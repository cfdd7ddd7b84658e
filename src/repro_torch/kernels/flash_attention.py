"""Flash attention (causal, optional sliding window, GQA), differentiable.

Counterpart of ``repro.kernels.flash_attention`` together with the GQA
head broadcast of ``repro.kernels.ops.flash_attention``. The forward
(:func:`flash_attention_forward`) on CUDA tensors launches a hand-written
kernel, chosen by dtype (:func:`kernel_for`): bf16 runs the tensor-core
kernel of ``csrc/flash_attention_sm90.cu`` (wgmma, TMA), fp32 the
CUDA-core kernel of ``csrc/flash_attention.cu``. Both map each query head
onto its kv head instead of repeating k and v. There is no fallback from
one to the other. On CPU tensors it returns the plain version
(:func:`repro_torch.kernels.ref.flash_attention_gqa_ref`), and so on meta
tensors, whose operations the dry run counts.

:func:`flash_attention` wraps the forward in a ``torch.autograd.Function``
whose backward (:func:`flash_attention_backward`) is plain PyTorch: the
gradient of the function the kernel computes (scores and p in fp32, p in
fp32 through P.V), recomputed per block of at most ``Q_BLOCK`` query rows,
as XLA differentiates the JAX package's query-chunked ``attention``. The
JAX package has no backward kernel either. CPU and card take the same
path, so the CPU tests exercise the backward the card runs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128, 256)
#: dtype -> (library under csrc/, C entry point) of the kernel that takes it
KERNELS = {torch.bfloat16: ("flash_attention_sm90",
                            "flash_attention_sm90_launch"),
           torch.float32: ("flash_attention", "flash_attention_launch")}


def kernel_for(dtype: torch.dtype):
    """``(library, entry point)`` of the kernel that takes ``dtype``: bf16
    the tensor-core kernel, fp32 the CUDA-core kernel; any other dtype
    raises."""
    if dtype not in KERNELS:
        raise TypeError(f"flash_attention takes fp32 or bf16, got {dtype}")
    return KERNELS[dtype]


def _launcher(dtype: torch.dtype):
    """The C entry point for ``dtype``, its library built on first use. Both
    take (q, k, v, o, B, Tq, Tk, Hq, Hkv, hd, causal, window, q_offset,
    stream)."""
    lib_name, fn_name = kernel_for(dtype)
    f = getattr(_build.load(lib_name), fn_name)
    if not f.argtypes:
        P, I = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, ctypes.c_longlong,
                      P]
        f.restype = ctypes.c_int
    return f


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window=None, q_offset: int = 0):
    """GQA attention, forward only. q:(B,Tq,Hq,hd), k/v:(B,Tk,Hkv,hd) ->
    (B,Tq,Hq,hd) in q's dtype. ``window``: keys with ``qpos - kpos >=
    window`` are masked; ``q_offset``: the absolute position of q[:, 0]
    relative to k[:, 0]."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"want q (B,Tq,Hq,hd) and k, v (B,Tk,Hkv,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Tq, Hq, hd = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} "
                         f"kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1 or None")
    if all(t.device.type in _build.PLAIN_DEVICES for t in (q, k, v)):
        return ref.flash_attention_gqa_ref(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset)
    _build.check_card(q, k, v)
    if q.dtype not in KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"want fp32 or bf16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous, 16-byte "
                         "aligned q, k, v")
    if min(B, Tq, Tk) == 0:
        raise ValueError(f"empty input: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _launcher(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq,
            Tk, Hq, Hkv, hd, int(bool(causal)),
            -1 if window is None else int(window), int(q_offset),
            _build.stream_ptr(q.device))
    _build.check_rc("flash_attention", rc)
    _build.count_launch("flash_attention", (B, Tq, Tk, Hq, Hkv, hd))
    return out


#: query rows per block of the backward's recompute: the JAX
#: ``attention``'s ``q_chunk`` (``repro/models/attention.py:73``)
Q_BLOCK = 1024


def _key_range(i0: int, i1: int, Tk: int, causal: bool, window, q_offset):
    """The keys ``[lo, hi)`` that query rows ``[i0, i1)`` can see. Where a
    row sees no key at all its softmax is uniform over every key (the
    -1e30 fill), so such a block takes all keys; otherwise the keys
    outside the band have p = 0 exactly and are left out."""
    first, last = i0 + q_offset, i1 - 1 + q_offset
    if causal and first < 0:
        return 0, Tk
    if window is not None and last - window + 1 >= Tk:
        return 0, Tk
    lo = max(0, first - window + 1) if window is not None else 0
    hi = min(Tk, last + 1) if causal else Tk
    return lo, hi


def flash_attention_backward(q, k, v, do, *, causal=True, window=None,
                             q_offset=0, q_block: int = Q_BLOCK):
    """Gradients (dq, dk, dv) of :func:`flash_attention_forward` at (q, k,
    v) for the output gradient ``do``, in plain PyTorch. Per block of
    query rows: the scores and p again in fp32 (masked
    scores -1e30, as the kernel), ``dp = do.v^T``, ``ds = p (dp -
    rowsum(p dp))`` (zero where masked), ``dq = ds.k / sqrt(hd)``, and dk,
    dv summed over each kv head's group of query heads. Returned in the
    inputs' dtypes. The blocks are the JAX ``attention``'s: Tq rows in
    one block up to ``q_block``, else blocks of the largest divisor of Tq
    not above it."""
    B, Tq, Hq, hd = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = 1.0 / (hd ** 0.5)
    kf, vf = k.float(), v.float()
    while Tq % q_block:      # the largest divisor of Tq not above q_block
        q_block -= 1
    dq = torch.empty((B, Tq, Hq, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Tk, Hkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i0 in range(0, Tq, q_block):
        i1 = min(Tq, i0 + q_block)
        lo, hi = _key_range(i0, i1, Tk, causal, window, q_offset)
        qb = q[:, i0:i1].float().reshape(B, i1 - i0, Hkv, g, hd)
        dob = do[:, i0:i1].float().reshape(B, i1 - i0, Hkv, g, hd)
        kb, vb = kf[:, lo:hi], vf[:, lo:hi]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
        qpos = torch.arange(i0, i1, device=q.device)[:, None] + q_offset
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones((i1 - i0, hi - lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window is not None:
            mask &= (qpos - kpos) < window
        s = torch.where(mask, s, ref.NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dob, vb)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        ds = torch.where(mask, ds, 0.0) * scale
        del dp
        dq[:, i0:i1] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kb).reshape(
            B, i1 - i0, Hq, hd)
        dk[:, lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb)
        dv[:, lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", p, dob)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention_forward` (the kernel on the card) with
    :func:`flash_attention_backward` as its gradient."""

    @staticmethod
    def forward(q, k, v, causal, window, q_offset):
        return flash_attention_forward(q, k, v, causal=causal,
                                       window=window, q_offset=q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, q_offset = inputs
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_backward(
            q, k, v, do, causal=causal, window=window, q_offset=q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, q_offset: int = 0):
    """GQA attention with a gradient. q:(B,Tq,Hq,hd), k/v:(B,Tk,Hkv,hd) ->
    (B,Tq,Hq,hd) in q's dtype; the forward is
    :func:`flash_attention_forward`, the backward
    :func:`flash_attention_backward`."""
    return FlashAttention.apply(q, k, v, bool(causal), window,
                                int(q_offset))

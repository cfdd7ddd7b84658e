"""Flash attention forward (causal, optional sliding window, GQA).

Counterpart of ``repro.kernels.flash_attention`` together with the GQA
head broadcast of ``repro.kernels.ops.flash_attention``. On CUDA tensors
:func:`flash_attention` launches a hand-written kernel, chosen by dtype
(:func:`kernel_for`): bf16 runs the tensor-core kernel of
``csrc/flash_attention_sm90.cu`` (wgmma, TMA), fp32 the CUDA-core kernel
of ``csrc/flash_attention.cu``. Both map each query head onto its kv head
instead of repeating k and v. There is no fallback from one to the other.
On CPU tensors it returns the plain version
(:func:`repro_torch.kernels.ref.flash_attention_gqa_ref`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128)
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, q_offset: int = 0):
    """GQA attention. q:(B,Tq,Hq,hd), k/v:(B,Tk,Hkv,hd) -> (B,Tq,Hq,hd) in
    q's dtype. ``window``: keys with ``qpos - kpos >= window`` are masked;
    ``q_offset``: the absolute position of q[:, 0] relative to k[:, 0]."""
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
    if all(t.device.type == "cpu" for t in (q, k, v)):
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

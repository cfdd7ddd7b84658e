"""RWKV6 chunked WKV recurrence with a state in and a state out.

Counterpart of ``repro.kernels.rwkv6_scan`` under the contract of the
model's ``chunked_wkv`` (``repro.models.rwkv6``): the Pallas kernel starts
from a zero state and drops the final one; serving needs both, since each
decode step carries the state to the next. On CUDA tensors
:func:`rwkv6_scan` launches the hand-written kernels in
``csrc/rwkv6_scan.cu`` (a chunked prefill kernel, and a T = 1 decode
kernel with no chunk machinery); on CPU (and meta) tensors it returns
the plain version (:func:`repro_torch.kernels.ref.rwkv6_chunked_ref`).
Either way
the final state may be written into a caller's buffer (``state_out``),
``state0`` itself included: decode updates its cache in place.

:func:`rwkv6_scan` is a ``torch.autograd.Function`` with gradients for r,
k, v, logw, u and state0 from the gradients of both the output and the
final state. Its backward is plain PyTorch: the plain version recomputed
under autograd and differentiated, i.e. autodiff of the same chunked math
as XLA's of the JAX package's ``chunked_wkv``, clamp included (inside the
clamped region, the clamp's gradient is 0). ``state_out`` writes in place
and is a serving path: with a gradient to take it raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

CHUNK = 64
HEAD_DIMS = (32, 64)


def _lib():
    lib = _build.load("rwkv6_scan")
    f = lib.rwkv6_scan_launch
    if not f.argtypes:
        P, I = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, P]
        f.restype = ctypes.c_int
    return lib


def rwkv6_scan_forward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor, u: torch.Tensor, state0=None, *,
                       chunk: int = CHUNK, state_out=None):
    """The scan, forward only. r, k, v, logw: (B, T, H, hd); u: (H, hd);
    state0: (B, H, hd, hd) fp32 (key axis first; None: zeros). Chunks of
    ``min(chunk, T)`` steps, the last one possibly shorter. Returns ``(out
    fp32 (B, T, H, hd), final state fp32 (B, H, hd, hd))``. ``state_out``:
    a contiguous fp32 (B, H, hd, hd) buffer the final state is written
    into and returned as; it may be ``state0`` (an in-place update, with
    the same result)."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"want r, k, v, logw of one (B, T, H, hd) shape, "
                         f"got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, T, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"want u of shape {(H, hd)}, got {tuple(u.shape)}")
    for name, s in (("state0", state0), ("state_out", state_out)):
        if s is not None and tuple(s.shape) != (B, H, hd, hd):
            raise ValueError(f"want {name} of shape {(B, H, hd, hd)}, got "
                             f"{tuple(s.shape)}")
    if state_out is not None and (state_out.dtype != torch.float32
                                  or not state_out.is_contiguous()):
        raise ValueError("state_out must be a contiguous fp32 tensor")
    if not 1 <= chunk <= CHUNK:
        raise ValueError(f"chunk={chunk} must lie in [1, {CHUNK}]")
    c = min(chunk, T)
    if state0 is None:
        state0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                             device=r.device)
    ins = (r, k, v, logw, u, state0)
    if all(t.device.type in _build.PLAIN_DEVICES for t in ins) and (
            state_out is None
            or state_out.device.type in _build.PLAIN_DEVICES):
        out, state = ref.rwkv6_chunked_ref(r, k, v, logw, u, state0, c)
        if state_out is None:
            return out, state
        return out, state_out.copy_(state)
    outs = () if state_out is None else (state_out,)
    _build.check_card(*ins, *outs)
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"rwkv6_scan takes fp32 inputs, got "
                        f"{[t.dtype for t in ins]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in ins + outs):
        raise ValueError("rwkv6_scan takes contiguous, 16-byte aligned "
                         "inputs")
    if min(B, T, H) == 0:
        raise ValueError(f"empty input of shape {tuple(r.shape)}")
    out = torch.empty_like(r)
    state = torch.empty_like(state0) if state_out is None else state_out
    with torch.cuda.device(r.device):
        rc = _lib().rwkv6_scan_launch(
            *(t.data_ptr() for t in ins), out.data_ptr(), state.data_ptr(),
            B, T, H, hd, c, _build.stream_ptr(r.device))
    _build.check_rc("rwkv6_scan", rc)
    _build.count_launch("rwkv6_scan", (B, T, H, hd))
    return out, state


def rwkv6_scan_backward(r, k, v, logw, u, state0, d_out, d_state,
                        chunk: int = CHUNK):
    """Gradients for (r, k, v, logw, u, state0) of the scan's (out, final
    state) given theirs (either may be None: no gradient flows from it).
    Plain PyTorch: :func:`repro_torch.kernels.ref.rwkv6_chunked_ref`
    recomputed under autograd and differentiated."""
    ins = [t.detach().requires_grad_()
           for t in (r, k, v, logw, u, state0)]
    if d_out is None and d_state is None:
        return tuple(torch.zeros_like(t) for t in ins)
    outs, ups = [], []
    with torch.enable_grad():
        out, state = ref.rwkv6_chunked_ref(*ins, min(chunk, r.shape[1]))
        for o, g in ((out, d_out), (state, d_state)):
            if g is not None:
                outs.append(o)
                ups.append(g)
        grads = torch.autograd.grad(outs, ins, ups, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(ins, grads))


class RWKV6Scan(torch.autograd.Function):
    """:func:`rwkv6_scan_forward` (the kernel on the card), with
    :func:`rwkv6_scan_backward` as its gradient."""

    @staticmethod
    def forward(r, k, v, logw, u, state0, chunk):
        return rwkv6_scan_forward(r, k, v, logw, u, state0, chunk=chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        *tensors, chunk = inputs
        ctx.save_for_backward(*tensors)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, d_out, d_state):
        return (*rwkv6_scan_backward(*ctx.saved_tensors, d_out, d_state,
                                     ctx.chunk), None)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, state0=None, *,
               chunk: int = CHUNK, state_out=None):
    """:func:`rwkv6_scan_forward` with a gradient (see the module's
    docstring): the same arguments and results. ``state_out`` (an in-place
    write) raises when a gradient is to be taken."""
    ins = (r, k, v, logw, u) + (() if state0 is None else (state0,))
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad
                                                 for t in ins)
    if state_out is not None:
        if needs_grad:
            raise RuntimeError("rwkv6_scan: state_out writes in place and "
                               "takes no gradient; call it without "
                               "state_out under autograd")
        return rwkv6_scan_forward(r, k, v, logw, u, state0, chunk=chunk,
                                  state_out=state_out)
    if state0 is None and r.dim() == 4:
        B, _, H, hd = r.shape
        state0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                             device=r.device)
    return RWKV6Scan.apply(r, k, v, logw, u, state0, chunk)

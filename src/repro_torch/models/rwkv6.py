"""RWKV-6 "Finch" time-mixing block (arXiv:2404.05892), chunked.

Counterpart of ``repro.models.rwkv6``. Recurrence per head (state S in
R^{dk x dv}):
    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
with *data-dependent* per-channel decay w_t = exp(-exp(w0 + lora(x_t))).

:func:`chunked_wkv` runs the chunked form (chunk 64, fp32 internals)
through the hand-written scan kernel (``kernels.ops.rwkv6_scan``) on the
card and its plain version on the CPU, with the state carried in and out:
prefill starts from zeros, and every decode step is a T = 1 call that
continues from the previous step's state. Training differentiates it
(the scan's backward recomputes the plain version under autograd);
``state_out``, the in-place decode write, takes no gradient.

Simplification vs the full Finch block, as in the JAX package: static
learned token-shift mixing coefficients per projection (mu), with the
data-dependent LoRA applied to the decay only.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import ParamStore, group_norm_heads, silu

LORA_DIM = 64
CHUNK = 64


def init_rwkv6(store: ParamStore, prefix: str, cfg: ArchConfig,
               stack: int = 0):
    d = cfg.d_model
    lead = (stack,) if stack else ()
    lax_ = ("layers",) if stack else ()
    for name in ("r", "k", "v", "g", "o"):
        store.param(f"{prefix}/w_{name}", lead + (d, d),
                    lax_ + ("embed", "embed2"))
    for name in ("r", "k", "v", "g", "w"):
        store.param(f"{prefix}/mu_{name}", lead + (d,), lax_ + ("embed",),
                    init="uniform", scale=0.5)
    store.param(f"{prefix}/w0", lead + (d,), lax_ + ("embed",), init="zeros")
    store.param(f"{prefix}/lora_a", lead + (d, LORA_DIM),
                lax_ + ("embed", "lora"), scale=0.01)
    store.param(f"{prefix}/lora_b", lead + (LORA_DIM, d),
                lax_ + ("lora", "embed"), scale=0.01)
    store.param(f"{prefix}/u", lead + (d,), lax_ + ("embed",),
                init="uniform", scale=0.5)
    store.param(f"{prefix}/ln_g", lead + (d,), lax_ + ("embed",), init="ones")


def _shift(x):
    """token shift: x_{t-1} (zeros at t=0)."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def chunked_wkv(r, k, v, logw, u, *, chunk: int = CHUNK, state0=None,
                state_out=None):
    """Chunked RWKV6 recurrence.

    r,k,v: (B, T, H, hd); logw: (B, T, H, hd) (log decay, <= 0); u: (H, hd).
    Returns (out (B,T,H,hd) fp32, final state (B,H,hd,hd) fp32); the state
    is written into ``state_out`` when given (it may be ``state0``).
    """
    B, T, H, hd = r.shape
    assert T % chunk == 0 or T < chunk, (T, chunk)
    r, k, v, logw = (a.float().contiguous() for a in (r, k, v, logw))
    return ops.rwkv6_scan(r, k, v, logw, u.float().contiguous(), state0,
                          chunk=min(chunk, T), state_out=state_out)


def rwkv6_decay(p, xw: torch.Tensor) -> torch.Tensor:
    """log decay in (-inf, 0): -exp(w0 + tanh(x A) B)."""
    lora = xw.float() @ p["lora_a"].float()
    lora = torch.tanh(lora) @ p["lora_b"].float()
    return -torch.exp(p["w0"].float() + lora)


def apply_rwkv6(p, x: torch.Tensor, cfg: ArchConfig, state=None,
                shifted=None, state_out=None):
    """Time-mixing. x: (B,T,d). state/shifted given in decode mode;
    ``state_out`` (may be ``state``) receives the new state in place.

    Returns (out, (new_state, last_x)) — the carries are used by serve_step.
    """
    B, T, d = x.shape
    H = cfg.n_heads
    hd = cfg.resolved_head_dim
    xs = _shift(x) if shifted is None else torch.cat(
        [shifted[:, None], x[:, :-1]], dim=1)

    proj = {}
    for name in ("r", "k", "v", "g"):
        xm = _mix(x, xs, p[f"mu_{name}"])
        proj[name] = xm @ p[f"w_{name}"]
    xw = _mix(x, xs, p["mu_w"])
    logw = rwkv6_decay(p, xw)                                 # (B,T,d) fp32

    r = proj["r"].reshape(B, T, H, hd)
    k = proj["k"].reshape(B, T, H, hd)
    v = proj["v"].reshape(B, T, H, hd)
    u = p["u"].float().reshape(H, hd)
    out, new_state = chunked_wkv(r, k, v, logw.reshape(B, T, H, hd), u,
                                 chunk=CHUNK if T >= CHUNK else T,
                                 state0=state, state_out=state_out)
    # the JAX block normalises with unit gamma and leaves ln_g unused
    out = group_norm_heads(out, torch.ones((hd,), device=x.device))
    out = out.reshape(B, T, d).to(x.dtype) * silu(proj["g"])
    out = out @ p["w_o"]
    return out, (new_state, x[:, -1])


def rwkv6_decode_step(p, x1: torch.Tensor, cfg: ArchConfig, state, last_x):
    """Single-token decode: x1 (B,1,d); O(1) per token (recurrent form).
    The new state is written over ``state`` (in place) and returned."""
    out, (new_state, new_last) = apply_rwkv6(p, x1, cfg, state=state,
                                             shifted=last_x,
                                             state_out=state)
    return out, (new_state, new_last)

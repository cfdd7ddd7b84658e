"""RecurrentGemma / Griffin recurrent block: temporal conv + RG-LRU.

Counterpart of ``repro.models.rglru`` (arXiv:2402.19427), names and
layouts unchanged. RG-LRU per channel:
    r_t = sigmoid(W_a x_t + b_a)         (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)         (input gate)
    a_t = a^(c * r_t),  a = sigmoid(Lambda),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence runs in fp32 as a log-depth doubling scan over whole
tensors (ceil(log2 T) steps: 12 at T = 4096), where JAX runs
``jax.lax.associative_scan``; both are parallel prefix scans of the same
combine, ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``, grouped in other
orders, so they agree to fp32 rounding (a few ulps of h per doubling
step; the CPU tests hold them at rtol 1e-5 / atol 1e-6 on the block's
state). Decode is the same block at T = 1 (O(1) state). The JAX package
has no kernel here (plain jnp), so neither has the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamStore, silu

C_EXP = 8.0
CONV_W = 4


def init_rglru(store: ParamStore, prefix: str, cfg: ArchConfig,
               stack: int = 0):
    d = cfg.d_model
    lead = (stack,) if stack else ()
    lax_ = ("layers",) if stack else ()
    store.param(f"{prefix}/w_in", lead + (d, d), lax_ + ("embed", "embed2"))
    store.param(f"{prefix}/w_gate_branch", lead + (d, d),
                lax_ + ("embed", "embed2"))
    store.param(f"{prefix}/conv_w", lead + (CONV_W, d),
                lax_ + ("conv", "embed"), scale=0.1)
    store.param(f"{prefix}/conv_b", lead + (d,), lax_ + ("embed",),
                init="zeros")
    store.param(f"{prefix}/w_a", lead + (d, d), lax_ + ("embed", "embed2"))
    store.param(f"{prefix}/b_a", lead + (d,), lax_ + ("embed",), init="zeros")
    store.param(f"{prefix}/w_x", lead + (d, d), lax_ + ("embed", "embed2"))
    store.param(f"{prefix}/b_x", lead + (d,), lax_ + ("embed",), init="zeros")
    store.param(f"{prefix}/lam", lead + (d,), lax_ + ("embed",),
                init="uniform", scale=2.0)
    store.param(f"{prefix}/w_out", lead + (d, d), lax_ + ("embed", "embed2"))


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv width 4. x:(B,T,d), w:(4,d). Returns (out,
    the last 3 inputs as the next call's ``conv_state``)."""
    if conv_state is None:
        pad = torch.zeros((x.shape[0], CONV_W - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i] for i in range(CONV_W)) + b
    new_state = xp[:, -(CONV_W - 1):]
    return out, new_state


def _rglru_scan(a, bx, h0=None):
    """h_t = a_t h_{t-1} + bx_t for a, bx (B,T,d) fp32 from state h0 (B,d)
    (zeros if None), as a doubling scan: at step s every position t >= s
    folds in the running pair of position t - s."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], 1)
    T, s = a.shape[1], 1
    while s < T:
        bx = torch.cat([bx[:, :s], bx[:, :-s] * a[:, s:] + bx[:, s:]], 1)
        if 2 * s < T:
            a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], 1)
        s *= 2
    return bx


def apply_rglru(p, x: torch.Tensor, cfg: ArchConfig, state=None,
                conv_state=None):
    """Griffin recurrent block. x:(B,T,d) -> (out, (h_state fp32 (B,d),
    conv_state (B,3,d)))."""
    gate = silu(x @ p["w_gate_branch"])
    xi = x @ p["w_in"]
    xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_state)

    x32 = xi.float()
    r = torch.sigmoid(x32 @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(x32 @ p["w_x"].float() + p["b_x"].float())
    log_a0 = F.logsigmoid(p["lam"].float())
    log_a = C_EXP * r * log_a0                       # log a_t <= 0
    a = torch.exp(log_a)
    bx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * x32)
    h = _rglru_scan(a, bx, h0=state)
    new_state = h[:, -1]
    out = h.to(x.dtype) * gate
    out = out @ p["w_out"]
    return out, (new_state, new_conv)


def rglru_decode_step(p, x1: torch.Tensor, cfg: ArchConfig, state,
                      conv_state):
    """Single-token decode (the block at T = 1, from the carried state)."""
    return apply_rglru(p, x1, cfg, state=state, conv_state=conv_state)

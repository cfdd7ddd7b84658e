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

:func:`apply_rglru_tp` is the block on one model rank's shards under
``model_sharding="auto"`` (``models.tensor_parallel``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import tensor_parallel as tpl
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


def _rglru_gates(x32_all, x32, w_a, w_x, b_a, b_x, lam):
    """The recurrence's decay a_t and input sqrt(1 - a_t^2) (i_t * x_t)
    (fp32) of the channels of ``x32``, the gates from ``x32_all`` through
    the matching columns of w_a and w_x (``x32_all`` is ``x32`` but on a
    model rank, whose columns need every channel)."""
    r = torch.sigmoid(x32_all @ w_a.float() + b_a.float())
    i = torch.sigmoid(x32_all @ w_x.float() + b_x.float())
    log_a0 = F.logsigmoid(lam.float())
    log_a = C_EXP * r * log_a0                       # log a_t <= 0
    a = torch.exp(log_a)
    bx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * x32)
    return a, bx


def apply_rglru(p, x: torch.Tensor, cfg: ArchConfig, state=None,
                conv_state=None):
    """Griffin recurrent block. x:(B,T,d) -> (out, (h_state fp32 (B,d),
    conv_state (B,3,d)))."""
    gate = silu(x @ p["w_gate_branch"])
    xi = x @ p["w_in"]
    xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_state)

    x32 = xi.float()
    a, bx = _rglru_gates(x32, x32, p["w_a"], p["w_x"], p["b_a"], p["b_x"],
                         p["lam"])
    h = _rglru_scan(a, bx, h0=state)
    new_state = h[:, -1]
    out = h.to(x.dtype) * gate
    out = out @ p["w_out"]
    return out, (new_state, new_conv)


def rglru_decode_step(p, x1: torch.Tensor, cfg: ArchConfig, state,
                      conv_state):
    """Single-token decode (the block at T = 1, from the carried state)."""
    return apply_rglru(p, x1, cfg, state=state, conv_state=conv_state)


# ------------------------------------------------- tensor-parallel form

#: the replicated per-channel leaves, each read only through a rank's
#: channels under model_sharding="auto"
TP_REPLICATED = ("conv_w", "conv_b", "b_a", "b_x", "lam")


def _rglru_in(x, w_gate_branch, w_in, conv_w, conv_b):
    """A rank's channels of the gate branch and of the conv output (fp32)."""
    gate = silu(x @ w_gate_branch)
    xi = x @ w_in
    xi, _ = _causal_conv(xi, conv_w, conv_b)
    return gate, xi.float()


def _rglru_mix(x32_all, x32, gate, w_a, w_x, b_a, b_x, lam):
    """A rank's channels of the gated RG-LRU output: the gates from the
    whole conv output ``x32_all`` through its columns of w_a and w_x, the
    recurrence on its channels ``x32``."""
    h = _rglru_scan(*_rglru_gates(x32_all, x32, w_a, w_x, b_a, b_x, lam))
    return h.to(gate.dtype) * gate


def apply_rglru_tp(p, x: torch.Tensor, cfg: ArchConfig, tp, spec,
                   remat: bool):
    """:func:`apply_rglru`'s output on this rank's shards (``tp``: a
    ``models.tensor_parallel.TPContext``; ``spec``: key -> (spec, global
    shape) of the block's leaves), the whole (B, T, d) on every model
    rank. x: the normed residual, the same on every rank.

    Every d x d weight is column-sharded, so a rank owns d/m channels: the
    gate branch, w_in and the depthwise conv (its slice of conv_w, conv_b)
    give its channels; w_a and w_x need the whole conv output, which is
    gathered in fp32 (its gradient differs between ranks: summed); the
    gates, the recurrence (b_a, b_x, lam sliced) and the gating are its
    channels again. w_out is column-sharded, so its input is gathered
    (summed gradient) and its output gathered (the residual's gradient,
    the same on every rank: sliced). The two local parts are checkpointed
    under ``remat``; the replicated leaves enter by one
    :func:`tensor_parallel.copy_in_leaves`, x by ``copy_in``.

    Collectives of a block at m > 1: forward the three gathers (3
    all_reduce of (B, T, d)); backward x's copy_in, the leaves' (8 d
    fp32) and the first two gathers': 4 all_reduce. The weights must be
    column-sharded (d_model divisible by m; the caller runs the plain
    block otherwise)."""
    lo, hi = tp.own(cfg.d_model)
    xin = tpl.copy_in(x, tp)
    rep = tpl.copy_in_leaves({k: p[k] for k in TP_REPLICATED}, tp)
    if tp.m > 1:
        rep = {k: v[..., lo:hi] for k, v in rep.items()}
    gate, x32 = tpl.local(remat, _rglru_in, xin, p["w_gate_branch"],
                          p["w_in"], rep["conv_w"], rep["conv_b"])
    x32_all = tpl.gather(x32, -1, tp, replicated_grad=False)
    h = tpl.local(remat, _rglru_mix, x32_all, x32, gate, p["w_a"], p["w_x"],
                  rep["b_a"], rep["b_x"], rep["lam"])
    y = tpl.gather(h, -1, tp, replicated_grad=False)
    return tpl.gather(y @ p["w_out"], -1, tp, replicated_grad=True)

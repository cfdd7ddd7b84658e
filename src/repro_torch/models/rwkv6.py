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

:func:`apply_rwkv6_tp` is the block on one model rank's shards under
``model_sharding="auto"`` (``models.tensor_parallel``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import tensor_parallel as tpl
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


def _projections(p, w, x, xs):
    """r, k, v and g: the token-shift mixes of x and its shift ``xs`` (by
    ``mu_*`` of ``p``) through ``w[name]``; and the log decay (B, T, d)
    fp32 of the ``mu_w`` mix (``w0`` and the LoRA of ``p``)."""
    proj = {}
    for name in ("r", "k", "v", "g"):
        xm = _mix(x, xs, p[f"mu_{name}"])
        proj[name] = xm @ w[name]
    xw = _mix(x, xs, p["mu_w"])
    return proj, rwkv6_decay(p, xw)


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

    proj, logw = _projections(p, {n: p[f"w_{n}"] for n in "rkvg"}, x, xs)
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


# ------------------------------------------------- tensor-parallel form

#: the replicated leaves the block reads, each only through a rank's
#: columns under model_sharding="auto" (ln_g is unused)
TP_REPLICATED = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "lora_a",
                 "lora_b", "u")


def tp_heads(cfg: ArchConfig, m: int, rank: int):
    """Model rank ``rank``'s columns ``[lo, hi)`` of d (its 1/m of the
    column-sharded w_r, w_k, w_v, w_g, w_o) and the heads they touch."""
    hd = cfg.resolved_head_dim
    n = cfg.d_model // m
    lo, hi = rank * n, (rank + 1) * n
    return (lo, hi), (lo // hd, -(-hi // hd))


def _rwkv6_local(rep, w, x, cfg: ArchConfig, cols, heads):
    """This rank's columns of the time mix's gated output (B, T, hi - lo),
    before w_o: the token shift and mixes on the whole x, r/k/v of the
    heads ``[h_lo, h_hi)`` its columns touch, the decay computed whole and
    sliced to them, the scan (``kernels.ops.rwkv6_scan``) and the per-head
    group norm on those heads, then its columns, gated. At one rank these
    are :func:`apply_rwkv6`'s operations."""
    B, T, d = x.shape
    hd = cfg.resolved_head_dim
    (lo, hi), (h_lo, h_hi) = cols, heads
    nh = h_hi - h_lo
    proj, logw = _projections(rep, w, x, _shift(x))
    if (h_lo, h_hi) != (0, cfg.n_heads):
        logw = logw[..., h_lo * hd:h_hi * hd]
    r = proj["r"].reshape(B, T, nh, hd)
    k = proj["k"].reshape(B, T, nh, hd)
    v = proj["v"].reshape(B, T, nh, hd)
    u = rep["u"].float().reshape(cfg.n_heads, hd)[h_lo:h_hi]
    out, _ = chunked_wkv(r, k, v, logw.reshape(B, T, nh, hd), u,
                         chunk=CHUNK if T >= CHUNK else T)
    out = group_norm_heads(out, torch.ones((hd,), device=x.device))
    out = out.reshape(B, T, nh * hd)
    if (lo, hi) != (h_lo * hd, h_hi * hd):
        out = out[..., lo - h_lo * hd:hi - h_lo * hd]
    return out.to(x.dtype) * silu(proj["g"])


def apply_rwkv6_tp(p, x: torch.Tensor, cfg: ArchConfig, tp, spec,
                   remat: bool):
    """:func:`apply_rwkv6`'s output on this rank's shards (``tp``: a
    ``models.tensor_parallel.TPContext``; ``spec``: key -> (spec, global
    shape) of the block's leaves), the whole (B, T, d) on every model
    rank. x: the normed residual, the same on every rank.

    The rank computes its columns of the gated heads' output
    (:func:`_rwkv6_local`, checkpointed under ``remat``): where the rule
    cut its columns inside a head, it computes every head its columns
    touch, from w_r/w_k/w_v columns gathered over the ranks, and keeps its
    columns. w_o is column-sharded, so the heads' output is gathered to
    the whole d (its gradient differs between ranks: summed), multiplied
    by the rank's columns of w_o, and the block's output gathered (its
    gradient, the residual's, is the same on every rank: sliced). The
    replicated leaves enter by one :func:`tensor_parallel.copy_in_leaves`
    (their gradients are partial on each rank), x by ``copy_in``.

    Collectives of a block at m > 1, whole heads a rank: forward the two
    gathers (2 all_reduce of (B, T, d)); backward x's copy_in (B, T, d),
    the leaves' (7 d + 2·64·d fp32) and the first gather's (B, T, d): 3
    all_reduce. Cut heads add a gather of w_r, w_k and w_v each way. The
    weights must be column-sharded (d_model divisible by m; the caller
    runs the plain block otherwise)."""
    hd = cfg.resolved_head_dim
    plans = [tp_heads(cfg, tp.m, r) for r in range(tp.m)]
    cols, (h_lo, h_hi) = plans[tp.rank]
    al = tpl.ranges_aligned(tp, cfg.d_model,
                            [(a * hd, b * hd) for _, (a, b) in plans])
    xin = tpl.copy_in(x, tp)
    rep = tpl.copy_in_leaves({k: p[k] for k in TP_REPLICATED}, tp)
    w = {n: tp.part(p[f"w_{n}"], *spec[f"w_{n}"], 1, h_lo * hd, h_hi * hd,
                    al) for n in ("r", "k", "v")}
    w["g"] = p["w_g"]
    o = tpl.local(remat, _rwkv6_local, rep, w, xin, cfg, cols, (h_lo, h_hi))
    y = tpl.gather(o, -1, tp, replicated_grad=False)
    return tpl.gather(y @ p["w_o"], -1, tp, replicated_grad=True)

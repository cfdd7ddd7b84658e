"""Mixture-of-Experts FFN with capacity-based gather/scatter routing.

Counterpart of ``repro.models.moe``, with its names, layouts and order of
operations: the top-k routes of each token flattened as (token, k), each
route's position in its expert by an exclusive cumsum over the routes,
routes past the capacity ``C`` dropped, an (E, C) token-index dispatch
buffer whose empty slots gather token 0, the expert SwiGLU as batched
products over the experts, and the combine weighted by the renormalised
top-k probabilities and masked by ``keep``. The JAX package has no kernel
here (plain jnp), so neither has the port.

Two points where torch differs from jnp and the port follows jnp:

- ``jax.lax.top_k`` breaks ties toward the lowest index; ``torch.topk``
  promises no order among ties, so the top k come from a stable
  descending sort.
- JAX scatters the token indices with ``mode="drop"``, which skips the
  out-of-range destinations of dropped routes. The port never hands an
  out-of-range index to a scatter: a dropped route writes to one spare
  slot past the buffer's end, which is cut off.

Every index is int64, so a stacked expert leaf of more than 2^31 elements
(mixtral-8x22b's, llama4's) is addressed correctly.

:func:`apply_moe_tp` is the tensor-parallel form of ``model_sharding=
"auto"`` (a rank's experts, or every expert's d_ff columns); the JAX
package has none, GSPMD partitioning ``apply_moe`` from the specs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.common import ParamStore, silu


def init_moe(store: ParamStore, prefix: str, cfg: ArchConfig, stack: int = 0):
    """stack>0: leading ``layers`` axis (the stacked ``blocks/*`` leaves)."""
    E, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    lead = (stack,) if stack else ()
    lax_ = ("layers",) if stack else ()
    store.param(f"{prefix}/router", lead + (d, E), lax_ + ("embed", "expert"),
                scale=0.02)
    store.param(f"{prefix}/w_gate", lead + (E, d, ff),
                lax_ + ("expert", "embed", "ff"))
    store.param(f"{prefix}/w_up", lead + (E, d, ff),
                lax_ + ("expert", "embed", "ff"))
    store.param(f"{prefix}/w_down", lead + (E, ff, d),
                lax_ + ("expert", "ff", "embed"))


def capacity(cfg: ArchConfig, T: int) -> int:
    """Slots per expert for T tokens: ``max(1, int(T k cf / E))``."""
    E, k, cf = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    return max(1, int(T * k * cf / E))


class Routing(NamedTuple):
    probs: torch.Tensor    # (B, T, E) fp32 router softmax
    top_w: torch.Tensor    # (B, T, k) fp32, renormalised over the k routes
    top_e: torch.Tensor    # (B, T, k) int64 experts, best first
    pos: torch.Tensor      # (B, T*k) int64 place of each route in its expert
    keep: torch.Tensor     # (B, T*k) bool: pos < C
    buf: torch.Tensor      # (B, E*C) int64 source token of each slot (0: none)
    slot: torch.Tensor     # (B, T*k) int64 slot each route reads back


def moe_routing(p, x: torch.Tensor, cfg: ArchConfig) -> Routing:
    """The router and the dispatch of ``apply_moe`` for x (B, T, d)."""
    B, T, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    C = capacity(cfg, T)
    logits = x.float() @ p["router"].float()                  # (B,T,E) fp32
    probs = torch.softmax(logits, dim=-1)
    # the top k by a stable descending sort: ties to the lowest index
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :k], top_e[..., :k]
    top_w = top_w / top_w.sum(-1, keepdim=True)

    routes = top_e.reshape(B, T * k)
    onehot = torch.nn.functional.one_hot(routes, E)           # (B,T*k,E)
    pos_all = torch.cumsum(onehot, dim=1) - onehot            # exclusive
    pos = (pos_all * onehot).sum(-1)                          # (B,T*k)
    keep = pos < C

    token_idx = (torch.arange(T * k, device=x.device) // k).expand(B, T * k)
    # kept routes to their slots, dropped ones to the spare slot E*C
    dest = torch.where(keep, routes * C + pos, E * C)
    buf = torch.zeros((B, E * C + 1), dtype=torch.int64, device=x.device)
    buf.scatter_(1, dest, token_idx)
    buf = buf[:, :E * C]
    slot = (routes * C + pos).clamp(0, E * C - 1)
    return Routing(probs, top_w, top_e, pos, keep, buf, slot)


def _experts(x, buf, slot, w_gate, w_up, w_down, e_lo: int, C: int):
    """Each route's expert output (B, T*k, d) from the experts
    ``[e_lo, e_lo + E_l)`` that ``w_gate``, ``w_up``, ``w_down`` hold
    (E_l on their leading axis, at whatever d_ff columns they hold): the
    slots ``buf[:, e_lo*C:(e_lo+E_l)*C]`` gathered, the SwiGLU as batched
    products over those experts, and each route's slot read back. A route
    whose slot lies in another expert reads zero."""
    B, T, d = x.shape
    E_l = w_gate.shape[0]
    rows = torch.arange(B, device=x.device)[:, None]
    own = buf[:, e_lo * C:(e_lo + E_l) * C]
    gx = x[rows, own.clamp(0, T - 1)].reshape(B, E_l, C, d)   # (B,E,C,d)

    # expert SwiGLU, one batched product per weight over the experts
    g = torch.einsum("becd,edf->becf", gx, w_gate)
    u = torch.einsum("becd,edf->becf", gx, w_up)
    y = torch.einsum("becf,efd->becd", silu(g) * u, w_down)
    y = y.reshape(B, E_l * C, d)
    if E_l * C == buf.shape[1]:
        return y[rows, slot]                                  # (B,T*k,d)
    s = slot - e_lo * C
    s = torch.where((s >= 0) & (s < E_l * C), s, E_l * C)
    return torch.cat([y, y.new_zeros(B, 1, d)], 1)[rows, s]


def _combine(back, r: Routing):
    """Each token's routes (B, T*k, d) weighted by the renormalised top-k
    probabilities, drop-masked, summed over its k routes."""
    B, Tk, d = back.shape
    T, k = r.top_w.shape[1:]
    w = (r.top_w.reshape(B, T * k) * r.keep).to(back.dtype)
    return (back.reshape(B, T, k, d) * w.reshape(B, T, k, 1)).sum(2)


def _load_balance(r: Routing, cfg: ArchConfig):
    """Switch-style load-balance aux loss."""
    E = cfg.moe.num_experts
    frac_routed = torch.nn.functional.one_hot(
        r.top_e[..., 0], E).float().mean((0, 1))
    mean_prob = r.probs.mean((0, 1))
    return E * (frac_routed * mean_prob).sum() * cfg.moe.router_aux_loss


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, T, d) -> (out (B, T, d), aux_loss fp32 scalar).

    Routing/capacity is computed independently per example, as in JAX."""
    r = moe_routing(p, x, cfg)
    back = _experts(x, r.buf, r.slot, p["w_gate"], p["w_up"], p["w_down"],
                    0, capacity(cfg, x.shape[1]))
    return _combine(back, r).to(x.dtype), _load_balance(r, cfg)


def apply_moe_tp(p, x: torch.Tensor, cfg: ArchConfig, tp, spec,
                 remat: bool):
    """:func:`apply_moe` on this rank's shards (``tp``: a
    ``models.tensor_parallel.TPContext``; ``spec``: key -> (spec, global
    shape) of the ``moe/*`` leaves), the whole (B, T, d) output and the
    aux loss on every model rank. x: the normed residual, the same on
    every rank.

    The spec rule shards the experts on E where m divides it (and the
    router's E columns with them), else each expert's d_ff columns (the
    router replicated). Either way the router runs whole on every rank:
    its columns gathered (d x E, outside the checkpointed part; its
    gradient, the same on every rank, sliced back), then the plain
    :func:`moe_routing` on x, so the routes, drops and slots are the same
    on every rank by construction (logits gathered from the ranks'
    columns could move by an ulp and flip a route on one rank only). A
    rank runs its experts' slots, or every expert at its d_ff columns, on
    ``copy_in(x)`` (checkpointed under ``remat``) into each route's
    partial output, zero for a slot of another rank's expert; one
    ``reduce_out`` of those (B, T*k, d) partials in fp32 (exact when the
    experts are sharded: each slot is non-zero on one rank), then the
    combine and the load-balance term on every rank, as the plain form
    computes them. With every ``moe/*`` leaf replicated (neither E nor
    d_ff divisible by m) the plain form runs on every rank.

    Collectives of a block at m > 1: forward the router's gather (none
    with the router replicated) and the reduce_out; backward x's copy_in:
    3 all_reduce."""
    if tp.m > 1 and tpl.MODEL not in spec["w_gate"][0]:
        return tpl.local(remat, apply_moe, p, x, cfg)
    router = p["router"]
    if tpl.MODEL in spec["router"][0]:
        router = tpl.gather(router, -1, tp, replicated_grad=True)
    r = moe_routing({"router": router}, x, cfg)
    e_lo = (tp.own(cfg.moe.num_experts)[0]
            if tp.m > 1 and spec["w_gate"][0][0] == tpl.MODEL else 0)
    back = tpl.local(remat, _experts, tpl.copy_in(x, tp), r.buf, r.slot,
                     p["w_gate"], p["w_up"], p["w_down"], e_lo,
                     capacity(cfg, x.shape[1]))
    out = _combine(tpl.reduce_out(back, tp), r)
    return out.to(x.dtype), _load_balance(r, cfg)

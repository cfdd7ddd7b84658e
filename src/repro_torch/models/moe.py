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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
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


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, T, d) -> (out (B, T, d), aux_loss fp32 scalar).

    Routing/capacity is computed independently per example, as in JAX."""
    B, T, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    C = capacity(cfg, T)
    r = moe_routing(p, x, cfg)

    rows = torch.arange(B, device=x.device)[:, None]
    gx = x[rows, r.buf.clamp(0, T - 1)].reshape(B, E, C, d)  # (B,E,C,d)

    # expert SwiGLU, one batched product per weight over the experts
    g = torch.einsum("becd,edf->becf", gx, p["w_gate"])
    u = torch.einsum("becd,edf->becf", gx, p["w_up"])
    y = torch.einsum("becf,efd->becd", silu(g) * u, p["w_down"])
    y = y.reshape(B, E * C, d)

    # combine: each route gathers its slot back, weighted, drop-masked
    back = y[rows, r.slot]                                    # (B,T*k,d)
    w = (r.top_w.reshape(B, T * k) * r.keep).to(back.dtype)
    out = (back.reshape(B, T, k, d) * w.reshape(B, T, k, 1)).sum(2)

    # Switch-style load-balance aux loss
    frac_routed = torch.nn.functional.one_hot(
        r.top_e[..., 0], E).float().mean((0, 1))
    mean_prob = r.probs.mean((0, 1))
    aux = E * (frac_routed * mean_prob).sum() * cfg.moe.router_aux_loss
    return out.to(x.dtype), aux

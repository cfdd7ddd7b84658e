"""Look-back Gradient Multiplier (paper Algorithm 1) — PyTorch port.

Counterpart of ``repro.core.lbgm``. Per client k and round t, with
accumulated stochastic gradient g and stored look-back gradient (LBG) l:

    sin^2(alpha) = 1 - (<g,l> / (||g|| ||l||))^2          (LBP error, step 6)
    rho          = <g,l> / ||l||^2                        (LBC, step 8)
    if sin^2(alpha) <= delta:  upload the SCALAR rho; server uses rho*l
    else:                      upload g; both sides set l <- g

The JAX package writes these per client and ``vmap``s them; here the client
axis is written out. Every tensor of a gradient or LBG dict carries a
leading client axis ``C`` and every per-client scalar is a ``(C,)`` tensor,
so the fused decision kernels see the whole chunk in one launch. Leaves are
visited in sorted key order, as ``jax.tree`` does, so per-leaf sums add up
in the same order in both packages.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.tree_math import (per_client, tree_scale, tree_select,
                                        tree_sq_norm, tree_vdot)
from repro_torch.kernels.ops import lbgm_projection, lbgm_sparse_decision
from repro_torch.kernels.ref import flat_to_blocks, topk_abs_rows

EPS = 1e-20


class LBGMStats(NamedTuple):
    sin2: torch.Tensor           # LBP error, (C,)
    rho: torch.Tensor            # LBC, (C,)
    sent_scalar: torch.Tensor    # bool (C,): True => 1 float on the uplink
    uplink_floats: torch.Tensor  # logical floats uploaded this round, (C,)
    grad_sq_norm: torch.Tensor   # (C,)


def recycle_gate(sin2, delta_threshold):
    """Algorithm 1 step 7: recycle iff the LBP error clears the threshold
    (``sin2 == 1`` covers degenerate LBGs and orthogonal gradients)."""
    return (sin2 <= delta_threshold) & (sin2 < 1.0)


def decision_from_scalars(gl, gg, ll, delta_threshold):
    """(sin2, rho, sent_scalar) from the three projection scalars."""
    cos2 = (gl * gl) / torch.clamp(gg * ll, min=EPS)
    sin2 = torch.where(ll > EPS, 1.0 - cos2, torch.ones_like(cos2))
    rho = gl / torch.clamp(ll, min=EPS)
    return sin2, rho, recycle_gate(sin2, delta_threshold)


def topk_uplink_stats(sin2, rho, scalar, gg, total_k: int) -> LBGMStats:
    """Sparse-store round stats: a full round ships k values + k block-local
    indices (~1.5 floats per kept value), a recycle round 1 float."""
    ones = torch.ones_like(sin2)
    return LBGMStats(sin2=sin2, rho=rho, sent_scalar=scalar,
                     uplink_floats=torch.where(scalar, ones,
                                               1.5 * total_k * ones),
                     grad_sq_norm=gg)


def lbgm_stats(grad, lbg, fused: bool = False):
    """(sin2, rho, gg) per client. ``fused=True`` computes <g,l>, ||g||^2
    and ||l||^2 with the one-pass projection kernel (one launch over every
    leaf of the chunk) instead of three separate passes."""
    if fused:
        gl, gg, ll = lbgm_projection(grad, lbg)
    else:
        gl = tree_vdot(grad, lbg)
        gg = tree_sq_norm(grad)
        ll = tree_sq_norm(lbg)
    sin2, rho, _ = decision_from_scalars(gl, gg, ll, 1.0)
    return sin2, rho, gg


def lbgm_client_step(grad, lbg, delta_threshold, fused: bool = False):
    """Paper Algorithm 1, worker side, dense LBG, for a chunk of clients.
    Returns (g_tilde as seen by the server, new_lbg, LBGMStats)."""
    sin2, rho, gg = lbgm_stats(grad, lbg, fused=fused)
    scalar = recycle_gate(sin2, delta_threshold)
    g_tilde = tree_select(scalar, tree_scale(lbg, rho), grad)
    new_lbg = tree_select(scalar, lbg, grad)
    m = sum(int(x[0].numel()) for x in grad.values())
    ones = torch.ones_like(sin2)
    stats = LBGMStats(sin2=sin2, rho=rho, sent_scalar=scalar,
                      uplink_floats=torch.where(scalar, ones, m * ones),
                      grad_sq_norm=gg)
    return g_tilde, new_lbg, stats


# ------------------------------------------------------------- topk variant

BLOCK = 65536


def _block_layout(size: int, k_frac: float) -> Tuple[int, int, int]:
    """(nb, block, kb) for a leaf of ``size``: block-wise top-kb per
    contiguous block; nb rounded up to a multiple of 16 (the JAX package
    shards the rows over a model axis; the port keeps the layout so banks
    and byte counts agree)."""
    block = min(size, BLOCK)
    nb = -(-size // block)
    if nb > 1:
        nb = -(-nb // 16) * 16
    k = max(1, int(size * k_frac))
    kb = max(1, min(block, k // nb if nb > 1 else k))
    return nb, block, kb


def _to_blocks(g: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    """(C, *shape) -> (C, nb, block) fp32, zero-padded at the end."""
    return flat_to_blocks(g.reshape(g.shape[0], -1).float(), nb, block)


def _live_rows(size: int, block: int) -> int:
    return -(-size // block)


def leaf_topk(g: torch.Tensor, k_frac: float, trim_pad: bool = False):
    """Block-wise top-|.| of a (C, *shape) leaf: ``{'idx': (C, nb, kb)
    int32, 'val': (C, nb, kb) f32}``. ``trim_pad=True`` emits the all-zero
    pad rows as (iota, zeros) directly instead of selecting on them — the
    same values."""
    size = int(g[0].numel())
    nb, block, kb = _block_layout(size, k_frac)
    live = _live_rows(size, block) if trim_pad else nb
    blocks = _to_blocks(g, live, block)
    idx, vals = topk_abs_rows(blocks, kb)
    if live < nb:
        C = g.shape[0]
        iota = torch.arange(kb, dtype=torch.int32, device=g.device)
        idx = torch.cat([idx, iota.expand(C, nb - live, kb)], 1)
        vals = torch.cat([vals, vals.new_zeros((C, nb - live, kb))], 1)
    return {"idx": idx, "val": vals}


def leaf_sparse_gather(g: torch.Tensor, sparse, k_frac: float,
                       trim_pad: bool = False) -> torch.Tensor:
    """g's values at the sparse entry positions -> (C, nb, kb) f32.
    ``trim_pad=True`` emits the pad rows' values as exact zeros."""
    size = int(g[0].numel())
    nb, block, _ = _block_layout(size, k_frac)
    live = _live_rows(size, block) if trim_pad else nb
    blocks = _to_blocks(g, live, block)
    gv = torch.gather(blocks, 2, sparse["idx"][:, :live].long())
    if live < nb:
        gv = torch.cat([gv, gv.new_zeros((gv.shape[0], nb - live)
                                          + gv.shape[2:])], 1)
    return gv


def leaf_scatter(sparse, shape, size: int, k_frac: float) -> torch.Tensor:
    """Dense fp32 (C, *shape) leaf holding ``sparse`` values at their
    indices."""
    nb, block, _ = _block_layout(size, k_frac)
    C = sparse["idx"].shape[0]
    dense = sparse["val"].new_zeros((C, nb, block), dtype=torch.float32)
    dense.scatter_(2, sparse["idx"].long(), sparse["val"].float())
    return dense.reshape(C, -1)[:, :size].reshape((C,) + tuple(shape))


def topk_count(size: int, k_frac: float) -> int:
    nb, _, kb = _block_layout(size, k_frac)
    return nb * kb


def init_topk_lbg(params_like, k_frac: float
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """One client's empty sparse LBG for an unbatched params dict, on the
    params' device."""
    out = {}
    for name in sorted(params_like):
        leaf = params_like[name]
        nb, _, kb = _block_layout(int(leaf.numel()), k_frac)
        out[name] = {"idx": torch.zeros((nb, kb), dtype=torch.int32,
                                        device=leaf.device),
                     "val": torch.zeros((nb, kb), dtype=torch.float32,
                                        device=leaf.device)}
    return out


def topk_step_core(grad: Dict[str, torch.Tensor], lbg, delta_threshold,
                   k_frac: float, *, sparse_out=False, fused=False):
    """Sparse-LBG Algorithm-1 step for a chunk of clients.

    grad: dict of dense (C, ...) leaves. lbg: dict of {idx, val}, each
    (C, nb, kb). ``fused=True`` replaces the three dense passes over each
    leaf (sparse gather, ||g||^2, block-wise top-k) with one launch of the
    fused decision kernel (``kernels.ops.lbgm_sparse_decision``) on the
    flat leaf.

    ``sparse_out=True`` skips the dense scatter of g_tilde and returns
    ``((send, gscale), new_lbg, stats)``: ``send`` is the per-leaf sparse
    {idx, val} payload with RAW values (the LBG's on a recycle round, the
    fresh top-k's on a full round) and ``gscale`` (C,) is what the server
    folds in (rho on a recycle round, 1 on a full round).
    """
    trim = sparse_out or fused
    names = sorted(grad)
    gl = ll = gg = None
    fresh = {}
    for name in names:
        g, sl = grad[name], lbg[name]
        size = int(g[0].numel())
        if fused:
            # the flat leaf in its own dtype: the kernel reads the live
            # rows only and treats the layout's padding as zeros
            _, block, _ = _block_layout(size, k_frac)
            gg_leaf, gv, ti, tv = lbgm_sparse_decision(
                g.reshape(g.shape[0], -1), sl["idx"], block=block)
            fresh[name] = {"idx": ti, "val": tv}
        else:
            gv = leaf_sparse_gather(g, sl, k_frac, trim_pad=trim)
            flat = g.reshape(g.shape[0], -1).float()
            gg_leaf = (flat * flat).sum(1)
        gl_leaf = (gv * sl["val"]).flatten(1).sum(1)
        ll_leaf = (sl["val"] * sl["val"]).flatten(1).sum(1)
        if gl is None:
            gl, ll, gg = gl_leaf, ll_leaf, gg_leaf
        else:
            gl, ll, gg = gl + gl_leaf, ll + ll_leaf, gg + gg_leaf
    sin2, rho, scalar = decision_from_scalars(gl, gg, ll, delta_threshold)

    g_tilde, new_lbg = {}, {}
    total_k = 0
    for name in names:
        g, sl = grad[name], lbg[name]
        size = int(g[0].numel())
        total_k += int(sl["idx"][0].numel())
        new = fresh[name] if fused else leaf_topk(g, k_frac, trim_pad=trim)
        s3 = per_client(scalar, sl["idx"])
        keep_idx = torch.where(s3, sl["idx"], new["idx"])
        keep_val = torch.where(s3, sl["val"], new["val"])
        if sparse_out:
            g_tilde[name] = {"idx": keep_idx, "val": keep_val}
        else:
            send = {"idx": keep_idx,
                    "val": torch.where(s3, per_client(rho, sl["val"])
                                       * sl["val"], new["val"])}
            g_tilde[name] = leaf_scatter(send, g.shape[1:], size, k_frac)
        new_lbg[name] = {"idx": keep_idx, "val": keep_val}
    stats = topk_uplink_stats(sin2, rho, scalar, gg, total_k)
    if sparse_out:
        gscale = torch.where(scalar, rho, torch.ones_like(rho))
        return (g_tilde, gscale), new_lbg, stats
    return g_tilde, new_lbg, stats


def lbgm_topk_client_step(grad: Dict[str, torch.Tensor], lbg,
                          delta_threshold, k_frac: float,
                          sparse_out: bool = False, fused: bool = False):
    """LBGM stacked on top-K with sparse LBG storage (see
    :func:`topk_step_core`)."""
    return topk_step_core(grad, lbg, delta_threshold, k_frac,
                          sparse_out=sparse_out, fused=fused)


# --------------------------------------------------- threshold schedules

def corollary1_threshold(grad_sq_norm, tau: int, total_rounds: int):
    """Adaptive delta from Corollary 1: sin^2(alpha) <= eta / ||d||^2 with
    eta = 1/sqrt(tau*T) and d = g/tau (normalized ASG)."""
    eta = 1.0 / float(tau * total_rounds) ** 0.5
    d_sq = grad_sq_norm / float(tau) ** 2
    return torch.clamp(eta / torch.clamp(d_sq, min=EPS), max=1.0)

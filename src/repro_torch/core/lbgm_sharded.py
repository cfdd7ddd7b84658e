"""Mesh-local LBGM decision (Algorithm 1's top-k variant on a model axis).

Counterpart of ``repro.core.lbgm_sharded``. The JAX package runs the
decision under ``shard_map``; here a mesh rank is a process that holds
its rows of each leaf's *global* block layout and its bank rows, and the
only traffic of the decision is one ``all_reduce`` over the model group
of each client's three partial scalars (<g,l>, ||l||², ||g||²).

The planning side of the JAX module is here too: a bank laid out per
device shard of each leaf (:func:`sharded_lbg_layout`,
:func:`init_sharded_lbg`), its specs plain tuples as
``train.sharding``'s.

``make_sharded_topk_step`` (model-sharded gradients with ``pre_blocked``
block rows, ``model_sharding="auto"``) is not ported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device
from repro_torch.core.lbgm import (_block_layout, decision_from_scalars,
                                   topk_step_core, topk_uplink_stats)
from repro_torch.kernels.ops import lbgm_sparse_decision
from repro_torch.kernels.ref import flat_to_blocks, topk_abs_rows
from repro_torch.train.sharding import axes_size, axis_entry


def local_leaf_size(leaf_shape, spec, mesh_shape: Dict[str, int]) -> int:
    """Elements of one rank's shard of a leaf of ``leaf_shape`` laid out
    by ``spec`` (per dim: None, an axis name, or a tuple of names) over a
    mesh of ``mesh_shape`` (axis name -> extent)."""
    n = 1
    for i, d in enumerate(leaf_shape):
        e = spec[i] if i < len(spec) else None
        div = 1
        if e is not None:
            for a in (e if isinstance(e, tuple) else (e,)):
                div *= mesh_shape[a]
        n *= d // div
    return n


def _spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names, in order (a dim's tuple of axes
    flattened)."""
    out = []
    for e in spec:
        if e is None:
            continue
        out.extend((e,) if isinstance(e, str) else e)
    return tuple(out)


def sharded_lbg_layout(params_like, gspecs, mesh, k_frac: float):
    """The top-k bank laid out per device shard of each leaf: name ->
    ``{"idx", "val"}`` of shape ``(nb * n_shards, kb)`` (int32, float32)
    as tensors on the ``meta`` device, where ``(nb, _, kb)`` is the block
    layout of one shard of the leaf under its spec ``gspecs[name]`` and
    n_shards the product of the extents of the axes the spec names; and
    name -> ``{"idx", "val"}`` specs, the block rows over those axes,
    ``(axes, None)`` in ``PartitionSpec``'s normal form. ``mesh``: axis
    names and extents (``train.sharding.abstract_mesh``)."""
    meta = torch.device("meta")
    layout, specs = {}, {}
    for name, leaf in params_like.items():
        axes = _spec_axes(gspecs[name])
        nb, _, kb = _block_layout(local_leaf_size(
            tuple(leaf.shape), gspecs[name], mesh.shape), k_frac)
        shape = (nb * axes_size(mesh, axes), kb)
        layout[name] = {
            "idx": torch.empty(shape, dtype=torch.int32, device=meta),
            "val": torch.empty(shape, dtype=torch.float32, device=meta)}
        spec = (axis_entry(axes), None)
        specs[name] = {"idx": spec, "val": spec}
    return layout, specs


def init_sharded_lbg(params_like, gspecs, mesh, k_frac: float,
                     device="cuda"):
    """:func:`sharded_lbg_layout`'s bank, zero-filled on ``device``: the
    card by default, ``"meta"`` to plan with shapes and dtypes only, the
    CPU when asked for by name."""
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    layout, _ = sharded_lbg_layout(params_like, gspecs, mesh, k_frac)
    return {name: {f: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                   for f, t in leaf.items()}
            for name, leaf in layout.items()}


def make_local_topk_step(delta: float, k_frac: float, *,
                         sparse_out: bool = False, fused: bool = False):
    """Rank-local Algorithm-1 top-k step ``fn(grads, lbg)`` over a chunk
    of clients: :func:`core.lbgm.topk_step_core` with no collective. Each
    client rank holds its clients' whole gradients and bank rows, so the
    decision is local and bit for bit the unsharded step."""
    def step(grads, lbg):
        return topk_step_core(grads, lbg, delta, k_frac,
                              sparse_out=sparse_out, fused=fused)
    return step


def model_shard_rows(nb: int, n_model: int) -> int:
    """Block rows of an ``(nb, kb)`` leaf each model rank owns under
    ``n_model``-way model sharding, or 0 when the leaf cannot shard (``nb``
    not divisible, e.g. single-block leaves such as biases, which stay
    replicated and are counted once through a rank-0 gate).
    ``_block_layout`` rounds multi-block ``nb`` up to a multiple of 16 so
    that power-of-two model meshes divide it."""
    if n_model > 1 and nb % n_model == 0:
        return nb // n_model
    return 0


def bank_model_partition(params_like, k_frac: float,
                         n_model: int) -> Dict[str, bool]:
    """name -> whether that leaf's sparse-bank block rows shard over the
    model axis: the one rule the scheduler's bank placement and the
    decision's row slices both follow, so the bank rows a rank holds are
    the rows its decision reads."""
    return {name: model_shard_rows(
        _block_layout(int(leaf.numel()), k_frac)[0], n_model) > 0
        for name, leaf in params_like.items()}


def _rank_rows(g: torch.Tensor, idx: torch.Tensor, lo: int, hi: int,
               block: int, fused: bool):
    """The decision's three passes over the rows of the flat (C, size)
    leaf ``g`` whose elements [lo, hi) this rank holds (zero past the
    leaf's end): ``(gg (C,), gathered, top_idx, top_val)`` at idx's rows.
    Rows past the leaf's end are pad rows: (iota, zeros), as the whole
    leaf's step emits them. The kernel reads only the live elements."""
    C, nb_l, kb = idx.shape
    seg = g[:, lo:hi]
    live = -(-(hi - lo) // block)
    if live and fused:
        gg, gv, ti, tv = lbgm_sparse_decision(seg.contiguous(), idx,
                                              block=block)
        return gg, gv, ti, tv
    f32 = dict(dtype=torch.float32, device=g.device)
    gv = torch.zeros((C, nb_l, kb), **f32)
    ti = torch.arange(kb, dtype=torch.int32,
                      device=g.device).expand(C, nb_l, kb).clone()
    tv = torch.zeros((C, nb_l, kb), **f32)
    if not live:
        return torch.zeros(C, **f32), gv, ti, tv
    seg = seg.float()
    bl = flat_to_blocks(seg, live, block)
    gv[:, :live] = torch.gather(bl, 2, idx[:, :live].long())
    ti[:, :live], tv[:, :live] = topk_abs_rows(bl, kb)
    return (seg * seg).sum(1), gv, ti, tv


def make_mesh_topk_step(delta: float, k_frac: float, *, n_model: int,
                        model_rank: int = 0, group=None,
                        sparse_out: bool = True, fused: bool = False):
    """Per-client Algorithm-1 decision of the ``(clients, model)`` mesh:
    ``fn(grads, lbg) -> ((send, gscale), new_lbg, stats)`` over a chunk of
    clients, ``grads`` whole on every model rank.

    * ``n_model == 1``: exactly :func:`make_local_topk_step`, bit for bit
      the unsharded step.
    * ``n_model > 1``: model rank r takes rows ``[r·nb/m, (r+1)·nb/m)`` of
      each leaf's *global* block layout, the rows of the bank it holds
      (``lbg`` carries those rows only). A leaf whose ``nb`` does not
      divide (:func:`bank_model_partition`) is processed whole on every
      rank and its partials are gated to rank 0 (a multiply by 1 or 0,
      not a division by m). The (C, 3) partials go through one
      ``all_reduce`` over ``group``, then the decision rule of
      ``core.lbgm.decision_from_scalars``. The uplink counts the global
      ``nb·kb``, the same on every mesh. Only the sparse payload
      (``sparse_out=True``) is supported: the dense g_tilde would need
      the leaf assembled across ranks.

    ``fused`` runs the decision kernel on the rank's rows of the flat
    leaf; otherwise the plain gather and block top-k run.
    """
    if n_model == 1:
        return make_local_topk_step(delta, k_frac, sparse_out=sparse_out,
                                    fused=fused)
    if not sparse_out:
        raise ValueError(
            "make_mesh_topk_step: model-axis sharding (n_model > 1) "
            "requires the sparse aggregation contract (sparse_out=True); "
            "the dense per-client g_tilde cannot be assembled rank-local")

    def step(grads, lbg):
        names = sorted(grads)
        parts = None
        local = {}
        total_k = 0
        for name in names:
            g, sl = grads[name], lbg[name]
            C = g.shape[0]
            size = int(g[0].numel())
            nb, block, kb = _block_layout(size, k_frac)
            total_k += nb * kb
            nb_l = sl["idx"].shape[1]
            sharded = nb_l != nb
            assert nb_l == (nb // n_model if sharded else nb), (
                name, nb_l, nb, n_model)
            r0 = model_rank * nb_l if sharded else 0
            lo, hi = min(size, r0 * block), min(size, (r0 + nb_l) * block)
            gg, gv, ti, tv = _rank_rows(g.reshape(C, -1), sl["idx"], lo, hi,
                                        block, fused)
            local[name] = (ti, tv)
            leaf = torch.stack([(gv * sl["val"]).flatten(1).sum(1),
                                (sl["val"] * sl["val"]).flatten(1).sum(1),
                                gg], 1)
            if not sharded:
                # every model rank computed the same whole-leaf partials:
                # count them once, exactly
                leaf = leaf * float(model_rank == 0)
            parts = leaf if parts is None else parts + leaf
        dist.all_reduce(parts, group=group)
        gl, ll, gg = parts.unbind(1)
        sin2, rho, scalar = decision_from_scalars(gl, gg, ll, delta)

        send, new_lbg = {}, {}
        for name in names:
            sl = lbg[name]
            ti, tv = local[name]
            s3 = scalar[:, None, None]
            keep = {"idx": torch.where(s3, sl["idx"], ti),
                    "val": torch.where(s3, sl["val"], tv)}
            send[name] = keep
            new_lbg[name] = keep
        stats = topk_uplink_stats(sin2, rho, scalar, gg, total_k)
        gscale = torch.where(scalar, rho, torch.ones_like(rho))
        return (send, gscale), new_lbg, stats

    return step

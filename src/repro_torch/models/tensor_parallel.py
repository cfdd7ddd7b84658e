"""Tensor-parallel client compute over the ``model`` axis of the FL mesh
(``model_sharding="auto"``).

The JAX package has no counterpart module: GSPMD partitions the client
forward and backward from the params' specs and inserts the collectives
itself. Here they are written out as autograd Functions that use only
``all_reduce`` (sum), the one collective gloo carries for CUDA tensors
besides ``broadcast`` (ROADMAP §1, the collectives rule), which
:meth:`TPContext.assemble` uses:

* :func:`copy_in` enters a tensor-parallel region: identity forward,
  ``all_reduce`` backward (each rank's use of a replicated tensor adds a
  partial gradient); :func:`copy_in_leaves` does so for several small
  replicated leaves at once, their gradients summed by one fp32
  ``all_reduce``;
* :func:`reduce_out` leaves it: ``all_reduce`` forward (each rank holds a
  partial sum), identity backward;
* :func:`gather` assembles a dim sharded over the model ranks (the
  embedding's d_model columns): a zero-filled ``all_reduce`` of the
  tensor's bytes forward
  (``launch.mesh.gather_sum``, bit for bit); backward the rank's slice of
  the upstream gradient when that gradient is the same on every rank, an
  ``all_reduce`` then the slice otherwise.

:class:`TPContext` holds the model group, the rank, m and each leaf's
resolved spec (``train.sharding``'s rule, the engine's vocab rule), and
cuts the rank's shards and assembles whole leaves from them (one
``broadcast`` of each model rank's packed shards: the engine's reshard
of a chunk's gradients, and ``FLEngine.params``). With m = 1 every
collective is skipped and every slice is the whole tensor, so the
tensor-parallel forms compute what the plain ones do, op for op.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import broadcast_pieces, gather_sum, pack_bytes

Spec = Tuple[Optional[str], ...]
MODEL = "model"


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyInMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1).float() for g in gs])
        dist.all_reduce(flat, group=ctx.group)
        out, o = [], 0
        for g in gs:
            out.append(flat[o:o + g.numel()].view(g.shape).to(g.dtype))
            o += g.numel()
        return (None, *out)


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp, replicated_grad):
        ctx.dim, ctx.tp, ctx.rep = dim, tp, replicated_grad
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * tp.m
        full = x.new_zeros(shape)
        full.narrow(dim, tp.rank * n, n).copy_(x)
        return gather_sum([full], tp.group)[0]

    @staticmethod
    def backward(ctx, g):
        tp, dim = ctx.tp, ctx.dim
        if not ctx.rep:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=tp.group)
        n = g.shape[dim] // tp.m
        return g.narrow(dim, tp.rank * n, n), None, None, None


def copy_in(x: torch.Tensor, tp: "TPContext") -> torch.Tensor:
    return x if tp.m == 1 else _CopyIn.apply(x, tp.group)


def copy_in_leaves(tree: Dict[str, torch.Tensor], tp: "TPContext"
                   ) -> Dict[str, torch.Tensor]:
    """:func:`copy_in` of every tensor of ``tree`` (replicated leaves that
    each rank uses only through its slice), their gradients summed over
    the model ranks in fp32 by one ``all_reduce`` of their packed
    elements."""
    if tp.m == 1:
        return dict(tree)
    names = sorted(tree)
    return dict(zip(names, _CopyInMany.apply(tp.group,
                                             *[tree[k] for k in names])))


def local(remat: bool, fn, *args):
    """``fn(*args)``, checkpointed when ``remat``: a local part between two
    collectives, so the backward's recompute repeats none of them."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def reduce_out(x: torch.Tensor, tp: "TPContext") -> torch.Tensor:
    """The sum over the model ranks of their partials ``x``, added in
    fp32 and returned in ``x``'s dtype."""
    if tp.m == 1:
        return x
    return _ReduceOut.apply(x.float(), tp.group).to(x.dtype)


def gather(x: torch.Tensor, dim: int, tp: "TPContext",
           replicated_grad: bool) -> torch.Tensor:
    """``x``, the rank's 1/m of ``dim``, assembled to the whole extent on
    every rank (rank r's part at ``[r·n, (r+1)·n)``)."""
    if tp.m == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), tp, replicated_grad)


class TPContext:
    """The model ranks of one client rank's group, and each leaf's spec
    over ``("model",)`` (a tuple with one entry per dim: ``"model"`` or
    None) and global shape."""

    def __init__(self, specs: Dict[str, Spec],
                 shapes: Dict[str, Sequence[int]], group, rank: int,
                 m: int):
        self.specs = {k: tuple(v) for k, v in specs.items()}
        self.shapes = {k: tuple(int(d) for d in v) for k, v in shapes.items()}
        self.group, self.rank, self.m = group, int(rank), int(m)

    def own(self, n: int) -> Tuple[int, int]:
        """``[lo, hi)``: this rank's part of an extent ``n`` split m ways."""
        k = n // self.m
        return self.rank * k, (self.rank + 1) * k

    def sharded_dim(self, name: str) -> Optional[int]:
        spec = self.specs[name]
        return spec.index(MODEL) if MODEL in spec else None

    # ------------------------------------------------------------ shards
    def shard(self, name: str, full: torch.Tensor, lead: int = 0):
        """This rank's shard of leaf ``name`` (``lead`` leading dims, such
        as a client axis, before the leaf's own), in storage of its own."""
        d = self.sharded_dim(name)
        if d is None or self.m == 1:
            return full
        lo, hi = self.own(full.shape[lead + d])
        return full.narrow(lead + d, lo, hi - lo).clone()

    def shard_tree(self, tree, lead: int = 0):
        return {k: self.shard(k, v, lead) for k, v in tree.items()}

    def assemble(self, tree, lead: int = 0):
        """The whole leaves of this rank's shards ``tree`` on every rank
        of the model group: each model rank broadcasts its shards, packed
        in one buffer (model rank 0's also holds the replicated leaves;
        sent in pieces, ``launch.mesh.broadcast_pieces``), so a rank
        receives (m - 1)/m of the bytes, where a ring ``all_reduce`` of
        zero-filled leaves would move twice that."""
        if self.m == 1:
            return dict(tree)
        names = sorted(tree)
        out = {}
        for k in names:
            x, d = tree[k], self.sharded_dim(k)
            if d is None:
                out[k] = x if self.rank == 0 else torch.empty_like(x)
                continue
            shape = list(x.shape)
            shape[lead + d] *= self.m
            out[k] = x.new_empty(shape)
        for r in range(self.m):
            mine = [k for k in names
                    if self.sharded_dim(k) is not None or r == 0]
            if not mine:
                # every leaf replicated: model rank 0's alone are sent
                continue
            parts = [tree[k] for k in mine]
            if r == self.rank:
                buf, spans = pack_bytes(parts)
            else:
                buf, spans = pack_bytes(parts, fill=False)
            broadcast_pieces(buf, dist.get_global_rank(self.group, r),
                             self.group)
            raw = buf.view(torch.uint8)
            for k, x, (o, n) in zip(mine, parts, spans):
                d = self.sharded_dim(k)
                got = x if r == self.rank else \
                    raw[o:o + n].view(x.dtype).reshape(x.shape)
                if d is None:
                    if r != self.rank:
                        out[k].copy_(got)
                else:
                    m = x.shape[lead + d]
                    out[k].narrow(lead + d, r * m, m).copy_(got)
        return out

    # ------------------------------------------------------------ views
    def part(self, w: torch.Tensor, spec: Spec, full: Sequence[int],
             dim: int, lo: int, hi: int, aligned: bool) -> torch.Tensor:
        """``[lo, hi)`` of ``dim`` of a leaf with ``spec`` and global shape
        ``full``, of which this rank rests ``w``, for a use that differs
        between ranks (the tensor-parallel region). ``aligned``: every
        rank's range lies in its own shard (decided for all ranks alike,
        so that all of them gather or none does)."""
        n = full[dim]
        if spec[dim] == MODEL and self.m > 1:
            if aligned:
                o_lo, o_hi = self.own(n)
                return w if (lo, hi) == (o_lo, o_hi) else w.narrow(
                    dim, lo - o_lo, hi - lo)
            w = gather(w, dim, self, replicated_grad=False)
        else:
            w = copy_in(w, self)
        return w if (lo, hi) == (0, n) else w.narrow(dim, lo, hi - lo)


def ranges_aligned(tp: TPContext, n: int, ranges) -> bool:
    """Whether every rank r's range ``ranges[r]`` lies in its own 1/m of an
    extent ``n``."""
    k = n // tp.m
    return all(r * k <= lo and hi <= (r + 1) * k
               for r, (lo, hi) in enumerate(ranges))

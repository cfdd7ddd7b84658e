"""Plain PyTorch versions of the LBGM kernels.

Counterparts of ``repro.kernels.ref``: the CPU path of every kernel
wrapper, the engine's arithmetic when its device is the CPU, and what
``chip_smoke.py`` holds each CUDA kernel against on the card. Every
function takes an optional leading batch (client) axis.
"""
from __future__ import annotations

import torch


def lbgm_projection_ref(g: torch.Tensor, l: torch.Tensor):
    """fp32 (<g,l>, ||g||^2, ||l||^2) over the last axis of ``(..., n)``."""
    g32, l32 = g.float(), l.float()
    return ((g32 * l32).sum(-1), (g32 * g32).sum(-1), (l32 * l32).sum(-1))


def topk_abs_rows(rows: torch.Tensor, kb: int):
    """Per-row top-``kb`` by |value|, in descending |value| order with ties
    to the lowest index — ``lax.top_k``'s rule. ``torch.topk`` promises no
    tie order, so it runs here on unique int64 keys, the IEEE bits of |x|
    (monotone in the magnitude) above ``n - 1 - index``: the largest key
    is the largest |x|, and among equal |x| the lowest index.
    Returns (idx int32, signed values)."""
    n = rows.shape[-1]
    bits = rows.float().abs().view(torch.int32).to(torch.int64)
    rank = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=rows.device)
    idx = torch.topk((bits << 32) | rank, kb, dim=-1).indices
    return idx.to(torch.int32), torch.gather(rows, -1, idx)


def lbgm_sparse_decision_ref(blocks: torch.Tensor, idx: torch.Tensor):
    """The three dense passes the fused sparse kernel replaces.

    blocks: (..., nb, block); idx: (..., nb, kb) int32 block-local
    positions. Returns ``(gg (...), gathered (..., nb, kb), top_idx
    (..., nb, kb) int32, top_val (..., nb, kb))``: top-k by |value| per
    block row in descending |value| order, values kept signed.
    """
    b32 = blocks.float()
    gg = (b32 * b32).sum((-2, -1))
    gathered = torch.gather(b32, -1, idx.long())
    ti, tv = topk_abs_rows(b32, idx.shape[-1])
    return gg, gathered, ti, tv


def lbgm_dequant_accum_ref(acc: torch.Tensor, w: torch.Tensor,
                           gscale: torch.Tensor, idx: torch.Tensor,
                           qv: torch.Tensor, scale: torch.Tensor):
    """Sequential dequantize + scatter-accumulate, in place on ``acc``.

    acc: (nb, block) f32; w, gscale: (C,) f32; idx: (C, nb, kb) int32
    block-local positions, unique within a row; qv: (C, nb, kb) int8 or
    float8_e4m3fn wire values; scale: (C, nb, 1) f32 row scales. Clients
    fold strictly in order, each a gather-modify-scatter:
    ``coeff = (w_c * gscale_c) * scale_c``, then
    ``a[row, idx] = a[row, idx] + where(w_c > 0, coeff * f32(qv_c), 0)``.
    The multiply and the add are separate ops (no FMA), as in the CUDA
    kernel, so the two agree bit for bit; the ``w_c > 0`` select keeps a
    phantom client's NaN payload or gscale out. Returns ``acc``."""
    for c in range(idx.shape[0]):
        w_c = w[c]
        coeff = (w_c * gscale[c]) * scale[c]             # (nb, 1)
        i_c = idx[c].long()
        add = torch.where(w_c > 0, coeff * qv[c].float(), 0.0)
        acc.scatter_(1, i_c, acc.gather(1, i_c) + add)
    return acc


def sort_topk_rows(idx: torch.Tensor, val: torch.Tensor):
    """Canonicalize a block-row top-k (idx, val) pair by ascending index."""
    order = torch.argsort(idx, dim=-1)
    return torch.gather(idx, -1, order), torch.gather(val, -1, order)


def lbgm_sparse_decision_two_pass_ref(blocks: torch.Tensor,
                                      idx: torch.Tensor):
    """The two-pass (threshold-select) decision: the same (idx, val) set
    per row as :func:`lbgm_sparse_decision_ref`, in ascending index
    order."""
    gg, gathered, ti, tv = lbgm_sparse_decision_ref(blocks, idx)
    ti, tv = sort_topk_rows(ti, tv)
    return gg, gathered, ti, tv

"""Top-K gradient sparsification (paper baseline for P3), batched over a
chunk's clients. Counterpart of ``repro.compression.topk``."""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import topk_abs_rows


def topk_leaf(g: torch.Tensor, k_frac: float):
    """Keep each client's k largest-|.| entries of a ``(C, ...)`` leaf, ties
    to the lowest index as ``lax.top_k``. Returns the dense sparsified leaf
    and the logical uplink float count (values + indices at ~0.5)."""
    flat = g.reshape(g.shape[0], -1).float()
    k = max(1, int(flat.shape[1] * k_frac))
    idx, val = topk_abs_rows(flat, k)
    dense = torch.zeros_like(flat).scatter_(1, idx.long(), val)
    return dense.reshape(g.shape).to(g.dtype), 1.5 * k


def compress(grads, k_frac: float):
    """Top-K of every leaf. Returns (sparsified dense dict, (C,) uplink
    float count)."""
    total = 0.0
    out = {}
    for name, g in grads.items():
        out[name], cost = topk_leaf(g, k_frac)
        total += cost
    leaf = next(iter(grads.values()))
    return out, torch.full((leaf.shape[0],), total, dtype=torch.float32,
                           device=leaf.device)

"""SignSGD with a per-leaf magnitude scale (Bernstein et al. 2018; paper
P4), batched over a chunk's clients. Counterpart of
``repro.compression.signsgd``.

Uplink cost: 1 bit per element (1/32 float) + 1 scale float per leaf.
"""
from __future__ import annotations

import torch


def compress(grads):
    out = {}
    bits = 0.0
    for name, g in grads.items():
        g32 = g.float()
        scale = g32.abs().reshape(g.shape[0], -1).mean(1)
        out[name] = (torch.sign(g32) * scale.reshape(
            (-1,) + (1,) * (g.dim() - 1))).to(g.dtype)
        bits += g[0].numel()  # 1 bit / element
    leaf = next(iter(grads.values()))
    return out, torch.full((leaf.shape[0],), bits / 32.0 + len(grads),
                           dtype=torch.float32, device=leaf.device)

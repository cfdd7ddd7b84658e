"""ATOMO-style low-rank gradient factorization (Wang et al. 2018; paper
P3), batched over a chunk's clients. Counterpart of
``repro.compression.atomo``.

Each client's leaf is reshaped to 2-D and approximated at rank r, by an
exact truncated SVD (``method="svd"``) or by subspace (power) iteration
(``method="power"``). The power method starts every leaf from the JAX
package's draw, ``jax.random.normal(PRNGKey(0), (n, r), float32)``,
replayed in NumPy by :mod:`repro_torch.core.jax_prng` and moved to the
leaf's device, so its iterates are the reference's.
Uplink cost: r * (m + n) floats per leaf.
"""
from __future__ import annotations

import torch

from repro_torch.core import jax_prng


def _to_2d(g: torch.Tensor) -> torch.Tensor:
    """(C, ...) -> (C, m, n), as the JAX package reshapes one client's
    leaf: a scalar to (1, 1), a vector to (1, n), else (shape[0], -1)."""
    C = g.shape[0]
    if g.dim() == 1:
        return g.reshape(C, 1, 1)
    if g.dim() == 2:
        return g.reshape(C, 1, -1)
    return g.reshape(C, g.shape[1], -1)


def lowrank_leaf(g: torch.Tensor, rank: int, method: str = "svd",
                 iters: int = 2):
    m2 = _to_2d(g).float()
    _, m, n = m2.shape
    r = min(rank, m, n)
    if method == "svd":
        u, s, vt = torch.linalg.svd(m2, full_matrices=False)
        approx = (u[..., :r] * s[..., None, :r]) @ vt[..., :r, :]
    else:  # power iteration from the reference's start, for every client
        q = torch.from_numpy(jax_prng.normal(jax_prng.prng_key(0), (n, r)))
        q = q.to(m2.device).expand(m2.shape[0], n, r)
        for _ in range(iters):
            p = m2 @ q                              # (C, m, r)
            p, _ = torch.linalg.qr(p)
            q = m2.transpose(1, 2) @ p              # (C, n, r)
        approx = p @ q.transpose(1, 2)
    return approx.reshape(g.shape).to(g.dtype), float(r * (m + n))


def compress(grads, rank: int = 2, method: str = "svd"):
    out = {}
    total = 0.0
    for name, g in grads.items():
        out[name], cost = lowrank_leaf(g, rank, method)
        total += cost
    leaf = next(iter(grads.values()))
    return out, torch.full((leaf.shape[0],), total, dtype=torch.float32,
                           device=leaf.device)

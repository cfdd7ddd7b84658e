"""Gradient-space PCA study (paper §2, Algorithm 2).

Counterpart of ``repro.analysis.pca``: stack the accumulated per-epoch
gradients, SVD, and count components explaining 95%/99% of variance
(N95-PCA / N99-PCA); plus the two cosine heat maps (actual-vs-principal,
Fig. 2; consecutive actual, Fig. 3) that motivate hypotheses (H1)/(H2).

The gradients come in as dicts of torch tensors on any device (or numpy
arrays); each is copied to the host as fp32 and flattened with its leaves
in sorted key order, the order ``jax.tree.leaves`` gives a dict, so that
the coordinate subsample above ``max_dim`` picks the same coordinates as
the JAX package. The SVD is numpy's, on the host, as in JAX.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _leaves(tree):
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, sequences in
    order, recursively."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def flatten_grad(tree) -> np.ndarray:
    """One fp32 host vector of every leaf, in sorted key order."""
    return np.concatenate([_host(x).reshape(-1) for x in _leaves(tree)])


def n_pca(grads: np.ndarray, variance: float) -> int:
    """#components explaining `variance` of total (Algorithm 2,
    get_num_PCA_components): count singular values accounting for that
    fraction of the aggregated singular values."""
    if grads.shape[0] == 1:
        return 1
    s = np.linalg.svd(grads, compute_uv=False)
    cum = np.cumsum(s) / max(np.sum(s), 1e-30)
    return int(np.searchsorted(cum, variance) + 1)


def pca_directions(grads: np.ndarray, variance: float) -> np.ndarray:
    """Principal gradient directions (left-singular rows in gradient space)."""
    u, s, vt = np.linalg.svd(grads, full_matrices=False)
    cum = np.cumsum(s) / max(np.sum(s), 1e-30)
    k = int(np.searchsorted(cum, variance) + 1)
    return vt[:k]


def cosine_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    an = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-30)
    bn = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-30)
    return an @ bn.T


class GradientSpaceTracker:
    """Collects per-epoch accumulated gradients and reports N-PCA progression
    (the paper's Fig. 1 top row) plus the Fig. 2/3 heat maps."""

    def __init__(self, max_dim: int = 200_000, seed: int = 0):
        # coordinate subsampling keeps the SVD tractable for larger models
        self.max_dim = max_dim
        self.seed = seed
        self._proj = None
        self.grads: List[np.ndarray] = []
        self.n95: List[int] = []
        self.n99: List[int] = []

    def add(self, grad_tree):
        g = flatten_grad(grad_tree)
        if g.size > self.max_dim:
            if self._proj is None:
                rng = np.random.RandomState(self.seed)
                idx = rng.choice(g.size, self.max_dim, replace=False)
                self._proj = np.sort(idx)   # coordinate subsampling
            g = g[self._proj]
        self.grads.append(g)
        mat = np.stack(self.grads)
        self.n95.append(n_pca(mat, 0.95))
        self.n99.append(n_pca(mat, 0.99))

    def matrix(self) -> np.ndarray:
        return np.stack(self.grads)

    def heatmaps(self, variance: float = 0.99
                 ) -> Tuple[np.ndarray, np.ndarray]:
        mat = self.matrix()
        pgd = pca_directions(mat, variance)
        return cosine_matrix(mat, pgd), cosine_matrix(mat, mat)

    def summary(self) -> Dict[str, object]:
        return {"epochs": len(self.grads), "n95": self.n95, "n99": self.n99,
                "n95_final": self.n95[-1] if self.n95 else 0,
                "n99_final": self.n99[-1] if self.n99 else 0}

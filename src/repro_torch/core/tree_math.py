"""Vector math over flat parameter dicts (fp32 accumulation throughout).

The port writes the client axis out: every leaf of a *batched* dict
carries a leading client axis ``C``, and per-client scalars are ``(C,)``
tensors. Leaves are visited in sorted key order — the order
``jax.tree.leaves`` uses in the JAX package — so per-leaf sums add up in
the same order in both packages.
"""
from __future__ import annotations

from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


def per_client(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """View the (C,) vector ``s`` so it broadcasts against leaf ``x``."""
    return s.reshape(s.shape + (1,) * (x.dim() - s.dim()))


def tree_vdot(a: Tree, b: Tree) -> torch.Tensor:
    """Per-client <a, b> over all leaves -> (C,) fp32."""
    sums = [(a[k].float() * b[k].float()).flatten(1).sum(1)
            for k in sorted(a)]
    return torch.stack(sums).sum(0)


def tree_sq_norm(a: Tree) -> torch.Tensor:
    return tree_vdot(a, a)


def tree_scale(a: Tree, s: torch.Tensor) -> Tree:
    return {k: (x.float() * per_client(s, x)).to(x.dtype)
            for k, x in a.items()}


def tree_select(pred: torch.Tensor, a: Tree, b: Tree) -> Tree:
    """Per-leaf ``where(pred, a, b)`` with a (C,) bool predicate."""
    return {k: torch.where(per_client(pred, a[k]), a[k], b[k]) for k in a}


def tree_size(a: Tree) -> int:
    """Element count of an unbatched dict (one client's parameters)."""
    return sum(int(x.numel()) for x in a.values())

"""Error feedback (Karimireddy et al. 2019), batched over a chunk's
clients. Counterpart of ``repro.compression.error_feedback``.

The paper uses EF "as standard only if top-K sparsification is used":
compress(g + e); e' = (g + e) - compressed.
"""
from __future__ import annotations


def apply(compress_fn, grads, residual):
    """Returns (compressed, new_residual, (C,) uplink cost)."""
    target = {k: grads[k] + residual[k] for k in grads}
    compressed, cost = compress_fn(target)
    new_residual = {k: target[k] - compressed[k] for k in target}
    return compressed, new_residual, cost

"""Uplink compressors the paper stacks LBGM on (P3/P4) — PyTorch port.

Counterpart of ``repro.compression``. Each base compressor registers a
factory ``(**kw) -> fn(grads) -> (grads', cost)`` in the ``COMPRESSORS``
registry. ``grads`` is a *batched* dict (leaves ``(C, ...)``, one row per
client of a chunk) and ``cost`` the (C,) fp32 uplink float count of each
client. :func:`make_uplink_pipeline` composes the base compressor with
error feedback.
"""
from __future__ import annotations

import inspect

import torch

from repro_torch.compression import atomo, error_feedback, signsgd, topk
from repro_torch.fed.registry import COMPRESSORS, register_compressor


@register_compressor("none")
def _identity_pipeline():
    def fn(g):
        leaf = next(iter(g.values()))
        m = sum(int(x[0].numel()) for x in g.values())
        return g, torch.full((leaf.shape[0],), float(m),
                             dtype=torch.float32, device=leaf.device)
    return fn


@register_compressor("topk")
def _topk_pipeline(k_frac: float = 0.1):
    return lambda g: topk.compress(g, k_frac)


@register_compressor("signsgd")
def _signsgd_pipeline():
    return signsgd.compress


@register_compressor("atomo")
def _atomo_pipeline(rank: int = 2, method: str = "svd"):
    return lambda g: atomo.compress(g, rank, method)


def get_compressor(name: str, **kw):
    """Returns fn: grads -> (dense compressed grads, uplink float cost)."""
    factory = COMPRESSORS.get(name)
    try:
        inspect.signature(factory).bind(**kw)
    except TypeError:
        accepted = sorted(inspect.signature(factory).parameters)
        raise ValueError(
            f"compressor {name!r} does not accept kwargs {sorted(kw)}; "
            f"accepted kwargs: {accepted}") from None
    return factory(**kw)


def make_uplink_pipeline(name: str = "none", kw=None,
                         use_error_feedback=None):
    """Base compressor + error feedback, as one hook.

    Returns ``(fn, uses_residual)`` with ``fn(grads, residual) -> (grads',
    residual', cost)``. Without error feedback the residual passes through
    untouched. Error feedback defaults to on iff the base compressor is
    top-K, as in the paper."""
    use_ef = (use_error_feedback if use_error_feedback is not None
              else name == "topk")
    use_ef = bool(use_ef) and name != "none"
    compress = get_compressor(name, **(kw or {}))
    if use_ef:
        def fn(grads, residual):
            return error_feedback.apply(compress, grads, residual)
    else:
        def fn(grads, residual):
            out, cost = compress(grads)
            return out, residual, cost
    return fn, use_ef

"""Uplink compressors the paper stacks LBGM on (P3/P4) — PyTorch port.

Counterpart of ``repro.compression``. Only the identity compressor
``"none"`` is ported so far; top-K, SignSGD, ATOMO and error feedback are
later slices (ROADMAP.md), and ``FLConfig`` rejects their keys until then.

A compressor factory returns ``fn(grads) -> (grads', cost)`` over a
*batched* gradient dict (leaves ``(C, ...)``), with ``cost`` the (C,)
fp32 uplink float count of each client. Without error feedback (a later
slice) the engine keeps no residual bank.
"""
from __future__ import annotations

import inspect

import torch

from repro_torch.fed.registry import COMPRESSORS, register_compressor


@register_compressor("none")
def _identity_pipeline():
    def fn(g):
        leaf = next(iter(g.values()))
        m = sum(int(x[0].numel()) for x in g.values())
        return g, torch.full((leaf.shape[0],), float(m),
                             dtype=torch.float32, device=leaf.device)
    return fn


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
    """The uplink pipeline ``fn(grads) -> (grads', cost)``: the base
    compressor. Error feedback (on by default for top-K, as the paper)
    is not ported yet, so a config that turns it on is refused."""
    use_ef = (use_error_feedback if use_error_feedback is not None
              else name == "topk")
    if use_ef and name != "none":
        raise ValueError("error feedback is not ported to repro_torch yet")
    return get_compressor(name, **(kw or {}))

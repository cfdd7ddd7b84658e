"""Byzantine-robust server aggregation of the port.

Counterpart of ``repro.fed.robust``, with the same registry keys, aliases
and kwargs. Two aggregation modes share the engine's aggregator seam:

* **streaming** (``"mean"``, the default): the engine's strictly
  sequential ``carry += w_k * g_k`` fold, unchanged;
* **collect** (every robust rule): the schedulers stack the per-client
  payloads (dense g_tilde, or the sparse (idx, val) payload + gscale) over
  the round and hand the (K, ...) stack to the rule's ``reduce`` once.

Every rule is weighted by the round's normalized client weights; a
zero-weight row (unsampled, dropped out, phantom chunk padding, whose
values may be NaN) is masked with a select, never a multiply by 0. The
weighted sorts are stable, the running weight sums run in the order
XLA's CPU ``cumsum`` takes (``kernels.ref.chunk_cumsum``) and the total
weight is a sequential sum (XLA's order for K <= 32), so a median's pick
is the JAX package's and the same on the card and on the CPU.

Built-in rules: ``"mean"`` (streaming), ``"trimmed_mean"`` (``beta``),
``"coordinate_median"`` (alias ``"median"``), ``"geometric_median"``
(alias ``"gm"``; ``iters`` smoothed Weiszfeld steps, ``eps``) and
``"scalar_median"`` (the weighted median of the K gscale scalars, folded
over the sparse payloads without densifying them).
"""
from __future__ import annotations

import torch

from repro_torch.core.lbgm import _block_layout
from repro_torch.fed.registry import register_aggregator
from repro_torch.kernels.ref import chunk_cumsum


class StreamingMean:
    """Marker rule: keep the engine's streaming weighted-mean fold."""

    streaming = True


def _col(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return w.reshape((-1,) + (1,) * (x.dim() - 1))


def mask_invalid(w, g):
    """Rows whose weight is <= 0 become exact fp32 zeros, per leaf."""
    return {k: torch.where(_col(w, x) > 0, x.float(), 0.0)
            for k, x in g.items()}


def _total(w: torch.Tensor) -> torch.Tensor:
    """fp32 sum of the (K,) weights, client by client."""
    w = w.float()
    s = w[0]
    for k in range(1, w.shape[0]):
        s = s + w[k]
    return s


def _sorted_with_weights(w, x):
    """Sort one stacked leaf along the client axis (stably), carrying the
    weights: ``(values, weights, cum_weights)`` shaped like ``x``."""
    v, order = torch.sort(x, dim=0, stable=True)
    ws = torch.gather(_col(w.float(), x).expand(x.shape), 0, order)
    return v, ws, chunk_cumsum(ws, 0)


class TrimmedMean:
    """Per-coordinate weighted trimmed mean: drop ``beta`` weight mass from
    each tail of the sorted values and average the rest."""

    def __init__(self, beta: float = 0.1):
        if not 0.0 <= beta < 0.5:
            raise ValueError(
                f"trimmed_mean: beta must be in [0, 0.5), got {beta}")
        self.beta = float(beta)

    def reduce(self, w, g):
        g = mask_invalid(w, g)
        total = _total(w)
        lo, hi = self.beta * total, (1.0 - self.beta) * total
        den = torch.clamp(hi - lo, min=1e-20)

        def f(x):
            v, ws, cum = _sorted_with_weights(w, x)
            eff = (torch.minimum(torch.maximum(cum, lo), hi)
                   - torch.minimum(torch.maximum(cum - ws, lo), hi))
            return (eff * v).sum(0) / den
        return {k: f(x) for k, x in g.items()}


class CoordinateMedian:
    """Per-coordinate weighted median: the sorted value at which the
    running weight first reaches half the total."""

    def reduce(self, w, g):
        g = mask_invalid(w, g)
        half = 0.5 * _total(w)

        def f(x):
            v, _, cum = _sorted_with_weights(w, x)
            pick = (cum >= half).to(torch.uint8).argmax(0)
            return torch.gather(v, 0, pick[None])[0]
        return {k: f(x) for k, x in g.items()}


class ScalarMedian:
    """The weighted median of the K gscale scalars (rho on a recycle
    round, 1 on a full round), folded over the sparse payloads with that
    one multiplier (:class:`ScalarMedianSparseAggregator`)."""

    scalar_structured = True

    def median(self, w, gscale):
        wf = w.float()
        gs = torch.where(wf > 0, gscale.float(), 0.0)
        v, _, cum = _sorted_with_weights(wf, gs)
        half = 0.5 * _total(wf)
        return v[(cum >= half).to(torch.uint8).argmax()]


class GeometricMedian:
    """Smoothed Weiszfeld geometric median over whole update vectors:
    ``iters`` steps of z <- sum_k (w_k / max(||g_k - z||, eps)) g_k /
    sum_k (...), from the weighted mean; distances summed leaf by leaf in
    sorted key order."""

    def __init__(self, iters: int = 8, eps: float = 1e-6):
        if iters < 1:
            raise ValueError(
                f"geometric_median: iters must be >= 1, got {iters}")
        if eps <= 0:
            raise ValueError(
                f"geometric_median: eps must be > 0, got {eps}")
        self.iters = int(iters)
        self.eps = float(eps)

    def reduce(self, w, g):
        g = mask_invalid(w, g)
        names = sorted(g)
        wf = w.float()

        def wavg(weights):
            denom = torch.clamp(weights.sum(), min=1e-20)
            return {k: torch.tensordot(weights, g[k], dims=1) / denom
                    for k in names}

        z = wavg(wf)
        for _ in range(self.iters):
            d2 = 0.0
            for k in names:
                x = g[k]
                d2 = d2 + ((x - z[k][None]) ** 2).flatten(1).sum(1)
            z = wavg(wf / torch.clamp(torch.sqrt(d2), min=self.eps))
        return z


# ------------------------------------------------- engine collect adapters

class CollectDenseAggregator:
    """Collect-mode adapter over dense per-client g_tilde stacks."""

    collect = True
    sparse = False

    def __init__(self, rule):
        self.rule = rule

    def reduce(self, w, gt_stack):
        return self.rule.reduce(w, gt_stack)


def _sparse_layout(params, k_frac):
    return {name: (tuple(leaf.shape), int(leaf.numel()))
            + _block_layout(int(leaf.numel()), k_frac)[:2]
            for name, leaf in params.items()}


class CollectSparseAggregator:
    """Collect-mode adapter over sparse (idx, val) payloads: each client's
    payload is densified into the bank's (nb, block) layout with its
    gscale folded in, and the (K, nb, block) stacks go through the rule.
    ``decode`` widens a lossy codec's wire values (None: fp32 already)."""

    collect = True
    sparse = True

    def __init__(self, rule, params, k_frac: float, decode=None,
                 payload_keys=("idx", "val")):
        self.rule = rule
        self.decode = decode or (lambda sk: sk["val"])
        self.payload_keys = tuple(payload_keys)
        self._layout = _sparse_layout(params, k_frac)

    def reduce(self, w, out):
        send, gscale = out          # leaves (K, nb, kb); gscale (K,)
        stacks = {}
        for name, sk in send.items():
            _, _, nb, block = self._layout[name]
            vals = self.decode(sk).float()
            dense = vals.new_zeros((vals.shape[0], nb, block))
            dense.scatter_(2, sk["idx"].long(),
                           gscale.float()[:, None, None] * vals)
            stacks[name] = dense
        red = self.rule.reduce(w, stacks)
        return {name: red[name].reshape(-1)[:size].reshape(shape)
                for name, (shape, size, _, _) in self._layout.items()}


class ScalarMedianSparseAggregator:
    """Collect adapter of :class:`ScalarMedian`: the stacks stay in the
    sparse wire layout; the fold is the streaming sparse fold's strictly
    sequential gather-modify-scatter with each client's gscale replaced by
    the one median."""

    collect = True
    sparse = True

    def __init__(self, rule, params, k_frac: float, decode=None,
                 payload_keys=("idx", "val")):
        self.rule = rule
        self.decode = decode or (lambda sk: sk["val"])
        self.payload_keys = tuple(payload_keys)
        self._layout = _sparse_layout(params, k_frac)

    def reduce(self, w, out):
        send, gscale = out          # leaves (K, nb, kb); gscale (K,)
        med = self.rule.median(w, gscale)
        dev = gscale.device
        acc = {name: torch.zeros((nb, block), dtype=torch.float32,
                                 device=dev)
               for name, (_, _, nb, block) in self._layout.items()}
        idx = {name: send[name]["idx"].long() for name in acc}
        for k in range(w.shape[0]):
            w_k = w[k]
            on = w_k > 0
            coeff = w_k * med
            for name in sorted(acc):
                sk = {key: v[k] for key, v in send[name].items()}
                a, i_k = acc[name], idx[name][k]
                new = a.gather(1, i_k) + torch.where(
                    on, coeff * self.decode(sk).float(), 0.0)
                a.scatter_(1, i_k, new)
        return {name: acc[name].reshape(-1)[:size].reshape(shape)
                for name, (shape, size, _, _) in self._layout.items()}


# ------------------------------------------------------------ registry

# kw= declares each rule's aggregator_kw surface (the factories are
# lambdas over cfg), so FLConfig rejects a typo'd key at construction
register_aggregator("mean", lambda cfg: StreamingMean(), kw=())
register_aggregator("trimmed_mean", kw=("beta",))(
    lambda cfg: TrimmedMean(**(cfg.aggregator_kw or {})))
register_aggregator("coordinate_median", aliases=("median",), kw=())(
    lambda cfg: CoordinateMedian(**(cfg.aggregator_kw or {})))
register_aggregator("geometric_median", aliases=("gm",),
                    kw=("iters", "eps"))(
    lambda cfg: GeometricMedian(**(cfg.aggregator_kw or {})))
register_aggregator("scalar_median", kw=())(
    lambda cfg: ScalarMedian(**(cfg.aggregator_kw or {})))


def make_robust_rule(cfg):
    """Resolve ``cfg.aggregator`` through the registry, with an
    actionable error when ``aggregator_kw`` doesn't match the rule."""
    from repro_torch.fed.registry import AGGREGATORS
    try:
        return AGGREGATORS.get(cfg.aggregator)(cfg)
    except TypeError as e:
        raise ValueError(
            f"FLConfig.aggregator_kw {cfg.aggregator_kw!r} does not match "
            f"aggregator {cfg.aggregator!r}: {e}") from e

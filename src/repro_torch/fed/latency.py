"""Per-client latency / compute-heterogeneity models for ``"buffered"``.

Counterpart of ``repro.fed.latency``, with the same registry keys, kwargs
and draws. The buffered scheduler treats a slow client as latency: a
dispatched payload sits in flight for a model-drawn number of rounds and
folds into the global update in the round it lands, discounted by a
staleness weight. Each model supplies:

* ``sample_delays(rng, K)``: per-round (K,) integer rounds-of-delay, drawn
  from the engine's fault stream in the JAX package's order; a model that
  needs no randomness never touches ``rng``;
* ``staleness_weight(s)``: the discount ``1 / (1 + s)**alpha`` of a
  payload ``s`` rounds stale, selected to exactly 1.0 at ``s == 0`` (what
  makes a zero-latency buffered run equal the chunked scheduler's);
* ``sample_tau(K, tau)``: an optional per-client local-step budget, or
  None for every client at ``tau``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.fed.registry import LATENCIES, register_latency

#: sentinel delay of a payload that never arrives
NEVER = 1 << 30


class LatencyModel:
    """Base: zero delay, polynomial staleness discount, homogeneous tau.
    ``max_staleness`` (every model) evicts an in-flight payload older than
    that many rounds at the start of a round (None: never)."""

    def __init__(self, alpha: float = 0.5,
                 max_staleness: Optional[int] = None):
        if alpha < 0:
            raise ValueError(f"latency alpha must be >= 0, got {alpha}")
        if max_staleness is not None and int(max_staleness) < 0:
            raise ValueError(f"latency max_staleness must be >= 0 or "
                             f"None, got {max_staleness}")
        self.alpha = float(alpha)
        self.max_staleness = (None if max_staleness is None
                              else int(max_staleness))

    def setup(self, num_clients: int, seed: int) -> None:
        """One-time hook (e.g. draw a fixed straggler cohort)."""

    def sample_delays(self, rng: np.random.RandomState,
                      num_clients: int) -> np.ndarray:
        return np.zeros(num_clients, np.int64)

    def staleness_weight(self, s: torch.Tensor) -> torch.Tensor:
        return torch.where(s > 0, (1.0 + s) ** (-self.alpha), 1.0)

    def sample_tau(self, num_clients: int,
                   tau: int) -> Optional[np.ndarray]:
        return None


@register_latency("none")
class NoLatency(LatencyModel):
    """Synchronous: every dispatched payload arrives the same round."""


@register_latency("fixed")
class FixedLatency(LatencyModel):
    """Every client delivers exactly ``delay`` rounds after dispatch."""

    def __init__(self, delay: int = 1, alpha: float = 0.5,
                 max_staleness: Optional[int] = None):
        super().__init__(alpha, max_staleness)
        if delay < 0:
            raise ValueError(f"fixed latency delay must be >= 0, "
                             f"got {delay}")
        self.delay = int(delay)

    def sample_delays(self, rng, num_clients):
        return np.full(num_clients, self.delay, np.int64)


@register_latency("uniform")
class UniformLatency(LatencyModel):
    """Delay ~ UniformInt[low, high] per client per round."""

    def __init__(self, low: int = 0, high: int = 3, alpha: float = 0.5,
                 max_staleness: Optional[int] = None):
        super().__init__(alpha, max_staleness)
        if not 0 <= low <= high:
            raise ValueError(f"uniform latency needs 0 <= low <= high, "
                             f"got low={low} high={high}")
        self.low, self.high = int(low), int(high)

    def sample_delays(self, rng, num_clients):
        return rng.randint(self.low, self.high + 1,
                           size=num_clients).astype(np.int64)


@register_latency("lognormal")
class LognormalLatency(LatencyModel):
    """Delay = floor(scale * LogNormal(0, sigma)), clipped to
    ``max_delay``."""

    def __init__(self, scale: float = 1.0, sigma: float = 0.75,
                 max_delay: int = 16, alpha: float = 0.5,
                 max_staleness: Optional[int] = None):
        super().__init__(alpha, max_staleness)
        if scale < 0 or sigma < 0 or max_delay < 0:
            raise ValueError(
                f"lognormal latency needs scale, sigma, max_delay >= 0, "
                f"got scale={scale} sigma={sigma} max_delay={max_delay}")
        self.scale, self.sigma = float(scale), float(sigma)
        self.max_delay = int(max_delay)

    def sample_delays(self, rng, num_clients):
        d = np.floor(self.scale * rng.lognormal(
            0.0, self.sigma, size=num_clients))
        return np.clip(d, 0, self.max_delay).astype(np.int64)


@register_latency("straggler")
class StragglerLatency(LatencyModel):
    """A fixed cohort of round(frac*K) stragglers (seed-drawn, or clients
    ``[0, n)`` with ``cohort="head"``): they deliver ``delay`` (+
    UniformInt[0, jitter]) rounds late, run ``slow_tau`` local steps when
    set, or never deliver with ``drop=True`` (delay :data:`NEVER`)."""

    def __init__(self, frac: float = 0.2, delay: int = 4, jitter: int = 0,
                 slow_tau: Optional[int] = None, drop: bool = False,
                 cohort: str = "random", alpha: float = 0.5,
                 max_staleness: Optional[int] = None):
        super().__init__(alpha, max_staleness)
        if not 0.0 <= frac <= 1.0:
            raise ValueError(f"straggler frac must be in [0, 1], "
                             f"got {frac}")
        if delay < 0 or jitter < 0:
            raise ValueError(f"straggler delay/jitter must be >= 0, got "
                             f"delay={delay} jitter={jitter}")
        if slow_tau is not None and slow_tau < 1:
            raise ValueError(f"straggler slow_tau must be >= 1, "
                             f"got {slow_tau}")
        if cohort not in ("random", "head"):
            raise ValueError(f"straggler cohort must be 'random' or "
                             f"'head', got {cohort!r}")
        self.frac, self.delay, self.jitter = float(frac), int(delay), \
            int(jitter)
        self.slow_tau = None if slow_tau is None else int(slow_tau)
        self.drop = bool(drop)
        self.cohort = cohort
        self._slow = None

    def setup(self, num_clients, seed):
        self._slow = np.zeros(num_clients, bool)
        n = int(round(self.frac * num_clients))
        if n:
            if self.cohort == "head":
                self._slow[:n] = True
            else:
                cr = np.random.RandomState(
                    (seed * 2654435761 + 97) % (2 ** 31))
                self._slow[cr.choice(num_clients, size=n,
                                     replace=False)] = True

    def sample_delays(self, rng, num_clients):
        d = np.zeros(num_clients, np.int64)
        if self.drop:
            d[self._slow] = NEVER
            return d
        base = np.full(num_clients, self.delay, np.int64)
        if self.jitter:
            # all K drawn, whatever the cohort (stream invariance)
            base = base + rng.randint(0, self.jitter + 1,
                                      size=num_clients)
        d[self._slow] = base[self._slow]
        return d

    def sample_tau(self, num_clients, tau):
        if self.slow_tau is None:
            return None
        t = np.full(num_clients, tau, np.int32)
        t[self._slow] = min(self.slow_tau, tau)
        return t


def make_latency(cfg):
    """Resolve ``cfg.latency`` through the registry and run its one-time
    ``setup`` against the config's seed."""
    try:
        model = LATENCIES.get(cfg.latency)(**(cfg.latency_kw or {}))
    except TypeError as e:
        raise ValueError(
            f"FLConfig.latency_kw {cfg.latency_kw!r} does not match "
            f"latency model {cfg.latency!r}: {e}") from e
    model.setup(cfg.num_clients, cfg.seed)
    return model

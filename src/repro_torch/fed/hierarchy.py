"""Hierarchical (edge -> region -> global) aggregation tiers of the port.

Counterpart of ``repro.fed.hierarchy``. Clients upload to an *edge*
aggregator, edges forward a partial aggregate to a *region*, regions to
the *global* server. The topology sits behind the engine's aggregator
seam without changing any round history:

* :class:`TierMap` (pure NumPy, a copy of the JAX package's) resolves
  ``FLConfig.tiers`` into a client -> edge and edge -> region assignment
  (a contiguous balanced split in client order, or a seed-derived
  shuffle on its own ``RandomState`` stream) and the per-tier wire bytes
  the :class:`~repro_torch.comm.accounting.CommLedger` records each round.
* :class:`HierarchicalAggregator` wraps a streaming aggregator
  (``DenseAggregator`` or ``SparseTopKAggregator``). Its carry holds the
  inner aggregator's flat carry, on which ``accumulate`` runs the inner
  fold verbatim, so ``finalize`` is the un-tiered fold bit for bit; and an
  ``(E, ...)`` edge carry per leaf into which each chunk's clients fold
  with one ``index_add_`` per leaf per chunk, on ``(edge_id, row, idx)``.
  The edge partials agree with the JAX package's at fp32 tolerance, not to
  the bit: ``index_add_`` runs on atomics on the card, which reassociate,
  and the JAX fold (a ``lax.scan`` over clients) promises only the flat
  carry exactly. Summing the edge partials recovers the flat carry up to
  fp32 reassociation.

A robust rule (collect mode) cannot fold over partial aggregates, and a
lossy codec's payloads fold through the dequant kernel: under those the
tier map is accounting-only, as in the JAX engine.

Bytes per round (``TierMap.round_bytes``): the edge tier carries the
round's real client uplink bytes; every active edge (one participating
client or more) ships one dense fp32 partial carry upstream, and every
active region one more.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["TierMap", "HierarchicalAggregator", "make_tier_map"]


class TierMap:
    """Client -> edge (-> region) assignment resolved from
    ``FLConfig.tiers`` (see ``flconfig.py`` for the accepted spellings)."""

    def __init__(self, num_clients: int, levels, assign: str = "contiguous",
                 seed: int = 0):
        levels = [int(n) for n in levels]
        if not 1 <= len(levels) <= 2:
            raise ValueError(f"tiers levels must be [n_edges] or "
                             f"[n_edges, n_regions], got {levels!r}")
        self.num_clients = int(num_clients)
        self.n_edges = levels[0]
        self.n_regions = levels[1] if len(levels) == 2 else None
        self.assign = assign
        # contiguous balanced split: client k -> edge floor(k*E/K)
        edge_of = (np.arange(self.num_clients, dtype=np.int64)
                   * self.n_edges) // self.num_clients
        if assign == "shuffle":
            # the JAX package's dedicated stream for the permutation
            perm = np.random.RandomState(
                (seed * 2654435761 + 193) % (2 ** 31)
            ).permutation(self.num_clients)
            edge_of = edge_of[perm]
        elif assign != "contiguous":
            raise ValueError(f"tiers assign must be 'contiguous' or "
                             f"'shuffle', got {assign!r}")
        self.edge_of = edge_of.astype(np.int32)
        if self.n_regions is not None:
            self.region_of = ((np.arange(self.n_edges, dtype=np.int64)
                               * self.n_regions)
                              // self.n_edges).astype(np.int32)
        else:
            self.region_of = None

    def edge_ids_padded(self, padded_clients: int) -> np.ndarray:
        """(Kp,) edge id per client slot; pad clients route to edge 0
        (they contribute exact zeros: the aggregators' ``w > 0`` gate)."""
        out = np.zeros(padded_clients, np.int32)
        out[:self.num_clients] = self.edge_of
        return out

    def round_bytes(self, active_clients: np.ndarray, payload_bytes: float,
                    carry_bytes: float) -> Dict[str, float]:
        """Per-tier wire bytes of one round: ``active_clients`` (K,) the
        participation (or, buffered, the delivered cohort),
        ``payload_bytes`` the round's client uplink bytes, ``carry_bytes``
        one dense fp32 partial carry (``4 * n_params``)."""
        act = np.asarray(active_clients)[:self.num_clients] > 0
        edges = np.unique(self.edge_of[act])
        out = {"edge": float(payload_bytes)}
        if self.region_of is not None:
            regions = np.unique(self.region_of[edges]) if edges.size else \
                np.empty(0, np.int32)
            out["region"] = float(edges.size) * float(carry_bytes)
            out["global"] = float(regions.size) * float(carry_bytes)
        else:
            out["global"] = float(edges.size) * float(carry_bytes)
        return out


def make_tier_map(cfg) -> Optional[TierMap]:
    """``FLConfig.tiers`` (validated there) as a :class:`TierMap`, or None
    for the flat fold."""
    if cfg.tiers is None:
        return None
    if isinstance(cfg.tiers, dict):
        return TierMap(cfg.num_clients, cfg.tiers["levels"],
                       assign=cfg.tiers.get("assign", "contiguous"),
                       seed=cfg.seed)
    return TierMap(cfg.num_clients, cfg.tiers, seed=cfg.seed)


class HierarchicalAggregator:
    """A streaming aggregator's wrapper that folds per-edge partial carries
    beside the inner aggregator's untouched flat carry.

    The carry is ``{"flat": inner carry, "edge": {name: (E, ...)},
    "pos": int}``. Every scheduler that reaches this wrapper folds the
    client slots in order, chunk after chunk from slot 0, so ``pos``
    addresses the ``edge_ids`` table for each chunk's clients."""

    def __init__(self, inner, edge_ids: np.ndarray, n_edges: int):
        self.inner = inner
        self.n_edges = int(n_edges)
        self._edge_ids = torch.as_tensor(np.asarray(edge_ids, np.int64))
        self.payload_keys = getattr(inner, "payload_keys", None)

    def init(self, params):
        flat = self.inner.init(params)
        dev = next(iter(flat.values())).device
        if self._edge_ids.device != dev:
            self._edge_ids = self._edge_ids.to(dev)
        edge = {k: torch.zeros((self.n_edges,) + tuple(a.shape),
                               dtype=a.dtype, device=a.device)
                for k, a in flat.items()}
        return {"flat": flat, "edge": edge, "pos": 0}

    def accumulate(self, acc, w, out):
        n = w.shape[0]
        pos = acc["pos"]
        ids = self._edge_ids[pos:pos + n]
        # the inner fold runs verbatim on the flat carry: finalize is the
        # un-tiered aggregation bit for bit
        flat = self.inner.accumulate(acc["flat"], w, out)
        on = w > 0
        if isinstance(out, tuple):
            send, gscale = out
            coeff = w * gscale
            for name, e in acc["edge"].items():
                sk = send[name]
                val = torch.where(on[:, None, None],
                                  coeff[:, None, None] * sk["val"], 0.0)
                nb, block = e.shape[1], e.shape[2]
                row = torch.arange(nb, device=e.device)[None, :, None]
                flat_idx = (ids[:, None, None] * nb + row) * block \
                    + sk["idx"].long()
                e.view(-1).index_add_(0, flat_idx.reshape(-1),
                                      val.reshape(-1))
        else:
            for name, e in acc["edge"].items():
                g = out[name]
                wk = w.reshape((-1,) + (1,) * (g.dim() - 1))
                e.index_add_(0, ids, torch.where(
                    wk > 0, wk * g.float(), 0.0))
        return {"flat": flat, "edge": acc["edge"], "pos": pos + n}

    def finalize(self, acc):
        return self.inner.finalize(acc["flat"])

    def edge_partials(self, acc):
        """Per-leaf (E, ...) edge partial carries."""
        return acc["edge"]

    def combine_edges(self, acc):
        """The edge partials summed: the flat carry up to fp32
        reassociation (the fold an edge -> global deployment runs)."""
        return {k: a.sum(0) for k, a in acc["edge"].items()}

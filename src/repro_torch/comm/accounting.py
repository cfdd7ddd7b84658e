"""Logical communication accounting — the paper's reported metric
("floating-point parameters shared per worker", Figs. 5-8) plus the
real-byte wire ledger added with the codec subsystem.

Two parallel books are kept per round:

* ``uplink_floats`` / ``vanilla_floats`` — the paper's idealized
  fp32-scalar count (a top-k value is 1.5 floats, a scalar round is 1
  float), unchanged since PR 1 so historical trajectories stay
  comparable.
* ``wire_bytes`` / ``vanilla_wire_bytes`` — bytes a NIC would actually
  move under the active :mod:`repro_torch.comm.wire` codec (quantized values,
  varint-delta index streams, per-row scales, 1-byte rho scalars).
  ``vanilla_wire_bytes`` prices the same participants shipping the dense
  model in fp32 (4 bytes/parameter), so ``wire_savings`` reports the
  end-to-end reduction of sparsification *and* quantization together.

This module tracks the FL uplink a real client<->server deployment would
pay. It is a copy of ``repro.comm.accounting``: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class CommLedger:
    rounds: int = 0
    uplink_floats: float = 0.0
    vanilla_floats: float = 0.0
    wire_bytes: float = 0.0
    vanilla_wire_bytes: float = 0.0
    #: cumulative wire bytes per aggregation tier when the engine runs a
    #: hierarchical tier map (``FLConfig.tiers``): ``"edge"`` carries the
    #: clients' sparse payloads, ``"region"``/``"global"`` carry dense
    #: partial-carry models between aggregation levels
    tier_wire_bytes: Dict[str, float] = field(default_factory=dict)
    #: buffered-scheduler payloads dropped by max-staleness eviction
    #: (``latency_kw={"max_staleness": s}``)
    n_evicted: float = 0.0
    per_round: List[Dict[str, float]] = field(default_factory=list)

    def record(self, uplink: float, vanilla: float,
               wire: float = 0.0, vanilla_wire: float = 0.0,
               tiers: Optional[Dict[str, float]] = None):
        self.rounds += 1
        self.uplink_floats += uplink
        self.vanilla_floats += vanilla
        self.wire_bytes += wire
        self.vanilla_wire_bytes += vanilla_wire
        entry = {"uplink": uplink, "vanilla": vanilla,
                 "wire": wire, "vanilla_wire": vanilla_wire}
        if tiers is not None:
            for name, b in tiers.items():
                self.tier_wire_bytes[name] = (
                    self.tier_wire_bytes.get(name, 0.0) + float(b))
            entry["tiers"] = {k: float(v) for k, v in tiers.items()}
        self.per_round.append(entry)

    def state_dict(self) -> dict:
        """Checkpointable snapshot (plain dict of floats/lists — survives
        a checkpoint flatten/unflatten round-trip)."""
        return {"rounds": float(self.rounds),
                "uplink_floats": self.uplink_floats,
                "vanilla_floats": self.vanilla_floats,
                "wire_bytes": self.wire_bytes,
                "vanilla_wire_bytes": self.vanilla_wire_bytes,
                "tier_wire_bytes": dict(self.tier_wire_bytes),
                "n_evicted": self.n_evicted,
                "per_round": list(self.per_round)}

    def load_state(self, state: dict) -> None:
        self.rounds = int(state["rounds"])
        self.uplink_floats = float(state["uplink_floats"])
        self.vanilla_floats = float(state["vanilla_floats"])
        self.wire_bytes = float(state["wire_bytes"])
        self.vanilla_wire_bytes = float(state["vanilla_wire_bytes"])
        self.tier_wire_bytes = {
            k: float(v) for k, v in state.get("tier_wire_bytes", {}).items()}
        self.n_evicted = float(state.get("n_evicted", 0.0))
        self.per_round = [
            {k: ({kk: float(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else float(v))
             for k, v in entry.items()}
            for entry in state.get("per_round", [])]

    @property
    def savings(self) -> float:
        if self.vanilla_floats == 0:
            return 0.0
        return 1.0 - self.uplink_floats / self.vanilla_floats

    @property
    def wire_savings(self) -> float:
        if self.vanilla_wire_bytes == 0:
            return 0.0
        return 1.0 - self.wire_bytes / self.vanilla_wire_bytes

    def summary(self) -> Dict[str, float]:
        out = {"rounds": self.rounds, "uplink_floats": self.uplink_floats,
               "vanilla_floats": self.vanilla_floats,
               "savings": self.savings,
               "wire_bytes": self.wire_bytes,
               "vanilla_wire_bytes": self.vanilla_wire_bytes,
               "wire_savings": self.wire_savings}
        if self.tier_wire_bytes:
            out["tier_wire_bytes"] = dict(self.tier_wire_bytes)
        if self.n_evicted:
            out["n_evicted"] = self.n_evicted
        return out

"""Roofline terms of one step on one NVIDIA H100: the counterpart of
``repro.analysis.roofline``.

Terms (per card):
    compute    = FLOPs_per_device / peak_FLOP/s
    memory     = bytes_per_device / HBM_bw
    collective = collective_bytes_per_device / link_bw

The JAX package reads FLOPs and bytes off XLA's cost pass and parses the
collectives out of the optimized HLO. The port has no HLO: the FLOPs come
from ``torch.utils.flop_counter`` (``launch/dryrun.py``), and the
collectives are records ``(kind, result_bytes, group_size)`` that a
sharding plan lists. On one card there is none, so the list is empty.

Hardware constants: one H100 SXM at 700 W, NVIDIA's data sheet: 989
TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s fp32 outside them,
3.35 TB/s of HBM3, NVLink 4 at 900 GB/s, 450 GB/s each way.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

PEAK_FLOPS = 989e12
#: fp32 on the CUDA cores (no tensor cores): kernels that compute in fp32
FP32_PEAK_FLOPS = 67e12
HBM_BW = 3.35e12
LINK_BW = 450e9
#: device memory of one H100 80GB
HBM_BYTES = 80e9

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s4": 1, "u4": 1,
}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

#: one collective of a plan: (kind, bytes of its result per device,
#: replica-group size)
Collective = Tuple[str, int, int]


def shape_bytes(dtype: str, dims: Iterable[int]) -> int:
    """Bytes of an array of ``dims`` in the HLO dtype name ``dtype``."""
    n = 1
    for d in dims:
        n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes(records: Iterable[Collective]) -> Dict[str, float]:
    """Per-device link bytes per collective kind, from the result bytes R
    and the group size n of each record, with the ring traffic factors of
    the JAX package:
        all-reduce          2 R (n-1)/n     (reduce-scatter + all-gather)
        all-gather          R (n-1)/n       (R = gathered result)
        reduce-scatter      R (n-1)         (input = n R per device)
        all-to-all          R (n-1)/n
        collective-permute  R
    A group of one moves nothing and is not counted."""
    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_OPS}
    out["count"] = 0
    for kind, r_bytes, n in records:
        if kind not in COLLECTIVE_OPS:
            raise ValueError(f"unknown collective {kind!r}")
        if n <= 1:
            continue
        if kind == "all-reduce":
            traffic = 2.0 * r_bytes * (n - 1) / n
        elif kind in ("all-gather", "all-to-all"):
            traffic = r_bytes * (n - 1) / n
        elif kind == "reduce-scatter":
            traffic = float(r_bytes) * (n - 1)
        else:  # collective-permute
            traffic = float(r_bytes)
        out[kind] += traffic
        out["count"] += 1
    out["total"] = sum(out[k] for k in COLLECTIVE_OPS)
    return out


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_global: float
    compute_s: float = field(init=False)
    memory_s: float = field(init=False)
    collective_s: float = field(init=False)

    def __post_init__(self):
        self.compute_s = self.flops_per_device / PEAK_FLOPS
        self.memory_s = self.bytes_per_device / HBM_BW
        self.collective_s = self.collective_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops_global / total if total else 0.0

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops_global,
            "hlo_flops_per_dev": self.flops_per_device,
            "hlo_bytes_per_dev": self.bytes_per_device,
            "coll_bytes_per_dev": self.collective_bytes_per_device,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops(cfg, shape_cfg, n_active_params: int) -> float:
    """6 * N_active * D (training) or 2 * N_active * D (inference)."""
    if shape_cfg.kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 6.0 * n_active_params * tokens
    if shape_cfg.kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * n_active_params * tokens
    # decode: one token per sequence
    return 2.0 * n_active_params * shape_cfg.global_batch


def build_report(arch: str, shape: str, mesh_name: str, chips: int,
                 cost: Optional[dict], collectives: Iterable[Collective],
                 model_flops_global: float) -> RooflineReport:
    """``cost``: ``{"flops", "bytes accessed"}`` per device, as XLA's cost
    pass names them; ``collectives``: the plan's records (empty on one
    card)."""
    cost = cost or {}
    coll = collective_bytes(collectives)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=float(cost.get("flops", 0.0)),
        bytes_per_device=float(cost.get("bytes accessed", 0.0)),
        collective_bytes_per_device=float(coll["total"]),
        model_flops_global=model_flops_global,
    )

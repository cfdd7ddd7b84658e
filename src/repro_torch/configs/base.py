"""Configuration types of the PyTorch port (the two paper archs only).

``ArchConfig`` keeps the fields of ``repro.configs.base.ArchConfig`` that
the paper's FCN and CNN use, with the same defaults; ``LBGMConfig`` is the
arch-side view of :class:`repro_torch.fed.flconfig.FLConfig`, whose shared
defaults it reads so the two cannot drift.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.fed.flconfig import FLConfig

_FL_DEFAULTS = {f.name: f.default for f in dataclasses.fields(FLConfig)}


@dataclass(frozen=True)
class LBGMConfig:
    """Paper Algorithm 1 knobs — arch-side view of ``FLConfig``."""
    enabled: bool = _FL_DEFAULTS["use_lbgm"]
    variant: str = "full"           # "full" | "topk"
    delta_threshold: float = _FL_DEFAULTS["delta_threshold"]
    k_frac: float = 0.01            # for variant="topk"
    num_clients: int = 16
    local_steps: int = 1            # tau
    sample_frac: float = _FL_DEFAULTS["sample_frac"]

    def to_fl(self, **overrides) -> FLConfig:
        """The canonical engine config carrying these knobs."""
        return FLConfig.from_lbgm(self, **overrides)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                  # fcn | cnn
    source: str
    n_layers: int = 2
    d_model: int = 512              # FCN hidden width / CNN base channels
    vocab_size: int = 32768         # classes
    dtype: str = "bfloat16"
    dp_mode: str = "replicated"
    remat: bool = True
    lbgm: LBGMConfig = field(default_factory=LBGMConfig)

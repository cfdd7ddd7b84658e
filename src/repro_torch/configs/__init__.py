"""Architecture registry of the port: the paper's FCN and CNN, and the
decoder LMs of the serving slice (qwen3-1.7b, rwkv6-3b)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, LBGMConfig,
                                      MoEConfig, ShapeConfig, param_count)

_MODULES = {
    "paper-cnn": "repro_torch.configs.paper_cnn",
    "paper-fcn": "repro_torch.configs.paper_fcn",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


__all__ = ["ArchConfig", "INPUT_SHAPES", "LBGMConfig", "MoEConfig",
           "ShapeConfig", "get_config", "param_count"]

"""Architecture registry of the port: ``--arch <id>`` resolves through
the same ids as the JAX package's registry (the paper's FCN and CNN and
the ten assigned LM archs)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, LBGMConfig,
                                      MoEConfig, ShapeConfig,
                                      active_param_count, param_count)

_MODULES = {
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "paper-cnn": "repro_torch.configs.paper_cnn",
    "paper-fcn": "repro_torch.configs.paper_fcn",
}

ASSIGNED_ARCHS = [k for k in _MODULES if not k.startswith("paper-")]


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def all_configs():
    return {name: get_config(name) for name in _MODULES}


__all__ = ["ASSIGNED_ARCHS", "ArchConfig", "INPUT_SHAPES", "LBGMConfig",
           "MoEConfig", "ShapeConfig", "active_param_count", "all_configs",
           "get_config", "param_count"]

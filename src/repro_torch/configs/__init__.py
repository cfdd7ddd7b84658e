"""Architecture registry of the port: the paper's FCN and CNN."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, LBGMConfig

_MODULES = {
    "paper-cnn": "repro_torch.configs.paper_cnn",
    "paper-fcn": "repro_torch.configs.paper_fcn",
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


__all__ = ["ArchConfig", "LBGMConfig", "get_config"]

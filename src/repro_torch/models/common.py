"""Minimal pure-function module system of the port.

Counterpart of ``repro.models.common``. Parameters live in a *flat dict*
keyed by slash-separated paths, with the JAX package's names and layouts,
passed to plain apply functions; ``torch.func.grad``/``vmap`` take that
dict directly. A parallel flat dict maps each key to its logical axis
names.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Axes = Dict[str, Tuple[str, ...]]


class ParamStore:
    """Collects params + logical axes during model init.

    Every draw comes from the explicit ``torch.Generator`` it is given, on
    the CPU, so the same seed gives the same weights whatever device the
    params are moved to afterwards. The draws are torch's, not
    ``jax.random``'s: to run both packages from identical weights, carry
    the JAX package's params across with :func:`params_from_numpy`.
    """

    def __init__(self, gen: torch.Generator, dtype=torch.float32):
        self._gen = gen
        self.dtype = dtype
        self.params: Params = {}
        self.axes: Axes = {}

    def param(self, name: str, shape, axes, init: str = "normal",
              scale: float | None = None, dtype=None) -> torch.Tensor:
        assert name not in self.params, f"duplicate param {name}"
        assert len(shape) == len(axes), (name, shape, axes)
        dtype = dtype or self.dtype
        shape = tuple(shape)
        if init == "normal":
            # fan-in scaled normal; last contraction dim heuristic
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            s = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
            arr = torch.randn(shape, generator=self._gen,
                              dtype=torch.float32) * s
        elif init == "zeros":
            arr = torch.zeros(shape, dtype=torch.float32)
        elif init == "ones":
            arr = torch.ones(shape, dtype=torch.float32)
        elif init == "uniform":
            s = scale if scale is not None else 1.0
            arr = (torch.rand(shape, generator=self._gen,
                              dtype=torch.float32) * 2 - 1) * s
        else:
            raise ValueError(init)
        arr = arr.to(dtype)
        self.params[name] = arr
        self.axes[name] = tuple(axes)
        return arr


def params_from_numpy(np_params: Mapping[str, np.ndarray], device) -> Params:
    """The JAX package's flat param dict (as numpy arrays, names and
    layouts unchanged) as torch tensors on ``device`` — how a test runs
    both packages from identical initial weights."""
    return {k: torch.as_tensor(np.array(v, copy=True)).to(device)
            for k, v in np_params.items()}

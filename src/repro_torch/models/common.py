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

#: elements past which ``ParamStore`` draws a leaf slice by slice (2^31:
#: only the stacked expert weights of the full-width MoE models pass it)
SLICED_DRAW = 2 ** 31


class ParamStore:
    """Collects params + logical axes during model init.

    Every draw comes from the explicit ``torch.Generator`` it is given, on
    that generator's device: a CPU generator gives the same weights
    whatever device the params are moved to afterwards, and a CUDA one
    draws a full-size model on the card without a pass through host
    memory (other numbers than a CPU generator of the same seed). The
    draws are torch's, not ``jax.random``'s: to run both packages from
    identical weights, carry the JAX package's params across with
    :func:`params_from_numpy`. ``device="meta"`` makes shapes and dtypes
    only, with no draw. A drawn leaf of more than :data:`SLICED_DRAW`
    elements (the stacked expert weights of mixtral-8x22b and llama4) is
    drawn in fp32 one slice of its leading axes at a time, each cast into
    the leaf as it comes, so that the fp32 draw of the whole leaf (26 GB
    for 8 of mixtral's layers) never exists; its numbers are those slices'
    draws, not one draw of the whole shape.
    """

    def __init__(self, gen: torch.Generator, dtype=torch.float32,
                 device=None):
        self._gen = gen
        self._device = gen.device if device is None else torch.device(device)
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
            arr = self._draw(shape, dtype, lambda sh: torch.randn(
                sh, generator=self._gen, dtype=torch.float32,
                device=self._device) * s)
        elif init == "zeros":
            arr = torch.zeros(shape, dtype=torch.float32, device=self._device)
        elif init == "ones":
            arr = torch.ones(shape, dtype=torch.float32, device=self._device)
        elif init == "uniform":
            # U(-s, s), as jax.random.uniform(minval=-s, maxval=s)
            s = scale if scale is not None else 1.0
            arr = self._draw(shape, dtype, lambda sh: (torch.rand(
                sh, generator=self._gen, dtype=torch.float32,
                device=self._device) * 2 - 1) * s)
        else:
            raise ValueError(init)
        arr = arr.to(dtype)
        self.params[name] = arr
        self.axes[name] = tuple(axes)
        return arr

    def _draw(self, shape, dtype, draw):
        """``draw(shape)`` (fp32), or, past :data:`SLICED_DRAW` elements,
        ``draw`` of each slice over the fewest leading axes whose slices
        fit, cast into a leaf of ``dtype``."""
        if int(np.prod(shape)) <= SLICED_DRAW or self._device.type == "meta":
            return draw(shape)
        k = next(i for i in range(1, len(shape))
                 if int(np.prod(shape[i:])) <= SLICED_DRAW)
        out = torch.empty(shape, dtype=dtype, device=self._device)
        rows = out.view((-1,) + shape[k:])
        for i in range(rows.shape[0]):
            rows[i] = draw(shape[k:])
        return out


def _from_numpy(v) -> torch.Tensor:
    arr = np.array(v, copy=True)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.as_tensor does not take: the
        # same 16 bits, carried across as int16 and viewed as bf16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(arr)


def params_from_numpy(np_params: Mapping[str, np.ndarray], device) -> Params:
    """The JAX package's flat param dict (as numpy arrays, names and
    layouts unchanged; fp32 or bf16) as torch tensors on ``device``, bit
    for bit — how a test runs both packages from identical weights."""
    return {k: _from_numpy(v).to(device) for k, v in np_params.items()}


def subtree(params: Params, prefix: str) -> Params:
    """Slice a flat dict to keys under ``prefix/`` (prefix stripped)."""
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU FFN: down( silu(x@gate) * (x@up) )."""
    return (silu(x @ w_gate) * (x @ w_up)) @ w_down


def group_norm_heads(x: torch.Tensor, gamma: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm used by RWKV6 output; x: (..., H, hd)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float()).to(x.dtype)


def sinusoidal_positions(length: int, dim: int) -> torch.Tensor:
    """(length, dim) fp32 sin/cos table (sin at even columns, cos at odd),
    computed in float64 with numpy and rounded once, as in JAX."""
    pos = np.arange(length)[:, None]
    inv = np.exp(-np.log(10000.0) * (np.arange(0, dim, 2) / dim))[None, :]
    tab = np.zeros((length, dim), np.float32)
    tab[:, 0::2] = np.sin(pos * inv)
    tab[:, 1::2] = np.cos(pos * inv)
    return torch.from_numpy(tab)

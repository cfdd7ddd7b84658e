"""Abstract inputs for every (arch x shape) pair: the counterpart of
``repro.launch.specs``.

The JAX package returns ``jax.ShapeDtypeStruct`` pytrees from
``jax.eval_shape``; the port returns tensors on the ``meta`` device:
shapes and dtypes, no storage, no generator draw. The states keep the
port's host-side counters as Python ints (``step`` of a train state,
``pos`` of a decode state), where JAX keeps int32 scalars.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.frontends import extra_embed_shape
from repro_torch.models.transformer import _DTYPES, init_lm
from repro_torch.serve.decode import init_decode_state
from repro_torch.train.trainer import init_train_state

META = torch.device("meta")


def abstract_params(cfg: ArchConfig):
    """(params as meta tensors, logical axes) without allocating."""
    return init_lm(None, cfg, device=META)


def abstract_train_state(cfg: ArchConfig, num_clients: int,
                         use_lbgm: bool = True):
    """(train state as meta tensors, param logical axes)."""
    return init_train_state(None, cfg, num_clients, use_lbgm, device=META)


def abstract_decode_state(cfg: ArchConfig, batch: int, seq_len: int):
    """(decode state as meta tensors, logical axes)."""
    return init_decode_state(cfg, batch, seq_len, device=META)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                      num_clients: int) -> Dict[str, Any]:
    K = num_clients
    b = shape.global_batch // K
    T = shape.seq_len
    tau = cfg.lbgm.local_steps if cfg.dp_mode == "replicated" else 1
    lead: Tuple[int, ...] = (K, tau, b) if tau > 1 else (K, b)
    specs = {"tokens": _spec(lead + (T,), torch.int32),
             "labels": _spec(lead + (T,), torch.int32)}
    es = extra_embed_shape(cfg, b)
    if es is not None:
        specs["extra"] = _spec(lead + es[1:], _DTYPES[cfg.dtype])
    return specs


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    B, T = shape.global_batch, shape.seq_len
    specs = {"tokens": _spec((B, T), torch.int32)}
    es = extra_embed_shape(cfg, B)
    if es is not None:
        specs["extra"] = _spec(es, _DTYPES[cfg.dtype])
    return specs


def decode_token_spec(shape: ShapeConfig) -> torch.Tensor:
    return _spec((shape.global_batch, 1), torch.int32)

"""The prefill step of ``repro.train.trainer``.

The rest of the JAX module (the FL training step, ``lm_loss``, the
optimizer and the sharding glue) belongs to the training slice of the
port.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import prefill_logits


def make_prefill_step(cfg: ArchConfig):
    """``step(params, batch) -> (B, V)`` last-position logits of
    ``batch["tokens"]`` (B, T)."""
    def step(params, batch):
        return prefill_logits(params, cfg, batch["tokens"])
    return step

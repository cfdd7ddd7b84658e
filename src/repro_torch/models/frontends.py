"""Modality frontend STUBS, counterpart of ``repro.models.frontends``.

``[audio]`` / ``[vlm]`` architectures specify the transformer backbone
only; these helpers produce the precomputed frame/patch embeddings the
backbone consumes (whisper's encoder frames, qwen2-vl's vision patches).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import _DTYPES


def extra_embed_shape(cfg: ArchConfig, batch: int):
    """Shape of the stub embedding input, or None for pure-text archs."""
    if cfg.encdec:
        return (batch, cfg.encoder_seq, cfg.d_model)
    if cfg.vision_tokens:
        return (batch, cfg.vision_tokens, cfg.d_model)
    return None


def make_stub_embeds(gen: torch.Generator, cfg: ArchConfig, batch: int):
    """N(0, 0.02^2) stub embeddings in the model's dtype, drawn by ``gen``
    on its own device (as ``init_lm`` draws the weights; torch's draws,
    not ``jax.random``'s), or None for pure-text archs."""
    shape = extra_embed_shape(cfg, batch)
    if shape is None:
        return None
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * 0.02).to(_DTYPES[cfg.dtype])

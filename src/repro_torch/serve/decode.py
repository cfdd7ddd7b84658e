"""Serving: single-token decode with a KV cache of ``cache_len``.

Counterpart of ``repro.serve.decode``. Cache layouts per block kind:
  attn  — full ring cache of length seq_len (keys stored post-RoPE)
  swa   — ring cache of length min(window, seq_len)  (sub-quadratic path)
  rwkv6 — recurrent state (B, H, hd, hd) fp32 + last token embed (O(1)/token)
  rglru — hidden state (B, d) fp32 + conv tail (B, 3, d)     (O(1)/token)

An encoder-decoder (whisper) keeps ``state["enc_out"]`` (B, Te, d), which
every decoder block's cross-attention reads; M-RoPE (qwen2-vl) advances
all three position streams together from ``pos`` at decode, as in JAX
(prefill places the vision prefix on a grid, so the two differ there).

A homogeneous stack keeps its caches stacked along a leading layer axis
(``state["layers"]``), as the JAX package does. Where JAX returns new
arrays, :func:`serve_step` writes the new cache entries and states into
the state's tensors in place (a 28-layer qwen3 cache at B=8, L=4096 is
3.8 GB in bf16), and returns the same state dict with ``pos`` advanced.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv6_lib
from repro_torch.models.attention import (decode_attention, mrope_rotate,
                                          rope_rotate)
from repro_torch.models.common import rms_norm, subtree
from repro_torch.models.transformer import (_DTYPES, _apply_ffn,
                                            layer_params, uses_scan)


def _cache_len(cfg: ArchConfig, kind: str, seq_len: int,
               force_window: bool) -> int:
    if kind == "swa" or (force_window and kind == "attn"):
        return min(cfg.sliding_window, seq_len)
    return seq_len


def _block_cache(cfg: ArchConfig, kind: str, B: int, L: int, device,
                 lead=()):
    """Zero caches of one block (``lead``: a leading layer axis)."""
    hd = cfg.resolved_head_dim
    dt = _DTYPES[cfg.dtype]
    zeros = lambda shape, dtype: torch.zeros(lead + shape, dtype=dtype,
                                             device=device)
    lx = ("layers",) if lead else ()
    if kind in ("attn", "swa"):
        shape = (B, L, cfg.n_kv_heads, hd)
        axes = lx + ("batch", "cache", "kv_heads", "head_dim")
        return ({"k": zeros(shape, dt), "v": zeros(shape, dt)},
                {"k": axes, "v": axes})
    if kind == "rwkv6":
        return ({"s": zeros((B, cfg.n_heads, hd, hd), torch.float32),
                 "last": zeros((B, cfg.d_model), dt)},
                {"s": lx + ("batch", "heads", "head_dim", "head_dim2"),
                 "last": lx + ("batch", "embed")})
    if kind == "rglru":
        return ({"h": zeros((B, cfg.d_model), torch.float32),
                 "conv": zeros((B, rglru_lib.CONV_W - 1, cfg.d_model), dt)},
                {"h": lx + ("batch", "embed"),
                 "conv": lx + ("batch", "conv", "embed")})
    raise ValueError(kind)


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int,
                      use_window: Optional[bool] = None, device="cuda"):
    """Returns (state dict, logical-axes dict) on ``device``; ``pos`` is a
    Python int.

    ``use_window``: force the sliding-window cache for "attn" blocks
    (the sub-quadratic long-context path). Defaults on for long contexts
    per cfg.long_context. ``device="meta"`` gives the shapes and dtypes
    only, with no storage.
    """
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    if use_window is None:
        use_window = cfg.long_context == "swa" and seq_len > 65536
    state: Dict[str, Any] = {"pos": 0}
    axes: Dict[str, Any] = {"pos": ()}
    if cfg.encdec:
        state["enc_out"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=_DTYPES[cfg.dtype],
            device=dev)
        axes["enc_out"] = ("batch", "enc_seq", "embed")
    if uses_scan(cfg):
        kind = cfg.block_pattern[0]
        L = _cache_len(cfg, kind, seq_len, use_window)
        state["layers"], axes["layers"] = _block_cache(
            cfg, kind, batch, L, dev, lead=(cfg.n_layers,))
    else:
        for i in range(cfg.n_layers):
            kind = cfg.block_kind(i) if not cfg.encdec else "attn"
            L = _cache_len(cfg, kind, seq_len, use_window)
            state[f"layer_{i:02d}"], axes[f"layer_{i:02d}"] = _block_cache(
                cfg, kind, batch, L, dev)
    return state, axes


def _decode_attn(p, x1, cfg: ArchConfig, cache, pos: int, kind):
    """x1 (B,1,d); ring-buffer kv cache update (in place) + attention over
    the cache."""
    B = x1.shape[0]
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    L = cache["k"].shape[1]
    q = (x1 @ p["wa_q"]).reshape(B, 1, nq, hd)
    k = (x1 @ p["wa_k"]).reshape(B, 1, nkv, hd)
    v = (x1 @ p["wa_v"]).reshape(B, 1, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.mrope:
        # after the vision prefix, all three position streams advance
        # together
        pos3 = torch.full((3, B, 1), pos, dtype=torch.int64,
                          device=x1.device)
        q = mrope_rotate(q, pos3, cfg.mrope_sections, cfg.rope_theta)
        k = mrope_rotate(k, pos3, cfg.mrope_sections, cfg.rope_theta)
    else:
        posb = torch.full((B, 1), pos, dtype=torch.int64, device=x1.device)
        q = rope_rotate(q, posb, cfg.rope_theta)
        k = rope_rotate(k, posb, cfg.rope_theta)
    slot = pos % L
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    o = decode_attention(q, cache["k"], cache["v"],
                         valid_len=min(pos + 1, L))
    return o.reshape(B, 1, nq * hd) @ p["wa_o"], cache


def _decode_cross_attn(p, x1, enc_out, cfg: ArchConfig):
    """x1 (B,1,d) over the whole of enc_out (B,Te,d), k and v projected
    from it at every step, as in JAX."""
    B = x1.shape[0]
    Te = enc_out.shape[1]
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x1 @ p["wx_q"]).reshape(B, 1, nq, hd)
    k = (enc_out @ p["wx_k"]).reshape(B, Te, nkv, hd)
    v = (enc_out @ p["wx_v"]).reshape(B, Te, nkv, hd)
    o = decode_attention(q, k, v, valid_len=Te)
    return o.reshape(B, 1, nq * hd) @ p["wx_o"]


def _decode_block(p, x1, cfg: ArchConfig, kind, cache, pos: int,
                  enc_out=None):
    h = rms_norm(x1, p["norm1"], cfg.norm_eps)
    if kind in ("attn", "swa"):
        h, cache = _decode_attn(p, h, cfg, cache, pos, kind)
    elif kind == "rwkv6":
        # the scan writes the new state over the cache's (in place)
        h, (_, last) = rwkv6_lib.rwkv6_decode_step(
            subtree(p, "tmix"), h, cfg, cache["s"], cache["last"])
        cache["last"].copy_(last)
    elif kind == "rglru":
        h, (hs, conv) = rglru_lib.rglru_decode_step(
            subtree(p, "rec"), h, cfg, cache["h"], cache["conv"])
        cache["h"].copy_(hs)
        cache["conv"].copy_(conv)
    else:
        raise ValueError(kind)
    x1 = x1 + h
    if enc_out is not None:
        hx = rms_norm(x1, p["norm_x"], cfg.norm_eps)
        x1 = x1 + _decode_cross_attn(p, hx, enc_out, cfg)
    h2 = rms_norm(x1, p["norm2"], cfg.norm_eps)
    return x1 + _apply_ffn(p, h2, cfg)[0], cache


def serve_step(params, cfg: ArchConfig, state, token: torch.Tensor):
    """One decode step. token (B, 1) int -> (logits (B,1,V), state): the
    state's caches are updated in place and ``pos`` advanced by one."""
    pos = state["pos"]
    x = params["embed"][token]
    enc_out = state["enc_out"] if cfg.encdec else None
    for i, (kind, p) in enumerate(layer_params(params, cfg)):
        if uses_scan(cfg):
            cache = {k: v[i] for k, v in state["layers"].items()}
        else:
            cache = state[f"layer_{i:02d}"]
        x, _ = _decode_block(p, x, cfg, kind, cache, pos, enc_out=enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    state["pos"] = pos + 1
    return logits, state

"""Decoder-LM assembly for the block kinds the port runs.

Counterpart of ``repro.models.transformer`` for dense GQA decoders
(``attn``/``swa`` blocks with a SwiGLU FFN: qwen3) and RWKV6 (``rwkv6``:
rwkv6-3b). The params are the JAX package's flat dict, names and layouts
unchanged: a homogeneous stack keeps its ``blocks/*`` leaves with a
leading layer axis, and runs as a Python loop over layer slices where
JAX runs ``lax.scan``; a mixed pattern has one ``layer_XX/*`` subtree per
layer. MoE, RG-LRU, M-RoPE and encoder-decoder models are refused by
:class:`repro_torch.configs.base.ArchConfig` itself. Training runs
:func:`lm_loss` under autograd: blocks checkpointed per ``cfg.remat``, the
CE chunked over T with each chunk checkpointed.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import rwkv6 as rwkv6_lib
from repro_torch.models.attention import attention, rope_rotate
from repro_torch.models.common import ParamStore, rms_norm, subtree, swiglu

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ------------------------------------------------------------------ init

def _init_attn(store: ParamStore, prefix: str, cfg: ArchConfig, stack: int):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    lead = (stack,) if stack else ()
    lx = ("layers",) if stack else ()
    store.param(f"{prefix}/wa_q", lead + (d, nq * hd), lx + ("embed", "heads"))
    store.param(f"{prefix}/wa_k", lead + (d, nkv * hd),
                lx + ("embed", "kv_heads"))
    store.param(f"{prefix}/wa_v", lead + (d, nkv * hd),
                lx + ("embed", "kv_heads"))
    store.param(f"{prefix}/wa_o", lead + (nq * hd, d), lx + ("heads", "embed"))
    if cfg.qk_norm:
        store.param(f"{prefix}/q_norm", lead + (hd,), lx + ("head_dim",),
                    init="ones")
        store.param(f"{prefix}/k_norm", lead + (hd,), lx + ("head_dim",),
                    init="ones")


def _init_ffn(store: ParamStore, prefix: str, cfg: ArchConfig, stack: int):
    d, ff = cfg.d_model, cfg.d_ff
    lead = (stack,) if stack else ()
    lx = ("layers",) if stack else ()
    store.param(f"{prefix}/w_gate", lead + (d, ff), lx + ("embed", "ff"))
    store.param(f"{prefix}/w_up", lead + (d, ff), lx + ("embed", "ff"))
    store.param(f"{prefix}/w_down", lead + (ff, d), lx + ("ff", "embed"))


def _init_block(store: ParamStore, prefix: str, cfg: ArchConfig, kind: str,
                stack: int = 0):
    d = cfg.d_model
    lead = (stack,) if stack else ()
    lx = ("layers",) if stack else ()
    store.param(f"{prefix}/norm1", lead + (d,), lx + ("embed",), init="ones")
    if kind in ("attn", "swa"):
        _init_attn(store, prefix, cfg, stack)
    elif kind == "rwkv6":
        rwkv6_lib.init_rwkv6(store, prefix + "/tmix", cfg, stack)
    else:
        raise ValueError(kind)
    store.param(f"{prefix}/norm2", lead + (d,), lx + ("embed",), init="ones")
    _init_ffn(store, prefix, cfg, stack)


def uses_scan(cfg: ArchConfig) -> bool:
    """A single-kind stack keeps stacked ``blocks/*`` leaves (JAX runs them
    under ``lax.scan``)."""
    return len(cfg.block_pattern) == 1


def init_lm(gen: torch.Generator, cfg: ArchConfig, device="cuda"):
    """Returns (params flat dict, logical axes flat dict) on ``device``.
    The draws come from ``gen`` on its own device (see ``ParamStore``);
    ``device="meta"`` gives the shapes and dtypes only, with no draw."""
    meta = torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    store = ParamStore(gen, _DTYPES[cfg.dtype], device=dev if meta else None)
    d = cfg.d_model
    store.param("embed", (cfg.vocab_size, d), ("vocab", "embed"), scale=0.02)
    if uses_scan(cfg):
        _init_block(store, "blocks", cfg, cfg.block_pattern[0],
                    stack=cfg.n_layers)
    else:
        for i in range(cfg.n_layers):
            _init_block(store, f"layer_{i:02d}", cfg, cfg.block_kind(i))
    store.param("final_norm", (d,), ("embed",), init="ones")
    if not cfg.tie_embeddings:
        store.param("lm_head", (d, cfg.vocab_size), ("embed", "vocab"),
                    scale=0.02)
    return {k: v.to(dev) for k, v in store.params.items()}, store.axes


def layer_params(params: Dict[str, torch.Tensor], cfg: ArchConfig
                 ) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    """``(kind, block params)`` per layer, in order: slices of the stacked
    ``blocks/*`` leaves, or the ``layer_XX`` subtrees."""
    if uses_scan(cfg):
        # unbind: one autograd node per stacked leaf, whose backward stacks
        # the layers' gradients once (an index per layer would add a
        # zero-filled full-size gradient per layer)
        stacked = {k: v.unbind(0) for k, v in
                   subtree(params, "blocks").items()}
        for i in range(cfg.n_layers):
            yield cfg.block_pattern[0], {k: v[i] for k, v in stacked.items()}
    else:
        for i in range(cfg.n_layers):
            yield cfg.block_kind(i), subtree(params, f"layer_{i:02d}")


# ------------------------------------------------------------------ fwd

def _apply_attn_train(p, x, cfg: ArchConfig, kind: str, positions,
                      window_override=None):
    B, T, d = x.shape
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wa_q"]).reshape(B, T, nq, hd)
    k = (x @ p["wa_k"]).reshape(B, T, nkv, hd)
    v = (x @ p["wa_v"]).reshape(B, T, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope_rotate(q, positions, cfg.rope_theta)
    k = rope_rotate(k, positions, cfg.rope_theta)
    window = window_override if window_override is not None else (
        cfg.sliding_window if kind == "swa" else None)
    o = attention(q, k, v, causal=True, window=window)
    return o.reshape(B, T, nq * hd) @ p["wa_o"]


def _apply_ffn(p, x, cfg: ArchConfig):
    """Dense SwiGLU. Returns (out, aux loss 0.0), JAX's signature."""
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"]), 0.0


def _apply_block_train(p, x, cfg: ArchConfig, kind: str, positions):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind in ("attn", "swa"):
        h = _apply_attn_train(p, h, cfg, kind, positions)
    elif kind == "rwkv6":
        h, _ = rwkv6_lib.apply_rwkv6(subtree(p, "tmix"), h, cfg)
    else:
        raise ValueError(kind)
    x = x + h
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    h2, aux = _apply_ffn(p, h2, cfg)
    return x + h2, aux


def forward_hidden(params: Dict[str, torch.Tensor], cfg: ArchConfig,
                   tokens: torch.Tensor):
    """Backbone forward to the final hidden states. tokens (B,T) ->
    (hidden (B,T,d), aux loss). Under autograd with ``cfg.remat`` each
    block is checkpointed (its activations recomputed in the backward), as
    the JAX package's ``jax.checkpoint`` of the block."""
    B, T = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = 0.0
    for kind, p in layer_params(params, cfg):
        if remat:
            x, aux = checkpoint(_apply_block_train, p, x, cfg, kind,
                                positions, use_reentrant=False)
        else:
            x, aux = _apply_block_train(p, x, cfg, kind, positions)
        aux_total += aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux_total


def _head(params, cfg: ArchConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params, cfg: ArchConfig, tokens):
    """Full-logit forward (small models / tests). -> (logits (B,T,V), aux)."""
    x, aux = forward_hidden(params, cfg, tokens)
    return x @ _head(params, cfg), aux


def prefill_logits(params, cfg: ArchConfig, tokens):
    """Inference prefill: hidden for all positions, head for the last one."""
    x, _ = forward_hidden(params, cfg, tokens)
    return x[:, -1] @ _head(params, cfg)


def _chunk_ce(xc, lc, head):
    """Summed next-token CE and label count of one chunk (B, c, d)."""
    logits = (xc @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.clamp(min=0)[..., None].long())[..., 0]
    mask = (lc >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def lm_loss(params, cfg: ArchConfig, tokens, labels, ce_chunk: int = 512):
    """Next-token CE with a *chunked* softmax over T so the (B,T,V) logits
    never exist at once: each chunk of ``ce_chunk`` positions is
    checkpointed (its logits recomputed in the backward). labels = next
    tokens (caller-shifted); negative labels are masked. Returns (loss,
    {"ce", "aux"})."""
    x, aux = forward_hidden(params, cfg, tokens)
    head = _head(params, cfg)
    T = x.shape[1]
    c = min(ce_chunk, T)
    if T % c:
        raise ValueError(f"seq len {T} is not a multiple of ce_chunk {c}")
    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, T, c):
        xc, lc = x[:, i:i + c], labels[:, i:i + c]
        if torch.is_grad_enabled():
            t, n = checkpoint(_chunk_ce, xc, lc, head, use_reentrant=False)
        else:
            t, n = _chunk_ce(xc, lc, head)
        tot, cnt = tot + t, cnt + n
    ce = tot / torch.clamp(cnt, min=1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    return ce + aux, {"ce": ce, "aux": aux}

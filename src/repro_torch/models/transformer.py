"""Decoder-LM assembly covering every architecture family of the JAX
package.

Counterpart of ``repro.models.transformer``: dense GQA decoders
(``attn``/``swa`` blocks: qwen3, yi, deepseek, mistral-large), MoE FFNs
(mixtral, llama4), RWKV6 (``rwkv6``: rwkv6-3b), the hybrid RG-LRU + local
attention pattern (``rglru``: recurrentgemma), the encoder-decoder
backbone (whisper: ``enc_XX``/``dec_XX`` subtrees, a non-causal encoder
over the stub frames with sinusoidal positions, cross-attention in every
decoder block) and the early-fusion VLM backbone (qwen2-vl: M-RoPE, stub
patches over the first token embeddings). The params are the JAX
package's flat dict, names and layouts unchanged: a homogeneous stack
(one block kind, no encoder) keeps its ``blocks/*`` leaves with a leading
layer axis, and runs as a Python loop over layer slices where JAX runs
``lax.scan``; a mixed pattern has one ``layer_XX/*`` subtree per layer.
Every attention call (causal, windowed, the encoder's and the cross
attention) runs the flash kernel through :func:`attention`. Training
runs :func:`lm_loss` under autograd: blocks checkpointed per
``cfg.remat``, the CE chunked over T with each chunk checkpointed.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv6_lib
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.attention import attention, mrope_rotate, rope_rotate
from repro_torch.models.common import (ParamStore, rms_norm,
                                       sinusoidal_positions, subtree, swiglu)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ------------------------------------------------------------------ init

def _init_attn(store: ParamStore, prefix: str, cfg: ArchConfig, stack: int,
               cross: bool = False):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    lead = (stack,) if stack else ()
    lx = ("layers",) if stack else ()
    tag = "x" if cross else "a"
    store.param(f"{prefix}/w{tag}_q", lead + (d, nq * hd),
                lx + ("embed", "heads"))
    store.param(f"{prefix}/w{tag}_k", lead + (d, nkv * hd),
                lx + ("embed", "kv_heads"))
    store.param(f"{prefix}/w{tag}_v", lead + (d, nkv * hd),
                lx + ("embed", "kv_heads"))
    store.param(f"{prefix}/w{tag}_o", lead + (nq * hd, d),
                lx + ("heads", "embed"))
    if cfg.qk_norm and not cross:
        store.param(f"{prefix}/q_norm", lead + (hd,), lx + ("head_dim",),
                    init="ones")
        store.param(f"{prefix}/k_norm", lead + (hd,), lx + ("head_dim",),
                    init="ones")


def _init_ffn(store: ParamStore, prefix: str, cfg: ArchConfig, stack: int):
    if cfg.moe.num_experts:
        moe_lib.init_moe(store, prefix + "/moe", cfg, stack)
        return
    d, ff = cfg.d_model, cfg.d_ff
    lead = (stack,) if stack else ()
    lx = ("layers",) if stack else ()
    store.param(f"{prefix}/w_gate", lead + (d, ff), lx + ("embed", "ff"))
    store.param(f"{prefix}/w_up", lead + (d, ff), lx + ("embed", "ff"))
    store.param(f"{prefix}/w_down", lead + (ff, d), lx + ("ff", "embed"))


def _init_block(store: ParamStore, prefix: str, cfg: ArchConfig, kind: str,
                stack: int = 0, cross: bool = False):
    d = cfg.d_model
    lead = (stack,) if stack else ()
    lx = ("layers",) if stack else ()
    store.param(f"{prefix}/norm1", lead + (d,), lx + ("embed",), init="ones")
    if kind in ("attn", "swa"):
        _init_attn(store, prefix, cfg, stack)
    elif kind == "rwkv6":
        rwkv6_lib.init_rwkv6(store, prefix + "/tmix", cfg, stack)
    elif kind == "rglru":
        rglru_lib.init_rglru(store, prefix + "/rec", cfg, stack)
    else:
        raise ValueError(kind)
    if cross:
        store.param(f"{prefix}/norm_x", lead + (d,), lx + ("embed",),
                    init="ones")
        _init_attn(store, prefix, cfg, stack, cross=True)
    store.param(f"{prefix}/norm2", lead + (d,), lx + ("embed",), init="ones")
    _init_ffn(store, prefix, cfg, stack)


def uses_scan(cfg: ArchConfig) -> bool:
    """A single-kind stack without an encoder keeps stacked ``blocks/*``
    leaves (JAX runs them under ``lax.scan``)."""
    return len(cfg.block_pattern) == 1 and not cfg.encdec


def init_lm(gen: torch.Generator, cfg: ArchConfig, device="cuda"):
    """Returns (params flat dict, logical axes flat dict) on ``device``.
    The draws come from ``gen`` on its own device (see ``ParamStore``);
    ``device="meta"`` gives the shapes and dtypes only, with no draw."""
    meta = torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    store = ParamStore(gen, _DTYPES[cfg.dtype], device=dev if meta else None)
    d = cfg.d_model
    store.param("embed", (cfg.vocab_size, d), ("vocab", "embed"), scale=0.02)
    if cfg.encdec:
        for i in range(cfg.n_encoder_layers):
            _init_block(store, f"enc_{i:02d}", cfg, "attn")
        store.param("enc_norm", (d,), ("embed",), init="ones")
        for i in range(cfg.n_layers):
            _init_block(store, f"dec_{i:02d}", cfg, "attn", cross=True)
    elif uses_scan(cfg):
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
    """``(kind, block params)`` per decoder layer, in order: slices of the
    stacked ``blocks/*`` leaves, the ``layer_XX`` subtrees, or an
    encoder-decoder's ``dec_XX`` subtrees (see :func:`encoder_params`)."""
    if cfg.encdec:
        for i in range(cfg.n_layers):
            yield "attn", subtree(params, f"dec_{i:02d}")
    elif uses_scan(cfg):
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

def encoder_params(params: Dict[str, torch.Tensor], cfg: ArchConfig
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """An encoder-decoder's ``enc_XX`` subtrees, in order."""
    for i in range(cfg.n_encoder_layers):
        yield subtree(params, f"enc_{i:02d}")


def _apply_attn_train(p, x, cfg: ArchConfig, kind: str, positions, pos3,
                      window_override=None):
    B, T, d = x.shape
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wa_q"]).reshape(B, T, nq, hd)
    k = (x @ p["wa_k"]).reshape(B, T, nkv, hd)
    v = (x @ p["wa_v"]).reshape(B, T, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.mrope and pos3 is not None:
        q = mrope_rotate(q, pos3, cfg.mrope_sections, cfg.rope_theta)
        k = mrope_rotate(k, pos3, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = rope_rotate(q, positions, cfg.rope_theta)
        k = rope_rotate(k, positions, cfg.rope_theta)
    window = window_override if window_override is not None else (
        cfg.sliding_window if kind == "swa" else None)
    o = attention(q, k, v, causal=True, window=window)
    return o.reshape(B, T, nq * hd) @ p["wa_o"]


def _apply_self_attn_noncausal(p, x, cfg: ArchConfig):
    """The encoder's self-attention: no positions rotated, no mask."""
    B, T, d = x.shape
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wa_q"]).reshape(B, T, nq, hd)
    k = (x @ p["wa_k"]).reshape(B, T, nkv, hd)
    v = (x @ p["wa_v"]).reshape(B, T, nkv, hd)
    o = attention(q, k, v, causal=False)
    return o.reshape(B, T, nq * hd) @ p["wa_o"]


def _apply_cross_attn(p, x, enc_out, cfg: ArchConfig):
    """Decoder queries (B,T,d) over the encoder's output (B,Te,d), with no
    mask."""
    B, T, d = x.shape
    Te = enc_out.shape[1]
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wx_q"]).reshape(B, T, nq, hd)
    k = (enc_out @ p["wx_k"]).reshape(B, Te, nkv, hd)
    v = (enc_out @ p["wx_v"]).reshape(B, Te, nkv, hd)
    o = attention(q, k, v, causal=False)
    return o.reshape(B, T, nq * hd) @ p["wx_o"]


def _apply_ffn(p, x, cfg: ArchConfig):
    """The MoE FFN (its ``moe/*`` subtree) or the dense SwiGLU. Returns
    (out, aux loss), JAX's signature (aux 0.0 for the dense FFN)."""
    if cfg.moe.num_experts:
        return moe_lib.apply_moe(subtree(p, "moe"), x, cfg)
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"]), 0.0


def _apply_block_train(p, x, cfg: ArchConfig, kind: str, positions,
                       pos3=None, enc_out=None, causal_attn=True):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind in ("attn", "swa"):
        if causal_attn:
            h = _apply_attn_train(p, h, cfg, kind, positions, pos3)
        else:
            h = _apply_self_attn_noncausal(p, h, cfg)
    elif kind == "rwkv6":
        h, _ = rwkv6_lib.apply_rwkv6(subtree(p, "tmix"), h, cfg)
    elif kind == "rglru":
        h, _ = rglru_lib.apply_rglru(subtree(p, "rec"), h, cfg)
    else:
        raise ValueError(kind)
    x = x + h
    if enc_out is not None:
        hx = rms_norm(x, p["norm_x"], cfg.norm_eps)
        x = x + _apply_cross_attn(p, hx, enc_out, cfg)
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    h2, aux = _apply_ffn(p, h2, cfg)
    return x + h2, aux


def build_mrope_positions(cfg: ArchConfig, B: int, T: int, device=None):
    """(3, B, T) int64 positions: a vision grid of ``vision_tokens``
    patches followed by sequential text positions (qwen2-vl style)."""
    nv = cfg.vision_tokens
    side = max(1, int(nv ** 0.5))
    idx = torch.arange(T, device=device)
    is_vis = idx < nv
    text = idx - nv + side
    pos3 = torch.stack([torch.where(is_vis, 0, text),
                        torch.where(is_vis, idx // side, text),
                        torch.where(is_vis, idx % side, text)])   # (3, T)
    return pos3[:, None, :].expand(3, B, T)


def _block(remat: bool, *args):
    """One block, checkpointed when ``remat``."""
    if remat:
        return checkpoint(_apply_block_train, *args, use_reentrant=False)
    return _apply_block_train(*args)


def encode(params, cfg: ArchConfig, frames: torch.Tensor):
    """An encoder-decoder's encoder: the stub frames (B, Te, d) plus
    sinusoidal positions, through the non-causal ``enc_XX`` blocks and
    ``enc_norm``. Returns (enc_out, aux)."""
    remat = cfg.remat and torch.is_grad_enabled()
    dt = params["embed"].dtype
    e = frames.to(dt)
    e = e + sinusoidal_positions(e.shape[1], cfg.d_model).to(
        device=e.device, dtype=dt)
    aux_total = 0.0
    for p in encoder_params(params, cfg):
        e, aux = _block(remat, p, e, cfg, "attn", None, None, None, False)
        aux_total += aux
    return rms_norm(e, params["enc_norm"], cfg.norm_eps), aux_total


def forward_hidden(params: Dict[str, torch.Tensor], cfg: ArchConfig,
                   tokens: torch.Tensor, extra_embeds=None):
    """Backbone forward to the final hidden states. tokens (B,T) ->
    (hidden (B,T,d), aux loss).

    ``extra_embeds``: modality-stub embeddings. audio (enc-dec): encoder
    input frames (B, Te, d). vlm: patch embeddings (B, n_vis, d) that
    *overwrite* the first n_vis token embeddings (early fusion). Under
    autograd with ``cfg.remat`` each block is checkpointed (its
    activations recomputed in the backward), as the JAX package's
    ``jax.checkpoint`` of the block."""
    B, T = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    pos3 = None
    if cfg.mrope:
        pos3 = build_mrope_positions(cfg, B, T, device=x.device)
        if extra_embeds is not None:
            nv = extra_embeds.shape[1]
            x = torch.cat([extra_embeds.to(x.dtype), x[:, nv:]], dim=1)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = 0.0
    enc_out = None
    if cfg.encdec:
        if extra_embeds is None:
            raise ValueError("enc-dec needs encoder frames (extra_embeds)")
        enc_out, aux_total = encode(params, cfg, extra_embeds)
    for kind, p in layer_params(params, cfg):
        x, aux = _block(remat, p, x, cfg, kind, positions, pos3, enc_out,
                        True)
        aux_total += aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux_total


def _head(params, cfg: ArchConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params, cfg: ArchConfig, tokens, extra_embeds=None):
    """Full-logit forward (small models / tests). -> (logits (B,T,V), aux)."""
    x, aux = forward_hidden(params, cfg, tokens, extra_embeds)
    return x @ _head(params, cfg), aux


def prefill_logits(params, cfg: ArchConfig, tokens, extra_embeds=None):
    """Inference prefill: hidden for all positions, head for the last one."""
    x, _ = forward_hidden(params, cfg, tokens, extra_embeds)
    return x[:, -1] @ _head(params, cfg)


def _chunk_ce(xc, lc, head):
    """Summed next-token CE and label count of one chunk (B, c, d)."""
    logits = (xc @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.clamp(min=0)[..., None].long())[..., 0]
    mask = (lc >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def lm_loss(params, cfg: ArchConfig, tokens, labels, extra_embeds=None,
            ce_chunk: int = 512):
    """Next-token CE with a *chunked* softmax over T so the (B,T,V) logits
    never exist at once: each chunk of ``ce_chunk`` positions is
    checkpointed (its logits recomputed in the backward). labels = next
    tokens (caller-shifted); negative labels are masked. Returns (ce +
    aux, {"ce", "aux"}): aux is the MoE load-balance loss summed over the
    blocks (0 for a dense FFN)."""
    x, aux = forward_hidden(params, cfg, tokens, extra_embeds)
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


# ------------------------------------------------- tensor-parallel forms
#
# model_sharding="auto": the client forward and backward of the dense
# decoder family (attn/swa blocks, a dense SwiGLU FFN, GQA, optional
# qk-norm, tied or untied head, stacked or per-layer leaves; M-RoPE and
# the stub patches of the VLM), of the recurrent families (rwkv6 blocks:
# ``rwkv6.apply_rwkv6_tp``; the RG-LRU + local attention pattern:
# ``rglru.apply_rglru_tp``) and of the MoE FFN
# (``moe.apply_moe_tp``: a rank's experts or their d_ff columns, the
# router gathered and the routes replicated) over the model ranks of
# ``models.tensor_parallel.TPContext``. Each rank runs on its resting
# shards, placed by the JAX package's spec rule: the query heads of its
# rows of wa_o, the kv heads those need (gathered where the spec cut a
# rank's kv columns off whole heads: reduced yi-34b at m = 4 rests half a
# kv head a rank, recurrentgemma's one kv head is split over every rank),
# its columns of a recurrent mixer's d x d weights, its d_ff columns (or
# its experts), its d_model columns of the embedding (gathered to full d)
# and of the head (partial logits summed in fp32). A leaf the rule leaves
# replicated runs the plain form. M-RoPE rotates each head on its head_dim
# axis alone, so a rank rotates its local heads as the plain form rotates
# them all; the VLM's patches overwrite the first positions of the
# embedding after its columns are gathered to full d.

def tensor_parallel_refusal(cfg: ArchConfig):
    """None for the block kinds with a tensor-parallel form (attn, swa,
    rwkv6 and rglru blocks with a dense or MoE FFN, M-RoPE or not), else
    the kinds without one. An encoder-decoder has none either:
    :func:`forward_hidden_tp` raises on it."""
    odd = sorted(set(cfg.block_pattern) - {"attn", "swa", "rwkv6", "rglru"})
    if odd:
        return f"{'/'.join(odd)} blocks"
    return None


def block_specs(tp, cfg: ArchConfig):
    """kind -> {key: (spec, global shape)} of a decoder layer's params of
    that block kind (every layer of one kind has the same; recurrentgemma's
    cycle holds rglru and swa layers), read off the first such layer."""
    if uses_scan(cfg):
        first = {cfg.block_pattern[0]: ("blocks/", 1)}
    else:
        first = {}
        for i in range(cfg.n_layers):
            first.setdefault(cfg.block_kind(i), (f"layer_{i:02d}/", 0))
    return {kind: {k[len(pre):]: (tp.specs[k][drop:], tp.shapes[k][drop:])
                   for k in tp.specs if k.startswith(pre)}
            for kind, (pre, drop) in first.items()}


def _sub_specs(spec, sub: str):
    return {k[len(sub) + 1:]: v for k, v in spec.items()
            if k.startswith(sub + "/")}


def _attn_heads(cfg: ArchConfig, m: int, rank: int):
    """Model rank ``rank``'s rows ``[lo, hi)`` of wa_o (its 1/m of nq·hd),
    the query heads they touch and the kv heads those use."""
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    g = nq // nkv
    n = nq * hd // m
    lo, hi = rank * n, (rank + 1) * n
    h_lo, h_hi = lo // hd, -(-hi // hd)
    return (lo, hi), (h_lo, h_hi), (h_lo // g, (h_hi - 1) // g + 1)


def _attn_weights_tp(p, cfg: ArchConfig, tp, spec):
    """The weights of this rank's query heads and the kv heads they use
    (gathered over the ranks where the spec cut them off whole heads), and
    the norms; taken outside the checkpointed local part, so a gather is
    not repeated by its recompute."""
    hd = cfg.resolved_head_dim
    plans = [_attn_heads(cfg, tp.m, r) for r in range(tp.m)]
    _, (h_lo, h_hi), (kv_lo, kv_hi) = plans[tp.rank]
    q_al = tpl.ranges_aligned(tp, cfg.n_heads * hd,
                              [(a * hd, b * hd) for _, (a, b), _ in plans])
    kv_al = tpl.ranges_aligned(tp, cfg.n_kv_heads * hd,
                               [(a * hd, b * hd) for _, _, (a, b) in plans])
    w = {"wa_q": tp.part(p["wa_q"], *spec["wa_q"], 1, h_lo * hd, h_hi * hd,
                         q_al),
         "wa_k": tp.part(p["wa_k"], *spec["wa_k"], 1, kv_lo * hd,
                         kv_hi * hd, kv_al),
         "wa_v": tp.part(p["wa_v"], *spec["wa_v"], 1, kv_lo * hd,
                         kv_hi * hd, kv_al),
         "wa_o": p["wa_o"]}
    if cfg.qk_norm:
        w["q_norm"] = tpl.copy_in(p["q_norm"], tp)
        w["k_norm"] = tpl.copy_in(p["k_norm"], tp)
    return w, plans[tp.rank]


def _attn_local_tp(w, x, cfg: ArchConfig, kind: str, positions, pos3,
                   plan):
    """This rank's partial of the attention sublayer: its query heads'
    output through its rows of wa_o (the model ranks' partials sum to
    the sublayer's output); ``w`` and ``plan`` from
    :func:`_attn_weights_tp`."""
    B, T, d = x.shape
    hd, g = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    (lo, hi), (h_lo, h_hi), (kv_lo, kv_hi) = plan
    nh, nkh = h_hi - h_lo, kv_hi - kv_lo
    q = (x @ w["wa_q"]).reshape(B, T, nh, hd)
    k = (x @ w["wa_k"]).reshape(B, T, nkh, hd)
    v = (x @ w["wa_v"]).reshape(B, T, nkh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"], cfg.norm_eps)
        k = rms_norm(k, w["k_norm"], cfg.norm_eps)
    if cfg.mrope and pos3 is not None:
        q = mrope_rotate(q, pos3, cfg.mrope_sections, cfg.rope_theta)
        k = mrope_rotate(k, pos3, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = rope_rotate(q, positions, cfg.rope_theta)
        k = rope_rotate(k, positions, cfg.rope_theta)
    if nkh > 1 and (h_lo % g or nh % g):
        # the rank's query heads do not take whole kv groups: one kv head
        # per query head, so the kernel's GQA map is the global one (with
        # one kv head, as recurrentgemma's, every map is)
        sel = torch.tensor([h // g - kv_lo for h in range(h_lo, h_hi)],
                           device=x.device)
        k, v = k[:, :, sel], v[:, :, sel]
    window = cfg.sliding_window if kind == "swa" else None
    o = attention(q, k, v, causal=True, window=window).reshape(B, T, nh * hd)
    if (lo, hi) != (h_lo * hd, h_hi * hd):
        o = o[..., lo - h_lo * hd:hi - h_lo * hd]
    return o @ w["wa_o"]


#: kind -> (params subtree, the mixer's output weight) of a recurrent mixer
_RECURRENT = {"rwkv6": ("tmix", "w_o"), "rglru": ("rec", "w_out")}


def _mixer_plain(p, h, cfg: ArchConfig, kind: str, positions, pos3):
    """The plain form of the block's mixer (its output only)."""
    if kind == "rwkv6":
        return rwkv6_lib.apply_rwkv6(subtree(p, "tmix"), h, cfg)[0]
    if kind == "rglru":
        return rglru_lib.apply_rglru(subtree(p, "rec"), h, cfg)[0]
    return _apply_attn_train(p, h, cfg, kind, positions, pos3)


def _mixer_tp(p, h, cfg: ArchConfig, kind: str, positions, pos3, tp, spec,
              remat: bool):
    """The block's mixer on the normed residual ``h``, the whole output on
    every model rank. A mixer whose output weight the rule leaves
    replicated (its heads or d_model not divisible by m) runs the plain
    form on every rank, with no collective."""
    sub, w_out = _RECURRENT.get(kind, (None, "wa_o"))
    if tp.m > 1 and tpl.MODEL not in spec[
            f"{sub}/{w_out}" if sub else w_out][0]:
        return tpl.local(remat, _mixer_plain, p, h, cfg, kind, positions,
                         pos3)
    if kind == "rwkv6":
        return rwkv6_lib.apply_rwkv6_tp(subtree(p, sub), h, cfg, tp,
                                        _sub_specs(spec, sub), remat)
    if kind == "rglru":
        return rglru_lib.apply_rglru_tp(subtree(p, sub), h, cfg, tp,
                                        _sub_specs(spec, sub), remat)
    w, plan = _attn_weights_tp(p, cfg, tp, spec)
    return tpl.reduce_out(tpl.local(remat, _attn_local_tp, w,
                                    tpl.copy_in(h, tp), cfg, kind, positions,
                                    pos3, plan), tp)


def _apply_block_tp(p, x, cfg: ArchConfig, kind: str, positions, pos3, tp,
                    spec, remat: bool):
    """One block on this rank's shards; returns (x, aux loss), as
    :func:`_apply_block_train`. Under ``remat`` each sublayer's local
    parts are checkpointed between its collectives (the plain form
    checkpoints the whole block): the backward recomputes the heads, the
    mixer's columns and the d_ff columns (or the rank's experts) but no
    collective."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + _mixer_tp(p, h, cfg, kind, positions, pos3, tp, spec, remat)
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.moe.num_experts:
        y, aux = moe_lib.apply_moe_tp(subtree(p, "moe"), h2, cfg, tp,
                                      _sub_specs(spec, "moe"), remat)
        return x + y, aux
    ffn = (p["w_gate"], p["w_up"], p["w_down"])
    if tp.m > 1 and spec["w_down"][0][0] != tpl.MODEL:
        return x + tpl.local(remat, swiglu, h2, *ffn), 0.0
    # this rank's partial of the SwiGLU: its d_ff columns
    return x + tpl.reduce_out(tpl.local(remat, swiglu, tpl.copy_in(h2, tp),
                                        *ffn), tp), 0.0


def forward_hidden_tp(params, cfg: ArchConfig, tokens: torch.Tensor, tp,
                      extra_embeds=None):
    """:func:`forward_hidden` of the families with a tensor-parallel form
    on this rank's shards: the embedding's d_model columns gathered to
    full d (its gradient, the same on every rank, sliced back), each block
    tensor-parallel. The VLM's ``extra_embeds`` (B, n_vis, d), whole on
    every rank, overwrite the first n_vis positions of the gathered
    embedding, so the embedding's gradient there is zero on every rank,
    as in the plain form. Returns (hidden, aux loss summed over the
    blocks), both the same on every model rank."""
    if cfg.encdec:
        raise ValueError(
            f"arch {cfg.name!r} is an encoder-decoder, which has no "
            "tensor-parallel form (its encoder stack and cross attention)")
    specs = block_specs(tp, cfg)
    B, T = tokens.shape
    x = params["embed"][tokens]
    if tp.specs["embed"][1] == tpl.MODEL:
        x = tpl.gather(x, -1, tp, replicated_grad=True)
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    pos3 = None
    if cfg.mrope:
        pos3 = build_mrope_positions(cfg, B, T, device=x.device)
        if extra_embeds is not None:
            nv = extra_embeds.shape[1]
            x = torch.cat([extra_embeds.to(x.dtype), x[:, nv:]], dim=1)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = 0.0
    for kind, p in layer_params(params, cfg):
        x, aux = _apply_block_tp(p, x, cfg, kind, positions, pos3, tp,
                                 specs[kind], remat)
        aux_total += aux
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total


def _chunk_ce_tp(xc, lc, head, tp, cols):
    """:func:`_chunk_ce` with the head's rows ``cols`` of d_model on this
    rank (None: the head is replicated): the partial logits of every
    rank, summed by one fp32 all_reduce."""
    if cols is None:
        return _chunk_ce(xc, lc, head)
    xc = tpl.copy_in(xc, tp)
    if cols != (0, xc.shape[-1]):
        xc = xc[..., cols[0]:cols[1]]
    logits = tpl.reduce_out((xc @ head).float(), tp)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.clamp(min=0)[..., None].long())[..., 0]
    mask = (lc >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def lm_loss_tp(params, cfg: ArchConfig, tokens, labels, tp,
               extra_embeds=None, ce_chunk: int = 512):
    """:func:`lm_loss` of the families with a tensor-parallel form (see
    :func:`tensor_parallel_refusal`; an encoder-decoder raises) on this
    rank's shards (``tp``: a ``models.tensor_parallel.TPContext``), the
    VLM's stub patches ``extra_embeds`` as :func:`forward_hidden_tp`
    takes them: ce + aux, the MoE
    load-balance loss summed over the blocks (0 for a dense FFN). The loss
    is the same on every model rank, and with m = 1 it is
    :func:`lm_loss`'s bit for bit. With m > 1 a CE chunk is not
    checkpointed: its recompute would sum the (B, c, V) partial logits
    over the ranks a second time."""
    x, aux = forward_hidden_tp(params, cfg, tokens, tp, extra_embeds)
    head = _head(params, cfg)
    name, dim = ("embed", 1) if cfg.tie_embeddings else ("lm_head", 0)
    cols = (tp.own(cfg.d_model) if tp.specs[name][dim] == tpl.MODEL
            else None)
    T = x.shape[1]
    c = min(ce_chunk, T)
    if T % c:
        raise ValueError(f"seq len {T} is not a multiple of ce_chunk {c}")
    remat = torch.is_grad_enabled() and (tp.m == 1 or cols is None)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, T, c):
        xc, lc = x[:, i:i + c], labels[:, i:i + c]
        t, n = tpl.local(remat, _chunk_ce_tp, xc, lc, head, tp, cols)
        tot, cnt = tot + t, cnt + n
    ce = tot / torch.clamp(cnt, min=1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    return ce + aux, {"ce": ce, "aux": aux}

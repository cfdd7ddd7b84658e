"""Attention: GQA, RoPE, M-RoPE, causal + sliding-window, and the decode
step.

Counterpart of ``repro.models.attention``. The full-sequence form,
:func:`attention`, runs through the hand-written flash-attention kernel
(``kernels.ops.flash_attention``) on the card and its plain version on
the CPU; the JAX package's jnp path computes the same function. It takes
a gradient: ``ops.flash_attention`` is an autograd Function whose
backward is plain PyTorch, recomputed per block of 1024 query rows. Like the
kernel it replaces (``repro.kernels.flash_attention``), it keeps the
softmax weights in fp32 through P.V; the JAX jnp path rounds them to v's
dtype first, so the two differ by bf16 rounding in bf16 models and agree
to fp32 rounding in fp32 ones. The decode step, :func:`decode_attention`,
is plain PyTorch, as it is jnp outside any kernel in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def rope_rotate(x: torch.Tensor, positions: torch.Tensor,
                theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) int. Rotates the split halves
    (x[:hd/2], x[hd/2:]) in fp32."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions[..., None].float() * freqs              # (B,T,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_rotate(x: torch.Tensor, positions3: torch.Tensor, sections,
                 theta: float) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): positions3 (3, B, T) for (t, h, w).

    The hd/2 frequency slots are partitioned into ``sections`` groups; slot
    group i uses positions3[i]. Where JAX picks each slot's stream by an
    einsum against a one-hot, this indexes it (``repeat_interleave``): the
    same numbers, since the one-hot sum adds exact zeros."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    sel = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device),
        output_size=hd // 2)                               # (hd/2,) in {0,1,2}
    pos = positions3.float()[sel].permute(1, 2, 0)         # (B, T, hd/2)
    ang = pos * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """GQA attention. q:(B,Tq,Hq,hd), k/v:(B,Tk,Hkv,hd) -> (B,Tq,Hq,hd).

    ``q_offset``: absolute position of q[0] relative to k[0] (for caches).
    ``window``: sliding-window width (keys with qpos-kpos >= window masked).
    """
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len) -> torch.Tensor:
    """Single-token decode. q:(B,1,Hq,hd); caches:(B,S,Hkv,hd); keys at
    ``valid_len`` and beyond are masked. Scores and P.V in fp32, p rounded
    to the cache dtype first, as in JAX."""
    B, _, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, hd)
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * scale
    kpos = torch.arange(S, device=q.device)
    mask = kpos[None, :] < torch.as_tensor(
        valid_len, device=q.device).reshape(-1, 1)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, Hq, hd).to(q.dtype)

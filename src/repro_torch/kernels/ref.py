"""Plain PyTorch versions of the port's kernels.

Counterparts of ``repro.kernels.ref``: the CPU path of every kernel
wrapper, the engine's and the LM's arithmetic when their device is the
CPU, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card. Every LBGM function takes an optional leading batch (client) axis.
"""
from __future__ import annotations

import torch


def lbgm_projection_ref(g: torch.Tensor, l: torch.Tensor):
    """fp32 (<g,l>, ||g||^2, ||l||^2) over the last axis of ``(..., n)``."""
    g32, l32 = g.float(), l.float()
    return ((g32 * l32).sum(-1), (g32 * g32).sum(-1), (l32 * l32).sum(-1))


def topk_abs_rows(rows: torch.Tensor, kb: int):
    """Per-row top-``kb`` by |value|, in descending |value| order with ties
    to the lowest index — ``lax.top_k``'s rule. ``torch.topk`` promises no
    tie order, so it runs here on unique int64 keys, the IEEE bits of |x|
    (monotone in the magnitude) above ``n - 1 - index``: the largest key
    is the largest |x|, and among equal |x| the lowest index.
    Returns (idx int32, signed values)."""
    n = rows.shape[-1]
    bits = rows.float().abs().view(torch.int32).to(torch.int64)
    rank = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=rows.device)
    idx = torch.topk((bits << 32) | rank, kb, dim=-1).indices
    return idx.to(torch.int32), torch.gather(rows, -1, idx)


def flat_to_blocks(g: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    """A flat leaf (..., size) as its (..., nb, block) layout, zero-padded
    at the end, in its own dtype."""
    pad = nb * block - g.shape[-1]
    if pad:
        g = torch.nn.functional.pad(g, (0, pad))
    return g.reshape(g.shape[:-1] + (nb, block))


def lbgm_sparse_decision_ref(blocks: torch.Tensor, idx: torch.Tensor,
                             block=None):
    """The three dense passes the fused sparse kernel replaces.

    blocks: (..., nb, block), or the flat leaf (..., size) with ``block=``
    given (padded with zeros to idx's nb rows first); idx: (..., nb, kb)
    int32 block-local positions. Returns ``(gg (...), gathered (..., nb,
    kb), top_idx (..., nb, kb) int32, top_val (..., nb, kb))``: top-k by
    |value| per block row in descending |value| order, values kept signed.
    """
    if block is not None:
        blocks = flat_to_blocks(blocks, idx.shape[-2], block)
    b32 = blocks.float()
    gg = (b32 * b32).sum((-2, -1))
    gathered = torch.gather(b32, -1, idx.long())
    ti, tv = topk_abs_rows(b32, idx.shape[-1])
    return gg, gathered, ti, tv


def lbgm_dequant_accum_ref(acc: torch.Tensor, w: torch.Tensor,
                           gscale: torch.Tensor, idx: torch.Tensor,
                           qv: torch.Tensor, scale: torch.Tensor):
    """Sequential dequantize + scatter-accumulate, in place on ``acc``.

    acc: (nb, block) f32; w, gscale: (C,) f32; idx: (C, nb, kb) int32
    block-local positions, unique within a row; qv: (C, nb, kb) int8 or
    float8_e4m3fn wire values; scale: (C, nb, 1) f32 row scales. Clients
    fold strictly in order, each a gather-modify-scatter:
    ``coeff = (w_c * gscale_c) * scale_c``, then
    ``a[row, idx] = a[row, idx] + where(w_c > 0, coeff * f32(qv_c), 0)``.
    The multiply and the add are separate ops (no FMA), as in the CUDA
    kernel, so the two agree bit for bit; the ``w_c > 0`` select keeps a
    phantom client's NaN payload or gscale out. Returns ``acc``."""
    for c in range(idx.shape[0]):
        w_c = w[c]
        coeff = (w_c * gscale[c]) * scale[c]             # (nb, 1)
        i_c = idx[c].long()
        add = torch.where(w_c > 0, coeff * qv[c].float(), 0.0)
        acc.scatter_(1, i_c, acc.gather(1, i_c) + add)
    return acc


def sort_topk_rows(idx: torch.Tensor, val: torch.Tensor):
    """Canonicalize a block-row top-k (idx, val) pair by ascending index."""
    order = torch.argsort(idx, dim=-1)
    return torch.gather(idx, -1, order), torch.gather(val, -1, order)


def lbgm_sparse_decision_two_pass_ref(blocks: torch.Tensor,
                                      idx: torch.Tensor, block=None):
    """The two-pass (threshold-select) decision: the same (idx, val) set
    per row as :func:`lbgm_sparse_decision_ref`, in ascending index
    order."""
    gg, gathered, ti, tv = lbgm_sparse_decision_ref(blocks, idx, block)
    ti, tv = sort_topk_rows(ti, tv)
    return gg, gathered, ti, tv


# ------------------------------------------------------- LM serving kernels

NEG_INF = -1e30
#: the chunked WKV's overflow clamp on exp(-cum) (``models/rwkv6.py``)
EXP_CLAMP = 60.0


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0):
    """Naive softmax attention. q:(BH,Tq,hd), k/v:(BH,Tk,hd).

    fp32 scores scaled by 1/sqrt(hd), masked entries set to -1e30 (causal:
    ``qpos >= kpos``; window: ``qpos - kpos < window``; ``qpos`` counts
    from ``q_offset``), softmax and P.V in fp32, output cast to q's dtype.
    """
    Tq, Tk = q.shape[1], k.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = torch.arange(Tq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_gqa_ref(q, k, v, *, causal=True, window=None,
                            q_offset=0):
    """:func:`flash_attention_ref` in the ops layout: q (B,Tq,Hq,hd), k/v
    (B,Tk,Hkv,hd), each kv head repeated for its Hq / Hkv query heads (as
    ``repro.kernels.ops.flash_attention`` does) -> (B,Tq,Hq,hd)."""
    B, Tq, Hq, hd = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = q.transpose(1, 2).reshape(B * Hq, Tq, hd)
    kf = k.transpose(1, 2).repeat_interleave(g, dim=1).reshape(B * Hq, Tk, hd)
    vf = v.transpose(1, 2).repeat_interleave(g, dim=1).reshape(B * Hq, Tk, hd)
    o = flash_attention_ref(qf, kf, vf, causal=causal, window=window,
                            q_offset=q_offset)
    return o.reshape(B, Hq, Tq, hd).transpose(1, 2)


def rwkv6_scan_ref(r, k, v, logw, u):
    """Per-timestep recurrence — the ground-truth RWKV6 semantics.
    r,k,v,logw: (BH, T, hd); u: (BH, hd). Returns fp32 (BH, T, hd).

        out_t = r_t (S_{t-1} + u * k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    r, k, v, lw = (a.float() for a in (r, k, v, logw))
    u = u.float()
    BH, T, hd = r.shape
    S = torch.zeros((BH, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(T):
        kv = torch.einsum("bd,be->bde", k[:, t], v[:, t])
        outs.append(torch.einsum("bd,bde->be", r[:, t], S + u[..., None] * kv))
        S = torch.exp(lw[:, t])[..., None] * S + kv
    return torch.stack(outs, dim=1)


#: block length of XLA's running sum on the CPU (see :func:`chunk_cumsum`)
CUMSUM_BLOCK = 16


def chunk_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """fp32 running sum along ``dim`` (at most 256 long), associated as
    XLA's CPU ``cumsum`` associates it: sequential sums inside blocks of
    16 steps, plus the sequential sum of the earlier blocks' totals.

    The chunked WKV feeds the running log decay (|cum| up to ~60 and more)
    to exponentials whose ratios cancel, so one ulp of the sum moves the
    output by ~1e-5 relative; summing in the reference's order keeps the
    port within fp32 rounding of the JAX package. ``torch.cumsum`` on the
    CPU accumulates in double, and the CUDA kernel sums in this order too.
    """
    x = x.movedim(dim, -1)
    outs, pre = [], None
    for b0 in range(0, x.shape[-1], CUMSUM_BLOCK):
        acc, blk = None, []
        for t in range(b0, min(b0 + CUMSUM_BLOCK, x.shape[-1])):
            acc = x[..., t] if acc is None else acc + x[..., t]
            blk.append(acc)
        blk = torch.stack(blk, dim=-1)
        outs.append(blk if pre is None else blk + pre[..., None])
        pre = acc if pre is None else pre + acc
    return torch.cat(outs, dim=-1).movedim(-1, dim)


def rwkv6_chunked_ref(r, k, v, logw, u, state0, chunk):
    """The chunked WKV recurrence of ``models.rwkv6.chunked_wkv``, with a
    state in and the final state out: the plain version of the port's
    scan kernel (chunk length at most 64).

    r, k, v, logw: (B, T, H, hd); u: (H, hd); state0: (B, H, hd, hd), the
    key axis first. Chunks of ``chunk`` steps (the last one may be
    shorter). Per chunk, with ``cum`` the running sum of logw:
    ``out = (tril_{-1}((r e^{cum-lw}) (k e^{min(-cum, 60)})^T) + diag(r.u.k)) v
    + (r e^{cum-lw}) S`` and ``S <- S * e^{total}[key axis] +
    (k e^{total-cum})^T v``. Returns (out fp32 (B, T, H, hd), state fp32).
    """
    B, T, H, hd = r.shape
    f = lambda a: a.float().permute(0, 2, 1, 3)               # (B,H,T,hd)
    r, k, v, lw = f(r), f(k), f(v), f(logw)
    u = u.float()
    S = state0.float().clone()
    # every chunk's running sum at once (the same adds in the same order as
    # chunk by chunk): a few hundred small ops, not a few per step and chunk
    full = T // chunk * chunk
    cums = [] if full == 0 else [chunk_cumsum(
        lw[:, :, :full].reshape(B, H, full // chunk, chunk, hd),
        dim=3).reshape(B, H, full, hd)]
    if full < T:
        cums.append(chunk_cumsum(lw[:, :, full:], dim=2))
    cum_all = torch.cat(cums, dim=2) if len(cums) > 1 else cums[0]
    outs = []
    for t0 in range(0, T, chunk):
        rc, kc, vc, lwc = (a[:, :, t0:t0 + chunk] for a in (r, k, v, lw))
        c = rc.shape[2]
        tri = torch.tril(torch.ones((c, c), device=r.device), -1)
        eye = torch.eye(c, device=r.device)
        cum = cum_all[:, :, t0:t0 + chunk]
        cum_in = cum - lwc
        r_dec = rc * torch.exp(cum_in)
        k_dec = kc * torch.exp(torch.clamp(-cum, max=EXP_CLAMP))
        A = torch.einsum("bhid,bhjd->bhij", r_dec, k_dec) * tri
        A = A + torch.einsum("bhid,bhjd->bhij", rc * u[:, None, :], kc) * eye
        out = torch.einsum("bhij,bhjd->bhid", A, vc)
        out = out + torch.einsum("bhid,bhde->bhie", r_dec, S)
        total = cum[:, :, -1:, :]
        S = S * torch.exp(total).transpose(2, 3) + torch.einsum(
            "bhjd,bhje->bhde", kc * torch.exp(total - cum), vc)
        outs.append(out)
    out = torch.cat(outs, dim=2).permute(0, 2, 1, 3)
    return out, S

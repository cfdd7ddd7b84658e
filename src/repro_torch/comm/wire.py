"""Uplink wire codecs: quantized payload encoding and real-byte accounting.

Counterpart of ``repro.comm.wire``. The compressor pipeline and the LBGM
store decide *what* a client uploads (a dense update, a sparse top-k
``(idx, val)`` payload, or one scalar rho); a codec decides how those
numbers sit on the wire and prices the bytes. Codecs resolve through
``repro_torch.fed.registry.CODECS`` (``FLConfig.codec`` / ``codec_kw``):

``none``
    fp32 legacy wire format; payloads untouched, only bytes priced.
``delta_idx``
    lossless: fp32 values, varint-delta index stream (below).
``int8`` / ``fp8``
    value quantization (int8 grid, or fp8 e4m3) with one fp32
    power-of-two scale per block row (sparse payloads) or per leaf
    (dense payloads), delta-coded indices and a 1-byte e4m3 rho on scalar
    rounds. Stochastic rounding by default; ``codec_kw={"stochastic":
    false}`` rounds to nearest.

Wire format of one full-round sparse payload, per leaf (``nb`` rows of
``kb`` entries, ``repro_torch.core.lbgm._block_layout``)::

    [values]   nb*kb * value_bytes      (4 = fp32 | 1 = int8/fp8 e4m3)
    [scales]   nb * 4                   (quantized codecs only)
    [indices]  raw: nb*kb * 4 (int32)
               delta-coded: per row, indices sorted ascending, first
               index then successive deltas, each a varint of
               1 byte (< 2^7) / 2 bytes (< 2^14) / 3 bytes otherwise
    scalar (recycle) round: scalar_bytes (4 = fp32 rho | 1 = e4m3)
    dense full round: M * value_bytes + 4 per leaf scale (quantized only)

Scales are powers of two, so ``dequantize(quantize(v))`` is exact on
values already on the grid: the LBG bank holds the dequantized values the
server decoded, and re-encoding them on a recycle round gives them back
bit for bit. :func:`pow2_scale` takes the exponent from the float's bits,
so this holds on the CPU and on the card alike.

Stochastic rounding draws one seed per client per round from the
dedicated :func:`codec_rng` stream — the JAX package's draws, seed for
seed — riding the batch dict under ``WIRE_KEY``. The uniforms are the JAX
package's too, bit for bit: leaf ``i`` (in sorted-name order) of client c
rounds with ``jax.random.uniform(fold_in(PRNGKey(seed_c), i), f.shape)``,
replayed on the payload's device by ``core.jax_prng`` (threefry on int64
lanes), so the CPU and the card draw the same uniforms as the reference.

The port's convention is batched: payload leaves carry a leading client
axis ``(C, nb, kb)``, seeds are a ``(C,)`` int64 tensor, and every byte
count comes back as a ``(C,)`` fp32 tensor (varint bytes depend on each
client's indices).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.jax_prng import fold_in_t, prng_key_t, uniform_rows
from repro_torch.fed.registry import CODECS, register_codec

#: reserved batch-dict key for the per-client stochastic-rounding seed
WIRE_KEY = "_wire_seed"

#: e4m3 largest finite magnitude (S.1111.110 = 1.75 * 2^8)
E4M3_MAX = 448.0


def codec_rng(seed: int) -> np.random.RandomState:
    """Dedicated host rng stream for stochastic-rounding seeds, separate
    from the batch/mask stream (the JAX package's transform of the
    experiment seed)."""
    return np.random.RandomState((seed + 0xC0DEC) * 16807 % (2 ** 31))


# ------------------------------------------------------------ primitives

def stochastic_round(f, u):
    """Unbiased rounding of ``f`` to the integer grid: ``E[out] = f``.
    ``u`` is uniform on [0, 1); exact integers round to themselves."""
    lo = torch.floor(f)
    return lo + (u < (f - lo)).to(f.dtype)


def _exp2_int(e: torch.Tensor) -> torch.Tensor:
    """2^e as fp32, exactly, for int32 exponents: built from the IEEE bit
    pattern, subnormals included; 0 below 2^-149."""
    normal = ((e.clamp(-126, 127) + 127) << 23).view(torch.float32)
    sub = (torch.ones_like(e) << (e + 149).clamp(0, 22)).view(torch.float32)
    out = torch.where(e >= -126, normal, sub)
    return torch.where(e < -149, torch.zeros_like(out), out)


def _ceil_log2(r: torch.Tensor) -> torch.Tensor:
    """ceil(log2(r)) of positive finite fp32 ``r``, exactly, from its bits.
    A subnormal is first scaled by 2^64 (exact) into the normal range."""
    tiny = r < 2.0 ** -126
    rn = torch.where(tiny, r * 2.0 ** 64, r)
    bits = rn.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    return e - 64 * tiny.to(torch.int32)


def pow2_scale(m: torch.Tensor, qmax: float) -> torch.Tensor:
    """Smallest power of two ``s`` with ``m / s <= qmax`` (elementwise).

    ``s = 2^ceil(log2(max(m, 1e-38) / qmax))``, with the exponent taken
    from the float's bits and ``2^e`` built from them, so the result is
    exact and the same on every device. (The JAX package computes the
    exponent with ``log2``, which on XLA's CPU backend lands above k for
    some exact powers 2^k; see ROADMAP §3.) All-zero rows get s = 1."""
    r = torch.clamp(m, min=1e-38) / qmax
    s = _exp2_int(_ceil_log2(r))
    return torch.where(m > 0, s, torch.ones_like(s))


def e4m3_nearest(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest e4m3 value of ``x`` (saturating), as fp32: the
    scalar-round rho stream, one byte on the wire."""
    return (x.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)
            .to(torch.float32))


def _e4m3_step(a: torch.Tensor) -> torch.Tensor:
    """Grid spacing of e4m3 at magnitude ``a`` (a >= 0, fp32): the exponent
    from the IEEE bits, clipped to e4m3's normal range [-6, 8]; below 2^-6
    the denormal ladder's constant step 2^-9."""
    e = ((a.view(torch.int32) >> 23) & 0xFF) - 127
    return _exp2_int(e.clamp(-6, 8) - 3)


def delta_idx_bytes(idx: torch.Tensor) -> torch.Tensor:
    """Wire bytes of the varint-delta index stream of each client's sparse
    leaf: ``idx`` (C, ..., kb) int32 block-local (< 2^16) -> (C,) fp32.
    Per row the indices are sorted ascending and sent as first index, then
    deltas, each a 1/2/3-byte varint. A kb = 1 row costs one varint; pad
    rows (iota indices) cost 1 byte per entry."""
    s = torch.sort(idx, dim=-1).values.long()
    d = torch.diff(s, dim=-1, prepend=torch.zeros_like(s[..., :1]))
    per = 1 + (d >= (1 << 7)).long() + (d >= (1 << 14)).long()
    return per.flatten(1).sum(1).float()


# ----------------------------------------------------------- codec base

class WireCodec:
    """Base codec: the fp32 legacy wire format.

    The engine calls :meth:`encode_sparse` / :meth:`encode_dense` at the
    tail of ``client_fn``, on exactly what would be serialized, and the
    aggregator dequantizes through :meth:`decode_leaf` or the fused
    dequant-accumulate kernel."""

    name = "none"
    lossy = False          # value quantization active
    stochastic = False     # consumes a per-client rounding seed
    delta_idx = False      # varint-delta index stream vs raw int32
    value_bytes = 4.0      # per transmitted payload value
    scalar_bytes = 4.0     # per scalar-round rho
    scale_bytes = 0.0      # per block row (sparse) / per leaf (dense)
    #: sparse payload leaf keys the aggregator sees
    payload_keys = ("idx", "val")
    #: under a model-sharded mesh (:meth:`bind_model_rows`): this rank's
    #: model rank, and name -> whether that leaf's payload rows are sharded
    _model_rank = 0
    _msharded = None

    def bind_model_rows(self, model_rank: int, sharded) -> None:
        """The sparse payloads this codec encodes hold model rank
        ``model_rank``'s block rows of each leaf with ``sharded[name]``
        (``model_rank * rows`` is their first row in the whole leaf), and
        the whole leaf otherwise. Stochastic rounding then draws those
        rows' uniforms of the whole leaf's stream, and the wire bytes are
        this rank's share: its rows of the sharded leaves, and on model
        rank 0 only the whole leaves and a recycle round's bytes. Summed
        over the model ranks they are the whole payload's bytes."""
        self._model_rank = int(model_rank)
        self._msharded = dict(sharded)

    def _first_row(self, name: str, rows: int) -> int:
        """First row in the whole leaf of a payload of ``rows`` rows."""
        if self._msharded and self._msharded.get(name):
            return self._model_rank * rows
        return 0

    def _counted(self, name: str) -> bool:
        """Whether this rank's wire bytes count leaf ``name``."""
        return (not self._msharded or self._msharded.get(name)
                or self._model_rank == 0)

    def _scalar_wire(self, stats) -> torch.Tensor:
        own = self._model_rank == 0
        return torch.full_like(stats.rho, self.scalar_bytes if own else 0.0)

    # ------------------------------------------------------- byte model
    def sparse_full_bytes(self, send) -> torch.Tensor:
        """Full-round wire bytes of each client's sparse ``{name: {idx,
        val, ...}}`` payload (leaves ``(C, nb, kb)``) -> (C,) fp32. Without
        delta coding no payload data is read. Every term is a whole number
        of bytes, so the sums are exact in any order."""
        static, varint = 0.0, None
        for name in sorted(send):
            idx = send[name]["idx"]
            if not self._counted(name):
                continue
            nk, nb = float(idx[0].numel()), float(idx.shape[1])
            static += self.value_bytes * nk + self.scale_bytes * nb
            if self.delta_idx:
                b = delta_idx_bytes(idx)
                varint = b if varint is None else varint + b
            else:
                static += 4.0 * nk
        if varint is None:
            return torch.full((idx.shape[0],), static, dtype=torch.float32,
                              device=idx.device)
        return varint + static

    def sparse_layout_bytes(self, layouts) -> float:
        """Static full-round wire bytes for a ``[(nb, kb), ...]`` block
        layout. The legacy dense-aggregation path over a top-k store never
        materializes the indices, so they price at the raw 4 bytes."""
        return float(sum((self.value_bytes + 4.0) * nb * kb
                         + self.scale_bytes * nb for nb, kb in layouts))

    # --------------------------------------------------------- encoding
    def encode_sparse(self, out, new_lbg, stats, seed):
        """Encode a chunk's sparse ``(send, gscale)`` payloads. Returns
        ``(out, new_lbg, wire_bytes (C,))``; the lossless codecs leave
        payload and bank untouched."""
        wire = torch.where(stats.sent_scalar, self._scalar_wire(stats),
                           self.sparse_full_bytes(out[0]))
        return out, new_lbg, wire

    def encode_dense(self, gt, cost, seed):
        """Encode a chunk's dense update dicts; ``cost`` is the (C,) fp32
        float count. Returns ``(gt, wire_bytes (C,))``."""
        return gt, 4.0 * cost

    # --------------------------------------------------------- decoding
    def decode_leaf(self, sk):
        """fp32 values of one sparse payload leaf."""
        return sk["val"]


@register_codec("none")
class NoneCodec(WireCodec):
    pass


@register_codec("delta_idx")
class DeltaIdxCodec(WireCodec):
    name = "delta_idx"
    delta_idx = True


class _QuantizedCodec(WireCodec):
    """Shared machinery of the lossy value codecs."""

    lossy = True
    delta_idx = True
    value_bytes = 1.0
    scalar_bytes = 1.0     # rho as e4m3
    scale_bytes = 4.0
    payload_keys = ("idx", "val", "scale")
    wire_dtype = torch.int8
    qmax = 127.0

    def __init__(self, stochastic: bool = True):
        self.stochastic = bool(stochastic)

    def _round(self, f, seed, leaf: int, row0: int = 0):
        """Round ``f`` (C, rows, cols) to the grid: stochastically with
        client c's uniforms ``jax.random.uniform(fold_in(PRNGKey(seed_c),
        leaf), (R, cols))[row0:row0 + rows]`` (R the whole leaf's rows),
        or to nearest."""
        if self.stochastic:
            C, rows, cols = f.shape
            key = fold_in_t(prng_key_t(seed.to(f.device)), leaf)
            u = uniform_rows(key, rows * cols, start=row0 * cols)
            return stochastic_round(f, u.reshape(C, rows, cols))
        return torch.round(f)

    def quantize(self, val, seed, leaf: int, row0: int = 0):
        """(C, rows, cols) fp32 -> (wire-dtype grid, (C, rows, 1) fp32
        scale). ``seed`` (C,), ``leaf`` and the first row ``row0`` key the
        stochastic uniforms."""
        raise NotImplementedError

    def decode_leaf(self, sk):
        return sk["val"].float() * sk["scale"]

    def encode_sparse(self, out, new_lbg, stats, seed):
        send, gscale = out
        send2, lbg2 = {}, {}
        for i, name in enumerate(sorted(send)):
            sk = send[name]
            q, scale = self.quantize(sk["val"], seed, i, self._first_row(
                name, sk["val"].shape[1]))
            send2[name] = {"idx": sk["idx"], "val": q, "scale": scale}
            # the bank keeps the DEQUANTIZED grid values — what the server
            # decoded; on a recycle round they are on the grid already and
            # the transform is exactly the identity
            lbg2[name] = {"idx": new_lbg[name]["idx"],
                          "val": q.float() * scale}
        gscale_q = torch.where(stats.sent_scalar, e4m3_nearest(gscale),
                               gscale)
        wire = torch.where(stats.sent_scalar, self._scalar_wire(stats),
                           self.sparse_full_bytes(send2))
        return (send2, gscale_q), lbg2, wire

    def encode_dense(self, gt, cost, seed):
        # the codec ships the dense update itself: M values + leaf scales
        out, total = {}, 0.0
        for i, name in enumerate(sorted(gt)):
            leaf = gt[name]
            q, scale = self.quantize(
                leaf.float().reshape(leaf.shape[0], 1, -1), seed, i)
            # the dense fold takes fp32 dicts: dequantize here
            out[name] = (q.float() * scale).reshape(leaf.shape)
            total += self.value_bytes * leaf[0].numel() + self.scale_bytes
        return out, torch.full_like(cost, total)


@register_codec("int8")
class Int8Codec(_QuantizedCodec):
    name = "int8"

    def quantize(self, val, seed, leaf: int, row0: int = 0):
        m = val.abs().amax(-1, keepdim=True)
        scale = pow2_scale(m, self.qmax)
        q = self._round(val / scale, seed, leaf, row0)
        q = q.clamp(-self.qmax, self.qmax)
        return q.to(self.wire_dtype), scale


@register_codec("fp8")
class Fp8Codec(_QuantizedCodec):
    name = "fp8"
    wire_dtype = torch.float8_e4m3fn
    qmax = E4M3_MAX

    def quantize(self, val, seed, leaf: int, row0: int = 0):
        m = val.abs().amax(-1, keepdim=True)
        scale = pow2_scale(m, self.qmax)
        x = val / scale
        a = x.abs()
        step = _e4m3_step(a)
        # round the magnitude on its binade's grid; rounding up into the
        # next binade lands on that binade's grid (16 * step = 8 * 2step)
        r = self._round(a / step, seed, leaf, row0)
        xq = (torch.sign(x) * r * step).clamp(-self.qmax, self.qmax)
        return xq.to(self.wire_dtype), scale


# ------------------------------------------------------------- resolver

def make_codec(cfg) -> WireCodec:
    """Resolve ``cfg.codec`` / ``cfg.codec_kw`` through the registry."""
    try:
        return CODECS.get(cfg.codec)(**(cfg.codec_kw or {}))
    except TypeError as e:
        raise ValueError(
            f"codec {cfg.codec!r} rejected codec_kw={cfg.codec_kw!r}: {e}"
        ) from e

"""Uplink wire codecs: real-byte accounting of what a client uploads.

Counterpart of ``repro.comm.wire``. Only the fp32 legacy format
``"none"`` is ported so far (``delta_idx``, ``int8`` and ``fp8`` are a
later slice, with the ``lbgm_dequant_accum`` kernel). The engine calls
:meth:`WireCodec.encode_sparse`, :meth:`~WireCodec.encode_dense`,
:meth:`~WireCodec.sparse_layout_bytes` and ``scalar_bytes`` even for
``"none"``: it leaves every payload untouched and only prices its bytes.

Wire format of one full-round sparse payload, per leaf (``nb`` rows of
``kb`` entries, ``repro_torch.core.lbgm._block_layout``): ``nb*kb`` fp32
values plus ``nb*kb`` int32 indices. A scalar (recycle) round is one fp32
rho, 4 bytes; a dense full round ``4 * M`` bytes.

Every method takes the engine's batched payloads (leading client axis C)
and returns (C,) fp32 byte counts.
"""
from __future__ import annotations

import torch

from repro_torch.fed.registry import CODECS, register_codec


class WireCodec:
    """Base codec: the fp32 legacy wire format."""

    name = "none"
    lossy = False          # value quantization active
    value_bytes = 4.0      # per transmitted payload value
    scalar_bytes = 4.0     # per scalar-round rho
    scale_bytes = 0.0      # per block row (sparse) / per leaf (dense)

    # ------------------------------------------------------- byte model
    def sparse_full_bytes(self, send) -> float:
        """Full-round wire bytes of one client's sparse ``{name: {idx,
        val}}`` payload (leaves ``(C, nb, kb)``): a static constant, no
        payload data is read."""
        total = 0.0
        for name in sorted(send):
            idx = send[name]["idx"]
            nk, nb = float(idx[0].numel()), float(idx.shape[1])
            total += 4.0 * nk + self.value_bytes * nk + self.scale_bytes * nb
        return total

    def sparse_layout_bytes(self, layouts) -> float:
        """Static full-round wire bytes for a ``[(nb, kb), ...]`` block
        layout — the legacy dense-aggregation path over a top-k store
        prices the same (idx, val) payload the sparse path ships."""
        return float(sum((self.value_bytes + 4.0) * nb * kb
                         + self.scale_bytes * nb for nb, kb in layouts))

    # --------------------------------------------------------- encoding
    def encode_sparse(self, out, new_lbg, stats):
        """Encode a chunk's sparse ``(send, gscale)`` payloads. Returns
        ``(out, new_lbg, wire_bytes (C,))``; payload and bank unchanged."""
        full = torch.full_like(stats.rho, self.sparse_full_bytes(out[0]))
        wire = torch.where(stats.sent_scalar,
                           torch.full_like(full, self.scalar_bytes), full)
        return out, new_lbg, wire

    def encode_dense(self, gt, cost):
        """Encode a chunk's dense update dicts; ``cost`` is the (C,) fp32
        float count. Returns ``(gt, wire_bytes (C,))``."""
        return gt, 4.0 * cost


@register_codec("none")
class NoneCodec(WireCodec):
    pass


def make_codec(cfg) -> WireCodec:
    """Resolve ``cfg.codec`` / ``cfg.codec_kw`` through the registry."""
    try:
        return CODECS.get(cfg.codec)(**(cfg.codec_kw or {}))
    except TypeError as e:
        raise ValueError(
            f"codec {cfg.codec!r} rejected codec_kw={cfg.codec_kw!r}: {e}"
        ) from e

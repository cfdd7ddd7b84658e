"""Sparse-LBG kernels: the fused decision and the quantized fold.

Counterpart of ``repro.kernels.lbgm_sparse``. On a CUDA tensor each wrapper
launches its hand-written kernel; on a CPU tensor it returns the plain
version from :mod:`repro_torch.kernels.ref`.

* :func:`lbgm_sparse_decision_batched` (``csrc/lbgm_sparse_decision.cu``):
  gather, ||g||^2 and block top-k in one read of the leaf, flat or in the
  (B, nb, block) layout; one kernel a call. ``two_pass=False`` emits
  each row's top-kb in descending |value| order (ties to the lowest index,
  as ``lax.top_k``), ``two_pass=True`` the same set in ascending index
  order — the JAX package's one-pass and two-pass kernels.
* :func:`lbgm_dequant_accum` (``csrc/lbgm_dequant_accum.cu``): dequantize
  C clients' int8 / fp8-e4m3 sparse payloads and scatter-add them into an
  fp32 accumulator leaf, clients in order, in place.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("lbgm_sparse_decision")
    f = lib.lbgm_sparse_decision_launch
    if not f.argtypes:
        P, L = ctypes.c_void_p, ctypes.c_longlong
        f.argtypes = [P, ctypes.c_int, P, L, L, L, L, L, ctypes.c_int,
                      P, P, P, P, P, P, P, P]
        f.restype = ctypes.c_int
        for name in ("lbgm_sparse_decision_shared_sort_kb",
                     "lbgm_sparse_decision_block_max"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_longlong
        lib.lbgm_sparse_decision_cluster_size.argtypes = [L]
        lib.lbgm_sparse_decision_cluster_size.restype = ctypes.c_longlong
        lib.lbgm_sparse_decision_set_placement.argtypes = [ctypes.c_int]
        lib.lbgm_sparse_decision_set_placement.restype = ctypes.c_int
        lib.lbgm_sparse_decision_places_by_rank.argtypes = [L, L]
        lib.lbgm_sparse_decision_places_by_rank.restype = ctypes.c_int
    return lib


def shared_sort_kb() -> int:
    """The largest kb whose value-order keys the kernel sorts in one CTA's
    shared memory; past it the row's keys are sorted in a global scratch
    buffer (tiles in shared memory, then merge passes). Not a ceiling."""
    return int(_lib().lbgm_sparse_decision_shared_sort_kb())


def cluster_size(block: int) -> int:
    """CTAs in the thread-block cluster that selects one row of ``block``
    elements (1 for a row of at most 8192)."""
    return int(_lib().lbgm_sparse_decision_cluster_size(block))


_PLACEMENTS = ("rule", "rank", "sort")


def set_placement(how: str) -> str:
    """Value order (kb up to :func:`shared_sort_kb`) places a row's kept
    keys either by rank, every CTA of the cluster counting the keys below
    each key of its share, or by rank 0's bitonic sort; both give the same
    result. ``"rule"`` (the default) takes the one with the shorter loop
    (:func:`places_by_rank`); ``"rank"`` and ``"sort"`` force one, for
    measuring them against each other. Returns the previous setting."""
    if how not in _PLACEMENTS:
        raise ValueError(f"placement {how!r} not in {_PLACEMENTS}")
    return _PLACEMENTS[_lib().lbgm_sparse_decision_set_placement(
        _PLACEMENTS.index(how))]


def places_by_rank(block: int, kb: int) -> bool:
    """Whether the rule places value order's kb keys of a ``block`` row by
    rank (else by rank 0's bitonic sort)."""
    return bool(_lib().lbgm_sparse_decision_places_by_rank(block, kb))


def lbgm_sparse_decision_batched(blocks: torch.Tensor, idx: torch.Tensor,
                                 two_pass: bool = False,
                                 block: Optional[int] = None):
    """blocks: (B, nb, block) gradient block layout (fp32 or bf16), or the
    flat leaf (B, size) with ``block=`` given, row r of a client being its
    elements [r * block, (r + 1) * block), zero past ``size`` (nb = idx's
    rows; nb * block >= size). idx: (B, nb, kb) int32 block-local LBG
    positions in [0, block). Returns ``(gg (B,), gathered (B, nb, kb),
    top_idx (B, nb, kb) int32, top_val (B, nb, kb))``, all fp32 but the
    indices; the flat form gives the zero-padded layout's result."""
    if idx.dim() != 3 or blocks.dim() not in (2, 3) \
            or blocks.shape[0] != idx.shape[0]:
        raise ValueError(f"want blocks (B, nb, block) or (B, size) and idx "
                         f"(B, nb, kb), got {tuple(blocks.shape)} and "
                         f"{tuple(idx.shape)}")
    B, nb, kb = idx.shape
    if blocks.dim() == 3:
        if block is not None or blocks.shape[1] != nb:
            raise ValueError(f"blocks {tuple(blocks.shape)} and idx "
                             f"{tuple(idx.shape)}: the layout's rows must "
                             f"be idx's, and block= is for the flat form")
        block = blocks.shape[2]
    elif block is None:
        raise ValueError("the flat form (B, size) needs block=")
    size = blocks[0].numel()
    if not 1 <= kb <= block:
        raise ValueError(f"kb={kb} must lie in [1, block={block}]")
    if not 0 < size <= nb * block:
        raise ValueError(f"size={size} must lie in [1, nb * block = "
                         f"{nb * block}]")
    if blocks.device.type == "cpu" and idx.device.type == "cpu":
        fn = (ref.lbgm_sparse_decision_two_pass_ref if two_pass
              else ref.lbgm_sparse_decision_ref)
        return fn(blocks, idx, block=None if blocks.dim() == 3 else block)
    _build.check_card(blocks, idx)
    if blocks.dtype not in _DTYPES or idx.dtype != torch.int32:
        raise TypeError(f"want fp32/bf16 blocks and int32 idx, got "
                        f"{blocks.dtype} and {idx.dtype}")
    if not (blocks.is_contiguous() and idx.is_contiguous()):
        raise ValueError("lbgm_sparse_decision takes contiguous tensors")
    lib = _lib()
    if block > lib.lbgm_sparse_decision_block_max():
        raise ValueError(f"block={block} exceeds the kernel's "
                         f"{lib.lbgm_sparse_decision_block_max()}")
    dev = blocks.device
    f32 = dict(dtype=torch.float32, device=dev)
    live = -(-size // block)
    gg_part = torch.empty((B, live), **f32)
    gg = torch.empty((B,), **f32)
    gathered = torch.empty((B, nb, kb), **f32)
    top_idx = torch.empty((B, nb, kb), dtype=torch.int32, device=dev)
    top_val = torch.empty((B, nb, kb), **f32)
    # value order past the shared-memory sort: two buffers of 64-bit keys
    scratch = (torch.empty((2 * B * nb * kb,), dtype=torch.int64, device=dev)
               if not two_pass and kb > shared_sort_kb() else None)
    with torch.cuda.device(dev):
        rc = lib.lbgm_sparse_decision_launch(
            blocks.data_ptr(), _DTYPES[blocks.dtype], idx.data_ptr(), B,
            size, nb, block, kb, int(not two_pass), gg_part.data_ptr(),
            _build.tickets("lbgm_sparse_decision", dev, B).data_ptr(),
            gg.data_ptr(), gathered.data_ptr(), top_idx.data_ptr(),
            top_val.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            _build.stream_ptr(dev))
    name = ("lbgm_sparse_decision_two_pass" if two_pass
            else "lbgm_sparse_decision")
    _build.check_rc(name, rc)
    _build.count_launch(name, (B, size, nb, block, kb))
    return gg, gathered, top_idx, top_val


def lbgm_sparse_decision(blocks: torch.Tensor, idx: torch.Tensor,
                         two_pass: bool = False):
    """Unbatched view: blocks (nb, block), idx (nb, kb) -> (gg scalar,
    gathered, top_idx, top_val)."""
    gg, gath, ti, tv = lbgm_sparse_decision_batched(blocks[None], idx[None],
                                                    two_pass=two_pass)
    return gg[0], gath[0], ti[0], tv[0]


# ------------------------------------------ fused dequant + accumulate

_QV_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}
#: accumulator floats per CTA of the dequant kernel (csrc: SEG); a row of
#: ``block`` floats is split over ceil(block / DEQUANT_SEG) CTAs
DEQUANT_SEG = 4096


def _dequant_lib():
    lib = _build.load("lbgm_dequant_accum")
    f = lib.lbgm_dequant_accum_launch
    if not f.argtypes:
        P, L = ctypes.c_void_p, ctypes.c_longlong
        f.argtypes = [P, P, P, P, P, ctypes.c_int, P, L, L, L, L, P]
        f.restype = ctypes.c_int
    return lib


def lbgm_dequant_accum(acc: torch.Tensor, w: torch.Tensor,
                       gscale: torch.Tensor, idx: torch.Tensor,
                       qv: torch.Tensor, scale: torch.Tensor):
    """``acc += sum_c [w_c > 0] (w_c * gscale_c * scale_c) * f32(qv_c)``
    scattered at ``idx_c``, clients folded in order, in place on ``acc``.

    acc: (nb, block) f32; w, gscale: (C,) f32; idx: (C, nb, kb) int32
    block-local positions, unique within a row; qv: (C, nb, kb) int8 or
    float8_e4m3fn; scale: (C, nb, 1) f32. Returns ``acc``. The kernel and
    the plain version agree bit for bit (no FMA in either)."""
    if acc.dim() != 2 or idx.dim() != 3 or qv.shape != idx.shape:
        raise ValueError(f"want acc (nb, block) and idx, qv (C, nb, kb), got "
                         f"{tuple(acc.shape)}, {tuple(idx.shape)} and "
                         f"{tuple(qv.shape)}")
    C, nb, kb = idx.shape
    block = acc.shape[1]
    if (acc.shape[0] != nb or tuple(scale.shape) != (C, nb, 1)
            or tuple(w.shape) != (C,) or tuple(gscale.shape) != (C,)):
        raise ValueError(f"shapes disagree: acc {tuple(acc.shape)}, w "
                         f"{tuple(w.shape)}, gscale {tuple(gscale.shape)}, "
                         f"idx {tuple(idx.shape)}, scale {tuple(scale.shape)}")
    if not 1 <= kb <= block:
        raise ValueError(f"kb={kb} must lie in [1, block={block}]")
    tensors = (acc, w, gscale, idx, qv, scale)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.lbgm_dequant_accum_ref(acc, w, gscale, idx, qv, scale)
    _build.check_card(*tensors)
    if (any(t.dtype != torch.float32 for t in (acc, w, gscale, scale))
            or idx.dtype != torch.int32 or qv.dtype not in _QV_DTYPES):
        raise TypeError(
            f"want f32 acc, w, gscale and scale, int32 idx and int8 or "
            f"float8_e4m3fn qv; got {acc.dtype}, {w.dtype}, {gscale.dtype}, "
            f"{scale.dtype}, {idx.dtype} and {qv.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lbgm_dequant_accum takes contiguous tensors")
    lib = _dequant_lib()
    dev = acc.device
    with torch.cuda.device(dev):
        rc = lib.lbgm_dequant_accum_launch(
            acc.data_ptr(), w.data_ptr(), gscale.data_ptr(), idx.data_ptr(),
            qv.data_ptr(), _QV_DTYPES[qv.dtype], scale.data_ptr(), C, nb,
            block, kb, _build.stream_ptr(dev))
    _build.check_rc("lbgm_dequant_accum", rc)
    _build.count_launch("lbgm_dequant_accum", (C, nb, block, kb))
    return acc

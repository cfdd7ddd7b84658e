"""Fused LBGM projection: fp32 (<g,l>, ||g||^2, ||l||^2) in one read.

Counterpart of ``repro.kernels.lbgm_projection``. On CUDA tensors the
wrappers launch the hand-written kernel in ``csrc/lbgm_projection.cu``; on
CPU tensors they return the plain version
(:func:`repro_torch.kernels.ref.lbgm_projection_ref`). The batch axis is
the engine's client axis written out, and one call takes every leaf of a
chunk (:func:`lbgm_projection_leaves`): one kernel for the chunk.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("lbgm_projection")
    f = lib.lbgm_projection_launch
    if not f.argtypes:
        P, L = ctypes.c_void_p, ctypes.c_longlong
        f.argtypes = [P, P, P, P, ctypes.c_int, ctypes.c_int, L, P, P, P, P]
        f.restype = ctypes.c_int
        lib.lbgm_projection_tile.argtypes = []
        lib.lbgm_projection_tile.restype = ctypes.c_longlong
    return lib


def lbgm_projection_leaves(gs: Sequence[torch.Tensor],
                           ls: Sequence[torch.Tensor]):
    """gs, ls: leaves ``(B, n_i)`` (fp32 or bf16), all of one dtype and one
    B, g and l of each leaf of one shape. Returns (gl, gg, ll), each a (B,)
    fp32 tensor: each leaf's sums, added over the leaves in the given
    order — the same bits as adding one-leaf calls left to right."""
    if not gs or len(gs) != len(ls):
        raise ValueError(f"want one or more (g, l) leaf pairs, got "
                         f"{len(gs)} and {len(ls)}")
    for g, l in zip(gs, ls):
        if g.dim() != 2 or g.shape != l.shape:
            raise ValueError(f"want two (B, n) tensors of one shape, got "
                             f"{tuple(g.shape)} and {tuple(l.shape)}")
    B, dtype = gs[0].shape[0], gs[0].dtype
    if any(t.shape[0] != B for t in gs):
        raise ValueError(f"leaves disagree in their client count: "
                         f"{[t.shape[0] for t in gs]}")
    if any(t.dtype != dtype for t in (*gs, *ls)):
        raise TypeError(f"leaves disagree in dtype: "
                        f"{sorted({str(t.dtype) for t in (*gs, *ls)})}")
    if all(t.device.type == "cpu" for t in (*gs, *ls)):
        out = None
        for g, l in zip(gs, ls):
            part = ref.lbgm_projection_ref(g, l)
            out = part if out is None else tuple(
                a + b for a, b in zip(out, part))
        return out
    _build.check_card(*gs, *ls)
    if dtype not in _DTYPES:
        raise TypeError(f"want fp32 or bf16 inputs, got {dtype}")
    if not all(t.is_contiguous() for t in (*gs, *ls)):
        raise ValueError("lbgm_projection takes contiguous tensors")
    if B == 0 or any(g.shape[1] == 0 for g in gs):
        raise ValueError(f"empty input: {[tuple(g.shape) for g in gs]}")
    lib = _lib()
    tile = int(lib.lbgm_projection_tile())
    per_vec = 16 // gs[0].element_size()
    k = len(gs)
    g_ptr = (ctypes.c_void_p * k)(*[g.data_ptr() for g in gs])
    l_ptr = (ctypes.c_void_p * k)(*[l.data_ptr() for l in ls])
    n = (ctypes.c_longlong * k)(*[g.shape[1] for g in gs])
    vec = (ctypes.c_int * k)(*[
        int(g.shape[1] % per_vec == 0 and g.data_ptr() % 16 == 0
            and l.data_ptr() % 16 == 0) for g, l in zip(gs, ls)])
    dev = gs[0].device
    tiles = sum(-(-g.shape[1] // tile) for g in gs)
    partials = torch.empty(3 * B * tiles, dtype=torch.float32, device=dev)
    out = torch.empty((3, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.lbgm_projection_launch(
            g_ptr, l_ptr, n, vec, k, _DTYPES[dtype], B, partials.data_ptr(),
            _build.tickets("lbgm_projection", dev, B).data_ptr(),
            out.data_ptr(), _build.stream_ptr(dev))
    _build.check_rc("lbgm_projection", rc)
    _build.count_launch("lbgm_projection",
                        tuple((B, g.shape[1]) for g in gs))
    return out[0], out[1], out[2]


def lbgm_projection_batched(g: torch.Tensor, l: torch.Tensor):
    """g, l: (B, n) stacks (fp32 or bf16). Returns (gl, gg, ll), each a
    (B,) fp32 tensor — one fused pass per row (the one-leaf call)."""
    if g.dim() != 2 or g.shape != l.shape:
        raise ValueError(f"want two (B, n) tensors of one shape, got "
                         f"{tuple(g.shape)} and {tuple(l.shape)}")
    return lbgm_projection_leaves([g], [l])


def lbgm_projection(g: torch.Tensor, l: torch.Tensor):
    """Unbatched view: flat g, l (n,) -> three fp32 scalars."""
    gl, gg, ll = lbgm_projection_batched(g.reshape(1, -1), l.reshape(1, -1))
    return gl[0], gg[0], ll[0]

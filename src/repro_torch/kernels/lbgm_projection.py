"""Fused LBGM projection: fp32 (<g,l>, ||g||^2, ||l||^2) in one read.

Counterpart of ``repro.kernels.lbgm_projection``. On a CUDA tensor the
wrapper launches the hand-written kernel in ``csrc/lbgm_projection.cu``;
on a CPU tensor it returns the plain version
(:func:`repro_torch.kernels.ref.lbgm_projection_ref`). The batch axis is
the engine's client axis written out: one launch covers a whole chunk of
clients.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("lbgm_projection")
    f = lib.lbgm_projection_launch
    if not f.argtypes:
        P, L = ctypes.c_void_p, ctypes.c_longlong
        f.argtypes = [P, P, ctypes.c_int, L, L, ctypes.c_int, P, P, P]
        f.restype = ctypes.c_int
        lib.lbgm_projection_tile.argtypes = []
        lib.lbgm_projection_tile.restype = ctypes.c_longlong
    return lib


def lbgm_projection_batched(g: torch.Tensor, l: torch.Tensor):
    """g, l: (B, n) stacks (fp32 or bf16). Returns (gl, gg, ll), each a
    (B,) fp32 tensor — one fused pass per row."""
    if g.dim() != 2 or g.shape != l.shape:
        raise ValueError(f"want two (B, n) tensors of one shape, got "
                         f"{tuple(g.shape)} and {tuple(l.shape)}")
    if g.device.type == "cpu" and l.device.type == "cpu":
        return ref.lbgm_projection_ref(g, l)
    _build.check_card(g, l)
    if g.dtype != l.dtype or g.dtype not in _DTYPES:
        raise TypeError(f"want fp32 or bf16 inputs of one dtype, got "
                        f"{g.dtype} and {l.dtype}")
    if not (g.is_contiguous() and l.is_contiguous()):
        raise ValueError("lbgm_projection takes contiguous tensors")
    B, n = g.shape
    if B == 0 or n == 0:
        raise ValueError(f"empty input of shape {(B, n)}")
    lib = _lib()
    tile = int(lib.lbgm_projection_tile())
    tiles = -(-n // tile)
    per_vec = 16 // g.element_size()
    vec = int(n % per_vec == 0 and g.data_ptr() % 16 == 0
              and l.data_ptr() % 16 == 0)
    partials = torch.empty(3 * B * tiles, dtype=torch.float32,
                           device=g.device)
    out = torch.empty((3, B), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = lib.lbgm_projection_launch(
            g.data_ptr(), l.data_ptr(), _DTYPES[g.dtype], B, n, vec,
            partials.data_ptr(), out.data_ptr(), _build.stream_ptr(g.device))
    _build.check_rc("lbgm_projection", rc)
    _build.LAUNCHES["lbgm_projection"] += 1
    return out[0], out[1], out[2]


def lbgm_projection(g: torch.Tensor, l: torch.Tensor):
    """Unbatched view: flat g, l (n,) -> three fp32 scalars."""
    gl, gg, ll = lbgm_projection_batched(g.reshape(1, -1), l.reshape(1, -1))
    return gl[0], gg[0], ll[0]

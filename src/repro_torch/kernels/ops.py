"""Public wrappers of the port's kernels, as the engine and the LM call them.

Counterpart of ``repro.kernels.ops``. The JAX package routes ``jax.vmap``
over clients onto its batched kernels with ``custom_vmap`` rules; the port
writes the client axis out instead, so these take ``(C, ...)`` stacks and
call the batched kernels directly.

Dispatch: a CPU tensor goes to the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel or raises (see
``kernels._build.check_card``). The LM kernels (flash attention, the
RWKV6 scan) also take meta tensors to their plain versions, for the dry
run (``launch/dryrun.py``).
"""
from __future__ import annotations

import os
from typing import Dict

import torch

# the LM kernels take the JAX ops layout ((B, T, H, hd)) as they are: the
# wrappers themselves are the public entry points
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.lbgm_projection import lbgm_projection_leaves
# lbgm_dequant_accum takes the chunk's (C, nb, kb) payloads as they are:
# the wrapper itself is the public entry point (one call per leaf per chunk)
from repro_torch.kernels.lbgm_sparse import (  # noqa: F401
    lbgm_dequant_accum, lbgm_sparse_decision_batched)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: F401

#: "1" routes lbgm_sparse_decision through the index-order (two-pass) form
#: of the decision kernel — the same knob as the JAX package's
TWO_PASS_ENV = "REPRO_LBGM_TWO_PASS_TOPK"


def _default_two_pass() -> bool:
    return os.environ.get(TWO_PASS_ENV, "0").lower() not in (
        "0", "", "false", "off", "no")


def lbgm_projection(g_tree: Dict[str, torch.Tensor],
                    l_tree: Dict[str, torch.Tensor]):
    """Per-client fused (<g,l>, ||g||^2, ||l||^2) over a pair of batched
    dicts (leaves ``(C, ...)``, one dtype and one C): one launch over every
    leaf, the per-leaf sums added in sorted key order. Returns three (C,)
    fp32 tensors."""
    names = sorted(g_tree)
    return lbgm_projection_leaves(
        [g_tree[k].reshape(g_tree[k].shape[0], -1) for k in names],
        [l_tree[k].reshape(l_tree[k].shape[0], -1) for k in names])


def lbgm_sparse_decision(blocks: torch.Tensor, idx: torch.Tensor,
                         two_pass=None, block=None):
    """One fused pass over a ``(C, nb, block)`` block layout, or over the
    flat leaf ``(C, size)`` with ``block=``: returns ``(gg (C,), gathered,
    top_idx, top_val)``. ``two_pass=None`` reads the
    ``REPRO_LBGM_TWO_PASS_TOPK`` knob."""
    two_pass = _default_two_pass() if two_pass is None else bool(two_pass)
    return lbgm_sparse_decision_batched(blocks, idx, two_pass=two_pass,
                                        block=block)

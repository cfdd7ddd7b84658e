"""Checkpointing: flat-dict trees <-> .npz (atomic, with metadata).

Counterpart of ``repro.checkpoint.ckpt``, in its file format: one array
per leaf under its path joined by ``::`` (list and tuple nodes as ``#i``),
the metadata as a JSON string under ``__metadata__``, written to a
temporary file and moved into place. A file written by either package
loads in the other.

bf16 leaves are stored as their raw 16 bits, a numpy ``|V2`` (void, two
bytes) array: what ``np.savez`` writes for the JAX package's bf16 arrays
(``ml_dtypes.bfloat16``), and what numpy alone can hold, so no
``ml_dtypes`` is needed. :func:`load_checkpoint` turns a ``|V2`` array
back into a bf16 tensor, bit for bit.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "::"
#: numpy's dtype for a leaf of 16 raw bits (the JAX package's bf16 on disk)
_RAW16 = np.dtype("V2")


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        # exactly one trailing separator comes off (a leaf key may itself
        # end with a colon)
        out[prefix.removesuffix(_SEP)] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if isinstance(node, dict) and node and all(
                k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node
    return fix(tree)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_RAW16)
        return x.numpy()
    return np.asarray(x)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == _RAW16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def save_checkpoint(path: str, state, metadata: Optional[dict] = None):
    """Write ``state`` (a tree of dicts, lists and tensors or arrays, on
    any device) to ``path`` atomically."""
    flat = {k: _to_numpy(v) for k, v in _flatten(state).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # suffix must end in .npz or np.savez silently writes to "<tmp>.npz"
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, __metadata__=json.dumps(metadata or {}), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str) -> Tuple[Any, dict]:
    """``(tree of CPU tensors, metadata)``; raw 16-bit leaves come back as
    bf16."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__metadata__"]))
        flat = {k: _to_torch(z[k]) for k in z.files if k != "__metadata__"}
    return _unflatten(flat), meta

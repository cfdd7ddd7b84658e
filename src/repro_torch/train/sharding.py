"""Logical-axis -> mesh-axis sharding rules.

Counterpart of ``repro.train.sharding`` (``_MODEL_AXES``, ``_FSDP_AXES``,
``param_pspec`` in both modes with its ``embed_shard`` variant,
``params_shardings``). torch has no ``PartitionSpec``: a spec here is a
plain tuple with one entry per dim, a mesh-axis name or None. A mesh is
anything with ``axis_names`` and a ``shape`` mapping (axis name ->
extent), such as :class:`MeshAxes`; :func:`mesh_axes` reads one off a
``DeviceMesh``.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

Spec = Tuple[Optional[str], ...]

# logical axes that shard over the `model` mesh axis in every mode
_MODEL_AXES = {"vocab", "heads", "kv_heads", "ff", "expert", "embed2",
               "hidden", "classes", "cout"}
# logical axes that additionally shard over `data` in fsdp mode
_FSDP_AXES = {"embed", "feat"}


class MeshAxes(NamedTuple):
    """Axis names and extents of a mesh, without any device."""
    axis_names: Tuple[str, ...]
    shape: Mapping[str, int]


def mesh_axes(mesh) -> MeshAxes:
    """The :class:`MeshAxes` of a ``DeviceMesh`` with named dims."""
    names = tuple(mesh.mesh_dim_names)
    return MeshAxes(names, dict(zip(names, (int(d) for d in
                                            mesh.mesh.shape))))


def _mesh_axis_for(logical: str, mode: str, mesh,
                   dim_size: int) -> Optional[str]:
    if logical in _MODEL_AXES and "model" in mesh.axis_names:
        if dim_size % mesh.shape["model"] == 0:
            return "model"
    if mode == "fsdp" and logical in _FSDP_AXES and "data" in mesh.axis_names:
        if dim_size % mesh.shape["data"] == 0:
            return "data"
    return None


def param_pspec(axes: Tuple[str, ...], shape: Tuple[int, ...], mode: str,
                mesh, embed_shard: str = "vocab") -> Spec:
    """One leaf's spec: each logical axis to the mesh axis that shards
    it, where the extent divides; a mesh axis is used at most once."""
    used = set()
    out = []
    for logical, dim in zip(axes, shape):
        if embed_shard == "embed" and tuple(axes) == ("vocab", "embed"):
            # the embedding table along d_model (token gathers stay
            # local); vocab only over `data` in fsdp mode
            ax = ("model" if logical == "embed"
                  and dim % mesh.shape.get("model", 1) == 0 else None)
            ax = ax if logical == "embed" else (
                "data" if mode == "fsdp" and logical == "vocab"
                and dim % mesh.shape.get("data", 1) == 0 else None)
        else:
            ax = _mesh_axis_for(logical, mode, mesh, dim)
        if ax in used:
            ax = None
        if ax is not None:
            used.add(ax)
        out.append(ax)
    return tuple(out)


def params_shardings(axes_tree: Dict[str, Tuple[str, ...]], params,
                     mode: str, mesh,
                     embed_shard: str = "vocab") -> Dict[str, Spec]:
    """name -> spec of every leaf of ``params`` (anything with a
    ``shape``; ``embed_shard`` applies to the ``embed`` leaf)."""
    return {k: param_pspec(axes_tree[k], tuple(params[k].shape), mode, mesh,
                           embed_shard if k == "embed" else "vocab")
            for k in params}

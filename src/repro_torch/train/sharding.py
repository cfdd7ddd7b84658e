"""Logical-axis -> mesh-axis sharding rules.

Counterpart of ``repro.train.sharding`` (``abstract_mesh``, ``dp_axes``,
``_MODEL_AXES``, ``_FSDP_AXES``, ``param_pspec`` in both modes with its
``embed_shard`` variant, ``params_shardings``, ``stacked_pspec``,
``batch_pspec``, ``cache_pspec``, ``state_shardings``). torch has no
``PartitionSpec``: a spec here is a plain tuple with one entry per dim,
in ``PartitionSpec``'s normal form: None, a mesh-axis name, or a tuple of
two or more names (a dim over several axes, such as ``("pod",
"data")``). A mesh is anything with ``axis_names`` and a ``shape``
mapping (axis name -> extent), such as :class:`MeshAxes`, which
:func:`abstract_mesh` builds with no device; :func:`mesh_axes` reads one
off a ``DeviceMesh``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, \
    Union

#: one dim's entry of a spec: unsharded, one mesh axis, or several
Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

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


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> MeshAxes:
    """A mesh of ``axis_names`` with extents ``axis_sizes`` and no
    device, the planning form of a mesh (JAX's ``AbstractMesh``): every
    rule of this module takes it, as it takes a ``DeviceMesh`` read
    through :func:`mesh_axes`."""
    names = tuple(axis_names)
    sizes = tuple(int(d) for d in axis_sizes)
    if len(names) != len(sizes) or len(set(names)) != len(names):
        raise ValueError(f"abstract_mesh: {sizes} and {names} must pair "
                         "one extent with each distinct axis name")
    return MeshAxes(names, dict(zip(names, sizes)))


def dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes, outermost first: ``pod`` and
    ``data``, those it has."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_entry(axes) -> Axis:
    """One dim's entry in ``PartitionSpec``'s normal form: None for no
    axis, the name for one, the tuple for several."""
    if axes is None or isinstance(axes, str):
        return axes
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def axes_size(mesh, axes) -> int:
    """The product of the extents of ``axes`` (a spec entry) on
    ``mesh``."""
    if axes is None:
        return 1
    return math.prod(mesh.shape[a] for a in
                     ((axes,) if isinstance(axes, str) else axes))


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


def stacked_pspec(base: Spec, lead_axes) -> Spec:
    """Prepend mesh axes (e.g. the client axis) to a param spec."""
    return (axis_entry(lead_axes), *base)


def batch_pspec(mesh, extra_dims: int = 2) -> Spec:
    """Client/batch leading axis over ("pod", "data"); rest unsharded."""
    return (axis_entry(dp_axes(mesh)), *([None] * extra_dims))


def cache_pspec(axes: Tuple[str, ...], shape: Tuple[int, ...],
                mesh) -> Spec:
    """Decode-state spec: the batch over the data axes where their
    product divides it (and is at most it); the model axis on the first
    divisible dim of kv_heads, then heads, head_dim, head_dim2, embed,
    vocab (distributed flash-decode where no head count divides)."""
    model = mesh.shape.get("model", 1)
    model_target = None
    for cand in ("kv_heads", "heads", "head_dim", "head_dim2", "embed",
                 "vocab"):
        if model > 1 and any(logical == cand and dim % model == 0
                             for logical, dim in zip(axes, shape)):
            model_target = cand
            break
    dp = dp_axes(mesh)
    total = axes_size(mesh, dp)
    out, used_model = [], False
    for logical, dim in zip(axes, shape):
        if logical == "batch":
            out.append(axis_entry(dp) if dim % total == 0 and dim >= total
                       else None)
        elif logical == model_target and not used_model:
            out.append("model")
            used_model = True
        else:
            out.append(None)
    return tuple(out)


def state_shardings(axes_tree, state, mesh):
    """The decode state's specs, a tree of ``state``'s structure: each
    leaf whose logical axes are a tuple by :func:`cache_pspec`, any other
    leaf (no axes) replicated, ``()``. A leaf with no ``shape`` (the
    port's host-side ``pos``) has the shape ``()``."""
    if isinstance(axes_tree, tuple):
        return cache_pspec(axes_tree, tuple(getattr(state, "shape", ())),
                           mesh)
    if isinstance(axes_tree, dict):
        return {k: state_shardings(v, state[k], mesh)
                for k, v in axes_tree.items()}
    return ()

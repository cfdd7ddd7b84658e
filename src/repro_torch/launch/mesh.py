"""FL meshes of the port: ``torch.distributed`` ranks named ``("clients",
"model")``.

Counterpart of ``repro.launch.mesh``. A rank is a process, and takes the
place of a JAX device: a ``(c, m)`` mesh is c·m ranks, rank
``r = client_rank * m + model_rank`` (row-major, as JAX reshapes its
device list). Functions only: importing this module starts no process
group and touches no card.

The process group:

* one already up (a test's, a caller's) is used as it is;
* under ``torchrun`` (``WORLD_SIZE`` in the environment) the launcher's
  rendezvous is joined (``env://``);
* otherwise a world of one starts: rank 0, a ``FileStore`` in a temporary
  directory. A single-card run, and ``python -m repro_torch.fed.run`` with
  a sharded spec, need no launcher.

The backend is gloo on the CPU and NCCL across cards; when several ranks
share a card (more ranks than cards) it is gloo, which carries CUDA
tensors for ``all_reduce`` and ``broadcast`` and for no other collective,
so the sharded path uses only those two.

Unlike JAX, which takes the first n devices of a larger machine, a mesh
must cover the world exactly: a rank outside it would have no work, so a
smaller mesh raises as a larger one does.
"""
from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

#: JSON-able FL mesh spec (see ``repro_torch.fed.flconfig.FLConfig.mesh``):
#: None = every rank on the client axis, int n = (n, 1),
#: (c, m) = c-way client mesh x m-way model mesh.
MeshSpec = Union[None, int, Sequence[int]]

def backend_for(device) -> str:
    """gloo on the CPU; on the card NCCL when every rank has a card of
    its own, gloo when ranks share one (NCCL refuses two ranks on one
    card)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def ensure_world(device="cpu") -> int:
    """Start the process group if none is up (see the module docstring)
    and return the world size. On the card the rank's current device is
    set first: ``LOCAL_RANK`` modulo the cards, so ranks beyond the cards
    share them."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
        torch.cuda.init()
    if dist.is_initialized():
        return dist.get_world_size()
    backend = backend_for(dev)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        path = tempfile.mkdtemp(prefix="repro_torch_world_")
        store = dist.FileStore(os.path.join(path, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        # the world this module started ends with the interpreter (atexit
        # runs the group's end first, then removes the store)
        atexit.register(shutil.rmtree, path, True)
        atexit.register(shutdown)
    return dist.get_world_size()


def shutdown() -> None:
    """Destroy the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """Rank 0 (or no process group): the one rank that prints and writes
    files."""
    return rank() == 0


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device, what):
    """The DeviceMesh of ``shape`` over the whole world, or the JAX
    package's error when the world is not that size."""
    dev = torch.device(device)
    world = ensure_world(dev)
    n = 1
    for d in shape:
        n *= d
    if n > world:
        raise RuntimeError(
            f"need {n} devices for the {shape} {what}, have {world} "
            f"ranks; launch with torchrun --nproc-per-node {n}")
    if n < world:
        raise RuntimeError(
            f"the {shape} {what} has {n} devices but the world has "
            f"{world} ranks; a rank outside the mesh would have no work — "
            f"launch {n} ranks or give the mesh {world}")
    from torch.distributed.device_mesh import DeviceMesh
    # collective: every rank of the world builds the mesh's axis groups
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def mesh_shape(spec: MeshSpec, world: int) -> Tuple[int, int]:
    """``None`` -> (world, 1); ``n`` -> (n, 1); ``[c, m]`` -> (c, m)."""
    if spec is None:
        shape = (world, 1)
    elif isinstance(spec, int):
        shape = (spec, 1)
    else:
        spec = tuple(int(d) for d in spec)
        if len(spec) != 2:
            raise ValueError(
                f"FL mesh spec must be None, an int, or a (clients, model) "
                f"pair, got {spec!r}")
        shape = spec
    if min(shape) < 1:
        raise ValueError(f"FL mesh needs >= 1 device per axis, got {shape}")
    return shape


def make_fl_mesh(spec: MeshSpec = None, *, device, client_axis: str =
                 "clients", model_axis: str = "model"):
    """Named 2-D ``(clients, model)`` DeviceMesh for FL rounds
    (``scheduler="sharded"``), the resolver behind ``FLConfig.mesh``:

    * ``None``: every rank on the client axis, ``(world, 1)``;
    * ``int n``: ``(n, 1)``, pure client-data parallelism (bit for bit
      the ``[n, 1]`` mesh);
    * ``(c, m)``: c-way client mesh x m-way model-axis sharding of the
      LBG decision and banks.

    The mesh is always 2-D (the model axis has extent 1 in the first two
    cases). Its process groups: ``mesh.get_group(client_axis)``,
    ``mesh.get_group(model_axis)``."""
    world = ensure_world(device) if spec is None else None
    shape = mesh_shape(spec, world)
    return _mesh(shape, (client_axis, model_axis), device,
                 "(clients, model) FL mesh")


def make_client_mesh(num_devices: Optional[int] = None,
                     axis: str = "clients", *, device):
    """1-D client mesh, the pre-2-D spelling kept for external callers;
    the engine goes through :func:`make_fl_mesh`."""
    n = ensure_world(device) if num_devices is None else num_devices
    if n < 1:
        raise ValueError(f"client mesh needs >= 1 device, got {n}")
    return _mesh((n,), (axis,), device, "client mesh")


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh: ``(16, 16)`` on ``("data", "model")``, or with
    ``multi_pod`` ``(2, 16, 16)`` on ``("pod", "data", "model")``; 256 or
    512 ranks, a card each. A ``DeviceMesh`` only on a world of exactly
    that many ranks (a group already up, or a launcher's ``WORLD_SIZE``):
    any other world raises, as the JAX function raises on too few
    devices, and no smaller mesh is taken. No process group is started
    to find that out. To plan without the ranks, lay the state out on
    ``train.sharding.abstract_mesh`` of the same extents and names."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != n:
        raise RuntimeError(
            f"need {n} devices for the production mesh {shape} on "
            f"{names}, have {world} ranks; launch {n} ranks, a card each, "
            f"or plan on train.sharding.abstract_mesh({shape}, {names}), "
            "which needs no device")
    return _mesh(shape, names, device, "production mesh")


def make_debug_mesh(data: int = 1, model: int = 1, *, device):
    """Small ``("data", "model")`` mesh over the world (tests, examples)."""
    return _mesh((data, model), ("data", "model"), device,
                 "(data, model) debug mesh")


# ------------------------------------------------------------ gathers

#: the most bytes one collective of the gathers and reshards moves: gloo
#: stages a collective on a CUDA tensor through a pinned host copy of its
#: size, which the caching host allocator keeps (its size rounded up to a
#: power of two), so one collective of a model's bytes would hold that
#: much host memory a rank for the rest of the process
PIECE_BYTES = 1 << 28


def _pieces(buf):
    n = max(1, PIECE_BYTES // buf.element_size())
    return [buf[i:i + n] for i in range(0, buf.numel(), n)]


def all_reduce_pieces(buf, group):
    """``dist.all_reduce`` of a flat buffer in pieces of at most
    PIECE_BYTES. For the integer sums of the gathers: a piece sums as the
    whole buffer would."""
    for piece in _pieces(buf):
        dist.all_reduce(piece, group=group)


def broadcast_pieces(buf, src: int, group):
    """``dist.broadcast`` of a flat buffer in pieces of at most
    PIECE_BYTES."""
    for piece in _pieces(buf):
        dist.broadcast(piece, src=src, group=group)


def _byte_spans(nbytes):
    """Each segment's (offset, nbytes), every segment at an 8-byte
    boundary, and the int64 words that hold them all."""
    spans, off = [], 0
    for n in nbytes:
        spans.append((off, n))
        off += -(-n // 8) * 8
    return spans, max(off, 8) // 8


def _as_bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def pack_bytes(tensors, fill: bool = True):
    """One flat int64 buffer holding every tensor's bytes, each tensor's
    segment at an 8-byte boundary, and the segments' (offset, nbytes).
    ``fill=False``: an uninitialised buffer of that layout (to receive
    into)."""
    spans, words = _byte_spans([t.numel() * t.element_size()
                                for t in tensors])
    dev = tensors[0].device
    if not fill:
        return torch.empty(words, dtype=torch.int64, device=dev), spans
    buf = torch.zeros(words, dtype=torch.int64, device=dev)
    raw = buf.view(torch.uint8)
    for t, (o, n) in zip(tensors, spans):
        raw[o:o + n].copy_(_as_bytes(t))
    return buf, spans


def gather_sum_placed(layout, place, group, device):
    """:func:`gather_sum` without its zero-filled inputs and the copies of
    its outputs: the tensors of ``layout`` (a (shape, dtype) each) laid
    out as :func:`pack_bytes` lays them out, in one zero-filled buffer
    into which ``place(i, view)`` writes this rank's elements of tensor
    i; one integer ``all_reduce`` over ``group``
    (:func:`all_reduce_pieces`). Returns views of the buffer (any of them
    keeps the whole buffer alive), bit for bit the gather."""
    spans, words = _byte_spans([
        math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        for shape, dtype in layout])
    buf = torch.zeros(words, dtype=torch.int64, device=device)
    raw = buf.view(torch.uint8)
    views = [raw[o:o + n].view(dtype).view(shape)
             for (shape, dtype), (o, n) in zip(layout, spans)]
    for i, v in enumerate(views):
        place(i, v)
    all_reduce_pieces(buf, group)
    return views


def gather_sum(tensors, group):
    """The gather the sharded path runs as an ``all_reduce``: each rank
    passes zero-filled tensors holding its own elements, no byte of which
    any other rank fills. Summed as integers over ``group``, each byte is
    one rank's byte plus zeros, so the result is the gather bit for bit
    (signed zeros and NaN payloads included), in one collective (pieces of
    at most PIECE_BYTES, :func:`all_reduce_pieces`). Returns new
    tensors."""
    views = gather_sum_placed(
        [(tuple(t.shape), t.dtype) for t in tensors],
        lambda i, v: _as_bytes(v).copy_(_as_bytes(tensors[i])), group,
        tensors[0].device)
    return [v.clone() for v in views]

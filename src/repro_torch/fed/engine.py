"""Federated execution engine of the port (paper Algorithms 1 & 3).

Counterpart of ``repro.fed.engine``: the ``"vmap"``, ``"chunked"`` and
``"buffered"`` client schedulers, the ``"null"``, ``"dense"`` and
``"topk"`` LBG stores, the uplink compressor stacks (top-K, SignSGD,
ATOMO, with or without error feedback), the ``"mean"`` streaming fold
(``DenseAggregator``, ``SparseTopKAggregator`` for the top-k store,
``SparseCodecAggregator`` for its quantized payloads), the robust rules
of ``fed.robust`` in collect mode, every wire codec (``none``,
``delta_idx``, ``int8``, ``fp8``), the Byzantine attacks of
``fed.attacks`` and straggler dropout, the out-of-core ``"topk-host"``
store (:class:`HostTopKLBGStore`, streamed by :class:`_HostBankStreamer`),
hierarchical tiers (``fed.hierarchy``), checkpoint/resume, and the
``"sharded"`` scheduler with the ``"topk-sharded"`` store on a ``(clients,
model)`` mesh of ``torch.distributed`` ranks (:class:`ShardedScheduler`,
``launch.mesh``), whose ``model_sharding="auto"`` runs the client
forward and backward of the dense ``"lm"`` family tensor-parallel over the
model ranks (:meth:`FLEngine._setup_model_sharding`).

One round:

1. the host draws each client's ``tau`` batches and the Algorithm-3
   participation mask from one ``np.random.RandomState(seed + 1)`` stream,
   draw for draw as the JAX engine does, and stages them on the device
   (:class:`RoundPrefetcher` overlaps round t+1's draws and copy with
   round t). A stochastic wire codec also draws one rounding seed per
   client from its own stream (``codec_rng``), which rides the batch dict
   under ``WIRE_KEY``; the Byzantine flags, the attack's per-round seeds,
   the buffered scheduler's delays and the dropout draws come from the
   fault stream (``fault_rng``), in that order each round, and ride the
   batch dict under the attacks' reserved keys;
2. the scheduler walks the clients in chunks (``"vmap"``: one chunk of
   all K). Within a chunk the client axis is written out: local SGD is
   ``torch.func.vmap(torch.func.grad(loss))`` over the chunk's clients
   (or, for a loss marked :data:`CLIENT_LOOP`, a loop over them with
   ``torch.autograd.grad``),
   a payload attack corrupts the Byzantine rows of the accumulated
   gradient, the uplink pipeline compresses the stacks (adding each client's
   error-feedback residual), the LBG store's Algorithm-1 step takes the
   ``(C, ...)`` stacks and calls the *batched* decision kernels
   (``repro_torch.kernels.ops``) directly — one launch per leaf per chunk
   — and the codec encodes what the uplink ships;
3. the aggregator folds every client's update into the round aggregate
   strictly sequentially, ``a + where(w > 0, w * g, 0)`` in client order,
   so vmap and chunked add in the same order (quantized sparse payloads
   go through the dequant-accumulate kernel, one launch per leaf per
   chunk); a robust rule instead collects every chunk's payloads and
   reduces the (K, ...) stack once. The LBG and residual bank rows of the
   chunk are updated in place (unsampled clients keep theirs). The
   ``"buffered"`` scheduler writes each dispatched payload into its
   client's slot of a staleness buffer (in the codec's wire dtype) and
   folds the slots that arrive this round, staleness-discounted;
4. the server steps the params and ``CommLedger`` counts the uplink
   (and, under ``FLConfig.tiers``, the bytes of each aggregation tier).

``"topk-host"`` keeps the top-k bank in host memory (pinned on a CUDA
engine) and runs the round chunk by chunk: a side CUDA stream uploads
chunk c+1's bank and batch rows while chunk c computes and copies chunk
c's new rows back, so the device holds O(chunk) bank rows whatever K. Its
history is the in-memory ``"topk"`` store's bit for bit.

Every ``FLConfig.ckpt_every`` rounds :meth:`FLEngine.run` saves params,
banks, residuals, the staleness buffer, every host rng stream, the
buffered delivery plan, the ledger and the history
(``checkpoint.ckpt``); ``run(resume=True)`` continues the run bit for
bit. The thread that draws a round snapshots the host streams right
after its draws and hands the snapshot over with the round, so the cut is
exact with rounds queued ahead.

Device: the engine runs on the CUDA card unless it is given
``device="cpu"``; without a card it raises rather than carry on quietly on
the CPU. On the card it turns TF32 off for matmuls and cuDNN convolutions
(full fp32, as the JAX reference computes on the CPU). ``fused_kernels``
None or True routes the decision through ``kernels.ops`` (hand-written
kernels on a CUDA tensor, their plain versions on a CPU tensor); False
runs the legacy multi-pass path with dense aggregation.
"""
from __future__ import annotations

import queue
import threading
import warnings
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.comm.accounting import CommLedger
from repro_torch.comm.wire import WIRE_KEY, codec_rng, make_codec
from repro_torch.compression import make_uplink_pipeline
from repro_torch.core import lbgm as lbgm_lib
from repro_torch.core.device import resolve_device  # noqa: F401  (re-export)
from repro_torch.core.lbgm_sharded import (bank_model_partition,
                                           make_mesh_topk_step)
from repro_torch.core.tree_math import tree_size
from repro_torch.fed.attacks import (BYZ_KEY, STALE_KEY, fault_rng,
                                     make_attack, select_byzantine)
from repro_torch.fed.flconfig import FLConfig  # noqa: F401  (re-export)
from repro_torch.fed.hierarchy import HierarchicalAggregator, make_tier_map
from repro_torch.fed.latency import make_latency
from repro_torch.fed.registry import (LBG_STORES, SCHEDULERS,
                                      register_lbg_store, register_scheduler)
from repro_torch.fed.robust import (CollectDenseAggregator,
                                    CollectSparseAggregator,
                                    ScalarMedianSparseAggregator,
                                    make_robust_rule)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (gather_sum, gather_sum_placed,
                                     is_writer)
from repro_torch.models.tensor_parallel import TPContext


#: attribute a model component sets on its loss function (``True``) when
#: ``torch.func`` cannot transform the loss: the engine then runs a chunk's
#: clients one after another under ``torch.autograd`` (the ``"lm"``
#: component's loss checkpoints its blocks and CE chunks, and its kernels
#: are autograd Functions without a vmap rule)
CLIENT_LOOP = "client_loop"

#: attribute a model component sets on its loss function: a callable
#: ``tp -> loss`` (``tp`` a ``models.tensor_parallel.TPContext``) giving the
#: loss on one model rank's param shards, which ``model_sharding="auto"``
#: trains with
TENSOR_PARALLEL = "tensor_parallel"

#: reserved batch key: per-client local-step budgets (the buffered
#: scheduler's compute heterogeneity), stripped before local SGD
TAU_KEY = "_tau"


def resolve_fused_kernels(cfg: FLConfig) -> bool:
    """Kernel half of the ``FLConfig.fused_kernels`` knob. None and True
    take the fused decision (the hand-written kernels on a CUDA device,
    their plain versions on the CPU — ``kernels.ops`` dispatches on the
    tensor's device); False is the legacy multi-pass path."""
    return cfg.fused_kernels is not False


def _tmap(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts of tensors."""
    if isinstance(trees[0], dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


# ------------------------------------------------------------- LBG stores

def _null_stats(C: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    return lbgm_lib.LBGMStats(
        sin2=torch.ones(C, **f32), rho=torch.zeros(C, **f32),
        sent_scalar=torch.zeros(C, dtype=torch.bool, device=device),
        uplink_floats=torch.zeros(C, **f32),
        grad_sq_norm=torch.zeros(C, **f32))


class NullLBGStore:
    """Vanilla FL: no LBG bank, every round is a full round."""

    def init(self, params, num_clients: int, promote=None):
        return {}

    def client_step(self, grad, lbg_k):
        leaf = next(iter(grad.values()))
        return grad, lbg_k, _null_stats(leaf.shape[0], leaf.device)

    def full_round_cost(self, base_cost, stats):
        return base_cost


class DenseLBGStore:
    """Paper-faithful Algorithm 1: one dense params-shaped LBG per client.
    ``fused=True`` takes the decision's three reductions from the one-pass
    projection kernel (one batched launch per leaf per chunk)."""

    def __init__(self, delta_threshold: float, fused: bool = False):
        self.delta = delta_threshold
        self.fused = fused

    def init(self, params, num_clients: int, promote=None):
        """The bank holds what the uplink pipeline emits: each leaf in its
        param's dtype, promoted with ``promote`` (fp32 under error
        feedback, whose fp32 residual widens the gradient; the JAX bank
        takes that dtype at its first write)."""
        return {k: torch.zeros(
            (num_clients,) + tuple(p.shape), device=p.device,
            dtype=p.dtype if promote is None
            else torch.promote_types(p.dtype, promote))
            for k, p in params.items()}

    def client_step(self, grad, lbg_k):
        return lbgm_lib.lbgm_client_step(grad, lbg_k, self.delta,
                                         fused=self.fused)

    def full_round_cost(self, base_cost, stats):
        return base_cost


class TopKLBGStore:
    """Sparse (idx, val) LBG bank at k_frac density (paper App. C.1).
    ``fused=True`` takes the decision's three dense passes per leaf
    (gather, ||g||^2, block top-k) from one launch of the fused decision
    kernel. ``sparse_client_step`` / ``make_aggregator`` implement the
    sparse scalar-round aggregation contract."""

    def __init__(self, delta_threshold: float, k_frac: float = 0.1,
                 fused: bool = False):
        self.delta = delta_threshold
        self.k_frac = k_frac
        self.fused = fused

    def init(self, params, num_clients: int, promote=None):
        # the sparse bank's values are fp32 whatever the leaf's dtype
        proto = lbgm_lib.init_topk_lbg(params, self.k_frac)
        return _tmap(lambda x: torch.zeros((num_clients,) + tuple(x.shape),
                                           dtype=x.dtype, device=x.device),
                     proto)

    def client_step(self, grad, lbg_k):
        return lbgm_lib.lbgm_topk_client_step(grad, lbg_k, self.delta,
                                              self.k_frac, fused=self.fused)

    def sparse_client_step(self, grad, lbg_k):
        """((send, gscale), new_lbg, stats) — no dense scatter."""
        return lbgm_lib.lbgm_topk_client_step(grad, lbg_k, self.delta,
                                              self.k_frac, sparse_out=True,
                                              fused=self.fused)

    def make_aggregator(self, params):
        return SparseTopKAggregator(params, self.k_frac)

    def full_round_cost(self, base_cost, stats):
        return stats.uplink_floats


class HostTopKLBGStore(TopKLBGStore):
    """The top-k bank kept in host memory (``"topk-host"``).

    The decision, cost model and aggregator are :class:`TopKLBGStore`'s,
    and the history is the in-memory store's bit for bit; ``init``
    allocates the (Kp, nb, kb) idx and val banks as CPU tensors, pinned
    when the params live on a CUDA device (the engine then streams them
    with asynchronous copies; a bank that cannot be pinned raises). The
    engine sees ``host_resident`` and runs each round through the
    out-of-core chunk loop, so the device holds O(chunk * k_frac * M) bank
    bytes whatever K."""

    #: engine marker: run the round over bank chunks streamed from the host
    host_resident = True

    def init(self, params, num_clients: int, promote=None):
        proto = lbgm_lib.init_topk_lbg(params, self.k_frac)
        pin = next(iter(params.values())).device.type == "cuda"

        def host(x):
            t = torch.zeros((num_clients,) + tuple(x.shape), dtype=x.dtype,
                            pin_memory=pin)
            if pin and not t.is_pinned():
                raise RuntimeError(
                    "lbg_variant='topk-host': the host bank could not be "
                    "pinned; pageable memory would serialize the streamer")
            return t
        return _tmap(host, proto)


class ShardedTopKLBGStore(TopKLBGStore):
    """The top-k bank laid out for the ``(clients, model)`` mesh.

    The bank's shapes, cost model and aggregator are
    :class:`TopKLBGStore`'s; the decision goes through
    ``core.lbgm_sharded``:

    * on the client axis each rank holds the bank rows of the clients it
      trains (placed by :meth:`ShardedScheduler.layout_banks`), so the
      decision adds no traffic;
    * with ``n_model > 1`` and the sparse payload, each leaf's block rows
      shard over the model axis where ``nb`` divides
      (:meth:`bank_model_partition`): the scheduler binds the store to its
      model rank and group (:meth:`bind_model_rank`), each rank decides on
      its rows of the global block layout, and the three scalars go
      through one ``all_reduce`` over the model group. A rank holds
      O(K·k_frac·M / (c·m)) bank bytes.

    With ``n_model == 1`` the step is the rank-local one, bit for bit
    :class:`TopKLBGStore`'s: the two stores are interchangeable on any
    scheduler."""

    def __init__(self, delta_threshold: float, k_frac: float = 0.1,
                 fused: bool = False, n_model: int = 1):
        super().__init__(delta_threshold, k_frac, fused=fused)
        self.n_model = int(n_model)

    def bind_model_rank(self, model_rank: int, group) -> None:
        """Decide on model rank ``model_rank``'s rows, summing the
        scalars over ``group`` (the mesh's model group): the sparse step
        of those rows takes the place of the whole leaf's. The dense
        g_tilde step (``fused_kernels=False``) stays the whole leaf's,
        and its banks stay model-replicated."""
        self.sparse_client_step = make_mesh_topk_step(
            self.delta, self.k_frac, n_model=self.n_model,
            model_rank=model_rank, group=group, sparse_out=True,
            fused=self.fused)

    def bank_model_partition(self, params) -> Dict[str, bool]:
        """name -> whether that leaf's bank rows shard over the model axis
        (the one rule of ``core.lbgm_sharded``)."""
        return bank_model_partition(params, self.k_frac, self.n_model)


def _lbg_kw(cfg: FLConfig) -> dict:
    """User lbg_kw, refusing the engine-controlled keys."""
    kw = dict(cfg.lbg_kw or {})
    if "fused" in kw:
        raise ValueError(
            "FLConfig.lbg_kw: 'fused' is engine-controlled — set "
            "FLConfig.fused_kernels instead of passing it to the store")
    for reserved in ("n_model", "model_axis"):
        if reserved in kw:
            raise ValueError(
                f"FLConfig.lbg_kw: {reserved!r} is engine-controlled — "
                "the model axis comes from FLConfig.mesh ([clients, "
                "model]), not from store kwargs")
    return kw


register_lbg_store("null", lambda cfg: NullLBGStore())
register_lbg_store("dense", aliases=("full",))(
    lambda cfg: DenseLBGStore(cfg.delta_threshold,
                              fused=resolve_fused_kernels(cfg)))
register_lbg_store("topk")(
    lambda cfg: TopKLBGStore(cfg.delta_threshold,
                             fused=resolve_fused_kernels(cfg),
                             **_lbg_kw(cfg)))
register_lbg_store("topk-sharded")(
    lambda cfg: ShardedTopKLBGStore(cfg.delta_threshold,
                                    fused=resolve_fused_kernels(cfg),
                                    n_model=cfg.mesh_model_dim,
                                    **_lbg_kw(cfg)))
register_lbg_store("topk-host")(
    lambda cfg: HostTopKLBGStore(cfg.delta_threshold,
                                 fused=resolve_fused_kernels(cfg),
                                 **_lbg_kw(cfg)))


def make_lbg_store(cfg: FLConfig):
    key = "null" if not cfg.use_lbgm else cfg.resolved_lbg_variant
    return LBG_STORES.get(key)(cfg)


# ------------------------------------------------------------ aggregators

def _seq_weighted_sum(acc, w, gt_stack):
    """acc + sum_k w[k] * gt_stack[k], strictly sequentially in client
    order. The ``w_k > 0`` gate (not just ``w_k *``) keeps zero-weight pad
    clients out even if their update is not finite."""
    for k in range(w.shape[0]):
        w_k = w[k]
        on = w_k > 0
        for name in sorted(acc):
            acc[name] = acc[name] + torch.where(
                on, w_k * gt_stack[name][k].float(), 0.0)
    return acc


class DenseAggregator:
    """Dense fp32 params-shaped carry; O(M) per client."""

    def init(self, params):
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    def accumulate(self, acc, w, gt_stack):
        return _seq_weighted_sum(acc, w, gt_stack)

    def finalize(self, acc):
        return acc


def _ordered_add_(acc: torch.Tensor, pos: torch.Tensor, val: torch.Tensor):
    """``acc[pos[i]] += val[i]`` over i in one call, ``acc`` flat. On the
    CPU ``index_add_`` adds in i order, so a client-major ``pos`` is the
    strictly sequential client fold bit for bit. On the card
    ``index_put_`` with ``accumulate`` sorts the positions stably and sums
    each position's run in a fixed order: deterministic, the same on every
    call, but reassociated against the CPU's order."""
    if acc.is_cuda:
        acc.index_put_((pos,), val, accumulate=True)
    else:
        acc.index_add_(0, pos, val)


class SparseTopKAggregator:
    """Sparse scalar-round aggregation for the top-k store.

    The carry is a per-leaf ``(nb, block)`` fp32 accumulator in the bank's
    block layout. Client k contributes only its payload:
    ``a[row, idx] += where(w_k > 0, (w_k * gscale_k) * val, 0)``, clients
    in order. A chunk's clients fold in one :func:`_ordered_add_` per leaf:
    top-k indices are unique within a block row, so positions repeat only
    across clients. The carry is updated in place.
    """

    def __init__(self, params, k_frac: float):
        self._layout = {
            name: (tuple(leaf.shape), int(leaf.numel()))
            + lbgm_lib._block_layout(int(leaf.numel()), k_frac)[:2]
            for name, leaf in params.items()}

    def init(self, params):
        dev = next(iter(params.values())).device
        return {name: torch.zeros((nb, block), dtype=torch.float32,
                                  device=dev)
                for name, (_, _, nb, block) in self._layout.items()}

    def accumulate(self, acc, w, out):
        send, gscale = out            # leaves (C, nb, kb); gscale (C,)
        coeff = (w * gscale)[:, None, None]
        on = (w > 0)[:, None, None]
        for name in sorted(acc):
            a = acc[name]
            sk = send[name]
            nb, block = a.shape
            row = torch.arange(nb, device=a.device)[:, None] * block
            pos = (row + sk["idx"].long()).reshape(-1)
            val = torch.where(on, coeff * sk["val"], 0.0).reshape(-1)
            _ordered_add_(a.view(-1), pos, val)
        return acc

    def finalize(self, acc):
        return {name: acc[name].reshape(-1)[:size].reshape(shape)
                for name, (shape, size, _, _) in self._layout.items()}


class SparseCodecAggregator(SparseTopKAggregator):
    """Streaming aggregation of QUANTIZED sparse payloads.

    The layout, client order and finalize of :class:`SparseTopKAggregator`,
    but each client's payload arrives in the wire layout ``{idx, val
    (int8/fp8), scale}`` and widens inside the fold: one
    ``kernels.ops.lbgm_dequant_accum`` call per leaf per chunk (the
    hand-written kernel on the card, its plain version on the CPU), with
    the accumulator updated in place. No fp32 (C, nb, kb) payload stack is
    materialized.
    """

    def accumulate(self, acc, w, out):
        send, gscale = out   # idx/val (C, nb, kb); scale (C, nb, 1)
        for name in sorted(acc):
            sk = send[name]
            ops.lbgm_dequant_accum(acc[name], w, gscale, sk["idx"],
                                   sk["val"], sk["scale"])
        return acc


def make_aggregator(cfg: FLConfig, store, params, codec):
    """``(aggregator, sparse)`` for ``(cfg, store)``, as the JAX engine
    resolves it. The payload is sparse whenever the store supports it and
    ``fused_kernels`` is not False. The rule: ``"mean"`` keeps the
    streaming fold (:class:`SparseCodecAggregator` for a lossy codec's
    sparse payloads); every robust rule switches the schedulers into
    collect mode, with a lossy codec's ``decode_leaf`` and
    ``payload_keys`` handed to the adapter. ``scalar_median`` needs the
    sparse payload: it has no dense fallback."""
    rule = make_robust_rule(cfg)
    sparse = (cfg.fused_kernels is not False
              and hasattr(store, "make_aggregator"))
    if getattr(rule, "scalar_structured", False) and not sparse:
        raise ValueError(
            f"aggregator={cfg.aggregator!r} exploits the sparse "
            "scalar-round payload structure and has no dense fallback — "
            "use a top-k LBG store (lbg_variant='topk'/'topk-sharded') "
            "and leave fused_kernels unset or True")
    decode = codec.decode_leaf if codec.lossy else None
    pk = codec.payload_keys
    if getattr(rule, "streaming", False):
        if sparse:
            if codec.lossy:
                return SparseCodecAggregator(params, store.k_frac), True
            return store.make_aggregator(params), True
        return DenseAggregator(), False
    if getattr(rule, "scalar_structured", False):
        return ScalarMedianSparseAggregator(
            rule, params, store.k_frac, decode=decode,
            payload_keys=pk), True
    if sparse:
        return CollectSparseAggregator(rule, params, store.k_frac,
                                       decode=decode,
                                       payload_keys=pk), True
    return CollectDenseAggregator(rule), False


# ------------------------------------------------------------- schedulers

def pick_chunk(num_clients: int, chunk_size: int) -> int:
    """Chunk size of the chunked scheduler: the largest divisor of K that
    fits in chunk_size, unless that is under half of it (e.g. prime K) —
    then chunk_size, with a zero-weight padded tail chunk."""
    c = min(chunk_size, num_clients)
    d = max(x for x in range(1, c + 1) if num_clients % x == 0)
    return d if d >= max(1, c // 2) else c


def _rows(flag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) per-client vector shaped to broadcast over ``x``'s rows."""
    return flag.reshape((-1,) + (1,) * (x.dim() - 1))


def _keep_sampled(maskf, new, old):
    """Unsampled clients keep their previous per-client state."""
    return _tmap(lambda n, o: torch.where(_rows(maskf, n) > 0, n, o),
                 new, old)


def _select_(dst: torch.Tensor, flag: torch.Tensor, src: torch.Tensor):
    """``dst = where(flag > 0, src, dst)`` per row, in place; a 1-byte
    float (the fp8 wire) is selected through its uint8 bits."""
    src = src.to(dst.dtype)
    if dst.element_size() == 1 and dst.is_floating_point():
        dst, src = dst.view(torch.uint8), src.view(torch.uint8)
    dst.copy_(torch.where(_rows(flag, dst) > 0, src, dst))


def _cat_rows(parts):
    """Concatenate chunks' (C, ...) stacks (nested dicts, tuples) along
    the client axis."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _cat_rows([p[k] for p in parts]) for k in first}
    if isinstance(first, tuple):
        return tuple(_cat_rows([p[i] for p in parts])
                     for i in range(len(first)))
    return torch.cat(parts)


class _ChunkLoop:
    """Walks the (padded) clients in chunks of ``self.chunk``: each chunk
    runs ``client_fn`` over its stacked clients, folds the updates into the
    round aggregate in client order, and writes its bank rows back in
    place. The banks are allocated padded to the chunk grid (K + pad rows);
    pad rows are never sampled. The error-feedback residual bank (empty
    without error feedback) is sliced and written back like the LBG bank.
    A collect-mode aggregator (a robust rule) gets every chunk's raw
    payloads stacked over the (K + pad) clients and reduces them once."""

    num_clients: int
    chunk: int
    pad: int

    # bank placement: identities here; the sharded scheduler places each
    # rank's rows of the (clients, model) mesh
    def configure_store(self, store, sparse_agg: bool, params,
                        codec=None) -> None:
        """Bind ``store`` and ``codec`` to this scheduler's bank layout
        before the banks are allocated."""

    def bank_rows(self, Kp: int) -> int:
        """Client rows of the banks this process allocates."""
        return Kp

    def layout_banks(self, bank):
        """The allocated banks in the layout :meth:`run` indexes."""
        return bank

    def global_banks(self, bank):
        """The banks in the checkpoint's layout."""
        return bank

    def local_banks(self, bank):
        """This process's rows of banks in the checkpoint's layout."""
        return bank

    def sync(self) -> None:
        """Wait for every process of the run (one process: nothing)."""

    def prepare_batch(self, stacked: Dict[str, np.ndarray]):
        """(K, tau, b, ...) host arrays, zero-padded to K + pad rows."""
        if not self.pad:
            return stacked

        def pad(x):
            out = np.zeros((x.shape[0] + self.pad,) + x.shape[1:], x.dtype)
            out[:x.shape[0]] = x
            return out
        return {k: pad(v) for k, v in stacked.items()}

    def run(self, client_fn, agg, params, batch, lbg, resid, w, maskf):
        K, chunk, pad = self.num_clients, self.chunk, self.pad
        if pad:
            w = torch.cat([w, w.new_zeros(pad)])
            maskf = torch.cat([maskf, maskf.new_zeros(pad)])
        collect = getattr(agg, "collect", False)
        acc = None if collect else agg.init(params)
        ys, gts = [], []
        for start in range(0, K + pad, chunk):
            s = slice(start, start + chunk)
            gt, *y = self._chunk(client_fn, params, batch, lbg, resid,
                                 maskf, s)
            if collect:
                gts.append(gt)
            else:
                acc = agg.accumulate(acc, w[s], gt)
            ys.append(y)
        y = [torch.cat(col)[:K] for col in zip(*ys)]
        out = agg.reduce(w, _cat_rows(gts)) if collect else agg.finalize(acc)
        return (out, *y)

    def _chunk(self, client_fn, params, batch, lbg, resid, maskf, s):
        """``client_fn`` over the clients at ``s`` (a slice of the banks'
        client rows, or a chunk's index on the sharded ``(n_chunks,
        chunk/c, ...)`` layout); their bank rows are written back in place
        where ``maskf`` is set. Returns
        ``(gt, *per-client outputs)``."""
        l_c = _tmap(lambda x: x[s], lbg)
        r_c = _tmap(lambda x: x[s], resid)
        b_c = {k: v[s] for k, v in batch.items()}
        gt, nl, nr, *y = client_fn(params, b_c, l_c, r_c)
        for bank, new, old in ((lbg, nl, l_c), (resid, nr, r_c)):
            _tmap(lambda dst, src: dst[s].copy_(src), bank,
                  _keep_sampled(maskf[s], new, old))
        return (gt, *y)


@register_scheduler("vmap")
class VmapScheduler(_ChunkLoop):
    """All K clients in one chunk; O(K·M) transient working set."""

    def __init__(self, cfg: FLConfig, num_clients: int, device="cuda"):
        self.num_clients = num_clients
        self.chunk, self.pad = num_clients, 0


@register_scheduler("chunked")
class ChunkedScheduler(_ChunkLoop):
    """Chunks of ``pick_chunk(K, chunk_size)`` clients; O(chunk·M)
    transient working set."""

    def __init__(self, cfg: FLConfig, num_clients: int, device="cuda"):
        self.num_clients = num_clients
        self.chunk = pick_chunk(num_clients, cfg.chunk_size)
        self.pad = (-num_clients) % self.chunk


@register_scheduler("buffered")
class BufferedScheduler(ChunkedScheduler):
    """FedBuff-style buffered asynchronous aggregation on the chunked
    layout, as the JAX scheduler runs it:

    1. **compute**: every chunk runs ``client_fn``; bank rows update only
       under the *dispatch* mask (a client with a payload in flight
       neither updates its bank nor dispatches again);
    2. **buffer write**: each dispatching client overwrites its one
       in-flight slot (payload leaves in the codec's wire layout and
       dtype, gscale, its dispatch-round weight, uplink/scalar/wire), in
       place; every other slot is kept as it was;
    3. **delivery fold**: the slots delivered this round fold with weights
       ``w0 * disc(stale) * deliver``, normalized over the delivered
       cohort. The streaming rules fold chunk by chunk with the chunked
       scheduler's exact ``accumulate`` calls (the zero-latency guarantee:
       with ``latency="none"`` the round equals ``"chunked"``'s); a
       collect rule gets the whole (K + pad) buffer.

    Uplink, scalar fraction and wire bytes are those of the delivered
    payloads, reported in their arrival round."""

    #: engine marker: run via run_buffered with the host delivery plan
    delivery_weighted = True

    def run(self, client_fn, agg, params, batch, lbg, resid, w, maskf):
        raise TypeError(
            "BufferedScheduler aggregates through run_buffered(...); the "
            "engine threads the delivery plan and staleness buffer")

    def run_buffered(self, client_fn, agg, params, batch, lbg, resid,
                     buf, w0, dispatchf, deliverf, stalef, disc):
        K, chunk, pad = self.num_clients, self.chunk, self.pad
        dzp, w0p = dispatchf, w0
        if pad:
            z = dispatchf.new_zeros(pad)
            dzp, w0p = torch.cat([dispatchf, z]), torch.cat([w0, z])
        Kp = K + pad
        ys = []
        for start in range(0, Kp, chunk):
            s = slice(start, start + chunk)
            (send, gscale), loss, uplink, scalar, wire, sin2 = self._chunk(
                client_fn, params, batch, lbg, resid, dzp, s)
            d = dzp[s]
            _tmap(lambda dst, src: _select_(dst[s], d, src), buf["send"],
                  send)
            for key, val in (("gscale", gscale), ("w0", w0p[s]),
                             ("uplink", uplink), ("scalar", scalar),
                             ("wire", wire)):
                _select_(buf[key][s], d, val)
            ys.append((loss, sin2))
        loss, sin2 = (torch.cat(col)[:K] for col in zip(*ys))
        # the synchronous schedulers' normalization: under the zero-latency
        # plan (dispatch == deliver == mask, stale 0, disc(0) == 1.0
        # exactly) these are the chunked weights bit for bit
        wd = buf["w0"][:K] * disc(stalef) * deliverf
        wn = wd / torch.clamp(wd.sum(), min=1e-12)
        wnp = torch.cat([wn, wn.new_zeros(pad)]) if pad else wn
        if getattr(agg, "collect", False):
            out = agg.reduce(wnp, (buf["send"], buf["gscale"]))
        else:
            acc = agg.init(params)
            for start in range(0, Kp, chunk):
                s = slice(start, start + chunk)
                acc = agg.accumulate(
                    acc, wnp[s], (_tmap(lambda x: x[s], buf["send"]),
                                  buf["gscale"][s]))
            out = agg.finalize(acc)
        return (out, loss, buf["uplink"][:K] * deliverf,
                buf["scalar"][:K] * deliverf, buf["wire"][:K] * deliverf,
                sin2)


def pick_sharded_chunk(num_clients: int, chunk_size: int, n_dev: int) -> int:
    """Chunk size of the sharded scheduler: :func:`pick_chunk`'s policy,
    with the chunk split evenly over the ``n_dev`` client ranks.
    ``n_dev == 1`` is ``pick_chunk`` exactly (half of what makes the
    one-rank round bit for bit the chunked one)."""
    if n_dev == 1:
        return pick_chunk(num_clients, chunk_size)
    # capped at min(chunk_size, K) like pick_chunk, rounded down to the
    # mesh grid, never below n_dev (the smallest legal chunk)
    c = max(min(chunk_size, num_clients) // n_dev * n_dev, n_dev)
    divs = [x for x in range(n_dev, c + 1, n_dev) if num_clients % x == 0]
    if divs and divs[-1] >= max(n_dev, c // 2):
        return divs[-1]
    return c


@register_scheduler("sharded")
class ShardedScheduler(_ChunkLoop):
    """The chunked layout over a ``(clients, model)`` mesh of
    ``torch.distributed`` ranks (``FLConfig.mesh``, resolved by
    ``launch.mesh.make_fl_mesh``). Every rank builds the same engine; the
    chunk splits evenly over the c client ranks.

    * **Rows a rank holds.** Client rank r holds positions ``[r·chunk/c,
      (r+1)·chunk/c)`` of *every* chunk (the JAX bank shards axis 1 of its
      ``(n_chunks, chunk, ...)`` layout over ``clients``): their bank rows,
      their batches, and it trains those clients. Banks are stored
      ``(n_chunks, chunk/c, ...)``; a model-sharded leaf of the sparse bank
      (:meth:`configure_store`) keeps only model rank q's ``nb/m`` block
      rows. Per rank that is 1/c of the bank, 1/(c·m) for a model-sharded
      leaf.
    * **Seed, then sum.** Per chunk, client rank 0 folds its clients into
      the carry, the others into zeros, and one ``all_reduce`` over the
      client group sums them. On one client rank there is no collective:
      a ``(1, 1)`` mesh makes the chunked scheduler's ``accumulate``
      calls in its order, bit for bit, and ``n`` equals ``[n, 1]``.
      More client ranks reassociate the client sum (fp32 tolerance;
      uplink accounting stays exact).
    * **The carry over ``model``.** A model-sharded carry leaf holds each
      model rank's own rows; the round's end assembles every leaf across
      the model group (replicated leaves from model rank 0).
    * **Collect mode** (robust rules): every rank gathers the whole
      ``(Kp, ...)`` payload stack in client order (model-sharded payload
      rows assembled too) and the rule reduces it once.
    * **Per-client outputs** (loss, uplink, scalar, wire, sin²) come back
      in client order on every rank, so every rank holds the same history.

    The collectives are ``all_reduce`` only; a gather is an
    ``all_reduce`` of zero-filled buffers (``launch.mesh.gather_sum``)."""

    AXIS = "clients"
    MODEL_AXIS = "model"

    def __init__(self, cfg: FLConfig, num_clients: int, device="cuda"):
        from repro_torch.launch.mesh import make_fl_mesh
        self.mesh = make_fl_mesh(cfg.mesh, device=device,
                                 client_axis=self.AXIS,
                                 model_axis=self.MODEL_AXIS)
        self.n_client_dev, self.n_model = (int(d) for d in
                                           self.mesh.mesh.shape)
        self.n_dev = self.n_client_dev * self.n_model
        self.client_rank = self.mesh.get_local_rank(self.AXIS)
        self.model_rank = self.mesh.get_local_rank(self.MODEL_AXIS)
        self.client_group = self.mesh.get_group(self.AXIS)
        self.model_group = self.mesh.get_group(self.MODEL_AXIS)
        self.num_clients = num_clients
        self.chunk = pick_sharded_chunk(num_clients, cfg.chunk_size,
                                        self.n_client_dev)
        self.pad = (-num_clients) % self.chunk
        self.local = self.chunk // self.n_client_dev
        # set by configure_store when the sparse bank model-shards:
        # {name: bool} for the bank's block rows, mirrored by the carry;
        # None: everything model-replicated
        self._msharded: Optional[Dict[str, bool]] = None

    # ----------------------------------------------------- placement
    def configure_store(self, store, sparse_agg: bool, params,
                        codec=None) -> None:
        """Model sharding is on when the mesh has a model axis, the engine
        took the sparse payload (the dense g_tilde cannot be assembled
        across model ranks) and the store partitions its bank; otherwise
        every bank row and carry leaf is model-replicated. The store then
        decides on this model rank's rows, and ``codec`` encodes them."""
        if (self.n_model > 1 and sparse_agg
                and isinstance(store, ShardedTopKLBGStore)):
            self._msharded = store.bank_model_partition(params)
            store.bind_model_rank(self.model_rank, self.model_group)
            if codec is not None:
                codec.bind_model_rows(self.model_rank, self._msharded)

    def bind_model_axes(self, axes_tree, params) -> Dict[str, tuple]:
        """``model_sharding="auto"``: each leaf's spec over this mesh
        (:func:`auto_specs`)."""
        from repro_torch.train.sharding import MeshAxes
        mesh = MeshAxes((self.AXIS, self.MODEL_AXIS),
                        {self.AXIS: self.n_client_dev,
                         self.MODEL_AXIS: self.n_model})
        return auto_specs(axes_tree, params, mesh)

    def _model_rows(self, name, x, dim: int):
        """(start, rows) of model rank q's rows along ``dim`` of a leaf
        whose global extent there is ``x.shape[dim]``, or None when the
        leaf is model-replicated."""
        if not (self._msharded or {}).get(name):
            return None
        nb_l = x.shape[dim] // self.n_model
        return self.model_rank * nb_l, nb_l

    def bank_rows(self, Kp: int) -> int:
        """Client rows of the banks this rank allocates."""
        return Kp // self.chunk * self.local

    def layout_banks(self, bank):
        """This rank's ``(n_chunks * chunk/c, ...)`` bank -> ``(n_chunks,
        chunk/c, ...)``, a model-sharded sparse leaf narrowed to this model
        rank's block rows."""
        out = {}
        for name, leaf in bank.items():
            if isinstance(leaf, dict):
                out[name] = {}
                for k, x in leaf.items():
                    x = x.reshape((-1, self.local) + tuple(x.shape[1:]))
                    rows = self._model_rows(name, x, 2)
                    if rows is not None:
                        x = x.narrow(2, *rows).clone()
                    out[name][k] = x
            else:
                out[name] = leaf.reshape((-1, self.local)
                                         + tuple(leaf.shape[1:]))
        return out

    def prepare_batch(self, stacked: Dict[str, np.ndarray]):
        """(K, tau, b, ...) host arrays -> this rank's (n_chunks, chunk/c,
        tau, b, ...): every rank draws every client's batch from the same
        stream, then keeps its own."""
        c0 = self.client_rank * self.local
        out = {}
        for k, v in super().prepare_batch(stacked).items():
            v = v.reshape((-1, self.chunk) + v.shape[1:])
            out[k] = np.ascontiguousarray(v[:, c0:c0 + self.local])
        return out

    # ----------------------------------------------------- gathers
    def _to_global(self, name, local, model_dim: Optional[int]):
        """Zero-filled ``(n_chunks, chunk, ...)`` holding this rank's
        ``(n_chunks, chunk/c, ...)`` rows at their client positions (and
        model rows along ``model_dim`` for a model-sharded leaf, or for any
        tensor named None: each model rank's own slot there); a
        model-replicated leaf is filled by model rank 0 alone."""
        shape = list(local.shape)
        shape[1] = self.chunk
        rows = None
        if model_dim is not None and (
                name is None or (self._msharded or {}).get(name)):
            shape[model_dim] *= self.n_model
            rows = (self.model_rank * local.shape[model_dim],
                    local.shape[model_dim])
        out = local.new_zeros(shape)
        if rows is None and self.model_rank != 0:
            return out
        c0 = self.client_rank * self.local
        dst = out[:, c0:c0 + self.local]
        if rows is not None:
            dst = dst.narrow(model_dim, *rows)
        dst.copy_(local)
        return out

    def _gather(self, items):
        """``[(name, local, model_dim)]`` -> each local ``(n_chunks,
        chunk/c, ...)`` tensor at its global ``(n_chunks, chunk, ...)``
        extent, on every rank, in one gather over the world. ``model_dim``
        is the block-row dim of a sparse leaf (None: no model rows)."""
        if self.n_dev == 1 or not items:
            return [x for _, x, _ in items]
        return gather_sum([self._to_global(*it) for it in items], None)

    def _gather_tree(self, tree, model_dim: Optional[int]):
        """:meth:`_gather` over every leaf of ``{name: tensor}`` or
        ``{name: {k: tensor}}`` (``model_dim`` applies to the latter)."""
        items = []
        for name in sorted(tree):
            leaf = tree[name]
            if isinstance(leaf, dict):
                items += [(name, leaf[k], model_dim) for k in sorted(leaf)]
            else:
                items.append((name, leaf, None))
        it = iter(self._gather(items))
        return {name: ({k: next(it) for k in sorted(tree[name])}
                       if isinstance(tree[name], dict) else next(it))
                for name in sorted(tree)}

    def global_banks(self, bank):
        """The banks in the JAX sharded engine's global ``(n_chunks,
        chunk, ...)`` layout (the checkpoint's), on every rank."""
        return self._gather_tree(bank, 2)

    def local_banks(self, bank):
        """This rank's rows of global ``(n_chunks, chunk, ...)`` banks."""
        c0 = self.client_rank * self.local
        out = {}
        for name, leaf in bank.items():
            if isinstance(leaf, dict):
                out[name] = {}
                for k, x in leaf.items():
                    x = x[:, c0:c0 + self.local]
                    rows = self._model_rows(name, x, 2)
                    out[name][k] = x if rows is None else x.narrow(2, *rows)
            else:
                out[name] = leaf[:, c0:c0 + self.local]
        return out

    def sync(self) -> None:
        """Every rank waits for every other (one all_reduce of a zero):
        a checkpoint is on disk before any rank reads it."""
        if self.n_dev > 1:
            z = torch.zeros(1, device=self.mesh.device_type)
            dist.all_reduce(z)

    def _client_sum(self, acc):
        """The chunk's carry summed over the client group: one
        ``all_reduce`` of every leaf in one flat fp32 buffer. The leaves
        come back as views of it."""
        names = sorted(acc)
        flat = torch.cat([acc[n].reshape(-1) for n in names])
        dist.all_reduce(flat, group=self.client_group)
        out, off = {}, 0
        for n in names:
            k = acc[n].numel()
            out[n] = flat[off:off + k].view(acc[n].shape)
            off += k
        return out

    def _acc_init(self, agg, params):
        acc = agg.init(params)
        for name, a in acc.items():
            rows = self._model_rows(name, a, 0)
            if rows is not None:
                acc[name] = a.narrow(0, *rows).clone()
        return acc

    def _assemble_acc(self, acc):
        """Every carry leaf at its global extent, on every rank of the
        model group: the rank's rows (model-sharded) or model rank 0's
        leaf (replicated), gathered in one ``all_reduce``, written in place
        into the buffer it sums (``launch.mesh.gather_sum_placed``): one
        fp32 copy of the model a rank beside its rows, where zero-filled
        leaves, their packed buffer and the copies out would be three."""
        if self.n_model == 1:
            return acc
        names = sorted(acc)
        sharded = [bool((self._msharded or {}).get(n)) for n in names]
        layout = [(((acc[n].shape[0] * self.n_model,) + acc[n].shape[1:])
                   if on else acc[n].shape, acc[n].dtype)
                  for n, on in zip(names, sharded)]

        def place(i, full):
            a = acc[names[i]]
            if sharded[i]:
                full.narrow(0, self.model_rank * a.shape[0],
                            a.shape[0]).copy_(a)
            elif self.model_rank == 0:
                full.copy_(a)

        dev = next(iter(acc.values())).device
        return dict(zip(names, gather_sum_placed(layout, place,
                                                 self.model_group, dev)))

    # ----------------------------------------------------- the round
    def run(self, client_fn, agg, params, batch, lbg, resid, w, maskf):
        K, chunk, pad, cl = (self.num_clients, self.chunk, self.pad,
                             self.local)
        if pad:
            w = torch.cat([w, w.new_zeros(pad)])
            maskf = torch.cat([maskf, maskf.new_zeros(pad)])
        n_chunks = (K + pad) // chunk
        c0 = self.client_rank * cl
        w_l = w.reshape(n_chunks, chunk)[:, c0:c0 + cl].contiguous()
        m_l = maskf.reshape(n_chunks, chunk)[:, c0:c0 + cl].contiguous()
        collect = getattr(agg, "collect", False)
        acc = None if collect else self._acc_init(agg, params)
        ys, gts = [], []
        for i in range(n_chunks):
            gt, *y = self._chunk(client_fn, params, batch, lbg, resid, m_l,
                                 i)
            if collect:
                gts.append(gt)
            elif self.n_client_dev == 1:
                acc = agg.accumulate(acc, w_l[i], gt)
            else:
                if self.client_rank != 0:
                    acc = {n: torch.zeros_like(a) for n, a in acc.items()}
                acc = self._client_sum(agg.accumulate(acc, w_l[i], gt))
            ys.append(y)
        # per-client outputs in client order, from model rank 0; under
        # model sharding each model rank's wire bytes are its share of the
        # payload (the codec's bind_model_rows), summed here
        cols = [torch.stack(col) for col in zip(*ys)]
        items = [(n, c, None) for n, c in zip(
            ("loss", "uplink", "scalar", "wire", "sin2"), cols)]
        if self._msharded:
            items[3] = (None, cols[3][..., None], 2)
        y = self._gather(items)
        if self._msharded:
            y[3] = y[3].double().sum(-1).float()
        y = [x.reshape(-1)[:K] for x in y]
        if collect:
            stack = self._gather_payloads(gts)
            out = agg.reduce(w, stack)
        else:
            out = agg.finalize(self._assemble_acc(acc))
        return (out, *y)

    def _gather_payloads(self, gts):
        """Collect mode: the chunks' payloads (dense ``{name: (cl, ...)}``
        or sparse ``({name: {k: (cl, nb_l, kb)}}, gscale (cl,))``) as the
        whole ``(Kp, ...)`` stack in client order, on every rank."""
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        stack = lambda parts: _tmap(lambda *xs: torch.stack(xs), *parts)
        if not isinstance(gts[0], tuple):
            return _tmap(flat, self._gather_tree(stack(gts), None))
        send = stack([g[0] for g in gts])
        keys = [(name, k) for name in sorted(send) for k in sorted(send[name])]
        got = self._gather([(name, send[name][k], 2) for name, k in keys]
                           + [(None, torch.stack([g[1] for g in gts]), None)])
        out = {}
        for (name, k), x in zip(keys, got):
            out.setdefault(name, {})[k] = flat(x)
        return out, flat(got[-1])


def auto_specs(axes_tree, params, mesh) -> Dict[str, tuple]:
    """name -> spec (a tuple of ``"model"`` or None per dim) of every leaf
    of ``params`` under ``model_sharding="auto"``, JAX's rule
    (``ShardedScheduler.bind_model_axes``): the component's logical axes
    through ``train.sharding.param_pspec`` in "replicated" mode, except
    that a leaf with a ``vocab`` axis (the embedding, lm_head) shards its
    ``embed`` (d_model) dim instead, where the extent divides, so the
    token lookup and the CE's label pick stay local."""
    from repro_torch.train.sharding import param_pspec
    missing = sorted(set(params) - set(axes_tree))
    if missing:
        raise ValueError(
            f"model_sharding='auto': the model component's axes tree "
            f"is missing leaves {missing} — every param leaf needs a "
            "logical-axis tuple (see train.sharding.params_shardings)")
    m = mesh.shape.get(ShardedScheduler.MODEL_AXIS, 1)

    def leaf_spec(name):
        axes = tuple(axes_tree[name])
        shape = tuple(params[name].shape)
        if "vocab" in axes:
            out, used = [], False
            for logical, dim in zip(axes, shape):
                if logical == "embed" and not used and dim % m == 0:
                    out.append(ShardedScheduler.MODEL_AXIS)
                    used = True
                else:
                    out.append(None)
            return tuple(out)
        return param_pspec(axes, shape, "replicated", mesh)

    return {name: leaf_spec(name) for name in params}


def make_scheduler(cfg: FLConfig, num_clients: int, device="cuda"):
    """The configured scheduler: ``factory(cfg, num_clients, device=)``
    (the sharded scheduler builds its mesh on ``device``)."""
    return SCHEDULERS.get(cfg.scheduler)(cfg, num_clients, device=device)


# ------------------------------------------------------------- engine

class FLEngine:
    """``loss_fn(params, batch_dict) -> (loss, metrics)`` over a flat param
    dict; ``client_data`` is a list of per-client dicts of numpy arrays
    (see ``repro_torch.fed.partition``). ``params`` may be tensors on any
    device or numpy arrays; the engine keeps its copy on ``device``.

    A loss that ``torch.func`` cannot transform carries ``CLIENT_LOOP``
    (see :meth:`_make_client_loop`).

    After every round, ``sin2_history[-1]`` holds each client's LBP error
    sin²(α) of that round (1 for unsampled and vanilla-FL clients' rows as
    the store computed them), so a caller can check how far the decisions
    sat from ``delta_threshold``.
    """

    def __init__(self, loss_fn: Callable, params, client_data:
                 List[Dict[str, np.ndarray]], flcfg: FLConfig,
                 device="cuda", model_axes=None):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        # each leaf's logical axes, for model_sharding="auto"
        self.model_axes = model_axes
        self.cfg = flcfg
        # model_sharding="auto": the model group's context, once bound
        self._tp: Optional[TPContext] = None
        self.params = {k: torch.as_tensor(v).to(self.device)
                       for k, v in params.items()}
        self._n_params = tree_size(self._params)
        K = flcfg.num_clients
        if len(client_data) != K:
            raise ValueError(f"FLEngine: {len(client_data)} client shards "
                             f"for num_clients={K}")
        empty = [k for k, d in enumerate(client_data)
                 if len(next(iter(d.values()))) == 0]
        if empty:
            raise ValueError(
                f"FLEngine: clients {empty} have no training samples; "
                "every client needs >= 1 (a label-skew partition starves "
                "clients when class demand exceeds supply — use more data, "
                "fewer clients, or more classes_per_client)")
        # Byzantine attack and fault injection: the cohort is one fixed
        # round(attack_frac*K) subset; a data-level attack corrupts its
        # shards here, before the one concatenated copy below. Per-round
        # attack seeds, delays and dropout draw from the fault stream,
        # never from the batch/mask rng
        self.attack = make_attack(flcfg)
        self._byz = select_byzantine(K, flcfg.attack_frac, flcfg.seed)
        self._payload_attack = None
        if self.attack is not None:
            if self.attack.level == "data":
                client_data = [
                    self.attack.corrupt(d) if self._byz[k] > 0 else d
                    for k, d in enumerate(client_data)]
            else:
                self._payload_attack = self.attack
        self._fault_rng = fault_rng(flcfg.seed)
        self.sched = make_scheduler(flcfg, K, device=self.device)
        self._chunk, self._pad = self.sched.chunk, self.sched.pad
        sizes = np.array([len(next(iter(d.values())))
                          for d in client_data], np.float64)
        self.weights = torch.as_tensor(
            (sizes / sizes.sum()).astype(np.float32), device=self.device)
        # one concatenated copy of the client data; per-round batches are
        # a single fancy-index into it
        self._data_sizes = sizes.astype(np.int64)
        self._data_offsets = np.concatenate(
            [[0], np.cumsum(self._data_sizes[:-1])]).astype(np.int64)
        self._data_cat = {k: np.concatenate([d[k] for d in client_data])
                          for k in client_data[0]}
        self.store = make_lbg_store(flcfg)
        #: "topk-host": the bank lives in host memory and the round streams
        #: it chunk by chunk (HostTopKLBGStore, _HostBankStreamer)
        self._host_bank = bool(getattr(self.store, "host_resident", False))
        # the codec's rounding seeds come from their own stream, drawn only
        # when the codec is stochastic: a deterministic codec leaves every
        # other draw where it was
        self.codec = make_codec(flcfg)
        self._codec_rng = codec_rng(flcfg.seed)
        self.agg, self._sparse_agg = make_aggregator(flcfg, self.store,
                                                     self.params, self.codec)
        # hierarchical tiers: the streaming fold keeps its flat carry and
        # folds per-edge partials beside it (finalize is the flat fold bit
        # for bit); under a collect rule or a lossy codec's fold the tier
        # map only attributes bytes
        self.tiers = make_tier_map(flcfg)
        self._tiered_fold = False
        if self.tiers is not None and type(self.agg) in (
                SparseTopKAggregator, DenseAggregator):
            self.agg = HierarchicalAggregator(
                self.agg, self.tiers.edge_ids_padded(K + self._pad),
                self.tiers.n_edges)
            self._tiered_fold = True
        if self._host_bank and getattr(self.agg, "collect", False):
            raise ValueError(
                f"lbg_variant='topk-host' streams bank chunks and folds "
                f"payloads as they arrive, but aggregator="
                f"{flcfg.aggregator!r} runs in collect mode (a full "
                "(K, payload) device stack — exactly the O(K) memory the "
                "host store exists to avoid); use aggregator='mean'")
        if self.codec.lossy and not (
                self._sparse_agg or isinstance(self.store, NullLBGStore)):
            raise ValueError(
                f"codec={flcfg.codec!r} is lossy, but the dense LBGM bank "
                "cannot track the server-decoded values (recycle rounds "
                "would replay unquantized LBGs the server never saw). Use "
                "the sparse payload path (lbg_variant='topk'/'topk-sharded' "
                "with fused_kernels not False) or vanilla FL "
                "(use_lbgm=False)")
        # buffered scheduler: the latency model, the host delivery plan and
        # (below, once Kp is known) the staleness buffer on the device
        self._latency = None
        self._buffer = None
        self._tau_vec = None
        if getattr(self.sched, "delivery_weighted", False):
            if not self._sparse_agg:
                raise ValueError(
                    "scheduler='buffered' buffers sparse (idx, val) "
                    "payloads between dispatch and delivery — use "
                    "lbg_variant='topk'/'topk-sharded' and leave "
                    "fused_kernels unset or True")
            self._latency = make_latency(flcfg)
            # at most one payload in flight per client; arrival[k] is the
            # round it lands (-1: idle)
            self._arrival = np.full(K, -1, np.int64)
            self._dispatch_round = np.zeros(K, np.int64)
            self._plan_round = 0
            self._pending_delays = None
            self._tau_vec = self._latency.sample_tau(K, flcfg.tau)
            #: payloads delivered over the run
            self.n_delivered = 0.0
        # the (clients, model) mesh: the scheduler decides, with the store,
        # which bank and carry leaves shard over the model axis, before the
        # banks are allocated
        self.sched.configure_store(self.store, self._sparse_agg, self.params,
                                   codec=self.codec)
        Kp = K + self._pad
        # a scheduler that places banks (the sharded one) allocates only
        # this rank's client rows and lays them out itself
        rows = self.sched.bank_rows(Kp)
        self._pipeline, self._use_ef = make_uplink_pipeline(
            flcfg.compressor, flcfg.compressor_kw, flcfg.error_feedback)
        self.lbg = self.store.init(
            self.params, rows,
            promote=torch.float32 if self._use_ef else None)
        self.residual = {
            k: torch.zeros((rows,) + tuple(p.shape), dtype=torch.float32,
                           device=self.device)
            for k, p in self.params.items()} if self._use_ef else {}
        self.lbg = self.sched.layout_banks(self.lbg)
        self.residual = self.sched.layout_banks(self.residual)
        if self._latency is not None:
            self._buffer = self._init_buffer(Kp)
        if flcfg.model_sharding == "auto":
            self._setup_model_sharding(model_axes)
        self._client_fn = self._build_client_fn()
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._streamer = None
        if self._host_bank:
            self._streamer = _HostBankStreamer(self.lbg, self._chunk,
                                               self.device)
            # the finalizer holds the streamer only, not the engine
            self._streamer_finalizer = weakref.finalize(
                self, self._streamer.close)
        self.ledger = CommLedger()
        self.history: List[Dict[str, float]] = []
        self.sin2_history: List[np.ndarray] = []
        #: the host streams and buffered plan right after the draws of the
        #: round that ran last, taken by the thread that drew it: the cut
        #: save_checkpoint persists
        self._host_snapshot: Optional[dict] = None

    # ------------------------------------------------------------ params
    @property
    def params(self):
        """The global params. Under ``model_sharding="auto"`` each rank
        rests its shards and reading this assembles the whole leaves over
        the model group (a broadcast from each model rank: every rank of
        the group reads it together, as ``run_experiment``'s eval and the
        checkpoint do)."""
        if self._tp is None:
            return self._params
        return self._tp.assemble(self._params)

    @params.setter
    def params(self, full):
        self._params = (full if self._tp is None
                        else self._tp.shard_tree(full))

    def _server_step(self, agg):
        """params -= lr * the round's aggregate (each rank's shards of it
        under ``model_sharding="auto"``)."""
        lr = self.cfg.lr
        if self._tp is not None:
            agg = self._tp.shard_tree(agg)
        self._params = {k: p - lr * agg[k].to(p.dtype)
                        for k, p in self._params.items()}

    # -------------------------------------------------------------- build
    def _setup_model_sharding(self, model_axes):
        """Wire ``model_sharding="auto"`` (from ``__init__``): every leaf's
        spec by JAX's rule (:meth:`ShardedScheduler.bind_model_axes`), the
        model component's tensor-parallel loss on this rank's shards, and
        the params cut to those shards. The decision, the banks, the carry
        and the uplink accounting stay ``"replicate"``'s: each chunk's
        gradients are assembled to their whole leaves once, over the model
        group, before the store's step. Every refusal names its fix."""
        cfg = self.cfg

        def bad(msg):
            raise ValueError(f"model_sharding='auto': {msg}")

        if model_axes is None:
            bad("the model component carries no sharding metadata — only "
                "components returning (params, loss_fn, axes_tree) support "
                "tensor-parallel client compute (the 'lm' component does; "
                "fcn/cnn do not). Pass model_axes to FLEngine or use "
                "model_sharding='replicate'")
        if not isinstance(self.sched, ShardedScheduler):
            bad(f"scheduler {cfg.scheduler!r} cannot bind model axes; use "
                "the built-in 'sharded' scheduler")
        if getattr(self.agg, "collect", False):
            bad(f"aggregator={cfg.aggregator!r} runs in collect mode, "
                "which stacks per-client payloads across the model axis; "
                "only the streaming 'mean' rule is supported")
        if not (self._sparse_agg
                and isinstance(self.store, ShardedTopKLBGStore)):
            bad("requires the sparse aggregation contract over the "
                "mesh-aware bank — set lbg_variant='topk-sharded' and "
                "leave fused_kernels unset or True")
        if cfg.compressor != "none":
            bad(f"compressor={cfg.compressor!r} would run its top-k/sign "
                "ops on model-sharded gradients inside the auto region; "
                "only compressor='none' is supported")
        tp_form = getattr(self.loss_fn, TENSOR_PARALLEL, None)
        if tp_form is None:
            bad("the model component's loss has no tensor-parallel form "
                f"(a loss_fn.{TENSOR_PARALLEL} callable; the 'lm' "
                "component's has one); use model_sharding='replicate'")
        full = self._params
        specs = self.sched.bind_model_axes(model_axes, full)
        self._tp = TPContext(specs, {k: v.shape for k, v in full.items()},
                             self.sched.model_group, self.sched.model_rank,
                             self.sched.n_model)
        self.loss_fn = tp_form(self._tp)
        setattr(self.loss_fn, CLIENT_LOOP, True)
        self._params = self._tp.shard_tree(full)

    def _init_buffer(self, Kp):
        """The buffered scheduler's staleness buffer: one in-flight slot
        per (padded) client — payload leaves in the codec's wire layout and
        dtype, the payload's gscale, the client's dispatch-round weight,
        and the uplink/scalar/wire numbers reported on delivery."""
        k_frac = self.store.k_frac
        val_dt = (self.codec.wire_dtype if self.codec.lossy
                  else torch.float32)
        dev = self.device
        send = {}
        for name in sorted(self.params):
            nb, _, kb = lbgm_lib._block_layout(
                int(self.params[name].numel()), k_frac)
            sk = {"idx": torch.zeros((Kp, nb, kb), dtype=torch.int32,
                                     device=dev),
                  "val": torch.zeros((Kp, nb, kb), dtype=torch.float32,
                                     device=dev).to(val_dt)}
            if "scale" in self.codec.payload_keys:
                sk["scale"] = torch.ones((Kp, nb, 1), dtype=torch.float32,
                                         device=dev)
            send[name] = sk
        out = {"send": send}
        for key in ("gscale", "w0", "uplink", "scalar", "wire"):
            out[key] = torch.zeros(Kp, dtype=torch.float32, device=dev)
        return out

    def _make_client_update(self):
        """tau local SGD steps for a chunk of clients, vmapped over the
        chunk's client axis: every client starts from the global params.
        Returns the accumulated stochastic gradient (C, ...) per leaf and
        each client's mean loss (C,). A loss marked ``client_loop`` takes
        :meth:`_make_client_loop` instead.

        ``tau_k`` (C,), the buffered scheduler's per-client budgets: steps
        ``t >= tau_k`` still run (one vmapped shape) but their gradient is
        multiplied by 0 and their loss left out, as the JAX engine masks
        them."""
        cfg = self.cfg
        loss_fn = self.loss_fn
        if getattr(loss_fn, CLIENT_LOOP, False):
            return self._make_client_loop()

        def loss_aux(p, b):
            loss, _ = loss_fn(p, b)
            return loss, loss.detach()
        grad_fn = torch.func.vmap(torch.func.grad(loss_aux, has_aux=True))

        def client_update(params, batches, tau_k=None):
            C = next(iter(batches.values())).shape[0]
            p = {k: v.expand((C,) + v.shape) for k, v in params.items()}
            asg, losses, ons = None, [], []
            for t in range(cfg.tau):
                g, loss = grad_fn(p, {k: v[:, t] for k, v in
                                      batches.items()})
                if tau_k is not None:
                    on = (t < tau_k).float()
                    g = {k: x * _rows(on, x).to(x.dtype)
                         for k, x in g.items()}
                    ons.append(on)
                p = {k: p[k] - cfg.lr * g[k].to(p[k].dtype) for k in p}
                asg = g if asg is None else {k: asg[k] + g[k] for k in g}
                losses.append(loss)
            if tau_k is None:
                return asg, torch.stack(losses).mean(0)
            ons = torch.stack(ons)
            return asg, ((torch.stack(losses) * ons).sum(0)
                         / torch.clamp(ons.sum(0), min=1.0))

        return client_update

    def _make_client_loop(self):
        """The client axis of :meth:`_make_client_update` written out as a
        loop, for a loss ``torch.func`` cannot transform (checkpointed
        blocks, kernels behind autograd Functions): the chunk's clients one
        after another, each taking tau steps ``p - lr * g`` with
        ``torch.autograd.grad``. Each client's accumulated gradient is
        summed into its row of a preallocated ``(C, ...)`` stack in the
        gradient's dtype, then its temporaries are freed. The sum over tau
        is the JAX engine's ``jnp.sum`` over the stacked steps, which adds
        low-precision gradients in fp32 and rounds once: two steps round
        once in place; past two, a low-precision leaf sums in fp32. With
        ``tau_k`` client c takes its first ``tau_k[c]`` steps only (the
        masked steps of the vmapped form add exact zeros) and its loss is
        their mean."""
        from repro_torch.train.trainer import grad_and_loss
        cfg = self.cfg
        loss_fn = self.loss_fn

        def client_update(params, batches, tau_k=None):
            C = next(iter(batches.values())).shape[0]
            steps = ([cfg.tau] * C if tau_k is None
                     else [min(cfg.tau, int(t)) for t in tau_k.tolist()])
            asg = {k: torch.empty((C,) + v.shape, dtype=v.dtype,
                                  device=v.device)
                   for k, v in params.items()}
            losses = torch.empty(C, dtype=torch.float32,
                                 device=next(iter(params.values())).device)
            for c in range(C):
                acc = {k: v[c] if cfg.tau <= 2 or v.dtype == torch.float32
                       else torch.empty(v.shape[1:], dtype=torch.float32,
                                        device=v.device)
                       for k, v in asg.items()}
                for a in acc.values():
                    a.zero_()
                p, ls = params, []
                for t in range(steps[c]):
                    with torch.enable_grad():
                        g, loss = grad_and_loss(
                            loss_fn, p, {k: v[c, t]
                                         for k, v in batches.items()})
                    with torch.no_grad():
                        p = {k: p[k] - cfg.lr * g[k].to(p[k].dtype)
                             for k in p}
                        for k in acc:
                            acc[k].add_(g[k])
                    ls.append(loss)
                    del g, loss
                for k, a in acc.items():
                    if a.dtype != asg[k].dtype:
                        asg[k][c].copy_(a)
                losses[c] = torch.stack(ls).mean() if ls else 0.0
                del p, ls, acc
            return asg, losses

        return client_update

    def _build_client_fn(self):
        pipeline = self._pipeline
        store = self.store
        sparse = self._sparse_agg
        codec = self.codec
        attack = self._payload_attack
        tp = self._tp
        client_update = self._make_client_update()
        # the legacy dense-aggregation path over a top-k store prices the
        # same (idx, val) payload as the sparse path, from the static
        # block layout
        sparse_wire = None
        if not sparse and getattr(store, "k_frac", None) is not None:
            sparse_wire = codec.sparse_layout_bytes(
                [lbgm_lib._block_layout(int(p.numel()), store.k_frac)[::2]
                 for p in self.params.values()])

        def client_fn(params, batches, lbg_c, resid_c):
            # the engine's reserved keys (Byzantine flags, attack extras,
            # the codec's seed, local-step budgets) ride the batch dict;
            # strip them before local SGD
            batches = dict(batches)
            byz = batches.pop(BYZ_KEY, None)
            seed = batches.pop(WIRE_KEY, None)
            tau_k = batches.pop(TAU_KEY, None)
            extras = {k: batches.pop(k) for k in list(batches)
                      if k.startswith("_atk_")}
            asg, loss = client_update(params, batches, tau_k)
            if tp is not None:
                # model_sharding="auto": the chunk's gradients of this
                # rank's shards, reshard once to every leaf's whole extent
                # (replicated leaves from model rank 0), so the store
                # decides on the rows "replicate" mode hands it
                asg = tp.assemble(asg, lead=1)
            if attack is not None:
                # a Byzantine client corrupts its accumulated gradient
                # BEFORE the uplink pipeline and the LBGM decision: its
                # bank, decision and payload follow from the corrupted
                # update, as a protocol-following adversary's would
                asg = attack.apply(asg, byz, extras)
            asg, resid_c, cost = pipeline(asg, resid_c)
            step = store.sparse_client_step if sparse else store.client_step
            gt, lbg_c, stats = step(asg, lbg_c)
            scalar = stats.sent_scalar
            uplink = torch.where(scalar, torch.ones_like(cost),
                                 store.full_round_cost(cost, stats))
            if sparse:
                gt, lbg_c, wire = codec.encode_sparse(gt, lbg_c, stats,
                                                      seed)
            elif sparse_wire is not None:
                wire = torch.where(
                    scalar, torch.full_like(cost, codec.scalar_bytes),
                    torch.full_like(cost, sparse_wire))
            else:
                gt, wire = codec.encode_dense(gt, uplink, seed)
            return (gt, lbg_c, resid_c, loss, uplink, scalar, wire,
                    stats.sin2)

        return client_fn

    def _round_buffered(self, batch, plan):
        """The buffered round: ``plan``'s (K,) dispatch / deliver / stale
        vectors (see :meth:`_sample_mask`). Loss is taken over the
        dispatch cohort; uplink, scalar fraction and wire bytes over the
        payloads delivered this round."""
        dispatchf, deliverf, stalef = (
            torch.as_tensor(plan[k].astype(np.float32), device=self.device)
            for k in ("dispatch", "deliver", "stale"))
        w0 = self.weights * dispatchf
        wl = w0 / torch.clamp(w0.sum(), min=1e-12)
        agg, losses, uplink, scalar, wire, sin2 = self.sched.run_buffered(
            self._client_fn, self.agg, self._params, batch, self.lbg,
            self.residual, self._buffer, w0, dispatchf, deliverf, stalef,
            self._latency.staleness_weight)
        self._server_step(agg)
        metrics = torch.stack([
            (losses * wl).sum(), uplink.sum(),
            scalar.sum() / torch.clamp(deliverf.sum(), min=1.0),
            wire.sum()]).tolist()
        self.sin2_history.append(sin2.cpu().numpy())
        return dict(zip(("loss", "uplink_floats", "frac_scalar",
                         "wire_bytes"), metrics))

    def _round(self, batch, mask: np.ndarray):
        maskf = torch.as_tensor(mask.astype(np.float32), device=self.device)
        w = self.weights * maskf
        w = w / torch.clamp(w.sum(), min=1e-12)
        if self._host_bank:
            out = self._run_host_chunks(batch, w, maskf)
        else:
            out = self.sched.run(self._client_fn, self.agg, self._params,
                                 batch, self.lbg, self.residual, w, maskf)
        agg, losses, uplink, scalar, wire, sin2 = out
        self._server_step(agg)
        metrics = torch.stack([
            (losses * w).sum(),
            (uplink * maskf).sum(),
            (scalar.float() * maskf).sum() / torch.clamp(maskf.sum(),
                                                         min=1.0),
            (wire * maskf).sum()]).tolist()
        self.sin2_history.append(sin2.cpu().numpy())
        return dict(zip(("loss", "uplink_floats", "frac_scalar",
                         "wire_bytes"), metrics))

    def _run_host_chunks(self, batch, w, maskf):
        """The ``"topk-host"`` round: the chunked scheduler's ``run`` with
        the same chunk body (``client_fn``, the aggregator's ``accumulate``,
        the sampled rows written back), but each chunk's bank and batch rows
        arrive from the host through the streamer's double buffer, and its
        new rows go back to the host bank. Nothing here waits for the
        device; the per-chunk outputs are concatenated at the end, and
        ``finish_round`` is the round's one barrier (the host bank is then
        the post-round bank)."""
        K, chunk, pad = self.cfg.num_clients, self._chunk, self._pad
        client_fn, agg, params = self._client_fn, self.agg, self._params
        if pad:
            w = torch.cat([w, w.new_zeros(pad)])
            maskf = torch.cat([maskf, maskf.new_zeros(pad)])
        n_chunks = (K + pad) // chunk
        acc = agg.init(params)
        st = self._streamer
        st.begin_round(batch, n_chunks)
        ys = []
        try:
            for c in range(n_chunks):
                s = slice(c * chunk, (c + 1) * chunk)
                l_c, b_c = st.get(c)
                gt, nl, _, *y = client_fn(params, b_c, l_c, {})
                acc = agg.accumulate(acc, w[s], gt)
                st.put_writeback(c, _keep_sampled(maskf[s], nl, l_c))
                ys.append(y)
        finally:
            st.finish_round()
        y = [torch.cat(col)[:K] for col in zip(*ys)]
        return (agg.finalize(acc), *y)

    def host_chunk_device_bytes(self) -> int:
        """Device bytes of one streamed chunk of bank rows: the round holds
        two (the double buffer) plus the chunk's new rows, whatever
        ``num_clients``."""
        if not self._host_bank:
            raise ValueError("host_chunk_device_bytes: engine does not "
                             "run the topk-host store")
        leaves = []
        _tmap(leaves.append, self.lbg)
        return int(sum(v[0].numel() * v.element_size() for v in leaves)
                   * self._chunk)

    # -------------------------------------------------------------- data
    def _sample_batches(self, rng: np.random.RandomState):
        """Per-round (K + pad, tau, b, ...) host batches. The K per-client
        index draws run in client order — the JAX engine's stream, draw for
        draw (one ``randint`` call with per-client bounds). The reserved keys ride along, as the JAX engine draws them: a
        payload attack's Byzantine flags and per-round extras (fault
        stream), a stochastic codec's rounding seed per client (codec
        stream), and under the buffered scheduler the round's delays
        (fault stream, kept for :meth:`_sample_mask`; also under
        ``STALE_KEY`` for an attack) and the local-step budgets. The fault
        stream's order each round: attack extras, delays, dropout. Pad rows
        get zeros; uint32 seeds travel as int64.

        Under ``"topk-host"`` the batch stays on the host, as CPU tensors
        (pinned on a CUDA engine: the data rows are gathered straight into
        them), and the streamer uploads each chunk's rows beside its bank
        rows: nothing O(K) is staged on the device."""
        cfg = self.cfg
        K = cfg.num_clients
        # one call with per-client bounds: numpy's legacy bounded draw takes
        # the elements in order, each from its own bound, so these are the
        # per-client loop's draws (the JAX engine's), draw for draw
        idx = rng.randint(0, self._data_sizes[:, None, None],
                          size=(K, cfg.tau, cfg.batch_size)).astype(np.int64)
        idx += self._data_offsets[:, None, None]
        if self._host_bank:
            data = {k: self._gather_host(v, idx)
                    for k, v in self._data_cat.items()}
            stacked = {}
        else:
            data = {}
            stacked = {k: v[idx] for k, v in self._data_cat.items()}
        if self._payload_attack is not None:
            stacked[BYZ_KEY] = self._byz
            stacked.update(self._payload_attack.round_extras(
                self._fault_rng, cfg.num_clients))
        if self.codec.stochastic:
            stacked[WIRE_KEY] = self._codec_rng.randint(
                0, 2 ** 31 - 1, size=cfg.num_clients)
        if self._latency is not None:
            d = np.asarray(self._latency.sample_delays(
                self._fault_rng, cfg.num_clients), np.int64)
            self._pending_delays = d
            if self._payload_attack is not None:
                stacked[STALE_KEY] = d.astype(np.float32)
            if self._tau_vec is not None:
                stacked[TAU_KEY] = np.asarray(self._tau_vec, np.int32)
        stacked = {k: v.astype(np.int64) if v.dtype == np.uint32 else v
                   for k, v in stacked.items()}
        stacked = self.sched.prepare_batch(stacked)
        if not self._host_bank:
            return stacked
        pin = self.device.type == "cuda"
        data.update({k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in stacked.items()})
        return {k: v.pin_memory() if pin and k in stacked else v
                for k, v in data.items()}

    def _gather_host(self, v: np.ndarray, idx: np.ndarray) -> torch.Tensor:
        """``v[idx]`` zero-padded to K + pad rows, gathered straight into a
        CPU tensor (pinned on a CUDA engine)."""
        K = idx.shape[0]
        src = torch.from_numpy(v)
        out = torch.empty((K + self._pad,) + idx.shape[1:] + v.shape[1:],
                          dtype=src.dtype,
                          pin_memory=self.device.type == "cuda")
        # torch's gather runs without the interpreter lock, so the round
        # loop on the main thread keeps running beside it
        torch.index_select(src, 0, torch.from_numpy(idx.reshape(-1)),
                           out=out[:K].view((-1,) + v.shape[1:]))
        out[K:].zero_()
        return out

    def _sample_mask(self, rng: np.random.RandomState):
        """Algorithm-3 participation mask: exactly ``num_clients`` uniforms
        when ``sample_frac < 1`` (none otherwise); an empty cohort revives
        the client closest to its threshold without drawing more. With
        ``dropout_frac`` each sampled client then drops out on a uniform of
        the fault stream (``num_clients`` of them a round); an all-dropped
        round revives the sampled client least likely to have dropped.

        Under the buffered scheduler the mask becomes the round's delivery
        plan, a dict of (K,) ``dispatch``, ``deliver`` and ``stale``
        vectors and ``n_evicted``: pure host bookkeeping over the delays
        :meth:`_sample_batches` drew."""
        cfg = self.cfg
        if cfg.sample_frac >= 1.0:
            mask = np.ones(cfg.num_clients)
        else:
            u = rng.rand(cfg.num_clients)
            mask = (u < cfg.sample_frac).astype(np.float64)
            if mask.sum() == 0:
                mask[int(np.argmin(u))] = 1.0
        if cfg.dropout_frac > 0.0:
            d = self._fault_rng.rand(cfg.num_clients)
            dropped = mask * (d >= cfg.dropout_frac)
            if dropped.sum() == 0:
                dropped = np.zeros_like(mask)
                dropped[int(np.argmax(np.where(mask > 0, d, -1.0)))] = 1.0
            mask = dropped
        if self._latency is None:
            return mask
        t = self._plan_round
        self._plan_round += 1
        d = self._pending_delays
        if d is None:
            # a mask drawn without a preceding _sample_batches: the delays
            # now, from the same stream in the same per-round order
            d = np.asarray(self._latency.sample_delays(
                self._fault_rng, cfg.num_clients), np.int64)
        self._pending_delays = None
        # max-staleness eviction: a payload in flight longer than s rounds
        # is dropped and its client may dispatch again this round
        n_evicted = 0
        s_max = self._latency.max_staleness
        if s_max is not None:
            evict = (self._arrival >= 0) & \
                (t - self._dispatch_round > s_max)
            n_evicted = int(evict.sum())
            self._arrival[evict] = -1
        dispatch = (mask > 0) & (self._arrival < 0)
        self._dispatch_round[dispatch] = t
        self._arrival[dispatch] = t + d[dispatch]
        deliver = self._arrival == t
        stale = np.where(deliver, t - self._dispatch_round, 0)
        self._arrival[deliver] = -1
        return {"mask": mask,
                "dispatch": dispatch.astype(np.float64),
                "deliver": deliver.astype(np.float64),
                "stale": stale.astype(np.float64),
                "n_evicted": float(n_evicted)}

    def _stage(self, host_batch, stream=None):
        """Host batch -> device tensors. With ``stream`` (a side CUDA
        stream) the copy runs there from pinned memory, and the returned
        event marks its end."""
        if stream is None:
            return ({k: torch.from_numpy(v).to(self.device)
                     for k, v in host_batch.items()}, None)
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(v).pin_memory().to(
                self.device, non_blocking=True)
                for k, v in host_batch.items()}
            ev = torch.cuda.Event()
            ev.record(stream)
        return out, ev

    # -------------------------------------------------------------- run
    def prefetcher(self, rng: np.random.RandomState,
                   depth: int = 2) -> "RoundPrefetcher":
        """Double-buffered host prep over ``rng``'s draw stream; pass it to
        :meth:`run_round` in place of the rng, and ``close()`` it after."""
        return RoundPrefetcher(self, rng, depth=depth)

    def run_round(self, rng) -> Dict[str, float]:
        """One FL round. ``rng`` is a ``np.random.RandomState`` (host prep
        in line) or a :class:`RoundPrefetcher` (same draw stream)."""
        if isinstance(rng, RoundPrefetcher):
            # the producer's post-draw snapshot of the host streams comes
            # with the round: the one kept is always the round that runs
            batch, mask, ev, self._host_snapshot = rng.next()
            if ev is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(ev)
                for v in batch.values():
                    v.record_stream(cur)
        else:
            batch = self._sample_batches(rng)
            if not self._host_bank:
                batch, _ = self._stage(batch)
            mask = self._sample_mask(rng)
            self._host_snapshot = self._capture_host_state(rng)
        with torch.no_grad():
            if isinstance(mask, dict):
                # the buffered plan: uplink and wire (and the vanilla
                # baseline) count in the round the payloads arrive
                m = self._round_buffered(batch, mask)
                n_del = float(mask["deliver"].sum())
                self.n_delivered += n_del
                self.ledger.n_evicted += mask["n_evicted"]
                vanilla = n_del * self._n_params
            else:
                m = self._round(batch, mask)
                vanilla = float(mask.sum()) * self._n_params
        tiers = None
        if self.tiers is not None:
            # the edge links carried this round's client payloads (the
            # delivered ones under the buffered plan); each active edge and
            # region forwards one dense fp32 partial carry
            active = mask["deliver"] if isinstance(mask, dict) else mask
            tiers = self.tiers.round_bytes(
                active, m["wire_bytes"],
                carry_bytes=4.0 * self._n_params)
        self.ledger.record(m["uplink_floats"], vanilla,
                           wire=m["wire_bytes"], vanilla_wire=4.0 * vanilla,
                           tiers=tiers)
        m["total_uplink"] = self.ledger.uplink_floats
        m["vanilla_uplink"] = self.ledger.vanilla_floats
        m["savings"] = self.ledger.savings
        m["total_wire_bytes"] = self.ledger.wire_bytes
        m["wire_savings"] = self.ledger.wire_savings
        self.history.append(m)
        return m

    @property
    def total_uplink(self) -> float:
        return self.ledger.uplink_floats

    @property
    def vanilla_uplink(self) -> float:
        return self.ledger.vanilla_floats

    # ----------------------------------------------------- checkpointing
    @staticmethod
    def _rng_state(rng: np.random.RandomState) -> dict:
        _, keys, pos, has_gauss, cached = rng.get_state()
        return {"keys": keys.copy(), "pos": np.int64(pos),
                "has_gauss": np.int64(has_gauss),
                "cached": np.float64(cached)}

    @staticmethod
    def _set_rng_state(rng: np.random.RandomState, s: dict) -> None:
        rng.set_state(("MT19937", _np(s["keys"]).astype(np.uint32),
                       int(s["pos"]), int(s["has_gauss"]),
                       float(s["cached"])))

    def _capture_host_state(self, rng: np.random.RandomState) -> dict:
        """Snapshot of every host stream that feeds the round draws: the
        batch/mask rng, the fault and codec streams, and the buffered
        delivery plan. Taken by the thread that draws a round (the
        prefetcher's producer, or ``run_round`` in line) right after its
        draws: the cut that makes resume exact. A prefetcher may have
        drawn rounds ahead at save time, but the snapshot the engine holds
        is the round that ran, and the queued draws are drawn again, the
        same, from the restored streams."""
        s = {"rng": self._rng_state(rng),
             "fault_rng": self._rng_state(self._fault_rng),
             "codec_rng": self._rng_state(self._codec_rng)}
        if self._latency is not None:
            s["arrival"] = self._arrival.copy()
            s["dispatch_round"] = self._dispatch_round.copy()
            s["plan_round"] = np.int64(self._plan_round)
        return s

    def _restore_host_state(self, host: dict, rng: np.random.RandomState):
        """Set ``rng``, the fault and codec streams and the buffered plan
        from a :meth:`_capture_host_state` snapshot."""
        self._set_rng_state(rng, host["rng"])
        self._set_rng_state(self._fault_rng, host["fault_rng"])
        self._set_rng_state(self._codec_rng, host["codec_rng"])
        if self._latency is not None:
            self._arrival[...] = _np(host["arrival"]).astype(np.int64)
            self._dispatch_round[...] = _np(
                host["dispatch_round"]).astype(np.int64)
            self._plan_round = int(host["plan_round"])
            self._pending_delays = None

    def save_checkpoint(self, path: str) -> None:
        """Write the run's state after the last completed round to ``path``
        (atomically, ``checkpoint.ckpt``'s format): params, the LBG bank
        (the host bank under topk-host), the residual, the staleness buffer
        and delivered count, every host stream, the ledger and the history
        — what :meth:`restore_checkpoint` needs to continue bit for bit.
        On a mesh every rank calls it: the banks are gathered to the JAX
        sharded engine's global layout, rank 0 writes, and every rank waits
        until the file is there."""
        if self._host_snapshot is None:
            raise ValueError(
                "save_checkpoint: no completed round to snapshot — run "
                "at least one round first")
        # on a mesh the banks in the JAX sharded engine's global
        # (n_chunks, chunk, ...) layout, gathered on every rank
        lbg = self.sched.global_banks(self.lbg)
        residual = self.sched.global_banks(self.residual)
        state = {
            "params": self.params,
            "lbg": lbg,
            "residual": residual,
            "host": self._host_snapshot,
            "ledger": self.ledger.state_dict(),
            "history": self.history,
        }
        if self._buffer is not None:
            # numpy has no fp8: a 1-byte float leaf is saved as its bits
            state["buffer"] = _tmap(
                lambda t: t.view(torch.uint8) if _is_byte_float(t) else t,
                self._buffer)
            state["n_delivered"] = np.float64(self.n_delivered)
        if is_writer():
            ckpt_lib.save_checkpoint(path, state, metadata={
                "version": 1, "round": len(self.history),
                "config": self.cfg.to_dict()})
        self.sched.sync()

    def restore_checkpoint(self, path: str,
                           rng: np.random.RandomState) -> int:
        """Load ``path`` into this engine, built from the same FLConfig
        (checked against the checkpoint's metadata), and set ``rng``, the
        caller's batch/mask stream for the rounds to come. Every bank and
        buffer is written in place, so the topk-host streamer keeps its
        reference to the host bank; on a mesh each rank takes its own rows
        of the global banks. Returns the number of completed
        rounds (the index to resume from)."""
        tree, meta = ckpt_lib.load_checkpoint(path)
        if meta.get("config") != self.cfg.to_dict():
            raise ValueError(
                "restore_checkpoint: checkpoint was written under a "
                "different FLConfig — rebuild the engine with the "
                f"original config. Checkpoint config: {meta.get('config')}")
        self.params = {k: tree["params"][k].to(device=self.device,
                                                dtype=p.dtype)
                       for k, p in self._params.items()}
        for name, have in (("lbg", self.lbg), ("residual", self.residual),
                           ("buffer", self._buffer)):
            if have:
                src = tree[name]
                if name != "buffer":
                    src = self.sched.local_banks(src)
                _tmap(_copy_in, have, src)
        if self._buffer is not None:
            self.n_delivered = float(tree["n_delivered"])
        host = tree["host"]
        self._restore_host_state(host, rng)
        self.ledger.load_state(tree["ledger"])
        self.history = [{k: float(v) for k, v in h.items()}
                        for h in tree.get("history", [])]
        self._host_snapshot = host
        return int(meta["round"])

    def run(self, rounds: int, eval_fn: Optional[Callable] = None,
            eval_every: int = 10, verbose: bool = False,
            prefetch: bool = True, resume: bool = False):
        """Rounds up to ``rounds`` in all; ``resume=True`` first restores
        the checkpoint at ``FLConfig.ckpt_path`` and runs the rest. Every
        ``ckpt_every`` completed rounds the state goes to ``ckpt_path``."""
        cfg = self.cfg
        rng = np.random.RandomState(cfg.seed + 1)
        start = 0
        if resume:
            if not cfg.ckpt_path:
                raise ValueError(
                    "run(resume=True) needs FLConfig.ckpt_path")
            start = self.restore_checkpoint(cfg.ckpt_path, rng)
        src = self.prefetcher(rng) if prefetch else rng
        try:
            for r in range(start, rounds):
                m = self.run_round(src)
                if eval_fn is not None and (r + 1) % eval_every == 0:
                    m.update(eval_fn(self.params))
                if verbose and (r + 1) % eval_every == 0:
                    print(f"round {r+1:4d} " +
                          " ".join(f"{k}={v:.4g}" for k, v in m.items()))
                if cfg.ckpt_every and (r + 1) % cfg.ckpt_every == 0:
                    self.save_checkpoint(cfg.ckpt_path)
        finally:
            if prefetch:
                src.close()
        return self.history

    def close(self):
        """Stop the topk-host streamer (also done when the engine is
        collected)."""
        if self._streamer is not None:
            self._streamer_finalizer()


def _is_byte_float(t: torch.Tensor) -> bool:
    return t.element_size() == 1 and t.is_floating_point()


def _copy_in(dst: torch.Tensor, src: torch.Tensor):
    """Write a loaded checkpoint leaf into ``dst`` in place (a 1-byte
    float leaf arrives as its uint8 bits)."""
    if _is_byte_float(dst):
        dst.view(torch.uint8).copy_(src)
    else:
        dst.copy_(src.to(dst.dtype))


def _np(x) -> np.ndarray:
    """A checkpoint leaf (a CPU tensor after a load, or an array) as an
    array."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------- prefetcher

class RoundPrefetcher:
    """Host->device double buffering for the round loop.

    A daemon thread draws each round's ``(batch, mask)`` from the engine's
    rng in round order (batches first, then the mask — the synchronous
    order, which also draws the fault stream in its order: attack extras,
    delays, dropout), snapshots the host streams right after (the cut a
    checkpoint saves) and, on a CUDA device, copies the batch to the card
    on a side stream from pinned memory, so round t+1's host prep and copy
    overlap round t (under ``"topk-host"`` the batch stays on the host: the
    bank streamer uploads it chunk by chunk). While alive it is the rng's
    only consumer, so the history is identical to the synchronous path.
    ``close()`` rewinds the rng, the fault and codec streams and the
    buffered plan to the snapshot of the last round it handed out (to
    their state at construction if it handed out none): the rounds still
    queued are dropped as if never drawn, and a synchronous
    ``run_round`` on the same rng continues the run exactly.
    """

    _SENTINEL = object()

    def __init__(self, engine: FLEngine, rng: np.random.RandomState,
                 depth: int = 2):
        self._engine = engine
        self._rng = rng
        # the streams as they stand before any draw of this prefetcher
        self._last = engine._capture_host_state(rng)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._produce, name="fl-round-prefetch", daemon=True)
        self._thread.start()

    def _produce(self):
        eng = self._engine
        try:
            while not self._stop.is_set():
                host = eng._sample_batches(self._rng)
                if self._stop.is_set():
                    break
                mask = eng._sample_mask(self._rng)
                snap = eng._capture_host_state(self._rng)
                if eng._host_bank:
                    batch, ev = host, None
                else:
                    batch, ev = eng._stage(host, eng._copy_stream)
                item = (batch, mask, ev, snap)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # re-raised on the consumer side
            self._err = e
            while not self._stop.is_set():
                try:
                    self._q.put(self._SENTINEL, timeout=0.05)
                    break
                except queue.Full:
                    continue

    def next(self):
        """The next round's (batch, mask, copy event, host snapshot);
        raises if the thread died or after ``close()`` (whatever the queue
        still holds: a producer blocked in ``put()`` may land a round after
        the drain)."""
        while True:
            if self._stop.is_set():
                raise RuntimeError("RoundPrefetcher used after close()")
            if self._err is not None and self._q.empty():
                raise RuntimeError(
                    "round prefetch thread failed") from self._err
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is self._SENTINEL:
                raise RuntimeError(
                    "round prefetch thread failed") from self._err
            self._last = item[3]
            return item

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def close(self):
        self._stop.set()
        self._drain()  # so a blocked put() observes the stop flag
        self._thread.join(timeout=10)
        # a put() that landed after the first drain: no staged batch (device
        # memory) outlives close()
        self._drain()
        if self._thread.is_alive():
            warnings.warn(
                "RoundPrefetcher thread did not exit within 10s of close(); "
                "it may still hold the rng", RuntimeWarning)
        elif self._last is not None:
            # drop the queued rounds' draws: the streams as the synchronous
            # path leaves them after the rounds that ran
            self._engine._restore_host_state(self._last, self._rng)


# ----------------------------------------------------- host bank streamer

class _HostBankStreamer:
    """Streams the ``"topk-host"`` bank's chunks through a double buffer
    of device rows.

    On a CUDA engine the copies run on one side stream, ordered by events,
    and the host never waits inside the round:

    * ``begin_round`` uploads chunks 0 and 1 (bank rows from the pinned
      bank, batch rows from the round's pinned batch) into buffers 0 and
      1, each upload ending in an event;
    * ``get(c)`` makes the compute stream wait on chunk c's upload event
      and returns buffer ``c % 2``;
    * ``put_writeback(c, rows)`` records an event on the compute stream
      after chunk c, has the side stream wait on it, copies the new rows
      into the pinned bank (``record_stream`` keeps the allocator off
      them until the copy ran), and uploads chunk c + 2 into the buffer
      chunk c has finished with;
    * ``finish_round`` is the round's one barrier: the side stream is
      synchronized, so the host bank is the post-round bank before
      anything reads it (the next round, a checkpoint, a test).

    The stream's order puts a chunk's write-back before any later
    upload of the same rows. On a CPU engine the same steps run as plain
    copies."""

    def __init__(self, host_bank, chunk: int, device: torch.device):
        self._bank = host_bank   # {name: {idx, val: (Kp, nb, kb)}}
        self._chunk = chunk
        self._device = device
        self._side = (torch.cuda.Stream(device) if device.type == "cuda"
                      else None)
        self._bufs = None        # two {"bank": ..., "batch": ...} sets
        self._free = [None, None]    # compute events: buffer i unused
        self._up = {}                # chunk -> upload event
        self._batch = None
        self._n = 0

    def _rows(self, c):
        return slice(c * self._chunk, (c + 1) * self._chunk)

    def _alloc(self, batch):
        def like(x):
            return torch.empty((self._chunk,) + tuple(x.shape[1:]),
                               dtype=x.dtype, device=self._device)
        return [{"bank": _tmap(like, self._bank),
                 "batch": {k: like(v) for k, v in batch.items()}}
                for _ in range(2)]

    def begin_round(self, batch, n_chunks: int):
        if self._bufs is None or set(self._bufs[0]["batch"]) != set(batch):
            self._bufs = self._alloc(batch)
        self._batch, self._n = batch, n_chunks
        self._up = {}
        self._upload(0)
        self._upload(1)

    def _upload(self, c: int):
        if c >= self._n:
            return
        slot, sl = c % 2, self._rows(c)
        buf = self._bufs[slot]
        pairs = []
        _tmap(lambda d, h: pairs.append((d, h[sl])), buf["bank"], self._bank)
        pairs += [(buf["batch"][k], v[sl]) for k, v in self._batch.items()]
        if self._side is None:
            for d, h in pairs:
                d.copy_(h)
            return
        with torch.cuda.stream(self._side):
            if self._free[slot] is not None:
                self._side.wait_event(self._free[slot])
            for d, h in pairs:
                d.copy_(h, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._side)
        self._up[c] = ev

    def get(self, c: int):
        """Chunk c's device ``(bank rows, batch rows)``, ready for the
        compute stream."""
        buf = self._bufs[c % 2]
        if self._side is not None:
            torch.cuda.current_stream(self._device).wait_event(
                self._up.pop(c))
        return buf["bank"], buf["batch"]

    def put_writeback(self, c: int, new_rows):
        """Copy chunk c's new bank rows into the host bank, then upload
        chunk c + 2 into the buffer chunk c used."""
        sl = self._rows(c)
        if self._side is None:
            _tmap(lambda h, d: h[sl].copy_(d), self._bank, new_rows)
        else:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self._device))
            self._free[c % 2] = done
            with torch.cuda.stream(self._side):
                self._side.wait_event(done)

                def back(h, d):
                    h[sl].copy_(d, non_blocking=True)
                    d.record_stream(self._side)
                _tmap(back, self._bank, new_rows)
        self._upload(c + 2)

    def finish_round(self):
        if self._side is not None:
            self._side.synchronize()
        self._batch = None
        self._up = {}

    def close(self):
        if self._side is not None:
            self._side.synchronize()
        self._bufs = None
        self._batch = None

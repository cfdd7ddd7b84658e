"""Federated execution engine of the port (paper Algorithms 1 & 3).

Counterpart of ``repro.fed.engine``, for the slice the paper's own
experiment loop runs: the ``"vmap"`` and ``"chunked"`` client schedulers,
the ``"null"``, ``"dense"`` and ``"topk"`` LBG stores, the uplink
compressor stacks (top-K, SignSGD, ATOMO, with or without error
feedback), the ``"mean"`` streaming fold (``DenseAggregator``,
``SparseTopKAggregator`` for the top-k store, ``SparseCodecAggregator``
for its quantized payloads) and every wire codec (``none``,
``delta_idx``, ``int8``, ``fp8``). The host-bank, buffered, sharded,
robust-rule, attack, tier and checkpoint branches of the JAX engine are
later slices; ``FLConfig`` rejects their keys until then.

One round:

1. the host draws each client's ``tau`` batches and the Algorithm-3
   participation mask from one ``np.random.RandomState(seed + 1)`` stream,
   draw for draw as the JAX engine does, and stages them on the device
   (:class:`RoundPrefetcher` overlaps round t+1's draws and copy with
   round t). A stochastic wire codec also draws one rounding seed per
   client from its own stream (``codec_rng``), which rides the batch dict
   under ``WIRE_KEY``;
2. the scheduler walks the clients in chunks (``"vmap"``: one chunk of
   all K). Within a chunk the client axis is written out: local SGD is
   ``torch.func.vmap(torch.func.grad(loss))`` over the chunk's clients
   (or, for a loss marked :data:`CLIENT_LOOP`, a loop over them with
   ``torch.autograd.grad``),
   the uplink pipeline compresses the stacks (adding each client's
   error-feedback residual), the LBG store's Algorithm-1 step takes the
   ``(C, ...)`` stacks and calls the *batched* decision kernels
   (``repro_torch.kernels.ops``) directly — one launch per leaf per chunk
   — and the codec encodes what the uplink ships;
3. the aggregator folds every client's update into the round aggregate
   strictly sequentially, ``a + where(w > 0, w * g, 0)`` in client order,
   so vmap and chunked add in the same order (quantized sparse payloads
   go through the dequant-accumulate kernel, one launch per leaf per
   chunk); the LBG and residual bank rows of the chunk are updated in
   place (unsampled clients keep theirs);
4. the server steps the params and ``CommLedger`` counts the uplink.

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
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.comm.accounting import CommLedger
from repro_torch.comm.wire import WIRE_KEY, codec_rng, make_codec
from repro_torch.compression import make_uplink_pipeline
from repro_torch.core import lbgm as lbgm_lib
from repro_torch.core.device import resolve_device  # noqa: F401  (re-export)
from repro_torch.core.tree_math import tree_size
from repro_torch.fed.flconfig import FLConfig  # noqa: F401  (re-export)
from repro_torch.fed.registry import (LBG_STORES, SCHEDULERS,
                                      register_aggregator, register_latency,
                                      register_lbg_store, register_scheduler)
from repro_torch.kernels import ops


#: attribute a model component sets on its loss function (``True``) when
#: ``torch.func`` cannot transform the loss: the engine then runs a chunk's
#: clients one after another under ``torch.autograd`` (the ``"lm"``
#: component's loss checkpoints its blocks and CE chunks, and its kernels
#: are autograd Functions without a vmap rule)
CLIENT_LOOP = "client_loop"


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


def make_lbg_store(cfg: FLConfig):
    key = "null" if not cfg.use_lbgm else cfg.resolved_lbg_variant
    return LBG_STORES.get(key)(cfg)


# ------------------------------------------------------------ aggregators

# the only server rule and latency model ported: the streaming "mean"
# fold (make_aggregator) and synchronous delivery. They are registered so
# FLConfig validates their keys as the JAX package does.
register_aggregator("mean", lambda cfg: None, kw=())
register_latency("none", lambda cfg: None, kw=("alpha", "max_staleness"))


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


class SparseTopKAggregator:
    """Sparse scalar-round aggregation for the top-k store.

    The carry is a per-leaf ``(nb, block)`` fp32 accumulator in the bank's
    block layout. Client k contributes only its payload:
    ``a[row, idx] = a[row, idx] + where(w_k > 0, (w_k * gscale_k) * val,
    0)``, clients strictly in order. It is a gather-modify-scatter, with
    no atomics: top-k indices are unique within a block row. The carry is
    updated in place.
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
        idx = {name: send[name]["idx"].long() for name in acc}
        for k in range(w.shape[0]):
            w_k = w[k]
            on = w_k > 0
            coeff = w_k * gscale[k]
            for name in sorted(acc):
                a, i_k = acc[name], idx[name][k]
                new = a.gather(1, i_k) + torch.where(
                    on, coeff * send[name]["val"][k], 0.0)
                a.scatter_(1, i_k, new)
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
    """``(aggregator, sparse)``: sparse scalar-round payloads whenever the
    store supports them and ``fused_kernels`` is not False, else the dense
    fold; a lossy codec's sparse payloads fold through
    :class:`SparseCodecAggregator`. Only the streaming ``"mean"`` rule is
    ported."""
    if cfg.aggregator != "mean":
        raise ValueError(
            f"aggregator={cfg.aggregator!r} is not ported to repro_torch "
            "yet; use aggregator='mean'")
    if cfg.fused_kernels is not False and hasattr(store, "make_aggregator"):
        if codec.lossy:
            return SparseCodecAggregator(params, store.k_frac), True
        return store.make_aggregator(params), True
    return DenseAggregator(), False


# ------------------------------------------------------------- schedulers

def pick_chunk(num_clients: int, chunk_size: int) -> int:
    """Chunk size of the chunked scheduler: the largest divisor of K that
    fits in chunk_size, unless that is under half of it (e.g. prime K) —
    then chunk_size, with a zero-weight padded tail chunk."""
    c = min(chunk_size, num_clients)
    d = max(x for x in range(1, c + 1) if num_clients % x == 0)
    return d if d >= max(1, c // 2) else c


def _keep_sampled(maskf, new, old):
    """Unsampled clients keep their previous per-client state."""
    return _tmap(lambda n, o: torch.where(
        maskf.reshape((-1,) + (1,) * (n.dim() - 1)) > 0, n, o), new, old)


class _ChunkLoop:
    """Walks the (padded) clients in chunks of ``self.chunk``: each chunk
    runs ``client_fn`` over its stacked clients, folds the updates into the
    round aggregate in client order, and writes its bank rows back in
    place. The banks are allocated padded to the chunk grid (K + pad rows);
    pad rows are never sampled. The error-feedback residual bank (empty
    without error feedback) is sliced and written back like the LBG bank."""

    num_clients: int
    chunk: int
    pad: int

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
        acc = agg.init(params)
        ys = []
        for start in range(0, K + pad, chunk):
            s = slice(start, start + chunk)
            l_c = _tmap(lambda x: x[s], lbg)
            r_c = _tmap(lambda x: x[s], resid)
            b_c = {k: v[s] for k, v in batch.items()}
            gt, nl, nr, *y = client_fn(params, b_c, l_c, r_c)
            acc = agg.accumulate(acc, w[s], gt)
            for bank, new, old in ((lbg, nl, l_c), (resid, nr, r_c)):
                _tmap(lambda dst, src: dst[s].copy_(src), bank,
                      _keep_sampled(maskf[s], new, old))
            ys.append(y)
        y = [torch.cat(col)[:K] for col in zip(*ys)]
        return (agg.finalize(acc), *y)


@register_scheduler("vmap")
class VmapScheduler(_ChunkLoop):
    """All K clients in one chunk; O(K·M) transient working set."""

    def __init__(self, cfg: FLConfig, num_clients: int):
        self.num_clients = num_clients
        self.chunk, self.pad = num_clients, 0


@register_scheduler("chunked")
class ChunkedScheduler(_ChunkLoop):
    """Chunks of ``pick_chunk(K, chunk_size)`` clients; O(chunk·M)
    transient working set."""

    def __init__(self, cfg: FLConfig, num_clients: int):
        self.num_clients = num_clients
        self.chunk = pick_chunk(num_clients, cfg.chunk_size)
        self.pad = (-num_clients) % self.chunk


def make_scheduler(cfg: FLConfig, num_clients: int):
    return SCHEDULERS.get(cfg.scheduler)(cfg, num_clients)


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
        # each leaf's logical axes, for model_sharding="auto" (a later
        # slice: FLConfig refuses it until then)
        self.model_axes = model_axes
        self.cfg = flcfg
        self.params = {k: torch.as_tensor(v).to(self.device)
                       for k, v in params.items()}
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
        self.sched = make_scheduler(flcfg, K)
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
        # the codec's rounding seeds come from their own stream, drawn only
        # when the codec is stochastic: a deterministic codec leaves every
        # other draw where it was
        self.codec = make_codec(flcfg)
        self._codec_rng = codec_rng(flcfg.seed)
        self.agg, self._sparse_agg = make_aggregator(flcfg, self.store,
                                                     self.params, self.codec)
        if self.codec.lossy and not (
                self._sparse_agg or isinstance(self.store, NullLBGStore)):
            raise ValueError(
                f"codec={flcfg.codec!r} is lossy, but the dense LBGM bank "
                "cannot track the server-decoded values (recycle rounds "
                "would replay unquantized LBGs the server never saw). Use "
                "the sparse payload path (lbg_variant='topk' with "
                "fused_kernels not False) or vanilla FL (use_lbgm=False)")
        Kp = K + self._pad
        self._pipeline, self._use_ef = make_uplink_pipeline(
            flcfg.compressor, flcfg.compressor_kw, flcfg.error_feedback)
        self.lbg = self.store.init(
            self.params, Kp, promote=torch.float32 if self._use_ef else None)
        self.residual = {
            k: torch.zeros((Kp,) + tuple(p.shape), dtype=torch.float32,
                           device=self.device)
            for k, p in self.params.items()} if self._use_ef else {}
        self._client_fn = self._build_client_fn()
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self.ledger = CommLedger()
        self.history: List[Dict[str, float]] = []
        self.sin2_history: List[np.ndarray] = []

    # -------------------------------------------------------------- build
    def _make_client_update(self):
        """tau local SGD steps for a chunk of clients, vmapped over the
        chunk's client axis: every client starts from the global params.
        Returns the accumulated stochastic gradient (C, ...) per leaf and
        each client's mean loss (C,). A loss marked ``client_loop`` takes
        :meth:`_make_client_loop` instead."""
        cfg = self.cfg
        loss_fn = self.loss_fn
        if getattr(loss_fn, CLIENT_LOOP, False):
            return self._make_client_loop()

        def loss_aux(p, b):
            loss, _ = loss_fn(p, b)
            return loss, loss.detach()
        grad_fn = torch.func.vmap(torch.func.grad(loss_aux, has_aux=True))

        def client_update(params, batches):
            C = next(iter(batches.values())).shape[0]
            p = {k: v.expand((C,) + v.shape) for k, v in params.items()}
            asg, losses = None, []
            for t in range(cfg.tau):
                g, loss = grad_fn(p, {k: v[:, t] for k, v in
                                      batches.items()})
                p = {k: p[k] - cfg.lr * g[k].to(p[k].dtype) for k in p}
                asg = g if asg is None else {k: asg[k] + g[k] for k in g}
                losses.append(loss)
            return asg, torch.stack(losses).mean(0)

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
        once in place; past two, a low-precision leaf sums in fp32."""
        from repro_torch.train.trainer import grad_and_loss
        cfg = self.cfg
        loss_fn = self.loss_fn

        def client_update(params, batches):
            C = next(iter(batches.values())).shape[0]
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
                for t in range(cfg.tau):
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
                losses[c] = torch.stack(ls).mean()
                del p, ls, acc
            return asg, losses

        return client_update

    def _build_client_fn(self):
        pipeline = self._pipeline
        store = self.store
        sparse = self._sparse_agg
        codec = self.codec
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
            # the codec's per-client seed rides the batch dict; strip it
            # before local SGD
            batches = dict(batches)
            seed = batches.pop(WIRE_KEY, None)
            asg, loss = client_update(params, batches)
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

    def _round(self, batch, mask: np.ndarray):
        cfg = self.cfg
        maskf = torch.as_tensor(mask.astype(np.float32), device=self.device)
        w = self.weights * maskf
        w = w / torch.clamp(w.sum(), min=1e-12)
        agg, losses, uplink, scalar, wire, sin2 = self.sched.run(
            self._client_fn, self.agg, self.params, batch, self.lbg,
            self.residual, w, maskf)
        self.params = {k: p - cfg.lr * agg[k].to(p.dtype)
                       for k, p in self.params.items()}
        metrics = torch.stack([
            (losses * w).sum(),
            (uplink * maskf).sum(),
            (scalar.float() * maskf).sum() / torch.clamp(maskf.sum(),
                                                         min=1.0),
            (wire * maskf).sum()]).tolist()
        self.sin2_history.append(sin2.cpu().numpy())
        return dict(zip(("loss", "uplink_floats", "frac_scalar",
                         "wire_bytes"), metrics))

    # -------------------------------------------------------------- data
    def _sample_batches(self, rng: np.random.RandomState):
        """Per-round (K + pad, tau, b, ...) host batches. The K per-client
        index draws run in client order — the JAX engine's stream, draw for
        draw. A stochastic codec adds one rounding seed per client under
        ``WIRE_KEY``, from the codec stream (never ``rng``), as the JAX
        engine draws them; pad rows get seed 0."""
        cfg = self.cfg
        idx = np.empty((cfg.num_clients, cfg.tau, cfg.batch_size), np.int64)
        for k, n in enumerate(self._data_sizes):
            idx[k] = rng.randint(0, n, size=(cfg.tau, cfg.batch_size))
        idx += self._data_offsets[:, None, None]
        stacked = {k: v[idx] for k, v in self._data_cat.items()}
        if self.codec.stochastic:
            stacked[WIRE_KEY] = self._codec_rng.randint(
                0, 2 ** 31 - 1, size=cfg.num_clients).astype(np.int64)
        return self.sched.prepare_batch(stacked)

    def _sample_mask(self, rng: np.random.RandomState) -> np.ndarray:
        """Algorithm-3 participation mask: exactly ``num_clients`` uniforms
        when ``sample_frac < 1`` (none otherwise); an empty cohort revives
        the client closest to its threshold without drawing more."""
        cfg = self.cfg
        if cfg.sample_frac >= 1.0:
            return np.ones(cfg.num_clients)
        u = rng.rand(cfg.num_clients)
        mask = (u < cfg.sample_frac).astype(np.float64)
        if mask.sum() == 0:
            mask[int(np.argmin(u))] = 1.0
        return mask

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
            batch, mask, ev = rng.next()
            if ev is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(ev)
                for v in batch.values():
                    v.record_stream(cur)
        else:
            batch, _ = self._stage(self._sample_batches(rng))
            mask = self._sample_mask(rng)
        with torch.no_grad():
            m = self._round(batch, mask)
        vanilla = float(mask.sum()) * tree_size(self.params)
        self.ledger.record(m["uplink_floats"], vanilla,
                           wire=m["wire_bytes"], vanilla_wire=4.0 * vanilla)
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

    def run(self, rounds: int, eval_fn: Optional[Callable] = None,
            eval_every: int = 10, verbose: bool = False,
            prefetch: bool = True):
        rng = np.random.RandomState(self.cfg.seed + 1)
        src = self.prefetcher(rng) if prefetch else rng
        try:
            for r in range(rounds):
                m = self.run_round(src)
                if eval_fn is not None and (r + 1) % eval_every == 0:
                    m.update(eval_fn(self.params))
                if verbose and (r + 1) % eval_every == 0:
                    print(f"round {r+1:4d} " +
                          " ".join(f"{k}={v:.4g}" for k, v in m.items()))
        finally:
            if prefetch:
                src.close()
        return self.history


# ------------------------------------------------------------- prefetcher

class RoundPrefetcher:
    """Host->device double buffering for the round loop.

    A daemon thread draws each round's ``(batch, mask)`` from the engine's
    rng in round order (batches first, then the mask — the synchronous
    order) and, on a CUDA device, copies the batch to the card on a side
    stream from pinned memory, so round t+1's host prep and copy overlap
    round t. While alive it is the rng's only consumer, so the history is
    identical to the synchronous path; ``close()`` leaves the rng advanced
    by the rounds still queued.
    """

    _SENTINEL = object()

    def __init__(self, engine: FLEngine, rng: np.random.RandomState,
                 depth: int = 2):
        self._engine = engine
        self._rng = rng
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
                batch, ev = eng._stage(host, eng._copy_stream)
                item = (batch, mask, ev)
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
        """The next round's (batch, mask, copy event); raises if the
        thread died or after ``close()`` (whatever the queue still holds:
        a producer blocked in ``put()`` may land a round after the
        drain)."""
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

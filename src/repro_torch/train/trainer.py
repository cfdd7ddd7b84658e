"""LBGM trainer for the decoder LMs: the counterpart of ``repro.train.trainer``.

Clients are written out, one at a time, where the JAX package maps them
onto the data axes of a mesh (``vmap`` or ``lax.scan`` over a leading
client axis K):

* ``replicated`` mode — each client's accumulated stochastic gradient
  (tau local steps) against its dense LBG (paper Algorithm 1, the
  ``"full"`` variant; ``"topk"`` takes the sparse store), the reconstructed
  gradients mean-aggregated;
* ``fsdp`` mode — tau = 1, each reconstructed gradient divided by K as it
  is folded in, as the JAX ``lax.scan`` does.

At most one client's gradient is live at a time: each client's g_tilde is
folded into an fp32 accumulator in client order, and its LBG is written
into the bank in place (the step mutates ``state["lbg"]``; params and
optimizer state come back as new tensors). On CUDA tensors the decision
takes the fused kernels (the projection over a table of every leaf, the
sparse decision per leaf), on CPU tensors their plain versions. The mesh
glue (``train_state_shardings``, ``batch_shardings``) gives the JAX
package's specs as plain tuples (``train.sharding``), on a planning mesh
(``train.sharding.abstract_mesh``) or a ``DeviceMesh``'s axes; no step
here runs on a mesh yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import lbgm as lbgm_lib
from repro_torch.core.device import resolve_device
from repro_torch.models.common import params_from_numpy
from repro_torch.models.transformer import (init_lm, lm_loss, lm_loss_tp,
                                           prefill_logits,
                                           tensor_parallel_refusal)
from repro_torch.optim.sgd import sgd_init, sgd_update
from repro_torch.train import sharding as shd


# ------------------------------------------------------------- state

def effective_clients(cfg: ArchConfig, dp_total: int,
                      global_batch: int) -> int:
    """Clients per step: ``dp_total`` is the data-parallel size (1 on one
    card), where the JAX function reads it off a mesh."""
    if cfg.dp_mode == "replicated":
        k = min(dp_total, global_batch)
    else:
        k = max(1, min(cfg.lbgm.num_clients, global_batch // dp_total))
    while global_batch % k:
        k -= 1
    return k


def make_loss_fn(cfg: ArchConfig):
    def loss_fn(params, batch):
        return lm_loss(params, cfg, batch["tokens"], batch["labels"],
                       batch.get("extra"))
    return loss_fn


def make_tp_loss_fn(cfg: ArchConfig, tp):
    """:func:`make_loss_fn`'s loss on one model rank's shards
    (``models.transformer.lm_loss_tp``, with the batch's stub patches
    ``"extra"`` where it has them; ``tp``: a
    ``models.tensor_parallel.TPContext``). The dense decoder family, the
    M-RoPE VLM, the recurrent families (rwkv6, RG-LRU + local attention)
    and the MoE family have a tensor-parallel form. An encoder-decoder
    raises, naming the arch: its forward needs encoder frames, which the
    ``"lm"`` component's batches (tokens and labels) do not carry, as in
    the JAX package, whose FL engine cannot run it under any
    ``model_sharding`` either. Any other arch without a form raises,
    naming it."""
    if cfg.encdec:
        raise ValueError(
            f"model_sharding='auto': arch {cfg.name!r} is an "
            "encoder-decoder: enc-dec needs encoder frames, and the 'lm' "
            "component's batches carry none (tokens and labels only), as "
            "in the JAX package, whose FL engine cannot run it under any "
            "model_sharding; use a decoder-only arch")
    why = tensor_parallel_refusal(cfg)
    if why is not None:
        raise ValueError(
            f"model_sharding='auto': arch {cfg.name!r} has {why}, which "
            "have no tensor-parallel form (only attn, swa, rwkv6 and rglru "
            "blocks with a dense SwiGLU or MoE FFN). Use "
            "model_sharding='replicate'")

    def loss_fn(params, batch):
        return lm_loss_tp(params, cfg, batch["tokens"], batch["labels"], tp,
                          batch.get("extra"))
    return loss_fn


def init_train_state(gen: Optional[torch.Generator], cfg: ArchConfig,
                     num_clients: int, use_lbgm: bool = True,
                     device="cuda", params=None):
    """Returns (state dict, param logical axes). The params are drawn from
    ``gen`` (``models.transformer.init_lm``), or are ``params``: a flat
    dict of tensors (moved to ``device``) or of numpy arrays, such as the
    JAX package's, carried across bit for bit
    (``models.common.params_from_numpy``); the axes are then None. The
    dense LBG bank is fp32 when tau > 1 (the accumulated gradient is fp32;
    the JAX bank turns fp32 at its first write). ``device="meta"`` gives
    the shapes and dtypes only, with no draw and no storage."""
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    if params is None:
        params, axes = init_lm(gen, cfg, device=dev)
    elif all(isinstance(v, torch.Tensor) for v in params.values()):
        params, axes = {k: v.to(dev) for k, v in params.items()}, None
    else:
        params, axes = params_from_numpy(params, dev), None
    state: Dict[str, Any] = {"params": params, "opt": sgd_init(params),
                             "step": 0}
    if use_lbgm and cfg.lbgm.enabled:
        if cfg.lbgm.variant == "full":
            fp32 = cfg.dp_mode == "replicated" and cfg.lbgm.local_steps > 1
            state["lbg"] = {
                k: torch.zeros((num_clients,) + p.shape,
                               dtype=torch.float32 if fp32 else p.dtype,
                               device=dev)
                for k, p in params.items()}
        else:
            one = lbgm_lib.init_topk_lbg(params, cfg.lbgm.k_frac)
            state["lbg"] = {
                k: {f: torch.zeros((num_clients,) + t.shape, dtype=t.dtype,
                                   device=dev) for f, t in leaf.items()}
                for k, leaf in one.items()}
    return state, axes


# ------------------------------------------------------------- steps

def grad_and_loss(loss_fn, params, batch):
    """(grads in each param's dtype, loss): one backward through the
    model; a param the loss does not read gets a zero gradient, as
    ``jax.grad`` gives it."""
    names = sorted(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    loss, _ = loss_fn(dict(zip(names, leaves)), batch)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return ({k: torch.zeros_like(p) if g is None else g
             for k, p, g in zip(names, leaves, gs)}, loss.detach())


def _client_asg(loss_fn, params, client_batch, tau: int, lr):
    """Accumulated stochastic gradient over tau local SGD steps.

    tau == 1: plain grad (paper P4 distributed-training mode), in the
    params' dtype. tau > 1: local SGD on per-step slices (batch leaves
    (tau, b, ...)); the gradients summed in fp32.
    """
    if tau == 1:
        return grad_and_loss(loss_fn, params, client_batch)
    p, asg, losses = params, None, []
    for t in range(tau):
        g, loss = grad_and_loss(loss_fn, p, {k: v[t] for k, v in
                                             client_batch.items()})
        p = {k: (x.float() - lr * g[k].float()).to(x.dtype)
             for k, x in p.items()}
        asg = {k: x.float() for k, x in g.items()} if asg is None else {
            k: asg[k] + g[k].float() for k in asg}
        losses.append(loss)
    return asg, torch.stack(losses).mean()


def make_train_step(cfg: ArchConfig, num_clients: int, lr: float,
                    use_lbgm: bool = True, delta: Optional[float] = None):
    """``step(state, batch) -> (state, metrics)``; batch leaves are
    (K, b, T), or (K, tau, b, T) with tau > 1. The metrics are ``loss`` and,
    with LBGM, ``frac_scalar``, ``mean_sin2``, ``uplink_floats`` and
    ``vanilla_uplink_floats``, as the JAX ``_finish`` gives them."""
    loss_fn = make_loss_fn(cfg)
    replicated = cfg.dp_mode == "replicated"
    tau = cfg.lbgm.local_steps if replicated else 1
    delta = cfg.lbgm.delta_threshold if delta is None else delta
    use_lbgm = use_lbgm and cfg.lbgm.enabled
    K = num_clients

    def client_lbgm(g, lbg):
        # a client of one: (1, ...) leaves, the fused kernels on the card
        if cfg.lbgm.variant == "topk":
            return lbgm_lib.lbgm_topk_client_step(g, lbg, delta,
                                                  cfg.lbgm.k_frac, fused=True)
        return lbgm_lib.lbgm_client_step(g, lbg, delta, fused=True)

    def client_lbg(state, k):
        return {n: ({f: t[k:k + 1] for f, t in leaf.items()}
                    if isinstance(leaf, dict) else leaf[k:k + 1])
                for n, leaf in state["lbg"].items()}

    def store_lbg(state, k, new_lbg):
        for n, leaf in state["lbg"].items():
            if isinstance(leaf, dict):
                for f, t in leaf.items():
                    t[k].copy_(new_lbg[n][f][0])
            else:
                leaf[k].copy_(new_lbg[n][0])

    def step(state, batch):
        params = state["params"]
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        losses, stats = [], []
        for k in range(K):
            g, loss = _client_asg(loss_fn, params,
                                  {n: v[k] for n, v in batch.items()}, tau,
                                  lr)
            losses.append(loss)
            g = {n: x[None] for n, x in g.items()}
            if use_lbgm:
                g, new_lbg, st = client_lbgm(g, client_lbg(state, k))
                store_lbg(state, k, new_lbg)
                stats.append(st)
                del new_lbg
            for n, x in g.items():
                if replicated:
                    acc[n].add_(x[0])
                else:
                    acc[n].add_(x[0].float() / K)
            del g
        if replicated:
            for a in acc.values():
                a.div_(K)
        new_params, opt = sgd_update(params, acc, state["opt"], lr)
        del acc
        new_state = dict(state)
        new_state.update(params=new_params, opt=opt, step=state["step"] + 1)
        metrics = {"loss": torch.stack(losses).mean()}
        if use_lbgm:
            cat = lbgm_lib.LBGMStats(*(torch.cat(f) for f in zip(*stats)))
            n_params = sum(int(p.numel()) for p in params.values())
            metrics.update(
                frac_scalar=cat.sent_scalar.float().mean(),
                mean_sin2=cat.sin2.mean(),
                uplink_floats=cat.uplink_floats.sum(),
                vanilla_uplink_floats=torch.tensor(float(K * n_params),
                                                   dtype=torch.float32))
        return new_state, metrics

    return step


def make_prefill_step(cfg: ArchConfig):
    """``step(params, batch) -> (B, V)`` last-position logits of
    ``batch["tokens"]`` (B, T), with ``batch["extra"]`` (the stub frames
    or patches of ``models.frontends``) where the arch takes them."""
    def step(params, batch):
        return prefill_logits(params, cfg, batch["tokens"],
                              batch.get("extra"))
    return step


# ------------------------------------------------------------- sharding glue

def train_state_shardings(state, axes, cfg: ArchConfig, mesh,
                          embed_shard: str = "vocab"):
    """The train state's specs, a tree of ``state``'s structure (the JAX
    function's, each ``NamedSharding``'s spec as a tuple): the params by
    ``train.sharding.params_shardings`` in ``cfg.dp_mode``, the momentum
    as the params, ``step`` replicated; the dense bank in replicated mode
    ``(dp, *param spec)``; any other bank leaf ``(None, "model", None)``
    where it is 3-D and the model extent (> 1) divides its dim 1 (the
    sparse bank's blocks), else replicated."""
    mode = cfg.dp_mode
    pspec = shd.params_shardings(axes, state["params"], mode, mesh,
                                 embed_shard)
    out: Dict[str, Any] = {
        "params": pspec,
        "opt": {} if not state["opt"] else
        {"m": {k: pspec[k] for k in state["params"]}},
        "step": (),
    }
    if "lbg" in state:
        if cfg.lbgm.variant == "full" and mode == "replicated":
            dp = shd.dp_axes(mesh)
            out["lbg"] = {k: shd.stacked_pspec(pspec[k], dp)
                          for k in state["params"]}
        else:
            model = mesh.shape.get("model", 1)

            def lbg_spec(leaf):
                if isinstance(leaf, dict):
                    return {f: lbg_spec(t) for f, t in leaf.items()}
                if leaf.ndim == 3 and model > 1 \
                        and leaf.shape[1] % model == 0:
                    return (None, "model", None)
                return (None,) * leaf.ndim
            out["lbg"] = {k: lbg_spec(v) for k, v in state["lbg"].items()}
    return out


def batch_shardings(batch_spec, mesh):
    """The specs of a batch (a tensor or a dict of them, such as
    ``launch.specs.train_batch_specs``): the leading axis (clients or
    batch) over ("pod", "data") where their product divides it, the rest
    unsharded."""
    if isinstance(batch_spec, dict):
        return {k: batch_shardings(v, mesh) for k, v in batch_spec.items()}
    dp = shd.dp_axes(mesh)
    total = shd.axes_size(mesh, dp)
    shape = tuple(batch_spec.shape)
    lead = shd.axis_entry(dp) if shape and shape[0] % total == 0 else None
    return (lead, *([None] * (len(shape) - 1)))

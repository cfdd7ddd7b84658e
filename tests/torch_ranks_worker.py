"""One rank of a ``torch.distributed`` world of the port's FL engine on
the CPU (gloo), for ``tests/test_torch_sharded_ranks.py``.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/torch_ranks_worker.py JOBS.json OUT_DIR

``JOBS.json`` is a list of jobs run in order, in one process, so the
imports are paid once. ``PIECE_BYTES`` in the environment sets
``launch.mesh.PIECE_BYTES``, the largest piece of a gather or reshard. No process group is started here: the first
engine's mesh joins the launcher's world (``launch.mesh.ensure_world``,
``env://``), as under ``torchrun``.

* An engine job, ``{"tag", "spec" (an ExperimentSpec dict), "params" (an
  .npz of initial params, or null), "rounds", "resume", "copy_ckpt" (a
  path rank 0 copies the job's checkpoint to)}``, builds the engine with
  ``build_experiment(..., device="cpu")``, runs ``FLEngine.run`` and
  writes ``OUT_DIR/<tag>.r<rank>.pt``: the history, the final params, the
  per-leaf bytes of this rank's banks and of the global bank, the chunk
  layout, the mesh ranks, the process group's backend and the sin² rows.
  Under ``model_sharding="auto"`` it also writes each leaf's spec and this
  rank's resting param bytes.
* A tensor-parallel job, ``{"tag", "tp": {"arch", "kw" (``reduced()``
  overrides), "moe" (optional ``MoEConfig`` overrides), "mesh", "seed",
  "T" (optional, 16), "patches" (optional: the VLM's stub patches in the
  batch)}}``, draws the arch's params from a CPU generator of
  ``seed``, cuts this rank's shards by the engine's spec rule
  (``fed.engine.auto_specs``) and writes the tensor-parallel loss
  (``train.trainer.make_tp_loss_fn``) and gradients of its shards on
  :func:`tp_batch`, and the gradients assembled over the model group.
* An MoE job, ``{"tag", "moe": {"arch", "m", "seed", "remat", "moe"
  (optional ``MoEConfig`` overrides), "B", "T"}}``, runs
  ``models.moe.apply_moe_tp`` on a (1, m) mesh over :func:`moe_inputs`
  (the rank's shards of one MoE layer by JAX's spec rule, the same x on
  every rank) and writes its output, aux loss, the gradients of x, of its
  shards and assembled (of ``(out * dy).sum() + AUX_WEIGHT * aux``), and
  every routing it computed.
* A CLI job, ``{"tag", "cli": [argv]}``, runs ``repro_torch.fed.run.main``
  with ``{rank}`` in the arguments replaced by this rank, and writes its
  return code and what it printed. The CLI ends the launcher's world, so
  a CLI job comes last.
"""
import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from repro_torch.fed import experiment as texp  # noqa: E402
from repro_torch.fed import run as trun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402


def _bytes(tree):
    out = {}
    for name, leaf in tree.items():
        leaves = leaf.values() if isinstance(leaf, dict) else [leaf]
        out[name] = int(sum(x.numel() * x.element_size() for x in leaves))
    return out


def engine_job(job, rank):
    import torch.distributed as dist
    spec = texp.ExperimentSpec.from_dict(job["spec"])
    params = None
    if job.get("params"):
        with np.load(job["params"]) as z:
            params = {k: z[k] for k in z.files}
    eng, _ = texp.build_experiment(spec, params=params, device="cpu")
    hist = eng.run(job["rounds"], resume=job.get("resume", False))
    sched = eng.sched
    rec = {"history": hist,
           "params": {k: v.numpy() for k, v in eng.params.items()},
           "bank_bytes": _bytes(eng.lbg),
           "global_bytes": _bytes(sched.global_banks(eng.lbg)),
           "chunk": eng._chunk, "pad": eng._pad,
           "msharded": getattr(sched, "_msharded", None),
           "model_rank": getattr(sched, "model_rank", None),
           "backend": dist.get_backend(),
           "sin2": [np.asarray(s) for s in eng.sin2_history]}
    if eng._tp is not None:
        rec["specs"] = eng._tp.specs
        rec["rest_bytes"] = sum(v.numel() * v.element_size()
                                for v in eng._params.values())
    if job.get("copy_ckpt") and rank == 0:
        shutil.copy(spec.fl.ckpt_path, job["copy_ckpt"])
    return rec


def tp_batch(cfg, seed, client_rank, B=2, T=16, patches=False):
    """A client rank's (B, T) tokens and next-token labels; with
    ``patches``, the VLM's stub patches (``models.frontends``) from a CPU
    generator of the same seed as ``"extra"``."""
    from repro_torch.models.frontends import make_stub_embeds
    rng = np.random.RandomState(seed + 101 * client_rank)
    toks = rng.randint(0, cfg.vocab_size, size=(B, T + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])}
    if patches:
        batch["extra"] = make_stub_embeds(
            torch.Generator().manual_seed(seed + 101 * client_rank), cfg, B)
    return batch


def tp_cfg(tp):
    """The reduced arch config of a tensor-parallel or MoE job: ``kw``'s
    ``reduced()`` overrides, then ``moe``'s ``MoEConfig`` overrides."""
    import dataclasses
    from repro_torch.configs import get_config
    kw = dict(tp.get("kw", {}))
    for key in ("block_pattern", "mrope_sections"):
        if key in kw:
            kw[key] = tuple(kw[key])
    cfg = get_config(tp["arch"]).reduced(**kw)
    if tp.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **tp["moe"]))
    return cfg


#: the aux loss's weight in an MoE job's scalar, so its gradient shows
AUX_WEIGHT = 3.0


def moe_inputs(case):
    """An MoE job's inputs: (cfg, the ``moe/*`` params drawn from a CPU
    generator of ``seed`` without their prefix, their logical axes, x and
    the output's upstream gradient dy, both (B, T, d) fp32 from a numpy
    stream of ``seed``)."""
    from repro_torch.models import moe
    from repro_torch.models.common import ParamStore, subtree
    cfg = tp_cfg(case)
    store = ParamStore(torch.Generator().manual_seed(case["seed"]))
    moe.init_moe(store, "moe", cfg)
    rng = np.random.RandomState(case["seed"])
    B, T, d = case.get("B", 2), case.get("T", 16), cfg.d_model
    x = torch.as_tensor(rng.randn(B, T, d).astype(np.float32))
    dy = torch.as_tensor(rng.randn(B, T, d).astype(np.float32))
    return (cfg, subtree(store.params, "moe"), subtree(store.axes, "moe"),
            x, dy)


def moe_job(job, rank):
    from repro_torch.fed.engine import auto_specs
    from repro_torch.models import moe
    from repro_torch.models.tensor_parallel import TPContext
    from repro_torch.train.sharding import mesh_axes
    case = job["moe"]
    cfg, params, axes, x, dy = moe_inputs(case)
    mesh = tmesh.make_fl_mesh([1, case["m"]], device="cpu")
    specs = auto_specs(axes, params, mesh_axes(mesh))
    ctx = TPContext(specs, {k: v.shape for k, v in params.items()},
                    mesh.get_group("model"), mesh.get_local_rank("model"),
                    case["m"])
    shards = {k: ctx.shard(k, v).requires_grad_()
              for k, v in params.items()}
    x = x.requires_grad_()
    routings, real = [], moe.moe_routing

    def keep_routing(p, h, c):
        r = real(p, h, c)
        routings.append({f: v.detach().numpy()
                         for f, v in r._asdict().items()})
        return r

    moe.moe_routing = keep_routing
    try:
        out, aux = moe.apply_moe_tp(
            shards, x, cfg, ctx,
            {k: (specs[k], tuple(v.shape)) for k, v in params.items()},
            case.get("remat", False))
        ((out * dy).sum() + AUX_WEIGHT * aux).backward()
    finally:
        moe.moe_routing = real
    grads = {k: v.grad for k, v in shards.items()}
    return {"specs": specs, "model_rank": ctx.rank,
            "out": out.detach().numpy(), "aux": float(aux),
            "x_grad": x.grad.numpy(), "routings": routings,
            "grads": {k: v.numpy() for k, v in grads.items()},
            "assembled": {k: v.numpy()
                          for k, v in ctx.assemble(grads).items()}}


def tp_job(job, rank):
    from repro_torch.fed.engine import auto_specs
    from repro_torch.models.tensor_parallel import TPContext
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.sharding import mesh_axes
    from repro_torch.train.trainer import grad_and_loss, make_tp_loss_fn
    tp = job["tp"]
    cfg = tp_cfg(tp)
    mesh = tmesh.make_fl_mesh(tp["mesh"], device="cpu")
    params, axes = init_lm(torch.Generator().manual_seed(tp["seed"]), cfg,
                           device="cpu")
    specs = auto_specs(axes, params, mesh_axes(mesh))
    ctx = TPContext(specs, {k: v.shape for k, v in params.items()},
                    mesh.get_group("model"), mesh.get_local_rank("model"),
                    tp["mesh"][1])
    client_rank = mesh.get_local_rank("clients")
    grads, loss = grad_and_loss(make_tp_loss_fn(cfg, ctx),
                                ctx.shard_tree(params),
                                tp_batch(cfg, tp["seed"], client_rank,
                                         T=tp.get("T", 16),
                                         patches=tp.get("patches", False)))
    return {"loss": float(loss), "specs": specs,
            "model_rank": ctx.rank, "client_rank": client_rank,
            "grads": {k: v.numpy() for k, v in grads.items()},
            "assembled": {k: v.numpy()
                          for k, v in ctx.assemble(grads).items()}}


def cli_job(job, rank):
    argv = [a.replace("{rank}", str(rank)) for a in job["cli"]]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = trun.main(argv)
    return {"rc": rc, "stdout": out.getvalue()}


def main(jobs_path, out_dir):
    rank = int(os.environ["RANK"])
    if os.environ.get("PIECE_BYTES"):
        tmesh.PIECE_BYTES = int(os.environ["PIECE_BYTES"])
    with open(jobs_path) as f:
        jobs = json.load(f)
    try:
        for job in jobs:
            run = (cli_job if "cli" in job else tp_job if "tp" in job
                   else moe_job if "moe" in job else engine_job)
            rec = run(job, rank)
            torch.save(rec, f"{out_dir}/{job['tag']}.r{rank}.pt")
    finally:
        tmesh.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

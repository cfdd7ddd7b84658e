"""The ``"sharded"`` scheduler on gloo CPU ranks against the JAX package.

Each world is ``c·m`` spawned processes (``tests/torch_ranks_worker.py``,
given the environment ``torchrun`` gives its ranks, so the engine's mesh
joins the world through ``env://``), which runs a list of specs so the
imports are paid once; the 4-rank world's gathers and reshards go in
pieces of 64 KiB (``launch.mesh.PIECE_BYTES``). The worlds of 2, 4 and 8 ranks run at once, beside
the JAX package's reference runs in the test's own process. Every
rank must hold the same history and params, bit for bit. Against the JAX
package's in-process ``"chunked"`` run of the same spec from the same
params: ``uplink_floats``, ``frac_scalar`` (and the other EXACT fields)
equal, loss within rtol 1e-5, params within rtol 1e-4 / atol 1e-6, no
client's sin² within 1e-5 of delta. Behind the int8 wire at most 1e-3 of
a leaf's elements may sit off by a rounding tie, each within 1e-3
(``test_torch_fl_lm.py``'s ``TIE_FRACTION`` rule).

The FCN is widened to d_model 704 so fc1/w spans 9 live blocks (the last
one partly live) of its 16 block rows: both model ranks of m = 2 hold
live rows, and at m = 4 the last rank holds pad rows only. Cases:

* ``"topk-sharded"`` at ``(2, 1)``, ``(1, 2)`` and ``(2, 2)``: K = 10 in
  chunks of 6 (two pad clients on two client ranks), ``sample_frac``
  0.5; per-rank bank bytes of fc1/w are 1/(c·m) of the bank;
* the ``"dense"`` store at ``(2, 1)`` (the projection);
* int8 at ``(2, 2)``, round to nearest as in ``test_torch_fl_lm.py`` (the
  dequant fold on model-sharded rows; the stochastic draw of a rank's
  rows is held in ``test_torch_mesh.py``), and with its default
  stochastic rounding, held at the floor that a one-ulp nudge of the
  initial params moves the reference's own history
  (``tests/int8_nudge_floor.py``: a value near a tie of the value-order
  top-k may take another payload position, and so another uniform);
* ``trimmed_mean`` at ``(2, 2)`` (collect mode);
* checkpoint and resume at ``(2, 2)``: equal bit for bit to the
  uninterrupted run, and the round-1 file's banks equal to the ``(1, 1)``
  run's file;
* ``examples/specs/yi34b_mesh2x4.json`` at its ``[2, 4]`` mesh for 2
  rounds, against the JAX package's chunked ``"topk"`` run of the spec
  with the mesh removed;
* the CLI, ``repro_torch.fed.run.main``, on each rank of a world of two
  at ``(2, 1)``: rank 0 alone prints and writes ``--out``;
* ``model_sharding="auto"``: the tensor-parallel loss and gradients of
  reduced yi-34b (at m = 4 a rank rests half a kv head) and qwen3-1.7b
  (qk-norm, blocks checkpointed) on every rank of 2- and 4-rank worlds,
  with per-layer leaves, windowed blocks and a tied head at (2, 2) and a
  replicated FFN, against the plain loss and gradients in this process;
  and ``examples/specs/yi34b_tp2x4.json`` as shipped on the 8 ranks,
  against JAX's chunked run of the spec and the port's own
  ``"replicate"`` run, with each rank's resting params at most
  1/4 + 0.02 of the param bytes;
* ``model_sharding="auto"`` for the recurrent families: the
  tensor-parallel loss and gradients of reduced rwkv6-3b (the scan at a
  rank's local heads; at d_model 96 over 3 heads a rank's columns split a
  head) and of reduced recurrentgemma-2b at 3 layers (rglru, rglru, swa;
  T 48 past its window of 32; at m = 4, with 2 query heads, a rank rests
  half a query head and a quarter of the kv head) on 2- and 4-rank
  worlds (at d_model 126 and m = 4 the RG-LRU mixers and the embedding
  are replicated: the plain mixer on every rank); and each arch's
  ``"lm"`` engine run at (1, 2) against JAX's chunked run and the port's
  ``"replicate"`` run, as yi34b's;
* ``model_sharding="auto"`` for the MoE family: ``models.moe.
  apply_moe_tp`` on 2 and 4 ranks against ``apply_moe`` (routes, drops
  and slots exact on every rank, capacity drops in some cases, the
  k-th/(k+1)-th prob gap above 1e-5; output, aux and gradients at fp32
  tolerances, so a replicated gradient summed m times shows), the
  tensor-parallel loss and gradients of reduced mixtral-8x22b and llama4
  (experts sharded on E; at E = 2 and m = 4 on d_ff, the router
  replicated), and each arch's ``"lm"`` engine run at (1, 2) against
  JAX's chunked run and the port's ``"replicate"`` run;
* ``model_sharding="auto"`` for the M-RoPE VLM: the tensor-parallel loss
  and gradients of reduced qwen2-vl-2b with its stub patches over the
  gathered embedding on 2- and 4-rank worlds (at m = 4 a rank rests half
  a kv head), and a case whose 3 heads of 34 leave ``wa_o`` replicated,
  so every rank runs the plain mixer with the M-RoPE positions; and its
  ``"lm"`` engine run at (1, 2) against JAX's chunked run and the port's
  ``"replicate"`` run.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

from int8_nudge_floor import INT8_D704_TOL, assert_at_int8_floor  # noqa
from repro.fed import experiment as jexp  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fed import experiment as texp  # noqa: E402
from repro_torch.models.transformer import init_lm  # noqa: E402
from repro_torch.train.trainer import grad_and_loss, make_loss_fn  # noqa
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_ranks_worker import (AUX_WEIGHT, moe_inputs, tp_batch,  # noqa
                                tp_cfg)

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_ranks_worker.py"
EXACT = ("uplink_floats", "frac_scalar", "wire_bytes", "savings",
         "total_uplink", "vanilla_uplink", "total_wire_bytes",
         "wire_savings")
TIE_FRACTION = 1e-3
TIE_ATOL = 1e-3
TOPK = {"lbg_variant": "topk", "lbg_kw": {"k_frac": 0.1}}


def fcn_spec(K=10, rounds=2, **fl):
    base = dict(TOPK, num_clients=K, tau=2, lr=0.05, batch_size=16, seed=0,
                delta_threshold=0.85, chunk_size=6, sample_frac=0.5)
    base.update(fl)
    return {"name": "ranks", "model": {"name": "fcn",
                                       "kw": {"d_model": 704}},
            "data": {"name": "mixture",
                     "kw": {"n": 600, "n_eval": 50, "seed": 0}},
            "partition": {"name": "iid", "kw": {"seed": 0}},
            "fl": base, "rounds": rounds,
            "eval": {"every": 0, "final": False, "verbose": False}}


def sharded(d, mesh, **fl):
    """The spec on the sharded scheduler and mesh (top-k -> topk-sharded)."""
    d = json.loads(json.dumps(d))
    d["fl"].update(scheduler="sharded", mesh=mesh, **fl)
    if d["fl"].get("lbg_variant") == "topk":
        d["fl"]["lbg_variant"] = "topk-sharded"
    return d


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(world, jobs, out, piece_bytes=None):
    """Launch ``jobs`` on a gloo world of ``world`` CPU ranks, as
    ``torchrun`` would (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``); returns the processes.
    ``piece_bytes``: the ranks' ``launch.mesh.PIECE_BYTES``, so that the
    small models' gathers and reshards go in several pieces."""
    path = os.path.join(out, f"jobs{world}.json")
    with open(path, "w") as f:
        json.dump(jobs, f)
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT / "src"))
        if piece_bytes:
            env["PIECE_BYTES"] = str(piece_bytes)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), path, out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish(world, jobs, procs, out):
    """Wait for a world of :func:`start`; ``{tag: [record of rank 0, 1,
    ...]}``, or the ranks' output when one failed."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        return "\n".join(logs)[-4000:]
    return {job["tag"]: [torch.load(f"{out}/{job['tag']}.r{r}.pt",
                                    weights_only=False)
                         for r in range(world)] for job in jobs}


def jax_run(d):
    """The JAX package's in-process run of ``d``: (history, params, the
    initial params as numpy)."""
    jeng, _ = jexp.build_experiment(jexp.ExperimentSpec.from_dict(d))
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    hist = jeng.run(d["rounds"])
    return hist, {k: np.asarray(v) for k, v in jeng.params.items()}, p0


def jax_params(d):
    """The JAX package's initial params of ``d``, as numpy."""
    jeng, _ = jexp.build_experiment(jexp.ExperimentSpec.from_dict(d))
    return {k: np.asarray(v) for k, v in jeng.params.items()}


def assert_ranks_agree(recs):
    for rec in recs[1:]:
        assert rec["history"] == recs[0]["history"]
        for k, v in recs[0]["params"].items():
            assert np.array_equal(rec["params"][k], v), k


def assert_matches_jax(case, recs, jh, jp, delta, ties=False,
                       tol=dict(rtol=1e-4, atol=1e-6), recycles=True,
                       floor=False):
    """``floor``: params and loss at the stochastic int8 floor
    (``int8_nudge_floor.INT8_D704_TOL``) instead of ``tol``."""
    assert_ranks_agree(recs)
    th = recs[0]["history"]
    assert len(th) == len(jh)
    for r, (a, b) in enumerate(zip(jh, th)):
        for k in EXACT:
            assert a[k] == b[k], (case, r, k, a[k], b[k])
        np.testing.assert_allclose(
            b["loss"], a["loss"],
            rtol=INT8_D704_TOL["loss_rtol"] if floor else 1e-5,
            err_msg=f"{case} round {r}")
    margin = min(float(np.min(np.abs(s - delta))) for s in recs[0]["sin2"])
    assert margin > 1e-5, (case, margin)
    if recycles:
        assert max(h["frac_scalar"] for h in th) > 0, f"{case}: no recycle"
    for k, j in jp.items():
        t = recs[0]["params"][k]
        if floor:
            assert_at_int8_floor(f"{case} {k}", t, j)
            continue
        if ties:
            off = np.abs(t - j) > tol["atol"] + tol["rtol"] * np.abs(j)
            assert off.mean() <= TIE_FRACTION, (case, k, int(off.sum()))
            np.testing.assert_allclose(t, j, rtol=0, atol=TIE_ATOL,
                                       err_msg=k)
            t = np.where(off, j, t)
        np.testing.assert_allclose(t, j, err_msg=f"{case} {k}", **tol)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    yield str(out)
    shutil.rmtree(out, ignore_errors=True)


FCN_CASES = {"topk": {},
             "dense": dict(lbg_variant="dense", delta_threshold=0.75),
             "int8": dict(codec="int8", codec_kw={"stochastic": False}),
             "int8-stochastic": dict(codec="int8"),
             "trimmed": dict(aggregator="trimmed_mean")}


def yi34b_spec():
    """examples/specs/yi34b_mesh2x4.json as shipped, for 2 rounds."""
    with open(ROOT / "examples" / "specs" / "yi34b_mesh2x4.json") as f:
        d = json.load(f)
    d["rounds"] = 2
    d["eval"] = {"every": 0, "final": False, "verbose": False}
    return d


def yi34b_tp_spec(model_sharding="auto"):
    """examples/specs/yi34b_tp2x4.json as shipped (2 rounds), without
    its final eval."""
    with open(ROOT / "examples" / "specs" / "yi34b_tp2x4.json") as f:
        d = json.load(f)
    d["eval"] = {"every": 0, "final": False, "verbose": False}
    d["fl"]["model_sharding"] = model_sharding
    return d


#: tensor-parallel loss/gradient cases: tag -> (world, the job's "tp")
TP_CASES = {
    "yi@[1, 2]": (2, {"arch": "yi-34b", "mesh": [1, 2], "seed": 0}),
    "qwen3@[1, 2]": (2, {"arch": "qwen3-1.7b", "kw": {"remat": True},
                         "mesh": [1, 2], "seed": 1}),
    "yi@[1, 4]": (4, {"arch": "yi-34b", "mesh": [1, 4], "seed": 0}),
    "qwen3@[1, 4]": (4, {"arch": "qwen3-1.7b", "kw": {"remat": True},
                         "mesh": [1, 4], "seed": 1}),
    "yi-layers-swa-tied@[2, 2]": (4, {
        "arch": "yi-34b", "kw": {"block_pattern": ["attn", "swa"],
                                 "sliding_window": 8,
                                 "tie_embeddings": True},
        "mesh": [2, 2], "seed": 2}),
    "yi-ffn-replicated@[1, 4]": (4, {"arch": "yi-34b",
                                     "kw": {"d_ff": 258},
                                     "mesh": [1, 4], "seed": 3}),
    "rwkv6@[1, 2]": (2, {"arch": "rwkv6-3b", "mesh": [1, 2], "seed": 0}),
    "rwkv6@[1, 4]": (4, {"arch": "rwkv6-3b", "kw": {"remat": True},
                         "mesh": [1, 4], "seed": 0}),
    "rwkv6-split-heads@[1, 2]": (2, {"arch": "rwkv6-3b",
                                     "kw": {"d_model": 96, "n_heads": 3},
                                     "mesh": [1, 2], "seed": 0}),
    "recurrentgemma@[1, 2]": (2, {"arch": "recurrentgemma-2b",
                                  "kw": {"n_layers": 3, "remat": True},
                                  "mesh": [1, 2], "seed": 0, "T": 48}),
    "recurrentgemma@[1, 4]": (4, {"arch": "recurrentgemma-2b",
                                  "kw": {"n_layers": 3, "n_heads": 2},
                                  "mesh": [1, 4], "seed": 0, "T": 48}),
    # d_model 126 at m = 4: the RG-LRU mixers and the embedding replicated
    "recurrentgemma-d126@[1, 4]": (4, {"arch": "recurrentgemma-2b",
                                       "kw": {"n_layers": 3,
                                              "d_model": 126},
                                       "mesh": [1, 4], "seed": 0,
                                       "T": 48}),
    "mixtral@[1, 2]": (2, {"arch": "mixtral-8x22b", "mesh": [1, 2],
                           "seed": 0}),
    "llama4@[1, 2]": (2, {"arch": "llama4-maverick-400b-a17b",
                          "kw": {"remat": True}, "mesh": [1, 2],
                          "seed": 0}),
    "mixtral@[1, 4]": (4, {"arch": "mixtral-8x22b", "kw": {"remat": True},
                           "mesh": [1, 4], "seed": 1}),
    "llama4@[1, 4]": (4, {"arch": "llama4-maverick-400b-a17b",
                          "mesh": [1, 4], "seed": 1}),
    # E = 2 at m = 4: each expert's d_ff columns sharded, the router
    # replicated
    "mixtral-ff-sharded@[1, 4]": (4, {"arch": "mixtral-8x22b",
                                      "moe": {"num_experts": 2},
                                      "mesh": [1, 4], "seed": 2}),
    # the M-RoPE VLM with its stub patches over the first 8 positions: at
    # m = 2 two query heads and one kv head a rank, at m = 4 one query
    # head and half a kv head
    "qwen2-vl-patches@[1, 2]": (2, {"arch": "qwen2-vl-2b",
                                    "kw": {"remat": True}, "mesh": [1, 2],
                                    "seed": 0, "patches": True}),
    "qwen2-vl-patches@[1, 4]": (4, {"arch": "qwen2-vl-2b", "mesh": [1, 4],
                                    "seed": 1, "patches": True}),
    # 3 heads of 34 at m = 4: wa_o's 102 rows do not divide, so the
    # attention is replicated and every rank runs the plain mixer, which
    # must take the M-RoPE positions too; per-layer leaves (attn, swa)
    "qwen2-vl-attn-replicated@[1, 4]": (4, {
        "arch": "qwen2-vl-2b",
        "kw": {"n_heads": 3, "n_kv_heads": 1, "head_dim": 34,
               "mrope_sections": [5, 6, 6],
               "block_pattern": ["attn", "swa"], "sliding_window": 8},
        "mesh": [1, 4], "seed": 2, "patches": True}),
}
#: archs whose gradients are held at their own floor as well: reduced
#: rwkv6's fp32 gradients move by ~6e-5 of a leaf's largest under a
#: one-ulp nudge of the params (the per-head group norm of a near-constant
#: head at t = 0 divides by sqrt(eps)); its plain fp32 gradients sit ~8e-5
#: from the float64 ones, the tensor-parallel ones ~5e-5
TP_FLOOR_ARCHS = ("rwkv6-3b",)

#: the recurrent archs' (1, 2) engine runs: arch -> (layers, T)
RECURRENT_TP = {"rwkv6-3b": (2, 32), "recurrentgemma-2b": (3, 48)}
#: the MoE archs' (1, 2) engine runs: arch -> (layers, T)
MOE_TP = {"mixtral-8x22b": (2, 32), "llama4-maverick-400b-a17b": (2, 32)}
#: the M-RoPE VLM's (1, 2) engine run: 8 vision-grid and 24 text positions
#: (the "lm" component's batches carry no stub patches, as JAX's)
VLM_TP = {"qwen2-vl-2b": (2, 32)}
LM_TP = {**RECURRENT_TP, **MOE_TP, **VLM_TP}

#: apply_moe_tp against apply_moe: tag -> (world, the job's "moe")
MOE_UNIT = {
    "moe-mixtral@2": (2, {"arch": "mixtral-8x22b", "m": 2, "seed": 0}),
    "moe-llama4-drops@2": (2, {"arch": "llama4-maverick-400b-a17b",
                               "m": 2, "seed": 1, "remat": True,
                               "T": 24}),
    "moe-mixtral-drops@4": (4, {"arch": "mixtral-8x22b", "m": 4,
                                "seed": 2, "remat": True,
                                "moe": {"capacity_factor": 0.5}}),
    "moe-llama4@4": (4, {"arch": "llama4-maverick-400b-a17b", "m": 4,
                         "seed": 3}),
    # E = 2 at m = 4: d_ff sharded. Top-2 of 2 (at top-1 the combine's
    # weight is p/p = 1, whose router gradient is float noise of the
    # expert output: the ranks' fp32 sum of d_ff partials moves it)
    "moe-ff-sharded@4": (4, {"arch": "mixtral-8x22b", "m": 4, "seed": 4,
                             "moe": {"num_experts": 2,
                                     "capacity_factor": 0.75}}),
    # neither E = 2 nor d_ff 258 divisible by 4: every leaf replicated,
    # the plain form on every rank
    "moe-replicated@4": (4, {"arch": "mixtral-8x22b", "m": 4, "seed": 5,
                             "kw": {"d_ff": 258},
                             "moe": {"num_experts": 2}}),
}
#: the MOE_UNIT cases that must drop routes past an expert's capacity
MOE_DROPS = ("moe-llama4-drops@2", "moe-mixtral-drops@4",
             "moe-ff-sharded@4")


def lm_tp_spec(arch, model_sharding="auto"):
    """:func:`yi34b_tp_spec` with ``arch`` reduced at LM_TP's depth and T
    (vocab 512) on a (1, 2) mesh, K = 4 in chunks of 2."""
    d = yi34b_tp_spec(model_sharding)
    layers, T = LM_TP[arch]
    d["name"] = f"{arch}-tp-mesh1x2"
    d["model"]["kw"] = {"arch": arch, "reduced": True, "n_layers": layers,
                        "vocab_size": 512}
    d["data"]["kw"].update(vocab=512, seq_len=T)
    d["fl"].update(num_clients=4, chunk_size=2, mesh=[1, 2])
    return d


def _tp_jobs(world):
    return [dict(tag=tag, tp=tp) for tag, (w, tp) in TP_CASES.items()
            if w == world] + [dict(tag=tag, moe=case) for tag, (w, case)
                              in MOE_UNIT.items() if w == world]


def _job(tag, d, p0, rounds=None, **kw):
    return dict(tag=tag, spec=d, params=p0, rounds=rounds or d["rounds"],
                **kw)


def _checkpoint_spec(workdir, mesh, suffix=""):
    return sharded(fcn_spec(K=8, chunk_size=4, sample_frac=1.0,
                            ckpt_every=1, ckpt_path=os.path.join(
                                workdir, "mesh22.ckpt.npz" + suffix)),
                   mesh)


@pytest.fixture(scope="module")
def runs(workdir):
    """Every world at once: 2 ranks for the (2, 1) and (1, 2) jobs and
    the CLI, 4 for the (2, 2) jobs, 8 for yi34b at [2, 4]. The JAX
    package's reference runs go in this process meanwhile. Returns
    ``{"jax": {case: (spec, history, params)}, world: records or the
    failed ranks' output}``."""
    p0 = os.path.join(workdir, "p0.npz")
    np.savez(p0, **jax_params(fcn_spec()))
    yi = yi34b_spec()
    yi_ref = json.loads(json.dumps(yi))
    yi_ref["fl"].update(scheduler="chunked", mesh=None, lbg_variant="topk")
    p0_yi = os.path.join(workdir, "p0_yi.npz")
    np.savez(p0_yi, **jax_params(yi_ref))
    tp_ref = yi34b_tp_spec()
    tp_ref["fl"].update(scheduler="chunked", mesh=None, lbg_variant="topk",
                        model_sharding="replicate")
    p0_tp = os.path.join(workdir, "p0_tp.npz")
    np.savez(p0_tp, **jax_params(tp_ref))
    rec_ref, rec_jobs = {}, []
    for arch in LM_TP:
        rec_ref[arch] = lm_tp_spec(arch)
        rec_ref[arch]["fl"].update(scheduler="chunked", mesh=None,
                                   lbg_variant="topk",
                                   model_sharding="replicate")
        path = os.path.join(workdir, f"p0_{arch}.npz")
        np.savez(path, **jax_params(rec_ref[arch]))
        rec_jobs += [_job(f"{arch}-tp", lm_tp_spec(arch), path),
                     _job(f"{arch}-tp-replicate",
                          lm_tp_spec(arch, "replicate"), path)]
    cli_spec = os.path.join(workdir, "cli_spec.json")
    with open(cli_spec, "w") as f:
        json.dump(sharded(fcn_spec(rounds=1), [2, 1]), f)
    ref = {c: fcn_spec(scheduler="chunked", **fl)
           for c, fl in FCN_CASES.items()}
    ck = _checkpoint_spec(workdir, [2, 2])
    worlds = {
        2: [_job(f"{c}@{mesh}", sharded(ref[c], mesh), p0)
            for mesh, cases in (([2, 1], ("topk", "dense")),
                                ([1, 2], ("topk",)))
            for c in cases]
        + _tp_jobs(2) + rec_jobs
        + [dict(tag="cli", cli=["--spec", cli_spec, "--device", "cpu",
                                "--out", os.path.join(
                                    workdir, "cli.r{rank}.json")])],
        4: [_job(c, sharded(ref[c], [2, 2]), p0)
            for c in ("topk", "int8", "int8-stochastic", "trimmed")]
        + [_job("cut", ck, p0, rounds=1,
                copy_ckpt=ck["fl"]["ckpt_path"] + ".round1"),
           _job("resume", ck, p0, resume=True), _job("whole", ck, p0)]
        + _tp_jobs(4),
        8: [_job("yi", yi, p0_yi), _job("tp", yi34b_tp_spec(), p0_tp),
            _job("tp-replicate", yi34b_tp_spec("replicate"), p0_tp),
            dict(tag="tp-cli", cli=[
                "--spec", str(ROOT / "examples" / "specs" /
                              "yi34b_tp2x4.json"),
                "--rounds", "1", "--device", "cpu", "--out",
                os.path.join(workdir, "tp-cli.r{rank}.json")])],
    }
    # the 4-rank world's gathers and reshards in pieces of 64 KiB
    procs = {w: start(w, jobs, workdir, 1 << 16 if w == 4 else None)
             for w, jobs in worlds.items()}
    try:
        jax = {c: (d,) + jax_run(d)[:2] for c, d in ref.items()}
        jax["yi"] = (yi,) + jax_run(yi_ref)[:2]
        jax["tp"] = (tp_ref,) + jax_run(tp_ref)[:2]
        for arch, d in rec_ref.items():
            jax[arch] = (d,) + jax_run(d)[:2]
    finally:
        got = {w: finish(w, jobs, procs[w], workdir)
               for w, jobs in worlds.items()}
    return {"jax": jax, **got}


def world(runs, n):
    got = runs[n]
    assert not isinstance(got, str), f"a rank of the {n}-rank world " \
        f"failed:\n{got}"
    return got


@pytest.mark.parametrize("mesh", [[2, 1], [1, 2]])
def test_two_rank_meshes_match_jax(mesh, runs):
    got = world(runs, 2)
    cases = ["topk"] + (["dense"] if mesh == [2, 1] else [])
    for c in cases:
        d, jh, jp = runs["jax"][c]
        recs = got[f"{c}@{mesh}"]
        assert all(rec["backend"] == "gloo" for rec in recs)
        assert_matches_jax(f"{c}@{mesh}", recs, jh, jp,
                           d["fl"]["delta_threshold"])
    recs = got[f"topk@{mesh}"]
    c, m = mesh
    assert recs[0]["pad"] == (2 if c == 2 else 0)
    assert recs[0]["msharded"] == (None if m == 1 else {
        "fc1/w": True, "fc1/b": False, "fc2/w": False, "fc2/b": False})
    for rec in recs:
        assert rec["bank_bytes"]["fc1/w"] * c * m \
            == rec["global_bytes"]["fc1/w"]


def test_cli_runs_on_two_gloo_ranks(runs, workdir):
    """``python -m repro_torch.fed.run`` under a launcher's world of two
    ranks (``repro_torch.fed.run.main`` in each): both return 0 and end
    the world; rank 0 alone prints and writes ``--out``, whose records
    are the in-process chunked run's (from the same seed)."""
    recs = world(runs, 2)["cli"]
    assert [rec["rc"] for rec in recs] == [0, 0]
    assert "1 rounds on cpu" in recs[0]["stdout"]
    assert recs[1]["stdout"] == ""
    assert not os.path.exists(os.path.join(workdir, "cli.r1.json"))
    with open(os.path.join(workdir, "cli.r0.json")) as f:
        res = json.load(f)
    spec = fcn_spec(rounds=1, scheduler="chunked")
    eng, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(spec),
                                   device="cpu")
    want = eng.run(1)
    assert res["spec"]["fl"]["mesh"] == [2, 1]
    assert len(res["records"]) == 1
    for k in ("uplink_floats", "frac_scalar", "wire_bytes"):
        assert res["records"][0][k] == want[0][k], k
    np.testing.assert_allclose(res["records"][0]["loss"], want[0]["loss"],
                               rtol=1e-5)


def test_2x2_mesh_matches_jax_and_resumes(runs, workdir):
    """(2, 2): top-k-sharded, int8 (round to nearest, and stochastic at
    the floor of ``int8_nudge_floor.py``), trimmed_mean against JAX;
    checkpoint and resume against the uninterrupted run."""
    got = world(runs, 4)
    for c in ("topk", "int8", "int8-stochastic", "trimmed"):
        d, jh, jp = runs["jax"][c]
        assert_matches_jax(f"{c}@[2, 2]", got[c], jh, jp,
                           d["fl"]["delta_threshold"], ties=c == "int8",
                           floor=c == "int8-stochastic")
    for rec in got["topk"]:
        assert rec["backend"] == "gloo"
        assert rec["bank_bytes"]["fc1/w"] * 4 == rec["global_bytes"]["fc1/w"]
        # a replicated leaf: 1/c of the bank on every rank
        assert rec["bank_bytes"]["fc2/w"] * 2 == rec["global_bytes"]["fc2/w"]
    # resume == uninterrupted, bit for bit, on every rank
    for a, b in zip(got["resume"], got["whole"]):
        assert a["history"] == b["history"]
        for k in a["params"]:
            assert np.array_equal(a["params"][k], b["params"][k]), k
    # the round-1 file holds the global banks, equal to the (1, 1) run's
    one = _checkpoint_spec(workdir, [1, 1], ".1x1")
    with np.load(os.path.join(workdir, "p0.npz")) as z:
        p0 = {k: z[k] for k in z.files}
    eng, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(one),
                                   params=p0, device="cpu")
    eng.run(1)
    ck = _checkpoint_spec(workdir, [2, 2])["fl"]["ckpt_path"]
    a, _ = ckpt.load_checkpoint(ck + ".round1")
    b, _ = ckpt.load_checkpoint(one["fl"]["ckpt_path"])
    for name, leaf in b["lbg"].items():
        for k, x in leaf.items():
            assert tuple(x.shape[:2]) == (2, 4)
            assert torch.equal(a["lbg"][name][k], x), (name, k)


def test_yi34b_mesh2x4_spec_matches_jax(runs):
    """examples/specs/yi34b_mesh2x4.json as shipped ([2, 4], topk-sharded
    at k_frac 0.01, the "lm" component) for 2 rounds on 8 ranks, against
    JAX's chunked "topk" run of the spec without the mesh, at
    test_torch_fl_lm.py's fp32 tolerances (qwen3's params tolerance)."""
    got = world(runs, 8)["yi"]
    d, jh, jp = runs["jax"]["yi"]
    # as shipped (delta 0.5) its two rounds are full rounds; the FCN cases
    # hold the recycle branch
    assert_matches_jax("yi34b@[2, 4]", got, jh, jp,
                       d["fl"]["delta_threshold"], recycles=False)
    ms = got[0]["msharded"]
    assert ms and any(ms.values()), ms
    for rec in got:
        for name, on in ms.items():
            div = 8 if on else 2
            assert rec["bank_bytes"][name] * div == \
                rec["global_bytes"][name], name


@pytest.mark.parametrize("case", sorted(TP_CASES))
def test_tp_loss_and_grads_match_plain(case, runs):
    """The tensor-parallel loss and gradients of every rank's shards
    against the plain single-process ones from the same params and batch
    (fp32: loss rtol 1e-6, gradients rtol 1e-4 / atol 1e-5 of the leaf's
    largest; for TP_FLOOR_ARCHS a leaf's atol is the larger of that and
    twice the plain gradient's own spread under a one-ulp nudge of every
    param, towards +inf and towards -inf): each rank's gradient is its
    shard of the assembled one, and the assembled gradients are the same
    on every rank of a model group, bit for bit."""
    world_n, tp = TP_CASES[case]
    recs = world(runs, world_n)[case]
    cfg = tp_cfg(tp)
    params, _ = init_lm(torch.Generator().manual_seed(tp["seed"]), cfg,
                        device="cpu")
    c, m = tp["mesh"]
    plain, floor = {}, {}
    for r in range(c):
        batch = tp_batch(cfg, tp["seed"], r, T=tp.get("T", 16),
                         patches=tp.get("patches", False))
        g, loss = grad_and_loss(make_loss_fn(cfg), params, batch)
        plain[r] = ({k: v.numpy() for k, v in g.items()}, float(loss))
        if tp["arch"] not in TP_FLOOR_ARCHS:
            continue
        floor[r] = {k: 0.0 for k in g}
        for sign in (1, -1):
            moved = {k: torch.nextafter(v, torch.full_like(
                v, sign * float("inf"))) for k, v in params.items()}
            gn, _ = grad_and_loss(make_loss_fn(cfg), moved, batch)
            for k, v in gn.items():
                floor[r][k] = max(floor[r][k],
                                  float((v - g[k]).abs().max()))
    specs = recs[0]["specs"]
    assert specs["embed"] == ((None, "model") if cfg.d_model % m == 0
                              else (None, None))
    assert sum("model" in s for s in specs.values()) >= 6, specs
    for rec in recs:
        assert rec["specs"] == specs
        g, loss = plain[rec["client_rank"]]
        np.testing.assert_allclose(rec["loss"], loss, rtol=1e-6)
        q = rec["model_rank"]
        for k, want in g.items():
            got = rec["assembled"][k]
            atol = 1e-5 * np.abs(want).max()
            if floor:
                atol = max(atol, 2 * floor[rec["client_rank"]][k])
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol,
                                       err_msg=f"{case} {k}")
            mine = rec["grads"][k]
            if "model" in specs[k]:
                d = specs[k].index("model")
                n = got.shape[d] // m
                got = np.take(got, range(q * n, (q + 1) * n), axis=d)
            assert np.array_equal(mine, got), (case, k, q)
        mates = [o for o in recs if o["client_rank"] == rec["client_rank"]]
        for o in mates:
            for k, v in rec["assembled"].items():
                assert np.array_equal(o["assembled"][k], v), (case, k)


def test_tp_cli_runs_on_eight_gloo_ranks(runs, workdir):
    """``python -m repro_torch.fed.run --spec
    examples/specs/yi34b_tp2x4.json`` on each of 8 ranks (1 round): every
    rank returns 0, rank 0 alone prints and writes ``--out``; its round
    is the engine job's first round (the CLI draws the params from the
    spec's seed, the engine job takes JAX's: EXACT fields equal) and its
    final eval is finite."""
    recs = world(runs, 8)["tp-cli"]
    assert [rec["rc"] for rec in recs] == [0] * 8
    assert "1 rounds on cpu" in recs[0]["stdout"]
    assert all(rec["stdout"] == "" for rec in recs[1:])
    with open(os.path.join(workdir, "tp-cli.r0.json")) as f:
        res = json.load(f)
    assert res["spec"]["fl"]["model_sharding"] == "auto"
    first = world(runs, 8)["tp"][0]["history"][0]
    for k in ("uplink_floats", "frac_scalar", "wire_bytes"):
        assert res["records"][0][k] == first[k], k
    assert np.isfinite(res["final_eval"]["test_loss"])


def test_yi34b_tp2x4_spec_matches_jax(runs):
    """examples/specs/yi34b_tp2x4.json as shipped (reduced yi-34b at 60
    layers, [2, 4], model_sharding="auto") for 2 rounds on 8 ranks:

    * against JAX's chunked "topk" run of the spec without the mesh and
      model_sharding, under ``test_yi34b_mesh2x4_spec_matches_jax``'s
      rules;
    * against the port's own "replicate" run of the spec: EXACT fields
      equal, loss within rtol 1e-5 / atol 1e-7;
    * each rank rests its shards by JAX's spec rule, at most 1/4 + 0.02
      of the param bytes, ``embed`` (None, "model") and ``lm_head``
      ("model", None)."""
    got = world(runs, 8)
    d, jh, jp = runs["jax"]["tp"]
    recs, reps = got["tp"], got["tp-replicate"]
    assert_matches_jax("yi34b-tp@[2, 4]", recs, jh, jp,
                       d["fl"]["delta_threshold"], recycles=False)
    assert_ranks_agree(reps)
    for r, (a, b) in enumerate(zip(reps[0]["history"], recs[0]["history"])):
        for k in EXACT:
            assert a[k] == b[k], (r, k, a[k], b[k])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5,
                                   atol=1e-7)
    specs = recs[0]["specs"]
    assert specs["embed"] == (None, "model")
    assert specs["lm_head"] == ("model", None)
    total = sum(v.nbytes for v in recs[0]["params"].values())
    for rec in recs:
        assert rec["specs"] == specs
        assert rec["rest_bytes"] <= (1 / 4 + 0.02) * total, (
            rec["rest_bytes"], total)
        assert rec["msharded"] == reps[0]["msharded"]


def check_lm_tp_engine(arch, runs):
    """:func:`lm_tp_spec` (reduced, the ``"lm"`` component, top-k-sharded
    at k_frac 0.01, K = 4, 2 rounds, ``model_sharding="auto"`` on a (1,
    2) mesh) on 2 ranks: against JAX's chunked ``"topk"`` run of the spec
    without the mesh, under ``test_yi34b_mesh2x4_spec_matches_jax``'s
    rules; against the port's own ``"replicate"`` run, EXACT fields equal
    and loss within rtol 1e-5; each rank resting its shards by JAX's spec
    rule: half of each model-sharded leaf's bytes and the whole of each
    replicated one. Returns the leaves' specs."""
    got = world(runs, 2)
    d, jh, jp = runs["jax"][arch]
    recs, reps = got[f"{arch}-tp"], got[f"{arch}-tp-replicate"]
    assert_matches_jax(f"{arch}-tp@[1, 2]", recs, jh, jp,
                       d["fl"]["delta_threshold"], recycles=False)
    assert_ranks_agree(reps)
    for r, (a, b) in enumerate(zip(reps[0]["history"], recs[0]["history"])):
        for k in EXACT:
            assert a[k] == b[k], (r, k, a[k], b[k])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    specs = recs[0]["specs"]
    assert specs["embed"] == (None, "model")
    assert specs["lm_head"] == ("model", None)
    rest = sum(v.nbytes // (2 if "model" in specs[k] else 1)
               for k, v in recs[0]["params"].items())
    for rec in recs:
        assert rec["specs"] == specs
        assert rec["rest_bytes"] == rest, (rec["rest_bytes"], rest)
    return specs


@pytest.mark.parametrize("arch", sorted(RECURRENT_TP))
def test_recurrent_tp_engine_matches_jax(arch, runs):
    """:func:`check_lm_tp_engine` for the recurrent archs, their mixers
    model-sharded (at these widths rwkv6's replicated decay LoRA is 6.8%
    of the bytes)."""
    specs = check_lm_tp_engine(arch, runs)
    mixer = ("blocks/tmix/w_o" if arch == "rwkv6-3b"
             else "layer_00/rec/w_out")
    assert "model" in specs[mixer], specs[mixer]


@pytest.mark.parametrize("arch", sorted(MOE_TP))
def test_moe_tp_engine_matches_jax(arch, runs):
    """:func:`check_lm_tp_engine` for the MoE archs, the stacked experts
    sharded on E (dim 1, after ``layers``) with the router's E columns."""
    specs = check_lm_tp_engine(arch, runs)
    for k in ("w_gate", "w_up", "w_down"):
        assert specs[f"blocks/moe/{k}"] == (None, "model", None, None), k
    assert specs["blocks/moe/router"] == (None, None, "model")


def test_vlm_tp_engine_matches_jax(runs):
    """:func:`check_lm_tp_engine` for the M-RoPE VLM (reduced qwen2-vl-2b,
    M-RoPE at a rank's local heads: two query heads and one kv head a
    rank), its attention and FFN model-sharded."""
    specs = check_lm_tp_engine("qwen2-vl-2b", runs)
    assert specs["blocks/wa_o"] == (None, "model", None)
    assert specs["blocks/wa_k"] == (None, None, "model")
    assert specs["blocks/w_down"] == (None, "model", None)


@pytest.mark.parametrize("case", sorted(MOE_UNIT))
def test_moe_tp_matches_plain(case, runs):
    """``models.moe.apply_moe_tp`` on every rank of a (1, m) mesh against
    ``apply_moe`` on the same fp32 x, params and upstream gradient
    (:func:`torch_ranks_worker.moe_inputs`): every routing (probs, top-k,
    positions, keep, dispatch buffer, slots) equal to the plain one on
    every rank; each pair of neighbours among a token's k + 1 largest
    probs (the k-th and (k+1)-th among them) more than 1e-5 apart, so no
    float-level difference could flip a route or its order; the MOE_DROPS
    cases drop routes; output and aux within rtol 1e-5 (atol 1e-6 of the
    largest output), the gradients of x and of every leaf (each rank's its
    shard of the assembled one) within rtol 1e-4 / atol 1e-5 of the
    largest, so a gradient summed on m ranks where it should be summed
    once shows; output, aux and assembled gradients bit for bit the same
    on every rank."""
    world_n, mc = MOE_UNIT[case]
    recs = world(runs, world_n)[case]
    cfg, params, _, x, dy = moe_inputs(mc)
    k = cfg.moe.top_k
    leaves = {n: v.clone().requires_grad_() for n, v in params.items()}
    xg = x.clone().requires_grad_()
    out, aux = tmoe.apply_moe(leaves, xg, cfg)
    ((out * dy).sum() + AUX_WEIGHT * aux).backward()
    r = tmoe.moe_routing(params, x, cfg)
    srt = torch.sort(r.probs, dim=-1, descending=True).values[..., :k + 1]
    gap = float((srt[..., :-1] - srt[..., 1:]).min())
    assert gap > 1e-5, (case, gap)
    if case in MOE_DROPS:
        assert int((~r.keep).sum()) > 0, case
    want = {f: v.numpy() for f, v in r._asdict().items()}
    out, aux = out.detach().numpy(), float(aux.detach())
    specs = recs[0]["specs"]
    on_e = cfg.moe.num_experts % mc["m"] == 0
    on_ff = not on_e and cfg.d_ff % mc["m"] == 0
    assert specs["w_gate"] == (("model", None, None) if on_e
                               else (None, None, "model") if on_ff
                               else (None, None, None)), specs
    assert specs["router"] == ((None, "model") if on_e else (None, None))
    for rec in recs:
        assert len(rec["routings"]) == 1, len(rec["routings"])
        for f, v in rec["routings"][0].items():
            assert np.array_equal(v, want[f]), (case, f, rec["model_rank"])
        np.testing.assert_allclose(rec["out"], out, rtol=1e-5,
                                   atol=1e-6 * np.abs(out).max())
        np.testing.assert_allclose(rec["aux"], aux, rtol=1e-5)
        got = dict(rec["assembled"], x=rec["x_grad"])
        plain = {n: v.grad.numpy() for n, v in leaves.items()}
        plain["x"] = xg.grad.numpy()
        for n, g in plain.items():
            np.testing.assert_allclose(got[n], g, rtol=1e-4,
                                       atol=1e-5 * np.abs(g).max(),
                                       err_msg=f"{case} {n}")
        q = rec["model_rank"]
        for n, mine in rec["grads"].items():
            full = rec["assembled"][n]
            if "model" in specs[n]:
                dim = specs[n].index("model")
                w = full.shape[dim] // mc["m"]
                full = np.take(full, range(q * w, (q + 1) * w), axis=dim)
            assert np.array_equal(mine, full), (case, n, q)
        assert np.array_equal(rec["out"], recs[0]["out"])
        assert rec["aux"] == recs[0]["aux"]
        for n, v in rec["assembled"].items():
            assert np.array_equal(v, recs[0]["assembled"][n]), (case, n)

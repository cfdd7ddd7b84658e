"""The ``"sharded"`` scheduler on gloo CPU ranks against the JAX package.

Each world is ``c·m`` spawned processes (``tests/torch_ranks_worker.py``,
given the environment ``torchrun`` gives its ranks, so the engine's mesh
joins the world through ``env://``), which runs a list of specs so the
imports are paid once. The worlds of 2, 4 and 8 ranks run at once, beside
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
  rows is held in ``test_torch_mesh.py``);
* ``trimmed_mean`` at ``(2, 2)`` (collect mode);
* checkpoint and resume at ``(2, 2)``: equal bit for bit to the
  uninterrupted run, and the round-1 file's banks equal to the ``(1, 1)``
  run's file;
* ``examples/specs/yi34b_mesh2x4.json`` at its ``[2, 4]`` mesh for 2
  rounds, against the JAX package's chunked ``"topk"`` run of the spec
  with the mesh removed;
* the CLI, ``repro_torch.fed.run.main``, on each rank of a world of two
  at ``(2, 1)``: rank 0 alone prints and writes ``--out``.
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

from repro.fed import experiment as jexp  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.fed import experiment as texp  # noqa: E402

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


def start(world, jobs, out):
    """Launch ``jobs`` on a gloo world of ``world`` CPU ranks, as
    ``torchrun`` would (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``); returns the processes."""
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
                       tol=dict(rtol=1e-4, atol=1e-6), recycles=True):
    assert_ranks_agree(recs)
    th = recs[0]["history"]
    assert len(th) == len(jh)
    for r, (a, b) in enumerate(zip(jh, th)):
        for k in EXACT:
            assert a[k] == b[k], (case, r, k, a[k], b[k])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5,
                                   err_msg=f"{case} round {r}")
    margin = min(float(np.min(np.abs(s - delta))) for s in recs[0]["sin2"])
    assert margin > 1e-5, (case, margin)
    if recycles:
        assert max(h["frac_scalar"] for h in th) > 0, f"{case}: no recycle"
    for k, j in jp.items():
        t = recs[0]["params"][k]
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
             "trimmed": dict(aggregator="trimmed_mean")}


def yi34b_spec():
    """examples/specs/yi34b_mesh2x4.json as shipped, for 2 rounds."""
    with open(ROOT / "examples" / "specs" / "yi34b_mesh2x4.json") as f:
        d = json.load(f)
    d["rounds"] = 2
    d["eval"] = {"every": 0, "final": False, "verbose": False}
    return d


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
        + [dict(tag="cli", cli=["--spec", cli_spec, "--device", "cpu",
                                "--out", os.path.join(
                                    workdir, "cli.r{rank}.json")])],
        4: [_job(c, sharded(ref[c], [2, 2]), p0)
            for c in ("topk", "int8", "trimmed")]
        + [_job("cut", ck, p0, rounds=1,
                copy_ckpt=ck["fl"]["ckpt_path"] + ".round1"),
           _job("resume", ck, p0, resume=True), _job("whole", ck, p0)],
        8: [_job("yi", yi, p0_yi)],
    }
    procs = {w: start(w, jobs, workdir) for w, jobs in worlds.items()}
    try:
        jax = {c: (d,) + jax_run(d)[:2] for c, d in ref.items()}
        jax["yi"] = (yi,) + jax_run(yi_ref)[:2]
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
    """(2, 2): top-k-sharded, int8, trimmed_mean against JAX; checkpoint
    and resume against the uninterrupted run."""
    got = world(runs, 4)
    for c in ("topk", "int8", "trimmed"):
        d, jh, jp = runs["jax"][c]
        assert_matches_jax(f"{c}@[2, 2]", got[c], jh, jp,
                           d["fl"]["delta_threshold"], ties=c == "int8")
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

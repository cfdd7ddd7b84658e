"""The port's checkpoint and resume (``FLConfig.ckpt_every``, ``--resume``)
against the uninterrupted run and against the JAX package.

Mirrors ``tests/test_checkpoint_resume.py``:

* ``save_checkpoint`` -> a fresh engine -> ``restore_checkpoint`` -> the
  remaining rounds is the uninterrupted run bit for bit (history, params,
  banks, ledger) on the vmap, chunked and buffered schedulers, the
  ``"topk-host"`` store, tiers behind the stochastic int8 wire, and a
  payload attack with dropout behind the stochastic fp8 wire; and the
  resumed run agrees with the JAX engine's uninterrupted run
  (:func:`engine_parity`'s checks, the stochastic wires' params by the
  ``TIE_FRACTION`` rule);
* ``FLEngine.run(resume=True)`` with the prefetcher on (its thread draws
  ahead; the snapshot that travels with each round is the cut), and
  ``run_experiment(spec, resume=True)``; ``RoundPrefetcher.close()``
  rewinds the host streams to the last round it handed out;
* a checkpoint of another config is refused, a save before any round
  too, and a JAX-written checkpoint resumes in the port;
* ``examples/specs/hier_100k.json``, cut by ``--set`` only, through both
  CLIs' ``main`` with ``--resume``.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.fed import experiment as jexp  # noqa: E402
from repro.fed import run as jrun  # noqa: E402
from repro_torch.fed import experiment as texp  # noqa: E402
from repro_torch.fed import run as trun  # noqa: E402
from test_torch_robust import (EXACT, assert_runs_agree,  # noqa: E402
                               engines, fcn_spec)

ROOT = Path(__file__).resolve().parents[1]
TOPK = dict(lbg_variant="topk", lbg_kw={"k_frac": 0.1}, delta_threshold=0.9)
CHUNKED = dict(scheduler="chunked", chunk_size=4)
ROUNDS, SAVE_AT = 4, 2

CASES = {
    "vmap": dict(TOPK),
    "chunked-dense": dict(CHUNKED, delta_threshold=0.2),
    "topk-host": dict(TOPK, **CHUNKED, lbg_variant="topk-host"),
    "tiers-int8": dict(TOPK, **CHUNKED, tiers=[4, 2], codec="int8"),
    "buffered": dict(TOPK, scheduler="buffered", chunk_size=4,
                     latency="straggler",
                     latency_kw={"frac": 0.5, "delay": 2, "jitter": 1,
                                 "max_staleness": 4}),
    "attack-dropout-fp8": dict(TOPK, **CHUNKED, codec="fp8",
                               attack="gaussian", attack_frac=0.25,
                               attack_kw={"sigma": 0.5}, dropout_frac=0.2),
}
STOCHASTIC = ("tiers-int8", "attack-dropout-fp8")


def port_engine(fl, params):
    return texp.build_experiment(
        texp.ExperimentSpec.from_dict(fcn_spec(rounds=ROUNDS, **fl)),
        params=params, device="cpu")[0]


def assert_same_run(a, b):
    """Two port engines: histories, params, banks and ledgers equal."""
    assert a.history == b.history
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for bank_a, bank_b in ((a.lbg, b.lbg), (a.residual, b.residual)):
        flat_a, flat_b = [], []
        _leaves(bank_a, flat_a)
        _leaves(bank_b, flat_b)
        assert len(flat_a) == len(flat_b)
        for x, y in zip(flat_a, flat_b):
            assert torch.equal(x, y)
    assert a.ledger.state_dict() == b.ledger.state_dict()
    assert getattr(a, "n_delivered", None) == getattr(b, "n_delivered", None)


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    else:
        out.append(tree)


@pytest.mark.parametrize("case", sorted(CASES))
def test_save_restore_continue_bit_for_bit(case, tmp_path):
    fl = CASES[case]
    jeng, full = engines(fcn_spec(rounds=ROUNDS, **fl))
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    rng = np.random.RandomState(1)
    for _ in range(ROUNDS):
        full.run_round(rng)
    part = port_engine(fl, p0)
    rng = np.random.RandomState(1)
    for _ in range(SAVE_AT):
        part.run_round(rng)
    path = str(tmp_path / "ck.npz")
    part.save_checkpoint(path)
    res = port_engine(fl, p0)
    rng2 = np.random.RandomState(777)   # set by the restore
    assert res.restore_checkpoint(path, rng2) == SAVE_AT
    for _ in range(ROUNDS - SAVE_AT):
        res.run_round(rng2)
    assert_same_run(full, res)
    jrng = np.random.RandomState(1)
    jh = [jeng.run_round(jrng) for _ in range(ROUNDS)]
    assert_runs_agree(case, jeng, res, jh, res.history,
                      recycle=case != "buffered", ties=case in STOCHASTIC)


@pytest.mark.parametrize("case", ["tiers-int8", "attack-dropout-fp8",
                                  "buffered", "topk-host"])
def test_run_resume_prefetcher_path(case, tmp_path):
    """``run`` draws on the prefetcher's thread: the checkpoint carries the
    producer's snapshot of the round that ran, not the read-ahead."""
    path = str(tmp_path / "ck.npz")
    fl = dict(CASES[case], ckpt_every=ROUNDS - 1, ckpt_path=path)
    jeng, full = engines(fcn_spec(rounds=ROUNDS, **fl))
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    del jeng
    full.run(ROUNDS)              # leaves the round-3 checkpoint
    res = port_engine(fl, p0)
    res.run(ROUNDS, resume=True)  # round 4 only
    assert len(res.history) == ROUNDS
    assert_same_run(full, res)


def test_buffered_inflight_slots_travel(tmp_path):
    """Payloads dispatched before the save land after the resume."""
    fl = dict(TOPK, scheduler="buffered", chunk_size=4, latency="fixed",
              latency_kw={"delay": 2})
    jeng, full = engines(fcn_spec(rounds=ROUNDS, **fl))
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    del jeng
    rng = np.random.RandomState(0)
    for _ in range(ROUNDS):
        full.run_round(rng)
    part = port_engine(fl, p0)
    rng = np.random.RandomState(0)
    for _ in range(SAVE_AT):    # every slot still in flight
        part.run_round(rng)
    assert part._arrival.max() > SAVE_AT - 1
    path = str(tmp_path / "ck.npz")
    part.save_checkpoint(path)
    res = port_engine(fl, p0)
    rng2 = np.random.RandomState(0)
    res.restore_checkpoint(path, rng2)
    for _ in range(ROUNDS - SAVE_AT):
        res.run_round(rng2)
    assert_same_run(full, res)
    assert res.n_delivered == full.n_delivered > 0


def test_prefetcher_close_rewinds_host_streams():
    """After ``close()`` the rng, the fault and codec streams and the
    buffered plan stand where the synchronous path leaves them after the
    rounds that ran: the queued rounds' draws are dropped, and running on
    in line from the same rng gives the uninterrupted run."""
    fl = dict(TOPK, scheduler="buffered", chunk_size=4, codec="int8",
              latency="uniform", latency_kw={"low": 0, "high": 2},
              attack="gaussian", attack_frac=0.25, dropout_frac=0.2)
    jeng, full = engines(fcn_spec(rounds=ROUNDS, **fl))
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    del jeng
    rng = np.random.RandomState(1)
    for _ in range(ROUNDS):
        full.run_round(rng)
    eng = port_engine(fl, p0)
    rng = np.random.RandomState(1)
    pf = eng.prefetcher(rng, depth=2)
    for _ in range(SAVE_AT):
        eng.run_round(pf)
    pf.close()
    for _ in range(ROUNDS - SAVE_AT):
        eng.run_round(rng)
    assert_same_run(full, eng)


def test_restore_rejects_mismatched_config(tmp_path):
    path = str(tmp_path / "ck.npz")
    jeng, a = engines(fcn_spec(**TOPK))
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    a.run_round(np.random.RandomState(0))
    a.save_checkpoint(path)
    b = port_engine(dict(TOPK, delta_threshold=0.3), p0)
    with pytest.raises(ValueError, match="config") as e:
        b.restore_checkpoint(path, np.random.RandomState(0))
    assert "different FLConfig" in str(e.value)


def test_save_requires_round_boundary_state(tmp_path):
    fresh = port_engine(TOPK, None)
    with pytest.raises(ValueError, match="no completed round"):
        fresh.save_checkpoint(str(tmp_path / "ck.npz"))
    with pytest.raises(ValueError, match="ckpt_path"):
        fresh.run(2, resume=True)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the JAX engine wrote after round 2 continues in the
    port; its rounds 3-4 agree with the JAX engine's."""
    path = str(tmp_path / "ck.npz")
    fl = dict(TOPK, **CHUNKED, lbg_variant="topk-host", tiers=[4])
    jeng, teng = engines(fcn_spec(rounds=ROUNDS, **fl))
    jrng = np.random.RandomState(1)
    jh = [jeng.run_round(jrng) for _ in range(SAVE_AT)]
    jeng.save_checkpoint(path)
    jh += [jeng.run_round(jrng) for _ in range(ROUNDS - SAVE_AT)]
    trng = np.random.RandomState(0)
    assert teng.restore_checkpoint(path, trng) == SAVE_AT
    for _ in range(ROUNDS - SAVE_AT):
        teng.run_round(trng)
    assert_runs_agree("jax-ckpt", jeng, teng, jh, teng.history)


def _spec(path, ckpt_every=2, **fl):
    return texp.ExperimentSpec.from_dict({
        "name": "resume-smoke", "model": {"name": "fcn", "kw": {}},
        "data": {"name": "mixture", "kw": {"n": 400, "n_eval": 100}},
        "partition": {"name": "label_skew",
                      "kw": {"classes_per_client": 3}},
        "fl": dict(num_clients=4, tau=2, lr=0.05, batch_size=16,
                   use_lbgm=True, delta_threshold=0.2,
                   ckpt_every=ckpt_every, ckpt_path=path, **fl),
        "rounds": ROUNDS, "eval": {"every": 0, "final": True}})


def test_run_experiment_resume(tmp_path):
    path = str(tmp_path / "ck.npz")
    spec = _spec(path, codec="int8", lbg_variant="topk",
                 lbg_kw={"k_frac": 0.1})
    full = texp.run_experiment(spec, device="cpu")
    texp.run_experiment(spec, rounds=3, device="cpu")     # ckpt at round 2
    res = texp.run_experiment(spec, device="cpu", resume=True)
    assert [r.round for r in res.records] == list(range(1, ROUNDS + 1))
    for ra, rb in zip(full.records, res.records):
        for k in ("loss",) + EXACT:
            assert getattr(ra, k) == getattr(rb, k), k
    assert full.final_eval == res.final_eval
    bad = _spec(None, ckpt_every=0)
    with pytest.raises(ValueError, match="ckpt_path"):
        texp.run_experiment(bad, device="cpu", resume=True)


def test_hier_100k_spec_through_both_clis_with_resume(tmp_path,
                                                      monkeypatch):
    """``examples/specs/hier_100k.json``, cut by ``--set`` alone (K 64, n
    256, chunk 8, tiers [8, 2] shuffled, 6 rounds: the spec checkpoints
    every 5), through both CLIs' ``main``: each package's resumed run
    (rounds 1-5, then ``--resume`` to round 6) equals its uninterrupted
    run, and the port's agrees with the JAX package's."""
    spec_file = ROOT / "examples" / "specs" / "hier_100k.json"
    sets = ["fl.num_clients=64", "data.kw.n=256", "fl.chunk_size=8",
            'fl.tiers={"levels": [8, 2], "assign": "shuffle"}']
    d = json.loads(spec_file.read_text())
    for s in sets:
        key, _, raw = s.partition("=")
        node = d
        for part in key.split(".")[:-1]:
            node = node[part]
        node[key.split(".")[-1]] = json.loads(raw) if raw[0] in "{[" \
            else int(raw)
    jeng, _ = jexp.build_experiment(jexp.ExperimentSpec.from_dict(d))
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    del jeng
    real_build = texp.build_experiment

    def build(spec, params=None, device="cuda"):
        return real_build(spec, params=p0 if params is None else params,
                          device=device)
    monkeypatch.setattr(texp, "build_experiment", build)

    def run(main, tag, rounds, extra=()):
        out = tmp_path / f"{tag}-{rounds}.json"
        argv = ["--spec", str(spec_file), "--rounds", str(rounds),
                "--out", str(out)]
        for s in sets + [f"fl.ckpt_path={tmp_path / tag}.ckpt.npz"]:
            argv += ["--set", s]
        assert main(argv + list(extra)) == 0
        return json.loads(out.read_text())

    results = {}
    for tag, main, extra in (("jax", jrun.main, ()),
                             ("torch", trun.main, ("--device", "cpu"))):
        full = run(main, tag + "-full", 6, extra)
        run(main, tag, 5, extra)
        res = run(main, tag, 6, extra + ("--resume",))
        assert len(res["records"]) == 6
        for a, b in zip(full["records"], res["records"]):
            for k in ("loss",) + EXACT:
                assert a[k] == b[k], (tag, k)
        assert res["final_eval"] == full["final_eval"]
        results[tag] = res
    j, t = results["jax"], results["torch"]
    for a, b in zip(j["records"], t["records"]):
        for k in EXACT:
            assert a[k] == b[k], (k, a[k], b[k])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    assert max(r["frac_scalar"] for r in t["records"]) > 0
    for k, v in j["final_eval"].items():
        np.testing.assert_allclose(t["final_eval"][k], v, rtol=1e-4)

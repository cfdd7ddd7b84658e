"""The buffered asynchronous scheduler and the latency models of the port,
against ``repro.fed.latency`` and the JAX engine's ``"buffered"``.

* every latency model draws the same delays, cohorts and local-step
  budgets from one ``RandomState``; ``staleness_weight(0)`` is exactly 1.0;
* ``FLConfig`` refuses the same buffered configurations and mistyped
  ``*_kw`` keys as the JAX package, in the same words;
* engine histories against the JAX engine (:func:`engine_parity` of
  ``test_torch_robust.py``: discrete fields, delivered and evicted counts
  exact, wire bytes by arrival round; loss rtol 1e-5, params rtol 1e-4 /
  atol 1e-6): straggler latency with ``max_staleness`` eviction and a
  dropped cohort, variable tau, the int8 wire (the dequant fold reads the
  staleness buffer in wire dtype), fixed, uniform and lognormal delays,
  robust rules and an adaptive attack that reads its delay;
* with ``latency="none"`` the buffered round equals the port's chunked
  round bit for bit (histories and params), as the JAX package holds;
* reduced qwen3 through the engine's ``CLIENT_LOOP``, buffered with
  ``scalar_median`` under ``sign_flip``, against the JAX engine (the
  tolerances of ``test_torch_fl_lm.py``);
* ``examples/specs/async_buffered.json`` through both CLIs' ``main``.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.fed import latency as jl  # noqa: E402
from repro.fed.flconfig import FLConfig as JFL  # noqa: E402
from repro_torch.fed import latency as tl  # noqa: E402
from repro_torch.fed.flconfig import FLConfig as TFL  # noqa: E402
from test_torch_robust import (TOPK, engine_parity, engines,  # noqa: E402
                               fcn_spec, run_spec_file_through_both_clis)

ROOT = Path(__file__).resolve().parents[1]

MODELS = [("none", {}), ("fixed", {"delay": 2}),
          ("uniform", {"low": 1, "high": 4}),
          ("lognormal", {"scale": 2.0, "sigma": 1.0, "max_delay": 6}),
          ("straggler", {"frac": 0.3, "delay": 3, "jitter": 2}),
          ("straggler", {"frac": 0.5, "drop": True, "cohort": "head"}),
          ("straggler", {"frac": 0.4, "slow_tau": 1, "alpha": 1.0})]


@pytest.mark.parametrize("name,kw", MODELS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(MODELS)])
def test_latency_model_draws_match_jax(name, kw):
    K = 13
    for seed in (0, 4):
        jm, tm = jl.LATENCIES.get(name)(**kw), tl.LATENCIES.get(name)(**kw)
        jm.setup(K, seed)
        tm.setup(K, seed)
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        for _ in range(8):
            d = tm.sample_delays(tr, K)
            np.testing.assert_array_equal(d, jm.sample_delays(jr, K))
            assert d.dtype == np.int64
        np.testing.assert_array_equal(tr.rand(3), jr.rand(3))
        jt, tt = jm.sample_tau(K, 4), tm.sample_tau(K, 4)
        assert (jt is None) == (tt is None)
        if tt is not None:
            np.testing.assert_array_equal(tt, jt)
            assert tt.dtype == jt.dtype
        assert tm.max_staleness == jm.max_staleness
    s = np.array([0, 0, 1, 2, 5, 40], np.float32)
    w = tm.staleness_weight(torch.from_numpy(s))
    assert w.dtype == torch.float32
    assert (w[:2] == 1.0).all()
    np.testing.assert_allclose(
        w.numpy(), np.asarray(jm.staleness_weight(jnp.asarray(s))),
        rtol=1e-6)
    assert (np.diff(w.numpy()) <= 0).all()


def test_latency_registry_and_validation_match_jax():
    assert tl.NEVER == jl.NEVER
    from repro.fed.registry import LATENCIES as JL
    from repro_torch.fed.registry import LATENCIES as TLR
    assert TLR.names() == JL.names()
    for name in JL.names():
        assert TLR.valid_kw(name) == JL.valid_kw(name), name
    for bad in (dict(alpha=-1), dict(max_staleness=-1)):
        for mod in (jl, tl):
            with pytest.raises(ValueError, match="latency"):
                mod.LATENCIES.get("none")(**bad)
    for name, bad in (("fixed", dict(delay=-1)),
                      ("uniform", dict(low=3, high=1)),
                      ("lognormal", dict(sigma=-1)),
                      ("straggler", dict(frac=1.5)),
                      ("straggler", dict(cohort="tail")),
                      ("straggler", dict(slow_tau=0))):
        msgs = []
        for mod in (jl, tl):
            with pytest.raises(ValueError) as e:
                mod.LATENCIES.get(name)(**bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for cls, mod in ((JFL, jl), (TFL, tl)):
        with pytest.raises(ValueError, match="does not match"):
            mod.make_latency(_LatCfg())


class _LatCfg:
    latency, latency_kw, num_clients, seed = "fixed", {"speed": 1}, 4, 0


@pytest.mark.parametrize("kw", [
    dict(scheduler="buffered", use_lbgm=True, lbg_variant="dense"),
    dict(scheduler="buffered", use_lbgm=False),
    dict(scheduler="buffered", use_lbgm=True, lbg_variant="topk",
         fused_kernels=False),
    dict(scheduler="chunked", latency="fixed"),
    dict(latency="nope"),
    dict(attack="gaussian", attack_frac=0.2, attack_kw={"sgima": 2.0}),
    dict(aggregator="geometric_median", aggregator_kw={"iter": 5}),
    dict(scheduler="buffered", use_lbgm=True, lbg_variant="topk",
         latency="straggler", latency_kw={"fraction": 0.2}),
], ids=["dense-bank", "no-lbgm", "no-fused", "latency-needs-buffered",
        "unknown-latency", "attack-kw", "aggregator-kw", "latency-kw"])
def test_config_rejections_match_jax(kw):
    msgs = []
    for cls in (JFL, TFL):
        with pytest.raises(ValueError, match="FLConfig") as e:
            cls(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_buffered_configs_round_trip_in_both_packages():
    kw = dict(scheduler="buffered", use_lbgm=True, lbg_variant="topk",
              lbg_kw={"k_frac": 0.1}, latency="straggler",
              latency_kw={"frac": 0.2, "delay": 4, "max_staleness": 6},
              aggregator="geometric_median", dropout_frac=0.1)
    j, t = JFL(**kw), TFL(**kw)
    assert j.to_dict() == t.to_dict()
    assert TFL.from_dict(t.to_dict()) == t


# ------------------------------------------------------------ the engine

BUF = dict(TOPK, scheduler="buffered", chunk_size=3)

#: case -> (FLConfig overrides, rounds, must recycle)
ENGINE_CASES = {
    "straggler-mean": (dict(BUF, delta_threshold=0.9, latency="straggler",
                            latency_kw={"frac": 0.25, "delay": 2}), 6, True),
    "straggler-drop-evict": (dict(
        BUF, delta_threshold=0.9, latency="straggler",
        latency_kw={"frac": 0.5, "drop": True, "cohort": "head",
                    "max_staleness": 2}), 6, True),
    "fixed-evict-all": (dict(BUF, latency="fixed",
                             latency_kw={"delay": 3, "max_staleness": 1}),
                        8, False),
    "fixed-arrival-bytes": (dict(BUF, delta_threshold=0.9, latency="fixed",
                                 latency_kw={"delay": 1}), 5, True),
    "straggler-slow-tau": (dict(BUF, delta_threshold=0.9,
                                latency="straggler",
                                latency_kw={"frac": 0.5, "delay": 1,
                                            "slow_tau": 1}), 5, True),
    "straggler-int8-jitter": (dict(
        BUF, delta_threshold=0.9, codec="int8",
        codec_kw={"stochastic": False}, latency="straggler",
        latency_kw={"frac": 0.25, "delay": 2, "jitter": 2,
                    "max_staleness": 3}), 6, True),
    "uniform-gm-dropout": (dict(
        BUF, delta_threshold=0.9, num_clients=7, chunk_size=4,
        latency="uniform", latency_kw={"low": 0, "high": 2},
        aggregator="geometric_median", dropout_frac=0.2,
        sample_frac=0.8), 6, True),
    "lognormal-trimmed-sign": (dict(
        BUF, delta_threshold=0.9, latency="lognormal",
        latency_kw={"scale": 1.0, "max_delay": 3},
        aggregator="trimmed_mean", attack="sign_flip", attack_frac=0.25,
        attack_kw={"scale": 4.0}), 6, True),
    "straggler-scalar-median-int8-adaptive": (dict(
        BUF, delta_threshold=0.9, codec="int8",
        codec_kw={"stochastic": False}, latency="straggler",
        latency_kw={"frac": 0.25, "delay": 2},
        aggregator="scalar_median", attack="adaptive_scaled",
        attack_frac=0.25), 6, True),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_buffered_engine_parity(case):
    fl, rounds, recycle = ENGINE_CASES[case]
    jeng, teng = engine_parity(case, fl, rounds=rounds, recycle=recycle)
    assert teng._buffer["send"][next(iter(teng._buffer["send"]))][
        "val"].dtype == (torch.int8 if teng.codec.lossy else torch.float32)
    np.testing.assert_array_equal(teng._arrival, jeng._arrival)
    np.testing.assert_array_equal(teng._dispatch_round, jeng._dispatch_round)
    wires = [h["wire_bytes"] for h in teng.history]
    if case == "fixed-arrival-bytes":
        # delay 1, one slot a client: dispatch at even rounds, every byte
        # lands at the odd ones
        assert wires[0::2] == [0.0, 0.0, 0.0] and all(wires[1::2])
        assert teng.n_delivered == 2 * teng.cfg.num_clients
    if case == "fixed-evict-all":
        # every payload ages out at staleness 2 before its round-3 arrival
        assert teng.ledger.n_evicted == 3 * teng.cfg.num_clients
        assert teng.n_delivered == 0
        assert not any(wires)
    if case == "straggler-drop-evict":
        assert teng.ledger.n_evicted > 0


ZERO_LATENCY = {
    "plain": dict(delta_threshold=0.9),
    "sampling-dropout": dict(delta_threshold=0.9, sample_frac=0.7,
                             dropout_frac=0.25),
    "scalar-median": dict(delta_threshold=0.9, aggregator="scalar_median"),
    "gm-int8-attacked": dict(delta_threshold=0.9,
                             aggregator="geometric_median", codec="int8",
                             attack="sign_flip", attack_frac=0.34,
                             attack_kw={"scale": 4.0}),
    "fp8-pad": dict(delta_threshold=0.9, codec="fp8", num_clients=7,
                    chunk_size=4),
}


@pytest.mark.parametrize("case", sorted(ZERO_LATENCY))
def test_zero_latency_buffered_equals_chunked(case):
    """Histories equal as floats and params equal bit for bit."""
    fl = dict(TOPK, **{"chunk_size": 3, **ZERO_LATENCY[case]})
    out = []
    for sched in ("chunked", "buffered"):
        _, teng = engines(fcn_spec(scheduler=sched, **fl))
        rng = np.random.RandomState(1)
        out.append((teng, [teng.run_round(rng) for _ in range(4)]))
    (a, ha), (b, hb) = out
    assert ha == hb
    assert max(h["frac_scalar"] for h in ha) > 0
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert b.n_delivered > 0 and b.ledger.n_evicted == 0


def test_lm_client_loop_buffered_scalar_median_matches_jax():
    """Reduced qwen3 (2 layers, d 128, vocab 512, fp32) through the
    ``CLIENT_LOOP``: K=4 in chunks of 2, top-k 0.1 with the int8 wire
    (round to nearest), buffered with a straggler a round late,
    ``scalar_median`` and a ``sign_flip`` client; 3 rounds."""
    from test_torch_fl_lm import _assert_agree, _run_both, lm_spec
    from repro_torch.fed import engine as te
    d = lm_spec("qwen3-1.7b", num_clients=4, scheduler="buffered",
                chunk_size=2, delta_threshold=0.9, latency="straggler",
                latency_kw={"frac": 0.25, "delay": 1},
                aggregator="scalar_median", attack="sign_flip",
                attack_frac=0.25, attack_kw={"scale": 4.0}, codec="int8",
                codec_kw={"stochastic": False}, **TOPK)
    jeng, teng, jh, th = _run_both(d)
    assert getattr(teng.loss_fn, te.CLIENT_LOOP)
    assert teng.n_delivered == jeng.n_delivered
    _assert_agree("lm-buffered-scalar-median", jh, th, jeng.params, teng,
                  "float32", "qwen3-1.7b")


def test_async_spec_file_through_both_clis(tmp_path, monkeypatch):
    """``examples/specs/async_buffered.json`` as it is, 6 rounds: the head
    cohort's payloads, dispatched at round 0 four rounds late, arrive at
    round 4."""
    j, t = run_spec_file_through_both_clis(
        ROOT / "examples" / "specs" / "async_buffered.json", tmp_path,
        monkeypatch, rounds=6)
    wires = [r["wire_bytes"] for r in t["records"]]
    assert wires[4] > wires[3]

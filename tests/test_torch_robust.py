"""Byzantine-robust aggregation of the port against ``repro.fed.robust``.

Two levels, the same numpy inputs through both packages:

* **the rules** (``TrimmedMean`` at beta 0.1, 0.25 and 0,
  ``CoordinateMedian``, ``GeometricMedian`` with its 8 Weiszfeld steps,
  ``ScalarMedian``'s weighted median) on seeded stacks, with zero-weight
  rows holding NaN and with the clients permuted; and the collect
  adapters (``CollectSparseAggregator``, ``ScalarMedianSparseAggregator``)
  on sparse payload stacks in fp32 and behind the int8 wire's decode.
  Tolerance rtol 1e-6 (atol 1e-7), 1e-5 for the geometric median; the
  scalar median's pick is exact;
* **the engine** (:func:`engine_parity`, shared with
  ``test_torch_attacks.py`` and ``test_torch_buffered.py``): the paper FCN
  on label-skewed mixture data, K = 7 or 8, tau 2, lr 0.05, b 16, 3 rounds
  of both packages from the JAX package's initial params, across {vmap,
  chunked (K=7 in chunks of 4: one zero-weight pad client)} x {dense,
  top-k} x each rule, each under an attack. ``uplink_floats``,
  ``frac_scalar``, ``wire_bytes``, the savings, the delivered and evicted
  counts must be equal; loss rtol 1e-5; final params rtol 1e-4 / atol
  1e-6; no client's sin² within 1e-5 of delta, and a recycle round in
  every case that asks for one. The spec file
  ``examples/specs/robust_signflip_gm.json`` runs through both CLIs'
  ``main`` from the same params.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and spinning
# OpenMP threads would starve the other workers' threads
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.comm import wire as jw  # noqa: E402
from repro.fed import experiment as jexp  # noqa: E402
from repro.fed import robust as jr  # noqa: E402
from repro.fed.flconfig import FLConfig as JFL  # noqa: E402
from repro_torch.comm import wire as tw  # noqa: E402
from repro_torch.fed import experiment as texp  # noqa: E402
from repro_torch.fed import robust as tr  # noqa: E402
from repro_torch.fed.flconfig import FLConfig as TFL  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXACT = ("uplink_floats", "frac_scalar", "wire_bytes", "savings",
         "total_uplink", "vanilla_uplink", "total_wire_bytes",
         "wire_savings")
TOPK = {"lbg_variant": "topk", "lbg_kw": {"k_frac": 0.1}}
#: behind the stochastic int8/fp8 wire a float-level difference in a value
#: moves it across a rounding tie now and then (the uniforms are the JAX
#: package's, bit for bit): at most TIE_FRACTION of a leaf's elements may
#: sit off the params tolerance, each by at most TIE_ATOL, the rule of
#: ``test_torch_fl_lm.py`` (measured: 4 of fc1/w's 100,352 elements, by up
#: to 3.8e-5, in ``quantized_lbgm.json``'s 5 rounds; 6 by up to 2.1e-5 in
#: ``test_torch_host_bank.py``'s int8 case)
TIE_FRACTION = 1e-3
TIE_ATOL = 1e-3


def assert_params_close(t, j, msg, ties=False):
    """Params within rtol 1e-4 / atol 1e-6; with ``ties``, by the
    TIE_FRACTION rule."""
    if not ties:
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6, err_msg=msg)
        return
    diff = np.abs(t - j)
    off = diff > 1e-6 + 1e-4 * np.abs(j)
    assert off.sum() <= TIE_FRACTION * off.size, (msg, int(off.sum()))
    assert diff[off].max(initial=0.0) <= TIE_ATOL, (msg, diff[off].max())


# ------------------------------------------------------------- the rules

def _stacks(rng, K):
    return {"w": rng.randn(K, 5, 3).astype(np.float32),
            "b": rng.randn(K, 7).astype(np.float32),
            "c": rng.randn(K, 33).astype(np.float32)}


def _weights(rng, K, zero=()):
    w = rng.rand(K).astype(np.float32) + 0.05
    w[list(zero)] = 0.0
    return (w / w.sum()).astype(np.float32)


def _both(rule_j, rule_t, w, g):
    j = rule_j.reduce(jnp.asarray(w), {k: jnp.asarray(v)
                                       for k, v in g.items()})
    t = rule_t.reduce(torch.from_numpy(w),
                      {k: torch.from_numpy(v) for k, v in g.items()})
    return {k: np.asarray(v) for k, v in j.items()}, \
        {k: v.numpy() for k, v in t.items()}


RULES = {
    "trimmed-0.1": (lambda m: m.TrimmedMean(beta=0.1), 1e-6),
    "trimmed-0.25": (lambda m: m.TrimmedMean(beta=0.25), 1e-6),
    "trimmed-0": (lambda m: m.TrimmedMean(beta=0.0), 1e-6),
    "median": (lambda m: m.CoordinateMedian(), 1e-6),
    "gm": (lambda m: m.GeometricMedian(iters=8), 1e-5),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_jax(rule, seed):
    """Seeded stacks, K from 5 to 17, one or two zero-weight rows holding
    NaN (phantom padding) and one holding a huge finite value."""
    make, rtol = RULES[rule]
    rng = np.random.RandomState(seed)
    K = (5, 11, 17)[seed]
    g = _stacks(rng, K)
    zero = (1, K - 1) if seed else (2,)
    w = _weights(rng, K, zero)
    for k in g:
        g[k][zero[0]] = np.nan
        g[k][zero[-1]] = 1e30 if len(zero) > 1 else np.nan
    j, t = _both(make(jr), make(tr), w, g)
    for k in j:
        assert t[k].dtype == np.float32 and t[k].shape == j[k].shape
        assert np.isfinite(t[k]).all(), (rule, k)
        np.testing.assert_allclose(t[k], j[k], rtol=rtol, atol=1e-7,
                                   err_msg=f"{rule} {k}")


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_is_client_permutation_invariant(rule):
    make, rtol = RULES[rule]
    rng = np.random.RandomState(7)
    K = 9
    g = _stacks(rng, K)
    w = _weights(rng, K)
    perm = rng.permutation(K)
    j, _ = _both(make(jr), make(tr), w, g)
    _, t = _both(make(jr), make(tr), w[perm],
                 {k: v[perm] for k, v in g.items()})
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=10 * rtol, atol=1e-6,
                                   err_msg=f"{rule} {k}")


def test_trimmed_mean_beta0_is_the_weighted_mean():
    rng = np.random.RandomState(3)
    K = 7
    g = _stacks(rng, K)
    w = _weights(rng, K)
    _, t = _both(jr.TrimmedMean(0.0), tr.TrimmedMean(0.0), w, g)
    for k in t:
        ref = np.tensordot(w.astype(np.float64), g[k].astype(np.float64),
                           axes=1)
        np.testing.assert_allclose(t[k], ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("K", [4, 9, 20, 31])
def test_scalar_median_picks_the_jax_value(K):
    """The weighted median of the gscale scalars, with full-round clients
    at exactly 1, zero-weight rows at NaN, and ties: the same value."""
    rng = np.random.RandomState(K)
    for trial in range(20):
        w = _weights(rng, K, zero=(trial % K,))
        gs = rng.rand(K).astype(np.float32)
        gs[rng.rand(K) < 0.4] = 1.0
        gs[trial % K] = np.nan
        if trial % 3 == 0:
            w = np.where(w > 0, np.float32(1.0 / K), 0).astype(np.float32)
        j = np.asarray(jr.ScalarMedian().median(jnp.asarray(w),
                                                jnp.asarray(gs)))
        t = tr.ScalarMedian().median(torch.from_numpy(w),
                                     torch.from_numpy(gs)).numpy()
        assert t == j, (K, trial, t, j)


def test_rule_kw_validation_matches_jax():
    for mod in (jr, tr):
        with pytest.raises(ValueError, match="beta"):
            mod.TrimmedMean(beta=0.5)
        with pytest.raises(ValueError, match="iters"):
            mod.GeometricMedian(iters=0)
        with pytest.raises(ValueError, match="eps"):
            mod.GeometricMedian(eps=0.0)
    for mod, cls in ((jr, JFL), (tr, TFL)):
        with pytest.raises(ValueError, match="aggregator_kw"):
            cls(aggregator="trimmed_mean", aggregator_kw={"nope": 1})
        with pytest.raises(ValueError, match="does not match"):
            mod.make_robust_rule(_BadKw())
    from repro.fed.registry import AGGREGATORS as JA
    from repro_torch.fed.registry import AGGREGATORS as TA
    assert TA.names() == JA.names()
    for name in JA.names() + ["median", "gm"]:
        assert TA.valid_kw(name) == JA.valid_kw(name), name
        assert (name in TA) and (name in JA)


class _BadKw:
    """A config whose aggregator_kw the rule's constructor refuses."""
    aggregator = "coordinate_median"
    aggregator_kw = {"beta": 0.1}


# -------------------------------------------------- the collect adapters

def _payload(rng, params, k_frac, K, codec=None):
    """Sparse (idx, val) payload stacks in the bank's block layout (unique
    indices per row), gscale with recycle-round rhos and full-round 1s;
    behind ``codec`` the values are int8 with per-row scales."""
    from repro_torch.core.lbgm import _block_layout
    send = {}
    for name, shape in params.items():
        size = int(np.prod(shape))
        nb, block, kb = _block_layout(size, k_frac)
        idx = np.argsort(rng.rand(K, nb, block), axis=-1)[..., :kb]
        sk = {"idx": idx.astype(np.int32),
              "val": rng.randn(K, nb, kb).astype(np.float32)}
        if codec == "int8":
            sk["val"] = rng.randint(-127, 128, (K, nb, kb)).astype(np.int8)
            sk["scale"] = (2.0 ** rng.randint(-9, -3, (K, nb, 1))).astype(
                np.float32)
        send[name] = sk
    gscale = np.where(rng.rand(K) < 0.5, 1.0,
                      rng.randn(K)).astype(np.float32)
    return send, gscale


@pytest.mark.parametrize("adapter", ["collect-trimmed", "collect-gm",
                                     "scalar-median"])
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_sparse_adapters_match_jax(adapter, codec):
    rng = np.random.RandomState(11)
    params = {"w": (40, 30), "b": (30,)}
    K, k_frac = 7, 0.1
    send, gscale = _payload(rng, params, k_frac, K, codec)
    w = _weights(rng, K, zero=(3,))
    gscale[3] = np.nan
    for sk in send.values():
        if codec == "none":
            sk["val"][3] = np.nan
    jp = {k: jnp.zeros(s, jnp.float32) for k, s in params.items()}
    tp = {k: torch.zeros(s) for k, s in params.items()}
    jc = jw.make_codec(JFL(codec=codec))
    tc = tw.make_codec(TFL(codec=codec))
    jdec = jc.decode_leaf if jc.lossy else None
    tdec = tc.decode_leaf if tc.lossy else None

    def rule(m):
        return {"collect-trimmed": m.TrimmedMean(0.2),
                "collect-gm": m.GeometricMedian(iters=8),
                "scalar-median": m.ScalarMedian()}[adapter]
    cls = ("ScalarMedianSparseAggregator" if adapter == "scalar-median"
           else "CollectSparseAggregator")
    ja = getattr(jr, cls)(rule(jr), jp, k_frac, decode=jdec,
                          payload_keys=jc.payload_keys)
    ta = getattr(tr, cls)(rule(tr), tp, k_frac, decode=tdec,
                          payload_keys=tc.payload_keys)
    assert ta.payload_keys == ja.payload_keys and ta.collect and ta.sparse
    j = ja.reduce(jnp.asarray(w), (
        {n: {k: jnp.asarray(v) for k, v in sk.items()}
         for n, sk in send.items()}, jnp.asarray(gscale)))
    t = ta.reduce(torch.from_numpy(w), (
        {n: {k: torch.from_numpy(v) for k, v in sk.items()}
         for n, sk in send.items()}, torch.from_numpy(gscale)))
    rtol = 1e-5 if adapter == "collect-gm" else 1e-6
    for k, shape in params.items():
        assert tuple(t[k].shape) == shape
        assert np.isfinite(t[k].numpy()).all()
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=rtol, atol=1e-7, err_msg=k)


# ------------------------------------------------------------ the engine

def fcn_spec(rounds=3, **fl):
    base = dict(num_clients=8, tau=2, lr=0.05, batch_size=16, seed=0,
                delta_threshold=0.2)
    base.update(fl)
    return {"name": "robust", "model": {"name": "fcn", "kw": {}},
            "data": {"name": "mixture",
                     "kw": {"n": 1600, "n_eval": 200, "seed": 0}},
            "partition": {"name": "label_skew",
                          "kw": {"classes_per_client": 3, "seed": 0}},
            "fl": base, "rounds": rounds,
            "eval": {"every": 0, "final": False, "verbose": False}}


def engines(d):
    """Both packages' engines of spec dict ``d``, the port's from the JAX
    package's initial params, on the CPU."""
    jeng, _ = jexp.build_experiment(jexp.ExperimentSpec.from_dict(d))
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    teng, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(d),
                                    params=p0, device="cpu")
    assert teng._chunk == jeng._chunk and teng._pad == jeng._pad
    assert teng._sparse_agg == jeng._sparse_agg
    assert type(teng.agg).__name__ == type(jeng.agg).__name__
    np.testing.assert_array_equal(teng._byz, jeng._byz)
    return jeng, teng


def assert_runs_agree(case, jeng, teng, jh, th, recycle=True, ties=False):
    """Every check of the module docstring over two engines' histories;
    ``ties`` holds the params by the TIE_FRACTION rule (a stochastic
    wire)."""
    assert len(jh) == len(th)
    for r, (a, b) in enumerate(zip(jh, th)):
        assert set(a) == set(b), (case, r)
        for k in EXACT:
            assert a[k] == b[k], (case, r, k, a[k], b[k])
        assert np.isfinite(b["loss"]), (case, r)
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5,
                                   err_msg=f"{case} round {r}")
    assert teng.ledger.n_evicted == jeng.ledger.n_evicted, case
    assert getattr(teng, "n_delivered", None) == \
        getattr(jeng, "n_delivered", None), case
    assert teng.ledger.summary() == jeng.ledger.summary(), case
    for k, v in jeng.params.items():
        assert_params_close(teng.params[k].numpy(), np.asarray(v),
                            f"{case} {k}", ties)
    if teng.cfg.use_lbgm:
        delta = teng.cfg.delta_threshold
        margin = min(float(np.min(np.abs(s - delta)))
                     for s in teng.sin2_history)
        assert margin > 1e-5, (case, margin)
        if recycle:
            assert max(h["frac_scalar"] for h in th) > 0, \
                f"{case}: no recycle round to test"


def engine_parity(case, fl, rounds=3, recycle=True):
    """``rounds`` rounds of the FCN spec under ``fl`` in both packages,
    round by round from one seed; every check of the module docstring.
    Returns the two engines."""
    jeng, teng = engines(fcn_spec(rounds=rounds, **fl))
    jrng = np.random.RandomState(teng.cfg.seed + 1)
    trng = np.random.RandomState(teng.cfg.seed + 1)
    jh = [jeng.run_round(jrng) for _ in range(rounds)]
    th = [teng.run_round(trng) for _ in range(rounds)]
    assert_runs_agree(case, jeng, teng, jh, th, recycle=recycle)
    return jeng, teng


CHUNKED = dict(num_clients=7, scheduler="chunked", chunk_size=4)
SIGN = dict(attack="sign_flip", attack_frac=0.25, attack_kw={"scale": 4.0})
GAUSS = dict(attack="gaussian", attack_frac=0.25, attack_kw={"sigma": 0.5})
LABEL = dict(attack="label_flip", attack_frac=0.25, dropout_frac=0.2)
COLLUDE = dict(attack="colluding_sign", attack_frac=0.25)

#: {vmap, chunked} x {dense, top-k} x each rule, each under an attack.
#: The dense store recycles at delta 0.2 and top-k at 0.9 on this data
ENGINE_CASES = {
    "vmap-dense-trimmed-sign": dict(aggregator="trimmed_mean", **SIGN),
    "chunked-dense-trimmed-gauss": dict(CHUNKED, aggregator="trimmed_mean",
                                        aggregator_kw={"beta": 0.2},
                                        **GAUSS),
    "vmap-topk-trimmed-label": dict(TOPK, delta_threshold=0.9,
                                    aggregator="trimmed_mean", **LABEL),
    "chunked-topk-trimmed-sign": dict(TOPK, **CHUNKED, delta_threshold=0.9,
                                      aggregator="trimmed_mean", **SIGN),
    "vmap-dense-median-label": dict(aggregator="coordinate_median",
                                    **LABEL),
    "chunked-dense-median-sign": dict(CHUNKED, aggregator="median",
                                      **SIGN),
    "vmap-topk-median-gauss": dict(TOPK, delta_threshold=0.9,
                                   aggregator="coordinate_median", **GAUSS),
    "chunked-topk-median-collude": dict(TOPK, **CHUNKED, delta_threshold=0.9,
                                        aggregator="coordinate_median",
                                        **COLLUDE),
    "vmap-dense-gm-gauss": dict(aggregator="geometric_median", **GAUSS),
    "chunked-dense-gm-label": dict(CHUNKED, aggregator="gm", **LABEL),
    "vmap-topk-gm-sign": dict(TOPK, delta_threshold=0.9,
                              aggregator="geometric_median", **SIGN),
    "chunked-topk-gm-gauss": dict(TOPK, **CHUNKED, delta_threshold=0.9,
                                  aggregator="geometric_median",
                                  aggregator_kw={"iters": 4}, **GAUSS),
    "vmap-topk-scalar-median-sign": dict(TOPK, delta_threshold=0.9,
                                         aggregator="scalar_median",
                                         **SIGN),
    "chunked-topk-scalar-median-label": dict(TOPK, **CHUNKED,
                                             delta_threshold=0.9,
                                             aggregator="scalar_median",
                                             **LABEL),
    "chunked-topk-int8-scalar-median-collude": dict(
        TOPK, **CHUNKED, delta_threshold=0.9, aggregator="scalar_median",
        codec="int8", codec_kw={"stochastic": False}, **COLLUDE),
    "vmap-topk-int8-gm-sign": dict(
        TOPK, delta_threshold=0.9, aggregator="geometric_median",
        codec="int8", codec_kw={"stochastic": False}, **SIGN),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_rule_parity(case):
    engine_parity(case, ENGINE_CASES[case])


def test_scalar_median_refuses_the_dense_payload():
    for pkg in (jexp, texp):
        spec = pkg.ExperimentSpec.from_dict(fcn_spec(
            aggregator="scalar_median"))
        kw = {} if pkg is jexp else {"device": "cpu"}
        with pytest.raises(ValueError, match="no dense fallback"):
            pkg.build_experiment(spec, **kw)


def test_robust_spec_file_through_both_clis(tmp_path, monkeypatch):
    """``examples/specs/robust_signflip_gm.json`` as it is, 3 rounds,
    through ``repro.fed.run.main`` and ``repro_torch.fed.run.main``
    (``--device cpu``) from the JAX package's initial params: the same
    records and final eval."""
    run_spec_file_through_both_clis(
        ROOT / "examples" / "specs" / "robust_signflip_gm.json", tmp_path,
        monkeypatch)


def run_spec_file_through_both_clis(path, tmp_path, monkeypatch, rounds=3):
    from repro.fed import run as jrun
    from repro_torch.fed import run as trun
    d = json.loads(Path(path).read_text())
    jeng, _ = jexp.build_experiment(jexp.ExperimentSpec.from_dict(d))
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    del jeng
    real_build = texp.build_experiment

    def build(spec, params=None, device="cuda"):
        return real_build(spec, params=p0 if params is None else params,
                          device=device)
    monkeypatch.setattr(texp, "build_experiment", build)
    jout, tout = tmp_path / "j.json", tmp_path / "t.json"
    argv = ["--spec", str(path), "--rounds", str(rounds)]
    assert jrun.main(argv + ["--out", str(jout)]) == 0
    assert trun.main(argv + ["--device", "cpu", "--out", str(tout)]) == 0
    j, t = json.loads(jout.read_text()), json.loads(tout.read_text())
    assert len(j["records"]) == len(t["records"]) == rounds
    for a, b in zip(j["records"], t["records"]):
        for k in EXACT:
            assert a[k] == b[k], (k, a[k], b[k])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    for k, v in j["final_eval"].items():
        np.testing.assert_allclose(t["final_eval"][k], v, rtol=1e-4,
                                   err_msg=k)
    for k in ("total_uplink", "vanilla_uplink", "savings"):
        assert t[k] == j[k], (k, t[k], j[k])
    return j, t

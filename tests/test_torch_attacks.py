"""Byzantine attacks and fault injection of the port against
``repro.fed.attacks`` and the JAX engine's fault stream.

* ``select_byzantine``, ``fault_rng`` and every attack's ``round_extras``
  draw the same numbers;
* JAX's PRNG on the port's side: ``fold_in`` keys, the random bits under
  ``jax.random.normal`` equal bit for bit on the NumPy path
  (``core.jax_prng``) and on the tensor path (``random_bits_rows``); the
  normals within a few float32 ulps (rtol 1e-6, atol 1e-6: the port's
  ``log1p`` is not XLA's);
* each payload attack (``sign_flip``, ``scaled``, ``free_rider``,
  ``gaussian``, ``colluding_sign``, ``adaptive_scaled``) on the same
  stacks as the JAX attack vmapped over the clients: honest rows
  untouched, the rest equal (rtol 1e-6; the noise attacks to the normals'
  tolerance); ``label_flip`` corrupts the same labels;
* the engine's per-round fault stream (attack extras, then delays, then
  dropout draws, with the all-dropped fallback) equal draw for draw, on
  the thread of the prefetcher too;
* engine histories under the attacks the robust-rule cases of
  ``test_torch_robust.py`` leave out (:func:`engine_parity`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.fed import attacks as ja  # noqa: E402
from repro_torch.core import jax_prng as jp  # noqa: E402
from repro_torch.fed import attacks as ta  # noqa: E402
from test_torch_robust import (TOPK, engine_parity, engines,  # noqa: E402
                               fcn_spec)

SEEDS = np.array([0, 1, 17, 12345, 2 ** 31 - 2, 987654321], np.uint32)


def test_select_byzantine_and_fault_stream_match_jax():
    for K in (1, 6, 20, 100):
        for frac in (0.0, 0.1, 0.25, 0.5, 1.0):
            for seed in (0, 3, 11):
                np.testing.assert_array_equal(
                    ta.select_byzantine(K, frac, seed),
                    ja.select_byzantine(K, frac, seed))
    for seed in (0, 5):
        a, b = ta.fault_rng(seed), ja.fault_rng(seed)
        np.testing.assert_array_equal(a.rand(50), b.rand(50))
    for name in ("gaussian", "colluding_sign", "sign_flip"):
        jr, tr = ja.fault_rng(2), ta.fault_rng(2)
        for _ in range(3):
            j = ja.ATTACKS.get(name)().round_extras(jr, 9)
            t = ta.ATTACKS.get(name)().round_extras(tr, 9)
            assert j.keys() == t.keys()
            for k in j:
                np.testing.assert_array_equal(t[k], j[k])
                assert t[k].dtype == j[k].dtype


def test_registry_matches_jax():
    from repro.fed.registry import ATTACKS as JA
    from repro_torch.fed.registry import ATTACKS as TA
    assert TA.names() == JA.names()
    for name in JA.names():
        assert TA.valid_kw(name) == JA.valid_kw(name), name
    assert (ta.BYZ_KEY, ta.SEED_KEY, ta.CSEED_KEY, ta.STALE_KEY) == \
        (ja.BYZ_KEY, ja.SEED_KEY, ja.CSEED_KEY, ja.STALE_KEY)


@pytest.mark.parametrize("data", [0, 1, 5, 2 ** 31 + 3])
def test_fold_in_is_jax_bit_for_bit(data):
    for s in SEEDS:
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(int(s)),
                                             data))
        np.testing.assert_array_equal(jp.fold_in(jp.prng_key(int(s)), data),
                                      want)
    key = jp.fold_in_t(jp.prng_key_t(torch.from_numpy(
        SEEDS.astype(np.int64))), data)
    want = np.stack([np.asarray(jax.random.fold_in(
        jax.random.PRNGKey(int(s)), data)) for s in SEEDS])
    np.testing.assert_array_equal(
        np.stack([key[0].numpy(), key[1].numpy()], 1).astype(np.uint32),
        want)


@pytest.mark.parametrize("n", [1, 7, 1000, 70001])
def test_normal_bits_and_values_match_jax(n, monkeypatch):
    """The tensor path in pieces smaller than a row too (``_PIECE``)."""
    monkeypatch.setattr(jp, "_PIECE", 4096)
    keys = [jax.random.fold_in(jax.random.PRNGKey(int(s)), 3)
            for s in SEEDS]
    jbits = np.stack([np.asarray(jax.random.bits(k, (n,), jnp.uint32))
                      for k in keys])
    jnorm = np.stack([np.asarray(jax.random.normal(k, (n,), jnp.float32))
                      for k in keys])
    kt = jp.fold_in_t(jp.prng_key_t(torch.from_numpy(
        SEEDS.astype(np.int64))), 3)
    tbits = jp.random_bits_rows(kt, 0, n).numpy().astype(np.uint32)
    np.testing.assert_array_equal(tbits, jbits)
    np_bits = np.stack([jp.random_bits(jp.fold_in(jp.prng_key(int(s)), 3),
                                       (n,)) for s in SEEDS])
    np.testing.assert_array_equal(np_bits, jbits)
    tnorm = jp.normal_rows(kt, n).numpy()
    assert tnorm.dtype == np.float32 and np.isfinite(tnorm).all()
    np.testing.assert_allclose(tnorm, jnorm, rtol=1e-6, atol=1e-6)
    np_norm = np.stack([jp.normal(jp.fold_in(jp.prng_key(int(s)), 3), (n,))
                        for s in SEEDS])
    np.testing.assert_allclose(np_norm, jnorm, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------- the payload attacks

def _asg(rng, C, dtype=np.float32):
    return {"w": rng.randn(C, 6, 5).astype(dtype),
            "b": rng.randn(C, 5).astype(dtype),
            "a": rng.randn(C, 130).astype(dtype)}


ATTACK_CASES = {
    "sign_flip": ({"scale": 4.0}, 0.0),
    "scaled": ({"scale": 3.0}, 0.0),
    "free_rider": ({}, 0.0),
    "gaussian": ({"sigma": 0.5}, 1e-6),
    "colluding_sign": ({"scale": 2.0}, 1e-6),
    "adaptive_scaled": ({"scale": 4.0, "alpha": 0.5}, 1e-6),
}


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("name", sorted(ATTACK_CASES))
def test_payload_attack_matches_jax(name, stale):
    kw, rtol = ATTACK_CASES[name]
    rng = np.random.RandomState(4)
    C = 6
    asg = _asg(rng, C)
    byz = np.array([1, 0, 1, 0, 0, 1], np.float32)
    jatk, tatk = ja.make_attack(_Cfg(name, kw)), ta.make_attack(_Cfg(name,
                                                                     kw))
    extras = jatk.round_extras(ja.fault_rng(1), C)
    if stale:
        extras[ja.STALE_KEY] = np.array([0, 3, 1, 0, 7, 2], np.float32)
    j = jax.vmap(lambda a, b, e: jatk.apply(a, b, e))(
        {k: jnp.asarray(v) for k, v in asg.items()}, jnp.asarray(byz),
        {k: jnp.asarray(v) for k, v in extras.items()})
    t = tatk.apply({k: torch.from_numpy(v) for k, v in asg.items()},
                   torch.from_numpy(byz),
                   {k: torch.from_numpy(v.astype(np.int64)
                                        if v.dtype == np.uint32 else v)
                    for k, v in extras.items()})
    for k in asg:
        tk, jk = t[k].numpy(), np.asarray(j[k])
        assert tk.dtype == jk.dtype
        np.testing.assert_array_equal(tk[byz == 0], asg[k][byz == 0])
        np.testing.assert_allclose(tk, jk, rtol=rtol, atol=rtol,
                                   err_msg=f"{name} {k}")
    assert tatk.apply(asg, None, {}) is asg


def test_payload_attacks_keep_bf16_leaves():
    rng = np.random.RandomState(5)
    asg = {k: torch.from_numpy(v).to(torch.bfloat16)
           for k, v in _asg(rng, 3).items()}
    byz = torch.tensor([0.0, 1.0, 1.0])
    seeds = {ta.SEED_KEY: torch.tensor([3, 4, 5]),
             ta.CSEED_KEY: torch.tensor([9, 9, 9])}
    for name, (kw, _) in ATTACK_CASES.items():
        out = ta.make_attack(_Cfg(name, kw)).apply(asg, byz, seeds)
        for k, v in out.items():
            assert v.dtype == torch.bfloat16 and v.shape == asg[k].shape
            assert torch.equal(v[0], asg[k][0])


class _Cfg:
    def __init__(self, attack, kw):
        self.attack, self.attack_kw = attack, kw


def test_label_flip_matches_jax():
    y = np.random.RandomState(0).randint(0, 10, 50).astype(np.int32)
    d = {"x": np.zeros((50, 3), np.float32), "y": y}
    jt = ja.make_attack(_Cfg("label_flip", {})).corrupt(d)
    tt = ta.make_attack(_Cfg("label_flip", {"num_classes": 10})).corrupt(d)
    np.testing.assert_array_equal(tt["y"], jt["y"])
    assert tt["y"].dtype == np.int32 and tt["x"] is d["x"]
    for mod in (ja, ta):
        with pytest.raises(ValueError, match="integer labels"):
            mod.make_attack(_Cfg("label_flip", {})).corrupt({"x": y})
        with pytest.raises(ValueError, match="attack_kw"):
            mod.make_attack(_Cfg("sign_flip", {"sigma": 1.0}))
        assert mod.make_attack(_Cfg(None, None)) is None


# ------------------------------------------------- the engine's streams

def _host(x, K):
    """A JAX chunked batch leaf, (n_chunks, chunk, ...), as (K, ...)."""
    x = np.asarray(x)
    return x.reshape((-1,) + x.shape[2:])[:K]


@pytest.mark.parametrize("fl", [
    dict(attack="gaussian", attack_frac=0.3, dropout_frac=0.9,
         sample_frac=0.5, scheduler="chunked", chunk_size=3),
    dict(TOPK, attack="colluding_sign", attack_frac=0.3, dropout_frac=0.3,
         scheduler="buffered", chunk_size=3, latency="straggler",
         latency_kw={"frac": 0.5, "delay": 2, "jitter": 2,
                     "max_staleness": 2}),
    dict(TOPK, attack="adaptive_scaled", attack_frac=0.5,
         scheduler="buffered", chunk_size=4, latency="uniform",
         latency_kw={"low": 0, "high": 3}, codec="int8"),
], ids=["gaussian-dropout-fallback", "buffered-jitter-evict",
        "buffered-uniform-int8"])
def test_fault_stream_matches_jax_round_by_round(fl):
    """Six rounds of each engine's own host draws: the batch dict's
    reserved keys, the delivery plan and every stream's state after each
    round are equal (dropout_frac 0.9 at K=7 empties some cohorts)."""
    jeng, teng = engines(fcn_spec(num_clients=7, **fl))
    jrng, trng = np.random.RandomState(1), np.random.RandomState(1)
    K = 7
    for r in range(6):
        jb, tb = jeng._sample_batches(jrng), teng._sample_batches(trng)
        assert set(jb) == set(tb)
        for k in jb:
            if k.startswith("_"):
                np.testing.assert_array_equal(
                    tb[k][:K], _host(jb[k], K).astype(tb[k].dtype),
                    err_msg=f"round {r} {k}")
        jm, tm = jeng._sample_mask(jrng), teng._sample_mask(trng)
        if isinstance(jm, dict):
            assert jm.keys() == tm.keys()
            for k in jm:
                np.testing.assert_array_equal(tm[k], jm[k],
                                              err_msg=f"round {r} {k}")
        else:
            np.testing.assert_array_equal(tm, jm, err_msg=f"round {r}")
            assert tm.sum() >= 1
        for a, b in ((trng, jrng), (teng._fault_rng, jeng._fault_rng),
                     (teng._codec_rng, jeng._codec_rng)):
            sa, sb = a.get_state(), b.get_state()
            np.testing.assert_array_equal(sa[1], sb[1])
            assert sa[2:] == sb[2:]


def test_prefetcher_draws_the_fault_stream_in_order():
    """The port's run with its prefetch thread equals its synchronous run
    and the JAX engine's run (which prefetches too)."""
    fl = dict(TOPK, delta_threshold=0.9, attack="gaussian",
              attack_frac=0.25, dropout_frac=0.3, scheduler="buffered",
              chunk_size=4, latency="straggler",
              latency_kw={"frac": 0.25, "delay": 1, "jitter": 1})
    jeng, teng = engines(fcn_spec(**fl))
    _, teng_sync = engines(fcn_spec(**fl))
    th = teng.run(4, prefetch=True)
    ts = teng_sync.run(4, prefetch=False)
    jh = jeng.run(4)
    for a, b, c in zip(th, ts, jh):
        assert a == b
        for k in ("uplink_floats", "frac_scalar", "wire_bytes"):
            assert a[k] == c[k], (k, a[k], c[k])
    assert teng.n_delivered == teng_sync.n_delivered == jeng.n_delivered
    for k in teng.params:
        assert torch.equal(teng.params[k], teng_sync.params[k])


ENGINE_CASES = {
    "vmap-dense-mean-gaussian": dict(attack="gaussian", attack_frac=0.25),
    "chunked-topk-mean-scaled-dropout": dict(
        TOPK, num_clients=7, scheduler="chunked", chunk_size=4,
        delta_threshold=0.9, attack="scaled", attack_frac=0.3,
        dropout_frac=0.25),
    "vmap-topk-trimmed-free-rider": dict(
        TOPK, delta_threshold=0.9, aggregator="trimmed_mean",
        attack="free_rider", attack_frac=0.25),
    "chunked-dense-median-adaptive": dict(
        num_clients=7, scheduler="chunked", chunk_size=4,
        aggregator="coordinate_median", attack="adaptive_scaled",
        attack_frac=0.3),
    "vmap-dense-mean-dropout": dict(dropout_frac=0.3, sample_frac=0.8),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_attack_parity(case):
    engine_parity(case, ENGINE_CASES[case])

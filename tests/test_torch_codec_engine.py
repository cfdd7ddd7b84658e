"""The wire codecs, both packages: 5-round histories.

In the style of ``tests/test_torch_engine.py``: the fig5-sized spec (FCN,
K=20, tau=2, lr=0.05, b=16, label skew with 3 classes per client) runs 5
rounds in the JAX package and in the port (``device="cpu"``) from the same
initial params, under

* the top-k store (k_frac 0.1, delta 0.9) with each codec — ``delta_idx``
  and round-to-nearest ``int8`` and ``fp8`` — on the vmap and chunked
  schedulers, the K=7 chunk-4 case that pads a zero-weight client, and
  ``sample_frac=0.6``;
* vanilla FL (``use_lbgm=False``) with the int8 codec.

``uplink_floats``, ``frac_scalar``, ``wire_bytes``, ``savings``,
``total_wire_bytes`` and ``wire_savings`` must match exactly; loss rtol
1e-5; final params rtol 1e-4 / atol 1e-6. No client's sin^2 may lie
within 1e-5 of delta, and every LBGM case must recycle at least once.
:func:`parity_run` is the harness; ``test_torch_compressor_engine.py``
runs it over the compressor stacks.

Two float-level effects can part the histories for no real reason, and
the test rules both out instead of loosening a tolerance:

* a sin^2 next to delta (the margin above);
* a bank row whose maximum is exactly qmax * 2^k at an exponent where
  XLA's CPU ``log2`` is off (ROADMAP §3): the JAX package then re-encodes
  it on a grid twice as coarse. After every JAX round the test recomputes
  both packages' scales from the JAX bank's row maxima and requires them
  equal. No case here hits such a row.

A third cannot be ruled out: a value that sits within a float's error of
a rounding tie, which the two packages' gradients (sums in another order)
round to neighbouring grid points. The top-k cases quantize ~10^5 values
per round and none flips there; vanilla int8 quantizes every parameter
of every client, ~2*10^6 per round, and a handful flip. Each flipped
element of the params then differs by whole grid steps of lr * w * scale
(1.25e-5 here), so that case holds every element to rtol 1e-4 / atol 1e-6
except at most 0.1% of each leaf, which must lie within 5e-5 (four such
steps). The spec file ``examples/specs/quantized_lbgm.json`` runs through
both packages as it is.
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
from repro_torch.comm import wire as tw  # noqa: E402
from repro_torch.fed import experiment as texp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXACT = ("uplink_floats", "frac_scalar", "wire_bytes", "savings",
         "total_uplink", "vanilla_uplink", "total_wire_bytes",
         "wire_savings")
TOPK = {"lbg_variant": "topk", "lbg_kw": {"k_frac": 0.1},
        "delta_threshold": 0.9}
NEAREST = {"stochastic": False}

CASES = {
    "vmap-delta_idx": dict(TOPK, codec="delta_idx"),
    "vmap-int8": dict(TOPK, codec="int8", codec_kw=NEAREST),
    "vmap-fp8": dict(TOPK, codec="fp8", codec_kw=NEAREST),
    "chunked-int8": dict(TOPK, codec="int8", codec_kw=NEAREST,
                         scheduler="chunked", chunk_size=8),
    "chunked-fp8-pad": dict(TOPK, codec="fp8", codec_kw=NEAREST,
                            num_clients=7, scheduler="chunked",
                            chunk_size=4),
    "chunked-int8-sampled": dict(TOPK, codec="int8", codec_kw=NEAREST,
                                 scheduler="chunked", chunk_size=8,
                                 sample_frac=0.6),
    "vmap-vanilla-int8": dict(use_lbgm=False, codec="int8",
                              codec_kw=NEAREST),
}


def fig5_spec(rounds=5, **fl):
    base = dict(num_clients=20, tau=2, lr=0.05, batch_size=16, seed=0,
                delta_threshold=0.2)
    base.update(fl)
    return {"name": "fig5", "model": {"name": "fcn", "kw": {}},
            "data": {"name": "mixture",
                     "kw": {"n": 2000, "n_eval": 500, "seed": 0}},
            "partition": {"name": "label_skew",
                          "kw": {"classes_per_client": 3, "seed": 0}},
            "fl": base, "rounds": rounds,
            "eval": {"every": 0, "final": False, "verbose": False}}


def _engines(d):
    jeng, _ = jexp.build_experiment(jexp.ExperimentSpec.from_dict(d))
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    teng, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(d),
                                    params=p0, device="cpu")
    return jeng, teng


def _assert_no_log2_caveat_row(jeng, case, r):
    """Both packages' scales of the JAX bank's rows agree (no row at an
    exponent where XLA's log2 is off)."""
    codec = jeng.codec
    if not codec.lossy or not isinstance(jeng.lbg, dict):
        return
    for name, leaf in jeng.lbg.items():
        m = np.abs(np.asarray(leaf["val"])).max(-1)
        js = np.asarray(jw.pow2_scale(jnp.asarray(m), codec.qmax))
        ts = tw.pow2_scale(torch.from_numpy(m), codec.qmax).numpy()
        hit = np.argwhere(js != ts)
        assert hit.size == 0, (case, r, name, m[tuple(hit[0])])


def _assert_histories_agree(case, jh, th, teng):
    for r, (a, b) in enumerate(zip(jh, th)):
        for k in EXACT:
            assert a[k] == b[k], (case, r, k, a[k], b[k])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5,
                                   err_msg=f"{case} round {r}")
    if teng.cfg.use_lbgm:
        delta = teng.cfg.delta_threshold
        margin = min(float(np.min(np.abs(s - delta)))
                     for s in teng.sin2_history)
        assert margin > 1e-5, (case, margin)
        assert max(h["frac_scalar"] for h in th) > 0, \
            f"{case}: no recycle round to test"


def parity_run(case, fl):
    """5 rounds of both packages from the same params; every check of the
    module docstring."""
    d = fig5_spec(**fl)
    jeng, teng = _engines(d)
    assert teng._chunk == jeng._chunk and teng._pad == jeng._pad
    assert teng._sparse_agg == jeng._sparse_agg
    assert teng._use_ef == jeng._use_ef
    assert type(teng.agg).__name__ == type(jeng.agg).__name__
    if "pad" in case:
        assert teng._pad > 0
    jrng = np.random.RandomState(teng.cfg.seed + 1)
    trng = np.random.RandomState(teng.cfg.seed + 1)
    jh, th = [], []
    for r in range(5):
        jh.append(jeng.run_round(jrng))
        th.append(teng.run_round(trng))
        _assert_no_log2_caveat_row(jeng, case, r)
    _assert_histories_agree(case, jh, th, teng)
    dense_quantized = teng.codec.lossy and not teng.cfg.use_lbgm
    for k, v in jeng.params.items():
        t, j = teng.params[k].numpy(), np.asarray(v)
        if dense_quantized:          # rounding-tie flips, see the docstring
            off = np.abs(t - j) > 1e-6 + 1e-4 * np.abs(j)
            assert off.mean() <= 1e-3, (k, int(off.sum()))
            t = np.where(off, j, t)
            np.testing.assert_allclose(teng.params[k].numpy(), j,
                                       rtol=0, atol=5e-5, err_msg=k)
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6, err_msg=k)
    if teng._use_ef:
        for k, v in jeng.residual.items():
            np.testing.assert_allclose(teng.residual[k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_uplink_parity(case):
    parity_run(case, CASES[case])


# ------------------------------------------------ one spec, both packages


def test_quantized_spec_file_runs_in_both_packages():
    """examples/specs/quantized_lbgm.json, read as it is, with
    codec_kw={"stochastic": false} and 3 rounds, through both packages'
    run_experiment from the same initial params."""
    with open(ROOT / "examples" / "specs" / "quantized_lbgm.json") as f:
        d = json.load(f)
    d["fl"]["codec_kw"] = {"stochastic": False}
    d["rounds"] = 3
    d["eval"] = {"every": 0, "final": False, "verbose": False}
    jspec = jexp.ExperimentSpec.from_dict(d)
    jres = jexp.run_experiment(jspec)
    jeng, _ = jexp.build_experiment(jspec)
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    tres = texp.run_experiment(texp.ExperimentSpec.from_dict(d),
                               device="cpu", params=p0)
    assert len(tres.history) == len(jres.history) == 3
    for a, b in zip(jres.history, tres.history):
        for k in EXACT:
            assert a[k] == b[k], (k, a[k], b[k])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    assert max(h["frac_scalar"] for h in tres.history) > 0
    # and the file as it is (stochastic int8, its own eval policy) runs in
    # the port
    spec = texp.ExperimentSpec.load(
        str(ROOT / "examples" / "specs" / "quantized_lbgm.json"))
    res = texp.run_experiment(spec, rounds=2, device="cpu", params=p0)
    assert len(res.history) == 2 and res.history[1]["frac_scalar"] > 0
    assert np.isfinite(res.final_eval["test_loss"])


# ------------------------------------------------ stochastic rounding


def _quantized_spec_file():
    with open(ROOT / "examples" / "specs" / "quantized_lbgm.json") as f:
        d = json.load(f)
    d["rounds"] = 5
    d["eval"] = {"every": 0, "final": False, "verbose": False}
    return d


def _fp8_spec(**fl):
    from test_torch_robust import fcn_spec
    return fcn_spec(rounds=3, **dict(TOPK, codec="fp8", **fl))


STOCHASTIC = {
    # the spec file as it is: stochastic int8 (codec_kw null), 5 rounds
    "int8-spec-file": _quantized_spec_file,
    "fp8-topk-vmap": _fp8_spec,
    "fp8-topk-chunked-pad": lambda: _fp8_spec(
        num_clients=7, scheduler="chunked", chunk_size=4),
}


@pytest.mark.parametrize("case", sorted(STOCHASTIC))
def test_stochastic_codec_matches_jax(case):
    """The codecs' default, stochastic rounding, through both packages'
    engines from the JAX package's params: the uniforms are the JAX
    package's (``fold_in(PRNGKey(seed), leaf)``), so the exact fields are
    equal, loss within rtol 1e-5 and params within rtol 1e-4 / atol 1e-6,
    a rounding tie by the TIE_FRACTION rule (the spec file: 4 of fc1/w's
    100,352 elements, by up to 3.8e-5). With the counter-hash uniforms
    of before, the spec file parted by up to 7.2e-5 in loss and the fp8
    run by 8.0e-4 at round 2."""
    from test_torch_robust import assert_runs_agree, engines
    d = STOCHASTIC[case]()
    assert "stochastic" not in (d["fl"].get("codec_kw") or {})
    jeng, teng = engines(d)
    assert teng.codec.stochastic and jeng.codec.stochastic
    rounds = d["rounds"]
    jrng = np.random.RandomState(teng.cfg.seed + 1)
    trng = np.random.RandomState(teng.cfg.seed + 1)
    jh = [jeng.run_round(jrng) for _ in range(rounds)]
    th = [teng.run_round(trng) for _ in range(rounds)]
    assert_runs_agree(case, jeng, teng, jh, th, ties=True)


def _payload_capture(monkeypatch):
    """Record every payload row block the int8 codecs quantize (the
    fc1/w-sized ones): the JAX package's through a debug callback, one
    (nb, kb) client at a time, the port's as (C, nb, kb) chunks."""
    import jax
    jax_rows, port_rows = [], []
    jq, tq = jw.Int8Codec.quantize, tw.Int8Codec.quantize

    def jquant(self, val, key):
        if val.shape[-1] > 1000:
            jax.debug.callback(lambda v: jax_rows.append(np.array(v)), val)
        return jq(self, val, key)

    def tquant(self, val, seed, leaf, row0=0):
        if val.shape[-1] > 1000:
            port_rows.extend(val.numpy().copy())
        return tq(self, val, seed, leaf, row0)
    monkeypatch.setattr(jw.Int8Codec, "quantize", jquant)
    monkeypatch.setattr(tw.Int8Codec, "quantize", tquant)
    return jax_rows, port_rows


def test_stochastic_int8_parts_from_jax_by_payload_order(monkeypatch):
    """Stochastic int8 at d_model 704 parts from the JAX package by
    payload order, within the reference's own floor (ROADMAP §3, closed
    fault 1).

    The spec is ``test_torch_sharded_ranks.py``'s FCN (d_model 704, K=10,
    chunks of 5, sample_frac 0.5, top-k at k_frac 0.1) with the int8
    codec's default stochastic rounding, from the JAX package's params.
    fc1/w's payload is (16, 3449) a client. In round 1:

    * every payload row holds the same values in both packages, up to
      the gradients' float error (sorted rows within rtol 2e-6);
    * the positions that hold another value are few (at most 1e-3 of the
      payload) and each is one of a near tie: its |value| is within
      1e-6 of another such position's, so the block top-k in value order
      (ties to the lower index, both packages) ranks them by their last
      bits, which the gradients' sums in another order set apart.

    Stochastic rounding draws its uniform by payload position, so a value
    at another position draws another uniform and may land on the other
    grid point. Given JAX's own gradient bits the port places and codes
    every value as JAX does
    (:func:`test_stochastic_int8_payload_bits_equal_jax_on_jax_gradients`),
    and a one-ulp nudge of the initial params parts each package from
    itself as far: after 3 rounds the EXACT fields are equal and the
    params and loss are held at :data:`INT8_D704_TOL`."""
    from int8_nudge_floor import (INT8_D704_TOL, assert_at_int8_floor,
                                  d704_spec)
    jax_rows, port_rows = _payload_capture(monkeypatch)
    d = d704_spec()
    jeng, teng = _engines(d)
    assert teng.codec.stochastic and jeng.codec.stochastic
    jrng, trng = np.random.RandomState(1), np.random.RandomState(1)
    jh, th = [jeng.run_round(jrng)], [teng.run_round(trng)]
    assert len(jax_rows) == len(port_rows) == 10
    assert jax_rows[0].shape == (16, 3449)
    moved = 0
    for a in jax_rows:
        # the port's client whose sorted rows these are (the callback's
        # order is not the clients')
        b = min(port_rows, key=lambda b: float(
            np.abs(np.sort(a, -1) - np.sort(b, -1)).sum()))
        np.testing.assert_allclose(np.sort(b, -1), np.sort(a, -1),
                                   rtol=2e-6, atol=0)
        for ra, rb in zip(a, b):
            pos = np.flatnonzero(np.abs(ra - rb) > 1e-4 * np.abs(ra))
            moved += pos.size
            mag = np.abs(ra[pos])
            for p in pos:
                twin = np.abs(mag - abs(ra[p])) <= 1e-6 * abs(ra[p])
                assert twin.sum() >= 2, (p, ra[p], rb[p])
                assert np.any(np.abs(ra[pos] - rb[p]) <= 2e-6 * abs(rb[p]))
    assert 0 < moved <= 1e-3 * sum(a.size for a in jax_rows), moved
    for _ in range(d["rounds"] - 1):
        jh.append(jeng.run_round(jrng))
        th.append(teng.run_round(trng))
    for r, (a, b) in enumerate(zip(jh, th)):
        for k in EXACT:
            assert a[k] == b[k], (r, k, a[k], b[k])
        np.testing.assert_allclose(b["loss"], a["loss"],
                                   rtol=INT8_D704_TOL["loss_rtol"])
    assert max(h["frac_scalar"] for h in th) > 0
    for k, v in jeng.params.items():
        assert_at_int8_floor(k, teng.params[k].numpy(), np.asarray(v))


def test_stochastic_int8_payload_bits_equal_jax_on_jax_gradients(
        monkeypatch):
    """The port's value-order decision and stochastic int8 encoder, fed
    the JAX package's own fc1/w gradient bits (captured through debug
    callbacks, as :func:`_payload_capture` does), give JAX's payload
    positions, values, int8 codes and row scales bit for bit, for every
    client that sends its top-k over 3 rounds of the d_model 704 spec.
    So the port's parting from JAX (the test above) comes from the
    gradients' last bits, not from the decision or the codec."""
    import jax
    from int8_nudge_floor import d704_spec
    from repro.fed import engine as jeng_mod
    from repro_torch.core.lbgm import _block_layout
    from repro_torch.kernels import ops

    steps, encoded = [], []
    step0 = jeng_mod.TopKLBGStore.sparse_client_step
    encode0 = jw._QuantizedCodec.encode_sparse
    keep = lambda out: (lambda *a: out.append([np.array(x) for x in a]))

    def step(self, grad, lbg_k):
        out = step0(self, grad, lbg_k)
        (send, _), _, stats = out
        jax.debug.callback(keep(steps), grad["fc1/w"],
                           send["fc1/w"]["idx"], send["fc1/w"]["val"],
                           stats.sent_scalar)
        return out

    def encode(self, out, new_lbg, stats, seed):
        res = encode0(self, out, new_lbg, stats, seed)
        (send, _), _, _ = res
        jax.debug.callback(keep(encoded), out[0]["fc1/w"]["val"],
                           send["fc1/w"]["val"], send["fc1/w"]["scale"],
                           seed)
        return res
    monkeypatch.setattr(jeng_mod.TopKLBGStore, "sparse_client_step", step)
    monkeypatch.setattr(jw._QuantizedCodec, "encode_sparse", encode)
    d = d704_spec()
    jeng, _ = jexp.build_experiment(jexp.ExperimentSpec.from_dict(d))
    rng = np.random.RandomState(1)
    for _ in range(d["rounds"]):
        jeng.run_round(rng)
    assert len(steps) == len(encoded) == 30
    nb, block, kb = _block_layout(784 * 704, 0.1)
    codec = tw.Int8Codec()
    bits = lambda x: np.asarray(x).view(np.int32)
    full = 0
    for g, idx, val, scalar in steps:
        if scalar:
            continue
        full += 1
        _, _, ti, tv = ops.lbgm_sparse_decision(
            torch.from_numpy(g).reshape(1, -1),
            torch.zeros((1, nb, kb), dtype=torch.int32), block=block)
        np.testing.assert_array_equal(ti[0].numpy(), idx)
        np.testing.assert_array_equal(bits(tv[0].numpy()), bits(val))
        # the codec call of this client: the one that quantized its values
        (_, q, scale, seed), = [e for e in encoded
                                if np.array_equal(bits(e[0]), bits(val))]
        # fc1/w is leaf 1 of the sorted leaves
        tq, ts = codec.quantize(tv, torch.tensor([int(seed)]), 1)
        np.testing.assert_array_equal(tq[0].numpy(), q)
        np.testing.assert_array_equal(bits(ts[0].numpy()), bits(scale))
    assert full == 20, full

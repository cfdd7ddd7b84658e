"""Codec contracts on the port's engine, and its stochastic rounding.

The contract tests of ``tests/test_wire.py`` (byte oracles, the >= 3x
int8 byte cut, 1-byte scalar rounds, the lossy-codec guard, no seeds
drawn by a deterministic codec) run on the port. Stochastic rounding
replays the JAX package's threefry uniforms bit for bit (the engine
histories are held against the JAX package's in
``test_torch_codec_engine.py``); here the stochastic codecs are also held
to statistics: the same history from the same spec twice, and an
unbiased round-1 aggregate whose noise is the size of the JAX package's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and spinning
# OpenMP threads would starve the other workers' threads
torch.set_num_threads(1)

from repro.fed import experiment as jexp  # noqa: E402
from repro_torch.comm import wire as tw  # noqa: E402
from repro_torch.core.lbgm import _block_layout  # noqa: E402
from repro_torch.fed import experiment as texp  # noqa: E402
from test_torch_codec_engine import TOPK, _engines, fig5_spec  # noqa: E402

# ------------------------------------------------------- stochastic codecs


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_stochastic_codec_same_spec_same_history(codec):
    d = fig5_spec(rounds=3, **dict(TOPK, codec=codec))
    spec = texp.ExperimentSpec.from_dict(d)
    a = texp.run_experiment(spec, device="cpu")
    b = texp.run_experiment(spec, device="cpu")
    assert a.history == b.history
    assert max(h["frac_scalar"] for h in a.history) > 0


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_stochastic_round_one_is_unbiased(codec):
    """Round 1 is a full round for every client: the params after it are
    p0 - lr * sum_c w_c * dequant(quant(payload_c)). Over N codec streams
    the stochastic aggregate averages to the unquantized one (the error of
    the mean shrinks as 1/sqrt(N), where a biased rounding's would not),
    and a single stream's error is the size of the JAX package's."""
    N = 24
    d = fig5_spec(rounds=1, **dict(TOPK, codec=codec, num_clients=8))
    plain = fig5_spec(rounds=1, **dict(TOPK, num_clients=8))
    jeng, teng0 = _engines(plain)
    teng0.run_round(np.random.RandomState(1))
    p_none = {k: v.numpy().astype(np.float64) for k, v in
              teng0.params.items()}
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    errs, mean = [], {k: np.zeros_like(v) for k, v in p_none.items()}
    for n in range(N):
        teng, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(d),
                                        params=p0, device="cpu")
        teng._codec_rng = np.random.RandomState(1000 + n)
        m = teng.run_round(np.random.RandomState(1))
        assert m["frac_scalar"] == 0.0
        p = {k: v.numpy().astype(np.float64) for k, v in
             teng.params.items()}
        errs.append(sum(float(((p[k] - p_none[k]) ** 2).sum())
                        for k in p))
        for k in p:
            mean[k] += p[k] / N
    rms = float(np.mean(errs)) ** 0.5
    mean_err = sum(float(((mean[k] - p_none[k]) ** 2).sum())
                   for k in p_none) ** 0.5
    assert rms > 0
    assert mean_err < 2.0 * rms / N ** 0.5, (mean_err, rms)
    jd = jexp.ExperimentSpec.from_dict(d)
    jeng, _ = jexp.build_experiment(jd)
    jeng.run_round(np.random.RandomState(1))
    jerr = sum(float(((np.asarray(v, np.float64) - p_none[k]) ** 2).sum())
               for k, v in jeng.params.items()) ** 0.5
    assert 0.5 < jerr / rms < 2.0, (jerr, rms)


# ---------------------------------------------- contracts (test_wire.py)


def _port(K=6, **fl):
    d = fig5_spec(rounds=3, **dict(fl, num_clients=K))
    d["data"]["kw"]["n"] = 1200
    eng, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(d),
                                   device="cpu")
    return eng


def _rounds(eng, n=3):
    rng = np.random.RandomState(0)
    return [eng.run_round(rng) for _ in range(n)]


def test_vanilla_dense_int8_wire_byte_oracle():
    """use_lbgm=False + int8: every participant ships M 1-byte values and
    one 4-byte scale per leaf."""
    eng = _port(codec="int8", use_lbgm=False)
    h = _rounds(eng, 2)
    M = sum(int(p.numel()) for p in eng.params.values())
    L, K = len(eng.params), eng.cfg.num_clients
    for e in h:
        assert e["wire_bytes"] == K * (M + 4 * L)
    assert h[-1]["total_wire_bytes"] == 2 * K * (M + 4 * L)
    assert abs(h[-1]["wire_savings"] - (1 - (M + 4 * L) / (4.0 * M))) < 1e-9


def test_sparse_none_full_round_wire_byte_oracle():
    """codec='none' full rounds on the top-k store price 8 bytes (fp32
    value, raw int32 index) per kept entry of the padded block layout."""
    eng = _port(lbg_variant="topk", lbg_kw={"k_frac": 0.25})
    h = _rounds(eng, 1)
    expect = sum(8.0 * nb * kb for nb, _, kb in
                 (_block_layout(int(p.numel()), 0.25)
                  for p in eng.params.values()))
    assert h[0]["frac_scalar"] == 0.0
    assert h[0]["wire_bytes"] == eng.cfg.num_clients * expect


def test_int8_beats_fp32_lbgm_by_3x():
    kw = dict(lbg_variant="topk", lbg_kw={"k_frac": 0.25},
              scheduler="chunked", chunk_size=4)
    base = _rounds(_port(**kw))
    q = _rounds(_port(codec="int8", **kw))
    assert base[-1]["total_wire_bytes"] / q[-1]["total_wire_bytes"] >= 3.0
    assert abs(base[-1]["loss"] - q[-1]["loss"]) < 0.05


def test_scalar_round_wire_is_one_byte_quantized():
    eng = _port(codec="int8", delta_threshold=50.0, lbg_variant="topk",
                lbg_kw={"k_frac": 0.25})
    h = _rounds(eng)
    assert h[-1]["frac_scalar"] == 1.0
    assert h[-1]["wire_bytes"] == eng.cfg.num_clients * 1.0


def test_lossy_codec_requires_sparse_or_vanilla():
    with pytest.raises(ValueError, match="lossy"):
        _port(codec="int8")                                # dense bank
    with pytest.raises(ValueError, match="lossy"):
        _port(codec="fp8", lbg_variant="topk", fused_kernels=False)
    _port(codec="delta_idx")          # a lossless codec on the dense bank


def test_deterministic_codec_draws_no_seeds():
    topk = dict(lbg_variant="topk", lbg_kw={"k_frac": 0.25})
    eng = _port(codec="int8", codec_kw={"stochastic": False}, **topk)
    assert tw.WIRE_KEY not in eng._sample_batches(np.random.RandomState(0))
    state = eng._codec_rng.get_state()[1].copy()
    _rounds(eng, 2)
    assert np.array_equal(eng._codec_rng.get_state()[1], state)
    eng2 = _port(codec="int8", **topk)
    batch = eng2._sample_batches(np.random.RandomState(0))
    want = tw.codec_rng(0).randint(0, 2 ** 31 - 1, size=6)
    np.testing.assert_array_equal(batch[tw.WIRE_KEY], want)

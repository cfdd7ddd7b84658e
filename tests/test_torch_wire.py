"""The port's wire codecs (``repro_torch.comm.wire``) against the JAX
package's (``repro.comm.wire``), on the same numpy inputs.

Exact where the arithmetic is the same: ``stochastic_round`` on given
uniforms, ``e4m3_nearest``, the e4m3 grid step, ``delta_idx_bytes``,
round-to-nearest ``quantize`` of random rows, the codecs' encoders and
the ``codec_rng`` seed stream, draw for draw. ``pow2_scale`` is exact
except where the JAX package's ``log2`` is off: for m = qmax * 2^k at some
k, XLA's CPU ``log2`` lands above k and the JAX package picks 2^(k+1);
:func:`test_pow2_scale_jax_log2_caveat` pins those inputs.

The stochastic codecs draw the JAX package's uniforms bit for bit:
``core.jax_prng.uniform_rows`` equals ``jax.random.uniform(fold_in(
PRNGKey(seed), leaf), (n,))`` for every seed, leaf and length (pieces
shorter than a row too), and the stochastic encoders equal the JAX
package's per client. They are also held to statistics: unbiased
rounding, the error bounds of ``tests/test_wire.py``, idempotency on grid
values for every seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and spinning
# OpenMP threads would starve the other workers' threads
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from repro.comm import wire as jw  # noqa: E402
from repro.core.lbgm import LBGMStats as JStats  # noqa: E402
import jax  # noqa: E402

from repro_torch.comm import wire as tw  # noqa: E402
from repro_torch.core import jax_prng as jp  # noqa: E402
from repro_torch.core.lbgm import LBGMStats as TStats  # noqa: E402

CODECS = {"int8": (jw.Int8Codec, tw.Int8Codec, 127.0),
          "fp8": (jw.Fp8Codec, tw.Fp8Codec, jw.E4M3_MAX)}


def _f32(x):
    """A JAX or torch array (int8, fp8 or fp32) as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rows(rng, C, rows, cols):
    """Rows at several magnitudes, some with zeros and an all-zero row."""
    x = rng.randn(C, rows, cols).astype(np.float32)
    x *= (10.0 ** rng.uniform(-6, 3, size=(C, rows, 1))).astype(np.float32)
    x[rng.rand(C, rows, cols) < 0.1] = 0.0
    x[0, 0] = 0.0
    return x


# ------------------------------------------------------------ primitives


def test_stochastic_round_matches_jax():
    rng = np.random.RandomState(0)
    f = (rng.randn(64, 33) * 7).astype(np.float32)
    u = rng.rand(64, 33).astype(np.float32)
    want = np.asarray(jw.stochastic_round(jnp.asarray(f), jnp.asarray(u)))
    got = tw.stochastic_round(torch.from_numpy(f), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("qmax", [127.0, jw.E4M3_MAX])
def test_pow2_scale_matches_jax_on_random_maxima(qmax):
    """Random row maxima over 70 binades (never exact powers of two):
    equal to the JAX package, and the smallest power of two that fits."""
    rng = np.random.RandomState(1)
    m = (rng.rand(20000) * 10.0 ** rng.uniform(-30, 30, 20000)) \
        .astype(np.float32)
    m[:3] = 0.0
    got = tw.pow2_scale(torch.from_numpy(m), qmax).numpy()
    want = np.asarray(jw.pow2_scale(jnp.asarray(m), qmax))
    np.testing.assert_array_equal(got, want)
    pos = m > 0
    e = np.log2(got[pos].astype(np.float64))
    np.testing.assert_array_equal(e, np.round(e))        # powers of two
    assert np.all(m[pos] / got[pos] <= qmax)
    assert np.all(m[pos] / (got[pos] / 2) > qmax)
    assert np.all(got[~pos] == 1.0)


@pytest.mark.parametrize("qmax", [127.0, jw.E4M3_MAX])
def test_pow2_scale_jax_log2_caveat(qmax):
    """Rows whose maximum is exactly qmax * 2^k: m / qmax = 2^k, so the
    smallest fitting scale is 2^k. The port gives 2^k for every k. The JAX
    package takes ceil(log2(2^k)) from XLA's CPU log2, which comes out
    above k at k = -13, -15, -26 (and others), and gives 2^(k+1) there — a
    grid twice as coarse, on which such a row re-encodes differently. At
    k where XLA's log2 is exact, both give 2^k."""
    for k, jax_off in ((-13, True), (-15, True), (-26, True), (-12, False),
                       (-14, False), (0, False), (5, False)):
        m = np.float32(qmax * 2.0 ** k)
        port = float(tw.pow2_scale(torch.tensor([m]), qmax)[0])
        ref = float(jw.pow2_scale(jnp.asarray([m]), qmax)[0])
        assert port == 2.0 ** k, (k, port)
        assert ref == (2.0 ** (k + 1) if jax_off else 2.0 ** k), (k, ref)


def test_pow2_scale_exact_down_to_subnormal_scales():
    """2^e is built from its bits: exact at every exponent the 1e-38 floor
    admits, subnormal scales included (the JAX package's ldexp flushes
    those to 0)."""
    ks = np.arange(-135, 120)
    m = (127.0 * 2.0 ** ks * 1.5).astype(np.float32)
    m = m[m > 1e-38]
    got = tw.pow2_scale(torch.from_numpy(m), 127.0).numpy().astype(np.float64)
    want = 2.0 ** np.ceil(np.log2(m.astype(np.float64) / 127.0))
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert got.min() < 2.0 ** -126                      # a subnormal scale


def test_e4m3_nearest_and_step_match_jax():
    rng = np.random.RandomState(2)
    x = np.concatenate([
        rng.randn(4000) * 10.0 ** rng.uniform(-12, 4, 4000),
        [0.0, -0.0, 1.0, 447.0, 449.0, 1e6, -1e6, 0.3, 2.0 ** -9,
         2.0 ** -10, 3 * 2.0 ** -11, 2.0 ** -6]]).astype(np.float32)
    got = tw.e4m3_nearest(torch.from_numpy(x)).numpy()
    want = np.asarray(jw.e4m3_nearest(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tw.e4m3_nearest(
        torch.from_numpy(got)).numpy())                  # grid is fixed
    a = np.abs(x)
    np.testing.assert_array_equal(
        tw._e4m3_step(torch.from_numpy(a)).numpy(),
        np.asarray(jw._e4m3_step(jnp.asarray(a))))


def np_varint_bytes(idx):
    """Hand-computed varint-delta byte count (the wire-format oracle)."""
    total = 0
    for row in np.asarray(idx).reshape(-1, idx.shape[-1]):
        prev = 0
        for v in np.sort(row):
            d = int(v) - prev
            total += 1 if d < (1 << 7) else (2 if d < (1 << 14) else 3)
            prev = int(v)
    return float(total)


@pytest.mark.parametrize("shape,high", [((3, 6, 17), 1 << 15),
                                        ((2, 4, 1), 9000),
                                        ((4, 1, 64), 200),
                                        ((1, 16, 627), 1 << 16)])
def test_delta_idx_bytes_matches_jax(shape, high):
    rng = np.random.RandomState(3)
    idx = rng.randint(0, high, size=shape).astype(np.int32)
    got = tw.delta_idx_bytes(torch.from_numpy(idx)).numpy()
    assert got.shape == (shape[0],)
    for c in range(shape[0]):
        assert got[c] == float(jw.delta_idx_bytes(jnp.asarray(idx[c])))
        assert got[c] == np_varint_bytes(idx[c])


def test_delta_idx_bytes_degenerate_and_pad_rows():
    one = torch.tensor([[[5], [200], [40000]]], dtype=torch.int32)
    assert tw.delta_idx_bytes(one).tolist() == [1 + 2 + 3]
    pad = torch.arange(32, dtype=torch.int32).expand(2, 4, 32)
    assert tw.delta_idx_bytes(pad).tolist() == [4 * 32, 4 * 32]


def test_codec_rng_draw_for_draw():
    for seed in (0, 1, 17):
        a, b = tw.codec_rng(seed), jw.codec_rng(seed)
        for _ in range(3):
            np.testing.assert_array_equal(a.randint(0, 2 ** 31 - 1, 100),
                                          b.randint(0, 2 ** 31 - 1, 100))


# ------------------------------------------------------ nearest quantize


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_nearest_quantize_matches_jax(codec):
    jcls, tcls, _ = CODECS[codec]
    rng = np.random.RandomState(4)
    val = _rows(rng, 3, 8, 97)
    q, scale = tcls(stochastic=False).quantize(torch.from_numpy(val), None, 0)
    assert q.dtype == (torch.int8 if codec == "int8"
                       else torch.float8_e4m3fn)
    assert tuple(scale.shape) == (3, 8, 1)
    jc = jcls(stochastic=False)
    for c in range(3):
        jq, js = jc.quantize(jnp.asarray(val[c]), None)
        np.testing.assert_array_equal(_f32(q[c]), _f32(jq))
        np.testing.assert_array_equal(scale[c].numpy(), np.asarray(js))


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_encoders_match_jax_nearest(codec):
    """``encode_sparse`` (payload, bank, e4m3 rho, wire bytes) and
    ``encode_dense`` equal the JAX package's per client, rounding to
    nearest."""
    _encoders_match_jax(codec, stochastic=False)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_encoders_match_jax_stochastic(codec):
    """The same, rounding stochastically from per-client seeds: leaf i of
    client c draws ``jax.random.uniform(fold_in(PRNGKey(seed_c), i))``."""
    _encoders_match_jax(codec, stochastic=True)


def _encoders_match_jax(codec, stochastic):
    jcls, tcls, _ = CODECS[codec]
    rng = np.random.RandomState(5)
    C, names = 4, {"a/w": (16, 9), "b/b": (1, 3)}
    val = {n: _rows(rng, C, *s) for n, s in names.items()}
    idx = {n: np.stack([np.stack([rng.choice(300, s[1], replace=False)
                                  for _ in range(s[0])]) for _ in range(C)])
           .astype(np.int32) for n, s in names.items()}
    lidx = {n: np.roll(i, 1, axis=0) for n, i in idx.items()}
    gscale = (rng.randn(C) * 3).astype(np.float32)
    scalar = np.array([True, False, True, False])
    seeds = np.array([0, 17, 2 ** 31 - 2, 123456789], np.int64)
    tseed = torch.from_numpy(seeds) if stochastic else None
    jseed = [np.uint32(s) if stochastic else None for s in seeds]
    tc, jc = tcls(stochastic=stochastic), jcls(stochastic=stochastic)
    t_send = {n: {"idx": torch.from_numpy(idx[n]),
                  "val": torch.from_numpy(val[n])} for n in names}
    t_lbg = {n: {"idx": torch.from_numpy(lidx[n]),
                 "val": torch.from_numpy(val[n])} for n in names}
    z = torch.zeros(C)
    tstats = TStats(sin2=z, rho=torch.from_numpy(gscale),
                    sent_scalar=torch.from_numpy(scalar), uplink_floats=z,
                    grad_sq_norm=z)
    (send2, gs2), lbg2, wire = tc.encode_sparse(
        (t_send, torch.from_numpy(gscale)), t_lbg, tstats, tseed)
    for c in range(C):
        js = JStats(sin2=0.0, rho=gscale[c], sent_scalar=scalar[c],
                    uplink_floats=0.0, grad_sq_norm=0.0)
        (jsend, jgs), jlbg, jwire = jc.encode_sparse(
            ({n: {"idx": jnp.asarray(idx[n][c]), "val": jnp.asarray(
                val[n][c])} for n in names}, jnp.asarray(gscale[c])),
            {n: {"idx": jnp.asarray(lidx[n][c]), "val": jnp.asarray(
                val[n][c])} for n in names}, js, jseed[c])
        assert float(wire[c]) == float(jwire)
        assert float(gs2[c]) == float(jgs)
        for n in names:
            for k in ("idx", "val", "scale"):
                np.testing.assert_array_equal(_f32(send2[n][k][c]),
                                              _f32(jsend[n][k]))
            for k in ("idx", "val"):
                np.testing.assert_array_equal(lbg2[n][k][c].numpy(),
                                              np.asarray(jlbg[n][k]))
    dense = {n: torch.from_numpy(v.reshape(C, -1)) for n, v in val.items()}
    out, dwire = tc.encode_dense(dense, torch.ones(C), tseed)
    for c in range(C):
        jout, jdw = jc.encode_dense(
            {n: jnp.asarray(v[c]) for n, v in dense.items()}, 1.0,
            jseed[c])
        assert float(dwire[c]) == float(jdw)
        for n in names:
            np.testing.assert_array_equal(out[n][c].numpy(),
                                          np.asarray(jout[n]))


def test_lossless_codecs_leave_payload_and_price_bytes():
    rng = np.random.RandomState(6)
    idx = torch.from_numpy(rng.randint(0, 5000, (3, 2, 40)).astype(np.int32))
    send = {"w": {"idx": idx, "val": torch.randn(3, 2, 40)}}
    z = torch.zeros(3)
    stats = TStats(sin2=z, rho=z, sent_scalar=torch.tensor(
        [False, True, False]), uplink_floats=z, grad_sq_norm=z)
    for codec, scalar in ((tw.NoneCodec(), 4.0), (tw.DeltaIdxCodec(), 4.0)):
        out, bank, wire = codec.encode_sparse((send, z), send, stats, None)
        assert out[0] is send and bank is send
        full = 4 * 80 + (4 * 80 if codec.name == "none" else
                         tw.delta_idx_bytes(idx).numpy())
        np.testing.assert_array_equal(
            wire.numpy(), np.where([False, True, False], scalar, full))


# ------------------------------------------ stochastic (JAX uniform) path


UNIFORM_SEEDS = np.array([0, 1, 12345, 2 ** 31 - 2], np.int64)


@pytest.mark.parametrize("n,leaf", [(1, 0), (7, 3), (1000, 1), (4097, 2),
                                    (70001, 5)])
def test_uniform_rows_equals_jax_uniform(n, leaf, monkeypatch):
    """Row c of ``uniform_rows(fold_in_t(prng_key_t(seed), leaf), n)`` is
    ``jax.random.uniform(fold_in(PRNGKey(seed_c), leaf), (n,))`` bit for
    bit, drawn in pieces shorter than a row (``_PIECE``), and equals the
    NumPy replay ``jax_prng.uniform``."""
    monkeypatch.setattr(jp, "_PIECE", 4096)
    key = jp.fold_in_t(jp.prng_key_t(torch.from_numpy(UNIFORM_SEEDS)), leaf)
    u = jp.uniform_rows(key, n)
    assert u.dtype == torch.float32 and tuple(u.shape) == (4, n)
    for c, s in enumerate(UNIFORM_SEEDS):
        k = jax.random.fold_in(jax.random.PRNGKey(np.uint32(s)), leaf)
        ju = np.asarray(jax.random.uniform(k, (n,), jnp.float32))
        np.testing.assert_array_equal(u[c].numpy(), ju)
        np.testing.assert_array_equal(
            jp.uniform(jp.fold_in(jp.prng_key(int(s)), leaf), (n,)), ju)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_codec_rounds_with_the_leaf_keyed_jax_uniforms():
    """``_round`` draws leaf i's uniforms from ``fold_in(PRNGKey(seed),
    i)`` over the (rows, cols) payload, row-major, as JAX's
    ``uniform(key, f.shape)``: rounding against those uniforms by hand
    gives the codec's grid values."""
    rng = np.random.RandomState(3)
    f = torch.from_numpy((rng.randn(4, 5, 9) * 20).astype(np.float32))
    seed = torch.from_numpy(UNIFORM_SEEDS)
    for leaf in (0, 2):
        got = tw.Int8Codec()._round(f, seed, leaf)
        for c, s in enumerate(UNIFORM_SEEDS):
            k = jax.random.fold_in(jax.random.PRNGKey(np.uint32(s)), leaf)
            u = np.asarray(jax.random.uniform(k, (5, 9), jnp.float32))
            want = np.asarray(jw.stochastic_round(jnp.asarray(f[c].numpy()),
                                                  jnp.asarray(u)))
            np.testing.assert_array_equal(got[c].numpy(), want)


def _uniforms(seeds, leaf, shape):
    """The codecs' (C, rows, cols) uniforms of ``seeds`` at ``leaf``."""
    u = jp.uniform_rows(jp.fold_in_t(jp.prng_key_t(seeds), leaf),
                        shape[0] * shape[1])
    return u.reshape(seeds.shape[0], *shape)


def test_stochastic_round_with_hash_uniforms_is_unbiased():
    rng = np.random.RandomState(7)
    f = torch.from_numpy((rng.randn(1, 1, 64) * 7).astype(np.float32))
    seeds = torch.arange(4000)
    u = _uniforms(seeds, 0, (1, 64))
    q = tw.stochastic_round(f.expand(4000, 1, 64), u)
    assert torch.equal(q, torch.floor(q))
    frac = (f - torch.floor(f)).double()
    sigma = (torch.clamp(frac * (1 - frac), min=1e-12) / 4000).sqrt()
    assert bool(((q.double().mean(0) - f.double()).abs()
                 < 5 * sigma + 1e-6).all())
    ints = torch.arange(-5.0, 6.0).reshape(1, 1, 11)
    assert torch.equal(tw.stochastic_round(
        ints.expand(4000, 1, 11), _uniforms(seeds, 1, (1, 11))),
        ints.expand(4000, 1, 11))


@pytest.mark.parametrize("codec,nearest_rel", [("int8", 1.0 / 127.0),
                                               ("fp8", 1.0 / 16.0)])
def test_quantization_error_bounds(codec, nearest_rel):
    """tests/test_wire.py's bounds: nearest rounding errs by at most half
    the worst grid step (int8: rowmax/127; fp8: 2^-4 relative in-binade);
    stochastic rounding by less than one step (twice that)."""
    tcls = CODECS[codec][1]
    rng = np.random.RandomState(8)
    val = torch.from_numpy((rng.randn(5, 16, 128) * 3).astype(np.float32))
    rowmax = val.abs().amax(-1, keepdim=True)
    for stochastic, bound in ((False, nearest_rel), (True, 2 * nearest_rel)):
        c = tcls(stochastic=stochastic)
        q, scale = c.quantize(val, torch.arange(5) + 11, 2)
        dq = c.decode_leaf({"idx": None, "val": q, "scale": scale})
        assert bool(((dq - val).abs() <= rowmax * bound + 1e-7).all())


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("stochastic", [True, False])
def test_requantization_idempotent_for_every_seed(codec, stochastic):
    """dequant(quant(v)) is a fixed point of quant-dequant, exactly, under
    every rounding seed: the bank's grid values re-encode to themselves on
    every recycle round. (The scale may halve: a row whose maximum rounded
    down to qmax/2 or below re-encodes on a finer grid, to the same
    values.)"""
    tcls = CODECS[codec][1]
    rng = np.random.RandomState(9)
    val = torch.from_numpy(_rows(rng, 3, 8, 64))
    c = tcls(stochastic=stochastic)
    q, scale = c.quantize(val, torch.tensor([1, 2, 3]), 0)
    v1 = c.decode_leaf({"idx": None, "val": q, "scale": scale})
    for s in range(20):
        q2, s2 = c.quantize(v1, torch.tensor([s, 7 * s + 1, 2 ** 30 + s]),
                            s % 3)
        assert torch.equal(c.decode_leaf({"idx": None, "val": q2,
                                          "scale": s2}), v1)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_stochastic_quantize_is_unbiased_and_seeded(codec):
    """E[dequant(quant(v))] = v over seeds; one seed gives one result."""
    tcls = CODECS[codec][1]
    rng = np.random.RandomState(10)
    val = torch.from_numpy(rng.randn(1, 2, 32).astype(np.float32))
    c = tcls(stochastic=True)
    n = 3000
    q, scale = c.quantize(val.expand(n, 2, 32).contiguous(),
                          torch.arange(n), 0)
    dq = c.decode_leaf({"idx": None, "val": q, "scale": scale}).double()
    step = (dq - val.double()).abs().amax(0)        # <= one grid step
    assert bool(((dq.mean(0) - val.double()).abs()
                 <= 5 * step / (4 * n) ** 0.5 + 1e-7).all())
    q1, _ = c.quantize(val, torch.tensor([5]), 0)
    assert torch.equal(q1.float(), c.quantize(val, torch.tensor([5]), 0)[0]
                       .float())
    assert torch.equal(q1.float(), q[5:6].float())

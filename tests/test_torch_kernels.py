"""The port's kernel plain versions and wrappers against the JAX package.

``repro_torch.kernels.ref`` is held against ``repro.kernels.ref`` and
against the Pallas kernels run as the JAX package's own tests run them on
the CPU (``interpret=True``), batched and unbatched, one-pass and
two-pass. Inputs come from numpy with a fixed seed and go to both.

Tolerances: the projection's fp32 sums run in another order in the two
packages (rtol 1e-4; bf16 inputs rtol 5e-3, as ``tests/test_kernels.py``),
plus an absolute 1e-6 of the sum of |terms|: <g,l> of random vectors can
cancel to far below its terms, where a relative bound means nothing.
Top-k index sets *and orders* must match exactly, and so must the selected
and gathered values (they are copies of input elements); ||g||^2 rtol 1e-5.
The port's dequant-accumulate fold rounds ``coeff * q`` and the sum
separately (no FMA), as its CUDA kernel does. On fp8 payloads so does XLA
on the CPU, and the fold equals the JAX package's oracle and its
interpreted Pallas kernel exactly. On int8 payloads XLA contracts
``cur + coeff * f32(q)`` into one fused multiply-add (its result equals a
single-rounding emulation exactly), so there the port agrees to rtol 1e-6
(plus 1e-7 absolute where a sum cancels; the terms are O(1)).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and spinning
# OpenMP threads would starve the other workers' threads
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lbgm_projection import (  # noqa: E402
    lbgm_projection_batched_pallas, lbgm_projection_pallas)
from repro.comm.wire import Fp8Codec, Int8Codec  # noqa: E402
from repro.kernels.lbgm_sparse import (  # noqa: E402
    lbgm_dequant_accum_pallas, lbgm_sparse_decision_batched_pallas,
    lbgm_sparse_decision_pallas,
    lbgm_sparse_decision_two_pass_batched_pallas,
    lbgm_sparse_decision_two_pass_pallas)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.lbgm_projection import (  # noqa: E402
    lbgm_projection, lbgm_projection_batched)
from repro_torch.kernels.lbgm_sparse import (  # noqa: E402
    lbgm_dequant_accum, lbgm_sparse_decision, lbgm_sparse_decision_batched)

BF16 = {"f32": (np.float32, jnp.float32, torch.float32),
        "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, jdt, tdt):
    """The same values as a JAX and a torch array of one dtype."""
    j = jnp.asarray(x).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _close(got, want, g, l, rtol):
    """``got`` vs ``want`` (gl, gg, ll) within rtol, or within 1e-6 of the
    sum of |terms| where <g,l> cancels."""
    scale = np.asarray([np.asarray(x, np.float64) for x in
                        tref.lbgm_projection_ref(g.abs(), l.abs())])
    np.testing.assert_array_less(
        np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)),
        rtol * np.abs(np.asarray(want, np.float64)) + 1e-6 * scale + 1e-30)


# ------------------------------------------------------------ projection


@pytest.mark.parametrize("n", [17, 1000, 65536, 200_001])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_projection_plain_matches_jax(n, dt):
    rng = np.random.RandomState(n)
    _, jdt, tdt = BF16[dt]
    jg, tg = _pair(rng.randn(n).astype(np.float32) * 0.1, jdt, tdt)
    jl, tl = _pair(rng.randn(n).astype(np.float32) * 0.1, jdt, tdt)
    rtol = 5e-3 if dt == "bf16" else 1e-4
    want = np.asarray(jref.lbgm_projection_ref(jg, jl))
    pallas = np.asarray(lbgm_projection_pallas(jg, jl, interpret=True))
    got = np.array([float(x) for x in lbgm_projection(tg, tl)])
    _close(got, want, tg, tl, rtol)
    _close(got, pallas, tg, tl, rtol)


@pytest.mark.parametrize("B,n", [(3, 1000), (2, 65536), (4, 17)])
def test_projection_batched_matches_pallas_batched(B, n):
    rng = np.random.RandomState(B * n)
    jg, tg = _pair(rng.randn(B, n).astype(np.float32), jnp.float32,
                   torch.float32)
    jl, tl = _pair(rng.randn(B, n).astype(np.float32), jnp.float32,
                   torch.float32)
    want = lbgm_projection_batched_pallas(jg, jl, interpret=True)
    got = lbgm_projection_batched(tg, tl)
    for a in got:
        assert a.shape == (B,) and a.dtype == torch.float32
    _close(torch.stack(got).numpy(), np.stack([np.asarray(w) for w in want]),
           tg, tl, 1e-4)


def test_ops_projection_sums_leaves_in_sorted_order():
    """Per-client scalars over a batched dict: the per-leaf sums add in
    sorted key order, whatever order the dict was built in."""
    rng = np.random.RandomState(0)
    shapes = {"z": (3, 5), "a": (3, 40, 2), "m": (3, 7)}
    g = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
         for k, s in shapes.items()}
    l = {k: v * 0.5 + 1 for k, v in g.items()}
    gl, gg, ll = ops.lbgm_projection(g, l)
    for c in range(3):
        parts = [tref.lbgm_projection_ref(g[k][c].reshape(-1),
                                          l[k][c].reshape(-1))
                 for k in sorted(g)]
        want = [parts[0][i] + parts[1][i] + parts[2][i] for i in range(3)]
        for a, w in zip((gl[c], gg[c], ll[c]), want):
            assert float(a) == float(w)


# -------------------------------------------------------- sparse decision


def _blocks_idx(rng, B, nb, block, kb, kind="normal"):
    x = rng.randn(B, nb, block).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2) / 2
    elif kind == "zeros":
        x[:] = 0
    elif kind == "tiny":
        x = (x * 1e-35).astype(np.float32)
    elif kind == "huge":
        x = (x * 1e30).astype(np.float32)
    elif kind == "subnormal":
        x = (x * 1e-41).astype(np.float32)
    elif kind == "sparse":
        x = np.where(rng.rand(*x.shape) < 0.02, x, 0).astype(np.float32)
    idx = np.argsort(rng.rand(B, nb, block), axis=-1)[..., :kb]
    return x, idx.astype(np.int32)


def _assert_decision_equal(got, want, setwise=False):
    gg, gath, ti, tv = (np.asarray(a) for a in got)
    wgg, wgath, wti, wtv = (np.asarray(a) for a in want)
    np.testing.assert_allclose(gg, wgg, rtol=1e-5)
    np.testing.assert_array_equal(gath, wgath)
    if setwise:
        o, wo = np.argsort(ti, -1), np.argsort(wti, -1)
        ti, tv = (np.take_along_axis(a, o, -1) for a in (ti, tv))
        wti, wtv = (np.take_along_axis(a, wo, -1) for a in (wti, wtv))
    np.testing.assert_array_equal(ti, wti)
    np.testing.assert_array_equal(tv, wtv)


SPARSE_SHAPES = [(1, 700, 33), (3, 512, 17), (16, 1000, 9), (4, 256, 256),
                 (2, 4096, 1)]


@pytest.mark.parametrize("nb,block,kb", SPARSE_SHAPES)
def test_decision_plain_matches_jax_ref(nb, block, kb):
    rng = np.random.RandomState(nb * block + kb)
    x, idx = _blocks_idx(rng, 1, nb, block, kb)
    want = jref.lbgm_sparse_decision_ref(jnp.asarray(x[0]),
                                         jnp.asarray(idx[0]))
    got = tref.lbgm_sparse_decision_ref(torch.from_numpy(x[0]),
                                        torch.from_numpy(idx[0]))
    _assert_decision_equal(got, want)
    assert got[2].dtype == torch.int32


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "tiny", "huge",
                                  "subnormal", "sparse"])
@pytest.mark.parametrize("two_pass", [False, True])
def test_decision_batched_matches_pallas(kind, two_pass):
    """The wrapper on CPU tensors (the plain version) against the batched
    Pallas kernel in interpret mode: tie-heavy rows, all-zero rows,
    rows of tiny (1e-35), huge (1e30) and subnormal magnitude, and rows
    with fewer nonzeros than kb."""
    rng = np.random.RandomState(7)
    x, idx = _blocks_idx(rng, 3, 2, 256, 11, kind)
    pallas = (lbgm_sparse_decision_two_pass_batched_pallas if two_pass
              else lbgm_sparse_decision_batched_pallas)
    want = pallas(jnp.asarray(x), jnp.asarray(idx), interpret=True)
    got = lbgm_sparse_decision_batched(torch.from_numpy(x),
                                       torch.from_numpy(idx),
                                       two_pass=two_pass)
    # the one-pass form's value order (ties to the lowest index) matches
    # exactly; the two-pass forms agree as sets (the JAX kernel lists the
    # entries above the threshold, then the ties, each in index order; the
    # port one index order throughout)
    if kind == "subnormal":
        # the JAX two-pass kernel gathers through one-hot matmuls, which
        # flush subnormal values to zero on the CPU: hold the selection
        # against it, and the values against the JAX plain version
        for c in range(3):
            _assert_decision_equal(
                [a[c] for a in got],
                jref.lbgm_sparse_decision_ref(jnp.asarray(x[c]),
                                              jnp.asarray(idx[c])),
                setwise=two_pass)
        np.testing.assert_array_equal(np.sort(got[2].numpy(), -1),
                                      np.sort(np.asarray(want[2]), -1))
    else:
        _assert_decision_equal(got, want, setwise=two_pass)
    if kind == "zeros":  # an all-zero row is exactly (iota, zeros)
        np.testing.assert_array_equal(
            got[2].numpy(), np.broadcast_to(np.arange(11), (3, 2, 11)))


@pytest.mark.parametrize("two_pass", [False, True])
def test_decision_unbatched_matches_pallas(two_pass):
    rng = np.random.RandomState(3)
    x, idx = _blocks_idx(rng, 1, 3, 1000, 9, "ties")
    pallas = (lbgm_sparse_decision_two_pass_pallas if two_pass
              else lbgm_sparse_decision_pallas)
    want = pallas(jnp.asarray(x[0]), jnp.asarray(idx[0]), interpret=True)
    got = lbgm_sparse_decision(torch.from_numpy(x[0]),
                               torch.from_numpy(idx[0]), two_pass=two_pass)
    assert got[0].dim() == 0
    _assert_decision_equal(got, want, setwise=two_pass)


def test_decision_bf16_plain_matches_jax_ref():
    rng = np.random.RandomState(11)
    x, idx = _blocks_idx(rng, 1, 2, 512, 17)
    jx = jnp.asarray(x[0]).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    want = jref.lbgm_sparse_decision_ref(jx, jnp.asarray(idx[0]))
    got = tref.lbgm_sparse_decision_ref(tx, torch.from_numpy(idx[0]))
    _assert_decision_equal(got, want)


def test_two_pass_is_value_order_sorted_by_index():
    rng = np.random.RandomState(5)
    x, idx = _blocks_idx(rng, 2, 3, 300, 20, "ties")
    tx, ti = torch.from_numpy(x), torch.from_numpy(idx)
    one = tref.lbgm_sparse_decision_ref(tx, ti)
    two = tref.lbgm_sparse_decision_two_pass_ref(tx, ti)
    si, sv = tref.sort_topk_rows(one[2], one[3])
    assert torch.equal(si, two[2]) and torch.equal(sv, two[3])
    ji, jv = jref.sort_topk_rows(jnp.asarray(one[2].numpy()),
                                 jnp.asarray(one[3].numpy()))
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jv))


def test_two_pass_env_knob(monkeypatch):
    rng = np.random.RandomState(9)
    x, idx = _blocks_idx(rng, 2, 2, 256, 11)
    tx, ti = torch.from_numpy(x), torch.from_numpy(idx)
    monkeypatch.delenv(ops.TWO_PASS_ENV, raising=False)
    assert not ops._default_two_pass()
    one = ops.lbgm_sparse_decision(tx, ti)
    monkeypatch.setenv(ops.TWO_PASS_ENV, "1")
    assert ops._default_two_pass()
    two = ops.lbgm_sparse_decision(tx, ti)
    assert torch.equal(two[2], torch.sort(one[2], -1).values)
    for off in ("false", "0", "off", "no", "False"):
        monkeypatch.setenv(ops.TWO_PASS_ENV, off)
        assert not ops._default_two_pass(), off


# ------------------------------------------------ dequant + accumulate


def _dequant_case(wire_dtype, seed, C=5, nb=4, kb=8, block=32,
                  shared=False):
    """tests/test_wire.py's case: a phantom client (w = 0) with NaN values
    and gscale, int8 or fp8 payloads from the JAX codec. ``shared=True``
    puts every client on the same positions, so each position is hit C
    times in client order."""
    import jax
    rng = np.random.RandomState(seed)
    acc = rng.randn(nb, block).astype(np.float32)
    w = rng.rand(C).astype(np.float32)
    w[seed % C] = 0.0
    gscale = rng.rand(C).astype(np.float32)
    gscale[seed % C] = np.nan
    rows = [rng.choice(block, kb, replace=False) for _ in range(nb)]
    idx = np.stack([np.stack(rows if shared else
                             [rng.choice(block, kb, replace=False)
                              for _ in range(nb)]) for _ in range(C)]
                   ).astype(np.int32)
    val = rng.randn(C, nb, kb).astype(np.float32)
    codec = (Int8Codec if wire_dtype == "int8" else Fp8Codec)(
        stochastic=False)
    qv, scale = jax.vmap(lambda v: codec.quantize(v, None))(jnp.asarray(val))
    if wire_dtype == "fp8":
        qv = qv.at[seed % C].set(jnp.nan)          # NaN survives e4m3
    tq = torch.from_numpy(np.array(qv.astype(jnp.float32)))
    tq = tq.to(torch.int8 if wire_dtype == "int8" else torch.float8_e4m3fn)
    j = (jnp.asarray(acc), jnp.asarray(w), jnp.asarray(gscale),
         jnp.asarray(idx), qv, scale)
    t = (torch.from_numpy(acc), torch.from_numpy(w),
         torch.from_numpy(gscale), torch.from_numpy(idx), tq,
         torch.from_numpy(np.array(scale)))
    return j, t


def _fma_fold(acc, w, gscale, idx, qv, scale):
    """The fold with ``cur + coeff * q`` rounded once, as an FMA does: the
    float64 product of an fp32 coeff and an int8 value is exact."""
    a = acc.numpy().copy()
    for c in range(idx.shape[0]):
        coeff = ((w[c] * gscale[c]) * scale[c]).numpy().astype(np.float64)
        q = qv[c].float().numpy().astype(np.float64)
        for r in range(a.shape[0]):
            i = idx[c, r].numpy()
            if w[c] > 0:
                a[r, i] = (a[r, i] + coeff[r] * q[r]).astype(np.float32)
            else:
                a[r, i] = a[r, i] + np.float32(0)
    return a


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("wire_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("seed", range(3))
def test_dequant_accum_plain_matches_jax(wire_dtype, seed, shared):
    j, t = _dequant_case(wire_dtype, seed, shared=shared)
    want = np.asarray(jref.lbgm_dequant_accum_ref(*j))
    pallas = np.asarray(lbgm_dequant_accum_pallas(*j, interpret=True))
    acc_in = t[0].clone()
    got = tref.lbgm_dequant_accum_ref(*t)
    assert got is t[0]                              # updated in place
    assert np.all(np.isfinite(want))
    np.testing.assert_array_equal(want, pallas)
    if wire_dtype == "fp8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_array_equal(_fma_fold(acc_in, *t[1:]), want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # the wrapper and ops take the plain version on CPU tensors
    for fn in (lbgm_dequant_accum, ops.lbgm_dequant_accum):
        out = fn(acc_in.clone(), *t[1:])
        assert torch.equal(out, got)


def test_dequant_accum_edge_shapes_match_jax():
    """kb = 1 and a 10-wide block (the FCN's fc2/b leaf), one client."""
    for C, nb, kb, block in ((3, 1, 1, 10), (1, 2, 1, 5), (4, 1, 10, 10)):
        j, t = _dequant_case("int8", 0, C=C, nb=nb, kb=kb, block=block)
        want = np.asarray(jref.lbgm_dequant_accum_ref(*j))
        np.testing.assert_allclose(tref.lbgm_dequant_accum_ref(*t).numpy(),
                                   want, rtol=1e-6, atol=1e-7)


def test_dequant_accum_refuses_bad_shapes():
    j, t = _dequant_case("int8", 0)
    acc, w, gs, idx, qv, sc = t
    with pytest.raises(ValueError):
        lbgm_dequant_accum(acc[:2], w, gs, idx, qv, sc)
    with pytest.raises(ValueError):
        lbgm_dequant_accum(acc, w, gs, idx, qv, sc[:, :, 0])
    with pytest.raises(ValueError):
        lbgm_dequant_accum(acc, w[:2], gs, idx, qv, sc)


# --------------------------------------------------------------- dispatch


def test_cpu_tensors_take_plain_version_and_count_nothing():
    _build.reset_launch_counts()
    g = torch.randn(2, 100)
    lbgm_projection_batched(g, g)
    lbgm_sparse_decision_batched(torch.randn(2, 1, 100),
                                 torch.zeros(2, 1, 5, dtype=torch.int32))
    lbgm_dequant_accum(torch.zeros(1, 10), torch.ones(2), torch.ones(2),
                       torch.zeros(2, 1, 3, dtype=torch.int32),
                       torch.ones(2, 1, 3, dtype=torch.int8),
                       torch.ones(2, 1, 1))
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_wrapper_refuses_bad_shapes():
    with pytest.raises(ValueError):
        lbgm_projection_batched(torch.zeros(2, 3), torch.zeros(2, 4))
    with pytest.raises(ValueError):
        lbgm_sparse_decision_batched(torch.zeros(1, 2, 8),
                                     torch.zeros(1, 2, 9, dtype=torch.int32))

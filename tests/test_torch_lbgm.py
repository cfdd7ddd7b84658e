"""Algorithm 1 core (``core/lbgm.py``) across the two packages.

The JAX functions run per client under ``jax.vmap`` (as every scheduler
runs them); the port's take the ``(C, ...)`` stacks directly. Inputs come
from numpy with a fixed seed; the sparse banks the port starts from are the
JAX package's, carried across.

Tolerances: decisions, index sets, byte and float counts exactly; values
selected or gathered from the inputs exactly; reductions and products
rtol 1e-5 / atol 1e-7 (sin^2 rtol 1e-4, atol 1e-6: it is 1 - cos^2;
||g||^2 over ~1e5 squares, summed in another order, rtol 1e-4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and spinning
# OpenMP threads would starve the other workers' threads
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lbgm as jl  # noqa: E402
from repro_torch.core import lbgm as tl  # noqa: E402

C = 3
#: a fc1/w-like leaf spanning >1 block (nb rounds up to 16: pad rows live)
SHAPES = {"w": (700, 128), "b": (64,), "a": (5, 3)}


def _grads(seed, shapes=SHAPES, like=None, noise=0.3):
    rng = np.random.RandomState(seed)
    out = {}
    for name, s in shapes.items():
        x = rng.randn(C, *s).astype(np.float32)
        if like is not None:
            x = (like[name] + noise * x).astype(np.float32)
        out[name] = x
    return out


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _close(a, b, **kw):
    kw = {"rtol": 1e-5, "atol": 1e-7, **kw}
    for x, y in zip(jax.tree.leaves(_np(a)), jax.tree.leaves(_np(b))):
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32), **kw)


def _equal(a, b):
    la, lb = jax.tree.leaves(_np(a)), jax.tree.leaves(_np(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def _stats_match(ts, js):
    np.testing.assert_array_equal(ts.sent_scalar.numpy(),
                                  np.asarray(js.sent_scalar))
    np.testing.assert_array_equal(ts.uplink_floats.numpy(),
                                  np.asarray(js.uplink_floats))
    np.testing.assert_allclose(ts.sin2.numpy(), np.asarray(js.sin2),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ts.rho.numpy(), np.asarray(js.rho),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ts.grad_sq_norm.numpy(),
                               np.asarray(js.grad_sq_norm), rtol=1e-4)


@pytest.mark.parametrize("size,k_frac", [
    (100352, 0.1), (1280, 0.1), (128, 0.1), (10, 0.1), (36864, 0.1),
    (31360, 0.1), (89600, 0.01), (65536, 0.5), (65537, 0.1), (1, 0.3),
    (3 * 65536 + 5, 0.001)])
def test_block_layout_matches(size, k_frac):
    assert tl._block_layout(size, k_frac) == jl._block_layout(size, k_frac)
    assert tl.topk_count(size, k_frac) == jl.topk_count(size, k_frac)


def test_paper_fcn_layout():
    """fc1/w at k_frac=0.1 is (nb=16, block=65536, kb=627): 14 of its 16
    rows are zero padding."""
    assert tl._block_layout(784 * 128, 0.1) == (16, 65536, 627)
    assert tl._live_rows(784 * 128, 65536) == 2


def test_decision_from_scalars_edges():
    gl = np.array([0.0, 1.0, -2.0, 3.0], np.float32)
    gg = np.array([1.0, 1.0, 4.0, 9.0], np.float32)
    ll = np.array([0.0, 1.0, 1.0, 1e-30], np.float32)
    for delta in (0.0, 0.2, 1.0):
        t = tl.decision_from_scalars(*map(torch.from_numpy, (gl, gg, ll)),
                                     delta)
        j = jl.decision_from_scalars(*map(jnp.asarray, (gl, gg, ll)),
                                     delta)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("delta", [-1.0, 0.05, 0.5])
def test_dense_step_matches(fused, delta):
    g = _grads(0)
    lbg = _grads(1, like=g)
    lbg["a"] = np.zeros_like(lbg["a"]) if delta == 0.05 else lbg["a"]
    jgt, jnl, jst = jax.vmap(
        lambda a, b: jl.lbgm_client_step(a, b, delta))(_j(g), _j(lbg))
    tgt, tnl, tst = tl.lbgm_client_step(_t(g), _t(lbg), delta, fused=fused)
    _stats_match(tst, jst)
    _close(tgt, jgt)
    _equal(tnl, jnl)
    assert sorted(tgt) == sorted(jgt)


def _refreshed_bank(k_frac):
    """A JAX bank after one full round, so recycle rounds can fire."""
    proto = jl.init_topk_lbg(_j({k: v[0] for k, v in _grads(7).items()}),
                             k_frac)
    bank = jax.tree.map(lambda x: jnp.broadcast_to(x, (C,) + x.shape),
                        proto)
    _, bank, _ = jax.vmap(lambda a, b: jl.lbgm_topk_client_step(
        a, b, -1.0, k_frac))(_j(_grads(7)), bank)
    return bank


@pytest.mark.parametrize("sparse_out", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("delta", [-1.0, 0.7, 1.0])
def test_topk_step_matches(sparse_out, fused, delta):
    """The port's top-k step, with the sparse ``(send, gscale)`` contract
    or the dense scatter, fused or not, against the JAX package's unfused
    step: the same decisions, the same banks (index sets and order), the
    same payloads."""
    k_frac = 0.1
    bank = _refreshed_bank(k_frac)
    g = _grads(8, like={k: v for k, v in _grads(7).items()}, noise=0.8)
    jout, jnl, jst = jax.vmap(lambda a, b: jl.lbgm_topk_client_step(
        a, b, delta, k_frac, sparse_out=sparse_out))(_j(g), bank)
    tout, tnl, tst = tl.lbgm_topk_client_step(
        _t(g), _t(bank), delta, k_frac, sparse_out=sparse_out, fused=fused)
    _stats_match(tst, jst)
    if delta == 1.0:
        assert tst.sent_scalar.all()      # the recycle branch ran
    if delta == -1.0:
        assert not tst.sent_scalar.any()
    _equal(tnl, jnl)
    if sparse_out:
        (tsend, tgs), (jsend, jgs) = tout, jout
        _equal(tsend, jsend)
        np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs), rtol=1e-5)
    else:
        _close(tout, jout)


def test_sparse_out_reproduces_dense_g_tilde():
    k_frac = 0.1
    bank = _t(_refreshed_bank(k_frac))
    g = _t(_grads(8, like=_grads(7), noise=0.8))
    gt, _, st = tl.lbgm_topk_client_step(g, bank, 1.0, k_frac)
    (send, gscale), _, st2 = tl.lbgm_topk_client_step(g, bank, 1.0, k_frac,
                                                      sparse_out=True)
    assert torch.equal(st.sent_scalar, st2.sent_scalar)
    for name, leaf in g.items():
        dense = tl.leaf_scatter(send[name], leaf.shape[1:],
                                int(leaf[0].numel()), k_frac)
        np.testing.assert_allclose(
            (dense * gscale.reshape(-1, *[1] * (dense.dim() - 1))).numpy(),
            gt[name].numpy(), rtol=1e-5, atol=1e-7)


def test_trim_pad_is_bit_identical_and_matches_jax():
    g = _grads(3)["w"]
    assert tl._block_layout(g[0].size, 0.1)[0] == 16  # pad rows exist
    tg = torch.from_numpy(g)
    a = tl.leaf_topk(tg, 0.1)
    b = tl.leaf_topk(tg, 0.1, trim_pad=True)
    assert torch.equal(a["idx"], b["idx"]) and torch.equal(a["val"],
                                                           b["val"])
    ga = tl.leaf_sparse_gather(tg, a, 0.1)
    gb = tl.leaf_sparse_gather(tg, a, 0.1, trim_pad=True)
    assert torch.equal(ga, gb)
    j = jax.vmap(lambda x: jl.leaf_topk(x, 0.1, trim_pad=True))(
        jnp.asarray(g))
    _equal(b, j)
    jg = jax.vmap(lambda x, s: jl.leaf_sparse_gather(x, s, 0.1,
                                                     trim_pad=True))(
        jnp.asarray(g), j)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jg))


def test_init_and_scatter_match():
    params = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    tp = tl.init_topk_lbg(_t(params), 0.1)
    jp = jl.init_topk_lbg(_j(params), 0.1)
    assert sorted(tp) == sorted(jp)
    for name in tp:
        for part in ("idx", "val"):
            assert tuple(tp[name][part].shape) == jp[name][part].shape
            assert str(tp[name][part].dtype).split(".")[-1] == \
                str(jp[name][part].dtype)
    g = _grads(4)["w"]
    sp = jax.vmap(lambda x: jl.leaf_topk(x, 0.1))(jnp.asarray(g))
    want = jax.vmap(lambda s: jl.leaf_scatter(s, (700, 128), 89600, 0.1))(sp)
    got = tl.leaf_scatter(_t(sp), (700, 128), 89600, 0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_corollary1_threshold_matches():
    gsq = np.array([0.0, 1e-3, 1.0, 50.0], np.float32)
    for tau, T in ((2, 100), (5, 10)):
        want = jl.corollary1_threshold(jnp.asarray(gsq), tau, T)
        got = tl.corollary1_threshold(torch.from_numpy(gsq), tau, T)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6)

"""The port's uplink compressors (``repro_torch.compression``) against the
JAX package's (``repro.compression``), on the same numpy inputs.

The port's compressors take a chunk's clients at once (leaves ``(C,
...)``); the JAX package's take one client. Top-K and error feedback are
exact (top-K keeps ``lax.top_k``'s tie rule: the lowest index wins);
SignSGD's per-leaf mean |g| is a sum in another order (rtol 1e-6); ATOMO's
SVD is another LAPACK path, held at rtol 1e-4 on inputs with a gap after
rank r (atol 1e-5 for entries that cancel). The power method starts from
the JAX package's draw (replayed by ``repro_torch.core.jax_prng``); here
it is held to the SVD's error, as ``tests/test_compression.py`` holds the
JAX package's, and ``tests/test_torch_faults.py`` holds its iterates
against the JAX package. Every uplink cost is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and spinning
# OpenMP threads would starve the other workers' threads
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro import compression as jcomp  # noqa: E402
from repro.compression import error_feedback as jef  # noqa: E402
from repro_torch import compression as tcomp  # noqa: E402
from repro_torch.compression import atomo, signsgd, topk  # noqa: E402

SHAPES = {"fc1/w": (33, 20), "fc1/b": (20,), "conv/w": (3, 3, 2, 4),
          "s": ()}


def _grads(rng, C, kind="normal"):
    g = {n: rng.randn(C, *s).astype(np.float32) for n, s in SHAPES.items()}
    if kind == "ties":
        g = {n: np.round(v * 2) / 2 for n, v in g.items()}
    return g


def _jax_per_client(fn, g, C):
    """Run a one-client JAX compressor on each client; stack the outputs."""
    outs, costs = [], []
    for c in range(C):
        out, cost = fn({n: jnp.asarray(v[c]) for n, v in g.items()})
        outs.append({n: np.asarray(v) for n, v in out.items()})
        costs.append(float(cost))
    return {n: np.stack([o[n] for o in outs]) for n in g}, costs


def _torch(g):
    return {n: torch.from_numpy(v) for n, v in g.items()}


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("k_frac", [0.1, 0.25, 0.5])
def test_topk_matches_jax(kind, k_frac):
    C = 3
    g = _grads(np.random.RandomState(0), C, kind)
    want, wcost = _jax_per_client(
        lambda x: jcomp.get_compressor("topk", k_frac=k_frac)(x), g, C)
    got, cost = tcomp.get_compressor("topk", k_frac=k_frac)(_torch(g))
    for n in g:
        np.testing.assert_array_equal(got[n].numpy(), want[n])
    assert cost.tolist() == wcost


def test_topk_ties_keep_the_lowest_index():
    g = torch.tensor([[1.0, -2.0, 2.0, 0.5, -2.0]])
    out, cost = topk.compress({"w": g}, k_frac=0.4)       # k = 2
    assert out["w"].tolist() == [[0.0, -2.0, 2.0, 0.0, 0.0]]
    assert cost.tolist() == [3.0]


def test_signsgd_matches_jax():
    C = 4
    g = _grads(np.random.RandomState(1), C)
    g["fc1/b"][1] = 0.0                                   # sign(0) = 0
    want, wcost = _jax_per_client(jcomp.get_compressor("signsgd"), g, C)
    got, cost = signsgd.compress(_torch(g))
    for n in g:
        np.testing.assert_allclose(got[n].numpy(), want[n], rtol=1e-6)
        np.testing.assert_array_equal(np.sign(got[n].numpy()),
                                      np.sign(want[n]))
    assert cost.tolist() == wcost


def _gapped(rng, C, m, n, rank):
    """(C, m, n) matrices with singular values 10, 8, .. down to rank r,
    then a drop to 1e-2 or below: a gap after rank r."""
    out = []
    for _ in range(C):
        u, _ = np.linalg.qr(rng.randn(m, m))
        v, _ = np.linalg.qr(rng.randn(n, n))
        k = min(m, n)
        s = np.concatenate([10.0 - 2.0 * np.arange(rank),
                            1e-2 * rng.rand(k - rank)])
        out.append((u[:, :k] * s) @ v[:, :k].T)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_atomo_svd_matches_jax(rank):
    rng = np.random.RandomState(2)
    C = 3
    g = {"a": _gapped(rng, C, 12, 9, rank),
         "b": _gapped(rng, C, 4, 30, rank).reshape(C, 4, 5, 6),
         "v": rng.randn(C, 7).astype(np.float32),         # rank 1 as (1, n)
         "s": rng.randn(C).astype(np.float32)}            # (1, 1)
    want, wcost = _jax_per_client(
        lambda x: jcomp.get_compressor("atomo", rank=rank)(x), g, C)
    got, cost = tcomp.get_compressor("atomo", rank=rank)(_torch(g))
    for n in g:
        assert got[n].shape == g[n].shape
        np.testing.assert_allclose(got[n].numpy(), want[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    assert cost.tolist() == wcost


def test_atomo_power_iteration_close_to_svd():
    rng = np.random.RandomState(1)
    g = torch.from_numpy(rng.randn(2, 32, 16).astype(np.float32))
    svd_out, c1 = atomo.compress({"w": g}, rank=4, method="svd")
    pow_out, c2 = atomo.compress({"w": g}, rank=4, method="power")
    assert c1.tolist() == c2.tolist() == [4 * 48.0] * 2
    for c in range(2):
        e_svd = float((svd_out["w"][c] - g[c]).norm())
        e_pow = float((pow_out["w"][c] - g[c]).norm())
        assert e_pow <= 1.5 * e_svd + 1e-3
    # a fixed draw: the same result twice
    again, _ = atomo.compress({"w": g}, rank=4, method="power")
    assert torch.equal(again["w"], pow_out["w"])


def test_error_feedback_matches_jax_and_telescopes():
    """EF with top-K, 5 steps, against the JAX package; and its invariant
    sum_t compressed_t = sum_t g_t - residual_T."""
    rng = np.random.RandomState(3)
    C = 2
    fn, uses = tcomp.make_uplink_pipeline("topk", {"k_frac": 0.25})
    assert uses
    jfn, juses = jcomp.make_uplink_pipeline("topk", {"k_frac": 0.25})
    assert juses
    res = {"w": torch.zeros(C, 16)}
    jres = [{"w": jnp.zeros(16)} for _ in range(C)]
    total_g = np.zeros((C, 16))
    total_c = np.zeros((C, 16))
    for t in range(5):
        g = rng.randn(C, 16).astype(np.float32)
        c_t, res, cost = fn({"w": torch.from_numpy(g)}, res)
        for c in range(C):
            jc, jres[c], jcost = jfn({"w": jnp.asarray(g[c])}, jres[c])
            np.testing.assert_array_equal(c_t["w"][c].numpy(),
                                          np.asarray(jc["w"]))
            np.testing.assert_array_equal(res["w"][c].numpy(),
                                          np.asarray(jres[c]["w"]))
            assert float(cost[c]) == float(jcost)
        total_g += g
        total_c += c_t["w"].numpy()
    np.testing.assert_allclose(total_c + res["w"].numpy(), total_g,
                               rtol=1e-4, atol=1e-5)
    # the JAX module's own apply agrees with the pipeline's
    jc, jr, _ = jef.apply(jcomp.get_compressor("topk", k_frac=0.25),
                          {"w": jnp.ones(16)}, {"w": jnp.zeros(16)})
    assert np.asarray(jc["w"]).sum() + np.asarray(jr["w"]).sum() == 16


@pytest.mark.parametrize("name,ef,uses", [
    ("none", None, False), ("topk", None, True), ("topk", False, False),
    ("signsgd", None, False), ("signsgd", True, True), ("atomo", None, False),
    ("none", True, False)])
def test_pipeline_error_feedback_policy(name, ef, uses):
    """Error feedback defaults to on iff top-K, never for ``none``; without
    it the residual passes through untouched."""
    fn, got = tcomp.make_uplink_pipeline(name, None, ef)
    assert got == uses == jcomp.make_uplink_pipeline(name, None, ef)[1]
    g = {"w": torch.randn(2, 8)}
    res = {"w": torch.full((2, 8), 0.5)}
    out, res2, cost = fn(g, res)
    assert cost.shape == (2,)
    if not uses:
        assert res2 is res


def test_compressor_kwargs_are_checked():
    with pytest.raises(ValueError, match="accepted kwargs"):
        tcomp.get_compressor("topk", rank=2)
    with pytest.raises(ValueError, match="unknown compressor"):
        tcomp.get_compressor("zstd")

"""The paper's gradient-space PCA (``analysis/pca.py``) in both packages.

The same gradient dicts (numpy, handed to JAX as jnp arrays and to the
port as torch tensors) go through both trackers. ``n95``/``n99`` must be
exactly equal (the same fp32 host matrix and numpy's SVD on both sides),
the heat maps equal to 1e-6, and above ``max_dim`` the coordinate
subsample the same indices: the port flattens the leaves in sorted key
order, as ``jax.tree.leaves`` does for a dict, whatever order the dict
was built in.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.analysis import pca as jpca  # noqa: E402
from repro_torch.analysis import pca as tpca  # noqa: E402

#: leaf shapes, in an insertion order that is not sorted
SHAPES = {"w2": (16, 10), "b1": (16,), "w1": (24, 16), "b2": (10,),
          "conv/k": (3, 3, 2)}


def _grads(epochs, rank, seed=0, noise=1e-3):
    """Per-epoch gradient dicts that lie near a ``rank``-dim subspace."""
    rng = np.random.RandomState(seed)
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    basis = rng.randn(rank, n)
    out = []
    for _ in range(epochs):
        flat = rng.randn(rank) @ basis + noise * rng.randn(n)
        g, i = {}, 0
        for k, s in SHAPES.items():
            size = int(np.prod(s))
            g[k] = flat[i:i + size].reshape(s).astype(np.float32)
            i += size
        out.append(g)
    return out


def _trackers(grads, **kw):
    jt, tt = jpca.GradientSpaceTracker(**kw), tpca.GradientSpaceTracker(**kw)
    for g in grads:
        jt.add({k: jnp.asarray(v) for k, v in g.items()})
        tt.add({k: torch.from_numpy(v) for k, v in g.items()})
    return jt, tt


def test_flatten_grad_order_is_jax_tree_leaves():
    g = _grads(1, 2)[0]
    want = jpca.flatten_grad({k: jnp.asarray(v) for k, v in g.items()})
    got = tpca.flatten_grad({k: torch.from_numpy(v) for k, v in g.items()})
    assert got.dtype == np.float32 and np.array_equal(got, want)
    # nested dicts and sequences too, and bf16 leaves as fp32
    nested = {"b": [torch.ones(2), torch.zeros(1)],
              "a": {"y": torch.full((2,), 3.0, dtype=torch.bfloat16),
                    "x": torch.arange(3.0)}}
    assert tpca.flatten_grad(nested).tolist() == [0, 1, 2, 3, 3, 1, 1, 0]


@pytest.mark.parametrize("rank,epochs", [(3, 12), (1, 5), (8, 8)])
def test_tracker_matches_jax(rank, epochs):
    jt, tt = _trackers(_grads(epochs, rank))
    assert tt.n95 == jt.n95 and tt.n99 == jt.n99
    assert tt.summary() == jt.summary()
    assert np.array_equal(tt.matrix(), jt.matrix())
    for got, want in zip(tt.heatmaps(), jt.heatmaps()):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for v in (0.9, 0.99):
        assert tpca.n_pca(tt.matrix(), v) == jpca.n_pca(jt.matrix(), v)


def test_low_rank_is_detected():
    _, tt = _trackers(_grads(20, 3, noise=1e-6))
    assert tt.n99[-1] <= 3 and tt.n95[0] == 1


def test_subsample_above_max_dim_picks_the_same_coordinates():
    jt, tt = _trackers(_grads(6, 2, seed=1), max_dim=100, seed=7)
    assert np.array_equal(tt._proj, jt._proj)
    assert tt.matrix().shape == (6, 100)
    assert np.array_equal(tt.matrix(), jt.matrix())
    assert tt.n95 == jt.n95 and tt.n99 == jt.n99


def test_cosine_and_directions_match_jax():
    m = np.random.RandomState(3).randn(7, 40).astype(np.float32)
    np.testing.assert_allclose(tpca.cosine_matrix(m, m[:3]),
                               jpca.cosine_matrix(m, m[:3]), rtol=1e-6,
                               atol=1e-6)
    assert np.array_equal(tpca.pca_directions(m, 0.95),
                          jpca.pca_directions(m, 0.95))
    assert tpca.n_pca(m[:1], 0.99) == 1

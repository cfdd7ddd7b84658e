"""Three faults of the port against the JAX package, each pinned here.

1. ``RoundPrefetcher.next()`` after ``close()`` must raise, whatever the
   queue holds: a producer blocked in ``put()`` on a full queue lands its
   round after ``close()``'s first drain. A stub engine holds the producer
   inside ``put()`` until that drain is done, so the race is forced on every
   trial (no sleeps); 200 trials out of 200 must raise, and no staged round
   may remain queued.
2. ATOMO's power method starts every leaf from the JAX package's draw,
   ``jax.random.normal(PRNGKey(0), (n, r), float32)``, replayed in NumPy by
   ``repro_torch.core.jax_prng``: the threefry bits equal ``jax.random.bits``
   exactly (every leaf shape of the paper FCN and CNN, and the (n, r) starts
   ATOMO draws for them), the normals ``jax.random.normal`` within rtol
   1e-6 (XLA's ``erf_inv`` polynomial, evaluated with NumPy's ``log1p``),
   and ``atomo.compress(method="power")`` the JAX package's reconstructed
   leaves at rank 2 and 4 within rtol 1e-4 / atol 1e-5 (``approx`` does not
   depend on the QR's column signs).
3. Value-order top-k past kb = 16384 runs on the card; its exactness
   against the port's plain decision is held by
   ``tests/test_torch_kernel_edges_gpu.py`` and ``chip_smoke.py``. Here:
   that plain decision equals the JAX package's ``lax.top_k`` decision at
   kb = 16385, 32768 and 65536, ties and an all-zero row included.
"""
import queue
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compression import atomo as jatomo  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.compression import atomo  # noqa: E402
from repro_torch.core import jax_prng  # noqa: E402
from repro_torch.fed import engine  # noqa: E402
from repro_torch.kernels import lbgm_sparse as ks  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# ------------------------------------------------------- 1. the prefetcher


class _StubEngine:
    """What ``RoundPrefetcher`` calls on an engine: numbered rounds."""
    _copy_stream = None
    _host_bank = False

    def __init__(self):
        self.rounds = 0

    def _capture_host_state(self, rng):
        return None

    def _restore_host_state(self, host, rng):
        pass

    def _sample_batches(self, rng):
        self.rounds += 1
        return self.rounds

    def _sample_mask(self, rng):
        return None

    def _stage(self, host, stream=None):
        return host, None


def _gated_queue(entered: threading.Event, drained: threading.Event):
    """A queue whose ``put()`` on a full queue signals ``entered`` and then
    holds the producer until ``get_nowait()`` has found the queue empty
    (``close()``'s drain), so that put lands after the drain."""

    class Gated(queue.Queue):
        def put(self, item, block=True, timeout=None):
            if self.full():
                entered.set()
                assert drained.wait(10), "close() never drained the queue"
            super().put(item, block, None)

        def get_nowait(self):
            try:
                return super().get_nowait()
            except queue.Empty:
                drained.set()
                raise

    return Gated


def test_prefetcher_next_after_close_raises_every_time(monkeypatch):
    for trial in range(200):
        entered, drained = threading.Event(), threading.Event()
        monkeypatch.setattr(engine, "queue", types.SimpleNamespace(
            Queue=_gated_queue(entered, drained), Full=queue.Full,
            Empty=queue.Empty))
        pf = engine.RoundPrefetcher(_StubEngine(),
                                    np.random.RandomState(trial), depth=1)
        assert entered.wait(10), "the producer never blocked in put()"
        pf.close()
        assert not pf._thread.is_alive()
        with pytest.raises(RuntimeError, match="after close"):
            pf.next()
        assert pf._q.empty(), f"trial {trial}: a staged round outlived close()"


def test_prefetcher_serves_rounds_in_order_before_close():
    pf = engine.RoundPrefetcher(_StubEngine(), np.random.RandomState(0),
                                depth=2)
    try:
        assert [pf.next()[0] for _ in range(5)] == [1, 2, 3, 4, 5]
    finally:
        pf.close()
    with pytest.raises(RuntimeError, match="after close"):
        pf.next()


# ---------------------------------------------- 2. the JAX draw and ATOMO

#: every leaf of the paper FCN and CNN
PAPER_LEAVES = {
    "fcn": {"fc1/w": (784, 128), "fc1/b": (128,), "fc2/w": (128, 10),
            "fc2/b": (10,)},
    "cnn": {"conv0/w": (3, 3, 1, 32), "conv0/b": (32,),
            "conv1/w": (3, 3, 32, 32), "conv1/b": (32,),
            "conv2/w": (3, 3, 32, 64), "conv2/b": (64,),
            "conv3/w": (3, 3, 64, 64), "conv3/b": (64,),
            "fc/w": (3136, 10), "fc/b": (10,)},
}


def _atomo_start_shape(shape, rank):
    """The (n, r) start ATOMO draws for one client's leaf of ``shape``."""
    if len(shape) <= 1:
        m, n = 1, (int(np.prod(shape)) if shape else 1)
    else:
        m, n = shape[0], int(np.prod(shape[1:]))
    return (n, min(rank, m, n))


def _draw_shapes():
    shapes = {(5,), (7, 9), (3, 5, 2), (1,)}
    for leaves in PAPER_LEAVES.values():
        for shape in leaves.values():
            shapes.add(shape)
            for rank in (2, 4):
                shapes.add(_atomo_start_shape(shape, rank))
    return sorted(shapes)


def test_prng_key_is_jax_prng_key():
    for seed in (0, 1, 42, 2 ** 31 - 1, -1, 12345678901):
        want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
        np.testing.assert_array_equal(jax_prng.prng_key(seed), want)


@pytest.mark.parametrize("shape", _draw_shapes(), ids=str)
def test_threefry_bits_equal_jax_exactly(shape):
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = jax_prng.random_bits(jax_prng.prng_key(0), shape)
    assert got.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shape", [(784, 2), (3136, 4), (288, 4), (1000, 3)],
                         ids=str)
def test_normal_matches_jax(shape, seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))
    got = jax_prng.normal(jax_prng.prng_key(seed), shape)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    u_want = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), shape, jnp.float32,
        np.nextafter(np.float32(-1), np.float32(0)), 1.0))
    np.testing.assert_array_equal(
        jax_prng.uniform(jax_prng.prng_key(seed), shape,
                         np.nextafter(np.float32(-1), np.float32(0)), 1.0),
        u_want)


@pytest.mark.parametrize("model", sorted(PAPER_LEAVES))
@pytest.mark.parametrize("rank", [2, 4])
def test_atomo_power_iterates_match_jax(model, rank):
    rng = np.random.RandomState(rank)
    C = 2
    leaves = PAPER_LEAVES[model]
    g = {n: rng.randn(C, *s).astype(np.float32) for n, s in leaves.items()}
    got, cost = atomo.compress({n: torch.from_numpy(a) for n, a in g.items()},
                               rank=rank, method="power")
    for c in range(C):
        want, wcost = jatomo.compress({n: jnp.asarray(a[c])
                                       for n, a in g.items()},
                                      rank=rank, method="power")
        assert float(cost[c]) == wcost
        for n in g:
            np.testing.assert_allclose(got[n][c].numpy(),
                                       np.asarray(want[n]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{n} client {c}")


# ------------------------------------------- 3. value order past 16384


@pytest.mark.parametrize("kb", [16385, 32768, 65536])
def test_value_order_past_the_shared_sort_matches_jax(kb):
    """The port's plain decision, which the card's value-order path past
    16384 keys is held against exactly, equals the JAX package's
    ``lax.top_k`` decision there: half-integer values (many ties, and an
    exact ||g||^2 in any order) and an all-zero row."""
    rng = np.random.RandomState(kb)
    g = np.round(rng.randn(3, 65536) * 2).astype(np.float32) / 2
    g[2] = 0.0
    idx = np.stack([rng.permutation(65536)[:kb]
                    for _ in range(3)]).astype(np.int32)
    got = ks.lbgm_sparse_decision_batched(torch.from_numpy(g)[None],
                                          torch.from_numpy(idx)[None])
    want = jref.lbgm_sparse_decision_ref(jnp.asarray(g), jnp.asarray(idx))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))

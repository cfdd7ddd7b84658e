"""The sparse decision on the flat leaf, and the projection over a leaf table.

The fused top-k path hands the decision the flat leaf ``(C, size)`` with
``block=``, not the zero-padded ``(C, nb, block)`` layout: the result must
be the padded layout's, bit for bit, through the plain version here (the
kernel's form on the card is held against it in
``tests/test_torch_kernel_edges_gpu.py`` and ``chip_smoke.py``), and must
match the JAX package's batched Pallas kernels run on the padded layout in
interpret mode, as ``test_torch_kernels.py`` runs them. The projection's
one call over every leaf of a chunk must give the per-leaf sums added in
sorted key order exactly (``float(a) == float(w)``).

Tolerances: index sets and orders, selected and gathered values exactly;
||g||^2 against JAX rtol 1e-5 (another summation order), against the
padded layout of the port exactly (the same arithmetic).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lbgm_sparse import (  # noqa: E402
    lbgm_sparse_decision_batched_pallas,
    lbgm_sparse_decision_two_pass_batched_pallas)
from repro_torch.core import lbgm as tl  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.lbgm_projection import (  # noqa: E402
    lbgm_projection_batched, lbgm_projection_leaves)
from repro_torch.kernels.lbgm_sparse import (  # noqa: E402
    lbgm_sparse_decision_batched)

#: the paper FCN's leaves in sorted key order: fc1/b, fc1/w, fc2/b, fc2/w
FCN_SIZES = [128, 100352, 10, 1280]


def _flat_case(rng, C, size, block, nb, kb, kind="normal"):
    x = rng.randn(C, size).astype(np.float32)
    if kind == "sparse_tail":
        # the last live row: fewer nonzeros than kb, its zeros running
        # into the virtual zeros past `size`
        tail = size - (size - 1) // block * block
        x[:, size - tail:] = np.where(rng.rand(C, tail) < 0.5,
                                      x[:, size - tail:], 0.0)
    elif kind == "edge_ties":
        # ties of one magnitude up to the last live element, zeros after
        x = np.where(rng.rand(C, size) < 0.2, x, 0.0)
        x[:, -4:] = 0.0
        x[:, -9:-4] = np.float32(-0.75)
    idx = np.argsort(rng.rand(C, nb, block), -1)[..., :kb].astype(np.int32)
    return x.astype(np.float32), idx


def _assert_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", FCN_SIZES)
def test_flat_leaf_equals_padded_layout(size, dtype, two_pass):
    """The FCN's four leaves at k_frac 0.1: the flat form gives the padded
    layout's outputs bit for bit (gg included)."""
    nb, block, kb = tl._block_layout(size, 0.1)
    rng = np.random.RandomState(size)
    x, idx = _flat_case(rng, 2, size, block, nb, kb)
    g = torch.from_numpy(x).to(getattr(torch, dtype))
    ti = torch.from_numpy(idx)
    flat = lbgm_sparse_decision_batched(g, ti, two_pass, block=block)
    padded = lbgm_sparse_decision_batched(
        tref.flat_to_blocks(g, nb, block), ti, two_pass)
    _assert_equal(flat, padded)
    assert flat[2].shape == (2, nb, kb)


#: (size, block, nb, kb, kind): three live rows of 256 and one pad row; a
#: partly live last row with fewer nonzeros than kb; ties at zero across
#: the live/pad edge; a one-row leaf
SMALL = [(600, 256, 4, 11, "normal"), (517, 256, 4, 11, "sparse_tail"),
         (700, 256, 4, 40, "edge_ties"), (90, 90, 1, 9, "edge_ties")]


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("case", SMALL, ids=str)
def test_flat_leaf_matches_pallas(case, two_pass):
    """The flat form against the JAX package's batched Pallas kernel in
    interpret mode on the padded layout: value order exactly, the two-pass
    form as a set (its kernel lists the entries above the threshold, then
    the ties)."""
    size, block, nb, kb, kind = case
    rng = np.random.RandomState(size + kb)
    x, idx = _flat_case(rng, 3, size, block, nb, kb, kind)
    padded = np.zeros((3, nb * block), np.float32)
    padded[:, :size] = x
    pallas = (lbgm_sparse_decision_two_pass_batched_pallas if two_pass
              else lbgm_sparse_decision_batched_pallas)
    want = pallas(jnp.asarray(padded.reshape(3, nb, block)),
                  jnp.asarray(idx), interpret=True)
    got = lbgm_sparse_decision_batched(torch.from_numpy(x),
                                       torch.from_numpy(idx), two_pass,
                                       block=block)
    gg, gath, ti, tv = (np.asarray(a) for a in got)
    wgg, wgath, wti, wtv = (np.asarray(a) for a in want)
    np.testing.assert_allclose(gg, wgg, rtol=1e-5)
    np.testing.assert_array_equal(gath, wgath)
    if two_pass:
        o, wo = np.argsort(ti, -1), np.argsort(wti, -1)
        ti, tv = (np.take_along_axis(a, o, -1) for a in (ti, tv))
        wti, wtv = (np.take_along_axis(a, wo, -1) for a in (wti, wtv))
    np.testing.assert_array_equal(ti, wti)
    np.testing.assert_array_equal(tv, wtv)
    for r in range(-(-size // block), nb):  # pad rows: (iota, 0)
        np.testing.assert_array_equal(
            got[2][:, r].numpy(), np.broadcast_to(np.arange(kb), (3, kb)))
        assert not got[3][:, r].any()


@pytest.mark.parametrize("kind", ["sparse_tail", "edge_ties"])
def test_flat_leaf_bf16_matches_jax_ref(kind):
    """bf16 flat leaves against the JAX plain version of the padded bf16
    layout, client by client."""
    size, block, nb, kb = 517, 256, 4, 11
    rng = np.random.RandomState(5)
    x, idx = _flat_case(rng, 2, size, block, nb, kb, kind)
    padded = np.zeros((2, nb * block), np.float32)
    padded[:, :size] = x
    jx = jnp.asarray(padded.reshape(2, nb, block)).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    got = lbgm_sparse_decision_batched(
        tx.reshape(2, -1)[:, :size].contiguous(), torch.from_numpy(idx),
        block=block)
    for c in range(2):
        want = jref.lbgm_sparse_decision_ref(jx[c], jnp.asarray(idx[c]))
        np.testing.assert_allclose(np.asarray(got[0][c]),
                                   np.asarray(want[0]), rtol=1e-5)
        for a, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a[c].numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse_out", [False, True])
def test_fused_topk_step_same_bits_as_padded_copy(sparse_out, dtype,
                                                  monkeypatch):
    """The engine's fused top-k step now hands the decision the flat leaf;
    on the CPU it gives the same bits as the padded fp32 copy it made
    before (``_to_blocks``)."""
    rng = np.random.RandomState(3)
    C = 3
    shapes = {"w": (700, 128), "b": (64,), "a": (5, 3)}
    grad = {k: torch.from_numpy(rng.randn(C, *s).astype(np.float32)).to(
        getattr(torch, dtype)) for k, s in shapes.items()}
    k_frac = 0.05
    bank = {}
    for k, g in grad.items():
        nb, block, kb = tl._block_layout(int(g[0].numel()), k_frac)
        bank[k] = {"idx": torch.from_numpy(np.argsort(
            rng.rand(C, nb, block), -1)[..., :kb].astype(np.int32)),
            "val": torch.from_numpy(rng.randn(C, nb, kb).astype(np.float32))}

    def padded_copy(g, idx, block=None):
        return ops.lbgm_sparse_decision(
            tl._to_blocks(g, idx.shape[1], block), idx)

    new = tl.topk_step_core(grad, bank, 0.5, k_frac, sparse_out=sparse_out,
                            fused=True)
    monkeypatch.setattr(tl, "lbgm_sparse_decision", padded_copy)
    old = tl.topk_step_core(grad, bank, 0.5, k_frac, sparse_out=sparse_out,
                            fused=True)
    flat_new = torch.utils._pytree.tree_leaves(new)
    flat_old = torch.utils._pytree.tree_leaves(old)
    assert len(flat_new) == len(flat_old)
    for a, b in zip(flat_new, flat_old):
        assert torch.equal(a, b)


def test_flat_form_wrapper_refuses_bad_shapes():
    g = torch.zeros(2, 300)
    idx = torch.zeros(2, 2, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="block="):
        lbgm_sparse_decision_batched(g, idx)
    with pytest.raises(ValueError, match="size"):
        lbgm_sparse_decision_batched(g, idx, block=100)   # 300 > 2 * 100
    with pytest.raises(ValueError):
        lbgm_sparse_decision_batched(g.reshape(2, 2, 150), idx, block=150)
    with pytest.raises(ValueError):
        lbgm_sparse_decision_batched(g, idx[:1], block=150)


# ---------------------------------------------------- projection's table

def _tree(rng, C, shapes, dtype=torch.float32):
    return {k: torch.from_numpy(rng.randn(C, *s).astype(np.float32)).to(dtype)
            for k, s in shapes.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_projection_one_call_equals_per_leaf_sum(dtype):
    """``ops.lbgm_projection``'s one call over every leaf equals the
    per-leaf calls added in sorted key order, exactly."""
    rng = np.random.RandomState(1)
    dt = getattr(torch, dtype)
    shapes = {"fc2/w": (10, 128), "fc1/b": (128,), "fc2/b": (10,),
              "fc1/w": (784, 128)}
    g, l = _tree(rng, 4, shapes, dt), _tree(rng, 4, shapes, dt)
    got = ops.lbgm_projection(g, l)
    want = None
    for k in sorted(g):
        part = lbgm_projection_batched(g[k].reshape(4, -1),
                                       l[k].reshape(4, -1))
        want = part if want is None else tuple(a + b for a, b in
                                               zip(want, part))
    for a, w in zip(got, want):
        assert a.shape == (4,) and a.dtype == torch.float32
        for c in range(4):
            assert float(a[c]) == float(w[c])


def test_projection_leaves_refuse_disagreeing_leaves():
    a32, b16 = torch.zeros(3, 5), torch.zeros(3, 7, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        lbgm_projection_leaves([a32, b16], [a32, b16])
    with pytest.raises(TypeError, match="dtype"):
        ops.lbgm_projection({"a": a32, "b": b16}, {"a": a32, "b": b16})
    with pytest.raises(ValueError, match="client count"):
        lbgm_projection_leaves([a32, torch.zeros(2, 5)],
                               [a32, torch.zeros(2, 5)])
    with pytest.raises(ValueError):
        lbgm_projection_leaves([a32], [torch.zeros(3, 6)])
    with pytest.raises(ValueError):
        lbgm_projection_leaves([], [])


def test_launch_shapes_reset_with_the_counts():
    _build.reset_launch_counts()
    _build.count_launch("lbgm_projection", ((10, 5), (10, 7)))
    _build.count_launch("lbgm_projection", ((10, 5), (10, 7)))
    assert _build.LAUNCHES["lbgm_projection"] == 2
    assert _build.LAUNCH_SHAPES["lbgm_projection"] == {((10, 5), (10, 7)): 2}
    _build.reset_launch_counts()
    assert _build.LAUNCHES["lbgm_projection"] == 0
    assert _build.LAUNCH_SHAPES["lbgm_projection"] == {}


def test_value_order_placement_refuses_unknown_names():
    from repro_torch.kernels import lbgm_sparse as ks
    with pytest.raises(ValueError, match="placement"):
        ks.set_placement("bitonic")


@pytest.mark.parametrize("name, shape", [
    ("flash_attention", (4, 4096, 4096, 16, 8, 128)),
    ("rwkv6_scan", (4, 4096, 40, 64))])
def test_every_wrapper_counts_launches_by_shape(name, shape):
    _build.reset_launch_counts()
    _build.count_launch(name, shape)
    assert _build.LAUNCHES[name] == 1
    assert _build.LAUNCH_SHAPES[name] == {shape: 1}
    _build.reset_launch_counts()

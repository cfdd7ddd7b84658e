"""The training mesh's placement rules against the JAX package's, in one
process with no ranks.

Every arch of ``ASSIGNED_ARCHS`` at full width, its train state and
decode state as ``launch.specs`` lays them out (``jax.eval_shape`` in the
JAX package, ``meta`` tensors in the port), on ``abstract_mesh`` at
(16, 16) and (2, 4) on ("data", "model") and (2, 16, 16) on ("pod",
"data", "model"). The port's specs equal each ``NamedSharding``'s
``.spec`` as a tuple, leaf for leaf:

* ``train.trainer.train_state_shardings`` with both ``embed_shard``
  values (the dense bank ``(dp, *param spec)`` in replicated mode, the
  sparse bank ``(None, "model", None)`` where the blocks divide), at the
  clients of ``effective_clients`` for ``train_4k``;
* ``train.trainer.batch_shardings`` of ``launch.specs.train_batch_specs``;
* ``train.sharding.state_shardings`` of the decode state at
  ``decode_32k`` and ``long_500k`` (``cache_pspec``);
* ``core.lbgm_sharded.sharded_lbg_layout``'s shapes, dtypes and specs for
  the top-k archs, its ``gspecs`` from ``train_state_shardings``, and
  ``init_sharded_lbg`` on ``meta``;
* ``dp_axes``, ``batch_pspec`` and ``stacked_pspec``;
* ``launch.mesh.make_production_mesh`` refuses this one-process world,
  naming ``abstract_mesh``, and starts no process group.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import lbgm_sharded as jls  # noqa: E402
from repro.launch import specs as jsp  # noqa: E402
from repro.train import sharding as jsh  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import lbgm_sharded as tls  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tsp  # noqa: E402
from repro_torch.train import sharding as tsh  # noqa: E402
from repro_torch.train import trainer as ttr  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
TOPK = [a for a in ASSIGNED_ARCHS if get_config(a).lbgm.variant == "topk"]
DECODE = ("decode_32k", "long_500k")


def meshes(name):
    """(the JAX package's AbstractMesh, the port's MeshAxes) of ``name``."""
    sizes, names = MESHES[name]
    return jsh.abstract_mesh(sizes, names), tsh.abstract_mesh(sizes, names)


def specs_of(tree):
    """A tree of ``NamedSharding`` (or ``PartitionSpec``) as plain dicts
    of spec tuples."""
    return jax.tree.map(
        lambda s: tuple(getattr(s, "spec", s)), tree,
        is_leaf=lambda x: isinstance(x, (jax.sharding.NamedSharding,
                                         jax.sharding.PartitionSpec)))


def clients(arch, mesh_name):
    """The train_4k clients of ``arch`` on the mesh, in both packages."""
    jm, tm = meshes(mesh_name)
    gb = INPUT_SHAPES["train_4k"].global_batch
    k = jtr.effective_clients(jax_config(arch), jm, gb)
    dp = tsh.axes_size(tm, tsh.dp_axes(tm))
    assert ttr.effective_clients(get_config(arch), dp, gb) == k
    return k


@functools.lru_cache(maxsize=None)
def jax_train_state(arch, k):
    return jsp.abstract_train_state(jax_config(arch), k)


@functools.lru_cache(maxsize=None)
def torch_train_state(arch, k):
    return tsp.abstract_train_state(get_config(arch), k)


def shapes_of(tree):
    if isinstance(tree, dict):
        return {k: shapes_of(v) for k, v in tree.items()}
    return tuple(getattr(tree, "shape", ()))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_train_state_and_batch_shardings_match_jax(arch, mesh):
    jm, tm = meshes(mesh)
    k = clients(arch, mesh)
    jstate, jaxes = jax_train_state(arch, k)
    tstate, taxes = torch_train_state(arch, k)
    assert {n: tuple(v) for n, v in jaxes.items()} == taxes
    assert shapes_of(tstate) == jax.tree.map(lambda s: tuple(s.shape),
                                             jstate)
    for es in ("vocab", "embed"):
        want = specs_of(jtr.train_state_shardings(
            jstate, jaxes, jax_config(arch), jm, es))
        got = ttr.train_state_shardings(tstate, taxes, get_config(arch), tm,
                                        es)
        assert got == want, (arch, mesh, es)
    shape = INPUT_SHAPES["train_4k"]
    want = specs_of(jtr.batch_shardings(
        jsp.train_batch_specs(jax_config(arch), shape, k), jm))
    got = ttr.batch_shardings(
        tsp.train_batch_specs(get_config(arch), shape, k), tm)
    assert got == want
    tok = INPUT_SHAPES["decode_32k"]
    assert ttr.batch_shardings(tsp.decode_token_spec(tok), tm) == \
        tuple(jtr.batch_shardings(jsp.decode_token_spec(tok), jm).spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_decode_state_shardings_match_jax(arch, mesh):
    jm, tm = meshes(mesh)
    for name in DECODE:
        shape = INPUT_SHAPES[name]
        jstate, jaxes = jsp.abstract_decode_state(
            jax_config(arch), shape.global_batch, shape.seq_len)
        tstate, taxes = tsp.abstract_decode_state(
            get_config(arch), shape.global_batch, shape.seq_len)
        want = specs_of(jsh.state_shardings(jaxes, jstate, jm))
        got = tsh.state_shardings(taxes, tstate, tm)
        assert got == want, (arch, mesh, name)
        if "model" in tm.axis_names and tm.shape["model"] > 1:
            assert any("model" in s for s in jax.tree.leaves(
                got, is_leaf=lambda x: isinstance(x, tuple))), got


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", TOPK)
def test_sharded_lbg_layout_matches_jax(arch, mesh):
    jm, tm = meshes(mesh)
    k = clients(arch, mesh)
    jstate, jaxes = jax_train_state(arch, k)
    tstate, taxes = torch_train_state(arch, k)
    cfg = get_config(arch)
    for es in ("vocab", "embed"):
        jg = {n: s.spec for n, s in jtr.train_state_shardings(
            jstate, jaxes, jax_config(arch), jm, es)["params"].items()}
        tg = ttr.train_state_shardings(tstate, taxes, cfg, tm,
                                       es)["params"]
        jl, jsh_ = jls.sharded_lbg_layout(jstate["params"], jg, jm,
                                          cfg.lbgm.k_frac)
        tl, tsh_ = tls.sharded_lbg_layout(tstate["params"], tg, tm,
                                          cfg.lbgm.k_frac)
        assert tsh_ == specs_of(jsh_), (arch, mesh, es)
        assert sorted(tl) == sorted(jl)
        for name, leaf in jl.items():
            for f, s in leaf.items():
                t = tl[name][f]
                assert tuple(t.shape) == tuple(s.shape), (name, f)
                assert str(t.dtype).split(".")[-1] == str(s.dtype)
        bank = tls.init_sharded_lbg(tstate["params"], tg, tm,
                                    cfg.lbgm.k_frac, device="meta")
        assert {n: {f: (tuple(t.shape), t.dtype) for f, t in v.items()}
                for n, v in bank.items()} == \
            {n: {f: (tuple(t.shape), t.dtype) for f, t in v.items()}
             for n, v in tl.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_axes_and_lead_specs_match_jax(mesh):
    jm, tm = meshes(mesh)
    assert tm.axis_names == tuple(jm.axis_names)
    assert dict(tm.shape) == dict(jm.shape)
    assert tsh.dp_axes(tm) == jsh.dp_axes(jm)
    for n in range(4):
        assert tsh.batch_pspec(tm, n) == tuple(jsh.batch_pspec(jm, n))
    for base in ((), (None, "model"), ("model", None, None)):
        for lead in ((), ("data",), ("pod", "data"), "model"):
            assert tsh.stacked_pspec(base, lead) == tuple(
                jsh.stacked_pspec(jax.sharding.PartitionSpec(*base), lead))


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_production_mesh_refuses_one_process(multi_pod):
    """Not 256 (or 512) ranks: a RuntimeError naming the planning form,
    no smaller mesh, and no process group started to find that out."""
    import torch.distributed as dist
    was = dist.is_initialized()
    with pytest.raises(RuntimeError, match="abstract_mesh"):
        tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert dist.is_initialized() == was

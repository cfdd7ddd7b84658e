"""The ``"sharded"`` scheduler and the ``"topk-sharded"`` store of the
port, in one process: the world of one that ``launch.mesh`` starts when no
process group is up, so every mesh here is ``(1, 1)`` (the multi-rank
meshes are in ``test_torch_sharded_ranks.py``).

The port's counterparts of the JAX package's non-slow cases of
``test_sharded_scheduler.py`` and ``test_mesh2d.py`` (the
``model_sharding="auto"`` ones are in ``test_torch_tensor_parallel.py``):

* ``pick_sharded_chunk``, ``model_shard_rows`` and ``bank_model_partition``
  equal the JAX functions over a grid, and over the FCN's, CNN's and
  reduced qwen3's leaves at m in {1, 2, 4, 8};
* ``make_mesh_topk_step`` at m = 1 is ``TopKLBGStore.sparse_client_step``
  bit for bit, and the two stores are interchangeable bit for bit on
  ``"vmap"`` and ``"chunked"``;
* a ``(1, 1)`` mesh equals ``"chunked"`` bit for bit (history, params,
  banks): dense and top-k, with a padded chunk, sampling and error
  feedback; an int spec equals ``[n, 1]``;
* the port's ``(1, 1)`` fig5 run against the JAX package's ``"sharded"``
  run on its one CPU device, at the North star's tolerances (EXACT fields
  equal, loss rtol 1e-5, params rtol 1e-4 / atol 1e-6, no sin² within
  1e-5 of delta);
* a prefetch exception raised mid-run surfaces at the next round.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

from repro.core import lbgm_sharded as jls  # noqa: E402
from repro.fed import engine as jeng_mod  # noqa: E402
from repro.fed import experiment as jexp  # noqa: E402
from repro_torch.core import lbgm_sharded as tls  # noqa: E402
from repro_torch.fed import engine as teng_mod  # noqa: E402
from repro_torch.fed import experiment as texp  # noqa: E402
from repro_torch.fed.flconfig import FLConfig as TFL  # noqa: E402
from repro_torch.fed.registry import MODELS  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

EXACT = ("uplink_floats", "frac_scalar", "wire_bytes", "savings",
         "total_uplink", "vanilla_uplink", "total_wire_bytes",
         "wire_savings")
TOPK = {"lbg_variant": "topk", "lbg_kw": {"k_frac": 0.25}}


def spec(K=10, rounds=3, model="fcn", **fl):
    base = dict(num_clients=K, tau=2, lr=0.05, batch_size=16, seed=0,
                delta_threshold=0.2)
    base.update(fl)
    return {"name": "mesh", "model": {"name": model, "kw": {}},
            "data": {"name": "mixture",
                     "kw": {"n": 600, "n_eval": 50, "seed": 0}},
            "partition": {"name": "iid", "kw": {"seed": 0}},
            "fl": base, "rounds": rounds,
            "eval": {"every": 0, "final": False, "verbose": False}}


def engine(d, params=None):
    eng, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(d),
                                   params=params, device="cpu")
    return eng


def bank_rows(eng):
    """Every bank leaf as (Kp, ...) rows in client order, by path."""
    out = {}
    for which, bank in (("lbg", eng.lbg), ("residual", eng.residual)):
        if isinstance(eng.sched, teng_mod.ShardedScheduler):
            bank = teng_mod._tmap(
                lambda x: x.reshape((-1,) + tuple(x.shape[2:])),
                eng.sched.global_banks(bank))
        for name, leaf in bank.items():
            for k, x in (leaf.items() if isinstance(leaf, dict)
                         else [(None, leaf)]):
                out[(which, name, k)] = x
    return out


def assert_same_run(a, b, rounds=3):
    """History, params and banks bit for bit."""
    ha, hb = a.run(rounds), b.run(rounds)
    assert ha == hb
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    ra, rb = bank_rows(a), bank_rows(b)
    assert ra.keys() == rb.keys()
    for path, x in ra.items():
        assert torch.equal(x, rb[path]), path


# ------------------------------------------------------------ unit pieces

def test_pick_sharded_chunk_equals_jax():
    for n_dev in (1, 2, 3, 4, 8):
        for K in range(1, 41):
            for c in range(1, 21):
                got = teng_mod.pick_sharded_chunk(K, c, n_dev)
                assert got == jeng_mod.pick_sharded_chunk(K, c, n_dev), \
                    (K, c, n_dev)
                assert got % n_dev == 0
                if n_dev == 1:
                    assert got == teng_mod.pick_chunk(K, c)


def _leaf_sizes(model):
    kw = {"arch": "qwen3-1.7b", "reduced": True} if model == "lm" else {}
    params = MODELS.get(model)(seed=0, device="meta", **kw)[0]
    return params


@pytest.mark.parametrize("model", ["fcn", "cnn", "lm"])
def test_bank_model_partition_equals_jax(model):
    params = _leaf_sizes(model)
    shim = {k: types.SimpleNamespace(size=int(v.numel()))
            for k, v in params.items()}
    for m in (1, 2, 4, 8):
        for k_frac in (0.01, 0.1, 0.25):
            got = tls.bank_model_partition(params, k_frac, m)
            assert got == jls.bank_model_partition(shim, k_frac, m), (m,)
            if m == 1:
                assert not any(got.values())
    for nb in (1, 2, 16, 32, 48, 4752):
        for m in (1, 2, 3, 4, 8):
            assert tls.model_shard_rows(nb, m) == jls.model_shard_rows(nb, m)


def test_local_leaf_size_follows_the_spec():
    mesh = {"clients": 2, "model": 4}
    assert tls.local_leaf_size((64, 32), ("model", None), mesh) == 16 * 32
    assert tls.local_leaf_size((64, 32), (("clients", "model"),), mesh) \
        == 8 * 32
    assert tls.local_leaf_size((64, 32), (), mesh) == 64 * 32


@pytest.mark.parametrize("fused", [False, True])
def test_mesh_topk_step_n_model_1_is_the_store_step(fused):
    """At m = 1 the mesh step IS the rank-local step, bit for bit the
    top-k store's sparse step; m > 1 refuses the dense contract."""
    rs = np.random.RandomState(0)
    g = {"b": torch.as_tensor(rs.randn(3, 12).astype(np.float32)),
         "w": torch.as_tensor(rs.randn(3, 40, 8).astype(np.float32))}
    store = teng_mod.TopKLBGStore(0.5, k_frac=0.25, fused=fused)
    bank = store.init({k: v[0] for k, v in g.items()}, 3)
    for _ in range(2):   # a full round, then a recycle-capable one
        step = tls.make_mesh_topk_step(0.5, 0.25, n_model=1,
                                       sparse_out=True, fused=fused)
        got = step(g, bank)
        want = store.sparse_client_step(g, bank)
        a, b = [], []
        teng_mod._tmap(a.append, {"s": got[0][0], "l": got[1]})
        teng_mod._tmap(b.append, {"s": want[0][0], "l": want[1]})
        for x, y in zip(a + [got[0][1], *got[2]], b + [want[0][1],
                                                       *want[2]]):
            assert torch.equal(x, y)
        bank = got[1]
        g = {k: v + 0.1 * torch.as_tensor(
            rs.randn(*v.shape).astype(np.float32)) for k, v in g.items()}
    with pytest.raises(ValueError, match="sparse_out"):
        tls.make_mesh_topk_step(0.5, 0.25, n_model=2, sparse_out=False)


def test_sharded_store_registered_and_refuses_reserved_kw():
    store = teng_mod.make_lbg_store(TFL(lbg_variant="topk-sharded",
                                        lbg_kw={"k_frac": 0.25}))
    assert isinstance(store, teng_mod.ShardedTopKLBGStore)
    assert store.n_model == 1 and store.k_frac == 0.25
    with pytest.raises(ValueError, match="engine-controlled"):
        teng_mod.make_lbg_store(TFL(lbg_variant="topk-sharded",
                                    lbg_kw={"n_model": 2}))
    with pytest.raises(ValueError, match="sharded"):
        TFL(scheduler="sharded", tiers=[2])


# ------------------------------------------------------------ the mesh

def test_make_fl_mesh_shapes_and_errors():
    mesh = tmesh.make_fl_mesh(None, device="cpu")
    assert mesh.mesh_dim_names == ("clients", "model")
    assert tuple(mesh.mesh.shape) == (1, 1)
    assert tuple(tmesh.make_fl_mesh(1, device="cpu").mesh.shape) == (1, 1)
    mesh = tmesh.make_fl_mesh([1, 1], device="cpu", client_axis="c",
                              model_axis="m")
    assert mesh.mesh_dim_names == ("c", "m")
    assert mesh.get_group("c") is not None
    assert tmesh.make_client_mesh(device="cpu").mesh_dim_names == (
        "clients",)
    assert tmesh.make_debug_mesh(device="cpu").mesh_dim_names == (
        "data", "model")
    with pytest.raises(RuntimeError, match="device"):
        tmesh.make_fl_mesh([2, 1], device="cpu")
    with pytest.raises(RuntimeError, match="device"):
        tmesh.make_fl_mesh([1, 2], device="cpu")
    with pytest.raises(ValueError, match="axis"):
        tmesh.make_fl_mesh([0, 1], device="cpu")
    assert tmesh.is_writer() and tmesh.backend_for("cpu") == "gloo"


def test_mesh_too_large_fails_at_build():
    with pytest.raises(RuntimeError, match="device"):
        engine(spec(K=4, scheduler="sharded", mesh=2))


def test_sharded_banks_layout():
    """Banks are stored (n_chunks, chunk/c, ...): each rank's rows of every
    chunk."""
    eng = engine(spec(scheduler="sharded", mesh=1, chunk_size=5,
                      compressor="topk", compressor_kw={"k_frac": 0.25},
                      error_feedback=True))
    for bank in (eng.lbg, eng.residual):
        for leaf in bank.values():
            assert tuple(leaf.shape[:2]) == (2, 5)
    assert eng.sched.bank_rows(10) == 10


# ----------------------------------------- bit for bit on one rank

@pytest.mark.parametrize("sched", ["vmap", "chunked"])
def test_stores_interchangeable(sched):
    kw = dict(TOPK, K=6, scheduler=sched, chunk_size=3,
              delta_threshold=0.5)
    a = engine(spec(**kw))
    b = engine(spec(**dict(kw, lbg_variant="topk-sharded")))
    assert isinstance(b.store, teng_mod.ShardedTopKLBGStore)
    assert_same_run(a, b)


CASES = {
    "dense": dict(chunk_size=5),
    "topk": dict(TOPK, K=6, chunk_size=3, delta_threshold=0.8),
    "dense-pad-sampled-ef": dict(K=7, chunk_size=4, delta_threshold=0.3,
                                 compressor="topk",
                                 compressor_kw={"k_frac": 0.1},
                                 error_feedback=True, sample_frac=0.6),
    "topk-pad-sampled-int8": dict(TOPK, K=7, chunk_size=4,
                                  delta_threshold=0.8, sample_frac=0.6,
                                  codec="int8"),
    "topk-trimmed-mean": dict(TOPK, K=6, chunk_size=3, delta_threshold=0.5,
                              aggregator="trimmed_mean"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_1x1_mesh_equals_chunked_bitforbit(case):
    kw = CASES[case]
    rounds = 4 if "pad" in case else 3
    chunked = engine(spec(scheduler="chunked", **kw))
    skw = dict(kw, scheduler="sharded", mesh=[1, 1])
    if "lbg_variant" in kw:
        skw["lbg_variant"] = "topk-sharded"
    sharded = engine(spec(**skw))
    assert (sharded._chunk, sharded._pad) == (chunked._chunk, chunked._pad)
    assert (sharded.sched.n_client_dev, sharded.sched.n_model) == (1, 1)
    if "pad" in case:
        assert sharded._pad == 1
    assert_same_run(chunked, sharded, rounds=rounds)
    if "lbg_variant" in kw and "trimmed" not in case:
        assert max(h["frac_scalar"] for h in sharded.history) > 0


def test_int_mesh_equals_2d_mesh_bitforbit():
    kw = dict(TOPK, chunk_size=5, scheduler="sharded",
              lbg_variant="topk-sharded")
    assert_same_run(engine(spec(mesh=1, **kw)),
                    engine(spec(mesh=[1, 1], **kw)))


def test_1x1_checkpoint_holds_the_global_layout(tmp_path):
    """The checkpoint holds the JAX sharded engine's (n_chunks, chunk, ...)
    banks; resuming from it is the uninterrupted run bit for bit."""
    path = str(tmp_path / "mesh.ckpt.npz")
    kw = dict(TOPK, chunk_size=5, scheduler="sharded", mesh=[1, 1],
              lbg_variant="topk-sharded", ckpt_every=2, ckpt_path=path,
              delta_threshold=0.5)
    whole = engine(spec(**kw))
    whole.run(3)
    cut = engine(spec(**kw))
    cut.run(2)
    again = engine(spec(**kw))
    again.run(3, resume=True)
    assert again.history == whole.history
    for k in whole.params:
        assert torch.equal(again.params[k], whole.params[k]), k
    from repro_torch.checkpoint import ckpt
    tree, _ = ckpt.load_checkpoint(path)
    assert tuple(tree["lbg"]["fc1/w"]["idx"].shape[:2]) == (2, 5)


# ------------------------------------------------- against the JAX package

def test_fig5_1x1_against_jax_sharded():
    """fig5's spec (FCN, K=20, label skew) on the (1, 1) mesh in both
    packages, the top-k-sharded store at delta 0.7 (scalar rounds occur)."""
    d = spec(K=20, rounds=5, scheduler="sharded", mesh=[1, 1],
             chunk_size=8, lbg_variant="topk-sharded",
             lbg_kw={"k_frac": 0.1}, delta_threshold=0.7)
    d["data"]["kw"]["n"] = 2000
    d["partition"] = {"name": "label_skew",
                      "kw": {"classes_per_client": 3, "seed": 0}}
    jeng, _ = jexp.build_experiment(jexp.ExperimentSpec.from_dict(d))
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    teng = engine(d, params=p0)
    assert (teng._chunk, teng._pad) == (jeng._chunk, jeng._pad)
    jh, th = jeng.run(5), teng.run(5)
    for r, (a, b) in enumerate(zip(jh, th)):
        for k in EXACT:
            assert a[k] == b[k], (r, k, a[k], b[k])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    delta = teng.cfg.delta_threshold
    margin = min(float(np.min(np.abs(s - delta)))
                 for s in teng.sin2_history)
    assert margin > 1e-5, margin
    assert max(h["frac_scalar"] for h in th) > 0
    for k, v in jeng.params.items():
        np.testing.assert_allclose(teng.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


# ------------------------------------------------ prefetcher under a mesh

def test_prefetch_exception_propagates_midrun_sharded():
    eng = engine(spec(K=6, scheduler="sharded", mesh=[1, 1], chunk_size=3))
    calls = {"n": 0}
    orig = eng._sample_batches

    def failing(rng):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("host prep exploded")
        return orig(rng)

    eng._sample_batches = failing
    src = eng.prefetcher(np.random.RandomState(1), depth=1)
    try:
        eng.run_round(src)
        with pytest.raises(RuntimeError, match="prefetch thread failed"):
            for _ in range(4):
                eng.run_round(src)
        with pytest.raises(RuntimeError) as ei:
            src.next()
        assert "host prep exploded" in str(ei.value.__cause__)
    finally:
        src.close()


# ------------------------------------------ the codec on model-rank rows

@pytest.mark.parametrize("name", ["int8", "fp8", "delta_idx"])
def test_codec_on_model_rank_rows_is_the_whole_leafs(name):
    """A codec bound to model rank q's rows (``bind_model_rows``) encodes
    them as the unbound codec encodes those rows of the whole leaf: the
    stochastic uniforms of the whole leaf's stream, bit for bit; and the
    ranks' wire bytes sum to the whole payload's, scalar rounds included."""
    from repro_torch.comm import wire
    from repro_torch.core.lbgm import LBGMStats
    rs = np.random.RandomState(3)
    C, nb, kb = 3, 8, 5
    send = {"w": {"idx": torch.as_tensor(np.stack([
        np.stack([rs.choice(64, kb, replace=False) for _ in range(nb)])
        for _ in range(C)]).astype(np.int32)),
        "val": torch.as_tensor(rs.randn(C, nb, kb).astype(np.float32))},
        "b": {"idx": torch.as_tensor(rs.randint(0, 9, (C, 1, 2)).astype(
            np.int32)), "val": torch.as_tensor(
                rs.randn(C, 1, 2).astype(np.float32))}}
    seed = torch.as_tensor(rs.randint(0, 2 ** 31 - 1, C))
    rho = torch.as_tensor(rs.rand(C).astype(np.float32))
    stats = LBGMStats(sin2=rho, rho=rho,
                      sent_scalar=torch.tensor([True, False, False]),
                      uplink_floats=rho, grad_sq_norm=rho)
    whole = wire.CODECS.get(name)()
    (ws, _), _, wb = whole.encode_sparse((send, rho), send, stats, seed)
    total = torch.zeros(C)
    for q in range(2):
        codec = wire.CODECS.get(name)()
        codec.bind_model_rows(q, {"w": True, "b": False})
        part = {"w": {k: v[:, q * nb // 2:(q + 1) * nb // 2]
                      for k, v in send["w"].items()}, "b": send["b"]}
        (ps, _), _, pb = codec.encode_sparse((part, rho), part, stats, seed)
        for k, v in ps["w"].items():
            want = ws["w"][k][:, q * nb // 2:(q + 1) * nb // 2]
            assert torch.equal(v.view(torch.uint8) if v.element_size() == 1
                               and v.is_floating_point() else v,
                               want.view(torch.uint8)
                               if want.element_size() == 1
                               and want.is_floating_point() else want), k
        total += pb
    assert torch.equal(total, wb)

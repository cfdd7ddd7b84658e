"""The port's hierarchical aggregation tiers (``repro_torch.fed.hierarchy``)
against ``repro.fed.hierarchy`` and the JAX engine's tiers.

Mirrors ``tests/test_hierarchy.py``:

* ``TierMap`` (contiguous split, the seeded shuffle on its own stream,
  padding, ``round_bytes``) and ``make_tier_map`` equal the JAX package's
  exactly; ``FLConfig`` refuses the same ``tiers`` spellings in the same
  words and normalises the accepted ones to the same JSON form;
* ``HierarchicalAggregator``'s flat carry is the inner fold bit for bit;
  its edge partials (one ``index_add_`` per leaf per chunk) match the JAX
  package's on the same inputs within fp32 tolerance (rtol 1e-5, atol
  1e-6), and their sum matches the flat carry;
* a tiered round history is the flat one bit for bit within the port on
  the vmap, chunked and buffered schedulers (and accounting-only under a
  robust rule or a lossy codec), and it agrees with the JAX engine's
  tiered run (:func:`engine_parity`); the ledger's per-tier bytes equal
  the JAX ledger's exactly.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.fed import engine as jengine  # noqa: E402
from repro.fed import hierarchy as jh  # noqa: E402
from repro.fed.flconfig import FLConfig as JFL  # noqa: E402
from repro_torch.comm.accounting import CommLedger  # noqa: E402
from repro_torch.core.tree_math import tree_size  # noqa: E402
from repro_torch.fed import engine as tengine  # noqa: E402
from repro_torch.fed import experiment as texp  # noqa: E402
from repro_torch.fed import hierarchy as th  # noqa: E402
from repro_torch.fed.flconfig import FLConfig as TFL  # noqa: E402
from test_torch_robust import engine_parity, fcn_spec  # noqa: E402

TOPK = dict(lbg_variant="topk", lbg_kw={"k_frac": 0.1}, delta_threshold=0.9)


# ------------------------------------------------------------------ TierMap

@pytest.mark.parametrize("K,levels", [(10, [4]), (8, [4, 2]), (37, [5, 3]),
                                      (100000, [256, 16])])
def test_tier_map_contiguous_balanced(K, levels):
    t, j = th.TierMap(K, levels), jh.TierMap(K, levels)
    np.testing.assert_array_equal(t.edge_of, j.edge_of)
    assert t.edge_of.dtype == j.edge_of.dtype
    if j.region_of is None:
        assert t.region_of is None
    else:
        np.testing.assert_array_equal(t.region_of, j.region_of)
    np.testing.assert_array_equal(th.TierMap(10, [4]).edge_of,
                                  [0, 0, 0, 1, 1, 2, 2, 2, 3, 3])


@pytest.mark.parametrize("seed", [0, 3, 4, 2 ** 20 + 7])
def test_tier_map_shuffle_is_seeded_permutation(seed):
    for K, levels in ((32, [8]), (100000, [256, 16])):
        t = th.TierMap(K, levels, assign="shuffle", seed=seed)
        j = jh.TierMap(K, levels, assign="shuffle", seed=seed)
        np.testing.assert_array_equal(t.edge_of, j.edge_of)
        flat = th.TierMap(K, levels).edge_of
        np.testing.assert_array_equal(
            np.bincount(t.edge_of, minlength=levels[0]),
            np.bincount(flat, minlength=levels[0]))


def test_tier_map_padding_and_validation():
    t, j = th.TierMap(5, [2]), jh.TierMap(5, [2])
    np.testing.assert_array_equal(t.edge_ids_padded(8), j.edge_ids_padded(8))
    np.testing.assert_array_equal(t.edge_ids_padded(8)[5:], 0)
    for args, kw in (((8, [2, 2, 2]), {}), ((8, [4]), {"assign": "rr"})):
        msgs = []
        for mod in (th, jh):
            with pytest.raises(ValueError) as e:
                mod.TierMap(*args, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_tier_map_round_bytes():
    rng = np.random.RandomState(0)
    for K, levels, assign in ((8, [4, 2], "contiguous"), (8, [4], "shuffle"),
                              (300, [16, 4], "shuffle")):
        t = th.TierMap(K, levels, assign=assign, seed=1)
        j = jh.TierMap(K, levels, assign=assign, seed=1)
        for p in (1.0, 0.3, 0.02, 0.0):
            act = (rng.rand(K) < p).astype(np.float64)
            b = t.round_bytes(act, 1234.5, 40.0)
            assert b == j.round_bytes(act, 1234.5, 40.0)
    tm = th.TierMap(8, [4, 2])
    assert tm.round_bytes(np.ones(8), 100.0, 40.0) == {
        "edge": 100.0, "region": 160.0, "global": 80.0}
    assert th.TierMap(8, [4]).round_bytes(np.ones(8), 100.0, 40.0) == {
        "edge": 100.0, "global": 160.0}


def test_make_tier_map_spellings():
    for tiers in ([4, 2], {"levels": [4], "assign": "shuffle"},
                  {"levels": (4, 2)}):
        t = th.make_tier_map(TFL(num_clients=8, tiers=tiers, seed=2))
        j = jh.make_tier_map(JFL(num_clients=8, tiers=tiers, seed=2))
        assert (t.n_edges, t.n_regions, t.assign) == \
            (j.n_edges, j.n_regions, j.assign)
        np.testing.assert_array_equal(t.edge_of, j.edge_of)
    assert th.make_tier_map(TFL(num_clients=8)) is None


@pytest.mark.parametrize("tiers,word", [
    ([16], "tiers"),                               # more edges than K
    ([2, 4], "tiers"),                             # not descending
    ({"levels": [4], "assign": "zigzag"}, "tiers"),
    ({"levels": [4], "typo": 1}, "tiers"),
    ([0], "tiers"),
    ("4", "tiers"),
])
def test_flconfig_tiers_validation(tiers, word):
    msgs = []
    for cls in (JFL, TFL):
        with pytest.raises(ValueError, match=word) as e:
            cls(num_clients=8, tiers=tiers)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # the accepted spellings normalise to the same JSON form
    for ok in ([4, 2], (4,), {"levels": (4, 2), "assign": "shuffle"},
               {"levels": [3]}):
        t, j = TFL(num_clients=8, tiers=ok), JFL(num_clients=8, tiers=ok)
        assert t.to_dict() == j.to_dict()
        assert json.loads(json.dumps(t.to_dict())) == t.to_dict()
        assert TFL.from_dict(json.loads(json.dumps(t.to_dict()))) == t


# ------------------------------------------- the aggregator, both packages

def _payload(sparse, K, rng):
    """Numpy inputs of one fold: weights, the payload, the params."""
    shape = (64,)
    w = rng.rand(K).astype(np.float32)
    w[3] = 0.0
    if not sparse:
        return w, {"w": rng.randn(K, *shape).astype(np.float32)}, shape
    inner = tengine.SparseTopKAggregator({"w": torch.zeros(shape)}, 0.1)
    (_, _, nb, block) = inner._layout["w"]
    kb = max(1, int(np.ceil(0.1 * block)))
    idx = np.stack([np.stack([rng.choice(block, size=kb, replace=False)
                              for _ in range(nb)]) for _ in range(K)])
    send = {"w": {"idx": idx.astype(np.int32),
                  "val": rng.randn(K, nb, kb).astype(np.float32)}}
    gscale = np.where(rng.rand(K) < 0.5, 1.0,
                      rng.randn(K)).astype(np.float32)
    return w, (send, gscale), shape


def _fold(agg, acc, w, payload, chunk, conv):
    for s in range(0, w.shape[0], chunk):
        sl = slice(s, s + chunk)
        if isinstance(payload, tuple):
            out = ({n: {k: conv(v[sl]) for k, v in sk.items()}
                    for n, sk in payload[0].items()}, conv(payload[1][sl]))
        else:
            out = {k: conv(v[sl]) for k, v in payload.items()}
        acc = agg.accumulate(acc, conv(w[sl]), out)
    return acc


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_wrapper_flat_carry_is_bit_for_bit(sparse):
    rng = np.random.RandomState(0)
    K, E, chunk = 12, 3, 4
    w, payload, shape = _payload(sparse, K, rng)
    tm = th.TierMap(K, [E], assign="shuffle", seed=5)

    def port(inner_cls):
        inner = inner_cls({"w": torch.zeros(shape)}, 0.1) if sparse \
            else inner_cls()
        return inner, th.HierarchicalAggregator(inner,
                                                tm.edge_ids_padded(K), E)

    def jax_(inner_cls):
        inner = inner_cls({"w": jnp.zeros(shape)}, k_frac=0.1) if sparse \
            else inner_cls()
        return inner, jh.HierarchicalAggregator(inner,
                                                tm.edge_ids_padded(K), E)

    cls = "SparseTopKAggregator" if sparse else "DenseAggregator"
    t_in, t_h = port(getattr(tengine, cls))
    j_in, j_h = jax_(getattr(jengine, cls))
    tp = {"w": torch.zeros(shape)}
    a_flat = _fold(t_in, t_in.init(tp), w, payload, chunk, torch.from_numpy)
    a_hier = _fold(t_h, t_h.init(tp), w, payload, chunk, torch.from_numpy)
    assert torch.equal(t_in.finalize(a_flat)["w"],
                       t_h.finalize(a_hier)["w"])
    j_hier = _fold(j_h, j_h.init({"w": jnp.zeros(shape)}), w, payload,
                   chunk, jnp.asarray)
    # the edge partials against the JAX package's, and their sum against
    # the flat carry: fp32 tolerance
    np.testing.assert_allclose(t_h.edge_partials(a_hier)["w"].numpy(),
                               np.asarray(j_h.edge_partials(j_hier)["w"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_h.combine_edges(a_hier)["w"].numpy(),
                               a_flat["w"].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        t_h.finalize(a_hier)["w"].numpy(),
        np.asarray(j_h.finalize(j_hier)["w"]), rtol=1e-5, atol=1e-6)
    # each edge partial holds only its own clients' mass
    for e in range(E):
        w_e = np.where(tm.edge_of == e, w, 0.0).astype(np.float32)
        ref = _fold(t_in, t_in.init(tp), w_e, payload, chunk,
                    torch.from_numpy)
        np.testing.assert_allclose(
            t_h.edge_partials(a_hier)["w"][e].numpy(), ref["w"].numpy(),
            rtol=1e-5, atol=1e-6)
    jax.clear_caches()


# ------------------------------------------------------------ the engine

def port_run(rounds=3, **fl):
    eng, _ = texp.build_experiment(
        texp.ExperimentSpec.from_dict(fcn_spec(rounds=rounds, **fl)),
        device="cpu")
    rng = np.random.RandomState(1)
    return eng, [eng.run_round(rng) for _ in range(rounds)]


def assert_port_same(a, ha, b, hb):
    assert ha == hb
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


TIERED = {
    "chunked": dict(TOPK, scheduler="chunked", chunk_size=4),
    "vmap": dict(TOPK),
    "chunked-sampled": dict(TOPK, scheduler="chunked", chunk_size=4,
                            sample_frac=0.5),
    "chunked-shuffle": dict(TOPK, scheduler="chunked", chunk_size=4,
                            tiers={"levels": [4, 2], "assign": "shuffle"}),
    "buffered": dict(TOPK, scheduler="buffered", chunk_size=4,
                     latency="fixed", latency_kw={"delay": 1}),
    "vmap-dense": dict(delta_threshold=0.2),
}


@pytest.mark.parametrize("case", sorted(TIERED))
def test_tiered_history_bit_for_bit_flat(case):
    fl = dict(TIERED[case])
    tiers = fl.pop("tiers", [4, 2])
    flat, hf = port_run(**fl)
    tier, ht = port_run(tiers=tiers, **fl)
    assert tier._tiered_fold
    assert_port_same(flat, hf, tier, ht)
    # the buffered run's first round delivers nothing, and its 3 rounds
    # hold no recycle round
    jeng, teng = engine_parity(case, dict(fl, tiers=tiers),
                               recycle=case != "buffered")
    assert jeng._tiered_fold and teng._tiered_fold
    assert teng.ledger.tier_wire_bytes == jeng.ledger.tier_wire_bytes


@pytest.mark.parametrize("extra", [
    {"aggregator": "median"},
    {"codec": "int8"},
], ids=["median", "int8"])
def test_tiered_accounting_only_paths(extra):
    fl = dict(TOPK, scheduler="chunked", chunk_size=4, **extra)
    flat, hf = port_run(**fl)
    tier, ht = port_run(tiers=[4], **fl)
    assert not tier._tiered_fold
    assert tier.ledger.tier_wire_bytes
    assert_port_same(flat, hf, tier, ht)


def test_ledger_tier_byte_attribution():
    fl = dict(TOPK, scheduler="chunked", chunk_size=4, tiers=[4, 2])
    jeng, teng = engine_parity("ledger", fl)
    tb = teng.ledger.tier_wire_bytes
    assert tb == jeng.ledger.tier_wire_bytes
    assert set(tb) == {"edge", "region", "global"}
    assert tb["edge"] == sum(h["wire_bytes"] for h in teng.history)
    carry = 4.0 * tree_size(teng.params)
    assert tb["region"] == 3 * 4 * carry
    assert tb["global"] == 3 * 2 * carry
    for e in teng.ledger.per_round:
        assert set(e["tiers"]) == {"edge", "region", "global"}
    assert teng.ledger.per_round == jeng.ledger.per_round
    assert teng.ledger.summary()["tier_wire_bytes"] == tb


def test_ledger_tiers_roundtrip_state_dict():
    eng, _ = port_run(**TOPK, scheduler="chunked", chunk_size=4, tiers=[4])
    fresh = CommLedger()
    fresh.load_state(eng.ledger.state_dict())
    assert fresh.state_dict() == eng.ledger.state_dict()
    assert fresh.tier_wire_bytes == eng.ledger.tier_wire_bytes


def test_sparse_fold_equals_the_client_loop():
    """``SparseTopKAggregator.accumulate`` folds a chunk in one call per
    leaf; on the CPU it is the client-by-client fold of before bit for
    bit (kept here as the reference), with positions shared by many
    clients and zero-weight clients holding NaN payloads."""
    rng = np.random.RandomState(4)
    C, shape = 40, (3000,)
    agg = tengine.SparseTopKAggregator({"w": torch.zeros(shape)}, 0.05)
    (_, _, nb, block) = agg._layout["w"]
    kb = 150
    # a few hot positions every client keeps, the rest random
    idx = np.stack([np.concatenate([np.arange(10), 10 + rng.choice(
        block - 10, kb - 10, replace=False)]) for _ in range(C)])
    send = {"w": {"idx": torch.from_numpy(idx.reshape(C, nb, kb)
                                          .astype(np.int32)),
                  "val": torch.from_numpy(
                      rng.randn(C, nb, kb).astype(np.float32))}}
    w = torch.from_numpy(rng.rand(C).astype(np.float32))
    w[[3, 17]] = 0.0
    send["w"]["val"][[3, 17]] = float("nan")
    gscale = torch.from_numpy(np.where(rng.rand(C) < 0.5, 1.0, rng.randn(
        C)).astype(np.float32))
    got = agg.accumulate(agg.init({"w": torch.zeros(shape)}), w,
                         (send, gscale))["w"]
    want = agg.init({"w": torch.zeros(shape)})["w"]
    for k in range(C):
        i_k = send["w"]["idx"][k].long()
        new = want.gather(1, i_k) + torch.where(
            w[k] > 0, (w[k] * gscale[k]) * send["w"]["val"][k], 0.0)
        want.scatter_(1, i_k, new)
    assert torch.equal(got, want)

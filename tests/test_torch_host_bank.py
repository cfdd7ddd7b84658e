"""The port's out-of-core ``"topk-host"`` store against ``"topk"`` and
against the JAX package's ``"topk-host"``.

Mirrors ``tests/test_host_bank.py``:

* ``lbg_variant="topk-host"`` gives the in-memory ``"topk"`` store's
  history, final params and final banks bit for bit, within the port and
  within the JAX package, on the chunked scheduler, with sampling, tiers,
  the stochastic int8 wire, and a payload attack with dropout; and the
  port's ``"topk-host"`` run agrees with the JAX package's
  (:func:`engine_parity` of ``test_torch_robust.py``: discrete fields
  exact, loss rtol 1e-5, params rtol 1e-4 / atol 1e-6; the int8 wire's
  rounding ties by ``TIE_FRACTION``);
* the banks and the round's batch stay in host memory; one streamed
  chunk's device bytes do not depend on K, and a K = 102,400 round runs;
* the configurations JAX refuses are refused in the same words.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.fed.flconfig import FLConfig as JFL  # noqa: E402
from repro_torch.fed import experiment as texp  # noqa: E402
from repro_torch.fed.engine import FLEngine  # noqa: E402
from repro_torch.fed.flconfig import FLConfig as TFL  # noqa: E402
from test_torch_robust import (assert_runs_agree, engines,  # noqa: E402
                               fcn_spec)

BASE = dict(scheduler="chunked", chunk_size=4, lbg_variant="topk",
            lbg_kw={"k_frac": 0.1}, delta_threshold=0.9)
HOST = dict(BASE, lbg_variant="topk-host")
CASES = {
    "plain": {},
    "sampled": {"sample_frac": 0.5},
    "tiered": {"tiers": [4, 2]},
    "codec": {"codec": "int8"},
    "attack-dropout": {"attack": "sign_flip", "attack_frac": 0.25,
                       "attack_kw": {"scale": 4.0}, "dropout_frac": 0.2},
}


def port_engine(params=None, rounds=3, **fl):
    return texp.build_experiment(
        texp.ExperimentSpec.from_dict(fcn_spec(rounds=rounds, **fl)),
        params=params, device="cpu")[0]


def numpy_params(eng):
    return {k: np.asarray(v) for k, v in eng.params.items()}


def rounds_of(eng, n=3, seed=1):
    rng = np.random.RandomState(seed)
    return [eng.run_round(rng) for _ in range(n)]


def assert_same_run(a, b, ha, hb, banks=True):
    """Two engines of one package: histories, params and banks equal."""
    assert ha == hb
    for k in a.params:
        x, y = (np.asarray(e.params[k].cpu() if torch.is_tensor(e.params[k])
                           else e.params[k]) for e in (a, b))
        np.testing.assert_array_equal(x, y, err_msg=k)
    if banks:
        for name in a.lbg:
            for f in a.lbg[name]:
                np.testing.assert_array_equal(
                    np.asarray(a.lbg[name][f]), np.asarray(b.lbg[name][f]),
                    err_msg=f"{name} {f}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_store_bit_for_bit_vs_topk(case):
    extra = CASES[case]
    jeng, host = engines(fcn_spec(rounds=3, **HOST, **extra))
    dev = port_engine(numpy_params(jeng), **BASE, **extra)
    assert host._host_bank and jeng._host_bank
    assert host._tiered_fold == jeng._tiered_fold == (case == "tiered")
    # the bank lives in host memory, not on the engine's device
    assert all(host.lbg[n][f].device.type == "cpu"
               for n in host.lbg for f in host.lbg[n])
    hd, hh = rounds_of(dev), rounds_of(host)
    assert_same_run(dev, host, hd, hh)
    jh = rounds_of(jeng)
    assert_runs_agree(case, jeng, host, jh, hh,
                      ties=case == "codec")
    if case == "plain":
        # and within the JAX package
        jdev, _ = engines(fcn_spec(rounds=3, **BASE))
        assert_same_run(jdev, jeng, rounds_of(jdev), jh)


def test_host_store_engine_run_prefetch():
    """The prefetcher's thread draws the rounds and the streamer streams
    the bank: ``run`` equals the in-memory store's ``run``."""
    dev, host = port_engine(**BASE), port_engine(**HOST)
    assert_same_run(dev, host, dev.run(3), host.run(3))


@pytest.mark.parametrize("kw,word", [
    (dict(scheduler="vmap"), "topk-host"),
    (dict(scheduler="chunked", error_feedback=True), "topk-host"),
    (dict(scheduler="chunked", compressor="topk"), "topk-host"),
    (dict(scheduler="chunked", fused_kernels=False), "topk-host"),
    (dict(scheduler="buffered"), "buffered"),
])
def test_host_store_config_rejections(kw, word):
    kw = dict(num_clients=8, use_lbgm=True, lbg_variant="topk-host", **kw)
    msgs = []
    for cls in (JFL, TFL):
        with pytest.raises(ValueError, match=word) as e:
            cls(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_host_store_refuses_collect_rules():
    """A collect-mode rule needs the whole (K, payload) stack on the
    device: refused at engine build, in the JAX package's words."""
    msgs = []
    for build in (lambda d: engines(d), lambda d: port_engine(**d["fl"])):
        with pytest.raises(ValueError, match="mean") as e:
            build(fcn_spec(**HOST, aggregator="median"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_device_bank_bytes_independent_of_K():
    small, big = port_engine(num_clients=8, **HOST), \
        port_engine(num_clients=32, **HOST)
    jsmall, tsmall = engines(fcn_spec(num_clients=8, **HOST))
    assert small.host_chunk_device_bytes() == big.host_chunk_device_bytes()
    assert tsmall.host_chunk_device_bytes() == jsmall.host_chunk_device_bytes()
    with pytest.raises(ValueError, match="topk-host"):
        port_engine(**BASE).host_chunk_device_bytes()
    # the round's batch stays on the host, padded to the chunk grid
    batch = big._sample_batches(np.random.RandomState(9))
    assert all(v.device.type == "cpu" and v.shape[0] == 32
               for v in batch.values())


def _tiny(K, chunk=512):
    """A least-squares model on 4 samples a client (the JAX test's)."""
    d = 8
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(d).astype(np.float32) * 0.1}

    def loss_fn(p, b):
        err = b["x"] @ p["w"] - b["y"]
        return torch.mean(err * err), {}

    x = rng.randn(K * 4, d).astype(np.float32)
    y = (x @ np.arange(d, dtype=np.float32) / d).astype(np.float32)
    data = [{"x": x[4 * k: 4 * k + 4], "y": y[4 * k: 4 * k + 4]}
            for k in range(K)]
    return FLEngine(loss_fn, params, data,
                    TFL(num_clients=K, tau=1, lr=0.1, batch_size=4,
                        chunk_size=chunk, scheduler="chunked",
                        use_lbgm=True, lbg_variant="topk-host",
                        lbg_kw={"k_frac": 0.25}, delta_threshold=0.5),
                    device="cpu")


def test_100k_client_round_fixed_device_bytes():
    # 102400 = 200 * 512 keeps the chunk of the K = 1024 engine
    small, big = _tiny(1024), _tiny(102_400)
    assert small._chunk == big._chunk == 512
    assert small.host_chunk_device_bytes() == big.host_chunk_device_bytes()
    m = big.run_round(np.random.RandomState(0))
    assert np.isfinite(m["loss"]) and big.ledger.rounds == 1
    per_client = sum(v[0].numel() * v.element_size()
                     for sk in big.lbg.values() for v in sk.values())
    assert big.host_chunk_device_bytes() == per_client * big._chunk


@pytest.mark.parametrize("variant", ["topk", "topk-host"])
def test_batch_draws_equal_the_per_client_loop(variant):
    """``_sample_batches`` draws every client's indices in one ``randint``
    call with per-client bounds: the per-client loop's draws (the JAX
    engine's stream, kept here as the reference), the rng left in the same
    state, on unequal shards (label skew) and on a one-sample client."""
    eng = port_engine(num_clients=7, **dict(HOST, lbg_variant=variant))
    eng._data_sizes[3] = 1      # a client with one sample: no draw at all
    for seed in (0, 5):
        rng, ref = np.random.RandomState(seed), np.random.RandomState(seed)
        batch = eng._sample_batches(rng)
        cfg = eng.cfg
        idx = np.empty((7, cfg.tau, cfg.batch_size), np.int64)
        for k, n in enumerate(eng._data_sizes):
            idx[k] = ref.randint(0, n, size=(cfg.tau, cfg.batch_size))
        idx += eng._data_offsets[:, None, None]
        for key, v in eng._data_cat.items():
            np.testing.assert_array_equal(np.asarray(batch[key])[:7],
                                          v[idx])
            np.testing.assert_array_equal(np.asarray(batch[key])[7:], 0)
        assert rng.randint(2 ** 30) == ref.randint(2 ** 30)

"""The port's LM training slice against the JAX package, on the CPU.

``train.trainer.make_train_step`` (both ``dp_mode``s, the ``"full"`` and
``"topk"`` LBG stores, tau = 2, LBGM off, a negative delta) runs three
steps from the JAX package's params (carried across with
``params_from_numpy``) on the same numpy batches as the JAX step: the
discrete metrics (``frac_scalar``, ``uplink_floats``,
``vanilla_uplink_floats``) equal, the loss within rtol 1e-5, the params
within rtol 1e-4 / atol 1e-6, the top-k banks' kept sets equal; and no client's sin² lies within 1e-5 of
delta, where a float-level difference could flip a decision.
``mean_sin2`` agrees within rtol 1e-3: the JAX package's jitted fsdp step
gives 0.566836 where its own eager per-client calls give 0.566938 and the
port 0.566946 (qwen3 reduced, step 2). ``launch.train.main`` against the JAX
driver with the same flags, checkpoints across packages, ``markov_lm`` and
the top-k layout at the LMs' leaf sizes complete the slice.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import lbgm as jlbgm  # noqa: E402
from repro.data.synthetic import markov_lm as jmarkov  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.optim import sgd_update as jsgd_update  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import lbgm as tlbgm  # noqa: E402
from repro_torch.data.synthetic import markov_lm  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim import sgd_init, sgd_update  # noqa: E402
from repro_torch.train import trainer as ttr  # noqa: E402

LOSS_RTOL = 1e-5
SIN2_RTOL = 1e-3
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
MARGIN = 1e-5
EXACT = ("frac_scalar", "uplink_floats", "vanilla_uplink_floats")


def _cfgs(arch, dp_mode="replicated", variant="full", tau=1):
    out = []
    for get in (jget, tget):
        cfg = get(arch).reduced()
        out.append(dataclasses.replace(
            cfg, dp_mode=dp_mode, lbgm=dataclasses.replace(
                cfg.lbgm, variant=variant, local_steps=tau)))
    return out


def _record_sin2(monkeypatch):
    """Every client's sin² the port's trainer decides on."""
    seen = []
    for name in ("lbgm_client_step", "lbgm_topk_client_step"):
        real = getattr(tlbgm, name)

        def wrapped(*a, _real=real, **kw):
            out = _real(*a, **kw)
            seen.extend(out[2].sin2.tolist())
            return out
        monkeypatch.setattr(tlbgm, name, wrapped)
    return seen


def _by_index(idx, val):
    order = np.argsort(idx, axis=-1, kind="stable")
    return (np.take_along_axis(idx, order, -1),
            np.take_along_axis(val, order, -1))


#: name -> (arch, dp_mode, variant, tau, use_lbgm, delta); the trainer is
#: arch-agnostic, and rwkv6's gradient is held in test_torch_train_kernels
STEP_CASES = {
    "replicated_full": ("qwen3-1.7b", "replicated", "full", 1, True, 0.6),
    "replicated_topk": ("qwen3-1.7b", "replicated", "topk", 1, True, 0.6),
    "fsdp_topk": ("qwen3-1.7b", "fsdp", "topk", 1, True, 0.6),
    "tau2": ("qwen3-1.7b", "replicated", "full", 2, True, 0.6),
    "no_lbgm": ("qwen3-1.7b", "replicated", "full", 1, False, 0.6),
    "negative_delta": ("qwen3-1.7b", "replicated", "full", 1, True, -1.0),
}


@pytest.mark.parametrize("case", STEP_CASES)
def test_train_step_matches_jax(case, monkeypatch):
    arch, dp_mode, variant, tau, use_lbgm, delta = STEP_CASES[case]
    jcfg, tcfg = _cfgs(arch, dp_mode, variant, tau)
    K, b, T, lr, steps = 3, 2, 16, 0.05, 3
    jstate, _ = jtr.init_train_state(jax.random.PRNGKey(0), jcfg, K,
                                     use_lbgm=use_lbgm)
    np_params = {k: np.asarray(v) for k, v in jstate["params"].items()}
    tstate, axes = ttr.init_train_state(None, tcfg, K, use_lbgm=use_lbgm,
                                        device="cpu", params=np_params)
    assert axes is None
    jstep = jax.jit(jtr.make_train_step(jcfg, K, lr, use_lbgm=use_lbgm,
                                        delta=delta))
    tstep = ttr.make_train_step(tcfg, K, lr, use_lbgm=use_lbgm, delta=delta)
    # one pool batch per client (the paper-like regime that recycles)
    toks, labels = markov_lm(K * b * tau, T, tcfg.vocab_size, seed=1)
    lead = (K, tau, b) if tau > 1 else (K, b)
    batch = {"tokens": toks.reshape(*lead, T),
             "labels": labels.reshape(*lead, T)}
    sin2 = _record_sin2(monkeypatch)
    fracs = []
    for _ in range(steps):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        assert sorted(tm) == sorted(jm)
        for k in EXACT:
            if k in jm:
                assert float(tm[k]) == float(jm[k]), (k, tm[k], jm[k])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        if "mean_sin2" in jm:
            np.testing.assert_allclose(float(tm["mean_sin2"]),
                                       float(jm["mean_sin2"]),
                                       rtol=SIN2_RTOL)
            fracs.append(float(tm["frac_scalar"]))
    assert tstate["step"] == steps
    for k, v in tstate["params"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate["params"][k]),
                                   err_msg=k, **PARAM_TOL)
    if use_lbgm:
        assert len(sin2) == K * steps
        margin = min(abs(s - delta) for s in sin2)
        assert margin > MARGIN, f"a client's sin² lies {margin:.3g} from delta"
        if delta > 0:      # both branches of Algorithm 1 taken
            assert max(fracs) > 0 and min(fracs) < 1, fracs
        else:
            assert fracs == [0.0] * steps
        lbg = tstate["lbg"]
        jlbg = jstate["lbg"]
        for k in lbg:
            if variant == "topk":
                # the kept sets, each row's entries in index order (the
                # order of equal-magnitude neighbours is a rounding tie)
                got = _by_index(lbg[k]["idx"].numpy(), lbg[k]["val"].numpy())
                want = _by_index(np.asarray(jlbg[k]["idx"]),
                                 np.asarray(jlbg[k]["val"]))
                assert np.array_equal(got[0], want[0]), k
                np.testing.assert_allclose(got[1], want[1], err_msg=k,
                                           **PARAM_TOL)
            else:
                np.testing.assert_allclose(lbg[k].numpy(),
                                           np.asarray(jlbg[k]),
                                           err_msg=k, **PARAM_TOL)


def test_effective_clients_matches_jax_on_one_device():
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    for dp_mode in ("replicated", "fsdp"):
        jcfg, tcfg = _cfgs("qwen3-1.7b", dp_mode)
        for gb in (1, 4, 6, 16):
            assert ttr.effective_clients(tcfg, 1, gb) == \
                jtr.effective_clients(jcfg, mesh, gb)


@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.0, 0.1),
                                         (0.9, 0.0)])
def test_sgd_matches_jax(momentum, wd):
    rng = np.random.RandomState(0)
    p = {"a": rng.randn(4, 3).astype(np.float32),
         "b": rng.randn(5).astype(np.float32)}
    g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    topt = sgd_init(tp, momentum)
    jopt = {} if momentum == 0.0 else {
        "m": {k: jnp.zeros_like(v) for k, v in p.items()}}
    jp = p
    for _ in range(2):
        tp, topt = sgd_update(tp, {k: torch.from_numpy(v) for k, v in
                                   g.items()}, topt, 0.1, momentum, wd)
        jp, jopt = jsgd_update(jp, g, jopt, 0.1, momentum, wd)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6)
    # bf16 params: the update in fp32, the result cast back
    pb = {"w": torch.ones(3, dtype=torch.bfloat16)}
    out, _ = sgd_update(pb, {"w": torch.full((3,), 0.3)}, {}, 0.1)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], torch.full((3,), 0.97).bfloat16())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-vl-2b",
                                  "whisper-base"])
def test_main_matches_the_jax_driver(arch, tmp_path, monkeypatch):
    """The same flags through both drivers, the port started from the JAX
    driver's initial params (``--init``) and, for the archs that take stub
    embeddings (qwen2-vl's patches, whisper's encoder frames), from the JAX
    driver's stub (``make_stub_embeds`` of ``PRNGKey(seed)``, handed to the
    port's ``make_stub_embeds``): the same history, both branches of
    Algorithm 1 taken, and each package reads the other's ``final.npz``."""
    argv = ["--arch", arch, "--reduced", "--steps", "4", "--seq", "32",
            "--pool", "1", "--delta", "0.6", "--log-every", "1"]
    cfg = dataclasses.replace(jget(arch).reduced(), dp_mode="replicated")
    jp, _ = jt.init_lm(jax.random.PRNGKey(0), cfg)
    jsave(str(tmp_path / "init.npz"), {"params": jp})
    jstub = jfront.make_stub_embeds(jax.random.PRNGKey(0), cfg, 8)
    stubs = []

    def stub(gen, tcfg, batch):
        assert batch == 8 and tcfg.name == arch
        stubs.append(None if jstub is None else
                     torch.from_numpy(np.array(jstub)).to(gen.device))
        return stubs[-1]
    monkeypatch.setattr(tlaunch, "make_stub_embeds", stub, raising=False)
    sin2 = _record_sin2(monkeypatch)
    jh = jlaunch.main(argv + ["--out", str(tmp_path / "jax")])
    th = tlaunch.main(argv + ["--out", str(tmp_path / "torch"), "--device",
                              "cpu", "--init", str(tmp_path / "init.npz")])
    assert len(th) == len(jh) == 4
    for a, b in zip(th, jh):
        assert sorted(a) == sorted(b)
        assert a["step"] == b["step"]
        for k in EXACT:
            assert a[k] == b[k], (k, a[k], b[k])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(a["mean_sin2"], b["mean_sin2"],
                                   rtol=SIN2_RTOL)
    fracs = [h["frac_scalar"] for h in th]
    assert max(fracs) > 0 and min(fracs) < 1, fracs
    assert min(abs(s - 0.6) for s in sin2) > MARGIN
    with open(tmp_path / "torch" / "history.json") as f:
        assert json.load(f) == th
    if jstub is not None:
        assert len(stubs) == 1 and stubs[0] is not None
    tfinal, tmeta = jload(str(tmp_path / "torch" / "final.npz"))
    jfinal, jmeta = load_checkpoint(str(tmp_path / "jax" / "final.npz"))
    assert tmeta == jmeta == {"arch": arch, "steps": 4}
    for k, v in jfinal["params"].items():
        np.testing.assert_allclose(np.asarray(tfinal["params"][k]),
                                   v.numpy(), err_msg=k, **PARAM_TOL)


def test_main_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--reduced", "--steps", "1", "--seq", "8",
                      "--out", str(tmp_path)])


def test_main_flags_shape_the_config():
    args = tlaunch.parse_args(["--arch", "rwkv6-3b", "--reduced",
                               "--layers", "3", "--vocab", "300"])
    cfg = tlaunch.train_config(args)
    assert (cfg.n_layers, cfg.vocab_size, cfg.dp_mode) == (3, 300,
                                                          "replicated")
    cfg = tlaunch.train_config(tlaunch.parse_args(["--d-model", "256"]))
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff) == (256, 4, 2, 64, 768)


def test_markov_lm_equals_jax():
    for args in ((6, 32, 512), (3, 7, 97, 5, 2)):
        for a, b in zip(markov_lm(*args), jmarkov(*args)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_checkpoints_load_across_packages(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"params": {"w": rng.randn(3, 4).astype(np.float32),
                       "end:": rng.randn(2).astype(np.float32)},
            "list": [rng.randn(2).astype(np.float32),
                     rng.randint(0, 9, 3).astype(np.int32)]}
    meta = {"arch": "x", "steps": 3}
    jsave(str(tmp_path / "j.npz"), tree, meta)
    save_checkpoint(str(tmp_path / "t.npz"),
                    {"params": {k: torch.from_numpy(v) for k, v in
                                tree["params"].items()},
                     "list": [torch.from_numpy(v) for v in tree["list"]]},
                    meta)
    got, gmeta = load_checkpoint(str(tmp_path / "j.npz"))
    back, bmeta = jload(str(tmp_path / "t.npz"))
    assert gmeta == bmeta == meta
    for k, v in tree["params"].items():
        assert np.array_equal(got["params"][k].numpy(), v)
        assert np.array_equal(back["params"][k], v)
    for a, b, v in zip(got["list"], back["list"], tree["list"]):
        assert np.array_equal(a.numpy(), v) and np.array_equal(b, v)
        assert a.numpy().dtype == b.dtype == v.dtype


def test_bf16_checkpoints_round_trip_bit_for_bit(tmp_path):
    """bf16 leaves are stored as their 16 raw bits (``|V2``), as numpy
    stores the JAX package's bf16: both directions keep every bit."""
    bits = torch.from_numpy(np.random.RandomState(1).randint(
        -2 ** 15, 2 ** 15, 64).astype(np.int16))
    w = bits.view(torch.bfloat16)
    save_checkpoint(str(tmp_path / "t.npz"), {"w": w})
    got, _ = load_checkpoint(str(tmp_path / "t.npz"))
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), bits)
    raw, _ = jload(str(tmp_path / "t.npz"))
    assert raw["w"].dtype.itemsize == 2
    assert np.array_equal(raw["w"].view(np.int16), bits.numpy())
    jw = jnp.asarray(np.asarray(w.float()), dtype=jnp.bfloat16)
    jsave(str(tmp_path / "j.npz"), {"w": jw})
    got, _ = load_checkpoint(str(tmp_path / "j.npz"))
    assert torch.equal(got["w"].float(), w.float())


#: the LMs' largest leaves at full width: qwen3-1.7b's ``embed`` (151936 x
#: 2048) and stacked ``blocks/w_gate`` (28 x 2048 x 6144), rwkv6-3b's
#: ``blocks/w_gate`` (32 x 2560 x 8960); mixtral-8x22b's stacked expert
#: leaf ``blocks/moe/w_gate`` (layers x 8 x 6144 x 16384) at the card's
#: 2 layers (1.61 billion elements) and at 3 (past 2^31: the LBG's indices
#: are block-local, so int32 holds them)
LM_LEAVES = {"qwen3_embed": (151936, 2048),
             "qwen3_w_gate": (28, 2048, 6144),
             "rwkv6_w_gate": (32, 2560, 8960),
             "mixtral_experts_2l": (2, 8, 6144, 16384),
             "mixtral_experts_3l": (3, 8, 6144, 16384)}


@pytest.mark.parametrize("leaf", LM_LEAVES)
def test_topk_layout_at_lm_leaf_sizes_matches_jax(leaf):
    shape = LM_LEAVES[leaf]
    size = int(np.prod(shape))
    for k_frac in (0.01, 0.001):
        assert tlbgm._block_layout(size, k_frac) == \
            jlbgm._block_layout(size, k_frac)
        assert tlbgm.topk_count(size, k_frac) == jlbgm.topk_count(size,
                                                                  k_frac)
    nb, block, kb = tlbgm._block_layout(size, 0.01)
    assert block == 65536 and nb % 16 == 0
    live = -(-size // block)
    assert (leaf, live, nb, kb) in {("qwen3_embed", 4748, 4752, 654),
                                    ("qwen3_w_gate", 5376, 5376, 655),
                                    ("rwkv6_w_gate", 11200, 11200, 655),
                                    ("mixtral_experts_2l", 24576, 24576, 655),
                                    ("mixtral_experts_3l", 36864, 36864, 655)}
    got = tlbgm.init_topk_lbg({"x": torch.empty(shape, device="meta")},
                              0.01)
    want = jlbgm.init_topk_lbg({"x": jax.ShapeDtypeStruct(shape,
                                                          jnp.bfloat16)},
                               0.01)
    for f in ("idx", "val"):
        assert tuple(got["x"][f].shape) == want["x"][f].shape
        assert str(got["x"][f].dtype).split(".")[-1] == \
            str(want["x"][f].dtype)

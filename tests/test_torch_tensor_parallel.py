"""``model_sharding="auto"`` in one process: the spec rule against the
JAX package's, the tensor-parallel forms at m = 1, and the refusals.

* ``train.sharding.param_pspec`` (both modes, the ``embed_shard``
  variant) and the engine's bound leaf specs (``fed.engine.auto_specs``)
  equal the JAX package's rule for every leaf of reduced yi-34b,
  qwen3-1.7b, rwkv6-3b (stacked ``blocks/`` leaves), recurrentgemma-2b
  (per-layer rglru and swa leaves), mixtral-8x22b and llama4 (stacked
  experts: E = 4 shards on E up to m = 4, on d_ff at m = 8) and
  qwen2-vl-2b (M-RoPE) at m in {1, 2, 4, 8}:
  ``repro.train.sharding.param_pspec`` on
  ``abstract_mesh``, plus the vocab rule of ``ShardedScheduler.
  bind_model_axes`` (``repro/fed/engine.py:1041-1049``);
* at m = 1 the tensor-parallel loss and gradients are the plain ones bit
  for bit (the MoE load-balance term included; the VLM with and without
  its stub patches), and a ``(1, 1)`` auto run is the ``(1, 1)``
  replicate run bit for bit;
* the engine's refusals mirror ``tests/test_mesh2d.py:150-195``, and the
  encoder-decoder is refused by name at engine build with the cause the
  JAX package shares: the ``"lm"`` component's batches carry no encoder
  frames.

The tensor-parallel gradients on 2- and 4-rank gloo worlds, and
``examples/specs/yi34b_tp2x4.json`` on 8 ranks, are in
``test_torch_sharded_ranks.py``.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.train import sharding as jsh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fed import engine as fe  # noqa: E402
from repro_torch.fed import experiment as texp  # noqa: E402
from repro_torch.fed.flconfig import FLConfig  # noqa: E402
from repro_torch.models.frontends import make_stub_embeds  # noqa: E402
from repro_torch.models.tensor_parallel import TPContext  # noqa: E402
from repro_torch.models.transformer import (init_lm, lm_loss,  # noqa: E402
                                            lm_loss_tp)
from repro_torch.train import sharding as tsh  # noqa: E402
from repro_torch.train.trainer import grad_and_loss  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["yi-34b", "qwen3-1.7b", "rwkv6-3b", "recurrentgemma-2b",
         "mixtral-8x22b", "llama4-maverick-400b-a17b", "qwen2-vl-2b"]
MS = [1, 2, 4, 8]


def jax_axes(arch):
    """The JAX package's reduced params (shapes) and logical axes."""
    params, axes = jax_init_lm(jax.random.PRNGKey(0),
                               jax_config(arch).reduced())
    return params, axes


def jax_auto_spec(axes, shape, mesh, m):
    """``ShardedScheduler.bind_model_axes``'s leaf rule, as the JAX
    package writes it (``repro/fed/engine.py:1041-1049``)."""
    if "vocab" in axes:
        out, used = [], False
        for logical, dim in zip(axes, shape):
            if logical == "embed" and not used and dim % m == 0:
                out.append("model")
                used = True
            else:
                out.append(None)
        return tuple(out)
    return tuple(jsh.param_pspec(axes, shape, "replicated", mesh))


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_rule_matches_jax(arch, m):
    params, axes = jax_axes(arch)
    _, taxes = init_lm(None, get_config(arch).reduced(), device="meta")
    assert taxes == {k: tuple(v) for k, v in axes.items()}
    jm = jsh.abstract_mesh((2, m), ("clients", "model"))
    tm = tsh.MeshAxes(("clients", "model"), {"clients": 2, "model": m})
    fm = jsh.abstract_mesh((2, m), ("data", "model"))
    tfm = tsh.MeshAxes(("data", "model"), {"data": 2, "model": m})
    for k, v in params.items():
        for mode in ("replicated", "fsdp"):
            for jmesh, tmesh in ((jm, tm), (fm, tfm)):
                for es in ("vocab", "embed"):
                    want = tuple(jsh.param_pspec(axes[k], v.shape, mode,
                                                 jmesh, es))
                    got = tsh.param_pspec(taxes[k], v.shape, mode, tmesh,
                                          es)
                    assert got == want, (k, mode, es, got, want)
    for mode, es in (("replicated", "vocab"), ("fsdp", "embed")):
        want = {k: tuple(s.spec) for k, s in jsh.params_shardings(
            axes, params, mode, jax.sharding.Mesh(
                np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model")), es).items()}
        got = tsh.params_shardings(taxes, params, mode,
                                   tsh.MeshAxes(("data", "model"),
                                                {"data": 1, "model": 1}), es)
        assert got == want
    bound = fe.auto_specs(taxes, params, tm)
    for k, v in params.items():
        assert bound[k] == jax_auto_spec(axes[k], v.shape, jm, m), k
    assert bound["embed"] == (None, "model")
    assert bound["lm_head"] == ("model", None)
    if "blocks/moe/router" in params:
        # the stacked experts: on E where m divides it (the router's E
        # columns with them), else on d_ff with the router replicated
        on_e = 4 % m == 0
        assert bound["blocks/moe/router"] == (
            (None, None, "model") if on_e else (None, None, None))
        assert bound["blocks/moe/w_gate"] == (
            (None, "model", None, None) if on_e
            else (None, None, None, "model"))
        assert bound["blocks/moe/w_down"] == (
            (None, "model", None, None) if on_e
            else (None, None, "model", None))


def _batch(cfg, seed=0, B=2, T=16):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(B, T + 1))
    return {"tokens": torch.as_tensor(toks[:, :-1]),
            "labels": torch.as_tensor(toks[:, 1:])}


@pytest.mark.parametrize("arch,kw", [
    ("yi-34b", {}),
    ("qwen3-1.7b", {"remat": True}),
    ("qwen3-1.7b", {"tie_embeddings": True,
                    "block_pattern": ("attn", "swa"),
                    "sliding_window": 8}),
    ("rwkv6-3b", {}),
    ("recurrentgemma-2b", {"n_layers": 3, "remat": True}),
    ("mixtral-8x22b", {}),
    ("llama4-maverick-400b-a17b", {"remat": True}),
])
def test_tp_loss_at_one_rank_is_the_plain_loss(arch, kw):
    """With m = 1 the tensor-parallel loss and gradients are
    ``lm_loss``'s bit for bit (no collective runs), the MoE load-balance
    term included."""
    cfg = get_config(arch).reduced(**kw)
    assert_tp_at_one_rank_is_plain(cfg, _batch(cfg))


@pytest.mark.parametrize("patches", [False, True],
                         ids=["tokens", "stub-patches"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_vlm_tp_loss_at_one_rank_is_the_plain_loss(remat, patches):
    """Reduced qwen2-vl-2b (M-RoPE over 8 vision-grid and 8 text
    positions) at m = 1: the tensor-parallel loss and gradients are
    ``lm_loss``'s bit for bit, with the stub patches of
    ``models.frontends`` over the first 8 positions and without; with
    them the embedding's gradient at the rows only those positions read
    is zero."""
    cfg = get_config("qwen2-vl-2b").reduced(remat=remat)
    batch = _batch(cfg)
    if patches:
        batch["extra"] = make_stub_embeds(torch.Generator().manual_seed(5),
                                          cfg, 2)
    g = assert_tp_at_one_rank_is_plain(cfg, batch)
    nv = cfg.vision_tokens
    hidden = set(batch["tokens"][:, :nv].flatten().tolist()) - set(
        batch["tokens"][:, nv:].flatten().tolist())
    assert hidden
    rows = g["embed"][sorted(hidden)]
    assert bool((rows == 0).all()) == patches


def assert_tp_at_one_rank_is_plain(cfg, batch):
    """The m = 1 tensor-parallel loss, aux and gradients of ``cfg`` on
    ``batch`` (with its ``"extra"`` where it has one) equal the plain
    ones bit for bit; returns the gradients."""
    params, axes = init_lm(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    mesh = tsh.MeshAxes(("clients", "model"), {"clients": 1, "model": 1})
    tp = TPContext(fe.auto_specs(axes, params, mesh),
                   {k: v.shape for k, v in params.items()}, None, 0, 1)
    plain = lambda p, b: lm_loss(p, cfg, b["tokens"], b["labels"],
                                 b.get("extra"))
    tpl = lambda p, b: lm_loss_tp(p, cfg, b["tokens"], b["labels"], tp,
                                  b.get("extra"))
    g0, l0 = grad_and_loss(plain, params, batch)
    g1, l1 = grad_and_loss(tpl, params, batch)
    assert torch.equal(l0, l1)
    with torch.no_grad():
        aux0 = plain(params, batch)[1]["aux"]
        aux1 = tpl(params, batch)[1]["aux"]
    assert torch.equal(aux0, aux1)
    assert (float(aux1) > 0) == bool(cfg.moe.num_experts)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    return g1


def tp_spec(mesh=(1, 1), n_layers=2, **fl):
    """examples/specs/yi34b_tp2x4.json at ``mesh``, cut in depth."""
    with open(ROOT / "examples" / "specs" / "yi34b_tp2x4.json") as f:
        d = json.load(f)
    d["model"]["kw"]["n_layers"] = n_layers
    d["fl"]["mesh"] = list(mesh)
    d["fl"].update(fl)
    d["eval"] = {"every": 0, "final": True, "verbose": False}
    return d


@pytest.mark.parametrize("fl", [{}, {"codec": "int8", "tau": 2}],
                         ids=["as-shipped", "int8-tau2"])
def test_auto_1x1_equals_replicate_bitforbit(fl):
    """A ``(1, 1)`` auto run is the ``(1, 1)`` replicate run bit for bit:
    history, final eval and params."""
    d = tp_spec(**fl)
    auto = texp.run_experiment(texp.ExperimentSpec.from_dict(d),
                               device="cpu")
    d["fl"]["model_sharding"] = "replicate"
    rep = texp.run_experiment(texp.ExperimentSpec.from_dict(d),
                              device="cpu")
    assert auto.history == rep.history
    assert auto.final_eval == rep.final_eval
    ea, _ = texp.build_experiment(
        texp.ExperimentSpec.from_dict(dict(d, fl=dict(
            d["fl"], model_sharding="auto"))), device="cpu")
    er, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(d),
                                  device="cpu")
    ea.run(2)
    er.run(2)
    for k, v in er.params.items():
        assert torch.equal(ea.params[k], v), k


# ------------------------------------------------------------ refusals


def test_model_sharding_knob_validation():
    """``tests/test_mesh2d.py``'s knob test against the port's FLConfig."""
    assert FLConfig().model_sharding == "replicate"
    cfg = FLConfig(scheduler="sharded", mesh=[1, 1], model_sharding="auto")
    assert cfg.model_sharding == "auto"
    assert FLConfig.from_dict(json.loads(json.dumps(cfg.to_dict()))) == cfg
    with pytest.raises(ValueError, match="model_sharding"):
        FLConfig(model_sharding="tp")
    with pytest.raises(ValueError, match="sharded"):
        FLConfig(scheduler="chunked", model_sharding="auto")


def _fcn(**fl):
    base = dict(num_clients=6, tau=2, lr=0.05, batch_size=16,
                scheduler="sharded", mesh=[1, 1], chunk_size=3,
                use_lbgm=True, delta_threshold=0.2,
                lbg_variant="topk-sharded", lbg_kw={"k_frac": 0.25},
                model_sharding="auto")
    base.update(fl)
    return {"name": "fcn", "model": {"name": "fcn", "kw": {}},
            "data": {"name": "mixture", "kw": {"n": 120, "n_eval": 10}},
            "partition": {"name": "iid", "kw": {}}, "fl": base,
            "rounds": 1, "eval": {"every": 0, "final": False,
                                  "verbose": False}}


def _fcn_engine(axes=True, **fl):
    """The FCN engine under ``fl``, handed a fake axes tree (the FCN
    component carries none) so a later refusal is reached."""
    d = _fcn(**fl)
    spec = texp.ExperimentSpec.from_dict(d)
    from repro_torch.fed import registry
    params, loss_fn = registry.MODELS.get("fcn")(seed=0, device="cpu")
    train, _ = registry.DATASETS.get("mixture")(n=120, n_eval=10)
    parts = registry.PARTITIONERS.get("iid")(train, spec.fl.num_clients)
    data = [{k: v[p] for k, v in train.items()} for p in parts]
    ax = {k: ("hidden",) * v.ndim for k, v in params.items()} if axes \
        else None
    return fe.FLEngine(loss_fn, params, data, spec.fl, device="cpu",
                       model_axes=ax)


def test_model_sharding_auto_needs_axes_metadata():
    """The FCN component carries no axes tree: engine construction fails
    actionably."""
    with pytest.raises(ValueError, match="sharding metadata"):
        texp.build_experiment(texp.ExperimentSpec.from_dict(_fcn()),
                              device="cpu")


@pytest.mark.parametrize("fl,match", [
    (dict(compressor="topk", compressor_kw={"k_frac": 0.1}), "compressor"),
    (dict(aggregator="trimmed_mean"), "collect mode"),
    (dict(lbg_variant="topk"), "topk-sharded"),
    (dict(fused_kernels=False), "topk-sharded"),
    ({}, "tensor-parallel form"),
], ids=["compressor", "collect", "store", "dense-fold", "no-tp-loss"])
def test_model_sharding_auto_refusals(fl, match):
    """Each refusal names its fix; axes are checked first, so a fake tree
    reaches the later checks."""
    with pytest.raises(ValueError, match=match):
        _fcn_engine(**fl)


def test_model_sharding_auto_refuses_a_scheduler_without_model_axes(
        monkeypatch):
    """A scheduler other than the built-in sharded one cannot bind model
    axes."""
    monkeypatch.setattr(fe, "make_scheduler", lambda cfg, K, device: (
        fe.ChunkedScheduler(cfg, K, device=device)))
    with pytest.raises(ValueError, match="cannot bind model axes"):
        _fcn_engine()


@pytest.mark.parametrize("arch", ["whisper-base"])
def test_other_families_refused_by_name(arch):
    """The encoder-decoder is refused at engine build, naming the arch and
    the cause the JAX package shares (``repro/fed/experiment.py:462``,
    ``repro/models/transformer.py:229``): the ``"lm"`` component's batches
    carry no encoder frames. Under ``"replicate"`` the same spec builds
    and fails at its first loss, as it does in the JAX package."""
    d = tp_spec()
    d["model"]["kw"] = {"arch": arch, "reduced": True, "n_layers": 2}
    d["data"]["kw"].update(vocab=512)
    with pytest.raises(ValueError,
                       match=f"{arch}.*encoder frames.*carry none"):
        texp.build_experiment(texp.ExperimentSpec.from_dict(d),
                              device="cpu")
    d["fl"]["model_sharding"] = "replicate"
    eng, _ = texp.build_experiment(texp.ExperimentSpec.from_dict(d),
                                   device="cpu")
    with pytest.raises(ValueError, match="enc-dec needs encoder frames"):
        eng.run(1)

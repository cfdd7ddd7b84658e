"""The port's LBGM training step over the rest of the single-card zoo,
against the JAX package's ``make_train_step`` on the CPU.

Each case runs two or three steps of K = 3 clients at the arch's
``reduced()``
(fp32, two layers, no remat) from the JAX package's params (carried across
with ``params_from_numpy``) on the same numpy batches and, for qwen2-vl and
whisper, the same stub embeddings (JAX's ``make_stub_embeds``, broadcast
over the clients as ``launch/train.py`` gives them). Held as
``tests/test_torch_trainer.py`` holds qwen3 (its constants): the discrete
metrics (``frac_scalar``, ``uplink_floats``, ``vanilla_uplink_floats``)
equal, the top-k banks' kept index sets equal, the loss within rtol 1e-5,
``mean_sin2`` within rtol 1e-3, the params and values within rtol 1e-4 /
atol 1e-6, and no client's sin² within 1e-5 of delta. Every case takes
both branches of Algorithm 1: step 1 sends every gradient (the LBGs are
zero), step 2 is the first decision; a third step runs where step 2
recycles every client, so that a full send also replaces a live LBG.
recurrentgemma runs at tau 2 only: its blocks are the same at tau 1, and
the tau-1 path of the replicated step is the qwen2-vl, whisper and
mixtral-replicated cases'.

MoE cases (mixtral in its config's ``fsdp`` + ``topk`` and in the
``replicated`` + ``topk`` that ``launch/train.py`` forces, llama4 in
``fsdp`` + ``topk``): every routing call of the port's run is held
against JAX's routing lines (``test_torch_lm_families._jax_routing``) on
the same layer input with JAX's params of that step: the routes
(``top_e``) and the drops (``keep``) equal, and no router margin (the k-th
against the (k+1)-th probability) within 1e-5, so that equal routes are
not luck; some routes are dropped. The load-balance aux reaches the loss
(``lm_loss`` returns ce + aux) and the router's gradient.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import frontends as jfront  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402
from repro_torch.data.synthetic import markov_lm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.train import trainer as ttr  # noqa: E402
from test_torch_lm_families import _jax_routing  # noqa: E402
from test_torch_trainer import (EXACT, LOSS_RTOL, MARGIN,  # noqa: E402
                                PARAM_TOL, SIN2_RTOL, _by_index, _cfgs,
                                _record_sin2)

K, B, T, LR = 3, 2, 16, 0.05

#: name -> (arch, dp_mode, variant, tau, delta, steps). delta puts every
#: client's sin² farther than MARGIN from it and takes both branches.
ZOO_CASES = {
    "mixtral_fsdp_topk": ("mixtral-8x22b", "fsdp", "topk", 1, 0.6, 2),
    "mixtral_replicated_topk": ("mixtral-8x22b", "replicated", "topk", 1,
                                0.6, 2),
    "llama4_fsdp_topk": ("llama4-maverick-400b-a17b", "fsdp", "topk", 1,
                         0.75, 2),
    "recurrentgemma_tau2": ("recurrentgemma-2b", "replicated", "full", 2,
                            0.85, 3),
    "qwen2vl_stubs": ("qwen2-vl-2b", "replicated", "full", 1, 0.6, 2),
    "whisper_stubs": ("whisper-base", "replicated", "full", 1, 0.6, 2),
    "yi34b_fsdp_topk": ("yi-34b", "fsdp", "topk", 1, 0.65, 3),
}


def _record_routes(monkeypatch):
    """(layer input, top_e, keep) of every routing call of the port."""
    seen = []
    real = tmoe.moe_routing

    def wrapped(p, x, cfg):
        r = real(p, x, cfg)
        seen.append((x.detach().numpy().copy(), r.top_e.numpy(),
                     r.keep.numpy()))
        return r
    monkeypatch.setattr(tmoe, "moe_routing", wrapped)
    return seen


def _router(params, layer):
    """Layer ``layer``'s router of a MoE stack (stacked ``blocks/*``)."""
    return {"router": params["blocks/moe/router"][layer]}


def _check_routes(calls, jparams_per_step, jcfg):
    """Each port routing call against JAX's routing on the same input:
    client by client, layer by layer, step by step."""
    L = jcfg.n_layers
    assert len(calls) == len(jparams_per_step) * K * L
    k = jcfg.moe.top_k
    dropped = 0
    for i, (x, top_e, keep) in enumerate(calls):
        step, layer = i // (K * L), i % L
        jr = _jax_routing(_router(jparams_per_step[step], layer),
                          jnp.asarray(x), jcfg)
        srt = np.sort(np.asarray(jr["probs"]), -1)[..., ::-1]
        margin = float((srt[..., k - 1] - srt[..., k]).min())
        assert margin > MARGIN, (i, margin)
        assert np.array_equal(top_e, np.asarray(jr["top_e"])), i
        assert np.array_equal(keep, np.asarray(jr["keep"])), i
        dropped += int((~keep).sum())
    assert dropped > 0


def _batch(cfg, tau, jcfg):
    toks, labels = markov_lm(K * B * tau, T, cfg.vocab_size, seed=1)
    lead = (K, tau, B) if tau > 1 else (K, B)
    batch = {"tokens": toks.reshape(*lead, T),
             "labels": labels.reshape(*lead, T)}
    stub = jfront.make_stub_embeds(jax.random.PRNGKey(3), jcfg, B)
    if stub is not None:
        batch["extra"] = np.broadcast_to(np.asarray(stub)[None],
                                         (K,) + stub.shape).copy()
    return batch


@pytest.mark.parametrize("case", ZOO_CASES)
def test_zoo_train_step_matches_jax(case, monkeypatch):
    arch, dp_mode, variant, tau, delta, steps = ZOO_CASES[case]
    jcfg, tcfg = _cfgs(arch, dp_mode, variant, tau)
    jstate, _ = jtr.init_train_state(jax.random.PRNGKey(0), jcfg, K)
    np_params = {k: np.asarray(v) for k, v in jstate["params"].items()}
    tstate, _ = ttr.init_train_state(None, tcfg, K, device="cpu",
                                     params=np_params)
    jstep = jax.jit(jtr.make_train_step(jcfg, K, LR, delta=delta))
    tstep = ttr.make_train_step(tcfg, K, LR, delta=delta)
    batch = _batch(tcfg, tau, jcfg)
    sin2 = _record_sin2(monkeypatch)
    moe = bool(tcfg.moe.num_experts)
    calls = _record_routes(monkeypatch) if moe else None
    jparams, fracs = [], []
    for _ in range(steps):
        jparams.append({k: np.asarray(v) for k, v in
                        jstate["params"].items()})
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        assert sorted(tm) == sorted(jm)
        for k in EXACT:
            assert float(tm[k]) == float(jm[k]), (k, tm[k], jm[k])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["mean_sin2"]),
                                   float(jm["mean_sin2"]), rtol=SIN2_RTOL)
        fracs.append(float(tm["frac_scalar"]))
    for k, v in tstate["params"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate["params"][k]),
                                   err_msg=k, **PARAM_TOL)
    assert len(sin2) == K * steps
    margin = min(abs(s - delta) for s in sin2)
    assert margin > MARGIN, f"a client's sin² lies {margin:.3g} from delta"
    assert max(fracs) > 0 and min(fracs) < 1, fracs
    for k, leaf in tstate["lbg"].items():
        jleaf = jstate["lbg"][k]
        if variant == "topk":
            got = _by_index(leaf["idx"].numpy(), leaf["val"].numpy())
            want = _by_index(np.asarray(jleaf["idx"]),
                             np.asarray(jleaf["val"]))
            assert np.array_equal(got[0], want[0]), k
            np.testing.assert_allclose(got[1], want[1], err_msg=k,
                                       **PARAM_TOL)
        else:
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf),
                                       err_msg=k, **PARAM_TOL)
    if moe:
        _check_routes(calls, jparams, jcfg)
        _aux_reaches_loss_and_router(tstate["params"], tcfg, batch)


def _aux_reaches_loss_and_router(params, cfg, batch):
    """``lm_loss`` is ce + aux with aux > 0, and aux alone moves the
    router."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, parts = tt.lm_loss(leaves, cfg, torch.from_numpy(
        batch["tokens"][0]), torch.from_numpy(batch["labels"][0]))
    assert float(parts["aux"].detach()) > 0
    assert float(loss.detach()) == float((parts["ce"] + parts["aux"]).detach())
    g, = torch.autograd.grad(parts["aux"], [leaves["blocks/moe/router"]])
    assert float(g.abs().max()) > 0


def test_build_experiment_takes_tensor_params():
    """``build_experiment(params=...)`` takes a dict of tensors as it takes
    numpy arrays, and keeps tensors already on the engine's device without
    a copy (the card's MoE weights are handed from the training phase to
    the FL round so)."""
    from repro_torch.fed.experiment import ExperimentSpec, build_experiment
    from test_torch_fl_lm import lm_spec
    spec = ExperimentSpec.from_dict(lm_spec("mixtral-8x22b", rounds=1,
                                            model_kw={"reduced": True}))
    eng, _ = build_experiment(spec, device="cpu")
    tensors = {k: v.clone() for k, v in eng.params.items()}
    arrays = {k: v.numpy() for k, v in tensors.items()}
    a, _ = build_experiment(spec, params=tensors, device="cpu")
    b, _ = build_experiment(spec, params=arrays, device="cpu")
    for k, v in tensors.items():
        assert a.params[k].data_ptr() == v.data_ptr()
        assert torch.equal(a.params[k], b.params[k])

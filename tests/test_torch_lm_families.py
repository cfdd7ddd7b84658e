"""The rest of the LM zoo in both packages from the same weights: the dense
34-123B configs, MoE (mixtral-8x22b, llama4), the RG-LRU hybrid
(recurrentgemma-2b), the M-RoPE VLM (qwen2-vl-2b) and the encoder-decoder
(whisper-base).

The JAX package's ``init_lm`` params carry across verbatim
(``params_from_numpy``). Each arch's ``reduced()`` in fp32 runs through both
packages on the same numpy tokens and stub embeddings (JAX's
``make_stub_embeds``, carried across as numpy). Tolerances, fp32:

- logits of ``forward``, ``prefill_logits``, ``make_prefill_step`` and
  every ``serve_step``, and ``lm_loss`` (loss, ce, aux): rtol 1e-4 /
  atol 1e-5 (matmul and softmax sums in other orders);
- the building blocks on numpy inputs: the same, except the RG-LRU
  state, rtol 1e-5 / atol 1e-6 (JAX's ``associative_scan`` and the port's
  doubling scan group the same products in other orders: a few fp32 ulps);
- exactly equal: ``sinusoidal_positions``, ``build_mrope_positions``,
  MoE's routes (``top_e``), ``keep`` and dispatch buffer, and
  ``generate``'s greedy tokens. The MoE cases assert that no router
  margin (the k-th against the (k+1)-th probability) lies within 1e-5, so
  equal routes are not luck, and one case runs under capacity pressure
  (drops > 0). The greedy cases assert that every step's top-1/top-2
  logit margin exceeds the logit difference between the packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and spinning
# OpenMP threads would starve the other workers' threads
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serve import decode as jd  # noqa: E402
from repro.train.trainer import make_prefill_step as jprefill  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import frontends as tfront  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.serve import decode as td  # noqa: E402
from repro_torch.train.trainer import make_prefill_step  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
MARGIN = 1e-5
NEW_ARCHS = ["yi-34b", "deepseek-67b", "mistral-large-123b", "mixtral-8x22b",
             "llama4-maverick-400b-a17b", "recurrentgemma-2b", "qwen2-vl-2b",
             "whisper-base"]


def _cfgs(arch, **over):
    return (dataclasses.replace(jget(arch).reduced(), **over),
            dataclasses.replace(tget(arch).reduced(), **over))


def _params(jcfg, seed=0):
    jp, _ = jt.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                 "cpu")


def _tokens(cfg, B, T, seed=1):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _stub(jcfg, B, seed=2):
    """JAX's stub frames/patches as numpy, or None for a text arch."""
    e = jfront.make_stub_embeds(jax.random.PRNGKey(seed), jcfg, B)
    return None if e is None else np.asarray(e)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               err_msg=what, **tol)


def _rng_np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


class _MoERecorder:
    """Wraps the port's ``apply_moe`` to keep each call's routing, so a
    test can assert that no router margin lies within ``MARGIN``."""

    def __init__(self, monkeypatch):
        self.routings = []
        orig = tmoe.apply_moe

        def rec(p, x, cfg):
            self.routings.append(tmoe.moe_routing(p, x, cfg))
            return orig(p, x, cfg)
        monkeypatch.setattr(tmoe, "apply_moe", rec)

    def min_margin(self, k):
        m = float("inf")
        for r in self.routings:
            srt = torch.sort(r.probs, dim=-1, descending=True).values
            if srt.shape[-1] > k:
                m = min(m, float((srt[..., k - 1] - srt[..., k]).min()))
        return m


# ------------------------------------------------------------ configs

def test_every_jax_arch_is_registered():
    from repro.configs import ASSIGNED_ARCHS as jassigned
    from repro.configs import all_configs as jall
    from repro_torch.configs import ASSIGNED_ARCHS, all_configs
    assert ASSIGNED_ARCHS == jassigned
    assert sorted(all_configs()) == sorted(jall())


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_lm_names_shapes_and_axes(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, jaxes = jt.init_lm(jax.random.PRNGKey(0), jcfg)
    tp, taxes = tt.init_lm(torch.Generator().manual_seed(0), tcfg,
                           device="cpu")
    assert list(tp) == list(jp)
    assert taxes == jaxes
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_width_init_counts(arch):
    """At the published widths: the port's ``init_lm`` on the meta device
    makes JAX's names and shapes (``jax.eval_shape``: no arrays), and as
    many params as ``param_count`` plus what its formula leaves out: the
    final norm (and whisper's ``enc_norm``), and for recurrentgemma the
    part of ``init_rglru`` (``5d^2 + 8d`` drawn) above the formula's
    rglru term (``4d + 2d^2 + 3d``), which the port keeps as JAX
    writes it."""
    from repro_torch.configs import param_count
    jcfg, tcfg = jget(arch), tget(arch)
    shapes = jax.eval_shape(lambda k: jt.init_lm(k, jcfg)[0],
                            jax.random.PRNGKey(0))
    tp, _ = tt.init_lm(torch.Generator(), tcfg, device="meta")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(s.shape) for k, s in shapes.items()}
    n = sum(int(v.numel()) for v in tp.values())
    d = tcfg.d_model
    rec = sum(tcfg.block_kind(i) == "rglru" for i in range(tcfg.n_layers))
    left_out = d * (2 if tcfg.encdec else 1) + rec * (3 * d * d + d)
    assert n == param_count(tcfg) + left_out


def test_sliced_draw_of_a_large_leaf(monkeypatch):
    """A leaf past ``SLICED_DRAW`` elements is drawn one slice of its
    leading axes at a time (the fewest axes whose slices fit), each cast
    into the leaf: the same numbers as those slices' draws."""
    monkeypatch.setattr(tcommon, "SLICED_DRAW", 10)
    store = tcommon.ParamStore(torch.Generator().manual_seed(3),
                               torch.bfloat16)
    leaf = store.param("w", (3, 4, 5), ("a", "b", "c"), scale=0.5)
    gen = torch.Generator().manual_seed(3)
    want = torch.stack([torch.randn((5,), generator=gen) * 0.5
                        for _ in range(12)]).reshape(3, 4, 5).bfloat16()
    assert leaf.dtype == torch.bfloat16 and torch.equal(leaf, want)
    small = store.param("b", (2, 5), ("a", "c"), init="uniform", scale=2.0)
    assert small.shape == (2, 5) and float(small.abs().max()) <= 2.0


# ------------------------------------------------------------ blocks

def test_sinusoidal_positions_equal():
    for length, dim in ((16, 128), (1500, 512), (7, 6)):
        assert np.array_equal(tcommon.sinusoidal_positions(length, dim)
                              .numpy(),
                              np.asarray(jcommon.sinusoidal_positions(
                                  length, dim)))


@pytest.mark.parametrize("nv,T", [(8, 20), (256, 300), (0, 9), (5, 3)])
def test_build_mrope_positions_equal(nv, T):
    jcfg, tcfg = _cfgs("qwen2-vl-2b", vision_tokens=nv)
    want = np.asarray(jt.build_mrope_positions(jcfg, 2, T))
    got = tt.build_mrope_positions(tcfg, 2, T).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("sections,hd", [((4, 6, 6), 32), ((16, 24, 24), 128)])
def test_mrope_rotate(sections, hd):
    x = _rng_np(0, 2, 11, 3, hd)
    pos3 = np.random.RandomState(1).randint(0, 500, (3, 2, 11)).astype(
        np.int32)
    want = jattn.mrope_rotate(jnp.asarray(x), jnp.asarray(pos3), sections,
                              1e6)
    got = tattn.mrope_rotate(_t(x), _t(pos3).long(), sections, 1e6)
    _close(got, want)
    # equal streams: standard RoPE
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    _close(tattn.mrope_rotate(_t(x), _t(same).long(), sections, 1e6),
           tattn.rope_rotate(_t(x), _t(same[0]).long(), 1e6))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    x, w, b = _rng_np(0, 2, 9, 16), _rng_np(1, 4, 16), _rng_np(2, 16)
    st = _rng_np(3, 2, 3, 16) if with_state else None
    jo, js = jrglru._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
    to, ts = trglru._causal_conv(_t(x), _t(w), _t(b), _t(st))
    _close(to, jo)
    _close(ts, js)


def _rglru_params(jcfg, seed=0):
    store = jcommon.ParamStore(jax.random.PRNGKey(seed))
    jrglru.init_rglru(store, "rec", jcfg)
    jp = jcommon.subtree(store.params, "rec")
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                 "cpu")


@pytest.mark.parametrize("T,carried", [(1, True), (5, False), (33, True),
                                       (257, False)])
def test_apply_rglru(T, carried):
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    jp, tp = _rglru_params(jcfg)
    d = jcfg.d_model
    x = _rng_np(4, 2, T, d)
    h0 = _rng_np(5, 2, d, scale=0.5) if carried else None
    c0 = _rng_np(6, 2, 3, d) if carried else None
    jo, (jh, jc) = jrglru.apply_rglru(
        jp, jnp.asarray(x), jcfg,
        state=None if h0 is None else jnp.asarray(h0),
        conv_state=None if c0 is None else jnp.asarray(c0))
    to, (th, tc) = trglru.apply_rglru(tp, _t(x), tcfg, state=_t(h0),
                                      conv_state=_t(c0))
    _close(th, jh, SCAN_TOL, "state")
    _close(tc, jc, what="conv state")
    _close(to, jo, what="out")


def test_rglru_scan_is_the_recurrence():
    """The doubling scan against the step-by-step recurrence in float64."""
    a = np.random.RandomState(0).uniform(0.5, 1.0, (2, 100, 8))
    bx = np.random.RandomState(1).randn(2, 100, 8)
    h0 = np.random.RandomState(2).randn(2, 8)
    h, want = h0, []
    for t in range(100):
        h = a[:, t] * h + bx[:, t]
        want.append(h)
    got = trglru._rglru_scan(_t(a), _t(bx), _t(h0))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


def _jax_routing(p, x, cfg):
    """The routing lines of ``repro.models.moe.apply_moe``, as written
    there, returning what it keeps internal."""
    B, T, d = x.shape
    E, k, cf = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    C = max(1, int(T * k * cf / E))
    logits = jnp.einsum("btd,de->bte", x, p["router"],
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_w, top_e = jax.lax.top_k(probs, k)
    routes = top_e.reshape(B, T * k)
    onehot = jax.nn.one_hot(routes, E, dtype=jnp.int32)
    pos_all = jnp.cumsum(onehot, axis=1) - onehot
    pos = jnp.sum(pos_all * onehot, axis=-1)
    keep = pos < C
    token_idx = jnp.tile(jnp.arange(T * k) // k, (B, 1))
    dest = routes * C + jnp.where(keep, pos, C * E)
    buf = jnp.zeros((B, E * C), jnp.int32)
    buf = jax.vmap(lambda b, dst, src: b.at[dst].set(src, mode="drop"))(
        buf, dest, token_idx)
    return {"probs": probs, "top_e": top_e, "pos": pos, "keep": keep,
            "buf": buf}


def _moe_params(jcfg, seed=0):
    store = jcommon.ParamStore(jax.random.PRNGKey(seed))
    jmoe.init_moe(store, "moe", jcfg)
    jp = jcommon.subtree(store.params, "moe")
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                 "cpu")


# (arch, overrides, T): top-2 of 4 and top-1 of 4 experts; a capacity
# factor of 0.5 drops routes
MOE_CASES = [("mixtral-8x22b", {}, 24), ("llama4-maverick-400b-a17b", {}, 24),
             ("mixtral-8x22b", {"capacity_factor": 0.5}, 40),
             ("llama4-maverick-400b-a17b", {"capacity_factor": 0.5}, 17),
             ("mixtral-8x22b", {}, 1)]


@pytest.mark.parametrize("arch,moe_over,T", MOE_CASES)
def test_apply_moe(arch, moe_over, T):
    jcfg, tcfg = _cfgs(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **moe_over))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             **moe_over))
    jp, tp = _moe_params(jcfg)
    x = _rng_np(7, 3, T, jcfg.d_model)
    jr = _jax_routing(jp, jnp.asarray(x), jcfg)
    tr = tmoe.moe_routing(tp, _t(x), tcfg)
    k = tcfg.moe.top_k
    srt = np.sort(np.asarray(jr["probs"]), -1)[..., ::-1]
    assert float((srt[..., k - 1] - srt[..., k]).min()) > MARGIN
    _close(tr.probs, jr["probs"])
    assert np.array_equal(tr.top_e.numpy(), np.asarray(jr["top_e"]))
    assert np.array_equal(tr.pos.numpy(), np.asarray(jr["pos"]))
    assert np.array_equal(tr.keep.numpy(), np.asarray(jr["keep"]))
    assert np.array_equal(tr.buf.numpy(), np.asarray(jr["buf"]))
    if moe_over:
        assert int((~tr.keep).sum()) > 0          # capacity pressure
    jo, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    to, taux = tmoe.apply_moe(tp, _t(x), tcfg)
    _close(to, jo, what="out")
    _close(taux, jaux, what="aux")


def test_moe_top_k_ties_go_to_the_lowest_index():
    """Equal router probabilities: the routes are the lowest-index
    experts, as ``jax.lax.top_k`` picks them."""
    jcfg, tcfg = _cfgs("mixtral-8x22b")
    jp, tp = _moe_params(jcfg)
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    x = _rng_np(8, 1, 6, jcfg.d_model)
    tr = tmoe.moe_routing(tp, _t(x), tcfg)
    jr = _jax_routing(jp, jnp.asarray(x), jcfg)
    assert np.array_equal(tr.top_e.numpy(), np.asarray(jr["top_e"]))
    assert (tr.top_e[..., 0] == 0).all() and (tr.top_e[..., 1] == 1).all()


def test_apply_cross_attn():
    jcfg, tcfg = _cfgs("whisper-base")
    jp, tp = _params(jcfg)
    jp0 = jcommon.subtree(jp, "dec_00")
    tp0 = tcommon.subtree(tp, "dec_00")
    x, e = _rng_np(9, 2, 7, jcfg.d_model), _rng_np(10, 2, 16, jcfg.d_model)
    want = jt._apply_cross_attn(jp0, jnp.asarray(x), jnp.asarray(e), jcfg)
    _close(tt._apply_cross_attn(tp0, _t(x), _t(e), tcfg), want)
    # and the decode step's: one query over the whole encoder output
    want1 = jd._decode_cross_attn(jp0, jnp.asarray(x[:, :1]),
                                  jnp.asarray(e), jcfg)
    _close(td._decode_cross_attn(tp0, _t(x[:, :1]), _t(e), tcfg), want1)


def test_stub_embeds_shapes_and_scale():
    for arch, shape in (("whisper-base", (3, 1500, 512)),
                        ("qwen2-vl-2b", (3, 256, 1536)),
                        ("yi-34b", None)):
        cfg = tget(arch)
        assert tfront.extra_embed_shape(cfg, 3) == \
            jfront.extra_embed_shape(jget(arch), 3) == shape
    cfg = tget("whisper-base")
    e = tfront.make_stub_embeds(torch.Generator().manual_seed(0), cfg, 2)
    assert e.dtype == torch.bfloat16 and e.shape == (2, 1500, 512)
    assert 0.018 < float(e.float().std()) < 0.022


# ------------------------------------------------------------ models

def _extra(jcfg, B):
    return _stub(jcfg, B) if (jcfg.encdec or jcfg.vision_tokens) else None


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_and_prefill_match_jax(arch, monkeypatch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    rec = _MoERecorder(monkeypatch)
    B, T = 2, 24
    toks = _tokens(jcfg, B, T)
    extra = _extra(jcfg, B)
    je = None if extra is None else jnp.asarray(extra)
    jl, jaux = jt.forward(jp, jcfg, jnp.asarray(toks), je)
    tl, taux = tt.forward(tp, tcfg, _t(toks), _t(extra))
    _close(tl, jl, what="forward logits")
    _close(torch.as_tensor(taux), jaux, what="aux")
    _close(tt.prefill_logits(tp, tcfg, _t(toks), _t(extra)),
           jt.prefill_logits(jp, jcfg, jnp.asarray(toks), je),
           what="prefill_logits")
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": _t(toks)}
    if extra is not None:
        jb["extra"], tb["extra"] = je, _t(extra)
    _close(make_prefill_step(tcfg)(tp, tb), jprefill(jcfg)(jp, jb),
           what="make_prefill_step")
    if tcfg.moe.num_experts:
        assert rec.routings and rec.min_margin(tcfg.moe.top_k) > MARGIN


def test_vlm_without_patches_and_with_few():
    """qwen2-vl with no stub (the grid positions alone) and with fewer
    patches than ``vision_tokens``."""
    jcfg, tcfg = _cfgs("qwen2-vl-2b")
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 2, 20)
    _close(tt.forward(tp, tcfg, _t(toks))[0],
           jt.forward(jp, jcfg, jnp.asarray(toks))[0])
    few = _stub(jcfg, 2)[:, :3]
    _close(tt.forward(tp, tcfg, _t(toks), _t(few))[0],
           jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(few))[0])


def test_encdec_needs_frames():
    _, tcfg = _cfgs("whisper-base")
    tp, _ = tt.init_lm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    with pytest.raises(ValueError, match="encoder frames"):
        tt.forward(tp, tcfg, torch.zeros((1, 4), dtype=torch.int64))
    assert not tt.uses_scan(tcfg) and tt.uses_scan(_cfgs("yi-34b")[1])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_lm_loss_matches_jax(arch, monkeypatch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    rec = _MoERecorder(monkeypatch)
    B, T = 2, 16
    toks = _tokens(jcfg, B, T)
    labels = _tokens(jcfg, B, T, seed=3)
    labels[0, :2] = -1
    extra = _extra(jcfg, B)
    jl, jaux = jt.lm_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                          None if extra is None else jnp.asarray(extra),
                          ce_chunk=8)
    tl, taux = tt.lm_loss(tp, tcfg, _t(toks), _t(labels).long(), _t(extra),
                          ce_chunk=8)
    _close(tl, jl, what="loss")
    _close(taux["ce"], jaux["ce"], what="ce")
    _close(taux["aux"], jaux["aux"], what="aux")
    if tcfg.moe.num_experts:
        assert float(taux["aux"]) > 0
        assert rec.min_margin(tcfg.moe.top_k) > MARGIN
    else:
        assert float(taux["aux"]) == 0.0


def test_lm_loss_moe_gradient_flows_through_the_aux(monkeypatch):
    """lm_loss = ce + aux: the router gets a gradient from both, as under
    ``jax.grad`` of the JAX loss."""
    jcfg, tcfg = _cfgs("mixtral-8x22b")
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 1, 8)
    labels = _tokens(jcfg, 1, 8, seed=3)
    name = "blocks/moe/router"
    jg = jax.grad(lambda p: jt.lm_loss(p, jcfg, jnp.asarray(toks),
                                       jnp.asarray(labels), ce_chunk=8)[0])(
        jp)[name]
    leaf = tp[name].clone().requires_grad_()
    loss, _ = tt.lm_loss(dict(tp, **{name: leaf}), tcfg, _t(toks),
                         _t(labels).long(), ce_chunk=8)
    (g,) = torch.autograd.grad(loss, [leaf])
    _close(g, jg, dict(rtol=1e-3, atol=1e-6), "router gradient")


def _enc_out(jcfg, B):
    """Encoder frames for a decode state (the stub, as the JAX serve
    script passes them)."""
    return _stub(jcfg, B) if jcfg.encdec else None


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_step_matches_jax(arch, monkeypatch):
    """8 decode steps (the swa ring of the reduced configs wraps at 32);
    logits of each, then the caches."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    rec = _MoERecorder(monkeypatch)
    B, L = 2, 6
    toks = _tokens(jcfg, B, 8)
    js, _ = jd.init_decode_state(jcfg, B, L)
    ts, taxes = td.init_decode_state(tcfg, B, L, device="cpu")
    assert taxes == jd.init_decode_state(jcfg, B, L)[1]
    enc = _enc_out(jcfg, B)
    if enc is not None:
        js["enc_out"], ts["enc_out"] = jnp.asarray(enc), _t(enc)
    for t in range(8):
        jl, js = jd.serve_step(jp, jcfg, js, jnp.asarray(toks[:, t:t + 1]))
        tl, ts = td.serve_step(tp, tcfg, ts, _t(toks[:, t:t + 1]))
        _close(tl, jl, what=f"step {t}")
    assert ts["pos"] == int(js["pos"]) == 8
    flat_j = jax.tree_util.tree_flatten_with_path(
        {k: v for k, v in js.items() if k != "pos"})[0]
    for path, want in flat_j:
        got = ts
        for p in path:
            got = got[p.key]
        _close(got, want, SCAN_TOL if path[-1].key == "h" else TOL,
               jax.tree_util.keystr(path))
    if tcfg.moe.num_experts:
        assert rec.min_margin(tcfg.moe.top_k) > MARGIN


def _jax_generate(jp, jcfg, prompt, gen, cache_len, enc_out):
    """The JAX serve script's loop (``repro.launch.serve.main``) on given
    weights: prompt by repeated decode, then greedy argmax."""
    state, _ = jd.init_decode_state(jcfg, prompt.shape[0], cache_len)
    if enc_out is not None:
        state["enc_out"] = jnp.asarray(enc_out)
    step = jax.jit(lambda p, s, t: jd.serve_step(p, jcfg, s, t))
    for t in range(prompt.shape[1]):
        logits, state = step(jp, state, jnp.asarray(prompt[:, t:t + 1]))
    out, chosen = [], []
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for _ in range(gen):
        out.append(np.asarray(tok))
        chosen.append(np.asarray(logits[:, -1]))
        logits, state = step(jp, state, tok)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    return np.concatenate(out, 1), np.stack(chosen, 1)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_generate_matches_jax_serve_loop(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    prompt = _tokens(jcfg, 2, 6)
    enc = _enc_out(jcfg, 2)
    want, jlog = _jax_generate(jp, jcfg, prompt, 5, 16, enc)
    res = tserve.generate(tp, tcfg, prompt, 5, 16, enc_out=_t(enc))
    got = res.tokens.numpy()
    diff = np.abs(res.logits.numpy() - jlog).max()
    srt = np.sort(jlog, -1)
    assert float((srt[..., -1] - srt[..., -2]).min()) > diff
    assert np.array_equal(got, want)


def test_generate_encdec_needs_frames():
    _, tcfg = _cfgs("whisper-base")
    tp, _ = tt.init_lm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    with pytest.raises(ValueError, match="enc_out"):
        tserve.generate(tp, tcfg, np.zeros((1, 2), np.int32), 1, 8)


@pytest.mark.parametrize("arch", ["whisper-base", "recurrentgemma-2b",
                                  "mixtral-8x22b"])
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    gen = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--gen", "3",
                       "--cache-len", "16"])
    assert gen.shape == (2, 3)
    assert "ms/step" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-base"])
def test_decode_equals_prefill_where_the_reference_does(arch):
    """recurrentgemma's decode reproduces its forward; whisper's too when
    ``enc_out`` is the encoder's output over the frames (the serve script
    passes the stub itself)."""
    _, tcfg = _cfgs(arch)
    tp, _ = tt.init_lm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    toks = _t(_tokens(tcfg, 2, 12))
    frames = torch.from_numpy(_rng_np(3, 2, tcfg.encoder_seq, tcfg.d_model,
                                      scale=0.02)) if tcfg.encdec else None
    with torch.no_grad():
        fwd, _ = tt.forward(tp, tcfg, toks, frames)
        state, _ = td.init_decode_state(tcfg, 2, 16, device="cpu")
        if tcfg.encdec:
            state["enc_out"] = tt.encode(tp, tcfg, frames)[0]
        dec = torch.cat([td.serve_step(tp, tcfg, state, toks[:, t:t + 1])[0]
                         for t in range(12)], 1)
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), **TOL)

"""The LM stack of the port (qwen3-1.7b, rwkv6-3b) against the JAX package.

The JAX package's ``init_lm`` params carry across verbatim
(``params_from_numpy``: flat names, stacked ``blocks/*`` leaves and
layouts unchanged; bf16 bit for bit). Reduced configs in fp32 run through
both packages on the same numpy tokens: logits of ``forward``,
``prefill_logits`` and ``make_prefill_step`` must agree to rtol 1e-4 /
atol 1e-5 (fp32; matmul and softmax sums in other orders), and so must
the building blocks on numpy inputs.
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
from repro.configs import param_count as jparam_count  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train.trainer import make_prefill_step as jprefill  # noqa: E402
from repro_torch.configs import INPUT_SHAPES  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import param_count  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import rwkv6 as trwkv6  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.train.trainer import make_prefill_step  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["qwen3-1.7b", "rwkv6-3b"]
#: the mixed and sliding-window patterns of the dense family (swa window
#: 8 < T, so the window masks; a two-kind pattern keeps layer_XX subtrees)
VARIANTS = {"stack": {}, "swa": {"block_pattern": ("swa",),
                                  "sliding_window": 8},
            "mixed": {"block_pattern": ("attn", "swa"), "sliding_window": 8}}


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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_jax(arch, reduced):
    jcfg, tcfg = jget(arch), tget(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for f in dataclasses.fields(tcfg):
        if f.name == "lbgm":
            continue
        want = getattr(jcfg, f.name)
        got = getattr(tcfg, f.name)
        if dataclasses.is_dataclass(want):
            want, got = dataclasses.asdict(want), dataclasses.asdict(got)
        assert got == want, f.name
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim
    assert [tcfg.block_kind(i) for i in range(5)] == \
        [jcfg.block_kind(i) for i in range(5)]
    assert param_count(tcfg) == jparam_count(jcfg)


def test_full_size_param_counts():
    """The published widths, as ``init_lm`` would draw them (JAX shapes,
    no arrays): qwen3-1.7b 2,031,739,904 params, rwkv6-3b 3,597,437,440."""
    for arch, n in (("qwen3-1.7b", 2_031_739_904),
                    ("rwkv6-3b", 3_597_437_440)):
        shapes = jax.eval_shape(lambda k: jt.init_lm(k, jget(arch))[0],
                                jax.random.PRNGKey(0))
        assert sum(int(np.prod(s.shape)) for s in shapes.values()) == n
    assert INPUT_SHAPES["prefill_32k"].seq_len == 32768


@pytest.mark.parametrize("arch,variant", [
    ("qwen3-1.7b", v) for v in sorted(VARIANTS)] + [("rwkv6-3b", "stack")])
def test_init_lm_names_shapes_and_order(arch, variant):
    jcfg, tcfg = _cfgs(arch, **VARIANTS[variant])
    jp, jaxes = jt.init_lm(jax.random.PRNGKey(0), jcfg)
    tp, taxes = tt.init_lm(torch.Generator().manual_seed(0), tcfg,
                           device="cpu")
    assert list(tp) == list(jp)
    assert taxes == jaxes
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert tp[k].dtype == torch.float32
    # ones and zeros inits are exact; the normal and uniform draws have
    # the JAX scales
    for k in ("final_norm",):
        assert torch.equal(tp[k], torch.ones_like(tp[k]))
    if arch == "rwkv6-3b":
        assert torch.equal(tp["blocks/tmix/w0"],
                           torch.zeros_like(tp["blocks/tmix/w0"]))
        mu = tp["blocks/tmix/mu_r"]
        assert float(mu.abs().max()) <= 0.5 and float(mu.std()) > 0.2
    emb = tp["embed"]
    assert 0.015 < float(emb.std()) < 0.025


def test_bf16_params_carry_across_bit_for_bit():
    """A bf16 JAX model (ml_dtypes bfloat16 numpy arrays) lands as
    torch.bfloat16 with the same 16 bits in every leaf."""
    cfg = dataclasses.replace(jget("qwen3-1.7b").reduced(),
                              dtype="bfloat16")
    jp, _ = jt.init_lm(jax.random.PRNGKey(0), cfg)
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    assert np_params["embed"].dtype.name == "bfloat16"
    tp = params_from_numpy(np_params, "cpu")
    for k, v in np_params.items():
        assert tp[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(tp[k].view(torch.int16).numpy(),
                                      v.view(np.int16))
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  np_params["embed"].astype(np.float32))


def test_bf16_model_runs_in_bf16():
    """The port's own bf16 reduced qwen3: bf16 weights, bf16 logits."""
    _, tcfg = _cfgs("qwen3-1.7b", dtype="bfloat16")
    tp, _ = tt.init_lm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in tp.values())
    logits, _ = tt.forward(tp, tcfg, torch.from_numpy(_tokens(tcfg, 2, 8)))
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", [16, 128])
def test_forward_and_prefill_match_jax(arch, T):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 2, T)
    jl, jaux = jt.forward(jp, jcfg, jnp.asarray(toks))
    tl, taux = tt.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(taux) == float(jaux) == 0.0
    jpre = jt.prefill_logits(jp, jcfg, jnp.asarray(toks))
    tpre = tt.prefill_logits(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **TOL)
    # the hidden states are unit-RMS after the final norm (the logits, 50x
    # smaller through the 0.02-scaled head): rtol 1e-4 at that scale
    jh, _ = jt.forward_hidden(jp, jcfg, jnp.asarray(toks))
    th, _ = tt.forward_hidden(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("variant", ["swa", "mixed"])
def test_window_patterns_match_jax(variant):
    jcfg, tcfg = _cfgs("qwen3-1.7b", **VARIANTS[variant])
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 2, 24)
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(toks))
    tl, _ = tt.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=2)
    toks = _tokens(jcfg, 3, 64, seed=4)
    want = jprefill(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (3, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_norms_and_ffn_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 16).astype(np.float32) * 3 + 1
    g = rng.randn(16).astype(np.float32)
    for jf, tf, kw in ((jcommon.rms_norm, tcommon.rms_norm, {"eps": 1e-5}),
                       (jcommon.group_norm_heads, tcommon.group_norm_heads,
                        {})):
        want = jf(jnp.asarray(x), jnp.asarray(g), **kw)
        got = tf(torch.from_numpy(x), torch.from_numpy(g), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    w = [rng.randn(*s).astype(np.float32) * 0.2
         for s in ((16, 24), (16, 24), (24, 16))]
    want = jcommon.swiglu(jnp.asarray(x), *(jnp.asarray(a) for a in w))
    got = tcommon.swiglu(torch.from_numpy(x), *(torch.from_numpy(a)
                                                for a in w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    sub = tcommon.subtree({"a/b": 1, "a/c/d": 2, "ab": 3}, "a")
    assert sub == jcommon.subtree({"a/b": 1, "a/c/d": 2, "ab": 3}, "a")


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 3, 32).astype(np.float32)
    pos = rng.randint(0, 5000, (2, 7)).astype(np.int32)
    want = jattn.rope_rotate(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tattn.rope_rotate(torch.from_numpy(x), torch.from_numpy(pos),
                            theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_decode_attention_matches_jax():
    rng = np.random.RandomState(2)
    q = rng.randn(2, 1, 4, 32).astype(np.float32)
    kc, vc = (rng.randn(2, 12, 2, 32).astype(np.float32) for _ in range(2))
    for valid in (1, 7, 12):
        want = jattn.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc)),
                                      valid_len=valid)
        got = tattn.decode_attention(*(torch.from_numpy(a)
                                       for a in (q, kc, vc)),
                                     valid_len=valid)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_matches_jax_jnp_path():
    """The full-sequence attention (the port's flash kernel's plain
    version on the CPU) against the JAX jnp path in fp32, with a query
    chunk smaller than T so JAX's chunked loop runs."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 40, 4, 32).astype(np.float32)
    k, v = (rng.randn(2, 40, 2, 32).astype(np.float32) for _ in range(2))
    for window in (None, 9):
        want = jattn.attention(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=True, window=window, q_chunk=8)
        got = tattn.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("decode", [False, True])
def test_rwkv6_block_matches_jax(decode):
    """``apply_rwkv6`` over a sequence, or one decode step from a given
    state and last token, and its carries."""
    jcfg, tcfg = _cfgs("rwkv6-3b")
    jp, tp = _params(jcfg, seed=3)
    jblk = {k[len("blocks/tmix/"):]: v[0] for k, v in jp.items()
            if k.startswith("blocks/tmix/")}
    tblk = {k[len("blocks/tmix/"):]: v[0] for k, v in tp.items()
            if k.startswith("blocks/tmix/")}
    rng = np.random.RandomState(4)
    B, d, H, hd = 2, tcfg.d_model, tcfg.n_heads, tcfg.resolved_head_dim
    x = rng.randn(B, 1 if decode else 20, d).astype(np.float32)
    state = rng.randn(B, H, hd, hd).astype(np.float32) * 0.3
    last = rng.randn(B, d).astype(np.float32)
    if decode:
        jo, (js, jl) = jrwkv6.rwkv6_decode_step(
            jblk, jnp.asarray(x), jcfg, jnp.asarray(state), jnp.asarray(last))
        to, (ts, tl) = trwkv6.rwkv6_decode_step(
            tblk, torch.from_numpy(x), tcfg, torch.tensor(state),
            torch.from_numpy(last))
    else:
        jo, (js, jl) = jrwkv6.apply_rwkv6(jblk, jnp.asarray(x), jcfg)
        to, (ts, tl) = trwkv6.apply_rwkv6(tblk, torch.from_numpy(x), tcfg)
    for got, want in ((to, jo), (ts, js), (tl, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

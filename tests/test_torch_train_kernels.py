"""The training slice's differentiable kernels and loss against the JAX package.

``kernels.flash_attention.flash_attention`` and ``kernels.rwkv6_scan.
rwkv6_scan`` are autograd Functions: the forward is the hand-written
kernel on the card and its plain version on the CPU, the backward plain
PyTorch on both, so these CPU tests run the backward the card runs. Their
gradients are held against ``jax.grad`` of the JAX package's jnp paths
(``repro.models.attention.attention``, ``repro.models.rwkv6.chunked_wkv``)
on the same numpy inputs, in fp32: flash rtol 1e-4 / atol 1e-6, the scan
rtol 1e-4 / atol 1e-5 (sums over a chunk's running log decay, whose
exponentials cancel). ``lm_loss``'s value and every parameter's gradient
are held against ``jax.value_and_grad`` of the JAX ``lm_loss`` on reduced
configs at rtol 1e-4 / atol 1e-5 (the LM tolerance of the serving tests).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402
from repro_torch.models import rwkv6 as trwkv6  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402

FLASH_TOL = dict(rtol=1e-4, atol=1e-6)
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)
LM_TOL = dict(rtol=1e-4, atol=1e-5)


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


# ------------------------------------------------------------------ flash

#: (B, Tq, Tk, Hq, Hkv, causal, window, q_offset): causal and not, a
#: window, GQA 4:2, Tq > 1024 (query blocks of 640 in both packages) and
#: q_offset (a cache's tail)
FLASH_CASES = {
    "causal": (2, 48, 48, 4, 2, True, None, 0),
    "full": (1, 40, 56, 4, 2, False, None, 0),
    "window": (1, 64, 64, 4, 4, True, 16, 0),
    "q_offset": (1, 24, 88, 4, 2, True, None, 64),
    "q_offset_window": (1, 24, 88, 4, 2, True, 8, 64),
    "blocks": (1, 1280, 1280, 4, 2, True, None, 0),
    "blocks_window": (1, 1280, 1280, 2, 2, True, 300, 0),
}


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_gradients_match_jax_grad(case):
    B, Tq, Tk, Hq, Hkv, causal, window, q_offset = FLASH_CASES[case]
    hd = 32
    rng = np.random.RandomState(sorted(FLASH_CASES).index(case))
    q = _randn(rng, B, Tq, Hq, hd)
    k, v = _randn(rng, B, Tk, Hkv, hd), _randn(rng, B, Tk, Hkv, hd)
    do = _randn(rng, B, Tq, Hq, hd)

    def f(q, k, v):
        o = jattn.attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset)
        return jnp.sum(o * do), o
    (_, jo), jg = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        q, k, v)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = ops.flash_attention(*ts, causal=causal, window=window,
                            q_offset=q_offset)
    tg = torch.autograd.grad(o, ts, torch.from_numpy(do))
    _close(o, jo, FLASH_TOL, "out")
    for name, a, b in zip("qkv", tg, jg):
        _close(a, b, FLASH_TOL, f"d{name}")


def test_flash_backward_blocks_and_key_band():
    """The backward's query blocks are the JAX ``q_chunk`` rule's, and a
    block leaves out only keys whose p is exactly 0; a row that sees no
    key keeps every key (the -1e30 fill makes its softmax uniform)."""
    Tk = 96
    assert fa._key_range(0, 32, Tk, True, None, 0) == (0, 32)
    assert fa._key_range(32, 64, Tk, True, 8, 0) == (25, 64)
    assert fa._key_range(0, 32, Tk, False, None, 0) == (0, Tk)
    # rows before the first key (causal, negative offset) and rows past
    # the last key's window: every key
    assert fa._key_range(0, 32, Tk, True, None, -1) == (0, Tk)
    assert fa._key_range(0, 32, Tk, True, 8, 100) == (0, Tk)
    rng = np.random.RandomState(7)
    q, k, v, do = (torch.from_numpy(_randn(rng, 1, T, 2, 32))
                   for T in (24, Tk, Tk, 24))
    for offset, window in ((-8, None), (100, 8), (0, 4)):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        o = ref.flash_attention_gqa_ref(*ts, causal=True, window=window,
                                        q_offset=offset)
        want = torch.autograd.grad(o, ts, do)
        got = fa.flash_attention_backward(q, k, v, do, causal=True,
                                          window=window, q_offset=offset,
                                          q_block=8)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_flash_cpu_forward_is_the_plain_version_and_counts_nothing():
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 16, 2, 32)) for _ in range(3))
    _build.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=True, window=4)
    assert torch.equal(got, ref.flash_attention_gqa_ref(q, k, v, causal=True,
                                                        window=4))
    assert _build.LAUNCHES["flash_attention"] == 0


# ------------------------------------------------------------------- scan

#: (B, T, decay, state): decays of ~e^-0.14 a step, and of ~e^-3 a step
#: that pass e^-60 inside a chunk (the clamp's region); a state in or not;
#: T = 40 < 64 runs one chunk of 40
SCAN_CASES = {"slow_state": (1, 128, "slow", True),
              "fast_state": (1, 128, "fast", True),
              "short_no_state": (2, 40, "slow", False)}


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_gradients_match_jax_grad(case):
    B, T, decay, with_state = SCAN_CASES[case]
    H, hd = 2, 32
    rng = np.random.RandomState(sorted(SCAN_CASES).index(case))
    r, k, v = (_randn(rng, B, T, H, hd, scale=0.5) for _ in range(3))
    shift = 1.0 if decay == "fast" else -2.0
    logw = -np.exp(_randn(rng, B, T, H, hd, scale=0.5) + shift)
    logw = logw.astype(np.float32)
    if decay == "fast":
        assert (-np.cumsum(logw[:, :64], axis=1) > 60).any()
    u = _randn(rng, H, hd, scale=0.5)
    s0 = _randn(rng, B, H, hd, hd, scale=0.5) if with_state else \
        np.zeros((B, H, hd, hd), np.float32)
    do, ds = _randn(rng, B, T, H, hd), _randn(rng, B, H, hd, hd)
    chunk = min(64, T)

    def f(*a):
        o, S = jrwkv6.chunked_wkv(*a[:5], chunk=chunk, state0=a[5])
        return jnp.sum(o * do) + jnp.sum(S * ds)
    jg = jax.grad(f, argnums=tuple(range(6)))(r, k, v, logw, u, s0)
    ts = [torch.from_numpy(x).requires_grad_()
          for x in (r, k, v, logw, u, s0)]
    o, S = trwkv6.chunked_wkv(*ts[:5], chunk=chunk, state0=ts[5])
    tg = torch.autograd.grad((o, S), ts,
                             (torch.from_numpy(do), torch.from_numpy(ds)))
    for name, a, b in zip(("r", "k", "v", "logw", "u", "state0"), tg, jg):
        _close(a, b, SCAN_TOL, f"d{name}")


def test_scan_gradient_without_a_state_gradient():
    """Only the output is used: the final state's gradient is None in
    autograd, taken as zeros."""
    rng = np.random.RandomState(5)
    ins = [torch.from_numpy(_randn(rng, 1, 16, 1, 32, scale=0.5))
           for _ in range(3)]
    logw = torch.from_numpy(-np.exp(_randn(rng, 1, 16, 1, 32) - 2))
    u = torch.from_numpy(_randn(rng, 1, 32))
    ts = [t.requires_grad_() for t in (*ins, logw, u)]
    o, _ = rs.rwkv6_scan(*ts)
    got = torch.autograd.grad(o.sum(), ts)
    plain = [t.detach().clone().requires_grad_() for t in ts]
    o2, _ = ref.rwkv6_chunked_ref(*plain, torch.zeros(1, 1, 32, 32), 16)
    want = torch.autograd.grad(o2.sum(), plain)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_scan_state_out_refuses_a_gradient():
    rng = np.random.RandomState(6)
    r, k, v = (torch.from_numpy(_randn(rng, 1, 1, 1, 32)) for _ in range(3))
    logw = torch.from_numpy(-np.exp(_randn(rng, 1, 1, 1, 32)))
    u = torch.from_numpy(_randn(rng, 1, 32)).requires_grad_()
    state = torch.zeros(1, 1, 32, 32)
    with pytest.raises(RuntimeError, match="state_out"):
        rs.rwkv6_scan(r, k, v, logw, u, state, state_out=state)
    with torch.no_grad():     # serving: in place, as before
        out, st = rs.rwkv6_scan(r, k, v, logw, u, state, state_out=state)
    assert st is state


# ---------------------------------------------------------------- lm_loss

def _cfgs(arch, **over):
    return (dataclasses.replace(jget(arch).reduced(), **over),
            dataclasses.replace(tget(arch).reduced(), **over))


#: (arch, T, remat): T < ce_chunk (one chunk), T = 1024 (two chunks of
#: 512); remat on (each block checkpointed) and off
LOSS_CASES = [("qwen3-1.7b", 48, False), ("qwen3-1.7b", 1024, True),
              ("rwkv6-3b", 48, True), ("rwkv6-3b", 1024, False)]


@pytest.mark.parametrize("arch,T,remat", LOSS_CASES)
def test_lm_loss_value_and_gradient_match_jax(arch, T, remat):
    jcfg, tcfg = _cfgs(arch, remat=remat)
    jp, _ = jt.init_lm(jax.random.PRNGKey(0), jcfg)
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    rng = np.random.RandomState(T)
    B = 2 if T < 512 else 1
    toks = rng.randint(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.randint(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels[rng.rand(B, T) < 0.2] = -1            # masked positions
    labels[0, :3] = -1

    def jloss(p):
        loss, aux = jt.lm_loss(p, jcfg, toks, labels)
        return loss, aux
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)

    params = {k: v.requires_grad_() for k, v in
              params_from_numpy(np_params, "cpu").items()}
    loss, aux = tt.lm_loss(params, tcfg, torch.from_numpy(toks),
                           torch.from_numpy(labels))
    names = sorted(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names],
                                allow_unused=True)
    _close(loss, jl, LM_TOL, "loss")
    _close(aux["ce"], jaux["ce"], LM_TOL, "ce")
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    for name, g in zip(names, grads):
        want = np.asarray(jg[name])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, err_msg=name, **LM_TOL)


def test_lm_loss_masks_every_label():
    """All labels masked: ce = 0 / max(0, 1) = 0, as in JAX."""
    _, tcfg = _cfgs("qwen3-1.7b")
    params, _ = tt.init_lm(torch.Generator().manual_seed(0), tcfg,
                           device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    loss, aux = tt.lm_loss(params, tcfg, toks, torch.full((1, 8), -1))
    assert float(loss) == 0.0 and float(aux["ce"]) == 0.0
    with pytest.raises(ValueError, match="ce_chunk"):
        tt.lm_loss(params, tcfg, torch.zeros((1, 12), dtype=torch.int64),
                   torch.zeros((1, 12), dtype=torch.int64), ce_chunk=8)


def test_remat_reruns_each_block_forward():
    """With ``cfg.remat`` each block's forward runs again in the backward
    (torch.utils.checkpoint): the model's attention calls double under
    autograd and stay one per layer without it."""
    _, tcfg = _cfgs("qwen3-1.7b", remat=True)
    params, _ = tt.init_lm(torch.Generator().manual_seed(0), tcfg,
                           device="cpu")
    calls = []
    real = ops.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    toks = torch.zeros((1, 16), dtype=torch.int64)
    ops.flash_attention = counted
    try:
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        loss, _ = tt.lm_loss(leaves, tcfg, toks, toks)
        assert len(calls) == tcfg.n_layers
        loss.backward()
        assert len(calls) == 2 * tcfg.n_layers
        with torch.no_grad():
            tt.prefill_logits(params, tcfg, toks)
        assert len(calls) == 3 * tcfg.n_layers
    finally:
        ops.flash_attention = real

"""Serving in both packages from the same weights: the decode step, the
ring cache, and the greedy driver.

Reduced qwen3-1.7b and rwkv6-3b in fp32, params carried across from JAX
``init_lm``. Every ``serve_step`` of 16 must give the JAX step's logits
to rtol 1e-4 / atol 1e-5, and the caches and recurrent states after them
must agree to the same tolerance. ``generate`` must pick JAX's greedy
tokens exactly; the test also asserts that at every step the top-1/top-2
logit margin exceeds the logit difference between the packages, so that
equal tokens are not luck. The port's own decode must reproduce its
forward logits at the JAX serve test's tolerance (rtol 5e-2 / atol 5e-3).
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
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serve import decode as jd  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.serve import decode as td  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["qwen3-1.7b", "rwkv6-3b"]


def _setup(arch, seed=0, **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget(arch).reduced(), **over)
    jp, _ = jt.init_lm(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, B, T, seed=1):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_layout_matches_jax(arch):
    jcfg, tcfg, _, _ = _setup(arch)
    js, jaxes = jd.init_decode_state(jcfg, 3, 40)
    ts, taxes = td.init_decode_state(tcfg, 3, 40, device="cpu")
    assert ts["pos"] == 0 and taxes == jaxes
    assert sorted(ts["layers"]) == sorted(js["layers"])
    for k, v in js["layers"].items():
        assert tuple(ts["layers"][k].shape) == v.shape, k
        assert str(ts["layers"][k].dtype).split(".")[1] == str(v.dtype), k
        assert not ts["layers"][k].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_jax(arch):
    """16 decode steps: logits each step, then the caches / states."""
    jcfg, tcfg, jp, tp = _setup(arch)
    B, T = 2, 16
    toks = _tokens(jcfg, B, T)
    js, _ = jd.init_decode_state(jcfg, B, T)
    ts, _ = td.init_decode_state(tcfg, B, T, device="cpu")
    jstep = jax.jit(lambda p, s, t: jd.serve_step(p, jcfg, s, t))
    for t in range(T):
        jl, js = jstep(jp, js, jnp.asarray(toks[:, t:t + 1]))
        tl, ts = td.serve_step(tp, tcfg, ts, torch.from_numpy(
            toks[:, t:t + 1]))
        assert tl.shape == (B, 1, tcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert ts["pos"] == int(js["pos"]) == T
    for k, v in js["layers"].items():
        np.testing.assert_allclose(ts["layers"][k].numpy(), np.asarray(v),
                                   **TOL)


def test_ring_buffer_wraps_as_jax():
    """A cache shorter than the stream (swa window 8, cache 8, 24 steps):
    the ring slot pos % L and valid_len min(pos + 1, L), step for step
    against JAX, and the last logits against the window-8 forward."""
    jcfg, tcfg, jp, tp = _setup("qwen3-1.7b", sliding_window=8,
                                block_pattern=("swa",))
    B, T, W = 1, 24, 8
    toks = _tokens(jcfg, B, T, seed=2)
    js, _ = jd.init_decode_state(jcfg, B, W)
    ts, _ = td.init_decode_state(tcfg, B, W, device="cpu")
    assert ts["layers"]["k"].shape[2] == W
    jstep = jax.jit(lambda p, s, t: jd.serve_step(p, jcfg, s, t))
    for t in range(T):
        jl, js = jstep(jp, js, jnp.asarray(toks[:, t:t + 1]))
        tl, ts = td.serve_step(tp, tcfg, ts, torch.from_numpy(
            toks[:, t:t + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k, v in js["layers"].items():
        np.testing.assert_allclose(ts["layers"][k].numpy(), np.asarray(v),
                                   **TOL)
    fwd, _ = tt.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl[:, 0].numpy(), fwd[:, -1].numpy(),
                               rtol=5e-2, atol=5e-3)


def test_mixed_pattern_serves_per_layer_caches():
    """A two-kind pattern keeps one cache per layer (layer_XX), as JAX."""
    jcfg, tcfg, jp, tp = _setup("qwen3-1.7b", sliding_window=4,
                                block_pattern=("attn", "swa"))
    B, T = 2, 10
    toks = _tokens(jcfg, B, T, seed=3)
    js, _ = jd.init_decode_state(jcfg, B, T)
    ts, _ = td.init_decode_state(tcfg, B, T, device="cpu")
    assert sorted(ts) == sorted(js)
    jstep = jax.jit(lambda p, s, t: jd.serve_step(p, jcfg, s, t))
    for t in range(T):
        jl, js = jstep(jp, js, jnp.asarray(toks[:, t:t + 1]))
        tl, ts = td.serve_step(tp, tcfg, ts, torch.from_numpy(
            toks[:, t:t + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("layer_00", "layer_01"):
        for k, v in js[name].items():
            np.testing.assert_allclose(ts[name][k].numpy(), np.asarray(v),
                                       **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """tests/test_serve.py's check on the port alone: sequential decode
    reproduces the full-sequence forward logits."""
    _, tcfg, _, tp = _setup(arch)
    B, T = 2, 16
    toks = torch.from_numpy(_tokens(tcfg, B, T))
    fwd, _ = tt.forward(tp, tcfg, toks)
    ts, _ = td.init_decode_state(tcfg, B, T, device="cpu")
    outs = []
    for t in range(T):
        logits, ts = td.serve_step(tp, tcfg, ts, toks[:, t:t + 1])
        outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), fwd.numpy(),
                               rtol=5e-2, atol=5e-3)


def _jax_serve_logits(jp, jcfg, prompt, gen, cache_len):
    """The loop of ``repro.launch.serve.main``: the logits each greedy
    token came from."""
    state, _ = jd.init_decode_state(jcfg, prompt.shape[0], cache_len)
    step = jax.jit(lambda p, s, t: jd.serve_step(p, jcfg, s, t))
    for t in range(prompt.shape[1]):
        logits, state = step(jp, state, jnp.asarray(prompt[:, t:t + 1]))
    chosen = []
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for _ in range(gen):
        chosen.append(np.asarray(logits[:, -1]))
        logits, state = step(jp, state, tok)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    return np.stack(chosen, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_serve_loop(arch, capsys):
    """``generate`` on the JAX driver's weights (``init_lm`` at
    PRNGKey(seed)) and prompt (``RandomState(seed)``) gives the tokens
    ``python -m repro.launch.serve`` prints, with every greedy choice
    clear of the difference between the packages' logits."""
    seed, B, P, G, L = 0, 4, 32, 16, 128
    jcfg, tcfg, jp, tp = _setup(arch, seed=seed)
    want = jserve.main(["--arch", arch, "--reduced", "--batch", str(B),
                        "--prompt-len", str(P), "--gen", str(G),
                        "--cache-len", str(L), "--seed", str(seed)])
    capsys.readouterr()
    prompt = np.random.RandomState(seed).randint(
        0, jcfg.vocab_size, size=(B, P)).astype(np.int32)
    res = tserve.generate(tp, tcfg, prompt, G, L)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    jlog = _jax_serve_logits(jp, jcfg, prompt, G, L)
    tlog = res.logits.numpy()
    assert tlog.shape == jlog.shape == (B, G, tcfg.vocab_size)
    np.testing.assert_allclose(tlog, jlog, **TOL)
    top2 = np.sort(jlog, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    diff = np.abs(tlog - jlog).max(axis=-1)
    assert (margin > diff).all(), (margin.min(), diff.max())
    assert res.prefill_s > 0 and res.decode_s > 0


def test_serve_cli_runs_on_the_cpu(capsys):
    gen = tserve.main(["--arch", "rwkv6-3b", "--reduced", "--batch", "2",
                       "--prompt-len", "5", "--gen", "3", "--cache-len",
                       "16", "--device", "cpu"])
    assert gen.shape == (2, 3)
    out = capsys.readouterr().out
    assert "generated tokens" in out and "on cpu" in out


def test_rwkv6_chunk_clamp_is_the_reference_behaviour():
    """The reference's chunked RWKV6 clamps exp(-cum) at e^60. At the
    models' initial decay (log w about -1 per step) a channel passes
    |cum| = 60 at step 60 of a 64-step chunk, and there the JAX package's
    own forward parts from its decode. The port reproduces both sides:
    its forward is JAX's forward and its decode is JAX's decode, at every
    position."""
    jcfg, tcfg, jp, tp = _setup("rwkv6-3b")
    B, T = 2, 128
    toks = _tokens(jcfg, B, T, seed=1)
    jfwd = np.asarray(jt.forward(jp, jcfg, jnp.asarray(toks))[0])
    js, _ = jd.init_decode_state(jcfg, B, T)
    ts, _ = td.init_decode_state(tcfg, B, T, device="cpu")
    jstep = jax.jit(lambda p, s, t: jd.serve_step(p, jcfg, s, t))
    jdec, tdec = [], []
    for t in range(T):
        jl, js = jstep(jp, js, jnp.asarray(toks[:, t:t + 1]))
        tl, ts = td.serve_step(tp, tcfg, ts, torch.from_numpy(
            toks[:, t:t + 1]))
        jdec.append(np.asarray(jl))
        tdec.append(tl.numpy())
    jdec, tdec = np.concatenate(jdec, 1), np.concatenate(tdec, 1)
    gap = np.abs(jdec - jfwd).max(axis=(0, 2)) / np.abs(jfwd).max()
    assert gap[:60].max() < 1e-4                 # the same recurrence
    assert gap[60:64].max() > 0.05               # the clamp's steps
    tfwd = tt.forward(tp, tcfg, torch.from_numpy(toks))[0].numpy()
    np.testing.assert_allclose(tfwd, jfwd, **TOL)
    np.testing.assert_allclose(tdec, jdec, **TOL)

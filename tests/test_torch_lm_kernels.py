"""The port's LM kernels (flash attention, RWKV6 scan) against the JAX
package, through their plain versions on the CPU.

``repro_torch.kernels.ops.flash_attention`` and ``ops.rwkv6_scan`` take
CPU tensors to their plain versions; they are held against the JAX
package's Pallas kernels run as its own tests run them
(``interpret=True``) and against ``repro.kernels.ref``, on the sweep of
``tests/test_kernels.py``. Inputs come from numpy with a fixed seed and go
to both; bf16 inputs are the same fp32 numbers rounded to bf16 by each
package (round to nearest even in both, so the same bits).

Tolerances: JAX's own kernel tests' — flash 2e-4 in fp32 and 2e-2 in
bf16 (the fp32 softmax sums in another order; bf16 output rounding), the
scan 1e-3 against the per-step recurrence. The chunked form with a state
in and out (``chunked_wkv``) is held against
``repro.models.rwkv6.chunked_wkv`` at rtol 1e-4 / atol 1e-5: the port sums
the running log decay in XLA's association (``ref.chunk_cumsum``, pinned
bit for bit below, and the CUDA kernel's blockwise order emulated against
it), so only dot-product order differs. The wrapper may write the final
state into a caller's buffer, ``state0`` included (decode's in-place
update): the same bits either way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and spinning
# OpenMP threads would starve the other workers' threads
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import rwkv6 as trwkv6  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(x: np.ndarray, jdt=jnp.float32, tdt=torch.float32):
    j = jnp.asarray(x).astype(jdt)
    return j, torch.from_numpy(x).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _qkv(seed, B, tq, tk, Hq, Hkv, hd, dt):
    rng = np.random.RandomState(seed)
    jdt, tdt, _ = DTYPES[dt]
    return [_pair(rng.randn(*s).astype(np.float32), jdt, tdt)
            for s in ((B, tq, Hq, hd), (B, tk, Hkv, hd), (B, tk, Hkv, hd))]


def _flat_ref(jq, jk, jv, causal, window):
    """``repro.kernels.ref.flash_attention_ref`` in the ops layout, GQA
    heads repeated as ``repro.kernels.ops.flash_attention`` does."""
    B, tq, Hq, hd = jq.shape
    tk, Hkv = jk.shape[1], jk.shape[2]
    g = Hq // Hkv
    qf = jq.transpose(0, 2, 1, 3).reshape(B * Hq, tq, hd)
    kf = jnp.repeat(jk.transpose(0, 2, 1, 3), g, axis=1).reshape(
        B * Hq, tk, hd)
    vf = jnp.repeat(jv.transpose(0, 2, 1, 3), g, axis=1).reshape(
        B * Hq, tk, hd)
    o = jref.flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    return o.reshape(B, Hq, tq, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("tq,tk", [(128, 128), (256, 256), (128, 384)])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_matches_pallas_and_ref(tq, tk, window, dt):
    """tests/test_kernels.py's sweep: B=1, Hq=2, Hkv=1, hd=64."""
    (jq, tq_), (jk, tk_), (jv, tv_) = _qkv(0, 1, tq, tk, 2, 1, 64, dt)
    got = ops.flash_attention(tq_, tk_, tv_, causal=True, window=window)
    assert got.dtype == DTYPES[dt][1] and got.shape == (1, tq, 2, 64)
    tol = DTYPES[dt][2]
    pallas = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  interpret=True)
    for want in (pallas, _flat_ref(jq, jk, jv, True, window)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("tq,tk", [(100, 100), (37, 75), (75, 37), (1, 1),
                                   (1, 130), (130, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_gqa_and_ragged_lengths_match_ref(tq, tk, causal, window, dt):
    """GQA g = 2 (Hq=4, Hkv=2, hd=32) and lengths the Pallas kernel does
    not take (Tq, Tk % 128 != 0), against the JAX oracle only. Rows that
    see no key (causal, window and tq > tk + window) are excluded: there
    the naive softmax averages every key and the kernel returns 0."""
    (jq, tq_), (jk, tk_), (jv, tv_) = _qkv(1, 2, tq, tk, 4, 2, 32, dt)
    got = ops.flash_attention(tq_, tk_, tv_, causal=causal, window=window)
    want = _flat_ref(jq, jk, jv, causal, window)
    tol = DTYPES[dt][2]
    rows = tq if window is None else min(tq, tk + window - 1)
    np.testing.assert_allclose(_np(got)[:, :rows], _np(want)[:, :rows],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [None, 30])
def test_flash_q_offset_is_the_tail_of_the_full_call(window):
    """A query block at absolute positions off.. sees what the same rows
    of the full causal call see (the JAX oracle has no offset: compare
    with its rows off..)."""
    off, T = 48, 80
    (jq, tq_), (jk, tk_), (jv, tv_) = _qkv(2, 1, T, T, 4, 2, 32, "f32")
    got = ops.flash_attention(tq_[:, off:].contiguous(), tk_, tv_,
                              causal=True, window=window, q_offset=off)
    want = _flat_ref(jq, jk, jv, True, window)[:, off:]
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_flash_twin_matches_jax_ref_flat():
    """ref.flash_attention_ref is the twin of the JAX oracle in its own
    (BH, T, hd) layout."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(3, 50, 16).astype(np.float32) for _ in range(3))
    for window in (None, 7):
        want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                        causal=True, window=window)
        got = tref.flash_attention_ref(*(torch.from_numpy(a)
                                         for a in (q, k, v)),
                                       causal=True, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def _scan_inputs(seed, B, t, H, hd, decay="mild"):
    """tests/test_kernels.py's inputs, from numpy: ``mild`` log decay
    -0.7 sigmoid(N) never reaches the chunked form's clamp; ``model`` is
    the LM's initial -1 per step, which reaches it from step 60 of a
    64-step chunk."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, t, H, hd).astype(np.float32) * 0.5
               for _ in range(3))
    z = rng.randn(B, t, H, hd)
    logw = (-0.7 / (1 + np.exp(-z)) if decay == "mild"
            else -np.exp(0.04 * z)).astype(np.float32)
    u = (rng.randn(H, hd) * 0.5).astype(np.float32)
    return r, k, v, logw, u


@pytest.mark.parametrize("t", [64, 256])
@pytest.mark.parametrize("hd", [32, 64])
def test_scan_matches_pallas_and_per_step_ref(t, hd):
    B, H = 1, 2
    arrs = _scan_inputs(0, B, t, H, hd)
    got, state = ops.rwkv6_scan(*(torch.from_numpy(a) for a in arrs))
    assert got.dtype == torch.float32 and state.shape == (B, H, hd, hd)
    j = [jnp.asarray(a) for a in arrs]
    pallas = jops.rwkv6_scan(*j, interpret=True)
    flat = lambda a: a.transpose(0, 2, 1, 3).reshape(B * H, t, hd)
    uf = jnp.broadcast_to(j[4][None], (B, H, hd)).reshape(B * H, hd)
    step = jref.rwkv6_scan_ref(*(flat(a) for a in j[:4]), uf)
    step = step.reshape(B, H, t, hd).transpose(0, 2, 1, 3)
    for want in (pallas, step):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-3)


def test_scan_twin_matches_jax_per_step_ref():
    arrs = _scan_inputs(1, 1, 40, 3, 8)
    flat = [a[0].transpose(1, 0, 2) for a in arrs[:4]]
    want = jref.rwkv6_scan_ref(*(jnp.asarray(a) for a in flat),
                               jnp.asarray(arrs[4]))
    got = tref.rwkv6_scan_ref(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in flat), torch.from_numpy(arrs[4]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("T", [1, 37, 128])
@pytest.mark.parametrize("decay", ["mild", "model"])
@pytest.mark.parametrize("with_state", [False, True])
def test_chunked_wkv_matches_jax(T, decay, with_state):
    """The model's chunked form, state in and out, against
    ``repro.models.rwkv6.chunked_wkv`` (chunk 64; T < 64 is one chunk)."""
    B, H, hd = 2, 3, 32
    r, k, v, logw, u = _scan_inputs(2, B, T, H, hd, decay)
    s0 = (np.random.RandomState(5).randn(B, H, hd, hd).astype(np.float32)
          * 0.5 if with_state else None)
    chunk = 64 if T >= 64 else T
    jo, js = jrwkv6.chunked_wkv(
        *(jnp.asarray(a) for a in (r, k, v, logw, u)), chunk=chunk,
        state0=None if s0 is None else jnp.asarray(s0))
    to, ts = trwkv6.chunked_wkv(
        *(torch.from_numpy(a) for a in (r, k, v, logw, u)), chunk=chunk,
        state0=None if s0 is None else torch.from_numpy(s0))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-5)


def test_chunked_wkv_keeps_the_chunk_assertion():
    r, k, v, logw, u = (torch.from_numpy(a)
                        for a in _scan_inputs(0, 1, 100, 1, 32))
    with pytest.raises(AssertionError):
        trwkv6.chunked_wkv(r, k, v, logw, u)


@pytest.mark.parametrize("n", [1, 5, 16, 17, 37, 64, 100, 256])
def test_chunk_cumsum_is_xla_cumsum_bit_for_bit(n):
    x = np.random.RandomState(n).randn(3, n, 4).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    got = tref.chunk_cumsum(torch.from_numpy(x), dim=1).numpy()
    np.testing.assert_array_equal(got, want)


def _kernel_running_sum(lw: torch.Tensor, c: int):
    """The scan kernel's running log decay over one chunk's rows, in its
    order (``csrc/rwkv6_scan.cu``, passes 1 and 2): a 64-row tile with rows
    past ``c`` zero-filled; four threads per channel, each summing its
    16-step block in sequence from 0; then the earlier blocks' totals added
    in sequence. Returns (cum over the c rows, total = the last row's)."""
    x = torch.zeros((64,) + lw.shape[1:], dtype=torch.float32)
    x[:c] = lw[:c]
    runs, tots = [], []
    for s in range(4):
        acc = torch.zeros(lw.shape[1:], dtype=torch.float32)
        run = []
        for j in range(16):
            acc = acc + x[16 * s + j]
            run.append(acc)
        runs.append(torch.stack(run))
        tots.append(acc)
    last = (c - 1) // 16
    pre, pl = [torch.zeros_like(tots[0])], None
    for j in range(last):
        pl = tots[0] if j == 0 else pl + tots[j]
        pre.append(pl)
    total = tots[0] if last == 0 else tots[last] + pl
    cum = torch.cat([runs[s] if s == 0 else runs[s] + pre[s]
                     for s in range(last + 1)])[:c]
    return cum, total


@pytest.mark.parametrize("c", [1, 5, 16, 17, 37, 48, 63, 64])
def test_kernel_running_sum_order_is_chunk_cumsum(c):
    """The kernel's blockwise running sum (4 threads per channel, then the
    blocks' prefix) equals ``ref.chunk_cumsum`` (XLA's association) bit for
    bit, its total the last row's."""
    lw = -torch.from_numpy(np.abs(np.random.RandomState(c).randn(
        c, 3, 64)).astype(np.float32))
    cum, total = _kernel_running_sum(lw, c)
    want = tref.chunk_cumsum(lw, dim=0)
    assert torch.equal(cum, want)
    assert torch.equal(total, want[-1])


@pytest.mark.parametrize("T", [1, 37, 64, 128])
def test_scan_state_out_updates_in_place(T):
    """``state_out=state0`` (decode's in-place update) gives the same output
    and state as a fresh state, and both agree with the plain version and
    the JAX package's ``chunked_wkv``."""
    B, H, hd = 2, 3, 32
    arrs = _scan_inputs(3, B, T, H, hd, "model")
    s0 = (np.random.RandomState(6).randn(B, H, hd, hd) * 0.5).astype(
        np.float32)
    r, k, v, logw, u = (torch.from_numpy(a) for a in arrs)
    chunk = min(64, T)
    out, st = ops.rwkv6_scan(r, k, v, logw, u, torch.from_numpy(s0))
    cache = torch.from_numpy(s0.copy())
    out2, st2 = ops.rwkv6_scan(r, k, v, logw, u, cache, state_out=cache)
    assert st2 is cache
    assert torch.equal(out, out2) and torch.equal(st, st2)
    buf = torch.empty_like(cache)
    out3, st3 = ops.rwkv6_scan(r, k, v, logw, u, torch.from_numpy(s0),
                               state_out=buf)
    assert st3 is buf and torch.equal(st3, st) and torch.equal(out3, out)
    ro, rst = tref.rwkv6_chunked_ref(r, k, v, logw, u, torch.from_numpy(s0),
                                     chunk)
    assert torch.equal(out, ro) and torch.equal(st, rst)
    jo, js = jrwkv6.chunked_wkv(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                                state0=jnp.asarray(s0))
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-5)


def test_decode_step_updates_the_state_in_place():
    """The model's decode step writes the new state over the cache tensor
    itself, equal to what ``apply_rwkv6`` returns in a fresh tensor."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm, layer_params
    from repro_torch.models.common import subtree
    cfg = dataclasses.replace(get_config("rwkv6-3b").reduced(),
                              dtype="float32")
    params, _ = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    _, p = next(iter(layer_params(params, cfg)))
    p = subtree(p, "tmix")
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 1, cfg.d_model), generator=g)
    state = torch.randn((2, H, hd, hd), generator=g) * 0.5
    last = torch.randn((2, cfg.d_model), generator=g)
    y, (s_new, _) = trwkv6.apply_rwkv6(p, x, cfg, state=state.clone(),
                                       shifted=last)
    cache = state.clone()
    y2, (s2, _) = trwkv6.rwkv6_decode_step(p, x, cfg, cache, last)
    assert s2 is cache
    assert torch.equal(y, y2) and torch.equal(cache, s_new)


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    before = dict(_build.LAUNCHES)
    (_, q), (_, k), (_, v) = _qkv(4, 1, 8, 8, 2, 1, 32, "f32")
    ops.flash_attention(q, k, v)
    ops.rwkv6_scan(*(torch.from_numpy(a)
                     for a in _scan_inputs(0, 1, 8, 1, 32)))
    assert _build.LAUNCHES == before
    assert not _build._libs


def test_wrappers_refuse_bad_shapes():
    q = torch.zeros(1, 4, 3, 32)
    kv = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(kv, kv, kv, window=0)
    with pytest.raises(ValueError):
        ops.flash_attention(kv, kv[:, :, :, :16], kv)
    r = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="u of shape"):
        ops.rwkv6_scan(r, r, r, r, torch.zeros(3, 32))
    with pytest.raises(ValueError, match="state0"):
        ops.rwkv6_scan(r, r, r, r, torch.zeros(2, 32),
                       torch.zeros(1, 2, 32, 16))
    with pytest.raises(ValueError, match="chunk"):
        ops.rwkv6_scan(r, r, r, r, torch.zeros(2, 32), chunk=65)
    with pytest.raises(ValueError, match="state_out"):
        ops.rwkv6_scan(r, r, r, r, torch.zeros(2, 32),
                       state_out=torch.zeros(1, 2, 32, 16))
    with pytest.raises(ValueError, match="state_out"):
        ops.rwkv6_scan(r, r, r, r, torch.zeros(2, 32),
                       state_out=torch.zeros(1, 2, 32, 32).double())
    with pytest.raises(ValueError, match="state_out"):
        ops.rwkv6_scan(r, r, r, r, torch.zeros(2, 32),
                       state_out=torch.zeros(1, 2, 32, 64)[..., ::2])

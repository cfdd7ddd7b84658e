"""The arithmetic of the bf16 tensor-core flash-attention kernel, on the CPU.

``csrc/flash_attention_sm90.cu`` takes bf16 q, k, v, sums q.k in fp32 and
keeps p in fp32, but the tensor cores take bf16 operands for P.V. So the
kernel splits p into ``hi = bf16(p)`` and ``lo = bf16(p - hi)`` and adds
both products into one fp32 accumulator. :func:`emulate` below repeats that
arithmetic in plain PyTorch (64-key tiles, the online softmax in the log2
domain, as the kernel runs it); it lives here, not in the package. It is
held against the fp32 plain version of the same bf16 inputs
(``ref.flash_attention_gqa_ref``, and the JAX package's
``repro.kernels.ref.flash_attention_ref``) under exactly the per-element
bf16 tolerance ``chip_smoke.py`` holds the kernel to on the card. Rounding
p to bf16 alone misses that tolerance on the same inputs, which is why the
kernel splits. The wrapper's choice of kernel by dtype is checked through
its pure helper, without a launch.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _chip_smoke()
RTOL, ATOL = _CS.FLASH_RTOL_BF16, _CS.FLASH_ATOL_BF16
BK = 64  # keys per tile of the kernel


def emulate(q, k, v, *, causal=True, window=None, split=True):
    """The kernel's arithmetic on bf16 q (B,Tq,Hq,hd), k, v (B,Tk,Hkv,hd):
    fp32 scores, per 64-key tile the running max in the log2 domain, fp32
    p = 2^(s * log2(e)/sqrt(hd) - m) (0 where masked), P.V as hi.V + lo.V
    (``split``) or bf16(p).V, out = acc / max(l, 1e-30) rounded to bf16."""
    B, Tq, Hq, hd = q.shape
    Tk, g = k.shape[1], Hq // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (x.float().transpose(1, 2).repeat_interleave(g, 1)
              for x in (k, v))
    scale_log2 = float(np.float32(np.log2(np.e) / np.sqrt(hd)))
    m = torch.full((B, Hq, Tq, 1), -1e30)
    l = torch.zeros((B, Hq, Tq, 1))
    acc = torch.zeros((B, Hq, Tq, hd))
    qpos = torch.arange(Tq)[:, None]
    for kt in range(0, Tk, BK):
        ks, vs = kf[:, :, kt:kt + BK], vf[:, :, kt:kt + BK]
        kpos = torch.arange(kt, kt + ks.shape[2])[None, :]
        ok = torch.ones((Tq, ks.shape[2]), dtype=torch.bool)
        if causal:
            ok &= qpos >= kpos
        if window is not None:
            ok &= (qpos - kpos) < window
        s = torch.where(ok, qf @ ks.transpose(-1, -2), -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        corr = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s * scale_log2 - m_new), 0.0)
        if split:
            hi = p.bfloat16().float()
            pv = hi @ vs + (p - hi).bfloat16().float() @ vs
        else:
            pv = p.bfloat16().float() @ vs
        acc = acc * corr + pv
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).transpose(1, 2).bfloat16()


def _inputs(T, hd, seed, cancel=False):
    """bf16 q (1,T,2,hd), k, v (1,T,1,hd) from numpy. ``cancel``: v's rows
    come in pairs (x, -x + 1e-3 noise), so the outputs lie near 0."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(1, T, H, hd).astype(np.float32) for H in (2, 1, 1))
    if cancel:
        x = v[:, 0::2]
        v[:, 1::2] = -x[:, :T // 2] + 1e-3 * rng.randn(1, T // 2, 1, hd)
        q, k = q * 0.3, k * 0.3
    return [torch.from_numpy(a).bfloat16() for a in (q, k, v)]


def _violations(got, want):
    """Elements beyond chip_smoke.py's bf16 tolerance."""
    d = (got.float() - want).abs()
    return int((d > ATOL + RTOL * want.abs()).sum())


def _jax_ref(q, k, v, window):
    """``repro.kernels.ref.flash_attention_ref`` in fp32 on the same
    values, in the ops layout (one kv head repeated for two q heads)."""
    qf = jnp.asarray(q.float().numpy()).transpose(0, 2, 1, 3)[0]
    kf, vf = (jnp.repeat(jnp.asarray(x.float().numpy()).transpose(0, 2, 1, 3),
                         2, axis=1)[0] for x in (k, v))
    o = jref.flash_attention_ref(qf, kf, vf, causal=True, window=window)
    return torch.from_numpy(np.array(o)).transpose(0, 1)[None]


@pytest.mark.parametrize("T", [1, 2, 100, 300])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("window", [None, 50])
def test_split_p_meets_the_kernel_tolerance(T, hd, window):
    q, k, v = _inputs(T, hd, seed=T * 1000 + hd)
    got = emulate(q, k, v, window=window)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    want = ref.flash_attention_gqa_ref(q.float(), k.float(), v.float(),
                                       window=window)
    assert _violations(got, want) == 0
    jwant = _jax_ref(q, k, v, window)
    np.testing.assert_allclose(want.numpy(), jwant.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert _violations(got, jwant) == 0


def test_split_p_meets_the_tolerance_where_outputs_cancel():
    """v's rows cancel in pairs, so outputs lie near 0 (median |out| below
    0.02), where the absolute part of the tolerance counts."""
    q, k, v = _inputs(300, 64, seed=7, cancel=True)
    want = ref.flash_attention_gqa_ref(q.float(), k.float(), v.float())
    assert float(want.abs().median()) < 0.02
    assert _violations(emulate(q, k, v), want) == 0


@pytest.mark.parametrize("T,hd", [(100, 32), (300, 128)])
@pytest.mark.parametrize("cancel", [False, True])
def test_single_bf16_p_misses_the_kernel_tolerance(T, hd, cancel):
    """Why the kernel splits p: p rounded once to bf16 before P.V (as SDPA
    and the JAX model path do) breaks the one-ulp check on these inputs."""
    q, k, v = _inputs(T, hd, seed=7 if cancel else T * 1000 + hd,
                      cancel=cancel)
    want = ref.flash_attention_gqa_ref(q.float(), k.float(), v.float())
    assert _violations(emulate(q, k, v, split=False), want) > 0
    assert _violations(emulate(q, k, v), want) == 0


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, ("flash_attention_sm90", "flash_attention_sm90_launch")),
    (torch.float32, ("flash_attention", "flash_attention_launch"))])
def test_dtype_selects_the_kernel(dtype, kernel):
    """bf16 goes to the tensor-core kernel, fp32 to the CUDA-core kernel;
    both sources are built by ``_build`` and nothing was built here."""
    assert fa.kernel_for(dtype) == kernel
    assert kernel[0] in _build.SOURCES
    assert (_build.CSRC / f"{kernel[0]}.cu").is_file()
    assert not _build._libs


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int8])
def test_other_dtypes_have_no_kernel(dtype):
    with pytest.raises(TypeError):
        fa.kernel_for(dtype)

"""The device rule: the port runs on the CUDA card unless asked for the CPU.

Entry points default to ``device="cuda"`` and raise without a card; a
kernel wrapper handed a CUDA request on a machine without CUDA raises
rather than fall back to its plain version. The tests marked ``gpu`` need
the card (they run on the H100 through ``chip_smoke.py``'s build) and skip
here.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and spinning
# OpenMP threads would starve the other workers' threads
torch.set_num_threads(1)

from repro_torch.fed import experiment as texp  # noqa: E402
from repro_torch.fed.engine import FLEngine, resolve_device  # noqa: E402
from repro_torch.fed.flconfig import FLConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.lbgm_projection import \
    lbgm_projection_batched  # noqa: E402
from repro_torch.kernels.lbgm_sparse import (  # noqa: E402
    lbgm_dequant_accum, lbgm_sparse_decision_batched)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig, MoEConfig  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.transformer import init_lm  # noqa: E402
from repro_torch.serve.decode import init_decode_state  # noqa: E402


def _spec():
    return texp.ExperimentSpec.from_dict({
        "fl": {"num_clients": 2, "batch_size": 4},
        "data": {"name": "mixture", "kw": {"n": 40, "n_eval": 10}},
        "partition": {"name": "iid", "kw": {}}, "rounds": 1})


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        texp.build_experiment(_spec())
    with pytest.raises(RuntimeError, match="CUDA"):
        texp.run_experiment(_spec())
    data = [{"x": np.zeros((3, 2), np.float32)} for _ in range(2)]
    with pytest.raises(RuntimeError, match="CUDA"):
        FLEngine(lambda p, b: (0, {}), {"w": np.zeros(2, np.float32)}, data,
                 FLConfig(num_clients=2))
    from repro_torch.fed.run import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--rounds", "1"])


def test_lm_entry_points_raise_without_cuda(no_cuda):
    """The serving slice's entry points default to the card too."""
    cfg = get_config("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--reduced", "--gen", "1", "--prompt-len", "1"])
    params, _ = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert params["embed"].device.type == "cpu"


#: every arch id of the JAX package's registry
JAX_ARCHS = ["llama4-maverick-400b-a17b", "rwkv6-3b", "mistral-large-123b",
             "qwen3-1.7b", "whisper-base", "recurrentgemma-2b",
             "mixtral-8x22b", "qwen2-vl-2b", "yi-34b", "deepseek-67b",
             "paper-cnn", "paper-fcn"]


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_jax_configs_carry_across(arch):
    """The port's ArchConfig refuses no family: each JAX config, carried
    across field by field (all but ``unroll``, a knob of the JAX cost
    pass), is accepted, equals the port's ``get_config(arch)``, and has
    the same ``param_count`` and ``reduced()``."""
    from repro.configs import get_config as jget
    from repro.configs import active_param_count as jactive
    from repro.configs import param_count as jparam_count
    from repro_torch.configs import active_param_count, param_count
    from repro_torch.configs.base import LBGMConfig
    jcfg = jget(arch)
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    assert names == {f.name for f in dataclasses.fields(jcfg)} - {"unroll"}

    def carry(c):
        kw = {n: getattr(c, n) for n in names if n not in ("moe", "lbgm")}
        kw["moe"] = MoEConfig(**dataclasses.asdict(c.moe))
        kw["lbgm"] = LBGMConfig(**dataclasses.asdict(c.lbgm))
        return ArchConfig(**kw)
    tcfg = get_config(arch)
    assert carry(jcfg) == tcfg
    assert param_count(tcfg) == jparam_count(jcfg)
    assert active_param_count(tcfg) == jactive(jcfg)
    assert carry(jcfg.reduced()) == tcfg.reduced()
    assert param_count(tcfg.reduced()) == jparam_count(jcfg.reduced())


def test_cpu_runs_when_asked():
    res = texp.run_experiment(_spec(), device="cpu")
    assert res.device == "cpu" and len(res.records) == 1
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_kernel_wrappers_refuse_cuda_without_cuda(no_cuda):
    """A CUDA tensor cannot exist here, so hand the wrappers the device
    check's view of one: the check raises instead of falling back."""
    class FakeCuda:
        device = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="CUDA is not"):
        _build.check_card(FakeCuda())
    with pytest.raises(RuntimeError, match="CUDA"):
        lbgm_projection_batched(torch.zeros(1, 4, device="meta"),
                                torch.zeros(1, 4, device="meta"))
    with pytest.raises(RuntimeError, match="CUDA"):
        lbgm_sparse_decision_batched(
            torch.zeros(1, 1, 8, device="meta"),
            torch.zeros(1, 1, 2, dtype=torch.int32, device="meta"))
    with pytest.raises(RuntimeError, match="CUDA"):
        lbgm_dequant_accum(
            torch.zeros(1, 8, device="meta"), torch.ones(2, device="meta"),
            torch.ones(2, device="meta"),
            torch.zeros(2, 1, 2, dtype=torch.int32, device="meta"),
            torch.zeros(2, 1, 2, dtype=torch.int8, device="meta"),
            torch.ones(2, 1, 1, device="meta"))


def test_lm_kernel_wrappers_refuse_cuda_without_cuda(no_cuda, monkeypatch):
    """The LM kernels, like the LBGM ones, never fall back for a tensor
    off the plain devices: it raises. Their plain devices are the CPU and
    meta (the dry run counts the plain versions' operations on meta
    tensors), so meta tensors get the plain versions' shapes; with meta
    taken off the plain devices, a meta tensor stands for any other
    device and raises."""
    q = torch.zeros(1, 4, 2, 32, device="meta")
    u = torch.zeros(2, 32, device="meta")
    s0 = torch.zeros(1, 2, 32, 32, device="meta")
    o = flash_attention(q, q, q)
    assert o.device.type == "meta" and o.shape == q.shape
    out, st = rwkv6_scan(q, q, q, q, u, s0)
    assert out.device.type == st.device.type == "meta"
    assert out.shape == q.shape and st.shape == s0.shape
    monkeypatch.setattr(_build, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="CUDA"):
        rwkv6_scan(q, q, q, q, u, s0)


def test_engine_sets_no_tf32_on_the_card(monkeypatch):
    """resolve_device('cuda') turns TF32 off for matmuls and cuDNN."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cuda").type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_build_is_lazy():
    """Importing the kernel modules built nothing and found no compiler;
    the build sources are the six .cu files of the port's paths (flash
    attention has two: bf16 on the tensor cores, fp32 on the CUDA
    cores)."""
    assert not _build._libs
    assert _build.SOURCES == ("lbgm_projection", "lbgm_sparse_decision",
                              "lbgm_dequant_accum", "flash_attention",
                              "flash_attention_sm90", "rwkv6_scan")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert json.dumps(sorted(_build.LAUNCHES)) == json.dumps(
        ["flash_attention", "lbgm_dequant_accum", "lbgm_projection",
         "lbgm_sparse_decision", "lbgm_sparse_decision_two_pass",
         "rwkv6_scan"])


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py on the H100)")
    g = torch.randn(4, 100352, device="cuda")
    got = lbgm_projection_batched(g, g * 0.5)
    want = [x.cpu() for x in
            lbgm_projection_batched(g.cpu(), (g * 0.5).cpu())]
    for a, w in zip(got, want):
        torch.testing.assert_close(a.cpu(), w, rtol=1e-5, atol=1e-3)
    blocks = torch.randn(4, 16, 65536, device="cuda")
    idx = torch.randint(0, 65536, (4, 16, 627), dtype=torch.int32,
                        device="cuda")
    for two_pass in (False, True):
        got = lbgm_sparse_decision_batched(blocks, idx, two_pass=two_pass)
        want = lbgm_sparse_decision_batched(blocks.cpu(), idx.cpu(),
                                            two_pass=two_pass)
        assert torch.equal(got[2].cpu(), want[2])
        assert torch.equal(got[3].cpu(), want[3])
    for qdt in (torch.int8, torch.float8_e4m3fn):
        acc = torch.randn(16, 65536)
        idx = torch.argsort(torch.rand(10, 16, 65536), -1)[..., :627].to(
            torch.int32)
        qv = torch.randint(-127, 128, (10, 16, 627)).float().to(qdt)
        args = (torch.rand(10), torch.rand(10), idx, qv,
                torch.rand(10, 16, 1))
        got = lbgm_dequant_accum(acc.cuda(), *(a.cuda() for a in args))
        assert torch.equal(got.cpu(), lbgm_dequant_accum(acc, *args))


@pytest.mark.gpu
def test_lm_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py on the H100)")
    gen = torch.Generator().manual_seed(0)
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        q = torch.randn(2, 300, 16, 128, generator=gen).to(dtype)
        k, v = (torch.randn(2, 300, 8, 128, generator=gen).to(dtype)
                for _ in range(2))
        for window in (None, 100):
            got = flash_attention(q.cuda(), k.cuda(), v.cuda(),
                                  window=window)
            want = flash_attention(q, k, v, window=window)
            torch.testing.assert_close(got.cpu().float(), want.float(),
                                       rtol=tol, atol=tol)
    r, k, v = (torch.randn(2, 100, 40, 64, generator=gen) * 0.5
               for _ in range(3))
    logw = -torch.exp(0.04 * torch.randn(2, 100, 40, 64, generator=gen))
    u = torch.randn(40, 64, generator=gen) * 0.5
    s0 = torch.randn(2, 40, 64, 64, generator=gen) * 0.5
    got = rwkv6_scan(*(a.cuda() for a in (r, k, v, logw, u, s0)))
    want = rwkv6_scan(r, k, v, logw, u, s0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.cpu(), w, rtol=1e-4, atol=1e-4)

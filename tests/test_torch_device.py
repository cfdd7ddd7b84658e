"""The device rule: the port runs on the CUDA card unless asked for the CPU.

Entry points default to ``device="cuda"`` and raise without a card; a
kernel wrapper handed a CUDA request on a machine without CUDA raises
rather than fall back to its plain version. The tests marked ``gpu`` need
the card (they run on the H100 through ``chip_smoke.py``'s build) and skip
here.
"""
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
    the build sources are the three .cu files of the main path."""
    assert not _build._libs
    assert _build.SOURCES == ("lbgm_projection", "lbgm_sparse_decision",
                              "lbgm_dequant_accum")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert json.dumps(sorted(_build.LAUNCHES)) == json.dumps(
        ["lbgm_dequant_accum", "lbgm_projection", "lbgm_sparse_decision",
         "lbgm_sparse_decision_two_pass"])


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

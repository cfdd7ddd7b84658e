"""The paper's compressor stacks, both packages (fig. 7-style).

The parity harness of ``tests/test_torch_codec_engine.py`` (same spec,
same initial params, 5 rounds; exact uplink and byte fields, loss rtol
1e-5, params rtol 1e-4 / atol 1e-6, sin^2 margin > 1e-5, at least one
recycle round) over the dense store with top-K 0.1 and error feedback
(delta 0.75; delta 0.8 in the padded, sampled chunked case, which at 0.75
never recycles), top-K without it, ATOMO rank 2 and SignSGD (delta 0.5).
The error-feedback residual banks must agree like the params. Then a
fig. 7-style spec file through both packages' CLIs.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and spinning
# OpenMP threads would starve the other workers' threads
torch.set_num_threads(1)

from repro.fed import experiment as jexp  # noqa: E402
from test_torch_codec_engine import parity_run  # noqa: E402

TOPK_EF = {"compressor": "topk", "compressor_kw": {"k_frac": 0.1},
           "error_feedback": True, "delta_threshold": 0.75}

STACKS = {
    "vmap-dense-topk-ef": dict(TOPK_EF),
    "chunked-dense-topk-ef-pad-sampled": dict(
        TOPK_EF, num_clients=7, scheduler="chunked", chunk_size=4,
        sample_frac=0.6, delta_threshold=0.8),
    "chunked-dense-topk-no-ef": dict(
        TOPK_EF, error_feedback=False, delta_threshold=0.5,
        scheduler="chunked", chunk_size=5),
    "vmap-dense-atomo": dict(compressor="atomo", compressor_kw={"rank": 2},
                             delta_threshold=0.5),
    "vmap-dense-signsgd": dict(compressor="signsgd", delta_threshold=0.5),
}


@pytest.mark.parametrize("case", sorted(STACKS))
def test_compressor_stack_parity(case):
    parity_run(case, STACKS[case])


def test_fig7_spec_through_both_clis(tmp_path, monkeypatch):
    """A fig. 7-style spec file (benchmarks/fig7_plugplay.py's top-K + EF
    stack with LBGM) with ``--set fl.compressor=topk`` through both CLIs'
    ``main``. The port's CLI is handed the JAX package's initial params
    (its own model init draws from a torch.Generator)."""
    from benchmarks.common import build_spec
    from repro.fed import run as jrun
    from repro_torch.fed import run as trun
    spec = build_spec(name="fig7_topk_ef+lbgm", use_lbgm=True,
                      delta_threshold=0.75, error_feedback=True,
                      noniid=True)
    path = tmp_path / "fig7.json"
    path.write_text(spec.to_json())
    argv = ["--spec", str(path), "--set", "fl.compressor=topk",
            "--rounds", "3"]
    jeng, _ = jexp.build_experiment(spec)
    p0 = {k: np.asarray(v) for k, v in jeng.params.items()}
    real = trun.run_experiment
    monkeypatch.setattr(trun, "run_experiment",
                        lambda s, device, **kw: real(s, device=device,
                                                     params=p0, **kw))
    assert jrun.main(argv + ["--out", str(tmp_path / "j.json")]) == 0
    assert trun.main(argv + ["--device", "cpu",
                             "--out", str(tmp_path / "t.json")]) == 0
    jrec = json.loads((tmp_path / "j.json").read_text())
    trec = json.loads((tmp_path / "t.json").read_text())
    assert trec["spec"]["fl"]["compressor"] == "topk"
    assert trec["spec"] == jrec["spec"]
    assert len(trec["records"]) == len(jrec["records"]) == 3
    for a, b in zip(jrec["records"], trec["records"]):
        for k in ("uplink_floats", "frac_scalar", "wire_bytes",
                  "total_uplink", "total_wire_bytes"):
            assert a[k] == b[k], (k, a[k], b[k])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    np.testing.assert_allclose(trec["final_eval"]["test_loss"],
                               jrec["final_eval"]["test_loss"], rtol=1e-4)

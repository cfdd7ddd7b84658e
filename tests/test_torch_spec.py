"""One spec file drives either package; keys the port lacks are refused.

An ``ExperimentSpec`` JSON round-trips in both packages to equal
``FLConfig`` dicts; the ported keys (codecs, compressors, robust rules,
attacks, the buffered scheduler and its latency models, dropout) are
accepted with the same JSON form (and the tiers, checkpoint and
``"topk-host"`` keys, with ``examples/specs/hier_100k.json``, and the
``"sharded"`` scheduler with ``"topk-sharded"``, with
``examples/specs/yi34b_mesh2x4.json``), and the port's ``FLConfig``
rejects every registry key and knob it has not ported with the
reference's "unknown ...; registered: [...]" error, instead of running
something else (``model_sharding="auto"`` is accepted; the engine refuses
the model families it has no tensor-parallel form for, by name).
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and spinning
# OpenMP threads would starve the other workers' threads
torch.set_num_threads(1)

from repro.fed import experiment as jexp  # noqa: E402
from repro.fed.flconfig import FLConfig as JFL  # noqa: E402
from repro_torch.fed import experiment as texp  # noqa: E402
from repro_torch.fed.flconfig import FLConfig as TFL  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

SPEC = {
    "name": "roundtrip",
    "model": {"name": "cnn", "kw": {"arch": "paper-cnn"}},
    "data": {"name": "mixture", "kw": {"n": 300, "n_eval": 50}},
    "partition": {"name": "iid", "kw": {"seed": 3}},
    "fl": {"num_clients": 8, "tau": 3, "lr": 0.1, "batch_size": 4,
           "delta_threshold": 0.3, "scheduler": "chunked", "chunk_size": 3,
           "lbg_variant": "topk", "lbg_kw": {"k_frac": 0.05},
           "sample_frac": 0.75, "fused_kernels": False, "seed": 5,
           "mesh": None, "aggregator": "mean", "codec": "none"},
    "rounds": 7,
    "eval": {"every": 2, "final": True, "verbose": False},
}


def test_spec_json_roundtrips_in_both_packages():
    text = json.dumps(SPEC)
    js = jexp.ExperimentSpec.from_json(text)
    ts = texp.ExperimentSpec.from_json(text)
    assert js.fl.to_dict() == ts.fl.to_dict()
    assert js.to_dict() == ts.to_dict()
    assert json.loads(ts.to_json()) == json.loads(js.to_json())
    assert texp.ExperimentSpec.from_json(js.to_json()) == ts
    over = {"fl.delta_threshold": 0.5, "model.kw.d_model": 16}
    assert (js.with_overrides(over).to_dict()
            == ts.with_overrides(over).to_dict())


def test_flconfig_fields_and_defaults_match():
    assert TFL().to_dict() == JFL().to_dict()
    for bad in (dict(num_clients=0), dict(sample_frac=0.0),
                dict(chunk_size=0), dict(fused_kernels=1),
                dict(mesh=[2, 2]), dict(attack_frac=0.5)):
        for cls in (TFL, JFL):
            with pytest.raises(ValueError):
                cls(**bad)


@pytest.mark.parametrize("kw,word", [
    (dict(scheduler="sharded"), None),
    (dict(lbg_variant="topk-sharded"), None),
    (dict(scheduler="sharded", mesh=[1, 1], model_sharding="auto"), None),
])
def test_unported_keys_raise(kw, word):
    """The sharded scheduler and store, and ``model_sharding="auto"``,
    are ported: both packages accept them with the same JSON form."""
    j = JFL(**kw)  # valid in the reference
    if word is None:
        t = TFL(**kw)
        assert j.to_dict() == t.to_dict()
        assert TFL.from_dict(json.loads(json.dumps(t.to_dict()))) == t
        return
    with pytest.raises(ValueError, match=word):
        TFL(**kw)


@pytest.mark.parametrize("kw", [
    dict(aggregator="trimmed_mean"),
    dict(aggregator="geometric_median"),
    dict(aggregator="coordinate_median"),
    dict(aggregator="scalar_median", lbg_variant="topk"),
    dict(aggregator="trimmed_mean", aggregator_kw={"beta": 0.1}),
    dict(attack="gaussian", attack_frac=0.2),
    dict(attack="colluding_sign", attack_frac=0.2),
    dict(attack="sign_flip", attack_frac=0.2),
    dict(scheduler="buffered", lbg_variant="topk"),
    dict(latency="fixed", scheduler="buffered", lbg_variant="topk"),
    dict(dropout_frac=0.1),
    dict(lbg_variant="topk-host", scheduler="chunked"),
    dict(tiers=[2]),
    dict(ckpt_every=2, ckpt_path="x.npz"),
])
def test_ported_robust_attack_buffered_keys_accepted(kw):
    """The robust rules, the attacks, the buffered scheduler with its
    latency models and dropout, the ``"topk-host"`` store, tiers and
    checkpoints are ported: both packages accept them with the same JSON
    form."""
    j, t = JFL(**kw), TFL(**kw)
    assert j.to_dict() == t.to_dict()
    assert TFL.from_dict(json.loads(json.dumps(t.to_dict()))) == t


@pytest.mark.parametrize("name", ["hier_100k", "quantized_lbgm",
                                  "async_buffered", "robust_signflip_gm",
                                  "yi34b_mesh2x4"])
def test_example_spec_loads_and_roundtrips(name):
    """An example spec loads in both packages to the same dict, and the
    port's JSON form loads back to an equal spec."""
    path = Path(__file__).resolve().parents[1] / "examples" / "specs" / \
        f"{name}.json"
    js, ts = jexp.ExperimentSpec.load(str(path)), \
        texp.ExperimentSpec.load(str(path))
    assert js.to_dict() == ts.to_dict()
    assert texp.ExperimentSpec.from_json(ts.to_json()) == ts


def test_tensor_parallel_spec_is_refused():
    """examples/specs/yi34b_tp2x4.json (model_sharding="auto") loads in
    both packages to the same dict; its parity run on 8 ranks is
    ``test_torch_sharded_ranks.py::test_yi34b_tp2x4_spec_matches_jax``.
    What the port has no tensor-parallel form for is refused by name,
    not run as something else: the spec with the encoder-decoder
    whisper-base fails at engine build, naming the arch and the cause the
    JAX package shares (the "lm" component's batches carry no encoder
    frames); with rwkv6-3b, mixtral-8x22b and qwen2-vl-2b it builds."""
    path = ROOT / "examples" / "specs" / "yi34b_tp2x4.json"
    js, ts = jexp.ExperimentSpec.load(str(path)), \
        texp.ExperimentSpec.load(str(path))
    assert ts.fl.model_sharding == "auto"
    assert js.to_dict() == ts.to_dict()

    def at(arch):
        return ts.with_overrides({"fl.mesh": [1, 1], "model.kw": {
            "arch": arch, "reduced": True, "n_layers": 2},
            "data.kw.vocab": 512})
    with pytest.raises(ValueError,
                       match="whisper-base.*encoder frames.*carry none"):
        texp.build_experiment(at("whisper-base"), device="cpu")
    for arch in ("rwkv6-3b", "mixtral-8x22b", "qwen2-vl-2b"):
        eng, _ = texp.build_experiment(at(arch), device="cpu")
        assert eng._tp is not None


@pytest.mark.parametrize("kw", [
    dict(codec="int8"), dict(codec="fp8", codec_kw={"stochastic": False}),
    dict(codec="delta_idx"), dict(compressor="topk"),
    dict(compressor="topk", compressor_kw={"k_frac": 0.2},
         error_feedback=False),
    dict(compressor="signsgd", error_feedback=True),
    dict(compressor="atomo", compressor_kw={"rank": 3, "method": "power"}),
])
def test_ported_codec_and_compressor_keys_accepted(kw):
    """The codecs and compressor stacks are ported: both packages accept
    them with the same JSON form."""
    j, t = JFL(**kw), TFL(**kw)
    assert j.to_dict() == t.to_dict()
    assert TFL.from_dict(json.loads(json.dumps(t.to_dict()))) == t


def test_codec_kw_errors_match_the_reference():
    for cls in (TFL, JFL):
        with pytest.raises(ValueError, match="codec_kw keys"):
            cls(codec="int8", codec_kw={"bogus": 1})
        with pytest.raises(ValueError, match="unknown codec"):
            cls(codec="zstd")


def test_cli_prints_and_runs_on_cpu(tmp_path):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(dict(
        SPEC, model={"name": "fcn", "kw": {}}, rounds=2,
        fl=dict(SPEC["fl"], num_clients=4))))
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.fed.run", "--spec", str(spec),
         "--set", "fl.delta_threshold=0.4", "--print-spec"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    printed = json.loads(out.stdout)
    assert printed["fl"]["delta_threshold"] == 0.4
    res = tmp_path / "res.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.fed.run", "--spec", str(spec),
         "--device", "cpu", "--out", str(res)],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    assert "2 rounds on cpu" in out.stdout
    assert len(json.loads(res.read_text())["records"]) == 2

"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value.split(".")[0]


def test_scan_covers_the_port():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    port = "src/repro_torch/"
    assert {port + f for f in (
        "fed/engine.py", "core/lbgm.py", "kernels/ops.py",
        "kernels/lbgm_sparse.py", "comm/wire.py", "compression/__init__.py",
        "compression/topk.py", "compression/signsgd.py",
        "compression/atomo.py", "compression/error_feedback.py",
        "configs/qwen3_1_7b.py", "configs/rwkv6_3b.py",
        "kernels/flash_attention.py", "kernels/rwkv6_scan.py",
        "models/attention.py", "models/rwkv6.py", "models/transformer.py",
        "serve/decode.py", "train/trainer.py", "launch/serve.py",
        "core/device.py", "core/jax_prng.py", "launch/train.py",
        "checkpoint/ckpt.py", "optim/sgd.py", "data/synthetic.py",
        "optim/adam.py", "optim/schedules.py", "fed/robust.py",
        "fed/attacks.py", "fed/latency.py", "fed/hierarchy.py",
        "models/moe.py", "models/rglru.py", "models/frontends.py",
        "analysis/__init__.py", "analysis/pca.py", "configs/yi_34b.py",
        "configs/deepseek_67b.py", "configs/mistral_large_123b.py",
        "configs/mixtral_8x22b.py", "configs/llama4_maverick_400b_a17b.py",
        "configs/recurrentgemma_2b.py", "configs/qwen2_vl_2b.py",
        "configs/whisper_base.py", "launch/specs.py", "launch/dryrun.py",
        "analysis/roofline.py", "launch/mesh.py", "core/lbgm_sharded.py")} \
        | {"chip_smoke.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_entry_points_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.fed.experiment, repro_torch.fed.run, "
            "repro_torch.fed.engine, repro_torch.kernels.ops, "
            "repro_torch.comm.wire, repro_torch.compression.atomo, "
            "repro_torch.compression.error_feedback, "
            "repro_torch.compression.signsgd, repro_torch.compression.topk, "
            "repro_torch.launch.serve, repro_torch.serve.decode, "
            "repro_torch.train.trainer, repro_torch.models.transformer, "
            "repro_torch.configs.qwen3_1_7b, repro_torch.configs.rwkv6_3b, "
            "repro_torch.fed.robust, repro_torch.fed.attacks, "
            "repro_torch.fed.latency, repro_torch.fed.hierarchy, "
            "repro_torch.optim, repro_torch.models.moe, "
            "repro_torch.models.rglru, repro_torch.models.frontends, "
            "repro_torch.analysis.pca, repro_torch.analysis.roofline, "
            "repro_torch.launch.specs, repro_torch.launch.dryrun, "
            "repro_torch.launch.mesh, repro_torch.core.lbgm_sharded\n"
            "from repro_torch.configs import all_configs; all_configs()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_importing_the_mesh_modules_starts_no_process_group():
    """``launch.mesh`` and ``core.lbgm_sharded`` (and the engine that
    imports them) start no process group and touch no card on import:
    the mesh is made by a function."""
    code = ("import sys, torch.distributed as dist, repro_torch.launch.mesh, "
            "repro_torch.core.lbgm_sharded, repro_torch.fed.engine\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "up = dist.is_available() and dist.is_initialized()\n"
            "print(bad, up); sys.exit(1 if bad or up else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_importing_the_train_driver_loads_neither_jax_nor_repro():
    """``python -m repro_torch.launch.train`` and what it imports (the
    trainer, the optimizer, the checkpoints) stay free of the JAX package,
    and of the federated engine."""
    code = ("import sys, repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro') or m == 'repro_torch.fed.engine')\n"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_lm_serving_path_does_not_load_the_fl_engine():
    """The model and serving layers sit below the federated engine: they
    take the device rule from ``core.device``, not from ``fed.engine``."""
    code = ("import sys, repro_torch.launch.serve, repro_torch.train.trainer\n"
            "bad = sorted(m for m in sys.modules if m in "
            "('repro_torch.fed.engine', 'repro_torch.fed.experiment'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

"""The ``model_sharding="auto"`` phase of ``chip_smoke.py`` alone, on one
card.

    python3 scripts/chip_auto_readings.py

Builds the kernels and runs ``fl_sharded_auto_card``: qwen3-1.7b's FL-LM
top-k int8 spec of ``fl_sharded_qwen3_topk``, cut to ``AUTO_DEPTH``
layers, on the ``(1, 1)`` sharded mesh in this process, then on the
``(1, 2)`` mesh with ``model_sharding="auto"`` (2 gloo ranks on the card,
each resting half the params and running the client forward and backward
tensor-parallel), held against the first. Prints ``chip_smoke.py``'s JSON
records, after the card's name and power limit. Needs a CUDA card; exits
non-zero without one.
"""
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a "
                "CUDA card")
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.kernels import _build
    cs.T_START = time.perf_counter()
    cs.SMI_LINE = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(cs.SMI_LINE, flush=True)
    _build.build_all()
    cs.emit({"phase": "built"})
    totals = {k: 0 for k in _build.LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:
        cs.fl_sharded_auto_card(totals, tmp)
    cs.emit({"phase": "done",
             "launches": {k: v for k, v in totals.items() if v}})


if __name__ == "__main__":
    main()

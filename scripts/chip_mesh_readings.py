"""The sharded scheduler's phases of ``chip_smoke.py`` alone, on one card.

    python3 scripts/chip_mesh_readings.py

Builds the kernels, runs ``fl_sharded_mesh_card`` (the ``(2, 2)`` and
``(1, 2)`` gloo worlds on the card, each with the paper cohort, the
d_model-704 FCN and the CLI), then qwen3-1.7b's FL-LM top-k int8 spec
three times in a row: on the chunked scheduler, on the ``(1, 1)`` sharded
mesh (held bit for bit against the first), and on the chunked scheduler
again. With nothing else on the card or the host, the three round times
read the sharded scheduler's own cost beside the chunked one's. Prints
``chip_smoke.py``'s JSON records, after the card's name and power limit.
Needs a CUDA card; exits non-zero without one.
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    _build.build_all()
    cs.emit({"phase": "built"})
    totals = {k: 0 for k in _build.LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:
        cs.fl_sharded_mesh_card(totals, tmp)
    kw = {"fl.chunk_size": 2, "fl.codec": "int8", "rounds": 2}
    inmem, state = cs.fl_lm_topk("fl_lm_qwen3_topk_int8", "qwen3-1.7b",
                                 keep_state=True, **kw)
    cs.fl_sharded_qwen3_topk(totals, inmem, state)
    del inmem, state
    cs.fl_lm_topk("fl_lm_qwen3_topk_int8_again", "qwen3-1.7b", **kw)
    cs.emit({"phase": "done",
             "launches": {k: v for k, v in totals.items() if v}})


if __name__ == "__main__":
    main()

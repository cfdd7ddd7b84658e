"""The ``model_sharding="auto"`` phases of ``chip_smoke.py`` alone, on one
card.

    python3 scripts/chip_auto_readings.py [--arch ARCH [ARCH ...]]

Builds the kernels and runs an auto phase. By default (``--arch
qwen3-1.7b``) ``fl_sharded_auto_card``: qwen3-1.7b's FL-LM top-k int8 spec
of ``fl_sharded_qwen3_topk``, cut to ``AUTO_DEPTH`` layers, on the
``(1, 1)`` sharded mesh in this process, then on the ``(1, 2)`` mesh with
``model_sharding="auto"`` (2 gloo ranks on the card, each resting half
the params and running the client forward and backward tensor-parallel),
held against the first. ``--arch rwkv6-3b recurrentgemma-2b
mixtral-8x22b qwen2-vl-2b`` (any of them) runs
``fl_sharded_auto_recurrent_card``, ``fl_sharded_auto_moe_card`` and
``fl_sharded_auto_vlm_card`` instead: the same spec for each named arch
at its ``AUTO_RECURRENT``, ``AUTO_MOE`` or ``AUTO_VLM`` depth and seq_len
(and mixtral's ``AUTO_CLIENTS``), the ranks running one arch after the
other in that order, as in ``chip_smoke.py``. Prints ``chip_smoke.py``'s JSON
records, after the card's name and power limit, and then the kernels
line's new records. Needs a CUDA card; exits non-zero without one.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

ARMS = {arch: (arch, depth, T)
        for arch, depth, T in cs.AUTO_RECURRENT + cs.AUTO_MOE + cs.AUTO_VLM}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=["qwen3-1.7b"],
                    choices=["qwen3-1.7b", *ARMS],
                    help="qwen3-1.7b alone (fl_sharded_auto_card), or "
                         "recurrent, MoE and VLM archs "
                         "(fl_sharded_auto_recurrent_card, "
                         "fl_sharded_auto_moe_card, "
                         "fl_sharded_auto_vlm_card)")
    args = ap.parse_args(argv)
    if "qwen3-1.7b" in args.arch and len(args.arch) > 1:
        ap.error("qwen3-1.7b runs alone: its phase is another than the "
                 "recurrent, MoE and VLM archs'")
    return args


def main(argv=None):
    args = parse_args(argv)
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
        if args.arch == ["qwen3-1.7b"]:
            recs, _ = cs.fl_sharded_auto_card(totals, tmp)
        else:
            run = cs.fl_sharded_auto_start(
                tmp, [ARMS[a] for a in ARMS if a in args.arch],
                "fl_sharded_auto_recurrent_card")
            recs, _ = cs.fl_sharded_auto_finish(totals, run)
    print(json.dumps({"auto_kernels": recs}), flush=True)
    cs.emit({"phase": "done",
             "launches": {k: v for k, v in totals.items() if v}})


if __name__ == "__main__":
    main()

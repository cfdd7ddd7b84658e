"""CLI entry point for the port's declarative experiment API.

    PYTHONPATH=src python -m repro_torch.fed.run --spec spec.json \
        --set fl.delta_threshold=0.4 --set model.name=cnn --rounds 20

The same spec files and ``--set`` overrides as ``python -m repro.fed.run``,
and its ``--resume`` (continue from the checkpoint at ``fl.ckpt_path``).
Without ``--spec`` a small built-in spec runs (4-client FCN on the mixture
dataset); ``--print-spec`` dumps the resolved spec as JSON without
running. It runs on the CUDA card; ``--device cpu`` runs on the CPU
instead (without a card and without that flag it exits with an error).

A spec on the ``"sharded"`` scheduler runs on a ``(clients, model)`` mesh of
ranks (``fl.mesh``); launch one process per rank with ``torchrun``:

    torchrun --nproc-per-node 4 -m repro_torch.fed.run \
        --spec examples/specs/yi34b_mesh2x4.json --set 'fl.mesh=[2,2]' \
        --device cpu

(gloo on the CPU; on the card NCCL with a card per rank, gloo when ranks
share a card). Every rank runs the experiment and holds the same history;
rank 0 alone prints, writes ``--out`` and the checkpoints. A sharded spec
whose mesh is ``(1, 1)`` needs no launcher. A spec with
``model_sharding="auto"`` trains the dense, M-RoPE VLM, recurrent and
MoE ``"lm"`` families tensor-parallel over the mesh's model ranks, each
resting its shards:

    torchrun --nproc-per-node 8 -m repro_torch.fed.run \
        --spec examples/specs/yi34b_tp2x4.json --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from repro_torch.fed.experiment import (ComponentSpec, EvalPolicy,
                                        ExperimentSpec, run_experiment)
from repro_torch.fed.flconfig import FLConfig
from repro_torch.launch.mesh import is_writer, shutdown


def default_spec() -> ExperimentSpec:
    """Tiny 4-client FCN experiment: fast enough for smoke runs."""
    return ExperimentSpec(
        name="quick-fcn",
        model=ComponentSpec("fcn"),
        data=ComponentSpec("mixture", {"n": 400, "n_eval": 200}),
        partition=ComponentSpec("label_skew", {"classes_per_client": 3}),
        fl=FLConfig(num_clients=4, tau=2, lr=0.05, batch_size=16,
                    use_lbgm=True, delta_threshold=0.2),
        rounds=10,
        eval=EvalPolicy(every=5, final=True, verbose=True),
    )


def parse_set(kvs) -> dict:
    """``["a.b=1", "c=x"]`` -> ``{"a.b": 1, "c": "x"}`` (JSON-ish values)."""
    out = {}
    for kv in kvs or ():
        if "=" not in kv:
            raise SystemExit(f"--set expects key=value, got {kv!r}")
        key, _, raw = kv.partition("=")
        try:
            out[key] = json.loads(raw)
        except json.JSONDecodeError:
            out[key] = raw
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fed.run",
        description="Run one declarative FL experiment from a spec.")
    ap.add_argument("--spec", default=None,
                    help="path to an ExperimentSpec JSON file "
                         "(default: built-in quick-fcn spec)")
    ap.add_argument("--set", dest="sets", action="append", metavar="KEY=VAL",
                    help="dotted-key spec override, repeatable "
                         "(e.g. --set fl.delta_threshold=0.4)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="override the spec's round count")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; needs a card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="write the full result (records + spec) as JSON")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the resolved spec as JSON and exit")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint at fl.ckpt_path "
                         "(requires fl.ckpt_every/fl.ckpt_path in the "
                         "spec); the completed history is bit-for-bit "
                         "the uninterrupted run's")
    args = ap.parse_args(argv)

    spec = (ExperimentSpec.load(args.spec) if args.spec else default_spec())
    overrides = parse_set(args.sets)
    if overrides:
        spec = spec.with_overrides(overrides)
    if args.rounds is not None:
        spec = spec.with_overrides({"rounds": args.rounds})
    if args.print_spec:
        print(spec.to_json())
        return 0

    try:
        result = run_experiment(spec, device=args.device,
                                resume=args.resume)
        writer = is_writer()
    finally:
        if "WORLD_SIZE" in os.environ:
            # the launcher's ranks leave together
            shutdown()
    if not writer:
        return 0
    last = result.records[-1]
    print(f"[{spec.name}] {result.rounds} rounds on {result.device} in "
          f"{result.duration_s:.2f}s "
          f"({result.us_per_round / 1e3:.1f} ms/round)")
    print(f"  loss={last.loss:.4f} frac_scalar={last.frac_scalar:.2f} "
          f"uplink={result.total_uplink:.3g} floats "
          f"savings={result.savings:.1%}")
    print(f"  wire={last.total_wire_bytes:.3g} bytes "
          f"(codec={spec.fl.codec}) wire_savings={last.wire_savings:.1%}")
    if result.final_eval:
        print("  " + " ".join(f"{k}={v:.4f}"
                              for k, v in sorted(result.final_eval.items())))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result.to_dict(), f, indent=2)
        print(f"  result written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One-card dry run: every (arch x input shape) pair counted on the meta
device, with its roofline terms against one H100. The counterpart of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--no-lbgm] \
        [--out DIR]

It has no ``--multi-pod``, ``--both-meshes`` or ``--unroll``: those need a
mesh or XLA's cost pass; the mesh form waits for the multi-GPU slice.

Each pair builds its state from ``launch.specs`` on the meta device (no
storage, no draw) and runs its step there under
``torch.utils.flop_counter.FlopCounterMode``: the training step's client
gradient (the config's own ``dp_mode``; K from ``effective_clients`` on one
device), ``prefill_logits``, or ``serve_step``. On meta tensors the LM
kernels' wrappers take their plain versions, as on the CPU: flash's
forward counts every score of its T x T product, the masked ones
included; the backwards are the port's own (flash's recomputes scores
per block of 1024 query rows over the keys in the band, the scan's
recomputes its forward). The LBGM decision and the server fold are data
dependent and do not run on meta: they are counted from shapes, by the
formulas each row's ``notes`` state. Bytes are the step's arguments
(params, train or decode state, batch) read once. Nothing here needs a
card.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline as rl
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES,
                                 active_param_count, get_config)
from repro_torch.core.lbgm import topk_count
from repro_torch.launch import specs as sp
from repro_torch.models.transformer import prefill_logits
from repro_torch.serve.decode import serve_step
from repro_torch.train import trainer as tr

MESH = "h100x1"


def should_skip(cfg, shape_cfg):
    if shape_cfg.name == "long_500k" and cfg.long_context == "skip":
        return (f"{cfg.name}: long_500k skipped — enc-dec decoder context "
                "architecturally capped (DESIGN.md §4)")
    return None


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict (ints and Nones count 0)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return 0


def lbgm_flops(cfg, params, K: int, use_lbgm: bool):
    """(flops, note) of the step's data-dependent part, from shapes: per
    client, the decision (dense store: <g,l>, ||g||², ||l||² at 2 n each;
    top-k store: ||g||² at 2 n and <g,l> over the k kept entries at 2 k;
    the selection's comparisons are not flops), the reconstruction
    (rho * LBG, n, counted as if the client recycled) and the fold into
    the fp32 accumulator (n); then the server's 1/K (n) and the SGD update
    (2 n)."""
    n = sum(p.numel() for p in params.values())
    if not (use_lbgm and cfg.lbgm.enabled):
        per, what = n, "fold n"
    elif cfg.lbgm.variant == "topk":
        k = sum(topk_count(p.numel(), cfg.lbgm.k_frac)
                for p in params.values())
        per, what = 2 * n + 2 * k + n + n, ("decision 2n + 2k (top-k), "
                                            "reconstruction n, fold n")
    else:
        per, what = 6 * n + n + n, ("decision 6n (dense), reconstruction "
                                    "n, fold n")
    return (K * per + 3 * n,
            f"LBGM counted from shapes: per client {what}; server 1/K n "
            f"and SGD 2n (n = {n} params, K = {K})")


def lower_pair(arch: str, shape_name: str, use_lbgm: bool = True,
               lr: float = 1e-2, cfg_override=None):
    """One JSON row: ``RooflineReport.row()`` plus the step's argument
    bytes, ``hbm_per_device_gb``, ``fits_one_card`` and ``status``."""
    cfg = cfg_override or get_config(arch)
    shape_cfg = INPUT_SHAPES[shape_name]
    skip = should_skip(cfg, shape_cfg)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": MESH,
                "status": "skipped", "reason": skip}
    t0 = time.time()
    notes = ["flash's forward counted as its plain version: every score "
             "of the T x T product, the masked ones included"]
    extra = 0
    counter = FlopCounterMode(display=False)
    if shape_cfg.kind == "train":
        K = tr.effective_clients(cfg, 1, shape_cfg.global_batch)
        state, _ = sp.abstract_train_state(cfg, K, use_lbgm)
        batch = sp.train_batch_specs(cfg, shape_cfg, K)
        params = state["params"]
        tau = cfg.lbgm.local_steps if cfg.dp_mode == "replicated" else 1
        with counter:
            tr._client_asg(tr.make_loss_fn(cfg), params,
                           {k: v[0] for k, v in batch.items()}, tau, lr)
        flops = K * counter.get_total_flops()
        more, note = lbgm_flops(cfg, params, K, use_lbgm)
        flops += more
        notes += [f"one client's gradient counted on meta, times K = {K}",
                  "the backwards counted as the port runs them: flash's "
                  "recomputes scores per block of 1024 query rows over "
                  "the keys in the band (5 products), the scan's "
                  "recomputes its forward", note]
        args = tensor_bytes(state) + tensor_bytes(batch)
        # one client's gradient and the fp32 accumulator live beside them
        extra = tensor_bytes(params) + 4 * sum(p.numel()
                                               for p in params.values())
        notes.append("hbm: arguments, one client's gradient and the fp32 "
                     "accumulator; activations not counted")
    elif shape_cfg.kind == "prefill":
        params, _ = sp.abstract_params(cfg)
        batch = sp.prefill_batch_specs(cfg, shape_cfg)
        with counter, torch.no_grad():
            prefill_logits(params, cfg, batch["tokens"], batch.get("extra"))
        flops = counter.get_total_flops()
        args = tensor_bytes(params) + tensor_bytes(batch)
        notes.append("hbm: arguments; activations not counted")
    else:  # decode
        params, _ = sp.abstract_params(cfg)
        state, _ = sp.abstract_decode_state(cfg, shape_cfg.global_batch,
                                            shape_cfg.seq_len)
        tok = sp.decode_token_spec(shape_cfg)
        with counter, torch.no_grad():
            serve_step(params, cfg, state, tok)
        flops = counter.get_total_flops()
        args = tensor_bytes(params) + tensor_bytes(state) + tok.numel() * 4
        notes.append("hbm: arguments (params and caches); activations not "
                     "counted")
    mf = rl.model_flops(cfg, shape_cfg, active_param_count(cfg))
    report = rl.build_report(arch, shape_name, MESH, 1,
                             {"flops": float(flops),
                              "bytes accessed": float(args)}, [], mf)
    row = report.row()
    hbm = args + extra
    row.update(status="ok", count_s=time.time() - t0, arg_bytes=args,
               collectives=rl.collective_bytes([]),
               hbm_per_device_gb=hbm / 2 ** 30,
               fits_one_card=hbm <= rl.HBM_BYTES, notes=notes)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-lbgm", action="store_true",
                    help="vanilla-FL baseline step (no LBGM state)")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    out_dir = os.path.join(args.out, MESH)
    os.makedirs(out_dir, exist_ok=True)
    failures, rows = [], []
    for arch in archs:
        for shape in shapes:
            tag = f"{MESH}/{arch}__{shape}"
            print(f"=== {tag} ===", flush=True)
            try:
                row = lower_pair(arch, shape, use_lbgm=not args.no_lbgm)
            except Exception:
                traceback.print_exc()
                row = {"arch": arch, "shape": shape, "mesh": MESH,
                       "status": "FAILED",
                       "error": traceback.format_exc(limit=4)}
                failures.append(tag)
            suffix = "__vanilla" if args.no_lbgm else ""
            with open(os.path.join(out_dir, f"{arch}__{shape}{suffix}.json"),
                      "w") as f:
                json.dump(row, f, indent=1, default=str)
            rows.append(row)
            if row["status"] == "ok":
                print(f"  ok dominant={row['dominant']} "
                      f"terms=({row['compute_s']:.4f}, "
                      f"{row['memory_s']:.4f}, "
                      f"{row['collective_s']:.4f})s "
                      f"useful={row['useful_flops_ratio']:.3f} "
                      f"hbm={row['hbm_per_device_gb']:.1f}GiB "
                      f"fits_one_card={row['fits_one_card']}", flush=True)
            elif row["status"] == "skipped":
                print("  skipped:", row["reason"], flush=True)
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print(f"dry-run complete: {len(rows)} pairs counted")
    return rows


if __name__ == "__main__":
    main()

"""End-to-end training driver of the port.

Runs the LBGM trainer on synthetic-markov data on the card (the default)
or, when asked, on the CPU. Checkpoint and metrics under --out.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --steps 100 --seq 256 --batch 8 --clients 4 [--device cpu]

The flags of ``python -m repro.launch.train``, plus ``--device`` (``cuda``
by default: without a card it raises) and ``--init`` (start from the
params of a checkpoint written by either package). Without ``--init`` the
weights are drawn from ``--seed`` by a generator on the device, so the card
and the CPU draw different weights from one seed. The data stream
(``markov_lm``, the clients' batch draws) is the JAX driver's, draw for
draw. An arch that takes stub embeddings (whisper's encoder frames,
qwen2-vl's patches) gets one stub of ``--batch`` rows, drawn once by
``models.frontends.make_stub_embeds`` on the run's device (a generator of
``--seed`` + 1) and given to every client of every step, as the JAX
driver does (torch's draws, not JAX's). Like the JAX driver it forces
``dp_mode="replicated"``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import markov_lm
from repro_torch.models.frontends import make_stub_embeds
from repro_torch.train import trainer as tr


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer reduced variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8, help="per-client batch")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--delta", type=float, default=None,
                    help="LBGM sin^2 threshold (default: config)")
    ap.add_argument("--no-lbgm", action="store_true")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M model)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--pool", type=int, default=8,
                    help="batches of local data per client (small pool = "
                         "paper-like FL regime with recurring local epochs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="experiments/train")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; needs a card) or 'cpu'")
    ap.add_argument("--init", default=None,
                    help="start from the params of this checkpoint")
    return ap.parse_args(argv)


def train_config(args):
    """The arch config the flags ask for (the JAX driver's overrides)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    over = {}
    if args.d_model:
        n_kv = max(2, args.d_model // 128)
        n_q = max(n_kv, (args.d_model // 64) // n_kv * n_kv)  # divisible GQA
        over.update(d_model=args.d_model, n_heads=n_q, head_dim=64,
                    n_kv_heads=n_kv, d_ff=args.d_model * 3)
    if args.layers:
        over["n_layers"] = args.layers
    if args.vocab:
        over["vocab_size"] = args.vocab
    if over:
        cfg = dataclasses.replace(cfg, **over)
    return dataclasses.replace(cfg, dp_mode="replicated")


def client_batches(args, vocab: int, device, extra=None):
    """The JAX driver's batch stream: a markov-chain LM stream split iid
    across clients, each step every client draws ``--batch`` sequences of
    its pool. Yields {"tokens", "labels"}, each (K, b, T) on ``device``,
    and ``"extra"``: the stub ``extra`` (b, S, d) broadcast over the K
    clients, where one is given."""
    K = args.clients
    toks, labels = markov_lm(K * args.batch * args.pool, args.seq, vocab,
                             seed=args.seed)
    toks = toks.reshape(K, -1, args.seq)
    labels = labels.reshape(K, -1, args.seq)
    rng = np.random.RandomState(args.seed)
    while True:
        idx = rng.randint(0, toks.shape[1], size=(K, args.batch))
        batch = {n: torch.from_numpy(np.take_along_axis(
                     a, idx[..., None], axis=1)).to(device)
                 for n, a in (("tokens", toks), ("labels", labels))}
        if extra is not None:
            batch["extra"] = extra[None].expand((K,) + tuple(extra.shape))
        yield batch


def stub_embeds(args, cfg, device):
    """The run's stub embeddings (None for a text arch): ``--batch`` rows
    drawn once on ``device`` by a generator of ``--seed`` + 1, so that
    they are not the first draws of the weights' generator."""
    return make_stub_embeds(torch.Generator(device=device).manual_seed(
        args.seed + 1), cfg, args.batch)


def main(argv=None):
    args = parse_args(argv)
    cfg = train_config(args)
    dev = resolve_device(args.device)
    K = args.clients
    init = None
    if args.init:
        init = {k: v for k, v in load_checkpoint(args.init)[0]["params"]
                .items()}
    state, _ = tr.init_train_state(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, K,
        use_lbgm=not args.no_lbgm, device=dev, params=init)
    batches = client_batches(args, cfg.vocab_size, dev,
                             stub_embeds(args, cfg, dev))
    n_params = sum(v.numel() for v in state["params"].values())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M clients={K} "
          f"lbgm={'off' if args.no_lbgm else cfg.lbgm.variant}")

    step_fn = tr.make_train_step(cfg, K, args.lr, use_lbgm=not args.no_lbgm,
                                 delta=args.delta)

    os.makedirs(args.out, exist_ok=True)
    history = []
    t0 = time.time()
    uplink = vanilla = 0.0
    for step in range(args.steps):
        state, m = step_fn(state, next(batches))
        m = {k: float(v) for k, v in m.items()}
        uplink += m.get("uplink_floats", 0.0)
        vanilla += m.get("vanilla_uplink_floats", 0.0)
        m["step"] = step
        history.append(m)
        if (step + 1) % args.log_every == 0:
            sav = 1 - uplink / vanilla if vanilla else 0.0
            print(f"step {step+1:5d} loss={m['loss']:.4f} "
                  f"scalar_frac={m.get('frac_scalar', 0):.2f} "
                  f"cum_savings={sav:.1%} "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)", flush=True)

    save_checkpoint(os.path.join(args.out, "final.npz"),
                    {"params": state["params"]},
                    {"arch": cfg.name, "steps": args.steps})
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump(history, f)
    print("done:", args.out)
    return history


if __name__ == "__main__":
    main()

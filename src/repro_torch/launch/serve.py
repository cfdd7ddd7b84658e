"""Serving driver: batched greedy decode with the KV-cache serve_step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

The flags of ``python -m repro.launch.serve``, plus ``--device``: the
card by default (without one it exits with an error), ``cpu`` when asked.
The weights are drawn from ``--seed`` by a generator on that device, so
the card and the CPU draw different weights from one seed. The prompt is
the JAX driver's (``np.random.RandomState(seed)``), and the prompt is
prefilled by repeated decode, as there, which runs the ring cache end to
end. Every arch of ``repro_torch.configs`` serves (``--device cpu
--reduced`` on the CPU, full width on the card where it fits). An
encoder-decoder arch (whisper) decodes against stub frames from
``models.frontends.make_stub_embeds``, drawn from ``--seed`` on the
device and set as ``state["enc_out"]`` as the JAX serve script sets
them: the stub itself, not the encoder's output over it (only prefill
runs the encoder).
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.frontends import make_stub_embeds
from repro_torch.models.transformer import init_lm
from repro_torch.serve.decode import init_decode_state, serve_step


class Generation(NamedTuple):
    tokens: torch.Tensor      # (B, gen) int64 greedy tokens
    logits: torch.Tensor      # (B, gen, V): the logits each token came from
    prefill_s: float          # host seconds of the prompt's decode steps
    decode_s: float           # host seconds of the gen decode steps


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(params, cfg: ArchConfig, prompt, gen: int,
             cache_len: int, enc_out=None) -> Generation:
    """Greedy decode of ``gen`` tokens after the (B, P) ``prompt``, on the
    params' device: the prompt runs through ``serve_step`` one token at a
    time, then each step feeds back the argmax of the last logits (the
    lowest index among equal maxima, as ``jnp.argmax``). An
    encoder-decoder arch needs ``enc_out`` (B, Te, d), which becomes
    ``state["enc_out"]``: the JAX serve script passes the stub frames."""
    device = params["embed"].device
    prompt = torch.as_tensor(np.asarray(prompt), device=device)
    B, P = prompt.shape
    state, _ = init_decode_state(cfg, B, cache_len, device=device)
    if cfg.encdec:
        if enc_out is None:
            raise ValueError(f"{cfg.name} decodes against encoder frames: "
                             f"pass enc_out (B, {cfg.encoder_seq}, "
                             f"{cfg.d_model})")
        state["enc_out"] = enc_out.to(device=device,
                                      dtype=state["enc_out"].dtype)
    _sync(device)
    t0 = time.perf_counter()
    for t in range(P):
        logits, state = serve_step(params, cfg, state, prompt[:, t:t + 1])
    _sync(device)
    t1 = time.perf_counter()
    out, chosen = [], []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for _ in range(gen):
        out.append(tok)
        chosen.append(logits[:, -1])
        logits, state = serve_step(params, cfg, state, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(device)
    t2 = time.perf_counter()
    return Generation(torch.cat(out, dim=1), torch.stack(chosen, dim=1),
                      t1 - t0, t2 - t1)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; needs a card) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params, _ = init_lm(torch.Generator(device=dev).manual_seed(args.seed),
                        cfg, device=dev)
    enc_out = None
    if cfg.encdec:
        enc_out = make_stub_embeds(
            torch.Generator(device=dev).manual_seed(args.seed), cfg,
            args.batch)
    rng = np.random.RandomState(args.seed)
    prompt = rng.randint(0, cfg.vocab_size,
                         size=(args.batch, args.prompt_len)).astype(np.int32)
    res = generate(params, cfg, prompt, args.gen, args.cache_len, enc_out)
    gen = res.tokens.cpu().numpy()
    print("generated tokens:\n", gen)
    print(f"{args.gen} steps x batch {args.batch} on {dev}: "
          f"{1e3 * res.decode_s / args.gen:.1f} ms/step, "
          f"{args.batch * args.gen / res.decode_s:.1f} tok/s")
    return gen


if __name__ == "__main__":
    main()

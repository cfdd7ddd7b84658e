"""LR schedules, including the Corollary-1 rate eta = 1/sqrt(tau*T).

Counterpart of ``repro.optim.schedules``: each schedule maps a step (an
int or a tensor) to an fp32 scalar tensor, by the JAX formulas.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine(lr: float, total_steps: int, warmup: int = 0, floor: float = 0.0):
    def f(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * torch.where(step < warmup, warm, cos)
    return f


def corollary1(tau: int, total_rounds: int):
    """eta = 1/sqrt(tau*T) (paper Corollary 1)."""
    eta = 1.0 / (tau * total_rounds) ** 0.5
    return constant(eta)


def make_schedule(name: str, lr: float, total_steps: int = 1000, **kw):
    if name == "constant":
        return constant(lr)
    if name == "cosine":
        return cosine(lr, total_steps, **kw)
    if name == "corollary1":
        return corollary1(kw.get("tau", 1), total_steps)
    raise ValueError(name)

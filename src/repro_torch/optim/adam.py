"""Adam with fp32 moments over flat param dicts.

Counterpart of ``repro.optim.adam``: the moments and the update run in
fp32 and the result is cast back to each param's dtype; the step count
``t`` is an int32 scalar tensor. Returns new tensors, as the JAX function
does.
"""
from __future__ import annotations

from typing import Dict

import torch


def adam_init(params: Dict[str, torch.Tensor]):
    z = {k: torch.zeros_like(p, dtype=torch.float32)
         for k, p in params.items()}
    return {"m": z, "v": {k: torch.zeros_like(x) for k, x in z.items()},
            "t": torch.zeros((), dtype=torch.int32,
                             device=next(iter(params.values())).device)}


def adam_update(params: Dict[str, torch.Tensor], grads, opt_state, lr,
                b1=0.9, b2=0.999, eps=1e-8, weight_decay: float = 0.0):
    """``(new params, new opt state)``; ``grads`` may be fp32 or in the
    params' dtype."""
    t = opt_state["t"] + 1
    m = {k: b1 * mm + (1 - b1) * grads[k].float()
         for k, mm in opt_state["m"].items()}
    v = {k: b2 * vv + (1 - b2) * torch.square(grads[k].float())
         for k, vv in opt_state["v"].items()}
    tf = t.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=tf.device), tf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=tf.device), tf)

    def upd(p, mm, vv):
        step = lr * (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
        if weight_decay:
            step = step + lr * weight_decay * p.float()
        return (p.float() - step).to(p.dtype)

    new = {k: upd(p, m[k], v[k]) for k, p in params.items()}
    return new, {"m": m, "v": v, "t": t}

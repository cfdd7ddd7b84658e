"""SGD (+ optional momentum and weight decay) over flat param dicts.

Counterpart of ``repro.optim.sgd``: the update runs in fp32 and the
result is cast back to each param's dtype; the momentum buffer is fp32.
Returns new tensors, as the JAX function does.
"""
from __future__ import annotations

from typing import Dict

import torch


def sgd_init(params: Dict[str, torch.Tensor], momentum: float = 0.0):
    if momentum == 0.0:
        return {}
    return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()}}


def sgd_update(params: Dict[str, torch.Tensor], grads, opt_state, lr,
               momentum: float = 0.0, weight_decay: float = 0.0):
    """``(new params, new opt state)``. ``grads`` may be fp32 or in the
    params' dtype."""
    if momentum == 0.0:
        new_params = {
            k: (p.float() - lr * (grads[k].float() + weight_decay * p.float())
                ).to(p.dtype)
            for k, p in params.items()}
        return new_params, opt_state
    m = {k: momentum * mm + grads[k].float()
         for k, mm in opt_state["m"].items()}
    new_params = {k: (p.float() - lr * m[k]).to(p.dtype)
                  for k, p in params.items()}
    return new_params, {"m": m}

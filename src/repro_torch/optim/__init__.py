"""Optimizers and LR schedules of the port (``repro.optim``'s)."""
from repro_torch.optim.sgd import sgd_init, sgd_update  # noqa: F401
from repro_torch.optim.adam import adam_init, adam_update  # noqa: F401
from repro_torch.optim.schedules import (  # noqa: F401
    constant, cosine, make_schedule)

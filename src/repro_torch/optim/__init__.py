"""Optimizers of the port: the SGD of ``repro.optim.sgd`` (the paper
trains with plain SGD). Adam and the schedules come with a later slice."""
from repro_torch.optim.sgd import sgd_init, sgd_update  # noqa: F401

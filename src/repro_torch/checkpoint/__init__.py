"""Checkpoints of the port, in the JAX package's file format."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    load_checkpoint, save_checkpoint)

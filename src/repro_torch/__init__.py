"""PyTorch/CUDA port of the LBGM reproduction (``repro``, the JAX package).

``repro_torch.X.Y`` is the counterpart of ``repro.X.Y``. The port imports
torch and numpy only — never jax and nothing of ``repro``. Its entry points
(``repro_torch.fed.engine.FLEngine``, ``repro_torch.fed.experiment``,
``python -m repro_torch.fed.run``) run on the CUDA card unless the caller
asks for ``device="cpu"``.
"""

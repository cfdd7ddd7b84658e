"""Paper-native FCN (S2 in the paper's experiments).

2-layer fully-connected classifier as used by the paper on MNIST/FMNIST.
"""
from repro_torch.configs.base import ArchConfig, LBGMConfig

CONFIG = ArchConfig(
    name="paper-fcn",
    arch_type="fcn",
    source="ICLR2022 LBGM paper, setting S2",
    n_layers=2,
    d_model=128,          # hidden width
    vocab_size=10,        # classes
    dp_mode="replicated",
    dtype="float32",
    remat=False,
    lbgm=LBGMConfig(variant="full", delta_threshold=0.2,
                    num_clients=100, local_steps=2),
)

"""Paper-native CNN (S1 in the paper's experiments, Figs. 5-8).

A 4-layer conv classifier as used by the paper on MNIST/FMNIST/CIFAR-10.
Used for paper-faithful FL validation on synthetic image-like data.
"""
from repro_torch.configs.base import ArchConfig, LBGMConfig

CONFIG = ArchConfig(
    name="paper-cnn",
    arch_type="cnn",
    source="ICLR2022 LBGM paper, setting S1",
    n_layers=4,
    d_model=32,           # base channel width
    vocab_size=10,        # classes
    dp_mode="replicated",
    dtype="float32",
    remat=False,
    lbgm=LBGMConfig(variant="full", delta_threshold=0.2,
                    num_clients=100, local_steps=2),
)

"""Synthetic datasets (offline container — no MNIST/CIFAR/CelebA).

mixture classification: 28x28 "images" from per-class Gaussian prototypes —
a learnable stand-in for the paper's MNIST/FMNIST experiments. A NumPy copy
of ``repro.data.synthetic.mixture_classification``: the same seed gives the
same arrays in both packages.
"""
from __future__ import annotations

import numpy as np

IMG = 28


def mixture_classification(n: int, num_classes: int = 10, seed: int = 0,
                           noise: float = 0.35):
    rng = np.random.RandomState(seed)
    protos = rng.randn(num_classes, IMG, IMG, 1).astype(np.float32)
    protos /= np.linalg.norm(protos.reshape(num_classes, -1),
                             axis=1).reshape(-1, 1, 1, 1)
    protos *= IMG  # unit-ish per-pixel scale
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    x = protos[y] + noise * rng.randn(n, IMG, IMG, 1).astype(np.float32)
    return x, y

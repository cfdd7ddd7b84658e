"""Synthetic datasets (offline container — no MNIST/CIFAR/CelebA).

* mixture classification: 28x28 "images" from per-class Gaussian prototypes —
  a learnable stand-in for the paper's MNIST/FMNIST experiments.
* markov LM: token streams from a random sparse Markov chain — learnable
  next-token structure for the LMs.

NumPy copies of ``repro.data.synthetic.mixture_classification`` and
``markov_lm``: the same seed gives the same arrays in both packages.
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


def markov_lm(n_seqs: int, seq_len: int, vocab: int, seed: int = 0,
              branching: int = 4):
    """Each token has `branching` likely successors — learnable structure.
    Returns (inputs, labels), each (n_seqs, seq_len) int32; the labels are
    the inputs shifted by one."""
    rng = np.random.RandomState(seed)
    nxt = rng.randint(0, vocab, size=(vocab, branching))
    toks = np.empty((n_seqs, seq_len + 1), np.int32)
    toks[:, 0] = rng.randint(0, vocab, size=n_seqs)
    choices = rng.randint(0, branching, size=(n_seqs, seq_len))
    for t in range(seq_len):
        toks[:, t + 1] = nxt[toks[:, t], choices[:, t]]
    return toks[:, :-1], toks[:, 1:]  # inputs, labels

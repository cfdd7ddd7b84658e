"""Paper-native small models: the CNN (S1) and FCN (S2) classifiers used in
the paper's FL experiments (Figs. 5-8), in PyTorch.

Counterpart of ``repro.models.smallnets``. The public boundary keeps the
JAX package's layouts: inputs are NHWC ``(B, 28, 28, 1)`` arrays, conv
weights HWIO, and the CNN flattens its last feature map in NHWC order, so
``fc/w`` (and every other leaf) loads verbatim from JAX params. Inside,
activations run NCHW, PyTorch's convolution layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamStore

IMG = 28


def init_cnn(gen: torch.Generator, cfg: ArchConfig, device=None):
    store = ParamStore(gen, torch.float32, device=device)
    ch = cfg.d_model  # base width (32)
    chans = [1, ch, ch, 2 * ch, 2 * ch][: cfg.n_layers + 1]
    for i in range(cfg.n_layers):
        store.param(f"conv{i}/w", (3, 3, chans[i], chans[i + 1]),
                    ("kh", "kw", "cin", "cout"), scale=0.1)
        store.param(f"conv{i}/b", (chans[i + 1],), ("cout",), init="zeros")
    # two 2x2 maxpools -> 7x7 spatial
    feat = 7 * 7 * chans[cfg.n_layers]
    store.param("fc/w", (feat, cfg.vocab_size), ("feat", "classes"))
    store.param("fc/b", (cfg.vocab_size,), ("classes",), init="zeros")
    return store.params, store.axes


def apply_cnn(params, cfg: ArchConfig, x):
    """x: (B, 28, 28, 1) NHWC -> logits (B, classes)."""
    h = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    for i in range(cfg.n_layers):
        w = params[f"conv{i}/w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        h = F.conv2d(h, w, params[f"conv{i}/b"], padding=1)  # 3x3 "SAME"
        h = torch.relu(h)
        if i in (1, cfg.n_layers - 1):  # pool twice -> 7x7
            h = F.max_pool2d(h, 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC flatten order
    return h @ params["fc/w"] + params["fc/b"]


def init_fcn(gen: torch.Generator, cfg: ArchConfig, device=None):
    store = ParamStore(gen, torch.float32, device=device)
    d = cfg.d_model
    store.param("fc1/w", (IMG * IMG, d), ("feat", "hidden"))
    store.param("fc1/b", (d,), ("hidden",), init="zeros")
    store.param("fc2/w", (d, cfg.vocab_size), ("hidden", "classes"))
    store.param("fc2/b", (cfg.vocab_size,), ("classes",), init="zeros")
    return store.params, store.axes


def apply_fcn(params, cfg: ArchConfig, x):
    h = x.reshape(x.shape[0], -1)
    h = torch.relu(h @ params["fc1/w"] + params["fc1/b"])
    return h @ params["fc2/w"] + params["fc2/b"]


def classifier_loss(apply_fn, params, cfg, x, y):
    logits = apply_fn(params, cfg, x)
    logp = torch.log_softmax(logits, -1)
    ce = -torch.gather(logp, -1, y.long()[:, None]).mean()
    acc = (torch.argmax(logits, -1) == y).float().mean()
    return ce, {"ce": ce, "acc": acc}

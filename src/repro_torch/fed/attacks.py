"""Byzantine client attacks and fault injection of the port.

Counterpart of ``repro.fed.attacks``, with the same registry keys, kwargs,
batch keys and draws:

* ``level = "data"``: host-side corruption of the Byzantine clients'
  training data, applied once at engine construction (``corrupt(data)``).
  Built-in: ``"label_flip"`` (y -> num_classes - 1 - y).
* ``level = "payload"``: corruption of the accumulated gradient of a chunk
  of clients inside the round, before the uplink pipeline and the LBGM
  decision (``apply(asg, byz, extras)``: leaves ``(C, ...)``, ``byz`` the
  chunk's (C,) 0/1 Byzantine flags, ``extras`` the chunk's (C,) per-round
  extras). Built-ins: ``"sign_flip"``, ``"scaled"``, ``"free_rider"``,
  ``"gaussian"``, ``"colluding_sign"`` and ``"adaptive_scaled"``.

The Byzantine cohort is a fixed ``round(attack_frac * K)`` subset drawn
once from its own ``np.random.RandomState``; per-round attack randomness
and ``FLConfig.dropout_frac`` draw from a separate fault stream. Both
streams are the JAX package's, draw for draw. ``gaussian`` and
``colluding_sign`` draw ``jax.random.normal(fold_in(PRNGKey(seed), i),
shape)`` for leaf ``i`` in sorted key order, replayed on the gradient's
device by ``core.jax_prng.normal_rows``: the random bits are JAX's, the
normals within a few float32 ulps of them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import jax_prng
from repro_torch.fed.registry import ATTACKS, register_attack

#: reserved batch keys the engine strips before local SGD
BYZ_KEY = "_byz"
SEED_KEY = "_atk_seed"
CSEED_KEY = "_atk_cseed"
#: under scheduler="buffered", each client's rounds-of-delay draw, so an
#: adaptive attack can pre-compensate the server's staleness discount
STALE_KEY = "_atk_stale"


def select_byzantine(num_clients: int, attack_frac: float,
                     seed: int) -> np.ndarray:
    """The fixed Byzantine cohort: a (K,) 0/1 float32 mask of
    ``round(attack_frac * K)`` clients, from a dedicated stream."""
    mask = np.zeros(num_clients, np.float32)
    n_byz = int(round(attack_frac * num_clients))
    if n_byz:
        rng = np.random.RandomState(seed * 2654435761 % (2 ** 31) + 17)
        mask[rng.choice(num_clients, size=n_byz, replace=False)] = 1.0
    return mask


def fault_rng(seed: int) -> np.random.RandomState:
    """The fault stream: per-round attack noise, delays and dropout
    draws, separate from the engine's batch/mask stream."""
    return np.random.RandomState((seed + 0x5EED) * 48271 % (2 ** 31))


def _rows(flag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return flag.reshape((-1,) + (1,) * (x.dim() - 1))


def _leaf_normals(seed: torch.Tensor, asg):
    """``{name: jax.random.normal(fold_in(PRNGKey(seed_c), i), shape)}``
    for each row c and leaf i (sorted key order), fp32 (C, ...)."""
    key = jax_prng.prng_key_t(seed)
    out = {}
    for i, name in enumerate(sorted(asg)):
        x = asg[name]
        n = jax_prng.normal_rows(jax_prng.fold_in_t(key, i),
                                 int(x[0].numel()))
        out[name] = n.reshape(x.shape)
    return out


class PayloadAttack:
    """Base: corrupt the accumulated gradient of Byzantine clients.
    Subclasses implement ``_corrupt(asg, extras) -> asg`` over the chunk's
    stacks; the base keeps honest rows bit-untouched."""

    level = "payload"

    def round_extras(self, rng: np.random.RandomState,
                     num_clients: int) -> dict:
        """Per-round (K,) host arrays to thread through the batch dict."""
        return {}

    def apply(self, asg, byz, extras):
        if byz is None:
            return asg
        bad = self._corrupt(asg, extras)
        return {name: torch.where(_rows(byz, h) > 0, bad[name], h)
                for name, h in asg.items()}

    def _corrupt(self, asg, extras):
        raise NotImplementedError


@register_attack("sign_flip")
class SignFlip(PayloadAttack):
    """g -> -scale*g."""

    def __init__(self, scale: float = 1.0):
        self.scale = float(scale)

    def _corrupt(self, asg, extras):
        return {k: -self.scale * x for k, x in asg.items()}


@register_attack("scaled")
class Scaled(PayloadAttack):
    """g -> scale*g: model replacement."""

    def __init__(self, scale: float = 10.0):
        self.scale = float(scale)

    def _corrupt(self, asg, extras):
        return {k: self.scale * x for k, x in asg.items()}


@register_attack("free_rider")
class FreeRider(PayloadAttack):
    """g -> 0."""

    def _corrupt(self, asg, extras):
        return {k: torch.zeros_like(x) for k, x in asg.items()}


@register_attack("gaussian")
class Gaussian(PayloadAttack):
    """g -> sigma * N(0, I), fresh each round from a per-client seed of the
    fault stream."""

    def __init__(self, sigma: float = 1.0):
        self.sigma = float(sigma)

    def round_extras(self, rng, num_clients):
        return {SEED_KEY: rng.randint(
            0, 2 ** 31 - 1, size=num_clients).astype(np.uint32)}

    def _corrupt(self, asg, extras):
        noise = _leaf_normals(extras[SEED_KEY], asg)
        return {k: (self.sigma * noise[k]).to(x.dtype)
                for k, x in asg.items()}


@register_attack("colluding_sign")
class ColludingSign(PayloadAttack):
    """The whole Byzantine cohort pushes one shared random direction u
    (one seed a round, the same for every client): each member submits
    ``-scale * ||g_k|| * u``."""

    def __init__(self, scale: float = 1.0):
        self.scale = float(scale)

    def round_extras(self, rng, num_clients):
        shared = rng.randint(0, 2 ** 31 - 1)
        return {CSEED_KEY: np.full(num_clients, shared, np.uint32)}

    def _corrupt(self, asg, extras):
        dirs = _leaf_normals(extras[CSEED_KEY], asg)
        n2 = d2 = 0.0
        for name in sorted(asg):
            n2 = n2 + torch.square(asg[name].float()).flatten(1).sum(1)
            d2 = d2 + torch.square(dirs[name]).flatten(1).sum(1)
        coeff = (-self.scale * torch.sqrt(n2)
                 / torch.clamp(torch.sqrt(d2), min=1e-12))
        return {k: (_rows(coeff, d) * d).to(asg[k].dtype)
                for k, d in dirs.items()}


@register_attack("adaptive_scaled")
class AdaptiveScaled(PayloadAttack):
    """g -> -scale * (1 + s)^alpha * g, with s the client's delay under the
    buffered scheduler (``STALE_KEY``; absent, an amplified sign flip)."""

    def __init__(self, scale: float = 4.0, alpha: float = 0.5):
        self.scale = float(scale)
        self.alpha = float(alpha)

    def _corrupt(self, asg, extras):
        s = extras.get(STALE_KEY)
        out = {}
        for k, x in asg.items():
            amp = torch.full((x.shape[0],), self.scale, dtype=torch.float32,
                             device=x.device)
            if s is not None:
                amp = amp * (1.0 + s.float()) ** self.alpha
            out[k] = (-_rows(amp, x) * x.float()).to(x.dtype)
        return out


@register_attack("label_flip")
class LabelFlip:
    """Data-level poisoning: y -> num_classes - 1 - y on the Byzantine
    clients' local shards, applied once at engine construction."""

    level = "data"

    def __init__(self, num_classes: int = 10):
        self.num_classes = int(num_classes)

    def corrupt(self, data: dict) -> dict:
        if "y" not in data:
            raise ValueError(
                "label_flip attack needs integer labels under data key "
                f"'y'; client data has keys {sorted(data)} — use a "
                "payload-level attack (sign_flip/scaled/gaussian/"
                "free_rider) for unlabeled tasks")
        return {**data, "y": (self.num_classes - 1 - data["y"]).astype(
            data["y"].dtype)}


def make_attack(cfg):
    """Resolve ``cfg.attack`` through the registry (None -> no attack)."""
    if cfg.attack is None:
        return None
    try:
        return ATTACKS.get(cfg.attack)(**(cfg.attack_kw or {}))
    except TypeError as e:
        raise ValueError(
            f"FLConfig.attack_kw {cfg.attack_kw!r} does not match attack "
            f"{cfg.attack!r}: {e}") from e

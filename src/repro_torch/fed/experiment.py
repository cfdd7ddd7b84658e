"""Declarative experiment API of the port: ``ExperimentSpec`` ->
``run_experiment``.

Counterpart of ``repro.fed.experiment``: the same frozen spec types,
JSON form and dotted-key overrides, so one spec file drives either
package. Entry points:

* ``build_experiment(spec, params=None, device="cuda") -> (FLEngine,
  eval_fn)``. ``params`` takes a flat dict of numpy arrays (the JAX
  package's initial params, names and layouts unchanged) in place of the
  model component's own torch-drawn init, so both packages can run from
  identical weights.
* ``run_experiment(spec, rounds=None, device="cuda", params=None) ->
  ExperimentResult``.
* ``sweep(base_spec, overrides)``.
* ``python -m repro_torch.fed.run --spec spec.json --set key=value``.

Every entry point runs on the CUDA card unless given ``device="cpu"``, and
raises without a card.

Built-in components: models ``fcn``, ``cnn`` and ``lm``, datasets
``mixture`` and ``markov``, partitioners ``label_skew`` and ``iid``. A
model builder returns ``(params, loss_fn)`` or ``(params, loss_fn,
axes)`` (each leaf's logical axes, kept for ``model_sharding="auto"``),
with params drawn from a ``torch.Generator`` seeded by the spec. A builder
that takes ``device`` gets the engine's: ``fcn`` and ``cnn`` still draw on
the CPU (one init for both devices), ``lm`` draws on that device, so a
full-width LM never passes through host memory. With ``params`` given,
``build_experiment`` asks such a builder for ``device="meta"`` (shapes
only) to check the keys, with no second draw.
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, \
    Tuple, Union

import numpy as np
import torch

from repro_torch.fed.flconfig import FLConfig
from repro_torch.launch.mesh import is_writer
from repro_torch.fed.registry import (DATASETS, MODELS, PARTITIONERS,
                                      register_dataset, register_model,
                                      register_partitioner)

# --------------------------------------------------------------- spec types


@dataclass(frozen=True)
class ComponentSpec:
    """A registry key plus its keyword arguments: ``("mixture", {"n": 2000})``."""
    name: str
    kw: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class EvalPolicy:
    """When to run held-out evaluation during/after an experiment."""
    every: int = 0          # eval every N rounds (0 = never during the run)
    final: bool = True      # eval once after the last round
    verbose: bool = False   # print per-eval progress lines

    def __post_init__(self):
        if self.every < 0:
            raise ValueError(
                f"EvalPolicy: every must be >= 0, got {self.every}")


@dataclass(frozen=True)
class ExperimentSpec:
    """The complete, serializable description of one FL experiment."""
    model: ComponentSpec = field(
        default_factory=lambda: ComponentSpec("fcn"))
    data: ComponentSpec = field(
        default_factory=lambda: ComponentSpec("mixture"))
    partition: ComponentSpec = field(
        default_factory=lambda: ComponentSpec("label_skew"))
    fl: FLConfig = field(default_factory=FLConfig)
    rounds: int = 40
    eval: EvalPolicy = field(default_factory=EvalPolicy)
    name: str = "experiment"

    def validate(self) -> "ExperimentSpec":
        if self.rounds < 1:
            raise ValueError(
                f"ExperimentSpec: rounds must be >= 1, got {self.rounds}")
        for reg, comp in ((MODELS, self.model), (DATASETS, self.data),
                          (PARTITIONERS, self.partition)):
            if comp.name not in reg:
                raise ValueError(
                    f"ExperimentSpec: unknown {reg.kind} {comp.name!r}; "
                    f"registered {reg.kind}s: {reg.names()}")
        return self

    # ------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"ExperimentSpec: unknown fields {sorted(unknown)}; "
                f"known fields: {sorted(known)}")
        for key in ("model", "data", "partition"):
            if key in d and isinstance(d[key], Mapping):
                d[key] = ComponentSpec(**d[key])
        if isinstance(d.get("fl"), Mapping):
            d["fl"] = FLConfig.from_dict(d["fl"])
        if isinstance(d.get("eval"), Mapping):
            d["eval"] = EvalPolicy(**d["eval"])
        return cls(**d)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    # ----------------------------------------------------------- overrides
    def with_overrides(self, overrides: Mapping[str, Any]) -> "ExperimentSpec":
        """New spec with dotted-key overrides applied, e.g.
        ``{"fl.delta_threshold": 0.4, "model.kw.arch": "paper-cnn"}``."""
        def is_open(key):  # kw dicts take arbitrary component kwargs
            return key == "kw" or key.endswith("_kw")

        d = self.to_dict()
        for dotted, value in overrides.items():
            parts = dotted.split(".")
            node = d
            for p in parts[:-1]:
                if not isinstance(node, dict) or p not in node:
                    raise ValueError(
                        f"ExperimentSpec: unknown override key {dotted!r} "
                        f"(no field {p!r}; known: "
                        f"{sorted(node) if isinstance(node, dict) else []})")
                if node[p] is None and is_open(p):
                    node[p] = {}
                node = node[p]
            leaf = parts[-1]
            if not isinstance(node, dict):
                raise ValueError(
                    f"ExperimentSpec: unknown override key {dotted!r}")
            if leaf not in node and not (len(parts) > 1
                                         and is_open(parts[-2])):
                raise ValueError(
                    f"ExperimentSpec: unknown override key {dotted!r}; "
                    f"known keys here: {sorted(node)}")
            node[leaf] = value
        return type(self).from_dict(d)


# ------------------------------------------------------------ result types

#: history keys copied verbatim from ``FLEngine.run_round`` metrics
_HISTORY_KEYS = ("loss", "uplink_floats", "frac_scalar", "wire_bytes",
                 "total_uplink", "vanilla_uplink", "savings",
                 "total_wire_bytes", "wire_savings")


@dataclass
class RoundRecord:
    """One FL round's server-side metrics (mirrors ``FLEngine.history``)."""
    round: int
    loss: float
    uplink_floats: float
    frac_scalar: float
    total_uplink: float
    vanilla_uplink: float
    savings: float
    wire_bytes: float = 0.0
    total_wire_bytes: float = 0.0
    wire_savings: float = 0.0
    eval: Dict[str, float] = field(default_factory=dict)

    def as_history_entry(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in _HISTORY_KEYS}


@dataclass
class ExperimentResult:
    """Typed outcome of ``run_experiment``: round records + accounting.
    ``sin2`` holds each round's per-client LBP error (K,)."""
    spec: ExperimentSpec
    rounds: int
    records: List[RoundRecord]
    final_eval: Dict[str, float]
    total_uplink: float
    vanilla_uplink: float
    savings: float
    duration_s: float
    sin2: List[np.ndarray] = field(default_factory=list)
    device: str = "cpu"

    @property
    def history(self) -> List[Dict[str, float]]:
        """Engine-compatible history (equal to ``FLEngine.history``)."""
        return [r.as_history_entry() for r in self.records]

    @property
    def us_per_round(self) -> float:
        return self.duration_s / max(self.rounds, 1) * 1e6

    def to_dict(self) -> Dict[str, Any]:
        return {
            "spec": self.spec.to_dict(),
            "rounds": self.rounds,
            "records": [dataclasses.asdict(r) for r in self.records],
            "final_eval": self.final_eval,
            "total_uplink": self.total_uplink,
            "vanilla_uplink": self.vanilla_uplink,
            "savings": self.savings,
            "duration_s": self.duration_s,
            "device": self.device,
        }


# ------------------------------------------------------------ entry points


def build_experiment(spec: ExperimentSpec, params=None, device="cuda"):
    """Resolve the spec's components and wire the engine on ``device``.

    ``params``: optional flat dict of numpy arrays replacing the model
    component's own init (the JAX package's params carry across
    verbatim), or of tensors (moved to ``device``; a card's weights stay
    on the card). Returns ``(engine, eval_fn)``; ``eval_fn(params)`` gives
    ``{"test_loss", "test_acc"}`` on the held-out split.
    """
    from repro_torch.fed.engine import FLEngine, resolve_device
    from repro_torch.models.common import params_from_numpy

    dev = resolve_device(device)
    spec.validate()
    builder = MODELS.get(spec.model.name)
    kw = {"seed": spec.fl.seed, **spec.model.kw}
    if "device" in inspect.signature(builder).parameters:
        kw["device"] = dev if params is None else torch.device("meta")
    built = builder(**kw)
    init_params, loss_fn, model_axes = (
        built if len(built) == 3 else (*built, None))
    if params is not None:
        if set(params) != set(init_params):
            raise ValueError(
                f"build_experiment: params keys {sorted(params)} do not "
                f"match the model's {sorted(init_params)}")
        if all(isinstance(v, torch.Tensor) for v in params.values()):
            init_params = {k: v.to(dev) for k, v in params.items()}
        else:
            init_params = params_from_numpy(params, dev)
    train, held_out = DATASETS.get(spec.data.name)(**spec.data.kw)
    n_held = len(next(iter(held_out.values()))) if held_out else 0
    if n_held == 0 and (spec.eval.final or spec.eval.every):
        raise ValueError(
            "ExperimentSpec: the eval policy requests evaluation but the "
            "dataset's held-out split is empty (a mean over zero samples "
            "is NaN); grow it (e.g. data.kw n_eval > 0) or disable eval "
            "with EvalPolicy(every=0, final=False)")
    parts = PARTITIONERS.get(spec.partition.name)(
        train, spec.fl.num_clients, **spec.partition.kw)
    client_data = [{k: v[p] for k, v in train.items()} for p in parts]
    engine = FLEngine(loss_fn, init_params, client_data, spec.fl,
                      device=dev, model_axes=model_axes)
    eval_batch = {k: torch.as_tensor(v).to(dev)
                  for k, v in held_out.items()}

    def eval_fn(params) -> Dict[str, float]:
        with torch.no_grad():
            loss, metrics = loss_fn(params, eval_batch)
        out = {"test_loss": float(loss)}
        if "acc" in metrics:
            out["test_acc"] = float(metrics["acc"])
        return out

    return engine, eval_fn


def run_experiment(spec: ExperimentSpec, rounds: Optional[int] = None,
                   device="cuda", params=None,
                   resume: bool = False) -> ExperimentResult:
    """Build the spec's experiment on ``device``, run it, and return the
    typed result. The round loop is ``FLEngine.run``'s (same rng stream,
    host prep on the engine's :class:`RoundPrefetcher`); ``duration_s``
    counts round time only, each round ending in a host read of its
    metrics (which waits for the device). Every ``fl.ckpt_every`` rounds
    the engine's state goes to ``fl.ckpt_path``.

    ``resume=True`` restores the checkpoint at ``spec.fl.ckpt_path`` first
    and runs the remaining rounds; the history is the uninterrupted run's
    bit for bit. The records of the restored rounds carry no eval (eval
    only reads params and can be run again offline), and ``sin2`` holds
    the rounds run since the resume."""
    rounds = spec.rounds if rounds is None else rounds
    engine, eval_fn = build_experiment(spec, params=params, device=device)
    policy = spec.eval
    records: List[RoundRecord] = []
    rng = np.random.RandomState(spec.fl.seed + 1)
    start = 0
    if resume:
        if not spec.fl.ckpt_path:
            raise ValueError("run_experiment(resume=True) needs "
                             "fl.ckpt_path set in the spec")
        start = engine.restore_checkpoint(spec.fl.ckpt_path, rng)
        records = [RoundRecord(round=i + 1, eval={},
                               **{k: h[k] for k in _HISTORY_KEYS})
                   for i, h in enumerate(engine.history)]
    duration = 0.0
    src = engine.prefetcher(rng)
    try:
        for r in range(start, rounds):
            t0 = time.perf_counter()
            m = engine.run_round(src)
            duration += time.perf_counter() - t0
            ev: Dict[str, float] = {}
            if policy.every and (r + 1) % policy.every == 0:
                ev = eval_fn(engine.params)
                if policy.verbose and is_writer():
                    shown = {**m, **ev}
                    print(f"[{spec.name}] round {r+1:4d} " +
                          " ".join(f"{k}={v:.4g}"
                                   for k, v in shown.items()))
            records.append(RoundRecord(round=r + 1, eval=ev,
                                       **{k: m[k] for k in _HISTORY_KEYS}))
            if spec.fl.ckpt_every and (r + 1) % spec.fl.ckpt_every == 0:
                engine.save_checkpoint(spec.fl.ckpt_path)
    finally:
        src.close()
        engine.close()
    final_eval = eval_fn(engine.params) if policy.final else {}
    return ExperimentResult(
        spec=spec, rounds=rounds, records=records, final_eval=final_eval,
        total_uplink=engine.total_uplink,
        vanilla_uplink=engine.vanilla_uplink,
        savings=records[-1].savings if records else 0.0,
        duration_s=duration, sin2=list(engine.sin2_history),
        device=str(engine.device))


OverridesLike = Union[Mapping[str, Iterable[Any]],
                      Iterable[Mapping[str, Any]]]


def expand_overrides(overrides: OverridesLike) -> List[Dict[str, Any]]:
    """A mapping of ``key -> values`` expands to the cartesian grid; an
    iterable of dicts passes through as explicit sweep points."""
    if isinstance(overrides, Mapping):
        keys = list(overrides)
        grids = [list(overrides[k]) for k in keys]
        return [dict(zip(keys, combo)) for combo in itertools.product(*grids)]
    return [dict(o) for o in overrides]


def sweep(base_spec: ExperimentSpec, overrides: OverridesLike,
          rounds: Optional[int] = None, device="cuda",
          ) -> List[Tuple[Dict[str, Any], ExperimentResult]]:
    """Run ``base_spec`` under each override set, in grid order."""
    out = []
    for point in expand_overrides(overrides):
        spec = base_spec.with_overrides(point)
        out.append((point, run_experiment(spec, rounds, device=device)))
    return out


# --------------------------------------------------------------- built-ins


def _classifier_model(arch: str, seed: int, init_fn, apply_fn, device,
                      **arch_overrides):
    from repro_torch.configs import get_config
    from repro_torch.models.smallnets import classifier_loss

    cfg = get_config(arch)
    if arch_overrides:
        cfg = dataclasses.replace(cfg, **arch_overrides)
    # drawn on the CPU whatever the engine's device, unless only the
    # shapes are asked for
    meta = torch.device(device).type == "meta"
    params, _ = init_fn(torch.Generator().manual_seed(seed), cfg,
                        device="meta" if meta else None)
    loss_fn = lambda p, b: classifier_loss(apply_fn, p, cfg, b["x"], b["y"])
    return params, loss_fn


@register_model("fcn")
def _fcn_model(seed: int = 0, arch: str = "paper-fcn", device="cpu",
               **arch_overrides):
    """Paper S2: 1-hidden-layer FCN classifier on 28x28 inputs."""
    from repro_torch.models.smallnets import apply_fcn, init_fcn
    return _classifier_model(arch, seed, init_fcn, apply_fcn, device,
                             **arch_overrides)


@register_model("cnn")
def _cnn_model(seed: int = 0, arch: str = "paper-cnn", device="cpu",
               **arch_overrides):
    """Paper S1: small conv classifier on 28x28 inputs."""
    from repro_torch.models.smallnets import apply_cnn, init_cnn
    return _classifier_model(arch, seed, init_cnn, apply_cnn, device,
                             **arch_overrides)


@register_model("lm")
def _lm_model(seed: int = 0, arch: str = "qwen3-1.7b", reduced: bool = True,
              device="cuda", **arch_overrides):
    """Next-token LM on one of the port's decoder archs (qwen3-1.7b,
    rwkv6-3b), ``reduced()`` by default so the spec runs on a CPU; drop
    ``reduced`` for the published widths. The params are drawn on
    ``device`` (the engine's) from a generator there. The loss
    (``train.trainer.make_loss_fn``) is marked ``CLIENT_LOOP``:
    ``torch.func`` cannot take the gradient of its checkpointed blocks and
    CE chunks, so the engine runs a chunk's clients one after another.
    Under ``model_sharding="auto"`` the engine takes the loss's
    ``TENSOR_PARALLEL`` form (``train.trainer.make_tp_loss_fn``): the
    dense decoder, M-RoPE VLM (its M-RoPE positions; the batches carry no
    stub patches, as the JAX component's), recurrent (rwkv6, RG-LRU) and
    MoE families. It refuses the encoder-decoder at engine build: the
    batches carry no encoder frames, so whisper runs under no
    ``model_sharding``, in this package as in the JAX one."""
    from repro_torch.configs import get_config
    from repro_torch.core.device import resolve_device
    from repro_torch.fed.engine import CLIENT_LOOP, TENSOR_PARALLEL
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.trainer import make_loss_fn, make_tp_loss_fn

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if arch_overrides:
        cfg = dataclasses.replace(cfg, **arch_overrides)
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    params, axes = init_lm(gen.manual_seed(seed), cfg, device=dev)
    loss_fn = make_loss_fn(cfg)
    setattr(loss_fn, CLIENT_LOOP, True)
    setattr(loss_fn, TENSOR_PARALLEL, lambda tp: make_tp_loss_fn(cfg, tp))
    return params, loss_fn, axes


@register_dataset("mixture")
def _mixture_dataset(n: int = 2000, n_eval: int = 500, num_classes: int = 10,
                     seed: int = 0, noise: float = 0.35):
    """Gaussian-prototype 28x28 classification (MNIST/FMNIST stand-in)."""
    from repro_torch.data.synthetic import mixture_classification
    x, y = mixture_classification(n + n_eval, num_classes, seed=seed,
                                  noise=noise)
    return ({"x": x[:n], "y": y[:n]}, {"x": x[n:], "y": y[n:]})


@register_dataset("markov")
def _markov_dataset(n: int = 256, n_eval: int = 64, seq_len: int = 32,
                    vocab: int = 512, seed: int = 0, branching: int = 4):
    """Markov-chain token streams (each token has ``branching`` likely
    successors) for the ``"lm"`` component; ``vocab`` must match the
    arch's (the reduced archs clamp it to 512)."""
    from repro_torch.data.synthetic import markov_lm
    toks, labels = markov_lm(n + n_eval, seq_len, vocab, seed=seed,
                             branching=branching)
    return ({"tokens": toks[:n], "labels": labels[:n]},
            {"tokens": toks[n:], "labels": labels[n:]})


@register_partitioner("label_skew")
def _label_skew_partitioner(train, num_clients: int,
                            classes_per_client: int = 3, seed: int = 0):
    """Non-iid S1 split: each client sees only a few labels."""
    from repro_torch.fed.partition import partition_label_skew
    return partition_label_skew(train["y"], num_clients,
                                classes_per_client, seed=seed)


@register_partitioner("iid")
def _iid_partitioner(train, num_clients: int, seed: int = 0):
    from repro_torch.fed.partition import partition_iid
    n = len(next(iter(train.values())))
    return partition_iid(n, num_clients, seed=seed)

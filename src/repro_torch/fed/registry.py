"""String-keyed component registries of the PyTorch port.

The port keeps registries of its own: the JAX package's lazily import
``repro.fed.engine``, and the port imports nothing of that package. A key
the port has not ported yet is simply not registered here, so
``FLConfig`` rejects it with the usual "unknown ...; registered: [...]"
error instead of running something else. The built-in keys, aliases and
``kw=`` surfaces are the JAX package's.

Every pluggable piece of an FL experiment — model, dataset, partitioner,
uplink compressor, client scheduler, LBG storage scheme, server
aggregation rule, Byzantine attack — resolves through
one of the registries below, so an :class:`~repro_torch.fed.experiment.ExperimentSpec`
can name components by string and round-trip through JSON, and third-party
code can extend the system without touching ``fed/engine.py``:

    from repro_torch.fed.registry import register_model

    @register_model("my-net")
    def build(seed=0, **kw):
        ...
        return params, loss_fn

This module is deliberately pure-Python (no torch) so any layer may import
it without dragging in the engine. Built-in components live in torch-heavy
modules (``repro_torch.fed.engine``, ``repro_torch.fed.robust``,
``repro_torch.fed.attacks``, ``repro_torch.fed.latency``,
``repro_torch.compression``, ``repro_torch.fed.experiment``,
``repro_torch.comm.wire``); each registry
lazily imports its ``builtin_modules`` on first lookup so the built-ins
are always visible regardless of import order.
"""
from __future__ import annotations

import importlib
import inspect
from typing import Callable, Dict, FrozenSet, Iterable, Optional


class Registry:
    """A named string -> factory mapping with actionable error messages."""

    def __init__(self, kind: str, builtin_modules: Iterable[str] = ()):
        self.kind = kind
        self._entries: Dict[str, Callable] = {}
        self._aliases: Dict[str, str] = {}
        self._kw_specs: Dict[str, FrozenSet[str]] = {}
        self._builtin_modules = tuple(builtin_modules)
        self._loaded_modules: set = set()

    # ------------------------------------------------------------ loading
    def _ensure_builtins(self) -> None:
        # mark each module loaded only after its import succeeds: a failed
        # import must surface as the real ImportError on every lookup, not
        # latch the registry empty and report "registered: []". Re-entrancy
        # is safe — the imports call register(), never back into here.
        for mod in self._builtin_modules:
            if mod not in self._loaded_modules:
                importlib.import_module(mod)
                self._loaded_modules.add(mod)

    # -------------------------------------------------------- registration
    def register(self, name: str, obj: Optional[Callable] = None,
                 aliases: Iterable[str] = (),
                 kw: Optional[Iterable[str]] = None):
        """Register ``obj`` under ``name`` (usable as a decorator).

        Duplicate names are an error: silent overwrites are how two
        experiments end up silently running different code under one key.

        ``kw`` optionally declares the keyword names the component's
        ``*_kw`` config dict accepts — needed when the registered object
        is a factory (lambda over a cfg) whose signature hides the real
        constructor. Classes registered directly don't need it:
        :meth:`valid_kw` introspects their ``__init__``.
        """
        def _add(fn: Callable) -> Callable:
            # validate name AND all aliases before mutating anything, so a
            # collision leaves the registry untouched and the caller's
            # corrected retry succeeds
            if name in self._entries or name in self._aliases:
                raise ValueError(
                    f"duplicate {self.kind} registration {name!r}; "
                    f"registered: {self.names()}")
            for a in aliases:
                if a in self._entries or a in self._aliases:
                    raise ValueError(
                        f"duplicate {self.kind} alias {a!r}; "
                        f"registered: {self.names()}")
            self._entries[name] = fn
            for a in aliases:
                self._aliases[a] = name
            if kw is not None:
                self._kw_specs[name] = frozenset(kw)
            return fn
        return _add if obj is None else _add(obj)

    # ------------------------------------------------------------- lookup
    def get(self, name: str) -> Callable:
        self._ensure_builtins()
        key = self._aliases.get(name, name)
        try:
            return self._entries[key]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} {name!r}; registered "
                f"{self.kind}s: {self.names()}") from None

    def names(self) -> list:
        self._ensure_builtins()
        return sorted(self._entries)

    def valid_kw(self, name: str) -> Optional[FrozenSet[str]]:
        """Keyword names ``name``'s constructor accepts, or None when
        they can't be known statically (a factory registered without an
        explicit ``kw=`` spec, or a ``**kwargs`` constructor).

        ``FLConfig`` checks the user's ``*_kw`` dict against this at
        construction so a typo'd key fails with the valid names in the
        message instead of a TypeError deep inside the engine build.
        An explicit ``kw=`` spec always wins over introspection.
        """
        self._ensure_builtins()
        key = self._aliases.get(name, name)
        if key in self._kw_specs:
            return self._kw_specs[key]
        obj = self._entries.get(key)
        if obj is None or not inspect.isclass(obj):
            return None
        init = obj.__init__
        if init is object.__init__:
            return frozenset()
        try:
            sig = inspect.signature(init)
        except (TypeError, ValueError):
            return None
        params = list(sig.parameters.values())[1:]   # drop self
        if any(p.kind in (p.VAR_KEYWORD, p.VAR_POSITIONAL)
               for p in params):
            return None
        return frozenset(p.name for p in params)

    def __contains__(self, name: str) -> bool:
        self._ensure_builtins()
        return name in self._entries or name in self._aliases


_EXPERIMENT = ("repro_torch.fed.experiment",)
_ENGINE = ("repro_torch.fed.engine",)

MODELS = Registry("model", builtin_modules=_EXPERIMENT)
DATASETS = Registry("dataset", builtin_modules=_EXPERIMENT)
PARTITIONERS = Registry("partitioner", builtin_modules=_EXPERIMENT)
COMPRESSORS = Registry("compressor",
                       builtin_modules=("repro_torch.compression",))
SCHEDULERS = Registry("scheduler", builtin_modules=_ENGINE)
LBG_STORES = Registry("lbg_store", builtin_modules=_ENGINE)
AGGREGATORS = Registry("aggregator",
                       builtin_modules=("repro_torch.fed.robust",))
ATTACKS = Registry("attack", builtin_modules=("repro_torch.fed.attacks",))
CODECS = Registry("codec", builtin_modules=("repro_torch.comm.wire",))
LATENCIES = Registry("latency", builtin_modules=("repro_torch.fed.latency",))

register_model = MODELS.register
register_dataset = DATASETS.register
register_partitioner = PARTITIONERS.register
register_compressor = COMPRESSORS.register
register_scheduler = SCHEDULERS.register
register_lbg_store = LBG_STORES.register
register_aggregator = AGGREGATORS.register
register_attack = ATTACKS.register
register_codec = CODECS.register
register_latency = LATENCIES.register

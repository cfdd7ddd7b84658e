"""Canonical FL/LBGM knob container of the PyTorch port.

Same fields, defaults, validation and JSON form as
``repro.fed.flconfig.FLConfig``, so one spec file drives either package.
Registry-keyed fields are checked against the PORT's registries
(``repro_torch.fed.registry``); a key the port has not ported yet fails
with the usual "unknown ...; registered: [...]" error. The ``"sharded"``
scheduler and ``mesh`` run on ``torch.distributed`` ranks
(``repro_torch.launch.mesh``), ``model_sharding="auto"`` on the
``"sharded"`` scheduler only, as in the JAX package (the engine refuses
the model families and settings it has no tensor-parallel form for).

This module stays import-light (no torch): registries are consulted
lazily, which also lets ``repro_torch.configs`` import it without cycles.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

#: legacy spelling used by the arch-side LBGMConfig ("full" dense bank)
_LBG_VARIANT_ALIASES = {"full": "dense"}


@dataclass(frozen=True)
class FLConfig:
    num_clients: int = 100
    tau: int = 2                     # local SGD steps per round
    lr: float = 0.05
    batch_size: int = 32
    use_lbgm: bool = True
    delta_threshold: float = 0.2
    compressor: str = "none"         # registry key: none | topk | atomo |
    #                                  signsgd
    compressor_kw: Optional[dict] = None
    error_feedback: Optional[bool] = None   # default: on iff topk
    sample_frac: float = 1.0         # Algorithm 3 device sampling
    seed: int = 0
    scheduler: str = "vmap"          # registry key: vmap | chunked |
    #                                  buffered | sharded
    chunk_size: int = 16             # max clients per chunk
    mesh: Union[None, int, list] = None
    # ^ the sharded scheduler's (clients, model) mesh of ranks: None = every
    #   rank on the client axis, int n = [n, 1], [c, m] = c client ranks x
    #   m model ranks (launch.mesh.make_fl_mesh)
    model_sharding: str = "replicate"
    lbg_variant: str = "dense"       # registry key: dense | topk |
    #                                  topk-host | topk-sharded | null
    lbg_kw: Optional[dict] = None    # e.g. {"k_frac": 0.1} for topk
    aggregator: str = "mean"         # registry key: mean | trimmed_mean |
    #   coordinate_median | geometric_median | scalar_median
    #   (repro_torch.fed.robust); every rule but "mean" runs in collect mode
    aggregator_kw: Optional[dict] = None   # e.g. {"beta": 0.1} | {"iters": 8}
    attack: Optional[str] = None     # registry key: sign_flip | scaled |
    #   free_rider | gaussian | colluding_sign | adaptive_scaled |
    #   label_flip (repro_torch.fed.attacks); None = no attack
    attack_frac: float = 0.0         # the fixed Byzantine cohort's share
    attack_kw: Optional[dict] = None
    dropout_frac: float = 0.0        # per round, each sampled client drops
    #   out with this probability (drawn from the fault stream)
    fused_kernels: Optional[bool] = None
    # ^ the LBGM decision hot path. None (default) and True: the
    #   hand-written kernels on a CUDA device, their plain PyTorch versions
    #   on the CPU, plus sparse scalar-round aggregation for the top-k
    #   store. False: the legacy multi-pass path with dense aggregation.
    codec: str = "none"              # registry key: none | delta_idx |
    #   int8 | fp8 — the uplink wire codec (repro_torch.comm.wire)
    codec_kw: Optional[dict] = None  # e.g. {"stochastic": False}
    latency: str = "none"            # registry key: none | fixed |
    #   uniform | lognormal | straggler (repro_torch.fed.latency), the
    #   rounds-of-delay model of scheduler="buffered"
    latency_kw: Optional[dict] = None      # e.g. {"frac": 0.2, "delay": 4};
    #   {"max_staleness": s} evicts payloads older than s rounds
    tiers: Union[None, list, dict] = None
    # ^ hierarchical tiers (repro_torch.fed.hierarchy): [e] or [e, r]
    #   edges (and regions), contiguous in client order, or
    #   {"levels": [e, r], "assign": "shuffle"}; the global update stays
    #   bit for bit the flat fold, and CommLedger attributes per-tier bytes
    ckpt_every: int = 0              # checkpoint every N rounds; 0 = off
    ckpt_path: Optional[str] = None  # .npz checkpoint path (run --resume)

    # ---------------------------------------------------------- validation
    def __post_init__(self):
        def bad(msg):
            raise ValueError(f"FLConfig: {msg}")

        if self.num_clients < 1:
            bad(f"num_clients must be >= 1, got {self.num_clients}")
        if self.tau < 1:
            bad(f"tau must be >= 1, got {self.tau}")
        if self.batch_size < 1:
            bad(f"batch_size must be >= 1, got {self.batch_size}")
        if not 0.0 < self.sample_frac <= 1.0:
            bad(f"sample_frac must be in (0, 1], got {self.sample_frac}")
        if self.chunk_size < 1:
            bad(f"chunk_size must be >= 1, got {self.chunk_size}")

        def int_ge1(x):
            return isinstance(x, int) and not isinstance(x, bool) and x >= 1
        if self.mesh is not None:
            if isinstance(self.mesh, (list, tuple)):
                if len(self.mesh) != 2 or not all(int_ge1(d)
                                                  for d in self.mesh):
                    bad("mesh must be None, a client-device count >= 1, or "
                        "a [clients, model] pair of device counts >= 1 — "
                        f"got {self.mesh!r}")
                object.__setattr__(self, "mesh", [int(d) for d in self.mesh])
            elif not int_ge1(self.mesh):
                bad("mesh must be None, a client-device count >= 1, or a "
                    f"[clients, model] pair — got {self.mesh!r}")
        if self.mesh_model_dim > 1 and self.scheduler in ("vmap", "chunked",
                                                          "buffered"):
            bad(f"mesh={self.mesh!r} asks for model-axis sharding but "
                f"scheduler={self.scheduler!r} is mesh-unaware")
        if self.model_sharding not in ("replicate", "auto"):
            bad("model_sharding must be 'replicate' or 'auto' — got "
                f"{self.model_sharding!r}")
        if self.model_sharding == "auto" and self.scheduler != "sharded":
            bad(f"model_sharding='auto' shards the client forward/backward "
                "over the 2-D (clients, model) mesh, which only "
                f"scheduler='sharded' runs — got "
                f"scheduler={self.scheduler!r}")
        if not any(self.fused_kernels is v for v in (None, True, False)):
            bad("fused_kernels must be None, true, or false — got "
                f"{self.fused_kernels!r}; JSON/CLI specs must use the "
                "boolean literals, not 0/1")
        if not 0.0 <= self.attack_frac <= 1.0:
            bad(f"attack_frac must be in [0, 1], got {self.attack_frac}")
        if not 0.0 <= self.dropout_frac < 1.0:
            bad(f"dropout_frac must be in [0, 1), got {self.dropout_frac}")
        if self.attack is None and self.attack_frac > 0:
            bad(f"attack_frac={self.attack_frac} but attack=None — name an "
                "attack or set attack_frac=0")
        for kw_name in ("aggregator_kw", "attack_kw", "codec_kw",
                        "latency_kw"):
            kw = getattr(self, kw_name)
            if kw is not None and not isinstance(kw, dict):
                bad(f"{kw_name} must be a dict or None, got {kw!r}")
        # buffered scheduler: latency models only make sense there, and
        # the scheduler folds sparse (idx, val) payloads through the
        # staleness buffer — it has no dense/legacy path
        if self.latency != "none" and self.scheduler != "buffered":
            bad(f"latency={self.latency!r} models rounds-of-delay for the "
                "buffered scheduler, but "
                f"scheduler={self.scheduler!r} folds every payload the "
                "round it is computed — use scheduler='buffered' or "
                "latency='none'")
        if self.scheduler == "buffered":
            if not self.use_lbgm or self.resolved_lbg_variant not in (
                    "topk", "topk-sharded"):
                bad("scheduler='buffered' buffers each client's sparse "
                    "(idx, val) payload between dispatch and delivery, "
                    "which needs the top-k LBG store — set use_lbgm=True "
                    "and lbg_variant='topk' (or 'topk-sharded'), got "
                    f"use_lbgm={self.use_lbgm} "
                    f"lbg_variant={self.lbg_variant!r}")
            if self.fused_kernels is False:
                bad("scheduler='buffered' requires the sparse aggregation "
                    "contract; fused_kernels=False selects the legacy "
                    "dense fold which cannot buffer payloads — leave "
                    "fused_kernels unset (auto) or True")
            if self.model_sharding != "replicate":
                bad("scheduler='buffered' runs the replicated chunked "
                    "layout; model_sharding="
                    f"{self.model_sharding!r} needs scheduler='sharded'")
        # topk-host keeps the bank on the host and streams it chunk by
        # chunk through the chunked scheduler's client-block layout; a dense
        # error-feedback residual would put an O(K, M) tensor back on the
        # device
        if self.use_lbgm and self.resolved_lbg_variant == "topk-host":
            if self.scheduler != "chunked":
                bad("lbg_variant='topk-host' streams host-resident bank "
                    "chunks through the chunked client-block layout — set "
                    f"scheduler='chunked', got {self.scheduler!r}")
            ef_on = self.error_feedback is True or (
                self.error_feedback is None and self.compressor == "topk")
            if ef_on:
                bad("lbg_variant='topk-host' cannot run error feedback: "
                    "the dense (K, M) residual bank would live on device "
                    "and defeat out-of-core banks — set "
                    "error_feedback=False or compressor='none'")
            if self.fused_kernels is False:
                bad("lbg_variant='topk-host' requires the sparse "
                    "aggregation contract; fused_kernels=False selects "
                    "the legacy dense fold — leave fused_kernels unset "
                    "(auto) or True")
        if self.tiers is not None:
            levels, assign = self.tiers, "contiguous"
            if isinstance(self.tiers, dict):
                unknown = set(self.tiers) - {"levels", "assign"}
                if unknown:
                    bad(f"tiers dict keys {sorted(unknown)} unknown; "
                        "valid keys: ['assign', 'levels']")
                levels = self.tiers.get("levels")
                assign = self.tiers.get("assign", "contiguous")
            if assign not in ("contiguous", "shuffle"):
                bad("tiers assign must be 'contiguous' or 'shuffle', "
                    f"got {assign!r}")
            if (not isinstance(levels, (list, tuple)) or
                    not 1 <= len(levels) <= 2 or
                    not all(int_ge1(n) for n in levels)):
                bad("tiers levels must be [n_edges] or "
                    "[n_edges, n_regions] with ints >= 1, got "
                    f"{levels!r}")
            levels = [int(n) for n in levels]
            if levels[0] > self.num_clients:
                bad(f"tiers asks for {levels[0]} edges but only "
                    f"{self.num_clients} clients exist")
            if len(levels) == 2 and levels[1] > levels[0]:
                bad(f"tiers levels must descend edge -> region, got "
                    f"{levels!r}")
            # lists, so the form compares equal after a JSON round trip
            if isinstance(self.tiers, dict):
                object.__setattr__(
                    self, "tiers", {"levels": levels, "assign": assign})
            else:
                object.__setattr__(self, "tiers", levels)
            if self.scheduler == "sharded":
                bad("tiers are not supported with scheduler='sharded': "
                    "the hierarchical carry pytree has no mesh partition "
                    "spec — use vmap/chunked/buffered")
        if self.ckpt_every < 0:
            bad(f"ckpt_every must be >= 0, got {self.ckpt_every}")
        if self.ckpt_every > 0 and not self.ckpt_path:
            bad(f"ckpt_every={self.ckpt_every} needs a ckpt_path to "
                "write to")
        from repro_torch.fed import registry as reg
        if self.scheduler not in reg.SCHEDULERS:
            bad(f"unknown scheduler {self.scheduler!r}; registered "
                f"schedulers: {reg.SCHEDULERS.names()}")
        if self.use_lbgm and self.resolved_lbg_variant not in reg.LBG_STORES:
            bad(f"unknown lbg_variant {self.lbg_variant!r}; registered "
                f"lbg_stores: {reg.LBG_STORES.names()}")
        if self.compressor not in reg.COMPRESSORS:
            bad(f"unknown compressor {self.compressor!r}; registered "
                f"compressors: {reg.COMPRESSORS.names()}")
        if self.aggregator not in reg.AGGREGATORS:
            bad(f"unknown aggregator {self.aggregator!r}; registered "
                f"aggregators: {reg.AGGREGATORS.names()}")
        if self.attack is not None and self.attack not in reg.ATTACKS:
            bad(f"unknown attack {self.attack!r}; registered "
                f"attacks: {reg.ATTACKS.names()}")
        if self.codec not in reg.CODECS:
            bad(f"unknown codec {self.codec!r}; registered "
                f"codecs: {reg.CODECS.names()}")
        if self.latency not in reg.LATENCIES:
            bad(f"unknown latency {self.latency!r}; registered "
                f"latency models: {reg.LATENCIES.names()}")
        for field, kw_name, registry in (
                ("aggregator", "aggregator_kw", reg.AGGREGATORS),
                ("attack", "attack_kw", reg.ATTACKS),
                ("codec", "codec_kw", reg.CODECS),
                ("latency", "latency_kw", reg.LATENCIES)):
            comp, kw = getattr(self, field), getattr(self, kw_name)
            if comp is None or not kw:
                continue
            valid = registry.valid_kw(comp)
            if valid is None:
                continue
            unknown = sorted(set(kw) - valid)
            if unknown:
                bad(f"{kw_name} keys {unknown} are not accepted by "
                    f"{field}={comp!r}; valid keys: {sorted(valid)}")

    # ------------------------------------------------------------- views
    @property
    def resolved_lbg_variant(self) -> str:
        return _LBG_VARIANT_ALIASES.get(self.lbg_variant, self.lbg_variant)

    @property
    def mesh_shape(self) -> Optional[Tuple[int, int]]:
        if self.mesh is None:
            return None
        if isinstance(self.mesh, int):
            return (self.mesh, 1)
        return (self.mesh[0], self.mesh[1])

    @property
    def mesh_model_dim(self) -> int:
        shape = self.mesh_shape
        return 1 if shape is None else shape[1]

    def replace(self, **overrides) -> "FLConfig":
        return dataclasses.replace(self, **overrides)

    # ------------------------------------------------------ serialization
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FLConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"FLConfig: unknown fields {sorted(unknown)}; "
                f"known fields: {sorted(known)}")
        return cls(**d)

    # ------------------------------------------------- arch-config bridge
    @classmethod
    def from_lbgm(cls, lbgm, **overrides) -> "FLConfig":
        """Build from an arch-side ``configs.base.LBGMConfig`` view."""
        kw = dict(
            use_lbgm=lbgm.enabled,
            lbg_variant=lbgm.variant,
            delta_threshold=lbgm.delta_threshold,
            num_clients=lbgm.num_clients,
            tau=lbgm.local_steps,
            sample_frac=lbgm.sample_frac,
        )
        if _LBG_VARIANT_ALIASES.get(lbgm.variant, lbgm.variant) == "topk":
            kw["lbg_kw"] = {"k_frac": lbgm.k_frac}
        kw.update(overrides)
        return cls(**kw)

"""Configuration types of the PyTorch port.

``ArchConfig`` keeps the fields of ``repro.configs.base.ArchConfig`` that
the port runs, with the same defaults: the paper's FCN and CNN, and the
decoder LMs whose blocks are global attention (``attn``), sliding-window
attention (``swa``) or RWKV6 (``rwkv6``). The fields of the families the
port does not run yet (MoE, M-RoPE, vision tokens, encoder-decoder) are
kept so that such a config is refused by name. ``LBGMConfig`` is the
arch-side view of :class:`repro_torch.fed.flconfig.FLConfig`, whose shared
defaults it reads so the two cannot drift.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.fed.flconfig import FLConfig

_FL_DEFAULTS = {f.name: f.default for f in dataclasses.fields(FLConfig)}


#: block kinds the port runs; the others (``rglru``) come with a later slice
PORTED_BLOCKS = ("attn", "swa", "rwkv6")
LATER_SLICE = ("not ported yet: the port runs dense attn/swa and rwkv6 "
               "decoders; MoE, rglru, M-RoPE/vision and encoder-decoder "
               "models come with later slices of the port (ROADMAP §1, "
               "the rest of the LM stack)")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # 0 => dense FFN
    top_k: int = 1
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01   # load-balance loss coefficient


@dataclass(frozen=True)
class LBGMConfig:
    """Paper Algorithm 1 knobs — arch-side view of ``FLConfig``."""
    enabled: bool = _FL_DEFAULTS["use_lbgm"]
    variant: str = "full"           # "full" | "topk"
    delta_threshold: float = _FL_DEFAULTS["delta_threshold"]
    k_frac: float = 0.01            # for variant="topk"
    num_clients: int = 16
    local_steps: int = 1            # tau
    sample_frac: float = _FL_DEFAULTS["sample_frac"]

    def to_fl(self, **overrides) -> FLConfig:
        """The canonical engine config carrying these knobs."""
        return FLConfig.from_lbgm(self, **overrides)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                  # fcn | cnn | dense | ssm
    source: str
    n_layers: int = 2
    d_model: int = 512              # FCN hidden width / CNN base channels
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 2048
    vocab_size: int = 32768         # classes for FCN/CNN
    head_dim: int = 0               # 0 => d_model // n_heads
    moe: MoEConfig = field(default_factory=MoEConfig)
    # block pattern: tuple cycled over layers; entries "attn" (global),
    # "swa" (sliding-window attn), "rwkv6" ("rglru": a later slice)
    block_pattern: Tuple[str, ...] = ("attn",)
    sliding_window: int = 8192      # used by "swa" blocks / long-context decode
    qk_norm: bool = False
    mrope: bool = False
    encdec: bool = False
    vision_tokens: int = 0
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    dp_mode: str = "replicated"
    remat: bool = True
    lbgm: LBGMConfig = field(default_factory=LBGMConfig)
    # long-context decode policy: "swa" | "recurrent" | "skip" | "full"
    long_context: str = "swa"

    def __post_init__(self):
        unported = [k for k in self.block_pattern if k not in PORTED_BLOCKS]
        what = ([f"moe.num_experts={self.moe.num_experts}"]
                if self.moe.num_experts else []) \
            + (["mrope"] if self.mrope else []) \
            + (["encdec"] if self.encdec else []) \
            + ([f"vision_tokens={self.vision_tokens}"]
               if self.vision_tokens else []) \
            + [f"block kind {k!r}" for k in unported]
        if what:
            raise ValueError(f"{self.name}: {', '.join(what)} "
                             f"{LATER_SLICE}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def reduced(self, **overrides) -> "ArchConfig":
        """Reduced variant of the same family for CPU smoke tests (the
        JAX package's ``reduced()``, field for field)."""
        small = dict(
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 32),
            dp_mode="replicated",
            remat=False,
            dtype="float32",
            lbgm=dataclasses.replace(self.lbgm, num_clients=4),
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (embeddings + blocks + head), the JAX
    package's formula for the block kinds the port runs."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.resolved_head_dim
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    total = V * d                       # embed
    if not cfg.tie_embeddings:
        total += V * d                  # lm head
    for layer in range(cfg.n_layers):
        kind = cfg.block_kind(layer)
        if kind in ("attn", "swa"):
            total += d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
        elif kind == "rwkv6":
            # r,k,v,g,o projections + decay lora + mixing params
            total += 5 * d * d + 2 * d * 64 + 6 * d
        total += 3 * d * ff
        total += 2 * d                  # norms
    return total

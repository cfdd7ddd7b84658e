"""Configuration types of the PyTorch port.

``ArchConfig`` keeps the fields of ``repro.configs.base.ArchConfig``, with
the same defaults, for every family of the JAX package: the paper's FCN
and CNN, and the LMs whose blocks are global attention (``attn``),
sliding-window attention (``swa``), RWKV6 (``rwkv6``) or RG-LRU
(``rglru``), with a dense or MoE FFN, M-RoPE and vision tokens (qwen2-vl)
or an encoder (whisper). The JAX package's ``unroll`` (a knob of its XLA
cost pass) has no counterpart. ``LBGMConfig`` is the arch-side view of
:class:`repro_torch.fed.flconfig.FLConfig`, whose shared defaults it reads
so the two cannot drift.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.fed.flconfig import FLConfig

_FL_DEFAULTS = {f.name: f.default for f in dataclasses.fields(FLConfig)}


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
    arch_type: str                  # fcn | cnn | dense | moe | ssm | hybrid
                                    # | audio | vlm
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
    # "swa" (sliding-window attn), "rwkv6", "rglru"
    block_pattern: Tuple[str, ...] = ("attn",)
    sliding_window: int = 8192      # used by "swa" blocks / long-context decode
    qk_norm: bool = False
    mrope: bool = False             # qwen2-vl multimodal rotary
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    encdec: bool = False            # whisper-style encoder-decoder
    n_encoder_layers: int = 0
    encoder_seq: int = 1500         # whisper stub frame count
    vision_tokens: int = 0          # qwen2-vl stub patch count (prepended)
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    dp_mode: str = "replicated"
    remat: bool = True
    lbgm: LBGMConfig = field(default_factory=LBGMConfig)
    # long-context decode policy: "swa" | "recurrent" | "skip" | "full"
    long_context: str = "swa"

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
            encoder_seq=16 if self.encdec else self.encoder_seq,
            n_encoder_layers=2 if self.encdec else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            dp_mode="replicated",
            remat=False,
            dtype="float32",
            mrope_sections=(4, 6, 6) if self.mrope else self.mrope_sections,
            lbgm=dataclasses.replace(self.lbgm, num_clients=4),
        )
        if self.moe.num_experts:
            small["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4))
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
    package's formula term for term. Its rglru term (``4d + 2d^2 + 3d``)
    counts fewer params than ``init_rglru`` draws (``5d^2 + 8d``); it is
    kept as the reference writes it."""
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
        elif kind == "rglru":
            # conv4 + input/gate projections + recurrent params
            total += 4 * d + 2 * d * d + 3 * d
        if cfg.moe.num_experts and kind in ("attn", "swa"):
            total += cfg.moe.num_experts * 3 * d * ff + d * cfg.moe.num_experts
        else:
            total += 3 * d * ff
        total += 2 * d                  # norms
    if cfg.encdec:
        # encoder layers: self attn + ffn
        total += cfg.n_encoder_layers * (
            d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d + 3 * d * ff + 2 * d)
        # decoder cross-attention
        total += cfg.n_layers * (d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d + d)
    return total


def active_param_count(cfg: ArchConfig) -> int:
    """Params active per token (MoE: only top_k experts count)."""
    if not cfg.moe.num_experts:
        return param_count(cfg)
    dense = param_count(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    moe_layers = sum(1 for l in range(cfg.n_layers)
                     if cfg.block_kind(l) in ("attn", "swa"))
    inactive = moe_layers * (cfg.moe.num_experts - cfg.moe.top_k) * 3 * d * ff
    return dense - inactive

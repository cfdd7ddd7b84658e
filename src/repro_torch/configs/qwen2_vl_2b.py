"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191]

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
Vision encoder (ViT) is a STUB: models.frontends provides patch embeddings
(B, vision_tokens, d_model) consumed by the language backbone.
"""
from repro_torch.configs.base import ArchConfig, LBGMConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    source="arXiv:2409.12191",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    mrope_sections=(16, 24, 24),   # temporal/h/w sections summing to head_dim/2
    vision_tokens=256,
    block_pattern=("attn",),
    sliding_window=8192,
    dp_mode="replicated",
    lbgm=LBGMConfig(variant="full", num_clients=16),
    long_context="swa",
)

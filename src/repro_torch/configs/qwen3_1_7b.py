"""qwen3-1.7b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B]

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
Small enough for paper-faithful dense per-client LBGs.
"""
from repro_torch.configs.base import ArchConfig, LBGMConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    block_pattern=("attn",),
    sliding_window=8192,
    dp_mode="replicated",
    lbgm=LBGMConfig(variant="full", num_clients=16),
    long_context="swa",
)

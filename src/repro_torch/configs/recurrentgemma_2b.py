"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 2:1. [arXiv:2402.19427]

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.
Block pattern cycles (rglru, rglru, swa); local attention window 2048.
"""
from repro_torch.configs.base import ArchConfig, LBGMConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    source="arXiv:2402.19427",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "swa"),
    sliding_window=2048,
    dp_mode="replicated",
    lbgm=LBGMConfig(variant="full", num_clients=16),
    long_context="recurrent",
)

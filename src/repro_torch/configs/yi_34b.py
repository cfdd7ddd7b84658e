"""yi-34b [dense] — llama-arch GQA. [arXiv:2403.04652]

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
from repro_torch.configs.base import ArchConfig, LBGMConfig

CONFIG = ArchConfig(
    name="yi-34b",
    arch_type="dense",
    source="arXiv:2403.04652",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    block_pattern=("attn",),
    sliding_window=8192,
    dp_mode="fsdp",
    lbgm=LBGMConfig(variant="topk", k_frac=0.01, num_clients=16),
    long_context="swa",
)

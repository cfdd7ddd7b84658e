"""deepseek-67b [dense] — llama-arch. [arXiv:2401.02954]

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import ArchConfig, LBGMConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    arch_type="dense",
    source="arXiv:2401.02954",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    block_pattern=("attn",),
    sliding_window=8192,
    dp_mode="fsdp",
    lbgm=LBGMConfig(variant="topk", k_frac=0.01, num_clients=16),
    long_context="swa",
)

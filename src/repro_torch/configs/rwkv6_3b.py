"""rwkv6-3b [ssm] — Finch, data-dependent decay. [arXiv:2404.05892]

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
LBGM applies unchanged (gradient-space technique, model-agnostic).
"""
from repro_torch.configs.base import ArchConfig, LBGMConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    source="arXiv:2404.05892",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # rwkv6 heads = d_model / 64
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    dp_mode="replicated",
    lbgm=LBGMConfig(variant="full", num_clients=16),
    long_context="recurrent",
)

"""whisper-base [audio] — enc-dec, conv frontend (STUB). [arXiv:2212.04356]

6L d_model=512 8H (GQA kv=8) d_ff=2048 vocab=51865.
The mel-spectrogram + conv feature extractor is a stub, which
provides precomputed (B, 1500, 512) frame embeddings (models.frontends).
long_500k is SKIPPED: decoder context architecturally capped.
"""
from repro_torch.configs.base import ArchConfig, LBGMConfig

CONFIG = ArchConfig(
    name="whisper-base",
    arch_type="audio",
    source="arXiv:2212.04356",
    n_layers=6,                 # decoder layers
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    encdec=True,
    encoder_seq=1500,
    block_pattern=("attn",),
    dp_mode="replicated",
    lbgm=LBGMConfig(variant="full", num_clients=16),
    long_context="skip",
)

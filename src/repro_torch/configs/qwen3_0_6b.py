"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936. Qwen3 uses an
explicit head_dim=128 (16*128 != d_model) and RMSNorm on q/k heads.
"""
from .base import ArchConfig, dense_pattern, register

FULL = register(ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    block_pattern=dense_pattern(28),
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
))

SMOKE = register(FULL.replace(
    name="qwen3-0.6b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=24,
    d_ff=128, vocab_size=512, block_pattern=dense_pattern(2),
    vocab_pad_multiple=8, param_dtype="float32", compute_dtype="float32",
))

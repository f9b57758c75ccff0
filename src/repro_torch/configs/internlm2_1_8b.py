"""internlm2-1.8b [dense] — GQA [arXiv:2403.17297; hf]

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from .base import ArchConfig, dense_pattern, register

FULL = register(ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    block_pattern=dense_pattern(24),
    rope_theta=1_000_000.0,
))

SMOKE = register(FULL.replace(
    name="internlm2-1.8b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, block_pattern=dense_pattern(2),
    vocab_pad_multiple=8, param_dtype="float32", compute_dtype="float32",
))

"""zamba2-1.2b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; hf]

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
Mamba2 backbone with a *shared* attention+MLP block applied every 6th
layer (Zamba2 shares one transformer block's weights across its uses; we
keep that sharing — one ``hybrid_attn`` param set reused at every
occurrence). Attention uses a 4096 sliding window so the 500k-decode cell
is sub-quadratic (deviation + rationale in DESIGN.md §4).
"""
from .base import ArchConfig, hybrid_pattern, register

FULL = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    block_pattern=hybrid_pattern(38, period=6),
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    sliding_window=4096,
))

SMOKE = register(FULL.replace(
    name="zamba2-1.2b-smoke",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, block_pattern=hybrid_pattern(4, period=2),
    ssm_state=16, ssm_headdim=16, sliding_window=32,
    vocab_pad_multiple=8, param_dtype="float32", compute_dtype="float32",
))

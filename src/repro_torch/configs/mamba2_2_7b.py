"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified]

64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
expand=2 -> d_inner=5120, headdim=64 -> 80 SSD heads, 1 B/C group.
The long_500k flagship: O(S) prefill chunks, O(1) decode state.
"""
from .base import ArchConfig, register, ssm_pattern

FULL = register(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    block_pattern=ssm_pattern(64),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
))

SMOKE = register(FULL.replace(
    name="mamba2-2.7b-smoke",
    num_layers=2, d_model=64, vocab_size=512,
    block_pattern=ssm_pattern(2), ssm_state=16, ssm_headdim=16,
    ssm_chunk=16, vocab_pad_multiple=8,
    param_dtype="float32", compute_dtype="float32",
))

"""llama4-scout-17b-a16e [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts
top-1 + 1 shared expert per layer (Scout routes every layer). The
interleaved RoPE/NoPE schedule is kept as RoPE throughout (DESIGN.md §4).
"""
from .base import ArchConfig, moe_pattern, register

FULL = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=moe_pattern(48),
    num_experts=16,
    top_k=1,
    moe_d_ff=8192,
    num_shared_experts=1,
    rope_theta=500_000.0,
))

SMOKE = register(FULL.replace(
    name="llama4-scout-17b-a16e-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, moe_d_ff=96, vocab_size=512, block_pattern=moe_pattern(2),
    num_experts=4, top_k=1, num_shared_experts=1,
    moe_capacity_factor=8.0,   # no drops at smoke scale (see deepseek smoke)
    vocab_pad_multiple=8, param_dtype="float32", compute_dtype="float32",
))

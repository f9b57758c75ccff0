"""stablelm-3b [dense] — [hf:stabilityai/stablelm-2-1_6b; unverified]

32L d_model=2560 32H (GQA kv=32 == MHA) d_ff=6912 vocab=50304.
StableLM-2 family uses LayerNorm and partial-rotary attention; we keep
LayerNorm and full rotary (deviation noted in DESIGN.md §4).
"""
from .base import ArchConfig, dense_pattern, register

FULL = register(ArchConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    block_pattern=dense_pattern(32),
    norm="layernorm",
))

SMOKE = register(FULL.replace(
    name="stablelm-3b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=160, vocab_size=499, block_pattern=dense_pattern(2),
    vocab_pad_multiple=8, param_dtype="float32", compute_dtype="float32",
))

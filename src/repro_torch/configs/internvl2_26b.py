"""internvl2-26b [vlm] — InternViT + InternLM2 backbone.

[arXiv:2404.16821; hf] 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. Assignment rule: transformer BACKBONE only; the vision
frontend is a STUB — ``input_specs()`` provides precomputed patch
embeddings (256 tokens of InternViT width 3200, pixel-shuffled), projected
and prepended to the token stream (early fusion).
"""
from .base import ArchConfig, dense_pattern, register

FULL = register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    block_pattern=dense_pattern(48),
    rope_theta=1_000_000.0,
    frontend="patch_stub",
    frontend_len=256,
    frontend_dim=3200,
))

SMOKE = register(FULL.replace(
    name="internvl2-26b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=503, block_pattern=dense_pattern(2),
    frontend_len=8, frontend_dim=24, vocab_pad_multiple=8,
    param_dtype="float32", compute_dtype="float32",
))

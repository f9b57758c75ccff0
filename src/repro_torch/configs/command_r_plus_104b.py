"""command-r-plus-104b [dense] — GQA, no-bias
[hf:CohereForAI/c4ai-command-r-v01; unverified]

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000. The memory-
dominant assigned cell: 104B dense params; needs FSDP x TP (+ SP) on the
production mesh.
"""
from .base import ArchConfig, dense_pattern, register

FULL = register(ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    block_pattern=dense_pattern(64),
    use_bias=False,
    rope_theta=75_000_000.0,
))

SMOKE = register(FULL.replace(
    name="command-r-plus-104b-smoke",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=500, block_pattern=dense_pattern(2),
    vocab_pad_multiple=4, param_dtype="float32", compute_dtype="float32",
))

"""whisper-tiny [audio] — enc-dec, conv frontend (STUB) [arXiv:2212.04356]

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865. Encoder-decoder; the
mel/conv frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (1500 frames x d_model). Decode shapes run
through the decoder (cross-attending the stub-encoded audio); 6 heads are
not divisible by the 16-way model axis, so attention params fall back to
replication under the divisibility guard (sharding/partition.py) while
FFN/vocab still shard.
"""
from .base import ArchConfig, register

FULL = register(ArchConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    block_pattern=("xattn",) * 4,   # decoder blocks cross-attend the encoder
    norm="layernorm",
    frontend="audio_stub",
    frontend_len=1500,
    frontend_dim=384,
))

SMOKE = register(FULL.replace(
    name="whisper-tiny-smoke",
    num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
    block_pattern=("xattn",) * 2, frontend_len=12, frontend_dim=64,
    vocab_pad_multiple=8, param_dtype="float32", compute_dtype="float32",
))

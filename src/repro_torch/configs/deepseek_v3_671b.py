"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8
[arXiv:2412.19437; hf]

61L d_model=7168 128H d_ff=2048 (routed-expert width; the 3 leading dense
layers use the model's 18432 FFN) vocab=129280, MoE 256e top-8. MLA:
q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128 — the latent KV
cache (512+64 per token) is the serving win; decode uses the absorbed
formulation (models/attention.py). MTP (depth-1 multi-token prediction)
is available as ``train.mtp`` but off by default (DESIGN.md §4).
"""
from .base import ArchConfig, moe_pattern, register

FULL = register(ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,   # assignment lists kv=128; MLA has no separate KV heads
    head_dim=128,
    d_ff=18432,         # dense-layer FFN (first 3 layers)
    vocab_size=129280,
    block_pattern=moe_pattern(61, first_dense=3),
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=256,
    top_k=8,
    moe_d_ff=2048,
    num_shared_experts=1,
))

SMOKE = register(FULL.replace(
    name="deepseek-v3-671b-smoke",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=160, moe_d_ff=64, vocab_size=512,
    block_pattern=moe_pattern(3, first_dense=1),
    q_lora_rank=32, kv_lora_rank=24, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, num_experts=8, top_k=2, num_shared_experts=1,
    moe_capacity_factor=8.0,   # no token drops at smoke scale: keeps
    vocab_pad_multiple=8,      # prefill/decode bit-equivalent in tests
    param_dtype="float32", compute_dtype="float32",
))

"""Architecture + shape configuration registry (a copy of ``repro``'s).

One ``ArchConfig`` per assigned architecture (exact figures from the
assignment table; ``[source]`` notes in each arch file) plus reduced smoke
variants. Shapes are the assignment's four input-shape cells; skip rules
(sub-quadratic requirement for ``long_500k``) are encoded here and
surfaced by the dry-run/roofline reports.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

_REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # block kinds per layer; built by helpers below
    block_pattern: Tuple[str, ...] = ()

    # normalization / misc
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # attention
    attention: str = "gqa"          # gqa | mla
    sliding_window: int = 0         # 0 = full causal
    # chunked online-softmax attention (flash-style, plain torch): never
    # materializes (S, T) scores — KV streamed in `attn_chunk` blocks.
    # 0 = off (dense scores). §Perf lever for 32k+ prefill cells.
    attn_chunk: int = 0
    # MLA (DeepSeek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-4
    moe_combine: str = "scatter"    # scatter (EP-friendly) | gather

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # encoder-decoder / modality frontend (STUB per assignment)
    encoder_layers: int = 0
    frontend: str = "none"          # none | audio_stub | patch_stub
    frontend_len: int = 0           # precomputed frames / patches
    frontend_dim: int = 0           # stub embedding dim

    # dtypes / padding
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    # ``remat`` is the activation rematerialisation of a training step
    # (``models/lm.py`` applies it through ``torch.utils.checkpoint``);
    # ``scan_stages`` is the reference's compile knob (scanned vs
    # unrolled stages), which the port's layer loop ignores; it stays so
    # that a config means the same in both packages.
    remat: str = "full"             # full | dots | none
    scan_stages: bool = True

    # ------------------------------------------------------------------ #
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def stages(self) -> Tuple[Tuple[str, int], ...]:
        """Run-length encoded block pattern -> scan stages."""
        out = []
        for kind in self.block_pattern:
            if out and out[-1][0] == kind:
                out[-1][1] += 1
            else:
                out.append([kind, 1])
        return tuple((k, n) for k, n in out)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k: SSM-only, or attention under a sliding
        window (zamba2). Full-attention kinds: attn/moe/xattn/hybrid."""
        kinds = set(self.block_pattern)
        quad = {"attn", "moe", "xattn", "hybrid_attn"} & kinds
        return (not quad) or (self.sliding_window > 0)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper via its decoder)

    def dtype(self, what: str = "param") -> torch.dtype:
        name = self.param_dtype if what == "param" else self.compute_dtype
        return getattr(torch, name)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ------------------------------------------------------------------ #
def dense_pattern(n: int) -> Tuple[str, ...]:
    return ("attn",) * n


def moe_pattern(n: int, first_dense: int = 0) -> Tuple[str, ...]:
    return ("attn",) * first_dense + ("moe",) * (n - first_dense)


def ssm_pattern(n: int) -> Tuple[str, ...]:
    return ("ssm",) * n


def hybrid_pattern(n: int, period: int = 6) -> Tuple[str, ...]:
    """Zamba-style: shared attention block every ``period`` layers."""
    out = []
    for i in range(n):
        out.append("hybrid_attn" if (i % period) == (period - 1) else "ssm")
    return tuple(out)


# ------------------------------------------------------------------ #
@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def cell_supported(cfg: ArchConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """(supported, reason-if-skipped) per assignment skip rules."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("pure full-attention arch: 500k dense decode is not "
                       "sub-quadratic (assignment skip rule; DESIGN.md §4)")
    return True, ""


# ------------------------------------------------------------------ #
def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401 — populates _REGISTRY
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401 — populates _REGISTRY
    return tuple(sorted(_REGISTRY))

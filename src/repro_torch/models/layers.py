"""Shared neural layers: norms, RoPE, MLPs, embeddings
(``repro.models.layers`` in plain torch ops, the same math)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.partition import constrain, shard_range
from .builder import Builder

f32 = torch.float32


# ------------------------------------------------------------------ #
# Norms
# ------------------------------------------------------------------ #
def init_norm(b: Builder, cfg: ArchConfig, name: str, dim: int,
              stack: Optional[int] = None):
    st = (stack,) if stack else ()
    sta = ("layers",) if stack else ()
    with b.scope(name):
        b.param("scale", st + (dim,), sta + (None,), init="ones")
        if cfg.norm == "layernorm":
            b.param("bias", st + (dim,), sta + (None,), init="zeros")


def apply_norm(p, x: torch.Tensor, cfg: ArchConfig, eps: float = 1e-5
               ) -> torch.Tensor:
    xf = x.to(f32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(f32) + p["bias"].to(f32)
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].to(f32)
    return y.to(x.dtype)


def rms_norm_heads(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
                   ) -> torch.Tensor:
    """qk-norm: RMSNorm over the head_dim of (B, S, H, dh)."""
    xf = x.to(f32)
    var = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(f32)).to(x.dtype)


# ------------------------------------------------------------------ #
# RoPE
# ------------------------------------------------------------------ #
def rope_angles(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., S) int positions -> cos/sin of shape (..., S, dim/2), f32."""
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=f32,
                                    device=positions.device) / half)
    ang = positions.to(f32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, dh); cos/sin: (B, S, dh/2). Half-split convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    c = cos[:, :, None, :].to(f32)
    s = sin[:, :, None, :].to(f32)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------ #
# Dense + MLP
# ------------------------------------------------------------------ #
def init_linear(b: Builder, cfg: ArchConfig, name: str, d_in: int,
                d_out: int, axes: Tuple, stack: Optional[int] = None,
                scale: float = 1.0):
    st = (stack,) if stack else ()
    sta = ("layers",) if stack else ()
    with b.scope(name):
        b.param("w", st + (d_in, d_out), sta + tuple(axes), scale=scale)
        if cfg.use_bias:
            bias_axes = (axes[-1],) if axes[-1] in ("heads", "kv", "ff",
                                                    "vocab") else (None,)
            b.param("b", st + (d_out,), sta + bias_axes, init="zeros")


def apply_linear(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_mlp(b: Builder, cfg: ArchConfig, d_ff: int,
             stack: Optional[int] = None, name: str = "mlp"):
    """SwiGLU (gate/up/down)."""
    d = cfg.d_model
    with b.scope(name):
        init_linear(b, cfg, "gate", d, d_ff, ("fsdp", "ff"), stack)
        init_linear(b, cfg, "up", d, d_ff, ("fsdp", "ff"), stack)
        init_linear(b, cfg, "down", d_ff, d, ("ff", "fsdp"), stack)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it: the logistic expanded to
    ``1 / (1 + exp(-x))``, each step and the product rounded to ``x``'s
    dtype. (``F.silu`` rounds once; in bfloat16 a third of its values
    differ by an ulp.)"""
    return x * (1 / (1 + torch.exp(-x)))


def apply_mlp(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    g = silu(apply_linear(p["gate"], x, cfg))
    u = apply_linear(p["up"], x, cfg)
    return apply_linear(p["down"], g * u, cfg)


# ------------------------------------------------------------------ #
# Embeddings / unembedding
# ------------------------------------------------------------------ #
def init_embeddings(b: Builder, cfg: ArchConfig):
    V = cfg.padded_vocab
    b.param("embed", (V, cfg.d_model), ("vocab", "embed"), init="normal",
            scale=1.0)
    if not cfg.tie_embeddings:
        b.param("unembed", (cfg.d_model, V), ("embed", "vocab"))
    if cfg.frontend != "none":
        init_linear(b, cfg, "frontend_proj", cfg.frontend_dim, cfg.d_model,
                    ("fsdp", "embed"))


def embed_tokens(params, tokens: torch.Tensor, cfg: ArchConfig
                 ) -> torch.Tensor:
    # gather, then cast: the same values as casting the whole table first
    x = _lookup(params["embed"], tokens).to(cfg.dtype("compute"))
    return constrain(x, ("act_batch", None, None))


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.

    On a DTensor table split over its rows (the vocabulary), DTensor's
    strategy for the gather's backward (``index_put``) fails on some
    torch versions, so each rank looks up the tokens inside its slice of
    rows (zero elsewhere) on its local shard: a partial sum over the
    axes that split the rows, which the caller's ``constrain`` reduces.
    The tokens are whole on those axes; the table's gradient is a
    partial sum on the axes that split the tokens."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    row_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in table.placements]
    table = table.redistribute(mesh, row_pl)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok_pl = [Replicate() if isinstance(p, Shard) else q
              for p, q in zip(row_pl, tokens.placements)]
    tokens = tokens.redistribute(mesh, tok_pl)
    lo, size = shard_range(table, 0)
    grad_pl = [Partial() if isinstance(p, Replicate) and isinstance(q, Shard)
               else p for p, q in zip(row_pl, tok_pl)]
    idx = tokens.to_local() - lo
    inside = (idx >= 0) & (idx < size)
    rows = table.to_local(grad_placements=grad_pl)[idx.clamp(0, size - 1)]
    out_pl = [Partial() if isinstance(p, Shard) else q
              for p, q in zip(row_pl, tok_pl)]
    return DTensor.from_local(rows * inside[..., None], mesh, out_pl,
                              run_check=False)


def unembed(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    # the sequence whole on each rank, so that the product splits over
    # the vocabulary (on a mesh; the identity elsewhere)
    x = constrain(x, ("act_batch", None, None))
    if cfg.tie_embeddings:
        w = params["embed"].to(x.dtype).T
    else:
        w = params["unembed"].to(x.dtype)
    logits = torch.matmul(x, w)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    # mask padded vocab tail
    V = cfg.padded_vocab
    if V != cfg.vocab_size:
        neg = torch.finfo(logits.dtype).min
        mask = torch.arange(V, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, neg)
    return logits

"""Attention variants: GQA (+qk-norm, sliding window) and MLA (DeepSeek
latent attention with absorbed decode), plus cross-attention for enc-dec
(``repro.models.attention`` in plain torch ops, the same math).

Cache layouts (serve path):
  GQA   : {"k": (B, T, K, dh), "v": (B, T, K, dh)}         T = max seq
  MLA   : {"ckv": (B, T, kv_lora), "krope": (B, T, dr)}    latent cache

Differences from the reference: a cache is written in place (the
counterpart of the reference's donated cache), and a write past the
cache's length ``T`` raises ``ValueError`` where ``lax.dynamic_update_slice``
clamps the start index and overwrites the last slots.

Where the reference contracts with ``preferred_element_type=float32``, the
port upcasts both operands to float32 first: the products of the
compute-dtype values, accumulated in float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.partition import (local_apply, on_shards,
                                            regroup, shard_range,
                                            whole_pieces)
from .builder import Builder
from .layers import (apply_linear, apply_rope, init_linear, rms_norm_heads,
                     rope_angles)

NEG = -1e30
f32 = torch.float32


# ------------------------------------------------------------------ #
# GQA
# ------------------------------------------------------------------ #
def init_gqa(b: Builder, cfg: ArchConfig, stack: Optional[int] = None,
             name: str = "attn", cross: bool = False):
    d, H, K, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    st = (stack,) if stack else ()
    sta = ("layers",) if stack else ()
    with b.scope(name):
        init_linear(b, cfg, "wq", d, H * dh, ("fsdp", "heads"), stack)
        init_linear(b, cfg, "wk", d, K * dh, ("fsdp", "kv"), stack)
        init_linear(b, cfg, "wv", d, K * dh, ("fsdp", "kv"), stack)
        init_linear(b, cfg, "wo", H * dh, d, ("heads", "fsdp"), stack)
        if cfg.qk_norm and not cross:
            b.param("q_norm", st + (dh,), sta + (None,), init="ones")
            b.param("k_norm", st + (dh,), sta + (None,), init="ones")


def _split_heads(x, n, dh):
    x = whole_pieces(x, -1, n)
    return regroup(x, *x.shape[:-1], n, dh)


def _repeat_kv(x, G: int):
    """(B, T, K, dh) -> (B, T, K*G, dh), head h reading kv head h // G
    (``jnp.repeat(x, G, axis=2)``). On a mesh each rank repeats its own
    kv heads: its query heads are theirs' groups."""
    if G == 1:
        return x
    return on_shards(lambda t: t.repeat_interleave(G, dim=2), x)


_HEADS = ("act_batch", None, "act_heads", None)


def _attend_mha(q, k, v, mask):
    """Full attention (train/prefill). q/k/v: (B,S|T,H,dh), KV already
    repeated to H heads; ``mask`` broadcasts against (B,H,S,T). On a mesh
    each rank attends its batch rows and heads (``_HEADS``, the
    reference's constraint), on local shards."""
    return local_apply(_mha_local, (q, k, v, mask),
                       (_HEADS, _HEADS, _HEADS, None))


def _mha_local(q, k, v, mask):
    dh = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q.to(f32), k.to(f32))
    scores = scores / math.sqrt(dh)
    w = torch.softmax(torch.where(mask, scores, NEG), dim=-1)
    return torch.einsum("bhst,bthd->bshd", w.to(q.dtype), v)


def _attend_mha_chunked(q, k, v, chunk: int, window: int,
                        q_offset: int = 0):
    """Flash-style attention: KV streamed in chunks with an online
    softmax; peak score memory is (B, H, S, chunk) instead of
    (B, H, S, T). The reference's ``lax.scan`` over chunks is a loop here.
    On a mesh, on local shards as :func:`_attend_mha`.

    Causality from position math (q_pos = q_offset + i): no (S, T) mask
    tensor exists anywhere."""
    return local_apply(
        lambda q, k, v: _chunked_local(q, k, v, chunk, window, q_offset),
        (q, k, v), (_HEADS, _HEADS, _HEADS))


def _chunked_local(q, k, v, chunk: int, window: int, q_offset: int):
    B, S, H, dh = q.shape
    T = k.shape[1]
    if T % chunk:
        raise ValueError(f"cache length {T} is not a multiple of the "
                         f"chunk {chunk}")
    dev = q.device
    scale = 1.0 / math.sqrt(dh)
    qf = q.to(f32)
    qpos = q_offset + torch.arange(S, device=dev)[:, None]      # (S, 1)
    m = torch.full((B, H, S), NEG, dtype=f32, device=dev)
    l = torch.zeros((B, H, S), dtype=f32, device=dev)
    acc = torch.zeros((B, S, H, dh), dtype=f32, device=dev)
    for j in range(T // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        kpos = j * chunk + torch.arange(chunk, device=dev)[None, :]
        ok = kpos <= qpos                                       # (S, chunk)
        if window:
            ok &= kpos > qpos - window
        s_j = torch.einsum("bshd,bthd->bhst", qf, kj.to(f32)) * scale
        s_j = torch.where(ok, s_j, NEG)
        m_new = torch.maximum(m, s_j.amax(-1))                  # (B,H,S)
        p = torch.exp(s_j - m_new[..., None])                   # (B,H,S,c)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhst,bthd->bshd", p.to(q.dtype).to(f32),
                          vj.to(f32))
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
    return out.to(q.dtype)


def _attend_grouped(q, k, v, mask):
    """Grouped decode attention: q (B,S,K,G,dh) vs the K-head cache
    (B,T,K,dh). On a mesh that splits the cache's length (``cache_seq``)
    each rank attends its slice of positions and the slices combine by
    their softmax statistics (:func:`_attend_grouped_split`)."""
    if isinstance(k, DTensor):
        return _attend_grouped_split(q, k, v, mask)
    dh = q.shape[-1]
    scores = torch.einsum("bskgd,btkd->bkgst", q.to(f32), k.to(f32))
    scores = scores / math.sqrt(dh)
    w = torch.softmax(torch.where(mask, scores, NEG), dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", w.to(q.dtype), v)


def _attend_grouped_split(q, k, v, mask):
    """:func:`_attend_grouped` over a cache whose length is split across
    mesh axes, as split decoding does it: each rank scores its positions,
    the running max and the softmax denominator are all-reduced (max,
    sum) over the axes that split the length, and each rank's weighted
    values are all-reduced (sum). The query and the cache are batch-split
    alike; the result is batch-split and whole elsewhere. Serving only
    (no autograd through the collectives)."""
    from torch.distributed import _functional_collectives as funcol
    mesh, pl = k.device_mesh, k.placements
    split = [d for d, p in enumerate(pl) if isinstance(p, Shard)
             and p.dim == 1]
    batch_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in pl]
    kv_pl = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
             for p in pl]
    k_l = k.redistribute(mesh, kv_pl).to_local()
    v_l = v.redistribute(mesh, kv_pl).to_local()
    q_l = q.redistribute(mesh, batch_pl).to_local()
    lo, size = shard_range(k, 1)
    m_l = mask[..., lo:lo + size] if mask.shape[-1] > 1 else mask

    def reduce(t, op):
        for d in split:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, d)))
        return t

    dh = q_l.shape[-1]
    scores = torch.einsum("bskgd,btkd->bkgst", q_l.to(f32), k_l.to(f32))
    scores = torch.where(m_l, scores / math.sqrt(dh), NEG)
    top = reduce(scores.amax(-1, keepdim=True), "max")
    e = torch.exp(scores - top)
    w = e / reduce(e.sum(-1, keepdim=True), "sum")
    ctx = reduce(torch.einsum("bkgst,btkd->bskgd", w.to(q_l.dtype), v_l),
                 "sum")
    return DTensor.from_local(ctx, mesh, batch_pl, run_check=False)


def _causal_mask(S, T, offset, window, device=None):
    """(S, T) bool: query i (at absolute pos offset+i) sees key j<=pos and
    within the sliding window when set."""
    qpos = offset + torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def _check_write(what: str, start: int, n: int, T: int) -> None:
    """A cache write of ``n`` positions at ``start`` must fit in ``T``."""
    if start < 0 or start + n > T:
        raise ValueError(f"{what}: positions {start}..{start + n - 1} do "
                         f"not fit a cache of length {T}")


def _write_cache(buf: torch.Tensor, start: int, value: torch.Tensor
                 ) -> None:
    """``buf[:, start:start + n] = value`` in place, ``n = value.shape[1]``.

    On a DTensor whose length (dim 1, ``cache_seq``) is split over the
    mesh, slicing that dimension would redistribute into a temporary and
    the write would be lost. So ``value`` is redistributed to the cache's
    placements with its length whole (an explicit collective), and each
    rank writes the positions it owns into its local shard."""
    n = value.shape[1]
    if not isinstance(buf, DTensor):
        buf[:, start:start + n] = value
        return
    mesh, placements = buf.device_mesh, buf.placements
    whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
             for p in placements]
    v = value.redistribute(mesh, whole).to_local()
    local = buf.to_local()
    lo_own, size = shard_range(buf, 1)
    lo, hi = max(start, lo_own), min(start + n, lo_own + size)
    if lo < hi:
        local[:, lo - lo_own:hi - lo_own] = v[:, lo - start:hi - start]


def apply_gqa(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
              cache: Optional[Dict] = None, pos: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full (train/prefill) when ``cache is None`` or ``pos is None``;
    single-step decode when ``cache`` is given with an int ``pos``. The
    cache is written in place and returned."""
    B, S, d = x.shape
    H, K, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    G = H // K
    q = _split_heads(apply_linear(p["wq"], x, cfg), H, dh)
    k = _split_heads(apply_linear(p["wk"], x, cfg), K, dh)
    v = _split_heads(apply_linear(p["wv"], x, cfg), K, dh)
    if cfg.qk_norm:
        q = rms_norm_heads(p["q_norm"], q)
        k = rms_norm_heads(p["k_norm"], k)
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    def _full(qh, kh, vh, T):
        if cfg.attn_chunk and T > cfg.attn_chunk and T % cfg.attn_chunk == 0:
            return _attend_mha_chunked(qh, kh, vh, cfg.attn_chunk,
                                       cfg.sliding_window)
        mask = _causal_mask(S, T, 0, cfg.sliding_window, x.device)
        return _attend_mha(qh, kh, vh, mask[None, None])

    if cache is None:
        ctx = _full(q, _repeat_kv(k, G), _repeat_kv(v, G), S)
    elif pos is None:
        # prefill into a fresh cache of length T >= S
        T = cache["k"].shape[1]
        _check_write("prefill", 0, S, T)
        _write_cache(cache["k"], 0, k)
        _write_cache(cache["v"], 0, v)
        ctx = _full(q, _repeat_kv(cache["k"], G), _repeat_kv(cache["v"], G),
                    T)
    else:
        # decode: S == 1 at absolute position ``pos``; grouped form, the
        # cache keeps K heads
        T = cache["k"].shape[1]
        _check_write("decode", pos, S, T)
        _write_cache(cache["k"], pos, k)
        _write_cache(cache["v"], pos, v)
        kpos = torch.arange(T, device=x.device)
        m = kpos <= pos
        if cfg.sliding_window:
            m &= kpos > pos - cfg.sliding_window
        q = whole_pieces(q, 2, K)      # H heads regrouped as (K, G)
        ctx = _attend_grouped(regroup(q, B, S, K, G, dh), cache["k"],
                              cache["v"], m)   # m broadcasts over (..., T)
        ctx = regroup(ctx, B, S, H, dh)
    out = apply_linear(p["wo"], regroup(ctx, B, S, H * dh), cfg)
    return out, cache


# ------------------------------------------------------------------ #
# Cross-attention (enc-dec)
# ------------------------------------------------------------------ #
def apply_cross_attn(p, x: torch.Tensor, cfg: ArchConfig,
                     enc_kv: Tuple[torch.Tensor, torch.Tensor]
                     ) -> torch.Tensor:
    """x: (B,S,d) decoder; enc_kv: precomputed (k, v) (B,T,K,dh)."""
    B, S, _ = x.shape
    H, K, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = _split_heads(apply_linear(p["wq"], x, cfg), H, dh)
    k, v = enc_kv
    G = H // K
    mask = torch.ones((1, 1, 1, k.shape[1]), dtype=torch.bool,
                      device=x.device)
    ctx = _attend_mha(q, _repeat_kv(k, G), _repeat_kv(v, G), mask)
    return apply_linear(p["wo"], regroup(ctx, B, S, H * dh), cfg)


def encoder_kv(p, enc_out: torch.Tensor, cfg: ArchConfig):
    K, dh = cfg.num_kv_heads, cfg.head_dim_
    k = _split_heads(apply_linear(p["wk"], enc_out, cfg), K, dh)
    v = _split_heads(apply_linear(p["wv"], enc_out, cfg), K, dh)
    return k, v


# ------------------------------------------------------------------ #
# MLA (DeepSeek-V3)
# ------------------------------------------------------------------ #
def init_mla(b: Builder, cfg: ArchConfig, stack: Optional[int] = None,
             name: str = "attn"):
    d, H = cfg.d_model, cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    st = (stack,) if stack else ()
    sta = ("layers",) if stack else ()
    with b.scope(name):
        init_linear(b, cfg, "wq_a", d, ql, ("fsdp", "lora"), stack)
        b.param("q_ln", st + (ql,), sta + (None,), init="ones")
        init_linear(b, cfg, "wq_b", ql, H * (dn + dr), ("lora", "heads"),
                    stack)
        init_linear(b, cfg, "wkv_a", d, kl + dr, ("fsdp", "lora"), stack)
        b.param("kv_ln", st + (kl,), sta + (None,), init="ones")
        b.param("wk_b", st + (kl, H, dn), sta + ("lora", "heads", None))
        b.param("wv_b", st + (kl, H, dv), sta + ("lora", "heads", None))
        init_linear(b, cfg, "wo", H * dv, d, ("heads", "fsdp"), stack)


def _mla_qkv(p, x, cfg, positions):
    """Shared q / latent computation. Returns q_nope (B,S,H,dn),
    q_rope (B,S,H,dr), ckv (B,S,kl), krope (B,S,dr)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    kl = cfg.kv_lora_rank
    cq = apply_linear(p["wq_a"], x, cfg)
    cq = rms_norm_heads(p["q_ln"], cq)
    q = _split_heads(apply_linear(p["wq_b"], cq, cfg), H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv = apply_linear(p["wkv_a"], x, cfg)
    ckv, krope = kv[..., :kl], kv[..., kl:]
    ckv = rms_norm_heads(p["kv_ln"], ckv)
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    krope = apply_rope(krope[:, :, None, :], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, ckv, krope


def _mla_local(q_nope, k_nope, v, q_rope, krope, scale):
    """MLA's causal attention over materialised per-head K/V, on one
    rank's batch rows and heads."""
    S = q_nope.shape[1]
    s_nope = torch.einsum("bshn,bthn->bhst", q_nope.to(f32), k_nope.to(f32))
    s_rope = torch.einsum("bshr,btr->bhst", q_rope.to(f32), krope.to(f32))
    mask = _causal_mask(S, S, 0, 0, q_nope.device)
    scores = torch.where(mask, (s_nope + s_rope) * scale, NEG)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthv->bshv", w, v)


def apply_mla(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
              cache: Optional[Dict] = None, pos: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Prefill/train: materialised K/V per head. Decode: absorbed scores
    against the latent cache ((kv_lora + rope_dim) per token instead of
    2*H*dh)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope, ckv, krope = _mla_qkv(p, x, cfg, positions)
    scale = 1.0 / math.sqrt(dn + dr)

    if cache is not None and pos is not None:
        # ---- absorbed decode ----
        T = cache["ckv"].shape[1]
        _check_write("decode", pos, S, T)
        _write_cache(cache["ckv"], pos, ckv)
        _write_cache(cache["krope"], pos, krope)
        ckv_c, kr_c = cache["ckv"], cache["krope"]
        # q absorbed into latent space: (B,S,H,dn) x (kl,H,dn) -> (B,S,H,kl)
        q_abs = torch.einsum("bshn,khn->bshk", q_nope,
                             p["wk_b"].to(x.dtype))
        s_nope = torch.einsum("bshk,btk->bhst", q_abs.to(f32),
                              ckv_c.to(f32))
        s_rope = torch.einsum("bshr,btr->bhst", q_rope.to(f32),
                              kr_c.to(f32))
        mask = torch.arange(T, device=x.device) <= pos
        scores = torch.where(mask, (s_nope + s_rope) * scale, NEG)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx_lat = torch.einsum("bhst,btk->bshk", w, ckv_c)
        ctx = torch.einsum("bshk,khv->bshv", ctx_lat,
                           p["wv_b"].to(x.dtype))
    else:
        # ---- train / prefill: materialise per-head K, V ----
        k_nope = torch.einsum("btk,khn->bthn", ckv, p["wk_b"].to(x.dtype))
        v = torch.einsum("btk,khv->bthv", ckv, p["wv_b"].to(x.dtype))
        ctx = local_apply(
            lambda qn, kn, v, qr, kr: _mla_local(qn, kn, v, qr, kr, scale),
            (q_nope, k_nope, v, q_rope, krope),
            (_HEADS, _HEADS, _HEADS, _HEADS, ("act_batch", None, None)),
            out_like=2)
        if cache is not None:
            T = cache["ckv"].shape[1]
            _check_write("prefill", 0, S, T)
            _write_cache(cache["ckv"], 0, ckv)
            _write_cache(cache["krope"], 0, krope)
    out = apply_linear(p["wo"], regroup(ctx, B, S, H * dv), cfg)
    return out, cache

"""Mamba2 block — SSD (state-space duality) with chunked scan
(``repro.models.ssm`` in plain torch ops, the same math).

Train/prefill: the sequence is split into chunks of length Q; the
intra-chunk term is a masked (Q x Q) attention-like einsum, the
inter-chunk term a loop carrying the (H, P, N) state (the reference's
``lax.scan``). Decode: O(1) recurrent state update in float32.

State layout: x heads (B,S,H,P) with P = headdim; B/C projections per
group (B,S,G,N) broadcast over H//G heads; scalar decay per head.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.partition import local_apply
from .builder import Builder
from .layers import silu

f32 = torch.float32


def _dims(cfg: ArchConfig):
    di = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_headdim
    G = cfg.ssm_groups
    N = cfg.ssm_state
    return di, H, P, G, N


def init_mamba2(b: Builder, cfg: ArchConfig, stack: Optional[int] = None,
                name: str = "ssm"):
    d = cfg.d_model
    di, H, P, G, N = _dims(cfg)
    dconv = di + 2 * G * N
    st = (stack,) if stack else ()
    sta = ("layers",) if stack else ()
    with b.scope(name):
        b.param("in_proj", st + (d, 2 * di + 2 * G * N + H),
                sta + ("fsdp", "ff"))
        b.param("conv_w", st + (cfg.ssm_conv, dconv), sta + (None, "ff"))
        b.param("conv_b", st + (dconv,), sta + ("ff",), init="zeros")
        b.param("dt_bias", st + (H,), sta + (None,), init="zeros")
        b.param("A_log", st + (H,), sta + (None,), init="normal", scale=0.5)
        b.param("D", st + (H,), sta + (None,), init="ones")
        b.param("norm_w", st + (di,), sta + (None,), init="ones")
        b.param("out_proj", st + (di, d), sta + ("ff", "fsdp"))


def _split_in(zxbcdt, cfg: ArchConfig):
    di, H, P, G, N = _dims(cfg)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * G * N]
    dt = zxbcdt[..., -H:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, width W. xbc: (B,S,C); w: (W,C).
    Returns (out, new_state) with state = last W-1 inputs."""
    W = w.shape[0]
    B, S, C = xbc.shape
    if state is None:
        state = xbc.new_zeros((B, W - 1, C))
    xext = torch.cat([state, xbc], dim=1)              # (B, S+W-1, C)
    out = xbc.new_zeros((B, S, C))
    for i in range(W):
        out = out + xext[:, i:i + S, :] * w[i][None, None, :]
    out = out + bias[None, None, :]
    new_state = xext[:, -(W - 1):, :] if W > 1 else state
    return silu(out), new_state


def _mm(x: torch.Tensor, mm_dtype) -> torch.Tensor:
    """An operand of a float32-accumulated contraction in ``mm_dtype``:
    rounded to it, then widened."""
    return x.to(mm_dtype).to(f32)


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, mm_dtype=f32):
    """SSD over chunks. xh: (b,S,H,P); dt: (b,S,H) (post-softplus);
    A: (H,) negative; Bm/Cm: (b,S,G,N). Returns (y, final_state).

    ``mm_dtype``: dtype of the intra-chunk matmuls' operands and their
    (Q x Q) intermediates (the compute dtype); decay cumsums stay f32,
    accumulation is f32."""
    b, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = chunk
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {Q}")
    nc = S // Q

    xc = xh.reshape(b, nc, Q, H, P)
    dtc = dt.reshape(b, nc, Q, H).to(f32)
    Bh = Bm.reshape(b, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Ch = Cm.reshape(b, nc, Q, G, N).repeat_interleave(rep, dim=3)

    dA = dtc * A.to(f32)[None, None, None, :]           # (b,nc,Q,H) <= 0
    cum = torch.cumsum(dA, dim=2)                       # inclusive

    # intra-chunk (quadratic within Q only)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,Q,Q,H)
    ar = torch.arange(Q, device=xh.device)
    mask = ar[:, None] >= ar[None, :]
    # mask BEFORE the exp: above-diagonal diff is positive and can overflow
    # to +inf
    diff = torch.where(mask[None, None, :, :, None], diff, -torch.inf)
    LL = torch.exp(diff).to(mm_dtype)
    scores = torch.einsum("bnqhi,bnkhi->bnqkh", _mm(Ch, mm_dtype),
                          _mm(Bh, mm_dtype)).to(mm_dtype)
    M = scores * LL * dtc[:, :, None, :, :].to(mm_dtype)
    y_intra = torch.einsum("bnqkh,bnkhp->bnqhp", M.to(f32),
                           _mm(xc, mm_dtype))

    # per-chunk end states
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)      # (b,nc,Q,H)
    wgt = (dtc * decay_end).to(mm_dtype)                # (b,nc,Q,H)
    state_c = torch.einsum("bnkh,bnkhi,bnkhp->bnhpi", wgt.to(f32),
                           _mm(Bh, mm_dtype), _mm(xc, mm_dtype))

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (b,nc,H)
    h = torch.zeros((b, H, P, N), dtype=f32, device=xh.device)
    h_prevs = []
    for n in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, n, :, None, None] + state_c[:, n]
    h_prevs = torch.stack(h_prevs, dim=1)               # (b,nc,H,P,N)

    y_inter = torch.einsum(
        "bnqhi,bnhpi->bnqhp",
        _mm(Ch.to(f32) * torch.exp(cum)[..., None], mm_dtype),
        _mm(h_prevs, mm_dtype))
    y = (y_intra + y_inter).reshape(b, S, H, P)
    return y.to(xh.dtype), h


def apply_mamba2(p, x: torch.Tensor, cfg: ArchConfig,
                 cache: Optional[Dict] = None, pos: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """cache = {"conv": (B, W-1, dconv), "state": (B,H,P,N)}, updated in
    place; decode when ``pos`` is given (S must be 1).

    On a mesh the projections split over ``model`` as ``ff`` says, and
    the conv, the scan and the gated norm run on each rank's batch rows
    with the inner width whole (:func:`local_apply`: the scan's einsums
    over split dimensions have no dependable DTensor strategy)."""
    B, S, d = x.shape
    cdt = x.dtype
    if cache is not None and pos is not None and S != 1:
        raise ValueError(f"an SSM decode step takes one token, not {S}")
    zxbcdt = torch.matmul(x, p["in_proj"].to(cdt))
    rows = ("act_batch", None, None)
    whole = lambda t: (None,) * t.ndim  # noqa: E731
    params = [p[k] for k in ("A_log", "dt_bias", "conv_w", "conv_b", "D",
                             "norm_w")]
    args = [zxbcdt] + params
    axes = [rows] + [whole(t) for t in params]
    decode = cache is not None and pos is not None
    if decode:
        args += [cache["conv"], cache["state"]]
        axes += [rows, ("act_batch", None, None, None)]
    yn, conv_state, h = local_apply(
        lambda *a: _mamba2_core(cfg, decode, *a), args, axes)
    if cache is not None:
        for key, new in (("conv", conv_state), ("state", h)):
            if isinstance(cache[key], DTensor):
                new = new.redistribute(cache[key].device_mesh,
                                       cache[key].placements)
            cache[key].copy_(new)
    out = torch.matmul(yn, p["out_proj"].to(cdt))
    return out, cache


def _mamba2_core(cfg, decode, zxbcdt, A_log, dt_bias, conv_w, conv_b, D,
                 norm_w, conv_cache=None, state=None):
    """The conv, the scan and the gated RMSNorm of :func:`apply_mamba2`:
    (normed y (B,S,di) in the compute dtype, new conv state, new SSM
    state)."""
    B, S = zxbcdt.shape[:2]
    di, H, P, G, N = _dims(cfg)
    cdt = zxbcdt.dtype
    z, xbc, dt = _split_in(zxbcdt, cfg)
    A = -torch.exp(A_log.to(f32))
    dt = F.softplus(dt.to(f32) + dt_bias.to(f32))

    if decode:
        # ---- decode: O(1) state update ----
        xbc_act, conv_state = _causal_conv(
            xbc, conv_w.to(cdt), conv_b.to(cdt), conv_cache)
        xh = xbc_act[..., :di].reshape(B, 1, H, P).to(f32)
        Bm = xbc_act[..., di:di + G * N].reshape(B, 1, G, N)
        Cm = xbc_act[..., di + G * N:].reshape(B, 1, G, N)
        rep = H // G
        Bh = Bm.repeat_interleave(rep, dim=2).to(f32)   # (B,1,H,N)
        Ch = Cm.repeat_interleave(rep, dim=2).to(f32)
        dA = dt[:, 0] * A[None, :]                      # (B,H)
        h = state * torch.exp(dA)[:, :, None, None] + \
            torch.einsum("bh,bhi,bhp->bhpi", dt[:, 0], Bh[:, 0], xh[:, 0])
        y = torch.einsum("bhi,bhpi->bhp", Ch[:, 0], h)[:, None]  # (B,1,H,P)
        y = y + D.to(f32)[None, None, :, None] * xh
    else:
        xbc_act, conv_state = _causal_conv(
            xbc, conv_w.to(cdt), conv_b.to(cdt))
        xh = xbc_act[..., :di].reshape(B, S, H, P)
        Bm = xbc_act[..., di:di + G * N].reshape(B, S, G, N)
        Cm = xbc_act[..., di + G * N:].reshape(B, S, G, N)
        y, h = _ssd_chunked(xh, dt, A, Bm, Cm, min(cfg.ssm_chunk, S),
                            mm_dtype=cfg.dtype("compute"))
        y = y.to(f32) + D.to(f32)[None, None, :, None] * xh.to(f32)

    # gated RMSNorm
    yf = y.reshape(B, S, di)
    gated = yf * silu(z.to(f32))
    var = (gated ** 2).mean(-1, keepdim=True)
    yn = gated * torch.rsqrt(var + 1e-6) * norm_w.to(f32)
    return yn.to(cdt), conv_state, h

"""Mixture-of-Experts layer: top-k router, shared + routed experts
(``repro.models.moe`` in plain torch ops, the same routing and math).

Tokens are grouped (one group per sequence), each group scatters its
top-k slot assignments into per-expert capacity buffers, the experts run
as one batched einsum, and results come back by a scatter-add or a
gather with the router weights. Capacity overflow drops the token for
that expert; aux load-balance + router-z losses are returned.

The reference's out-of-range ``.at[].set(mode="drop")`` and
``.at[].add(mode="drop")`` targets are explicit here: the slot buffer has
one overflow row past ``E * cap`` and the combine one pad row past ``T``,
both sliced off.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.partition import local_apply, per_group
from .builder import Builder
from .layers import apply_mlp, init_mlp, silu

f32 = torch.float32


def init_moe(b: Builder, cfg: ArchConfig, stack: Optional[int] = None,
             name: str = "moe"):
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    st = (stack,) if stack else ()
    sta = ("layers",) if stack else ()
    with b.scope(name):
        b.param("router", st + (d, E), sta + (None, None), dtype=f32)
        b.param("w_gate", st + (E, d, f), sta + ("experts", "fsdp", None))
        b.param("w_up", st + (E, d, f), sta + ("experts", "fsdp", None))
        b.param("w_down", st + (E, f, d), sta + ("experts", None, "fsdp"))
        if cfg.num_shared_experts:
            init_mlp(b, cfg, cfg.moe_d_ff * cfg.num_shared_experts,
                     stack, name="shared")


def _topk_with_slots(gates: torch.Tensor, top_k: int, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gates (..., T, E) -> (expert_id, slot, weight), each (..., T, k),
    one group per leading index.

    Slot = position within the expert's capacity buffer, a cumulative
    count over the flattened (k, T) assignment order: primary routes
    first, then token order (slot >= capacity drops the token for that
    expert; the caller applies ``capacity``). Ties in the gates go to the
    lower expert id, as ``lax.top_k`` gives them.
    """
    *lead, T, E = gates.shape
    order = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, idx = order.values[..., :top_k], order.indices[..., :top_k]
    flat = idx.transpose(-1, -2).reshape(*lead, top_k * T)     # (..., k*T)
    onehot = F.one_hot(flat, E)                                # (..., k*T, E)
    pos = torch.cumsum(onehot, dim=-2) - 1
    slot_flat = torch.gather(pos, -1, flat[..., None])[..., 0]
    slot = slot_flat.reshape(*lead, top_k, T).transpose(-1, -2)
    return idx, slot, w


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (out, aux_loss).

    On a mesh, routing and combining run per group on each rank's
    sequences (:func:`~repro_torch.sharding.partition.per_group`: DTensor
    has no strategy for their ``sort`` / ``scatter_`` / ``gather``); the
    expert buffers are split over experts (``act_experts``) and groups
    (``act_batch``) for the expert products."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    G, T = B, S                                      # groups = sequences
    cap = max(4, int((T * k / E) * cfg.moe_capacity_factor))

    logits = torch.einsum("gtd,de->gte", x.to(f32), p["router"].to(f32))
    gates = torch.softmax(logits, dim=-1)            # (G, T, E)

    def dispatch(gates, x):
        idx, slot, w = _topk_with_slots(gates, k, cap)   # (G, T, k) each
        w = w / (w.sum(-1, keepdim=True) + 1e-9)         # renormalise
        keep = slot < cap                                # (G, T, k)
        Gl, dev = x.shape[0], x.device
        # scatter token rows into (G, E*cap) dispatch buffers; dropped
        # routes land in the overflow row E*cap
        flat_slot = torch.where(keep, idx * cap + slot, E * cap)
        token_of_slot = torch.full((Gl, E * cap + 1), T, dtype=torch.int64,
                                   device=dev)
        src = torch.arange(T, device=dev)[:, None].expand(T, k)
        token_of_slot.scatter_(1, flat_slot.reshape(Gl, -1),
                               src.reshape(1, -1).expand(Gl, -1))
        token_of_slot = token_of_slot[:, :E * cap]       # (G, E*cap)
        # gather token activations into expert buffers (pad row T = 0)
        xg_pad = torch.cat([x, x.new_zeros((Gl, 1, d))], dim=1)
        x_e = torch.gather(xg_pad, 1,
                           token_of_slot[:, :, None].expand(-1, -1, d))
        first = F.one_hot(idx[..., 0], E).to(f32)        # (G, T, E)
        return (x_e.reshape(Gl, E, cap, d), idx, slot, w * keep,
                flat_slot, token_of_slot, first)

    x_e, idx, slot, w_keep, flat_slot, token_of_slot, first = per_group(
        dispatch, gates, x)
    # expert FFN (SwiGLU) on each rank's groups and experts, the weights
    # gathered over their "fsdp" split. The reference constrains the
    # buffers to (None, "act_experts", ...) and XLA splits d over "data";
    # DTensor would repeat every group's expert work on each data rank,
    # and its einsum backward cannot view the gradients its
    # redistributions leave non-contiguous.
    cdt = x.dtype

    def experts(x_e, w_gate, w_up, w_down):
        h = silu(torch.einsum("gecd,edf->gecf", x_e, w_gate.to(cdt))) * \
            torch.einsum("gecd,edf->gecf", x_e, w_up.to(cdt))
        return torch.einsum("gecf,efd->gecd", h, w_down.to(cdt))

    buf_axes, w_axes = ("act_batch", "act_experts", None, None), \
        ("act_experts", None, None)
    y_e = local_apply(experts, (x_e, p["w_gate"], p["w_up"], p["w_down"]),
                      (buf_axes, w_axes, w_axes, w_axes))
    y_e = y_e.reshape(G, E * cap, d)

    def combine(y_e, idx, slot, w_keep, flat_slot, token_of_slot):
        Gl, dev = y_e.shape[0], y_e.device
        if cfg.moe_combine == "gather":
            # token t takes its k slots, weighted
            safe_slot = torch.where(slot < cap, idx * cap + slot, 0)
            y_tok = torch.gather(
                y_e, 1,
                safe_slot.reshape(Gl, T * k)[:, :, None].expand(-1, -1, d)
            ).reshape(Gl, T, k, d)
            return (y_tok * w_keep[..., None].to(cdt)).sum(dim=2)
        # scatter-add combine: each slot adds its weighted output to its
        # token's row; empty slots add to the pad row T
        w_slot = torch.zeros((Gl, E * cap + 1), dtype=f32, device=dev)
        w_slot.scatter_(1, flat_slot.reshape(Gl, -1),
                        w_keep.to(f32).reshape(Gl, -1))
        w_slot = w_slot[:, :E * cap]
        acc = torch.zeros((Gl, T + 1, d), dtype=cdt, device=dev)
        acc.scatter_add_(1, token_of_slot[:, :, None].expand(-1, -1, d),
                         y_e * w_slot[:, :, None].to(cdt))
        return acc[:, :T]

    y = per_group(combine, y_e, idx, slot, w_keep, flat_slot, token_of_slot)
    out = y.reshape(B, S, d)

    if cfg.num_shared_experts:
        out = out + apply_mlp(p["shared"], x, cfg)

    # aux losses (computed over all tokens)
    me = gates.mean(dim=(0, 1))                            # (E,)
    ce = first.mean(dim=(0, 1))
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)
    zl = cfg.router_z_weight * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    return out, aux + zl

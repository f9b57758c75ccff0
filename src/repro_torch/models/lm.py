"""Model assembly: decoder-only LMs, MoE, SSM/hybrid, enc-dec, VLM prefix
(``repro.models.lm`` in plain torch ops, the same math and tree layout).

One runtime for all 10 assigned architectures. A model is a sequence of
*stages* (run-length-encoded block pattern); each stage's layer params are
stacked on a leading ``layers`` axis, and a loop over the layer index
applies them where the reference scans. Zamba2's ``hybrid_attn`` blocks
share ONE param set across occurrences while keeping per-occurrence KV
caches.

Block kinds:
  attn        pre-norm GQA/MLA + SwiGLU MLP           (dense archs)
  moe         pre-norm GQA/MLA + MoE FFN              (llama4, deepseek)
  ssm         pre-norm Mamba2 (no MLP)                (mamba2, zamba2)
  hybrid_attn shared attention+MLP block              (zamba2)
  xattn       self-attn + cross-attn + MLP            (whisper decoder)

Serving writes the cache in place: ``prefill`` and ``decode_step`` return
the cache they were given, its tensors updated.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.core.devices import resolve_device
from repro_torch.sharding.partition import constrain, shard_range
from .attention import (apply_cross_attn, apply_gqa, apply_mla, encoder_kv,
                        init_gqa, init_mla)
from .builder import Builder, tree_leaves, tree_map
from .layers import (apply_linear, apply_mlp, apply_norm, embed_tokens,
                     init_embeddings, init_mlp, init_norm, unembed)
from .moe import apply_moe, init_moe
from .ssm import apply_mamba2, init_mamba2

PyTree = Any
f32 = torch.float32


# ------------------------------------------------------------------ #
# Init
# ------------------------------------------------------------------ #
def _init_attn_any(b: Builder, cfg: ArchConfig, stack):
    if cfg.attention == "mla":
        init_mla(b, cfg, stack)
    else:
        init_gqa(b, cfg, stack)


def _init_block(b: Builder, cfg: ArchConfig, kind: str, stack: int):
    st = stack if stack > 1 else None
    if kind in ("attn", "moe", "xattn"):
        init_norm(b, cfg, "norm1", cfg.d_model, st)
        _init_attn_any(b, cfg, st)
        if kind == "xattn":
            init_norm(b, cfg, "norm_x", cfg.d_model, st)
            init_gqa(b, cfg, st, name="xattn", cross=True)
        init_norm(b, cfg, "norm2", cfg.d_model, st)
        if kind == "moe":
            init_moe(b, cfg, st)
        else:
            init_mlp(b, cfg, cfg.d_ff, st)
    elif kind == "ssm":
        init_norm(b, cfg, "norm", cfg.d_model, st)
        init_mamba2(b, cfg, st)
    else:
        raise ValueError(kind)


def init_model(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
               abstract: bool = False, device="cuda"
               ) -> Tuple[PyTree, PyTree]:
    """Returns (params, logical-axes) trees. Draws come from
    ``generator`` (a ``torch.Generator`` on ``device``; seed 0 there when
    not given). ``abstract=True`` puts every tensor on the ``meta``
    device and allocates nothing."""
    if not abstract:
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        elif generator.device.type != dev.type:
            raise ValueError(f"a generator on {generator.device} cannot "
                             f"draw on {dev}")
    b = Builder(generator, abstract=abstract, dtype=cfg.dtype("param"))
    init_embeddings(b, cfg)
    init_norm(b, cfg, "final_norm", cfg.d_model)
    has_hybrid = any(k == "hybrid_attn" for k, _ in cfg.stages)
    if has_hybrid:
        with b.scope("shared_attn"):
            init_norm(b, cfg, "norm1", cfg.d_model, None)
            init_gqa(b, cfg, None)
            init_norm(b, cfg, "norm2", cfg.d_model, None)
            init_mlp(b, cfg, cfg.d_ff, None)
    with b.scope("stages"):
        for si, (kind, n) in enumerate(cfg.stages):
            if kind == "hybrid_attn":
                continue  # shared params above
            with b.scope(f"s{si}"):
                _init_block(b, cfg, kind, n)
    if cfg.encoder_layers:
        with b.scope("encoder"):
            with b.scope("blocks"):
                init_norm(b, cfg, "norm1", cfg.d_model, cfg.encoder_layers)
                init_gqa(b, cfg, cfg.encoder_layers)
                init_norm(b, cfg, "norm2", cfg.d_model, cfg.encoder_layers)
                init_mlp(b, cfg, cfg.d_ff, cfg.encoder_layers)
            init_norm(b, cfg, "final_norm", cfg.d_model)
    return b.build()


class LanguageModel(torch.nn.Module):
    """A parameter tree as one module: each dict level is a submodule and
    each leaf a parameter, so ``state_dict`` keys are the tree's paths
    joined by ``.`` (``stages.s0.attn.wq.w``). :meth:`tree` gives the
    nested dict of those parameters, which the functions of this module
    take. The parameters are frozen for serving unless ``trainable``;
    :mod:`repro_torch.train` takes the bare tree instead and asks
    autograd for the gradients of its leaves."""

    def __init__(self, cfg: ArchConfig, params: PyTree,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        for path, leaf in tree_leaves(params):
            mod = self
            for key in path[:-1]:
                if not hasattr(mod, key):
                    mod.add_module(key, torch.nn.Module())
                mod = getattr(mod, key)
            mod.register_parameter(
                path[-1], torch.nn.Parameter(leaf, requires_grad=trainable))

    def tree(self) -> PyTree:
        def walk(mod):
            out = dict(mod.named_parameters(recurse=False))
            out.update({k: walk(m) for k, m in mod.named_children()})
            return out
        return walk(self)

    def forward(self, tokens: torch.Tensor,
                frontend: Optional[torch.Tensor] = None):
        return forward(self.tree(), self.cfg, tokens, frontend)


# ------------------------------------------------------------------ #
# Blocks (apply)
# ------------------------------------------------------------------ #
def _apply_attn_any(p, x, cfg, positions, cache, pos):
    if cfg.attention == "mla":
        return apply_mla(p["attn"], x, cfg, positions, cache, pos)
    return apply_gqa(p["attn"], x, cfg, positions, cache, pos)


def _whole(y):
    """A block's output summed over the ranks that split its last
    product (heads, ``ff``, experts, the SSM's inner width) before the
    residual add: left a partial sum, the residual stream would stay
    partial and every later product would run whole on every rank of
    ``model``. The identity off a mesh."""
    return constrain(y, ("act_batch", None, None))


def _block_apply(kind: str, p, x, cfg: ArchConfig, positions,
                 cache: Optional[Dict], pos, enc_kv=None):
    """Returns (x_out, aux); writes ``cache`` in place."""
    zero = torch.zeros((), dtype=f32, device=x.device)
    if kind in ("attn", "moe", "hybrid_attn", "xattn"):
        h = apply_norm(p["norm1"], x, cfg)
        attn_cache = cache.get("attn") if cache else None
        a, _ = _apply_attn_any(p, h, cfg, positions, attn_cache, pos)
        x = x + _whole(a)
        if kind == "xattn":
            h = apply_norm(p["norm_x"], x, cfg)
            x = x + _whole(apply_cross_attn(p["xattn"], h, cfg, enc_kv))
        h = apply_norm(p["norm2"], x, cfg)
        if kind == "moe":
            f, aux = apply_moe(p["moe"], h, cfg)
        else:
            f, aux = apply_mlp(p["mlp"], h, cfg), zero
        return x + _whole(f), aux
    if kind == "ssm":
        h = apply_norm(p["norm"], x, cfg)
        ssm_cache = cache.get("ssm") if cache else None
        s, _ = apply_mamba2(p["ssm"], h, cfg, ssm_cache, pos)
        return x + _whole(s), zero
    raise ValueError(kind)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so cache writes land in the
    stacked tensors."""
    return None if tree is None else tree_map(lambda a: a[i], tree)


# matmuls without batch dims: ``jax.checkpoint_policies.
# dots_with_no_batch_dims_saveable`` saves these (a (B, S, d) @ (d, f)
# product reaches autograd as ``mm``; the attention einsums as ``bmm``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, fn):
    """``fn`` under the config's rematerialisation, as the reference wraps
    a scanned layer in ``jax.checkpoint``: ``"full"`` keeps only the
    layer's inputs and recomputes the rest in the backward, ``"dots"``
    also keeps the outputs of matmuls without batch dims, ``"none"``
    keeps everything. Only where autograd records; the values are the
    same in all three."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                _save_dots))
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _run_stages(params, cfg: ArchConfig, x, positions,
                cache: Optional[Dict], pos, enc_kv_tree=None):
    """Apply all stages; returns (x, aux_total)."""
    aux_total = torch.zeros((), dtype=f32, device=x.device)
    for si, (kind, n) in enumerate(cfg.stages):
        key = f"s{si}"
        stage_cache = (cache or {}).get(key)
        enc_kv = (enc_kv_tree or {}).get(key) if kind == "xattn" else None
        if kind == "hybrid_attn":
            if n != 1:
                raise ValueError("hybrid stages are single occurrences")
            p_stack = params["shared_attn"]
        else:
            p_stack = params["stages"][key]
        if n == 1:
            x, aux = _block_apply(kind, p_stack, x, cfg, positions,
                                  stage_cache, pos, enc_kv)
            aux_total = aux_total + aux
            continue
        # the reference scans over the stacked layers of this stage
        block = _remat(cfg, _block_apply)
        aux_s = torch.zeros((), dtype=f32, device=x.device)
        for i in range(n):
            x, aux = block(kind, _layer(p_stack, i), x, cfg, positions,
                           _layer(stage_cache, i), pos, _layer(enc_kv, i))
            aux_s = aux_s + aux
        aux_total = aux_total + aux_s
        x = constrain(x, ("act_batch", "act_seq", None))
    return x, aux_total


# ------------------------------------------------------------------ #
# Encoder (whisper) + frontend fusion
# ------------------------------------------------------------------ #
def _run_encoder(params, cfg: ArchConfig, frames: torch.Tensor
                 ) -> torch.Tensor:
    """frames: (B, F, d_model) stub frame embeddings.

    The encoder's self-attention is causal, as the reference computes it:
    ``apply_gqa`` without a cache applies the causal mask, although
    ``repro/models/lm.py`` calls it non-causal (frame 0's output does not
    depend on later frames in either package)."""
    x = frames
    B, F, _ = x.shape
    positions = torch.arange(F, device=x.device)[None].expand(B, F)
    enc = params["encoder"]

    def body(h, p_layer):
        a = apply_norm(p_layer["norm1"], h, cfg)
        out, _ = apply_gqa(p_layer["attn"], a, cfg, positions)
        h = h + _whole(out)
        m = apply_norm(p_layer["norm2"], h, cfg)
        return h + _whole(apply_mlp(p_layer["mlp"], m, cfg))

    body = _remat(cfg, body)
    for i in range(cfg.encoder_layers):
        x = body(x, _layer(enc["blocks"], i))
    return apply_norm(enc["final_norm"], x, cfg)


def _fuse_frontend(params, cfg: ArchConfig, tok_embeds: torch.Tensor,
                   frontend: Optional[torch.Tensor]):
    """VLM early fusion: project patch embeddings and prepend."""
    if frontend is None or cfg.frontend == "none":
        return tok_embeds, 0
    fe = apply_linear(params["frontend_proj"],
                      frontend.to(tok_embeds.dtype), cfg)
    # the fused sequence laid out as the token embeddings are
    x = constrain(torch.cat([fe, tok_embeds], dim=1),
                  ("act_batch", None, None))
    return x, fe.shape[1]


def _enc_kv_tree(params, cfg: ArchConfig, enc_out: torch.Tensor) -> Dict:
    """Per-stage cross-attention K/V from the encoder output; stacked on
    ``layers`` for stacked stages."""
    tree = {}
    for si, (kind, n) in enumerate(cfg.stages):
        if kind != "xattn":
            continue
        p = params["stages"][f"s{si}"]
        if n == 1:
            tree[f"s{si}"] = encoder_kv(p["xattn"], enc_out, cfg)
        else:
            kvs = [encoder_kv(_layer(p, i)["xattn"], enc_out, cfg)
                   for i in range(n)]
            tree[f"s{si}"] = (torch.stack([kv[0] for kv in kvs]),
                              torch.stack([kv[1] for kv in kvs]))
    return tree


def _embed_and_fuse(params, cfg: ArchConfig, tokens, frontend):
    """Token embeddings with the frontend fused in (VLM prefix) or fed to
    the encoder (enc-dec). Returns (x, n_prefix, enc_kv_tree)."""
    x = embed_tokens(params, tokens.long(), cfg)
    if cfg.encoder_layers:
        if frontend is None:
            raise ValueError(f"{cfg.name} needs frontend frames for its "
                             "encoder")
        enc_out = _run_encoder(params, cfg, frontend.to(x.dtype))
        return x, 0, _enc_kv_tree(params, cfg, enc_out)
    x, n_prefix = _fuse_frontend(params, cfg, x, frontend)
    return x, n_prefix, None


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


# ------------------------------------------------------------------ #
# Public entry points
# ------------------------------------------------------------------ #
def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full causal forward. Returns (logits, aux_loss). For enc-dec archs
    ``frontend`` feeds the encoder; for VLM it prepends to the sequence."""
    B = tokens.shape[0]
    x, n_prefix, enc_kv_tree = _embed_and_fuse(params, cfg, tokens,
                                               frontend)
    x, aux = _run_stages(params, cfg, x, _positions(B, x.shape[1], x.device),
                         None, None, enc_kv_tree)
    x = apply_norm(params["final_norm"], x, cfg)
    if n_prefix:
        x = x[:, n_prefix:]
    return unembed(params, x, cfg), aux


def loss_fn(params, cfg: ArchConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy (+ MoE aux). batch: tokens, labels
    [, frontend]; labels < 0 are ignored. Differentiable: the train step
    (:mod:`repro_torch.train`) takes ``torch.autograd.grad`` of the loss
    over the parameter leaves; ``cfg.remat`` says which activations the
    backward recomputes."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch.get("frontend"))
    labels = batch["labels"].long()
    valid = labels >= 0
    labels = torch.clamp(labels, min=0)
    ll = _label_logp(logits.to(f32), labels)
    denom = torch.clamp(valid.sum(), min=1)
    xent = -(ll * valid).sum() / denom
    loss = xent + aux
    return loss, {"loss": loss, "xent": xent, "aux": aux, "tokens": denom}


def _label_logp(logits: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
    """``log_softmax(logits)[..., labels]``.

    On a DTensor split over the vocabulary, ``log_softmax`` would gather
    the whole vocabulary onto every rank (its dimension must be whole),
    and a ``gather`` along it has no strategy. So the log-sum-exp reduces
    across the shards (an all-reduce of the max and of the sum), and each
    rank picks the labels inside its slice of the vocabulary (zero
    elsewhere), a partial sum over the ranks that split it."""
    if not isinstance(logits, DTensor):
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, labels[..., None])[..., 0]
    # the reductions replicated over the vocabulary's ranks (all-reduce):
    # split over the batch instead, the backward would move the
    # vocabulary whole onto each rank
    rows = ("act_batch", None)
    m = constrain(logits.amax(-1).detach(), rows)
    total = constrain(torch.exp(logits - m[..., None]).sum(-1), rows)
    lse = torch.log(total) + m
    return constrain(_pick_labels(logits, labels), rows) - lse


def _pick_labels(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """``logits[..., labels]`` on a vocabulary split over mesh axes: each
    rank gathers the labels in its slice, and the result is a partial sum
    over the axes that split the vocabulary."""
    mesh = logits.device_mesh
    logits = logits.redistribute(mesh, [Replicate() if p.is_partial() else p
                                        for p in logits.placements])
    pl, vdim = logits.placements, logits.ndim - 1
    lo, size = shard_range(logits, vdim)
    lab_pl = [Replicate() if isinstance(p, Shard) and p.dim == vdim
              else p for p in pl]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    idx = labels.redistribute(mesh, lab_pl).to_local() - lo
    inside = (idx >= 0) & (idx < size)
    picked = torch.gather(logits.to_local(), -1,
                          idx.clamp(0, size - 1)[..., None])[..., 0]
    out_pl = [Partial() if isinstance(p, Shard) and p.dim == vdim else p
              for p in pl]
    return DTensor.from_local(picked * inside, mesh, out_pl,
                              run_check=False)


# ------------------------------------------------------------------ #
# Serving: cache init / prefill / decode
# ------------------------------------------------------------------ #
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               abstract: bool = False, device="cuda"
               ) -> Tuple[PyTree, PyTree]:
    """Returns (cache, logical-axes), zeros on ``device`` (``meta`` when
    ``abstract``). Layout per stage; stacked on layers for stacked
    stages."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    dt = cfg.dtype("compute")
    K, dh = cfg.num_kv_heads, cfg.head_dim_
    di = cfg.d_inner
    P, N, Hs = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_heads
    Wc = cfg.ssm_conv
    dconv = di + 2 * cfg.ssm_groups * N

    def mk(shape, dtype, axes):
        return torch.zeros(shape, dtype=dtype, device=dev), axes

    cache, axes = {}, {}
    for si, (kind, n) in enumerate(cfg.stages):
        key = f"s{si}"
        lead = (n,) if n > 1 else ()
        la = ("layers",) if n > 1 else ()
        if kind in ("attn", "moe", "hybrid_attn", "xattn"):
            if cfg.attention == "mla":
                c1, a1 = mk(lead + (batch, max_len, cfg.kv_lora_rank), dt,
                            la + ("act_batch", "cache_seq", None))
                c2, a2 = mk(lead + (batch, max_len, cfg.qk_rope_dim), dt,
                            la + ("act_batch", "cache_seq", None))
                cache[key] = {"attn": {"ckv": c1, "krope": c2}}
                axes[key] = {"attn": {"ckv": a1, "krope": a2}}
            else:
                ck, ak = mk(lead + (batch, max_len, K, dh), dt,
                            la + ("act_batch", "cache_seq", "kv", None))
                cv, av = mk(lead + (batch, max_len, K, dh), dt,
                            la + ("act_batch", "cache_seq", "kv", None))
                cache[key] = {"attn": {"k": ck, "v": cv}}
                axes[key] = {"attn": {"k": ak, "v": av}}
        elif kind == "ssm":
            cc, ac = mk(lead + (batch, Wc - 1, dconv), dt,
                        la + ("act_batch", None, "ff"))
            cs, as_ = mk(lead + (batch, Hs, P, N), f32,
                         la + ("act_batch", None, None, None))
            cache[key] = {"ssm": {"conv": cc, "state": cs}}
            axes[key] = {"ssm": {"conv": ac, "state": as_}}
    return cache, axes


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, cache: PyTree,
            frontend: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, PyTree]:
    """Run the full prompt and fill ``cache`` (fresh, from
    :func:`init_cache`) in place. Returns (last-token logits, cache)."""
    B = tokens.shape[0]
    x, _, enc_kv_tree = _embed_and_fuse(params, cfg, tokens, frontend)
    x, _ = _run_stages(params, cfg, x, _positions(B, x.shape[1], x.device),
                       cache, None, enc_kv_tree)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = unembed(params, x[:, -1:], cfg)
    if enc_kv_tree is not None:
        cache["enc_kv"] = enc_kv_tree
    return logits, cache


def decode_step(params, cfg: ArchConfig, cache: PyTree, token: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, PyTree]:
    """One decode step. token: (B, 1) ints; pos: the current absolute
    position (an int). Returns (logits (B,1,V), cache), the cache written
    in place."""
    pos = int(pos)
    B = token.shape[0]
    x = embed_tokens(params, token.long(), cfg)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    x, _ = _run_stages(params, cfg, x, positions, cache, pos,
                       cache.get("enc_kv"))
    x = apply_norm(params["final_norm"], x, cfg)
    return unembed(params, x, cfg), cache

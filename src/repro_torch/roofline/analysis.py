"""Roofline analysis of traced dry-run steps (``repro.roofline.analysis``
with the card's constants).

Every traced number (dot flops, bytes, collective output bytes) is PER
DEVICE: the dry run traces one rank of the world, and
:mod:`repro_torch.roofline.trace_tools` counts each op on that rank's
local shards (a (512, 512, 512) product split 8 ways counts 2*512^3/8
flops). Therefore:

    compute    = flops_per_dev / peak_flops
    memory     = bytes_per_dev / hbm_bw
    collective = nvlink_bytes / nvlink_bw + network_bytes / network_bw

``HW`` holds the datasheet figures of one NVIDIA H100 80GB HBM3 (SXM5,
700 W): 989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM, 450e9 B/s a GPU each
way over NVLink inside an 8-GPU node and 50e9 B/s a GPU (400 Gb/s NDR)
between nodes. A collective whose group spans nodes is priced at the
slower link. A card set below 700 W runs slower than these figures.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Tuple


@dataclass(frozen=True)
class _HW:
    peak_flops: float = 989e12        # dense bf16 / GPU
    hbm_bw: float = 3.35e12           # B/s / GPU
    nvlink_bw: float = 450e9          # B/s / GPU each way, inside a node
    network_bw: float = 50e9          # B/s / GPU, between nodes (NDR)
    gpus_per_node: int = 8


HW = _HW()

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")


def ring_wire_bytes(kind: str, obytes: int, g: int) -> int:
    """Bytes one device puts on the wire for a collective of local output
    size ``obytes`` over a group of ``g``, by the ring algorithms:
      all-gather          O*(g-1)/g      (receives all but its own shard)
      reduce-scatter      O*(g-1)        (input = O*g streams through)
      all-reduce          2*O*(g-1)/g    (RS + AG phases)
      all-to-all          O*(g-1)/g
      collective-permute  O
    """
    if kind == "all-gather":
        return obytes * (g - 1) // g
    if kind == "reduce-scatter":
        return obytes * (g - 1)
    if kind == "all-reduce":
        return 2 * obytes * (g - 1) // g
    if kind == "all-to-all":
        return obytes * (g - 1) // g
    if kind == "collective-permute":
        return obytes
    raise ValueError(f"unknown collective {kind!r}")


def collective_bytes_from_trace(collectives: Iterable[Tuple]
                                ) -> Dict[str, int]:
    """Per-device wire bytes per collective kind, from the collectives a
    traced step issued: ``(kind, local output bytes, group size,
    spans_nodes)`` each (``trace_tools.StepTrace.collectives``).

    The keys are the reference's ``collective_bytes_from_hlo``'s: one per
    kind seen, ``total`` and ``raw_output_<kind>``; ``network`` adds the
    part of ``total`` whose groups span nodes."""
    out: Dict[str, int] = {}
    raw: Dict[str, int] = {}
    network = 0
    for kind, obytes, g, spans in collectives:
        wire = ring_wire_bytes(kind, obytes, g)
        out[kind] = out.get(kind, 0) + wire
        raw[kind] = raw.get(kind, 0) + obytes
        if spans:
            network += wire
    out["total"] = sum(out.values())
    out["network"] = network
    for k, v in raw.items():
        out[f"raw_output_{k}"] = v
    return out


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, hw: _HW = HW,
                   network_bytes_per_dev: float = 0.0) -> Dict[str, float]:
    """The reference's terms and keys; ``network_bytes_per_dev`` of the
    collective bytes cross nodes, the rest stay on NVLink."""
    compute = flops_per_dev / hw.peak_flops
    memory = bytes_per_dev / hw.hbm_bw
    collective = ((coll_bytes_per_dev - network_bytes_per_dev) / hw.nvlink_bw
                  + network_bytes_per_dev / hw.network_bw)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    terms["dominant"] = dom
    terms["roofline_fraction"] = compute / bound if bound > 0 else 0.0
    return terms


def model_flops(cfg, shape_kind: str, seq_len: int, global_batch: int,
                n_params_active: int, n_params_embed: int = 0) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference),
    D = processed tokens. Embedding params excluded from N by convention."""
    n = n_params_active - n_params_embed
    if shape_kind == "train":
        per_tok = 6 * n
        tokens = seq_len * global_batch
    elif shape_kind == "prefill":
        per_tok = 2 * n
        tokens = seq_len * global_batch
    else:  # decode: one token per sequence
        per_tok = 2 * n
        tokens = global_batch
    return float(per_tok) * float(tokens)


def active_params(cfg, params_total: int) -> int:
    """MoE: count routed experts once per top_k instead of num_experts."""
    if cfg.num_experts and cfg.top_k:
        expert_p = (3 * cfg.d_model * cfg.moe_d_ff) * cfg.num_experts
        n_moe_layers = sum(1 for k in cfg.block_pattern if k == "moe")
        all_experts = expert_p * n_moe_layers
        active_experts = all_experts * cfg.top_k // cfg.num_experts
        return params_total - all_experts + active_experts
    return params_total

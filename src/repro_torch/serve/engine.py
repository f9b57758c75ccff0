"""Batched serving engine: prefill + greedy decode
(``repro.serve.engine`` on torch).

Fixed batch slots, one cache, prompts padded to a common length per
batch. The decode step writes the cache in place (the counterpart of the
reference's donated cache), and the generated tokens stay on the device
until the last step.

Difference from the reference: ``generate`` raises ``ValueError`` when
the prompt, the frontend prefix and the generated tokens do not fit in
``max_len``; the reference's cache writes clamp their start index and
overwrite the last slot without error.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.devices import resolve_device
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models.builder import tree_leaves


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, max_len: int,
                 batch_slots: int, device="cuda"):
        self.device = resolve_device(device)
        on = {leaf.device.type for _, leaf in tree_leaves(params)}
        if on != {self.device.type}:
            raise ValueError(f"parameters on {sorted(on)}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.batch_slots = batch_slots

    def prefill(self, tokens, cache, frontend=None):
        return prefill(self.params, self.cfg, tokens, cache, frontend)

    def decode(self, cache, token, pos: int):
        return decode_step(self.params, self.cfg, cache, token, pos)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, steps: int,
                 frontend: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts: (B, S0) ints. Greedy-decodes ``steps`` tokens;
        returns them as (B, steps) int32."""
        cfg = self.cfg
        B, S0 = prompts.shape
        if B != self.batch_slots:
            raise ValueError(f"{B} prompts for {self.batch_slots} slots")
        n_prefix = (cfg.frontend_len
                    if (cfg.frontend != "none"
                        and not cfg.encoder_layers) else 0)
        if S0 + n_prefix + steps > self.max_len:
            raise ValueError(
                f"prompt {S0} + prefix {n_prefix} + {steps} steps exceeds "
                f"max_len {self.max_len}")
        cache, _ = init_cache(cfg, B, self.max_len, device=self.device)
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                 device=self.device)
        fe = None if frontend is None else torch.as_tensor(
            np.asarray(frontend), dtype=torch.float32, device=self.device)
        logits, cache = self.prefill(tokens, cache, fe)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        outs = [tok]
        for i in range(steps - 1):
            logits, cache = self.decode(cache, tok, S0 + n_prefix + i)
            tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
            outs.append(tok)
        return torch.cat(outs, dim=1).to(torch.int32).cpu().numpy()

"""Serve a small LM with batched requests: prefill + greedy decode via
the same ``decode_step`` the ``decode_*`` dry-run cells trace
(``examples/serve_lm.py`` of the JAX package).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Weights come from a seeded generator on the device; ``main(params=...)``
serves given ones (for example ``repro``'s, carried across by
:func:`repro_torch.convert.lm_params_from_jax`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.devices import resolve_device
from repro_torch.examples._cli import parser
from repro_torch.models import init_model
from repro_torch.serve import ServeEngine


def main(device="cuda", params=None, seed=0) -> dict:
    dev = resolve_device(device)
    cfg = get_config("qwen3-0.6b-smoke")
    if params is None:
        params, _ = init_model(cfg, torch.Generator(dev).manual_seed(seed),
                               device=dev)
    B, S0, steps = 4, 12, 16
    engine = ServeEngine(cfg, params, max_len=S0 + steps + 4,
                         batch_slots=B, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)
    out = engine.generate(prompts, steps=steps)
    print(f"prompts {prompts.shape} -> generated {out.shape}")
    for b in range(B):
        print(f"  req{b}: {prompts[b].tolist()} => {out[b].tolist()}")
    assert out.shape == (B, steps)
    assert (out >= 0).all() and (out < cfg.vocab_size).all()
    return {"prompts": prompts, "tokens": np.asarray(out)}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)

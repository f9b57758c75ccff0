from .builder import Builder, count_params, param_bytes
from .lm import (LanguageModel, decode_step, forward, init_cache,
                 init_model, loss_fn, prefill)

__all__ = ["Builder", "count_params", "param_bytes", "init_model",
           "LanguageModel", "forward", "loss_fn", "init_cache", "prefill",
           "decode_step"]

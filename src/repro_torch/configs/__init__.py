"""Config registry: import every arch module so `--arch <id>` resolves."""
from .base import (SHAPES, ArchConfig, ShapeCell, cell_supported,
                   get_config, list_configs)
from . import (command_r_plus_104b, deepseek_v3_671b, internlm2_1_8b,
               internvl2_26b, llama4_scout_17b_a16e, mamba2_2_7b,
               qwen3_0_6b, rlc_paper, stablelm_3b, whisper_tiny,
               zamba2_1_2b)

ASSIGNED = (
    "internvl2-26b", "stablelm-3b", "internlm2-1.8b", "qwen3-0.6b",
    "command-r-plus-104b", "llama4-scout-17b-a16e", "deepseek-v3-671b",
    "zamba2-1.2b", "mamba2-2.7b", "whisper-tiny",
)

__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "get_config",
           "list_configs", "cell_supported", "ASSIGNED"]

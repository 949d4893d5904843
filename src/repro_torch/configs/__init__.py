"""Architecture config registry: ``get_config(arch_id)`` /
``list_archs()``.

One module per assigned architecture, the same data as ``repro.configs``.
The paper's own ``gsc_cnn`` config belongs to the GSC slice of the port and
is not here yet.
"""

from __future__ import annotations

import importlib
from typing import List

from .base import SHAPES, ModelConfig, ShapeConfig, TrainConfig

ARCH_IDS = [
    "qwen3_moe_235b_a22b",
    "deepseek_v2_lite_16b",
    "starcoder2_15b",
    "yi_6b",
    "minitron_8b",
    "smollm_360m",
    "xlstm_350m",
    "zamba2_1p2b",
    "musicgen_large",
    "internvl2_2b",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIAS.update({
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "starcoder2-15b": "starcoder2_15b",
    "yi-6b": "yi_6b",
    "minitron-8b": "minitron_8b",
    "smollm-360m": "smollm_360m",
    "xlstm-350m": "xlstm_350m",
    "zamba2-1.2b": "zamba2_1p2b",
    "musicgen-large": "musicgen_large",
    "internvl2-2b": "internvl2_2b",
})


def get_config(arch: str) -> ModelConfig:
    arch_id = _ALIAS.get(arch, arch)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ALIAS)}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(ARCH_IDS)


__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "TrainConfig",
           "get_config", "list_archs"]

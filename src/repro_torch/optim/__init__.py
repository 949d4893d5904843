"""Optimizer substrate: AdamW (+ compressed moments), schedules, int8
error-feedback gradient compression."""

from .adamw import (AdamWConfig, apply_updates, clip_by_global_norm,
                    global_norm, init_state)
from .compression import (dequantize_int8, init_residuals,
                          make_compressed_grad_sync, quantize_int8)
from .schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "apply_updates", "clip_by_global_norm",
           "global_norm", "init_state", "dequantize_int8", "init_residuals",
           "make_compressed_grad_sync", "quantize_int8", "constant",
           "warmup_cosine"]

"""Decoder LMs assembled from config-driven blocks (attention blocks in
this slice of the port)."""

from . import attention, common, ffn, transformer
from .transformer import (forward, init_cache, init_model, param_count,
                          prefill, serve_step)

__all__ = ["attention", "common", "ffn", "transformer", "forward",
           "init_cache", "init_model", "param_count", "prefill",
           "serve_step"]

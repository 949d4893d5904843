"""Decoder LMs assembled from config-driven blocks (GQA or MLA attention
blocks with an FFN or a MoE, in this slice of the port)."""

from . import attention, common, ffn, moe, transformer
from .transformer import (forward, init_cache, init_model, param_count,
                          prefill, serve_step)

__all__ = ["attention", "common", "ffn", "moe", "transformer", "forward",
           "init_cache", "init_model", "param_count", "prefill",
           "serve_step"]

"""Decoder LMs assembled from config-driven blocks (GQA or MLA attention
blocks with an FFN or a MoE, in this slice of the port), and the paper's
GSC keyword-spotting CNN."""

from . import attention, common, ffn, gsc_cnn, moe, transformer
from .transformer import (forward, init_cache, init_model, init_train_params,
                          loss_fn, param_count, prefill, serve_step,
                          serving_params)

__all__ = ["attention", "common", "ffn", "gsc_cnn", "moe", "transformer",
           "forward", "init_cache", "init_model", "init_train_params",
           "loss_fn", "param_count", "prefill", "serve_step",
           "serving_params"]

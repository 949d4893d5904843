"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT + InternLM2. [arXiv:2404.16821; hf]

The InternViT frontend is a STUB per the assignment: input_specs()
provides 256 precomputed patch embeddings prefixed to the text tokens;
the LM backbone (InternLM2-2B shape) is implemented fully.
"""

from repro_torch.core.api import SparsityConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    act="silu",
    frontend="vision_prefix",
    n_prefix=256,
    ffn_sparsity=SparsityConfig(n=4, k_frac=0.125, route_share=0, kwta_impl="bisect"),
    block_pattern=("attn",) * 2,
)

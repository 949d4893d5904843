"""musicgen-large [audio]: 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Modality frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, S, D); the backbone is the transformer.
"""

from repro_torch.core.api import SparsityConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    frontend="embed",
    ffn_sparsity=SparsityConfig(n=4, k_frac=0.125, route_share=0, kwta_impl="bisect"),
    block_pattern=("attn",) * 2,
)

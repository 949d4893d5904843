"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-arch GQA. [arXiv:2403.04652; hf]

d_ff=11008 = 4*2752: CS pack n=4 divides it exactly.
"""

from repro_torch.core.api import SparsityConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    act="silu",
    ffn_sparsity=SparsityConfig(n=4, k_frac=0.125, route_share=0, kwta_impl="bisect"),
    block_pattern=("attn",) * 2,
)

"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE. [arXiv:2402.19173; hf]

CS packs the (huge) dense FFN: n=8 (87.5% weight sparsity) + 10% k-WTA
winners — the paper's §6.4 Transformer direction on the most FFN-heavy
assigned arch.
"""

from repro_torch.core.api import SparsityConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",
    ffn_sparsity=SparsityConfig(n=8, k_frac=0.10, route_share=0, kwta_impl="bisect"),
    block_pattern=("attn",) * 2,
)

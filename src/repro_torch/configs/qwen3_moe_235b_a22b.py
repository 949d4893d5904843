"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

Head-dim note: the assignment sheet's d_model/heads gives
head_dim=64; we follow the sheet exactly.
CS (the paper's technique) packs the expert FFNs (n=4 -> 75% weight
sparsity) with k-WTA on the expert hidden (12.5% winners): MoE routing is
the coarse activation sparsity, CS+k-WTA the fine one.
"""

from repro_torch.core.api import SparsityConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    act="silu",
    n_experts=128,
    experts_per_token=8,
    ffn_sparsity=SparsityConfig(n=4, k_frac=0.125, route_share=0, kwta_impl="bisect"),
    block_pattern=("attn",) * 2,   # scan unit of 2 layers (47 units)
)

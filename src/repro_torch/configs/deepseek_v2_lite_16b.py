"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE top-6, MLA kv_lora=512. [arXiv:2405.04434; hf]

Sheet discrepancy: "64e top-6" vs "2 shared + 160 routed";
160 routed is DeepSeek-V2 (236B). We implement the Lite spec: 64 routed +
2 shared, top-6.
"""

from repro_torch.core.api import SparsityConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    act="silu",
    n_experts=64,
    n_shared_experts=2,
    experts_per_token=6,
    use_mla=True,
    kv_lora_rank=512,
    rope_head_dim=64,
    ffn_sparsity=SparsityConfig(n=4, k_frac=0.125, route_share=0, kwta_impl="bisect"),
    block_pattern=("attn",),       # 27 units of 1 layer
)

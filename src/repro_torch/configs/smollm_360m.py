"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
— llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

The faithful-CS showcase arch. route_share=0: all groups share one route
table (R=G), the layout the production baseline uses; R=1 is exercised at
GSC scale and inside the kernels.
"""

from repro_torch.core.api import SparsityConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    d_head=64,
    act="silu",
    head_pad=16,   # 15 heads -> 16 computed (zero-masked) for TP divisibility
    ffn_sparsity=SparsityConfig(n=4, k_frac=0.125, route_share=0, kwta_impl="bisect"),
    block_pattern=("attn",) * 2,
)

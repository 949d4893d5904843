"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + ONE weight-shared attention
block invoked periodically (the Zamba trick). [arXiv:2411.15242; hf]

Pattern: 2 units x (18 mamba2 + 1 shared_attn) = 38 blocks; the shared_attn
params live outside the scan and are reused at every invocation.
Sub-quadratic: runs long_500k (Mamba2 state is O(1); the shared attention
KV cache seq-shards over the mesh).
"""

from repro_torch.core.api import SparsityConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    act="gelu",
    block_pattern=("mamba2",) * 18 + ("shared_attn",),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=128,
    ffn_sparsity=SparsityConfig(n=4, k_frac=0.125, route_share=0, kwta_impl="bisect"),
    supports_long_context=True,
)

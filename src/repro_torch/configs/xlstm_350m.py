"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (7:1 ratio as in the xLSTM paper's [7:1] notation).
[arXiv:2405.04517; unverified]

Sub-quadratic: runs the long_500k cell (O(1) recurrent state).
k-WTA is applied to block in/out projections only — never to the carried
recurrent state.
"""

from repro_torch.core.api import SparsityConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),   # 3 units of 8
    ssm_chunk=128,
    supports_long_context=True,
)

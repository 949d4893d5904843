"""Config dataclasses: model architecture, input shapes, training.

One ``ModelConfig`` per assigned architecture lives in
repro_torch/configs/<id>.py; the same dataclass drives full-scale runs and
reduced smoke tests (``reduced()``).  The fields, defaults and derived
properties are those of ``repro.configs.base`` (a test holds them equal).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.api import DENSE, SparsityConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm|cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    act: str = "silu"                # silu (SwiGLU) | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    vocab_pad: int = 128             # pad vocab to a multiple

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- MLA (DeepSeek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    rope_head_dim: int = 64

    # --- SSM / hybrid ---
    # The repeating unit of block kinds; n_layers must be a multiple of its
    # length. Entries: attn | mamba2 | mlstm | slstm | shared_attn.
    block_pattern: Tuple[str, ...] = ("attn",)
    ssm_state: int = 64
    ssm_chunk: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_kernel: int = 4

    # --- modality frontend stubs (audio/vlm) ---
    frontend: str = "none"           # none | embed (precomputed embeddings)
    n_prefix: int = 0                # prefix embeddings (vision patches)

    # --- the paper's technique ---
    ffn_sparsity: SparsityConfig = DENSE
    proj_sparsity: SparsityConfig = DENSE

    # --- numerics / memory ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    kv_cache_dtype: str = "bfloat16"   # "int8" halves decode cache bytes
    cache_write: str = "masked"        # "owner": row-owner write (sharded)

    # --- attention scaling for long context ---
    flash_block: int = 512           # kv-chunk size for blockwise attention
    supports_long_context: bool = False  # sub-quadratic (SSM/hybrid) only

    # --- accounting: unroll inner (flash/SSD) loops ---
    unroll_inner: bool = False

    # --- head padding (function-preserving) ---
    # head_pad rounds the *computed* head count up with dummy zero-masked
    # heads: exact same function. 0 = off.
    head_pad: int = 0

    def __post_init__(self):
        if self.n_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"block_pattern length {len(self.block_pattern)}")

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_heads(self) -> int:
        if not self.head_pad:
            return self.n_heads
        m = self.head_pad
        return ((self.n_heads + m - 1) // m) * m

    @property
    def padded_vocab(self) -> int:
        v, m = self.vocab_size, self.vocab_pad
        return ((v + m - 1) // m) * m

    @property
    def n_units(self) -> int:
        """Number of repetitions of ``block_pattern``."""
        return self.n_layers // len(self.block_pattern)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        base = dict(
            n_layers=2 * len(self.block_pattern),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            d_head=16,
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            experts_per_token=min(self.experts_per_token, 2),
            kv_lora_rank=32 if self.use_mla else 0,
            rope_head_dim=8 if self.use_mla else self.rope_head_dim,
            ssm_state=16,
            ssm_chunk=16,
            ssm_head_dim=16,
            n_prefix=min(self.n_prefix, 4),
            flash_block=32,
        )
        base.update(overrides)
        # shrink sparsity configs to fit tiny dims
        if self.ffn_sparsity.weight_sparse:
            base.setdefault("ffn_sparsity",
                            dataclasses.replace(self.ffn_sparsity, n=4,
                                                route_share=0))
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# The four assigned LM shapes (identical for all 10 archs).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    moment_dtype: str = "float32"     # bfloat16 = compressed optimizer state
    zero1: bool = True                # shard optimizer state over dp axes
    seed: int = 0
    microbatch: int = 0               # 0 = no gradient accumulation
    grad_compression: bool = False    # int8 error-feedback cross-pod sync
    checkpoint_every: int = 200
    ckpt_dir: str = "/tmp/repro_ckpt"
    log_every: int = 10

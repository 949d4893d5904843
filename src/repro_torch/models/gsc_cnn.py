"""The paper's end-to-end GSC keyword-spotting CNN (Table 1), in dense,
sparse-dense and sparse-sparse variants — the reference's
``repro.models.gsc_cnn`` in PyTorch.

Architecture (paper Table 1):
  Input 32x32x1 -> Conv 5x5x64 (VALID) -> MaxPool2 -> Conv 5x5x64 (VALID)
  -> MaxPool2 -> Flatten 1600 -> Linear 1500 -> Output 12

Variant mapping (paper §4.1):
  dense         — everything dense.
  sparse-dense  — CS weights on every layer but the output, dense
                  activations.
  sparse-sparse — CS weights + k-WTA activations everywhere downstream;
                  Conv-1's input is dense, so it is weight-sparse only.

Sparsity levels follow the paper: pack n=16 on the big layers (93.75%
weight sparsity), n=5 on the stem, k-WTA at ~12% winners (conv channel
k-WTA k=8/64, global linear k-WTA k=180/1500).

Params are the training layout (no ``packed_p``).  Activations are NHWC,
conv weights HWIO, as in the reference.  At the paper's shapes every
packed layer takes the Hadamard path (Conv-2's B·OH·OW·K is far above its
1600 inputs, Linear-1 is not flagged sparse), so no CUDA kernel runs here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.api import SparsityConfig
from repro_torch.core.kwta import kwta, kwta_channel, kwta_hist
from repro_torch.core.layers import (conv2d_apply, conv2d_init,
                                     drop_partition_major, linear_apply,
                                     linear_init, maxpool2d,
                                     packed_conv2d_apply, packed_conv2d_init,
                                     packed_linear_apply, packed_linear_init)
from repro_torch.core.masks import pad_to_multiple
from .common import resolve_device


@dataclasses.dataclass(frozen=True)
class GSCConfig:
    name: str = "gsc_cnn"
    variant: str = "sparse_sparse"  # dense | sparse_dense | sparse_sparse
    n_classes: int = 12
    channels: int = 64
    hidden: int = 1500
    # CS pack factors (weight density 1/n)
    conv1_n: int = 5                 # 80% sparse stem (paper §5.4 style)
    conv2_n: int = 16                # ~94% sparse
    linear_n: int = 16
    # k-WTA winners
    conv_k: int = 8                  # of 64 channels (~88% sparse)
    linear_k: int = 180              # of 1500 (88% sparse, paper Fig. 10)
    kwta_impl: str = "topk"

    @property
    def weight_sparse(self) -> bool:
        return self.variant in ("sparse_dense", "sparse_sparse")

    @property
    def activation_sparse(self) -> bool:
        return self.variant == "sparse_sparse"

    @property
    def hidden_padded(self) -> int:
        return pad_to_multiple(self.hidden, self.linear_n)


def init_model(cfg: GSCConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``
    with the reference's distributions and its numpy route seeds (41, 42,
    43), so the routes equal the reference's.  Runs on ``cuda`` unless
    ``device`` says otherwise."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    c = cfg.channels
    if cfg.weight_sparse:
        params = {
            "conv1": packed_conv2d_init(gen, 5, 5, 1, c,
                                        SparsityConfig(n=cfg.conv1_n),
                                        seed=41),
            "conv2": packed_conv2d_init(gen, 5, 5, c, c,
                                        SparsityConfig(n=cfg.conv2_n),
                                        seed=42),
            "linear": packed_linear_init(gen, 5 * 5 * c, cfg.hidden_padded,
                                         SparsityConfig(n=cfg.linear_n),
                                         seed=43),
            "out": linear_init(gen, cfg.hidden_padded, cfg.n_classes)}
        return drop_partition_major(params)
    return {"conv1": conv2d_init(gen, 5, 5, 1, c),
            "conv2": conv2d_init(gen, 5, 5, c, c),
            "linear": linear_init(gen, 5 * 5 * c, cfg.hidden),
            "out": linear_init(gen, cfg.hidden, cfg.n_classes)}


def _relu_or_kwta(h: torch.Tensor, cfg: GSCConfig) -> torch.Tensor:
    h = torch.relu(h)
    return kwta_channel(h, cfg.conv_k) if cfg.activation_sparse else h


def forward(params, x: torch.Tensor, cfg: GSCConfig) -> torch.Tensor:
    """x: (B, 32, 32, 1) -> logits (B, n_classes)."""
    c = cfg.channels
    act_sparse = cfg.activation_sparse

    # --- Conv-1 (stem): weight-sparse at most; input is dense (paper §5.4)
    if cfg.weight_sparse:
        h = packed_conv2d_apply(params["conv1"], x,
                                SparsityConfig(n=cfg.conv1_n), 5, 5)
    else:
        h = conv2d_apply(params["conv1"], x)
    h = maxpool2d(_relu_or_kwta(h, cfg))                 # (B, 14, 14, 64)

    # --- Conv-2: sparse-sparse heart of the network
    if cfg.weight_sparse:
        sp2 = SparsityConfig(
            n=cfg.conv2_n, k_frac=(cfg.conv_k / c) if act_sparse else None)
        h = packed_conv2d_apply(params["conv2"], h, sp2, 5, 5,
                                x_is_sparse=act_sparse)
    else:
        h = conv2d_apply(params["conv2"], h)
    h = maxpool2d(_relu_or_kwta(h, cfg))                 # (B, 5, 5, 64)
    h = h.reshape(h.shape[0], -1)                        # (B, 1600)

    # --- Linear-1 (+ global k-WTA, paper Fig. 10's 1500-element example)
    if cfg.weight_sparse:
        spl = SparsityConfig(
            n=cfg.linear_n,
            k_frac=(cfg.linear_k / cfg.hidden_padded) if act_sparse else None,
            kwta_impl=cfg.kwta_impl)
        h = packed_linear_apply(params["linear"], h, spl)
    else:
        h = linear_apply(params["linear"], h)
    h = torch.relu(h)
    if act_sparse:
        h = (kwta_hist(h, cfg.linear_k) if cfg.kwta_impl == "hist"
             else kwta(h, cfg.linear_k))

    return linear_apply(params["out"], h)


def loss_fn(params, batch, cfg: GSCConfig):
    """Mean cross-entropy of the logits against ``batch["y"]``.
    Returns (loss, {"loss", "accuracy"})."""
    logits = forward(params, batch["x"], cfg)
    labels = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"loss": loss, "accuracy": acc}


def theoretical_macs(cfg: GSCConfig) -> Dict[str, float]:
    """Per-sample MAC counts (the paper's Figure 1 accounting)."""
    c, hp = cfg.channels, cfg.hidden_padded
    dense = {
        "conv1": 28 * 28 * c * 25,
        "conv2": 10 * 10 * c * 25 * c,
        "linear": 1600 * cfg.hidden,
        "out": cfg.hidden * cfg.n_classes,
    }
    w = {  # weight sparsity reduction
        "conv1": cfg.conv1_n, "conv2": cfg.conv2_n, "linear": cfg.linear_n,
        "out": 1,
    }
    a = {  # activation sparsity reduction (inputs to each layer)
        "conv1": 1.0,
        "conv2": c / cfg.conv_k,
        "linear": c / cfg.conv_k,
        "out": hp / cfg.linear_k,
    }
    total_dense = sum(dense.values())
    sd = sum(v / w[k] for k, v in dense.items())
    ss = sum(v / (w[k] * a[k]) for k, v in dense.items())
    return {"dense": total_dense, "sparse_dense": sd, "sparse_sparse": ss,
            "speedup_sd": total_dense / sd, "speedup_ss": total_dense / ss}

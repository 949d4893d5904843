"""The frozen work formulas and peaks equal the program's formulas they
were copied from, at the cells' shapes."""

import importlib

import pytest
import torch

from counts import flops, peaks, topk_gather
from _perfbench_util import file_cell
from harness.model_cfg import port_config

CELLS = ["smollm-360m.chat4", "deepseek-v2-lite-16b.chat4"]


@pytest.mark.parametrize("name", CELLS)
def test_topk_gather_cost_frozen(name):
    K = importlib.import_module("repro_torch.kernels.topk_gather")
    cell = file_cell(name)
    cfg = port_config(cell.config)
    shape = topk_gather.launch_shape(cfg, cell.traffic["slots"])
    want = K.cost(shape["b"], shape["k"], shape["p"], shape["g"],
                  shape["n"], shape["r"], torch.bfloat16, torch.int64,
                  torch.bfloat16, torch.bfloat16)
    assert topk_gather.cost(**shape) == (want.flops, want.bytes)
    assert topk_gather.TENSOR_CORES == want.tensor_cores
    from repro_torch.launch.roofline import kernel_bound
    assert peaks.kernel_bound_s(want.flops, want.bytes, want.tensor_cores) \
        == kernel_bound(want)[0]


def test_peaks_frozen():
    from repro_torch.launch import roofline as R
    assert (peaks.BF16_FLOPS, peaks.F32_FLOPS, peaks.HBM_BYTES) == \
        (R.PEAK_FLOPS, R.F32_FLOPS, R.HBM_BW)


@pytest.mark.parametrize("shape", [(4, 960, 2560, 4), (32, 2560, 960, 4),
                                   (1, 2048, 1408, 4), (16384, 960, 2560, 4)])
def test_product_flops_frozen(shape):
    from repro_torch.core import functional as F
    b, i, o, n = shape
    assert flops.flops_dense(b, i, o) == F.flops_dense(b, i, o)
    assert flops.flops_cs_matmul(b, i, o, n) == F.flops_cs_matmul(b, i, o, n)


def test_step_counts_at_cell_shapes():
    cfg = port_config(file_cell("smollm-360m.chat4").config)
    per_token = flops.token_weights_flops(cfg)
    # 32 layers of GQA (d 960, 15 + 2x5 heads of 64) and the packed FFN
    # (2560 wide, 1/4 dense, 320 winners), and the 49152-row head
    attn = 2 * 960 * 25 * 64 + 2 * 960 * 960
    ffn = 2 * (2 * 960 * 2560 // 4) + 2 * 320 * 960 // 4
    assert per_token == 32 * (attn + ffn) + 2 * 960 * 49152
    assert flops.decode_step_flops(cfg, [10, 20]) == 2 * per_token + \
        32 * 2 * 15 * 2 * 64 * 30
    assert flops.train_step_flops(cfg, 1, 2) == 3 * (
        2 * per_token + 32 * 2 * 15 * 2 * 64 * 3)

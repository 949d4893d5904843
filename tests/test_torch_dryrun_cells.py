"""Dry-run cells at reduced width on a fake 2x2 process group.

A cell's ``full`` census equals n_units·``unit`` + ``head`` (+ ``opt``
for train) to within 3% of FLOPs: what the parts leave out is the
embedding lookup (decode, prefill) and, for train, the batch statistics'
sums and the gathers' copies (measured: at most 2.2%, on internvl2's
vision prefix)."""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D

SHAPES = {"decode": ShapeConfig("decode_t", 64, 8, "decode"),
          "train": ShapeConfig("train_t", 32, 4, "train"),
          "prefill": ShapeConfig("prefill_t", 32, 4, "prefill")}
CELLS = [("smollm-360m", "decode"), ("smollm-360m", "train"),
         ("smollm-360m", "prefill"), ("deepseek-v2-lite-16b", "decode"),
         ("deepseek-v2-lite-16b", "train"), ("qwen3-moe-235b-a22b", "train"),
         ("musicgen-large", "decode"), ("internvl2-2b", "train"),
         ("internvl2-2b", "prefill")]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell(arch, kind):
    return D.compile_cell(arch.replace("-", "_"), SHAPES[kind], False,
                          cfg_override=get_config(arch).reduced(),
                          device="cpu", mesh_dims=(2, 2))


@pytest.mark.parametrize("arch,kind", CELLS)
def test_full_is_the_sum_of_its_parts(arch, kind):
    rec = _cell(arch, kind)
    assert rec["ok"] and rec["mesh"] == "2x2"
    parts = rec["n_units"] * rec["unit"]["cost"]["flops"] \
        + rec["head"]["cost"]["flops"]
    if kind == "train":
        parts += rec["opt"]["cost"]["flops"]
    full = rec["full"]["cost"]["flops"]
    assert abs(parts / full - 1) <= 0.03, (parts, full)
    # a rank of a 2x2 mesh talks to the others, and never to the host
    assert rec["full"]["collectives"]["total_bytes"] > 0
    assert rec["full"]["host_transfers"] == []
    mem = rec["full"]["memory"]
    assert mem["peak_bytes_est"] >= mem["argument_bytes"] > 0


def test_an_ssm_serving_cell_records_its_queue_item():
    with pytest.raises(NotImplementedError, match="item 5"):
        _cell("zamba2-1.2b", "decode")

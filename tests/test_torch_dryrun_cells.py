"""Dry-run cells at reduced width on a fake 2x2 process group.

A cell's ``full`` census equals n_units·``unit`` + ``head`` (+ ``opt``
for train, without remat) to within 3% of FLOPs: what the parts leave
out is the embedding lookup (decode, prefill) and, for train, the batch
statistics' sums and the gathers' copies (measured: at most 2.2%, on
internvl2's vision prefix)."""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D

SHAPES = {"decode": ShapeConfig("decode_t", 64, 8, "decode"),
          "long": ShapeConfig("long_t", 64, 1, "decode"),
          "train": ShapeConfig("train_t", 32, 4, "train"),
          "prefill": ShapeConfig("prefill_t", 32, 4, "prefill")}
CELLS = [("smollm-360m", "decode"), ("smollm-360m", "train"),
         ("smollm-360m", "prefill"), ("deepseek-v2-lite-16b", "decode"),
         ("deepseek-v2-lite-16b", "train"), ("qwen3-moe-235b-a22b", "train"),
         ("musicgen-large", "decode"), ("internvl2-2b", "train"),
         ("internvl2-2b", "prefill"),
         # the SSM/hybrid serving cells: prefill, decode and, at a batch
         # of one, decode_long
         ("zamba2-1.2b", "prefill"), ("zamba2-1.2b", "decode"),
         ("zamba2-1.2b", "long"), ("xlstm-350m", "prefill"),
         ("xlstm-350m", "decode"), ("xlstm-350m", "long")]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell(arch, kind, remat=None):
    """The cell on a fake 2x2 group; a train cell without remat unless
    ``remat`` says so (the parts count no recompute: the reference's
    accounting steps run without remat)."""
    remat = kind != "train" if remat is None else remat
    return D.compile_cell(arch.replace("-", "_").replace(".", "p"),
                          SHAPES[kind], False,
                          cfg_override=get_config(arch).reduced(remat=remat),
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


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b"])
def test_remat_recomputes_the_forward_and_lowers_the_peak(arch):
    """With remat the train step's census adds one forward of the blocks
    (a quarter to a half of their forward and backward) and its peak
    falls."""
    plain, remat = _cell(arch, "train"), _cell(arch, "train", remat=True)
    extra = remat["full"]["cost"]["flops"] - plain["full"]["cost"]["flops"]
    blocks = plain["n_units"] * plain["unit"]["cost"]["flops"]
    assert 0.25 < extra / blocks < 0.5, extra / blocks
    assert remat["full"]["memory"]["peak_bytes_est"] < \
        plain["full"]["memory"]["peak_bytes_est"]


def test_an_ssm_serving_cell_records_its_queue_item():
    """zamba2's decode_long cell, which raised with its queue item before
    the SSM patterns served on a mesh: each Mamba2 block gathers its
    projection and its conv and sums its norm and its out projection
    over ``model``; each shared attention block gathers q/k/v and the FFN
    hidden and combines its softmax (max, then sums) over the cache rows'
    axes, ``data`` and ``model``; the lookup sums and the logits
    gather."""
    rec = _cell("zamba2-1.2b", "long")
    cfg = get_config("zamba2-1.2b").reduced()
    n_mamba = cfg.block_pattern.count("mamba2") * cfg.n_units
    n_shared = cfg.block_pattern.count("shared_attn") * cfg.n_units
    c = rec["full"]["collectives"]
    assert rec["ok"] and rec["kind"] == "decode" and \
        rec["global_batch"] == 1
    assert c["all-gather_count"] == 2 * n_mamba + 2 * n_shared + 1
    assert c["all-reduce_count"] == 2 * n_mamba + 2 * n_shared + 1


def test_prefill_cells_count_the_prefill_step(monkeypatch):
    """A prefill cell counts ``make_prefill_step`` (the forward's
    last-position logits), as the reference's does, and never the fused
    prefill that writes a cache."""
    made = []

    def step(cfg):
        made.append(cfg.remat)
        return prefill_step(cfg)

    def no_prefill(*a, **kw):
        raise AssertionError("the cell ran the fused prefill")

    prefill_step = D.St.make_prefill_step
    monkeypatch.setattr(D.St, "make_prefill_step", step)
    monkeypatch.setattr(D.T, "prefill", no_prefill)
    assert _cell("smollm-360m", "prefill")["ok"]
    assert made == [True]

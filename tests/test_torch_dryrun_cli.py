"""The dry run (``repro_torch.launch.dryrun``) at full size: nothing
allocated while a 235B cell traces on 16x16, and the command line (the
reference's record keys, a failed cell recorded, its cells and
overrides)."""

import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import steps as RSt
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096


def test_a_235b_cell_traces_without_allocating():
    """qwen3-moe-235b-a22b's decode_32k step on 16x16: the census counts
    the rank's params and cache (~12 GB) while the process grows by less
    than 1% of that."""
    D.compile_cell("smollm_360m", "decode_32k", False, device="cpu",
                   cfg_override=get_config("smollm-360m").reduced())
    before = _rss()
    rec = D.compile_cell("qwen3_moe_235b_a22b", "decode_32k", False,
                         device="cpu", accounting=False)
    grown = _rss() - before
    counted = rec["full"]["memory"]["argument_bytes"]
    assert counted > 10e9
    assert grown < 0.01 * counted, (grown, counted)
    assert rec["full"]["host_transfers"] == []
    assert rec["full"]["collectives"]["all-gather_count"] > 0


def _ref_floats(arch) -> int:
    params_s, _ = RSt.abstract_params(ref_config(arch))
    return sum(math.prod(x.shape) for x in jax.tree.leaves(params_s)
               if jnp.issubdtype(x.dtype, jnp.floating))


REF_TOP_KEYS = {"arch", "shape", "mesh", "kind", "n_units", "pattern",
                "seq_len", "global_batch", "time", "full", "unit", "head",
                "n_params", "ok", "wall_s"}


def test_the_cli_writes_the_reference_records(tmp_path, capsys):
    out = tmp_path / "results.json"
    assert D.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                   "--mesh", "pod1", "--device", "cpu", "--out",
                   str(out)]) == 0
    # a cell that raises (here: a block kind no model knows) is recorded
    assert D.main(["--arch", "zamba2-1.2b", "--shape", "decode_32k",
                   "--mesh", "pod1", "--device", "cpu", "--out", str(out),
                   "--no-accounting", "--override", "block_pattern=x"]
                  ) == 0
    log = capsys.readouterr().out
    assert "[OK  ] smollm_360m|decode_32k|pod1" in log
    assert "[FAIL] zamba2_1p2b|decode_32k|pod1" in log
    results = json.loads(out.read_text())
    rec = results["smollm_360m|decode_32k|pod1"]
    assert set(rec) == REF_TOP_KEYS
    assert rec["mesh"] == "16x16" and rec["ok"] is True
    assert set(rec["full"]) >= {"memory", "cost", "collectives"}
    assert set(rec["full"]["cost"]) >= {"flops", "bytes_accessed",
                                        "transcendentals"}
    assert set(rec["full"]["memory"]) >= {
        "argument_bytes", "output_bytes", "temp_bytes", "peak_bytes_est"}
    assert rec["n_params"] == _ref_floats("smollm-360m")
    failed = results["zamba2_1p2b|decode_32k|pod1"]
    assert failed["ok"] is False and "unknown block kind" in failed["error"]
    # a second run skips what is done, as the reference's does
    D.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--mesh",
            "pod1", "--device", "cpu", "--out", str(out)])
    assert "[skip] smollm_360m|decode_32k|pod1" in capsys.readouterr().out


def test_overrides_and_cells_are_the_reference():
    """The reference's cells (``repro.launch.dryrun.iter_cells``; that
    module is not imported here: it sets the XLA device count at import)."""
    cfg = D.apply_overrides(get_config("smollm-360m"),
                            "kv_cache_dtype='int8',ffn_sparsity.n=8")
    assert cfg.kv_cache_dtype == "int8" and cfg.ffn_sparsity.n == 8
    want = [(a, s, mp) for a in REF_ARCH_IDS for s in REF_SHAPES
            if s != "long_500k" or a in ("xlstm_350m", "zamba2_1p2b")
            for mp in (False, True)]
    assert list(D.iter_cells("both")) == want
    assert D.train_overrides("qwen3_moe_235b_a22b").moment_dtype == \
        "bfloat16"
    assert D.train_overrides("smollm_360m") == D.TrainConfig()

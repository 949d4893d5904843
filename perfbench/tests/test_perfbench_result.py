"""The result line, from runs whose look for a card is skipped (the CPU,
the port's reduced sizes), and the refusals of ``run.py`` itself."""

import json
import shutil
import subprocess
import sys

import pytest

from _perfbench_util import ROOT, run_small
from harness.cells import result_line

INFO = {"platform": "gpu", "kind": "a stand-in", "count": 1}
CELL = "deepseek-v2-lite-16b.chat4"


def _shape(line, cell, trace):
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert isinstance(line["correct"], bool)
    want = cell.per_layer if trace else cell.end_to_end
    names = {m["name"]: m["unit"] for m in want}
    for name, m in line["metrics"].items():
        assert names[name] == m["unit"] and isinstance(m["value"], float)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


@pytest.mark.parametrize("trace", [False, True])
def test_serve_line(trace):
    cell, out = run_small(CELL, trace=trace)
    line = result_line(cell, out, trace, INFO)
    _shape(line, cell, trace)
    if not trace:
        assert set(line["metrics"]) == {"gen_tok_s", "setup_s"}
    else:
        assert {"engine.decode_step_ms", "engine.itl_p95_ms",
                "model.prefill_ms", "scheduler.sample_ms",
                "step.mfu.decode"} <= set(line["metrics"])
    assert line["attempted"] % 8 == 0 and line["failed"] == 0


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          CELL, "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          CELL, "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""

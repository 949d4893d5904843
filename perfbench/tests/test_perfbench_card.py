"""The controls at the cells' own sizes, on the card (``-m card``; they
skip without a CUDA device): each cell's control, the program serving
weights rounded to fp8, has to come out not correct under the cell's
limits, and a sound run of the program correct."""

import importlib.util
import json

import pytest

from _perfbench_util import BENCH
from harness.spec import find_cell, load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
SEED = 6000000001


def _control(name):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_control_{name}", BENCH / "controls" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_serving_control_fails(name, card, capsys):
    assert _control("serve").main(["--workload", name, "--seeds",
                                   str(SEED), "--side", "both"]) == 0
    rows = {r["side"]: r for r in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{")) if "side" in r}
    for number, lim in find_cell(name).limits.items():
        assert rows["program"][number] <= lim["limit"] \
            < rows["fp8_weights"][number]

"""Small versions of the cells for the CPU tests: the port's reduced
configuration (float32 unless asked otherwise) and the configuration
file's keys made to agree with it."""

import dataclasses
import json
import time
from pathlib import Path

from harness.model_cfg import implied_keys
from harness.spec import Cell, find_cell, load_benchmark

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def hook(dtype="float32"):
    def cut(cfg, conf):
        small = dataclasses.replace(cfg.reduced(), compute_dtype=dtype)
        conf = dict(conf)
        for k, v in implied_keys(small, conf["model_type"]).items():
            if k not in ("ffn_sparsity", "capacity_factor"):
                conf[k] = v
        return small, conf
    return cut


#: a serving mix's sizes cut for the CPU (the distributions' shapes kept)
SMALL_SERVE = {"prompt_len": {"dist": "log_uniform", "min": 16, "max": 96},
               "output_len": {"dist": "log_uniform", "min": 4, "max": 24},
               "max_seq": 128}


#: cells the tests build from files where BENCHMARK.json does not list
#: them: {name: (configuration, mix)}
UNLISTED = {"smollm-360m.chat4": ("smollm-360m", "chat4"),
            "smollm-360m.batch32": ("smollm-360m", "chat32")}


def file_cell(name):
    """The cell ``name`` (``UNLISTED``'s, else ``<config>.<mix>``) built
    from its configuration and mix files alone, listed in BENCHMARK.json
    or not: no metrics and no limits (the tests of a family's reference
    and of the harness read the check's numbers themselves)."""
    config, traffic = UNLISTED.get(name) or name.rsplit(".", 1)
    conf = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    mix = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    return Cell(name, config, traffic, 1, conf, mix, [], [], {})


def small_cell(name, **traffic):
    """The cell ``name`` (as BENCHMARK.json lists it, else as
    :func:`file_cell` builds it) with its traffic cut to the CPU's sizes
    and, where given, further keys replaced."""
    listed = {w["name"] for w in load_benchmark(ROOT)["workloads"]}
    cell = find_cell(name) if name in listed else file_cell(name)
    return dataclasses.replace(cell, traffic={**cell.traffic, **SMALL_SERVE,
                                              **traffic})


def run_small(name, seed=2**31 + 7, seconds=0.5, trace=False,
              dtype="float32", traffic=None):
    from harness.cells import run_cell
    cell = small_cell(name, **(traffic or {}))
    return cell, run_cell(cell, seed, seconds, trace, "cpu",
                          time.perf_counter(), hook(dtype))

"""The benchmark's description: every name in BENCHMARK.json resolves to
its files, the file keeps the contract's shapes, the configuration files
agree with the port's configurations, and a new configuration, mix,
metric and cell need new files and entries only."""

import json
import re
import shutil

import pytest

from _perfbench_util import BENCH, ROOT
from harness.model_cfg import FROM_FILE, mismatches, port_config
from harness.spec import find_cell, load_benchmark, metric_reader

BENCHMARK = load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
CONFIG_FILES = sorted(p.name for p in (BENCH / "configs").glob("*.json"))


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["perfbench"]
    assert BENCHMARK["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCHMARK["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_and_reports(cell):
    c = find_cell(cell, root=ROOT)
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(metric_reader(m["name"], ROOT))
    assert c.limits and all("limit" in v for v in c.limits.values())


@pytest.mark.parametrize("file", CONFIG_FILES,
                         ids=lambda f: f[:-len(".json")])
def test_config_file_agrees_with_port(file):
    """Every configuration file: the port's configuration it names, with
    the keys the harness sets from the file, computes every size the file
    states; its entry in BENCHMARK.json, where listed, agrees with it."""
    data = json.loads((BENCH / "configs" / file).read_text())
    cfg = port_config(data)
    assert mismatches(data, cfg) == {}
    for key, field in FROM_FILE.items():
        assert getattr(cfg, field) == data[key]
    assert sorted(data["published"]) == sorted(data["reduced"])
    for k, v in data["published"].items():
        assert data[k] != v
    entry = [c for c in BENCHMARK["configs"]
             if c["file"] == f"perfbench/configs/{file}"]
    for conf in entry:
        assert data["source"] == conf["source"]
        assert sorted(data["reduced"]) == sorted(conf["reduced"])


def test_listed_configs_have_files():
    assert all(c["file"].split("/")[-1] in CONFIG_FILES
               for c in BENCHMARK["configs"])


def test_new_entries_need_new_files_only(tmp_path):
    """A copy of the benchmark with one more configuration, mix, metric
    and cell, each added as a file and an entry: the harness finds them."""
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "perfbench" / "configs" / "dummy-cfg.json").write_text(
        (BENCH / "configs" / "smollm-360m.json").read_text())
    (tmp_path / "perfbench" / "traffic" / "dummy-mix.json").write_text(
        json.dumps(dict(json.loads((BENCH / "traffic" / "chat4.json")
                                   .read_text()), slots=2)))
    (tmp_path / "perfbench" / "metrics" / "dummy.metric.py").write_text(
        "def read(record):\n    return 1.0\n")
    (tmp_path / "perfbench" / "limits" / "dummy-cfg.dummy-mix.json"
     ).write_text(json.dumps({"logit_gap": {"limit": 1.0}}))
    bench["configs"].append(dict(bench["configs"][0], name="dummy-cfg",
                                 file="perfbench/configs/dummy-cfg.json"))
    bench["workloads"].append({"name": "dummy-cfg.dummy-mix",
                               "config": "dummy-cfg", "traffic": "dummy-mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.metric", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "a test", "moves": "gen_tok_s",
                               "workloads": ["dummy-cfg.dummy-mix"]})
    bench["end_to_end"][0]["workloads"].append("dummy-cfg.dummy-mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = find_cell("dummy-cfg.dummy-mix", root=tmp_path)
    assert cell.traffic["slots"] == 2
    assert "dummy.metric" in [m["name"] for m in cell.per_layer]
    assert metric_reader("dummy.metric", tmp_path)({}) == 1.0
    assert cell.limits == {"logit_gap": {"limit": 1.0}}

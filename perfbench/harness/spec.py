"""Find a cell and everything it names, by name.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), their configurations and the metrics.  Each name maps to
files under ``perfbench/``:

* a configuration ``<c>``: ``configs/<c>.json`` (the ``file`` of its entry);
* a traffic mix ``<t>``: ``traffic/<t>.json``;
* a per-layer metric ``<m>``: ``metrics/<m>.py``, whose ``read(record)``
  returns the value or None;
* a cell ``<w>``: ``limits/<w>.json``, the limits its output check holds;
* a reference family ``<f>`` (a configuration's ``model_type``):
  ``reference/<f>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

#: the folder of the benchmark (``perfbench/``)
BENCH_DIR = Path(__file__).resolve().parents[1]
#: the root of the checkout
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One ``workloads`` entry with what it names."""
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict          # the configuration file
    traffic: Dict         # the traffic file
    end_to_end: List[Dict]    # the end-to-end metrics this cell reports
    per_layer: List[Dict]     # the per-layer metrics this cell reports
    limits: Dict          # the output check's limits


def load_benchmark(root: Path = ROOT) -> Dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _reports(metric: Dict, cell: str, e2e_of_cell: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    key lists, else every cell that reports the end-to-end metric it
    moves (or, for an end-to-end metric, every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_of_cell
    return True


def find_cell(name: str, bench: Optional[Dict] = None,
              root: Path = ROOT) -> Cell:
    """The ``workloads`` entry ``name`` with everything it names: its
    configuration and mix files, the metrics it reports and its limits
    (a cell has to have its limits file)."""
    bench = bench if bench is not None else load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "perfbench" / "traffic" /
                      f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    limits_path = root / "perfbench" / "limits" / f"{name}.json"
    if not limits_path.is_file():
        raise FileNotFoundError(f"no limits for {name} under "
                                "perfbench/limits/")
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), conf, mix,
                e2e, per_layer, json.loads(limits_path.read_text()))


def load_module(path: Path, name: str):
    """Import the Python file ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(record)`` function of per-layer metric ``name``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    return load_module(path, "perfbench_metric_" + name.replace(".", "_")
                       .replace("-", "_")).read


def reference_module(model_type: str):
    """The plain reference of a configuration family
    (``perfbench/reference/<model_type>.py``, with ``perfbench/`` on the
    import path)."""
    return importlib.import_module(f"reference.{model_type}")

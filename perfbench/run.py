"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` names the cells).  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced, the
``breakdown``; its last key, ``checks``, gives each number the output check
compared beside its limit, as the last lines of standard error do too.
It exits with 2 and prints no result where there is no CUDA device (or
fewer than the cell asks for), where the checkout lacks the program, or
where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names the run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def setup_paths() -> None:
    """The program from ``src/``, the harness from ``perfbench/``, and
    every build and kernel cache at a fixed path inside the checkout."""
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no program at {ROOT / 'src' / 'repro_torch'}")
    for p in (ROOT / "perfbench", ROOT / "src"):
        sys.path.insert(0, str(p))
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_paths()
    from harness.spec import find_cell
    try:
        cell = find_cell(args.workload, root=ROOT)
    except (FileNotFoundError, KeyError) as e:
        fail(str(e))
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} devices, "
             f"{torch.cuda.device_count()} present")
    from harness.cells import result_line, run_cell
    torch.cuda.reset_peak_memory_stats()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    bad = forbidden_modules()
    if bad:
        fail(f"modules loaded that the run may not load: {bad}")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips}
    line = result_line(cell, out, bool(args.trace), info)
    print(json.dumps({"perfbench_detail": out.get("check_detail", {}),
                      "window": out.get("window", {})}))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

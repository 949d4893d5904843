"""Print roofline terms for specific dry-run result keys (the reference's
``repro.launch.rooftool``, on the port's results file):

    PYTHONPATH=src python -m repro_torch.launch.rooftool KEY [KEY...] \\
        [--results experiments/dryrun_results_torch.json]
"""

import argparse
import json
import os
import sys

from repro_torch.configs import get_config
from repro_torch.launch.roofline import cell_roofline

DEFAULT_RESULTS = "experiments/dryrun_results_torch.json"


def show(path, keys):
    if not os.path.exists(path):
        raise SystemExit(
            f"rooftool: results file {path!r} not found — run the dry-run "
            f"sweep first (python -m repro_torch.launch.dryrun) or point "
            f"--results at an existing sweep output")
    with open(path) as f:
        results = json.load(f)
    for key in keys:
        rec = results.get(key)
        if rec is None:
            matches = [k for k in results if k.startswith(key)]
            for m in matches:
                show_one(m, results[m])
            if not matches:
                print(f"{key}: not found")
            continue
        show_one(key, rec)


def show_one(key, rec):
    if not rec.get("ok"):
        print(f"{key}: FAILED {rec.get('error','')[:120]}")
        return
    arch = key.split("|")[0]
    try:
        cfg = get_config(arch)
    except KeyError:
        cfg = None
    rl = cell_roofline(rec, cfg)
    if rl is None:
        print(f"{key}: no accounting data")
        return
    print(f"{key}:")
    print(f"  compute={rl['compute_s']*1e3:9.2f}ms  "
          f"memory={rl['memory_s']*1e3:9.2f}ms  "
          f"collective={rl['collective_s']*1e3:9.2f}ms  "
          f"-> {rl['bottleneck']}-bound")
    print(f"  mem/dev={rec['full']['memory'].get('peak_bytes_est',0)/1e9:.2f}GB  "
          f"useful={rl.get('useful_fraction',0):.3f}  "
          f"MFU@bound={rl.get('mfu_at_bound',0)*100:.2f}%")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.rooftool",
        description="Print roofline terms for dry-run result keys "
                    "(prefix match).")
    p.add_argument("keys", nargs="+", metavar="KEY",
                   help="result key or key prefix (e.g. 'smollm_360m|')")
    p.add_argument("--results", default=DEFAULT_RESULTS, metavar="PATH",
                   help=f"dry-run results JSON (default: {DEFAULT_RESULTS})")
    args = p.parse_args(argv)
    show(args.results, args.keys)
    return 0


if __name__ == "__main__":
    sys.exit(main())

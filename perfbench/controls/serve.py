"""The serving cells' control and the readings their limit is set from.

    python3 perfbench/controls/serve.py --workload <cell> --seeds a,b,c \
        [--side program|fp8_weights|both] [--calls 1]

For each seed and side, in one process: draw the weights, serve ``--calls``
calls of the cell's traffic through the program at the cell's size (a call
finishes all of its requests), check every finished request as a run does,
and print one JSON line with every number the check gives (the cell's
limits name those compared):

* side ``program``: the program as a run serves it; the lower reading of
  each number is the largest over the seeds;
* side ``fp8_weights``: the control, the program serving every weight of
  a product rounded to float8 e4m3 (one scale a tensor, stored back in the
  served dtype: the step below the configuration's bfloat16), checked
  against the float32 reference on the weights as drawn; the upper reading
  is the smallest over the seeds.

The last line gives both readings of each number the cell's limits name.
The benchmark's runs never run this; it needs a CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIDES = ("program", "fp8_weights")


def fp8_weights(tree, cfg):
    """A copy of the drawn weights with every weight of a product rounded
    to float8 e4m3 (one scale a tensor) and stored back in its dtype; the
    embedding is rounded only where it is the head too, and norm scales
    and route tables are kept."""
    import torch
    from reference.common import FP8_MAX

    def rnd(x):
        s = torch.clamp(x.float().abs().amax(), min=1e-30) / FP8_MAX
        return ((x.float() / s).to(torch.float8_e4m3fn).float() * s
                ).to(x.dtype)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        if node.is_floating_point() and node.ndim >= 2 and (
                path[0] != "embed" or cfg.tie_embeddings):
            return rnd(node)
        return node
    return walk(tree, ())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", choices=SIDES + ("both",), default="both")
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (ROOT / "perfbench", ROOT / "src"):
        sys.path.insert(0, str(p))
    import torch
    from harness import serve as SV
    from harness import traffic as TR
    from harness.cells import _free
    from harness.model_cfg import port_config
    from harness.spec import find_cell, reference_module
    from harness.weights import draw
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = find_cell(args.workload, root=ROOT)
    conf, mix = cell.config, cell.traffic
    cfg = port_config(conf)
    ref = reference_module(conf["model_type"])
    sides = SIDES if args.side == "both" else (args.side,)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        for side in sides:
            t0 = time.perf_counter()
            weights = draw(cfg, seed, args.device)
            served = (weights if side == "program"
                      else fp8_weights(weights, cfg))
            engine = SV.engine_for(cfg, served, mix, args.device)
            stream = TR.ServeStream(mix, cfg.vocab_size, seed)
            calls = [SV.serve_call(engine, stream.call(i))
                     for i in range(args.calls)]
            del engine, served
            _free(args.device)
            found = SV.check_served(conf, weights, SV.finished(calls),
                                    int(mix["max_seq"]), ref, args.device,
                                    with_pads=cfg.is_moe, control=True)
            row = {"seed": seed, "side": side, **found,
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del weights
            _free(args.device)
    summary = {"workload": cell.name, "seeds": len(rows) // len(sides)}
    for number in cell.limits:
        for side, key, pick in (("program", "lower", max),
                                ("fp8_weights", "upper", min)):
            vals = [r[number] for r in rows if r["side"] == side]
            if vals:
                summary[f"{number}_{key}"] = pick(vals)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

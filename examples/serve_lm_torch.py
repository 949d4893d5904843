"""Serve a (reduced) assigned-architecture LM with the PyTorch port's
continuous-batching engine: fused one-call prefill, slot-based KV cache,
mid-flight admission, greedy or temperature/top-k sampling — the decode
path the sparse-sparse topk dispatch targets.  On the card every decode
down projection of a sparse FFN whose B·K lies below its d_ff runs the
``topk_gather`` CUDA kernel.

Runs with telemetry on and ends with a human-readable summary: throughput,
TTFT p50/p95, stage breakdown, and the realized k/N per sparse layer (what
fraction of each FFN actually fired, vs the configured k).  The lines are
``examples/serve_lm.py``'s; the mesh is the reference's 1x1, which needs
no process group.

Run: PYTHONPATH=src python examples/serve_lm_torch.py --arch smollm-360m
     [--device cpu]

It runs on ``cuda`` unless ``--device`` names another device, and raises
where there is no CUDA device and none is named.
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import Engine
from repro_torch.models.common import resolve_device
from repro_torch.obs import Telemetry
from repro_torch.runtime.scheduler import Request, SamplingParams

MAX_SEQ = 64


def _ms(v):
    return "n/a" if v is None else f"{v * 1e3:.0f}ms"


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--no-telemetry", action="store_true",
                    help="serve without tracing/metrics (skips the summary)")
    ap.add_argument("--telemetry-jsonl", default=None, metavar="PATH",
                    help="also stream span/request events to a JSONL file")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def build_requests(vocab, n, gen, temperature=0.0, top_k=0):
    """Mixed prompt lengths and budgets, the case continuous batching
    wins: prompt 8 + 4·(i mod 3), budget gen - 4·(i mod 3), seed i."""
    rng = np.random.default_rng(0)
    return [Request(uid=i,
                    prompt=rng.integers(0, vocab, 8 + 4 * (i % 3)).tolist(),
                    max_new_tokens=max(1, gen - 4 * (i % 3)),
                    sampling=SamplingParams(temperature=temperature,
                                            top_k=top_k, seed=i))
            for i in range(n)]


def summary(snap):
    """Print the telemetry block; returns what it printed."""
    hists = snap["metrics"]["histograms"]
    ttft = hists.get("serve.ttft_s", {})
    itl = hists.get("serve.itl_s", {})
    print("-- telemetry ----------------------------------------------")
    print(f"  ttft  p50 {_ms(ttft.get('p50'))}  p95 {_ms(ttft.get('p95'))}")
    print(f"  itl   p50 {_ms(itl.get('p50'))}  p95 {_ms(itl.get('p95'))}")
    stages = sorted(snap["stages"].items(), key=lambda kv: -kv[1]["total_s"])
    brk = "  ".join(f"{name} {t['total_s']:.2f}s" for name, t in stages)
    print(f"  stages: {brk}")
    layers = snap["sparsity"]["layers"]
    if layers:
        print("  realized sparsity (mean k/N fired per layer):")
        for name in sorted(layers):
            e = layers[name]
            rk = e.get("realized_k_frac")
            cfg_k = e.get("configured_k_frac")
            ov = e.get("winner_overlap")
            line = f"    {name}: k/N {rk:.4f}" if rk is not None \
                else f"    {name}: k/N n/a"
            if cfg_k:
                line += f" (configured {cfg_k:.4f})"
            if ov is not None:
                line += f", step-to-step winner overlap {ov:.2f}"
            print(line)
    else:
        print("  realized sparsity: no sparse layers in this config")
    return {"ttft_p50": ttft.get("p50"), "ttft_p95": ttft.get("p95"),
            "itl_p50": itl.get("p50"), "itl_p95": itl.get("p95"),
            "stages": {n: t["total_s"] for n, t in stages},
            "layers": {n: e.get("realized_k_frac")
                       for n, e in layers.items()}}


def main(argv=None, params=None, cfg=None):
    """Serve, print the reference's lines and return their numbers.
    ``params`` (the engine's serving params, e.g. bridged) and ``cfg``
    (their config; default ``get_config(arch).reduced()``) replace the
    engine's seeded weights."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced() if cfg is None else cfg
    mesh = make_mesh((1, 1), ("data", "model"), device)
    tel = (Telemetry.off() if args.no_telemetry
           else Telemetry.on(jsonl_path=args.telemetry_jsonl,
                             sparsity_every=4))
    engine = Engine(cfg, max_seq=MAX_SEQ, n_slots=args.slots,
                    telemetry=tel, device=device, params=params, mesh=mesh)
    reqs = build_requests(cfg.vocab_size, args.requests, args.gen,
                          args.temperature, args.top_k)
    out, stats = engine.serve(reqs)
    print(f"arch={cfg.name} served {len(out)} requests in "
          f"{stats['wall_s']:.2f}s: {stats['tok_s']:.1f} tok/s, "
          f"{stats['decode_steps']} decode steps, "
          f"{stats['prefill_calls']} prefill calls (1 per prompt)")
    for uid in sorted(out)[:2]:
        print(f"  req {uid} ({len(out[uid])} toks, "
              f"ttft {stats['ttft_s'][uid]*1e3:.0f}ms):", out[uid][:12])
    result = {"cfg": cfg, "requests": reqs, "out": out, "stats": stats,
              "telemetry": None}
    if tel.enabled:
        result["telemetry"] = summary(engine.metrics_snapshot())
        tel.close()
    return result


if __name__ == "__main__":
    main()

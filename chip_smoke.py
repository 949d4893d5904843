#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device — a CUDA device is present; its name and power limit.
2. build — nvcc builds every kernel of the serving path from the sources
   in this checkout.
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it (and a few more), then its time,
   its plain version's time and that of one PyTorch library call of the
   same function, with the weights cold in L2 as the serving path finds
   them (and warm, beside them), and the least time the card could take
   for the same bytes and flops.
4. serve — ``Engine.serve`` on the shipped smollm-360m config at full
   width (bf16, 4 slots, 8 requests, prompt 16, gen 16, the engine's
   random weights from seed 0); the kernel launch counts show the decode
   steps went through the kernels.  Then one decode step's device time
   alone, from a CUDA-graph replay of it, against the eager step's wall
   time, and the eager step's device activities under torch.profiler.
5. parity — the same weights in float32: one prefill and three decode
   steps through the kernel and through the PyTorch formula
   (``use_pallas="off"``) give the same logits.

The line before the last holds the card's name and power limit as
``nvidia-smi`` gives them; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and float32 rate
# outside the tensor cores, the units the topk_gather kernel uses.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# The FFN down projection of smollm-360m at decode with 4 slots:
# B=4 rows, K=k_for(2560)=320 winners, P=2560/4, G=960/4, N=4, R=G.
MAIN_SHAPE = dict(b=4, k=320, p=640, g=240, n=4, r=240)
# Every other shape the check runs: the decode batches 1 and 7 (the last
# with B*K < d_ff), the faithful per-group routes (R=1), and the three
# shapes of the reference kernel's sweep (kernels/registry.py), in f32.
CHECK_SHAPES = [
    (dict(MAIN_SHAPE), torch.bfloat16),
    (dict(MAIN_SHAPE, b=1), torch.bfloat16),
    (dict(MAIN_SHAPE, b=7), torch.bfloat16),
    (dict(MAIN_SHAPE, r=1), torch.bfloat16),
    (dict(b=4, k=16, p=32, g=8, n=4, r=8), torch.float32),
    (dict(b=8, k=32, p=64, g=16, n=4, r=16), torch.float32),
    (dict(b=2, k=8, p=16, g=4, n=4, r=4), torch.float32),
]
# Copies of the main shape's weights the timing rotates over: 64 x 1.2 MB
# of bf16 packed weights exceed the card's 50 MB L2.
COPIES = 64
# Device activities of the profiled decode step printed, longest first.
PROFILE_TOP = 12


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fns, runs: int = 50, per_run: int = 20) -> float:
    """Median device time of one call, in ms, of the callables ``fns``
    called in turn (one callable: the same operands every call, warm in
    L2; many on copies of the operands larger than L2 together: cold).

    Each run enqueues ``per_run`` calls behind a sleep kernel, so the
    events around them time the card back to back and not the host's
    enqueue; the median over ``runs`` runs is taken after a warm-up."""
    calls = itertools.cycle(fns if isinstance(fns, list) else [fns])
    for _ in range(5):
        next(calls)()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)   # ~10 ms: hides the enqueue below
        start.record()
        for _ in range(per_run):
            next(calls)()
        end.record()
        samples.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) / per_run
                            for s, e in samples]))


def kernel_operands(shape, dtype, seed):
    """The down projection's operands as the model makes them: a packed
    layer from ``packed_linear_init`` and the support of a k-WTA'd
    activation, on the card."""
    from repro_torch.core import SparsityConfig, kwta
    from repro_torch.core.layers import packed_linear_init
    from repro_torch.kernels import topk_support
    b, k, p, g, n, r = (shape[x] for x in "bkpgnr")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    layer = packed_linear_init(gen, p * n, g * n,
                               SparsityConfig(n=n, route_share=r),
                               bias=False, seed=seed)
    x = torch.randn((b, p * n), device="cuda", generator=gen)
    vals, p_idx, s_off = topk_support(kwta(x, k), k, n)
    return (vals, p_idx, s_off, layer["packed_p"].to(dtype), layer["route"],
            layer["packed"].to(dtype))


def bound(vals, p_idx, packed_p, route):
    """Least time (ms) for the card: each input byte read once (the packed
    rows and route rows of the partitions this support touches), the
    output written once, against 2·B·K·G f32 flops."""
    b, k = vals.shape
    p, g, n = packed_p.shape
    touched = int(torch.unique(p_idx).numel())
    nbytes = (b * k * 12                                  # vals, p_idx, s_off
              + touched * g * n * packed_p.element_size()  # packed rows
              + touched * route.shape[0] * n               # route rows
              + b * g * n * 4)                             # output
    flops = 2 * b * k * g
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels():
    from repro_torch.core.functional import decompress
    from repro_torch.kernels.topk_gather import topk_gather, topk_gather_plain
    worst = 0.0
    for i, (shape, dtype) in enumerate(CHECK_SHAPES):
        vals, p_idx, s_off, packed_p, route, _ = kernel_operands(
            shape, dtype, SEED + i)
        got = topk_gather(vals, p_idx, s_off, packed_p, route)
        want = topk_gather_plain(vals, p_idx, s_off, packed_p, route)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        # both accumulate in f32 and differ only in the order of the sums
        tol = 1e-3 * (1.0 + float(want.abs().max()))
        print(f"[kernels] topk_gather {shape} {str(dtype)[6:]}: "
              f"max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            fail(f"topk_gather disagrees with its plain version at {shape}")
        worst = max(worst, err)
    vals, p_idx, s_off, packed_p, route, packed = kernel_operands(
        MAIN_SHAPE, torch.bfloat16, SEED)
    # library yardstick, never called by the port: the scattered k-sparse
    # activation times the decompressed dense weight, one torch.matmul
    p, g, n = packed_p.shape
    x_dense = torch.zeros((vals.shape[0], p * n), dtype=torch.bfloat16,
                          device="cuda")
    x_dense.scatter_(1, (p_idx.long() * n + s_off.long()),
                     vals.to(torch.bfloat16))
    w_dense = decompress(packed, route)
    # On the serving path a layer's weights are cold: the other layers'
    # ~0.5 GB stream through L2 between two launches of one layer.  So the
    # reported times rotate over COPIES copies of the weights; the warm
    # times, printed beside them, reuse one copy.
    copies = [(packed_p.clone(), route.clone(), w_dense.clone())
              for _ in range(COPIES)]
    timed = {
        "kernel": lambda pp, rt, _: topk_gather(vals, p_idx, s_off, pp, rt),
        "plain": lambda pp, rt, _: topk_gather_plain(vals, p_idx, s_off, pp,
                                                     rt),
        "library": lambda pp, rt, wd: torch.matmul(x_dense, wd)}
    cold = {name: device_ms([functools.partial(fn, *c) for c in copies])
            for name, fn in timed.items()}
    warm = {name: device_ms(functools.partial(fn, *copies[0]))
            for name, fn in timed.items()}
    bound_ms, bound_by = bound(vals, p_idx, packed_p, route)
    for label, t in (("L2-cold", cold), ("L2-warm", warm)):
        print(f"[kernels] topk_gather at {MAIN_SHAPE} bf16, {label}: kernel "
              f"{t['kernel']:.5f} ms, plain {t['plain']:.5f} ms, library "
              f"{t['library']:.5f} ms")
    print(f"[kernels] bound {bound_ms:.6f} ms ({bound_by})")
    return {"name": "topk_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_gather.cu",
            "replaces": "src/repro/kernels/topk_gather.py:61",
            "max_abs_err": worst, "ms": cold["kernel"],
            "plain_ms": cold["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": cold["library"]}


def phase_serve():
    from repro_torch.configs import get_config
    from repro_torch.kernels.topk_gather import topk_gather
    from repro_torch.launch.serve import Engine
    from repro_torch.runtime.scheduler import Request
    cfg = get_config("smollm-360m")
    prompt_len, gen, n_req = 16, 16, 8
    engine = Engine(cfg, max_seq=prompt_len + gen + 1, n_slots=4,
                    device="cuda")
    rng = np.random.default_rng(SEED)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               prompt_len).tolist(),
                    max_new_tokens=gen) for i in range(n_req)]
    engine.serve(reqs[:1])                 # warm-up: cuBLAS, allocator
    engine.prefill_calls = 0
    topk_gather.launches = 0
    out, stats = engine.serve(reqs)
    launches = topk_gather.launches
    steps = stats["decode_steps"]
    print(f"[serve] smollm-360m full width bf16: {n_req} requests, "
          f"{steps} decode steps, {stats['prefill_calls']} prefill calls, "
          f"topk_gather launches {launches}")
    if stats["prefill_calls"] != n_req:
        fail(f"prefill_calls {stats['prefill_calls']} != {n_req}")
    if launches == 0 or launches != cfg.n_layers * steps:
        fail(f"topk_gather launched {launches} times, want "
             f"{cfg.n_layers} x {steps} decode steps")
    for uid in range(n_req):
        toks = out.get(uid, [])
        if len(toks) != gen or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            fail(f"request {uid} returned {toks}")
    ttft = float(np.mean(list(stats["ttft_s"].values())))
    step_ms = stats["decode_s"] / steps * 1e3
    print(f"[serve] {stats['tok_s']:.2f} tok/s, mean TTFT {ttft * 1e3:.2f} "
          f"ms, decode step {step_ms:.3f} ms (host clock, with sampling "
          "sync)")
    dev_ms = step_device_ms(engine)
    print(f"[serve] one decode step on the device alone (CUDA graph "
          f"replay): {dev_ms:.3f} ms; device idle share of the eager step "
          f"{1 - dev_ms / step_ms:.3f}")
    acts = step_profile(engine)
    if not acts:
        print("[serve] torch.profiler recorded no device activity: the "
              "step's kernel count is not measured")
    else:
        print(f"[serve] one eager decode step under torch.profiler: "
              f"{sum(c for c, _ in acts.values())} device activities, "
              f"{sum(t for _, t in acts.values()):.3f} ms busy; by time:")
        for name, (count, ms) in sorted(acts.items(),
                                        key=lambda kv: -kv[1][1])[:PROFILE_TOP]:
            print(f"[serve]   {ms:8.3f} ms {count:5d}x {name[:100]}")
    return launches


def _decode_step(engine):
    """One decode step of every slot at position 16, as a callable."""
    from repro_torch.models import transformer as T
    cache = engine.new_cache(engine.n_slots)
    batch = {"tokens": torch.zeros((engine.n_slots, 1), dtype=torch.int64,
                                   device="cuda")}
    pos = torch.full((engine.n_slots,), 16, device="cuda")
    return lambda: T.serve_step(engine.params, cache, batch, pos, engine.cfg)


def step_device_ms(engine):
    """Device time of one decode step, in ms: the step captured in a CUDA
    graph and replayed, so no host dispatch sits between its kernels.  The
    port itself runs the step eagerly; the graph only measures it."""
    step = _decode_step(engine)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad():
        with torch.cuda.stream(side):       # warm-up before capture
            for _ in range(3):
                step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
    return device_ms(graph.replay, runs=10, per_run=10)


def step_profile(engine):
    """The device activities (kernels, copies) of one eager decode step
    under ``torch.profiler``: {name: [count, ms]}, empty where the
    profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step = _decode_step(engine)
    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    return by_name


def phase_parity():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("smollm-360m"),
                              compute_dtype="float32")
    params = T.init_model(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    b, s, max_seq = 2, 16, 20
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).cuda()
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1))).cuda()
             for _ in range(3)]
    runs = {}
    for mode in ("auto", "off"):
        cfg_m = dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
            cfg.ffn_sparsity, use_pallas=mode))
        with torch.no_grad():
            logits, cache = T.prefill(params, {"tokens": prompt}, cfg_m,
                                      max_seq)
            rows = [logits[:, -1]]
            for i, tok in enumerate(steps):
                logits, cache = T.serve_step(params, cache, {"tokens": tok},
                                             s + i, cfg_m)
                rows.append(logits)
        runs[mode] = torch.stack(rows)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(runs["auto"]).all()):
        fail("non-finite logits")
    err = float((runs["auto"] - runs["off"]).abs().max())
    # f32 throughout; the kernel and the formula differ only in the order
    # of their sums, which 32 layers carry into the logits
    tol = 1e-3
    print(f"[parity] f32 prefill + 3 decode steps, kernel vs formula: "
          f"max_abs_err={err:.3e} (max |logit| "
          f"{float(runs['off'].abs().max()):.3f}) tol={tol:.0e}")
    if not err <= tol:
        fail("kernel path and formula path disagree")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import build
    smi = device_line()
    print(f"[device] {smi}; {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    result = build("topk_gather")
    print(f"[build] topk_gather: nvcc {result.seconds:.2f} s "
          f"({time.perf_counter() - t0:.2f} s with the cache check)")
    for line in result.log.splitlines():
        if "registers" in line or "smem" in line:
            print(f"[build]   {line.strip()}")

    t = time.perf_counter()
    row = phase_kernels()
    print(f"[kernels] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    row["launches"] = phase_serve()
    print(f"[serve] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_parity()
    print(f"[parity] done in {time.perf_counter() - t:.1f} s")

    print(json.dumps({"kernels": [row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

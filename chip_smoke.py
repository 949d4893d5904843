#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device — a CUDA device is present; its name and power limit.
2. build — nvcc builds every kernel of the package from the sources in
   this checkout, one process per source, all started together.
3. kernels — ``topk_gather`` against its plain PyTorch version on the card
   at the shapes the serving path gives it (every decode batch B <= 7,
   R=1 and 2, f32 weights, N=1 to 16, a row that is not a whole number of
   strips, the reference's sweep), with the support as the layer hands it over (bf16 values, int64
   indices; a bf16 output must be the f32 one rounded once), on weights
   that its 16-byte copies cannot take (plain-load staging), and twice on
   the same operands (bit-identical); then its time, its plain version's
   time and that of one PyTorch library call of the same function, with
   the weights cold in L2 as the serving path finds them (and warm, beside
   them), and the least time the card could take for the same bytes and
   flops.
4. serve — ``Engine.serve`` on the shipped smollm-360m config at full
   width (bf16, 4 slots, 8 requests, prompt 16, gen 16, the engine's
   random weights from seed 0); the kernel launch counts show the decode
   steps went through the kernels.  Then one decode step's device time
   alone, from a CUDA-graph replay of it, against the eager step's wall
   time, and the eager step's device activities under torch.profiler (the
   longest, and ``topk_gather``'s line by name).
5. parity — the same weights in float32: one prefill and three decode
   steps through the kernel and through the PyTorch formula
   (``use_pallas="off"``) give the same logits.
6. ops — the kernel-ops API (``repro_torch.kernels.ops``) at smollm-360m's
   full FFN widths (N=4, the one shared route of ``route_share=0``, up
   960->2560 and down 2560->960, T=4 and T=128 tokens): ``packed_matmul``,
   ``grouped_cs_matmul`` and ``kwta_hist`` against their plain versions
   in bf16 and f32 and at the reference's sweeps (the products' sweeps in
   both types; ``kwta_hist`` bin for bin), grouped after the shared
   permutation against packed, and the products' bf16 tensor-core bodies
   on operands that their 16-byte copies cannot take (rows that are not a
   multiple of 16 bytes, a view whose base is not 16-byte aligned), and
   ``kwta_hist``'s plain-load loop on rows that its register path cannot
   hold (an unaligned view, a row longer than 20 KB); one
   forward and backward through each of the five ops, whose gradients must
   equal autograd's through the plain versions, with the launch counts of
   that run; then each kernel's time, L2-cold and warm, beside its plain
   version, one library call and its bound (the products at T=128 and T=4
   on the up and the down projection).
7. paged — the paged KV cache (``Engine(kv_layout="paged")``) on the
   shipped smollm-360m config at full width: in float32, a 40-token prompt
   chunk-prefilled over scattered page chains and three decode steps
   through the page tables give the logits of the contiguous prefill and
   decode with every k-WTA selection held to the contiguous run's (and,
   selecting freely, print how far a flipped selection moves them); the
   paged grow engine's greedy tokens equal the contiguous engine's on the
   reference's mixed-length parity workload (a token may differ only
   between the contiguous model's top two, closer than that move);
   in bf16, a workload of duplicated, extended and long prompts on a pool
   chosen by the scheduler and allocator alone (no model, on the CPU) so
   that it preempts, adopts prefix pages, breaks sharing and grows
   chains, with ``topk_gather`` launched once a layer a decode step; then
   tok/s, time to first token and the decode step of the paged engine
   beside the contiguous one, and the largest inter-token gap of three
   short requests while a 512-token prompt is admitted.
8. analysis — the sparsity-invariant linter (``repro_torch.analysis``)
   on the card: the two seeded-fault kernels (``analysis/csrc``) against
   their plain versions on in-range inputs; with every launch count at 0,
   the self-test, whose oob-gather and missing-init faults must be caught
   by guarded launches of the CUDA kernels (``in[2]``, ``out[2]``), and
   the guarded checks of the four shipped kernels at the registry sweeps
   and the serving shapes in bf16 and f32, which must find nothing; the
   six kernels' launch counts of that run; each shipped case's launch
   geometry as ``torch.profiler`` saw it against the ``launch_geometry``
   the linter reads; ``lint_config`` of the shipped
   smollm-360m config at full width on fake CUDA tensors (zero findings,
   32 ``repro_torch::topk_gather`` nodes in the decode graph); one
   contiguous and one paged decode step, their inputs already on the
   card, under ``torch.cuda.set_sync_debug_mode("error")``; the host
   time of a ``topk_gather`` call through the custom op against the bare
   launch; then the seeded kernels' times beside their plain versions, a
   library call and their bounds.  Then the reference verifier's fixture
   kernels (``analysis/csrc/fixtures.cu``: gather, induction, accum, pad,
   copy_scratch), every case through ``kernel_checks.check_case`` on the
   card with exactly the findings ``analysis/fixtures.py`` lists (counted
   in the same run as the self-test), the copy's over-budget scratches as
   ``launch-resource`` findings of their geometry, never launched; each
   family's clean launch against its plain version (exact for the copies,
   1e-6 of the largest value for the sums) and its time, warm, beside its
   plain version, one library call and its bound.  The guarded decode
   steps also run with the dispatch observer on and probed (under a
   support capture), the capture read back after the guard.
9. telemetry — ``repro_torch.obs`` on the shipped smollm-360m config at
   full width (bf16, 4 slots, phase 4's workload) with
   ``Telemetry.on(jsonl, sparsity_every=1)``, on the contiguous and the
   paged layout: the tokens equal a telemetry-off run's (a token may part
   only between the top two, by phase 7's rule); every FFN layer reports
   ``realized_k_frac`` in [K/d_ff, 1]; the dispatch summary holds 32
   ``topk[cuda]`` sites with the shared memory of the launch;
   ``topk_gather`` runs 32 times a step; the JSONL passes
   ``validate_jsonl`` with every event kind.  Under ``torch.profiler``
   the decode step issues the same device activities with telemetry off
   and on but unprobed (the probed step's extra activities are printed).
   Then the latency and sparsity columns, the stage totals, and tok/s and
   the host-clock step with telemetry off and on, in turns off, on, on,
   off (the overhead row: no limit, no claim).
10. moe — the MoE + MLA family and the int8 KV cache: deepseek-v2-lite-16b
   as shipped (27 layers, d_model 2048, MLA kv_lora 512, 64 routed
   experts top-6 + 2 shared), bf16, random weights from seed 0, serves
   phase 4's workload on the contiguous and the paged layout (tok/s,
   TTFT, host-clock step); ``topk_gather`` (the shared experts' decode
   down projection) runs once a layer a decode step and never in a
   prefill; each layout's step under ``torch.profiler`` and, where it
   captures, in a CUDA graph.  ``topk_gather`` at that shape (B=4, K=352,
   P=704, G=512, N=4, bf16) against its plain version, then its times
   beside one library call and its bound (row 1's ``moe_shape``).  In
   float32 a prefill of two prompts and three decode steps through the
   kernel give the formula path's logits (1e-3) with every k-WTA
   selection and router choice held.  smollm-360m with
   ``kv_cache_dtype="int8"`` on phase 4's weights and workload, both
   layouts: the cache's bytes against bf16's, paged tokens equal to
   contiguous ones but at ties.
11. train — the training path (``repro_torch.launch.train.Trainer``),
   which launches none of the kernels, as in the reference: (a) the
   shipped smollm-360m at full width (float32 masters, bf16 compute) for
   20 steps of ``lm_batch`` at batch 8, seq 128 (every loss finite, the
   loss guard silent, the last five losses below the first; host-clock
   step, tokens/s, peak memory; the four kernels' launches in the steps,
   which must be 0), and one step's device activities under
   ``torch.profiler`` in a fresh process; (b) ``save_async`` at step 10
   while training goes on in place, restored into a fresh Trainer equal
   to a host copy taken at the save; serving params made from the
   step-20 weights (every ``packed_p`` equal to ``partition_major`` of
   its ``packed``) serve phase 4's workload through ``topk_gather`` (32
   launches a decode step), and an f32 decode step through the kernel
   gives the formula's logits with the k-WTA selections held; (c) in a
   fresh process under ``torch.use_deterministic_algorithms``, 10
   straight steps against 5, a restart and 5 more on the reference
   test's reduced config (1e-5); (d) the GSC CNN at the paper's size in
   its three variants, 60 steps of AdamW at batch 32 each (last loss
   below 0.7 of the first), held-out accuracy, step time, the compression
   ratio and the realized k-WTA sparsity, and one f32 forward and
   backward of each variant against the port on the CPU.

The line before the last holds the card's name and power limit as
``nvidia-smi`` gives them; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import importlib
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, float32 rate
# outside the tensor cores and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

# The FFN down projection of smollm-360m at decode with 4 slots:
# B=4 rows, K=k_for(2560)=320 winners, P=2560/4, G=960/4, N=4, R=G.
MAIN_SHAPE = dict(b=4, k=320, p=640, g=240, n=4, r=240)
# Copies of a layer's weights the timing rotates over: 64 x 1.2 MB of bf16
# packed weights exceed the card's 50 MB L2.
COPIES = 64
# The ops phase's token counts: a decode batch of 4 slots, and a prefill of
# 8 prompts x 16 tokens (the shape every kernel's row is timed at).
OPS_TOKENS = (4, 128)
TIMED_TOKENS = 128
# A k-WTA row longer than the kernel's register path holds (20 KB): 32 KB
# in bf16, 64 KB in f32.
LONG_ROW = 16384
# The FFN projections and token counts the two products are timed at; the
# first is the shape of their rows' times.
PRODUCT_SHAPES = (("up", 128), ("up", 4), ("down", 128), ("down", 4))
# Device activities of the profiled decode step printed, longest first.
PROFILE_TOP = 12
# Phase 9's profiler check of the decode step: one window in a fresh
# process holds ACTIVITY_ROUNDS calls of each variant, interleaved; each
# variant's count is one that ACTIVITY_AGREE or more of its calls saw,
# and more of them than saw any other.
ACTIVITY_ROUNDS, ACTIVITY_AGREE = 4, 3
# The trace's categories of device activity: kernels, copies and fills.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The paged phase: pages of 16 rows, prompts prefilled in chunks of 64.
PAGE_SIZE, PAGED_CHUNK = 16, 64
# The reference's paged parity workload (tests/test_kvcache.py): 8
# requests on 4 slots, max_seq 40, pages of 8, a 13-page pool (full
# backing would be 21), chunks of 8.
PARITY_PLENS = (5, 19, 3, 26, 9, 14, 7, 22)
PARITY_GENS = tuple(6 + i % 5 for i in range(8))
# Two engines' tokens may part only where the contiguous model's top two
# tokens lie closer than this (or than what a k-WTA selection flip moves
# the logits by, measured in the same run).
TIE_MARGIN = 1e-3
# The long-prompt workload: three short requests decode while one prompt
# of this many tokens is prefilled.
LONG_PROMPT = 512


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


def check(label, got, want, exact=False, phase="ops"):
    """Hold a kernel's result against its plain version's on the card;
    returns the max abs error.  The products accumulate in f32 in both and
    differ only in the order of the sums: tolerance 1e-3·(1+max|plain|).
    ``exact``: equal element for element (k-WTA keeps the same set)."""
    torch.cuda.synchronize()
    err = (float((got.float() - want.float()).abs().max())
           if want.numel() else 0.0)
    if exact:
        tol, ok = 0.0, bool(torch.equal(got, want))
    else:
        tol = 1e-3 * (1.0 + float(want.float().abs().max()))
        ok = err <= tol
    print(f"[{phase}] {label}: max_abs_err={err:.3e} tol={tol:.3e}")
    if not ok:
        fail(f"{label}: the kernel disagrees with its plain version")
    return err


def topk_check_shapes():
    """The main shape and every decode batch the topk path takes (B <= 7,
    the last with B*K < d_ff), the faithful per-group routes (R=1) and two
    groups a route (R=2), f32 weights, the same FFN at every other pack
    factor, a G whose row is not a whole number of the kernel's strips
    (G=200 at N=4: 100 vectors of 16 B, the last strip 4 of 32), and the
    reference's sweep (kernels/registry.py) in f32 with all groups sharing
    one route."""
    from repro_torch.kernels.registry import TOPK_GATHER_SWEEP
    bf16 = torch.bfloat16
    return ([(dict(MAIN_SHAPE, b=b), bf16) for b in (4, 1, 2, 3, 7)]
            + [(dict(MAIN_SHAPE, r=r), bf16) for r in (1, 2)]
            + [(dict(MAIN_SHAPE), torch.float32)]
            + [(dict(MAIN_SHAPE, p=2560 // n, g=960 // n, n=n, r=960 // n),
                bf16) for n in (1, 2, 8, 16)]
            + [(dict(MAIN_SHAPE, g=200, r=200), bf16)]
            + [(dict(b=b, k=k, p=p, g=g, n=n, r=g), torch.float32)
               for b, k, p, g, n, _ in TOPK_GATHER_SWEEP])


def shifted(t):
    """A contiguous copy of ``t`` whose base lies one element past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_kernels():
    from repro_torch.kernels.topk_gather import (async_staging, topk_gather,
                                                 topk_gather_plain)
    bf16 = torch.bfloat16
    worst = 0.0

    def hold(label, operands):
        nonlocal worst
        worst = max(worst, check(f"topk_gather {label}",
                                 topk_gather(*operands),
                                 topk_gather_plain(*operands),
                                 phase="kernels"))

    for i, (shape, dtype) in enumerate(topk_check_shapes()):
        operands = kernel_operands(shape, dtype, SEED + i)[:5]
        if not async_staging(operands[3]):
            fail(f"topk_gather {shape}: weights not 16-byte aligned; the "
                 "cp.async staging would not run")
        hold(f"{shape} {str(dtype)[6:]}", operands)
    vals, p_idx, s_off, packed_p, route, packed = kernel_operands(
        MAIN_SHAPE, bf16, SEED)
    main = (vals, p_idx, s_off, packed_p, route)
    # the support as the layer hands it over: bf16 values, int64 indices
    serving = (vals.to(bf16), p_idx.long(), s_off.long(), packed_p, route)
    hold(f"{MAIN_SHAPE} bf16 values, int64 indices", serving)
    if not torch.equal(topk_gather(*serving, out_dtype=bf16),
                       topk_gather(*serving).to(bf16)):
        fail("topk_gather: the bf16 output is not the f32 one rounded once")
    print("[kernels] topk_gather bf16 output == f32 output rounded once")
    # weights that the 16-byte copies cannot take: rows of 243*4*2 = 1944 B,
    # a view whose base is 2 B past a 16-byte boundary, and the same in f32
    # (4 B past) at the reference's first sweep shape
    sweep = kernel_operands(dict(b=4, k=16, p=32, g=8, n=4, r=8),
                            torch.float32, SEED + 51)[:5]
    plain_staging = {
        "rows of 1944 B": kernel_operands(dict(MAIN_SHAPE, g=243, r=243),
                                          bf16, SEED + 50)[:5],
        "weights 2 B past 16": main[:3] + (shifted(packed_p), route),
        "f32 weights 4 B past 16, b=4 k=16 p=32 g=8 n=4": sweep[:3] + (
            shifted(sweep[3]), sweep[4])}
    for label, operands in plain_staging.items():
        if async_staging(operands[3]):
            fail(f"topk_gather {label}: weights are 16-byte aligned")
        hold(f"{label} plain-load staging", operands)
    # the sums meet in a fixed order: two launches, one answer
    if not torch.equal(topk_gather(*main), topk_gather(*main)):
        fail("topk_gather: two launches on the same operands differ")
    print("[kernels] topk_gather: two launches on the same operands are "
          "bit-identical")
    times = topk_times(MAIN_SHAPE, vals, p_idx, s_off, packed_p, route,
                       packed, "kernels")
    return {"name": "topk_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_gather.cu",
            "replaces": "src/repro/kernels/topk_gather.py:61",
            "max_abs_err": worst, **times, "body": TOPK_BODY}


def topk_times(shape, vals, p_idx, s_off, packed_p, route, packed, phase):
    """``topk_gather``'s time at ``shape`` (bf16), L2-cold and warm, beside
    its plain version, one library call, an empty launch and its bound:
    the timing keys of a kernels-line row."""
    from repro_torch.core.functional import decompress
    from repro_torch.kernels.topk_gather import (topk_gather,
                                                 topk_gather_plain)
    # library yardstick, never called by the port: the scattered k-sparse
    # activation times the decompressed dense weight, one torch.matmul
    p, g, n = packed_p.shape
    x_dense = torch.zeros((vals.shape[0], p * n), dtype=torch.bfloat16,
                          device="cuda")
    x_dense.scatter_(1, (p_idx.long() * n + s_off.long()),
                     vals.to(torch.bfloat16))
    w_dense = decompress(packed, route)
    # On the serving path a layer's weights are cold: the other layers'
    # weights stream through L2 between two launches of one layer.  So the
    # reported times rotate over COPIES copies of the weights; the warm
    # times, printed beside them, reuse one copy.
    copies = [(packed_p.clone(), route.clone(), w_dense.clone())
              for _ in range(COPIES)]
    timed = {
        "kernel": lambda pp, rt, _: topk_gather(vals, p_idx, s_off, pp, rt),
        "plain": lambda pp, rt, _: topk_gather_plain(vals, p_idx, s_off, pp,
                                                     rt),
        "library": lambda pp, rt, wd: torch.matmul(x_dense, wd),
        # the floor of this timing: a launch that does no work
        "empty": lambda *_: torch.cuda._sleep(0)}
    cold = {name: device_ms([functools.partial(fn, *c) for c in copies])
            for name, fn in timed.items()}
    warm = {name: device_ms(functools.partial(fn, *copies[0]))
            for name, fn in timed.items()}
    bound_ms, bound_by = bound(vals, p_idx, packed_p, route)
    for label, t in (("L2-cold", cold), ("L2-warm", warm)):
        print(f"[{phase}] topk_gather at {shape} bf16, {label}: kernel "
              f"{t['kernel']:.5f} ms, plain {t['plain']:.5f} ms, library "
              f"{t['library']:.5f} ms, empty launch {t['empty']:.5f} ms")
    print(f"[{phase}] bound {bound_ms:.6f} ms ({bound_by})")
    return {"ms": cold["kernel"], "plain_ms": cold["plain"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cold["library"], "ms_warm": warm["kernel"],
            "plain_ms_warm": warm["plain"],
            "library_ms_warm": warm["library"],
            "empty_launch_ms": cold["empty"]}


def kernel_wrappers():
    """Every kernel wrapper of the package, by the name its row carries
    (the linter's two seeded-fault kernels, then the verifier's fixture
    families, last)."""
    from repro_torch.analysis.fixtures import FAMILIES
    from repro_torch.analysis.seeded import missing_init, oob_gather
    from repro_torch.kernels import (grouped_cs_matmul, kwta_hist_cuda,
                                     packed_matmul, topk_gather)
    return {"topk_gather": topk_gather, "packed_matmul": packed_matmul,
            "grouped_cs_matmul": grouped_cs_matmul,
            "kwta_hist": kwta_hist_cuda, "oob_gather": oob_gather,
            "missing_init": missing_init, **FAMILIES}


def reset_counts():
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0


def read_counts():
    return {name: w.launches for name, w in kernel_wrappers().items()}


def phase_serve():
    from repro_torch.configs import get_config
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
    reset_counts()
    out, stats = engine.serve(reqs)
    counts = read_counts()
    launches = counts["topk_gather"]
    steps = stats["decode_steps"]
    print(f"[serve] smollm-360m full width bf16: {n_req} requests, "
          f"{steps} decode steps, {stats['prefill_calls']} prefill calls, "
          f"kernel launches {counts}")
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
        topk = {n: a for n, a in acts.items() if "topk_gather" in n}
        for name, (count, ms) in topk.items():
            print(f"[serve] topk_gather in the step: {ms:8.3f} ms "
                  f"{count:5d}x {name[:100]}")
        if not topk:
            print("[serve] topk_gather in the step: no device activity "
                  "of that name")
    return launches, steps, engine


def _decode_step(engine):
    """One decode step of every slot at position 16, as a callable; on a
    paged engine through page tables that give each slot its own pages."""
    from repro_torch.models import transformer as T
    n = engine.n_slots
    pages = None
    if engine.kv_layout == "paged":
        cache = engine.new_paged_cache()
        blocks = engine.kv_geo.blocks_per_slot
        pages = torch.arange(1, n * blocks + 1, device="cuda").view(n, blocks)
    else:
        cache = engine.new_cache(n)
    batch = {"tokens": torch.zeros((n, 1), dtype=torch.int64,
                                   device="cuda")}
    pos = torch.full((n,), 16, device="cuda")
    return lambda: T.serve_step(engine.params, cache, batch, pos, engine.cfg,
                                pages=pages)


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


def f32_model():
    """smollm-360m in float32 with random weights from SEED (the parity
    phases' model)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("smollm-360m"),
                              compute_dtype="float32")
    return cfg, T.init_model(cfg, seed=SEED, device="cuda")


def phase_parity():
    from repro_torch.models import transformer as T
    cfg, params = f32_model()
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


# ---------------------------------------------------------------------------
# phase 6: the kernel-ops API at smollm-360m's full FFN widths
# ---------------------------------------------------------------------------

# The rows of the kernels line that phase 6 fills: source, the TPU kernel
# each replaces (file:line of the wrapper that reaches pallas_call) and the
# body that serves the timed shape (bf16 operands, 16-byte aligned, 128
# tokens; the launchers pick it by operand type, alignment and batch).
OPS_KERNELS = {
    "packed_matmul": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
                      "src/repro/kernels/packed_matmul.py:64",
                      "mma.sync bf16 on a dense tile expanded in shared "
                      "memory, 4-stage cp.async ring of 128-input chunks, "
                      "32x32 tile, 4 warps"),
    "grouped_cs_matmul": ("src/repro_torch/kernels/csrc/grouped_cs_matmul.cu",
                          "src/repro/kernels/grouped_cs_matmul.py:46",
                          "mma.sync bf16, 6-stage cp.async ring, 32x32 tile, "
                          "4 warps"),
    "kwta_hist": ("src/repro_torch/kernels/csrc/kwta_hist.cu",
                  "src/repro/kernels/kwta_hist.py:75",
                  "CUDA cores: one 10-warp block a row, the row read once "
                  "into registers by 16-byte loads, 10 per-warp histograms"),
}
TOPK_BODY = ("CUDA cores: clusters of up to 8 blocks split K, every weight "
             "strip in flight by 16-byte cp.async, f32 partials added in "
             "rank order through distributed shared memory")
KWTA_NO_LIBRARY = ("no single PyTorch call computes the histogram "
                   "threshold; torch.topk is another function")


def ffn_layers(cfg, dtype, seed):
    """smollm-360m's FFN up (d_model -> d_ff) and down (d_ff -> d_model)
    projections at full width as ``packed_linear_init`` makes them
    (route_share=0: one route for all groups, R=G), as {name: (packed,
    packed_p, route)} in ``dtype``, on the card."""
    from repro_torch.core.layers import packed_linear_init
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}
    for name, d_in, d_out in (("up", cfg.d_model, cfg.d_ff),
                              ("down", cfg.d_ff, cfg.d_model)):
        layer = packed_linear_init(gen, d_in, d_out, cfg.ffn_sparsity,
                                   bias=False, seed=seed)
        out[name] = (layer["packed"].to(dtype), layer["packed_p"].to(dtype),
                     layer["route"])
    return out


def randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def unaligned(gen, *shape, dtype):
    """A contiguous view of random values whose base lies one element past
    a 16-byte boundary (its row strides are the shape's)."""
    flat = randn(gen, int(np.prod(shape)) + 1, dtype=dtype)
    return flat[1:].view(shape)


def ops_checks(cfg):
    """Each kernel against its plain version: the FFN's full widths at T=4
    and T=128 in bf16 and f32, and the reference's sweeps in f32.  Returns
    the worst error of each kernel."""
    from repro_torch.core import CSLayout, make_routes
    from repro_torch.kernels import (grouped_cs_matmul, grouped_cs_matmul_plain,
                                     interleave_out, kwta_hist_cuda,
                                     kwta_hist_cuda_plain, packed_matmul,
                                     packed_matmul_plain, permute_activations,
                                     slot_major_packed)
    from repro_torch.kernels.grouped_cs_matmul import (
        async_staging as grouped_async)
    from repro_torch.kernels.kwta_hist import register_path
    from repro_torch.kernels.packed_matmul import (
        async_staging as packed_async)
    from repro_torch.kernels.registry import (GROUPED_CS_SWEEP,
                                              KWTA_HIST_SWEEP,
                                              PACKED_MATMUL_SWEEP)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 100)
    worst = dict.fromkeys(OPS_KERNELS, 0.0)

    def hold(name, label, got, want, exact=False):
        worst[name] = max(worst[name],
                          check(f"{name} {label}", got, want, exact))

    k = cfg.ffn_sparsity.k_for(cfg.d_ff)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype)[6:]
        for proj, (packed, _, route) in ffn_layers(cfg, dtype, SEED).items():
            pk = slot_major_packed(packed)
            for t in OPS_TOKENS:
                x = randn(gen, t, packed.shape[1] * packed.shape[2],
                          dtype=dtype)
                if not (packed_async(x, packed, route)
                        and grouped_async(permute_activations(x, route), pk)):
                    fail(f"{proj} T={t}: full-width operands not 16-byte "
                         "aligned; the cp.async staging would not run")
                label = f"{proj} T={t} {dn}"
                y = packed_matmul(x, packed, route)
                hold("packed_matmul", label, y,
                     packed_matmul_plain(x, packed, route))
                xg = permute_activations(x, route)
                yg = grouped_cs_matmul(xg, pk)
                hold("grouped_cs_matmul", label, yg,
                     grouped_cs_matmul_plain(xg, pk))
                # at the shared route the two kernels compute one function
                hold("grouped_cs_matmul", label + " == packed_matmul",
                     interleave_out(yg), y)
        for t, d, kk in [(t, cfg.d_ff, k) for t in OPS_TOKENS] + [(8, 1500,
                                                                  225)]:
            x = randn(gen, t, d, dtype=dtype)
            path = ("registers" if register_path(x, torch.empty_like(x))
                    else "plain-load loop")
            if d == cfg.d_ff and path != "registers":
                fail(f"kwta_hist ({t}, {d}) {dn}: the register path would "
                     "not run")
            hold("kwta_hist", f"({t}, {d}) K={kk} {dn} {path}",
                 kwta_hist_cuda(x, kk), kwta_hist_cuda_plain(x, kk),
                 exact=True)
        # rows the register path cannot hold: a view 2 B (bf16) or 4 B past
        # a 16-byte boundary, and a row longer than 20 KB
        for label, x in (
                (f"unaligned view (8, {cfg.d_ff})",
                 unaligned(gen, 8, cfg.d_ff, dtype=dtype)),
                (f"long row (4, {LONG_ROW})",
                 randn(gen, 4, LONG_ROW, dtype=dtype))):
            if register_path(x, torch.empty_like(x)):
                fail(f"kwta_hist {label} {dn} would take the register path")
            hold("kwta_hist", f"{label} K={k} {dn} plain-load loop",
                 kwta_hist_cuda(x, k), kwta_hist_cuda_plain(x, k),
                 exact=True)
        x = randn(gen, OPS_TOKENS[0], cfg.d_ff, dtype=dtype)
        for kk in (cfg.d_ff, cfg.d_ff + 1):         # K >= D keeps the row
            hold("kwta_hist", f"K={kk} >= D={cfg.d_ff} {dn}",
                 kwta_hist_cuda(x, kk), x, exact=True)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for b, p, g, n, *_ in PACKED_MATMUL_SWEEP:
            packed = randn(gen, g, p, n, dtype=dtype)
            route = torch.from_numpy(make_routes(CSLayout(p * n, g * n, n),
                                                 SEED)).cuda()
            x = randn(gen, b, p * n, dtype=dtype)
            hold("packed_matmul", f"sweep b={b} p={p} g={g} n={n} R=1 {dn}",
                 packed_matmul(x, packed, route),
                 packed_matmul_plain(x, packed, route))
        for n, b, p, g, *_ in GROUPED_CS_SWEEP:
            xg = randn(gen, n, b, p, dtype=dtype)
            pk = randn(gen, n, p, g, dtype=dtype)
            hold("grouped_cs_matmul", f"sweep n={n} b={b} p={p} g={g} {dn}",
                 grouped_cs_matmul(xg, pk), grouped_cs_matmul_plain(xg, pk))
    # bf16 operands that the tensor-core bodies' 16-byte copies cannot take,
    # so that they stage with plain loads: rows that are not a multiple of
    # 16 bytes (packed: 12 inputs, 24 B; grouped: P=20, G=12), and, at full
    # width, an activation whose base is 2 bytes past a 16-byte boundary
    bf16 = torch.bfloat16
    up, up_route = ffn_layers(cfg, bf16, SEED)["up"][::2]
    pk_up = slot_major_packed(up)
    route = torch.from_numpy(make_routes(CSLayout(12, 24, 4), SEED)).cuda()
    packed_cases = {
        "rows of 24 B b=5 p=3 g=6 n=4 R=1": (
            randn(gen, 5, 12, dtype=bf16), randn(gen, 6, 3, 4, dtype=bf16),
            route),
        "unaligned view x up T=128": (
            unaligned(gen, TIMED_TOKENS, cfg.d_model, dtype=bf16), up,
            up_route)}
    for label, (x, packed, route) in packed_cases.items():
        if packed_async(x, packed, route):
            fail(f"packed_matmul {label}: operands are 16-byte aligned")
        hold("packed_matmul", f"{label} bf16 plain-load staging",
             packed_matmul(x, packed, route),
             packed_matmul_plain(x, packed, route))
    grouped_cases = {
        "rows of 40 B and 24 B n=4 b=7 p=20 g=12": (
            randn(gen, 4, 7, 20, dtype=bf16), randn(gen, 4, 20, 12,
                                                    dtype=bf16)),
        "unaligned view xg up T=128": (
            unaligned(gen, *pk_up.shape[:1], TIMED_TOKENS, pk_up.shape[1],
                      dtype=bf16), pk_up)}
    for label, (xg, pk) in grouped_cases.items():
        if grouped_async(xg, pk):
            fail(f"grouped_cs_matmul {label}: operands are 16-byte aligned")
        hold("grouped_cs_matmul", f"{label} bf16 plain-load staging",
             grouped_cs_matmul(xg, pk), grouped_cs_matmul_plain(xg, pk))
    for b, d, kk, _ in KWTA_HIST_SWEEP:
        x = randn(gen, b, d)
        hold("kwta_hist", f"sweep ({b}, {d}) K={kk} f32",
             kwta_hist_cuda(x, kk), kwta_hist_cuda_plain(x, kk), exact=True)
    return worst


def ops_gradients(cfg):
    """One forward and backward through each of the five ops at full width
    in f32 (the products over T=128 tokens, the sparse-sparse ops over a
    decode batch), with every kernel count set to 0 just before and read
    just after; then the gradients through the kernels against autograd's
    through the plain versions.  Returns the counts."""
    from repro_torch.core import kwta
    from repro_torch.kernels import (grouped_cs_matmul_op,
                                     grouped_cs_matmul_plain,
                                     kwta_hist_cuda_plain, kwta_hist_op,
                                     packed_matmul_op, packed_matmul_plain,
                                     permute_activations, slot_major_packed,
                                     topk_gather_op, topk_gather_plain,
                                     topk_gather_support_op, topk_support)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 200)
    layers = ffn_layers(cfg, torch.float32, SEED + 1)
    packed, _, route = layers["up"]
    _, packed_p, route_down = layers["down"]
    n, k = packed.shape[2], cfg.ffn_sparsity.k_for(cfg.d_ff)
    x = randn(gen, TIMED_TOKENS, cfg.d_model)
    xg, pk = permute_activations(x, route), slot_major_packed(packed)
    h, c = randn(gen, TIMED_TOKENS, cfg.d_ff), randn(gen, TIMED_TOKENS,
                                                     cfg.d_ff)
    xs = kwta(randn(gen, OPS_TOKENS[0], cfg.d_ff), k)    # k-sparse, decode
    vals, p_idx, s_off = topk_support(xs, k, n)

    def sq(y):
        return (y.float() ** 2).sum()

    # name: (loss through the op, the same loss through the plain version,
    # the differentiated operands)
    cases = {
        "packed_matmul_op": (
            lambda a, w: sq(packed_matmul_op(a, w, route)),
            lambda a, w: sq(packed_matmul_plain(a, w, route)), (x, packed)),
        "grouped_cs_matmul_op": (
            lambda a, w: sq(grouped_cs_matmul_op(a, w)),
            lambda a, w: sq(grouped_cs_matmul_plain(a, w)), (xg, pk)),
        "kwta_hist_op": (
            lambda a: (kwta_hist_op(a, k) * c).sum(),
            lambda a: (kwta_hist_cuda_plain(a, k) * c).sum(), (h,)),
        "topk_gather_support_op": (
            lambda v, w: sq(topk_gather_support_op(v, p_idx, s_off, w,
                                                   route_down)),
            lambda v, w: sq(topk_gather_plain(v, p_idx, s_off, w,
                                              route_down)),
            (vals, packed_p)),
        "topk_gather_op": (
            lambda a, w: sq(topk_gather_op(a, w, route_down, k)),
            lambda a, w: sq(topk_gather_plain(*topk_support(a, k, n), w,
                                              route_down)),
            (xs, packed_p)),
    }

    def grads(loss, operands):
        leaves = [t.detach().clone().requires_grad_() for t in operands]
        return torch.autograd.grad(loss(*leaves), leaves)

    reset_counts()
    through_kernels = {name: grads(op, operands)
                       for name, (op, _, operands) in cases.items()}
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[ops] one forward + backward through each of the five ops: "
          f"kernel launches {counts}")
    for name, (_, plain, operands) in cases.items():
        for i, (got, want) in enumerate(zip(through_kernels[name],
                                            grads(plain, operands))):
            check(f"{name} gradient of operand {i}", got, want)
    for name in OPS_KERNELS:
        if counts[name] == 0:
            fail(f"{name} was not launched by the ops' run")
    return counts


def product_bound(nbytes, t, d_in, d_out, n, dtype):
    """Least time (ms) of a CS product: ``nbytes`` over the HBM rate
    against the function's 2·T·D_in·D_out/N flops over the peak for its
    operands' type (bf16 tensor cores, or f32 outside them)."""
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * t * d_in * d_out / n / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ops_times(cfg):
    """Each kernel, its plain version and one library call in bf16, L2-cold
    (rotating over copies of the weights, or of the k-WTA input, larger
    than L2 together) and warm (one copy), with each kernel's bound: the
    products at ``PRODUCT_SHAPES``, ``kwta_hist`` at (128, d_ff).  Returns
    {name: {shape: (cold, warm, bound)}}, each time a {variant: ms}."""
    from repro_torch.core.functional import decompress
    from repro_torch.kernels import (grouped_cs_matmul, grouped_cs_matmul_plain,
                                     kwta_hist_cuda, kwta_hist_cuda_plain,
                                     packed_matmul, packed_matmul_plain,
                                     permute_activations, slot_major_packed)
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 300)
    layers = ffn_layers(cfg, bf16, SEED + 2)
    k = cfg.ffn_sparsity.k_for(cfg.d_ff)
    times = collections.defaultdict(dict)

    def run(name, shape, copies, fns, bound_):
        cold = {v: device_ms([functools.partial(fn, c) for c in copies])
                for v, fn in fns.items()}
        warm = {v: device_ms(functools.partial(fn, copies[0]))
                for v, fn in fns.items()}
        for label, tm in (("L2-cold", cold), ("L2-warm", warm)):
            print(f"[ops] {name} at {shape} bf16, {label}: " + ", ".join(
                f"{v} {ms:.5f} ms" for v, ms in tm.items()))
        print(f"[ops] {name} at {shape} bound {bound_[0]:.6f} ms "
              f"({bound_[1]})")
        times[name][shape] = (cold, warm, bound_)

    for proj in dict.fromkeys(p for p, _ in PRODUCT_SHAPES):
        packed, _, route = layers[proj]
        g, p, n = packed.shape
        weights = [(packed.clone(), route.clone(), slot_major_packed(packed),
                    decompress(packed, route)) for _ in range(COPIES)]
        for t in [t for q, t in PRODUCT_SHAPES if q == proj]:
            x = randn(gen, t, p * n, dtype=bf16)
            xg = permute_activations(x, route)
            out_bytes = t * g * n * 4
            run("packed_matmul", f"{proj} T={t}", weights, {
                "kernel": lambda w: packed_matmul(x, w[0], w[1]),
                "plain": lambda w: packed_matmul_plain(x, w[0], w[1]),
                "library": lambda w: torch.matmul(x, w[3])},
                product_bound(x.numel() * 2 + packed.numel() * 2
                              + route.numel() + out_bytes,
                              t, p * n, g * n, n, bf16))
            run("grouped_cs_matmul", f"{proj} T={t}", weights, {
                "kernel": lambda w: grouped_cs_matmul(xg, w[2]),
                "plain": lambda w: grouped_cs_matmul_plain(xg, w[2]),
                "library": lambda w: torch.bmm(xg, w[2])},
                product_bound(xg.numel() * 2 + packed.numel() * 2
                              + out_bytes, t, p * n, g * n, n, bf16))
        del weights
    h = randn(gen, TIMED_TOKENS, cfg.d_ff, dtype=bf16)
    # k-WTA: the row read and written once, against ~7 f32 operations an
    # element (min, max, subtract, multiply, two clamps, compare)
    t_bytes = 2 * h.numel() * 2 / HBM_BYTES_PER_S
    t_ops = 7 * h.numel() / F32_FLOPS
    run("kwta_hist", f"(128, d_ff) K={k}",
        [h.clone() for _ in range(2 * COPIES)], {   # 128 x 0.66 MB
            "kernel": lambda a: kwta_hist_cuda(a, k),
            "plain": lambda a: kwta_hist_cuda_plain(a, k),
            # a floor: the same bytes read and written by one copy
            "copy": lambda a: torch.empty_like(a).copy_(a)},
        (1e3 * max(t_bytes, t_ops),
         "bytes" if t_bytes >= t_ops else "operations"))
    return times


def phase_ops(cfg):
    worst = ops_checks(cfg)
    counts = ops_gradients(cfg)
    times = ops_times(cfg)
    rows = []
    for name, (source, replaces, body) in OPS_KERNELS.items():
        by_shape = times[name]
        cold, warm, (bound_ms, bound_by) = next(iter(by_shape.values()))
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": worst[name], "ms": cold["kernel"],
            "plain_ms": cold["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": cold.get("library"),
            "ms_warm": warm["kernel"], "plain_ms_warm": warm["plain"],
            "library_ms_warm": warm.get("library"), "body": body}
        if len(by_shape) > 1:
            row["shapes"] = {
                shape: {"ms": c["kernel"], "ms_warm": w["kernel"],
                        "plain_ms": c["plain"], "library_ms": c["library"],
                        "library_ms_warm": w["library"], "bound_ms": b[0]}
                for shape, (c, w, b) in by_shape.items()}
        rows.append(row)
    rows[-1]["library_note"] = KWTA_NO_LIBRARY
    cold, warm, _ = next(iter(times["kwta_hist"].values()))
    rows[-1]["copy_ms"], rows[-1]["copy_ms_warm"] = cold["copy"], warm["copy"]
    return rows


# ---------------------------------------------------------------------------
# phase 7: the paged KV cache at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def kwta_selections(held=None):
    """Record the kept set of every bisect k-WTA call made inside, in call
    order, as boolean masks; with ``held`` (an iterator of masks, one a
    call) keep those sets instead of selecting.  The serving FFN selects
    with ``repro_torch.core.layers.kwta_bisect``."""
    layers = importlib.import_module("repro_torch.core.layers")
    select, masks = layers.kwta_bisect, []

    def spy(x, k):
        if held is not None:
            keep = next(held)
        else:
            keep = select(x, k) != 0
        masks.append(keep)
        return x * keep.to(x.dtype)

    layers.kwta_bisect = spy
    try:
        yield masks
    finally:
        layers.kwta_bisect = select


def layout_logits(cfg, params):
    """Two 40-token prompts chunk-prefilled (three chunks of 16, the last
    padded) into page chains scattered over the pool, then three decode
    steps through the page tables, against one fused prefill and three
    contiguous decode steps, both through the kernel: the paged path with
    every k-WTA selection held to the contiguous run's, and free.
    Returns the largest logit difference of each, the largest contiguous
    logit, the selections of real rows that differ, their number and the
    ``topk_gather`` launches of the three runs."""
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(SEED + 3)
    b, s, n_steps = 2, 40, 3
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).cuda()
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1))).cuda()
             for _ in range(n_steps)]
    blocks = -(-(s + n_steps) // PAGE_SIZE)
    tables = (torch.from_numpy(rng.permutation(b * blocks) + 1)
              .view(b, blocks).cuda())
    spans = [(r, start, min(PAGE_SIZE, s - start))
             for r in range(b) for start in range(0, s, PAGE_SIZE)]

    def paged():
        pool = T.init_paged_cache(cfg, b * blocks + 1, PAGE_SIZE, "cuda")
        got = torch.empty((b, s, cfg.padded_vocab), device="cuda")
        for r, start, ln in spans:
            buf = torch.zeros((1, PAGE_SIZE), dtype=torch.int64,
                              device="cuda")
            buf[0, :ln] = prompt[r, start:start + ln]
            logits, _ = T.prefill_chunk(params, pool, {"tokens": buf},
                                        start, ln, cfg, tables[r:r + 1])
            got[r, start:start + ln] = logits[0, :ln]
        rows = [got]
        for i, tok in enumerate(steps):
            pos = torch.full((b,), s + i, device="cuda")
            rows.append(T.serve_step(params, pool, {"tokens": tok}, pos, cfg,
                                     pages=tables)[0][:, None])
        return torch.cat(rows, dim=1)

    reset_counts()
    with torch.no_grad():
        with kwta_selections() as contiguous:
            want, cache = T.prefill(params, {"tokens": prompt}, cfg,
                                    s + n_steps)
            rows = [want]
            for i, tok in enumerate(steps):
                pos = torch.full((b,), s + i, device="cuda")
                rows.append(T.serve_step(params, cache, {"tokens": tok}, pos,
                                         cfg)[0][:, None])
        want = torch.cat(rows, dim=1)
        # the contiguous selections in the paged run's call order: per
        # chunk every layer's rows of that chunk (padding rows keep none),
        # then the decode steps' as they were
        n_layers = cfg.n_layers
        held, real = [], []
        for r, start, ln in spans:
            for layer in range(n_layers):
                keep = torch.zeros((1, PAGE_SIZE, contiguous[0].shape[-1]),
                                   dtype=torch.bool, device="cuda")
                keep[0, :ln] = contiguous[layer][r, start:start + ln]
                held.append(keep)
                real.append(ln)
        held += contiguous[n_layers:]
        real += [1] * (len(contiguous) - n_layers)
        with kwta_selections(iter(held)):
            got_held = paged()
        with kwta_selections() as free_masks:
            got_free = paged()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got_held).all()):
        fail("paged logits: non-finite logits")
    # selections of real rows (not chunk padding) that differ
    return {"held": float((got_held - want).abs().max()),
            "free": float((got_free - want).abs().max()),
            "max_logit": float(want.abs().max()),
            "flips": sum(int((h[:, :n] != f[:, :n]).any(-1).sum())
                         for h, f, n in zip(held, free_masks, real)),
            "selections": sum(h.shape[0] * n for h, n in zip(held, real)),
            "launches": read_counts()["topk_gather"]}


def paged_logits(cfg, params):
    """``layout_logits`` in float32, gated.  The two paths sum in other
    orders (a fused prefill of 80 rows against chunks of 16; attention
    over the 48-row view against 40 rows), and the k-WTA keeps a value or
    drops it on a threshold, so a difference of ~1e-6 next to the
    threshold keeps another set, which moves the logits by ~1e-2.  So the
    held run is the gate (tolerance 1e-3), and the free run's difference
    and the number of selections that differ are printed.  Returns the
    free run's largest logit difference."""
    b, s, n_steps, n_layers = 2, 40, 3, cfg.n_layers
    d = layout_logits(cfg, params)
    launches, err, free_err = d["launches"], d["held"], d["free"]
    if launches != 3 * n_layers * n_steps:
        fail(f"paged logits: topk_gather launched {launches} times, want "
             f"3 runs x {n_layers} layers x {n_steps} steps")
    tol = 1e-3
    print(f"[paged] f32 chunked prefill of {b} x {s} tokens in chunks of "
          f"{PAGE_SIZE} + {n_steps} paged decode steps vs fused prefill + "
          f"contiguous decode, k-WTA selections held to the contiguous "
          f"run's: max_abs_err={err:.3e} (max |logit| "
          f"{d['max_logit']:.3f}) tol={tol:.0e}; topk_gather "
          f"launches {launches}")
    print(f"[paged] the same, selecting freely: max_abs_err={free_err:.3e}, "
          f"{d['flips']} of {d['selections']} (layer, position) selections "
          "keep another set")
    if not err <= tol:
        fail("paged logits disagree with the contiguous path")
    return free_err


def parity_requests(vocab):
    from repro_torch.runtime.scheduler import Request
    rng = np.random.default_rng(SEED)
    return [Request(uid=i, prompt=rng.integers(0, vocab, n).tolist(),
                    max_new_tokens=g)
            for i, (n, g) in enumerate(zip(PARITY_PLENS, PARITY_GENS))]


def top2(cfg, params, tokens):
    """The contiguous model's two most likely next tokens after ``tokens``
    and the gap between their logits (one fused prefill, float32)."""
    from repro_torch.models import transformer as T
    toks = torch.tensor([tokens], device="cuda")
    with torch.no_grad():
        logits, _ = T.prefill(params, {"tokens": toks}, cfg, len(tokens))
    top = torch.topk(logits[0, -1].float(), 2)
    return set(top.indices.tolist()), float(top.values[0] - top.values[1])


def paged_tokens(cfg, params, tie_margin):
    """The paged grow engine against the contiguous engine, greedy, f32, on
    the reference's parity workload.  Where a request's tokens part, the
    two tokens must be the contiguous model's top two there, and their
    logits closer than ``tie_margin``: the logit difference a k-WTA
    selection flip makes between the two layouts (``paged_logits``), at
    least TIE_MARGIN."""
    from repro_torch.launch.serve import Engine
    eng_c = Engine(cfg, max_seq=40, n_slots=4, params=params, device="cuda")
    eng_p = Engine(cfg, max_seq=40, n_slots=4, params=params, device="cuda",
                   kv_layout="paged", page_size=8, n_pages=13,
                   prefill_chunk=8)
    reqs = parity_requests(cfg.vocab_size)
    out_c, _ = eng_c.serve(reqs)
    out_p, stats = eng_p.serve(reqs)
    ties = 0
    for req in reqs:
        want, got = out_c[req.uid], out_p[req.uid]
        if len(got) != len(want):
            fail(f"paged parity: request {req.uid} returned {len(got)} "
                 f"tokens, want {len(want)}")
        part = next((j for j, (a, b) in enumerate(zip(want, got))
                     if a != b), None)
        if part is None:
            continue
        best, margin = top2(cfg, params, list(req.prompt) + want[:part])
        print(f"[paged] request {req.uid}: tokens part at step {part} "
              f"(contiguous {want[part]}, paged {got[part]}); the "
              f"contiguous model's top two there {sorted(best)}, margin "
              f"{margin:.3e}")
        if best != {want[part], got[part]} or not margin < tie_margin:
            fail(f"paged parity: request {req.uid} differs at step {part} "
                 f"beyond a tie (margin {margin:.3e}, bound "
                 f"{tie_margin:.3e})")
        ties += 1
    print(f"[paged] f32 engine tokens, paged grow vs contiguous, "
          f"{len(reqs)} requests ({stats['prefill_chunks']} chunks, "
          f"{stats['pages_capacity']} pages of 8): "
          f"{len(reqs) - ties} identical, {ties} parted at a tie of the "
          f"top two (margin < {tie_margin:.3e})")


def allocator_requests(vocab):
    """Mixed prompt lengths with a duplicated and an extended prompt: a
    40-token parent that keeps decoding while three budget-1 fillers pass
    through the other slots, so that its duplicate is admitted after the
    parent's pages are published (prefix hits, copy-on-write of the shared
    last page), an extension that adopts its two full pages, and longer
    prompts (two chunks) and budgets that outgrow the pool."""
    from repro_torch.runtime.scheduler import Request
    rng = np.random.default_rng(SEED + 4)
    base = rng.integers(0, vocab, 40).tolist()
    spec = ([(base, 40)]
            + [(rng.integers(0, vocab, 5).tolist(), 1) for _ in range(3)]
            + [(base, 30), (base + rng.integers(0, vocab, 50).tolist(), 20),
               (rng.integers(0, vocab, 70).tolist(), 24),
               (rng.integers(0, vocab, 20).tolist(), 30)])
    return [Request(uid=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(spec)]


def allocator_goals(stats):
    return (stats["preemptions"] >= 1 and stats["prefix_hit_pages"] >= 1
            and stats["cow_copies"] + stats["cow_in_place"] >= 1
            and stats["grown_pages"] >= 1)


ALLOC_KEYS = ("preemptions", "prefix_hit_pages", "cow_copies",
              "cow_in_place", "grown_pages", "max_concurrent",
              "prefill_chunks", "decode_steps")


def plan_pool(cfg, reqs, max_seq):
    """The largest pool on which the paged grow engine's scheduler and
    allocator alone — no model: every forward gives zero logits, on the
    CPU — preempt, adopt prefix pages, break sharing and grow chains.
    Page accounting does not depend on the tokens drawn.  Returns
    (n_pages, the planned stats)."""
    from repro_torch.launch.serve import Engine

    class NoModel(Engine):
        def new_paged_cache(self):
            return []                  # copy_cache_page has nothing to copy

        def _prefill_chunk(self, cache, tokens, table, start):
            return torch.zeros(self.cfg.vocab_size)

        def _decode_step(self, cache, tokens, pos, tables=None,
                         probed=False):
            return (np.zeros((self.n_slots, self.cfg.vocab_size),
                             np.float32), None)

    blocks = -(-max_seq // PAGE_SIZE)
    for n_pages in range(4 * blocks + 1, blocks, -1):
        eng = NoModel(cfg, max_seq=max_seq, n_slots=4, params={},
                      device="cpu", kv_layout="paged", page_size=PAGE_SIZE,
                      n_pages=n_pages, prefill_chunk=PAGED_CHUNK)
        _, stats = eng.serve(reqs)
        if allocator_goals(stats):
            return n_pages, stats
    fail("no pool size makes the allocator workload preempt, share and grow")


def paged_allocator(cfg, engine_c):
    """bf16 at full width: the allocator workload on the planned pool.
    Returns (topk_gather launches, decode steps) of its run."""
    from repro_torch.launch.serve import Engine
    reqs = allocator_requests(cfg.vocab_size)
    max_seq = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 1
    n_pages, plan = plan_pool(cfg, reqs, max_seq)
    print(f"[paged] pool planned by the scheduler and allocator alone (no "
          f"model, CPU): {n_pages} pages of {PAGE_SIZE} (full backing "
          f"{4 * -(-max_seq // PAGE_SIZE) + 1}); planned "
          + ", ".join(f"{k} {plan[k]}" for k in ALLOC_KEYS))
    eng = Engine(cfg, max_seq=max_seq, n_slots=4, params=engine_c.params,
                 device="cuda", kv_layout="paged", page_size=PAGE_SIZE,
                 n_pages=n_pages, prefill_chunk=PAGED_CHUNK)
    reset_counts()
    out, stats = eng.serve(reqs)
    counts = read_counts()
    launches, steps = counts["topk_gather"], stats["decode_steps"]
    print(f"[paged] bf16 allocator workload ({len(reqs)} requests): "
          + ", ".join(f"{k} {stats[k]}" for k in ALLOC_KEYS)
          + f"; kernel launches {counts}")
    if not allocator_goals(stats):
        fail("the allocator workload did not preempt, share and grow on "
             "the card")
    for req in reqs:
        toks = out.get(req.uid, [])
        if len(toks) != req.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"paged request {req.uid} returned {toks}")
    if launches == 0 or launches != cfg.n_layers * steps:
        fail(f"paged: topk_gather launched {launches} times, want "
             f"{cfg.n_layers} x {steps} decode steps")
    print("[paged] pool drained, allocator invariants hold (checked at the "
          "end of serve)")
    return launches, steps


def serve_numbers(stats):
    ttft = float(np.mean(list(stats["ttft_s"].values())))
    return (stats["tok_s"], ttft * 1e3,
            stats["decode_s"] / max(stats["decode_steps"], 1) * 1e3)


def paged_numbers(cfg, engine_c):
    """The paged engine beside the contiguous one on phase 4's workload,
    in turns (contiguous, paged, paged, contiguous); then the largest
    inter-token gap of three short requests while a LONG_PROMPT-token
    prompt is prefilled, in the same turns."""
    from repro_torch.launch.serve import Engine
    from repro_torch.runtime.scheduler import Request
    rng = np.random.default_rng(SEED)
    prompt_len, gen = 16, 16
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               prompt_len).tolist(),
                    max_new_tokens=gen) for i in range(8)]
    long_reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                    prompt_len).tolist(),
                         max_new_tokens=24) for i in range(3)]
    long_reqs.append(Request(uid=3, prompt=rng.integers(
        0, cfg.vocab_size, LONG_PROMPT).tolist(), max_new_tokens=4))
    engines = {}
    for layout in ("contiguous", "paged"):
        kw = ({} if layout == "contiguous" else
              dict(kv_layout="paged", page_size=PAGE_SIZE,
                   prefill_chunk=PAGED_CHUNK))
        engines[layout] = (
            Engine(cfg, max_seq=prompt_len + gen + 1, n_slots=4,
                   params=engine_c.params, device="cuda", **kw),
            Engine(cfg, max_seq=LONG_PROMPT + 5, n_slots=4,
                   params=engine_c.params, device="cuda", **kw))
        for eng, work in zip(engines[layout], (reqs, long_reqs)):
            eng.serve(work)                               # warm-up
    runs = collections.defaultdict(list)
    gaps = collections.defaultdict(list)
    for layout in ("contiguous", "paged", "paged", "contiguous"):
        eng, eng_long = engines[layout]
        _, stats = eng.serve(reqs)
        runs[layout].append(serve_numbers(stats))
        _, stats_long = eng_long.serve(long_reqs)
        gaps[layout].append([eng_long.records[u].itl_max * 1e3
                             for u in range(3)])
        tok_s, ttft, step = runs[layout][-1]
        print(f"[paged] {layout}: {tok_s:.2f} tok/s, mean TTFT {ttft:.2f} "
              f"ms, decode step {step:.3f} ms (host clock); with a "
              f"{LONG_PROMPT}-token prompt: largest inter-token gap of the "
              f"3 short requests {max(gaps[layout][-1]):.3f} ms (each: "
              + ", ".join(f"{g:.3f}" for g in gaps[layout][-1])
              + f"), decode step {serve_numbers(stats_long)[2]:.3f} ms")
    paged = engines["paged"][0]
    acts = step_profile(paged)
    print(f"[paged] one eager paged decode step under torch.profiler: "
          f"{sum(c for c, _ in acts.values())} device activities, "
          f"{sum(t for _, t in acts.values()):.3f} ms busy; on the device "
          f"alone (CUDA graph replay) {step_device_ms(paged):.3f} ms (the "
          "contiguous step: phase 4)")
    return {layout: {"tok_s": [r[0] for r in runs[layout]],
                     "ttft_ms": [r[1] for r in runs[layout]],
                     "decode_step_ms": [r[2] for r in runs[layout]],
                     "long_prompt_itl_max_ms": [max(g) for g in
                                                gaps[layout]]}
            for layout in runs}


def phase_paged(engine_c):
    """Returns (topk_gather launches, decode steps) of the bf16 allocator
    workload: the paged path's run."""
    cfg32, params32 = f32_model()
    free_err = paged_logits(cfg32, params32)
    paged_tokens(cfg32, params32, max(TIE_MARGIN, free_err))
    del params32
    torch.cuda.empty_cache()
    cfg = engine_c.cfg
    launches, steps = paged_allocator(cfg, engine_c)
    numbers = paged_numbers(cfg, engine_c)
    print(f"[paged] numbers {json.dumps(numbers)}")
    return launches, steps


# ---------------------------------------------------------------------------
# phase 8: the sparsity-invariant linter on the card
# ---------------------------------------------------------------------------

SEEDED = {
    "oob_gather": ("src/repro_torch/analysis/csrc/oob_gather.cu",
                   "src/repro/analysis/lint.py:439"),
    "missing_init": ("src/repro_torch/analysis/csrc/missing_init.cu",
                     "src/repro/analysis/lint.py:479"),
}
# The one PyTorch call timed beside each seeded kernel, at the reference's
# own seeded shapes (lint.py:770, :818-829).
SEEDED_LIBRARY = {
    "oob_gather": "F.embedding_bag(pidx, packed[1:], per_sample_weights="
                  "vals, mode='sum'): the same sum over the rows one past "
                  "the indices, for in-range indices",
    "missing_init": "torch.bmm(xg, packed): the function on a zeroed "
                    "output",
}


def seeded_checks():
    """The seeded kernels against their plain versions on in-range inputs
    (indices <= P - 2, so that ``pidx + 1`` stays inside packed; a zeroed
    output).  Returns ({name: max_abs_err}, {name: operands})."""
    from repro_torch.analysis import seeded
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 800)
    b, k, p, g, n = (seeded.OOB_SHAPE[x] for x in "bkpgn")
    vals = randn(gen, b, k)
    pidx = torch.randint(0, p - 1, (b, k), generator=gen, device="cuda",
                         dtype=torch.int32)
    pidx.view(-1)[-1] = p - 2
    packed = randn(gen, p, g, n)
    errs = {"oob_gather": check(
        "oob_gather at the seeded shape, indices in [0, P-2]",
        seeded.oob_gather(vals, pidx, packed),
        seeded.oob_gather_plain(vals, pidx, packed), phase="analysis")}
    s_, m, kk, c, bk = (seeded.MISSING_SHAPE[x] for x in
                        ("s", "m", "k", "c", "bk"))
    xg, w = randn(gen, s_, m, kk), randn(gen, s_, kk, c)
    out = torch.zeros((s_, m, c), device="cuda")
    seeded.missing_init_into(out, xg, w, bk)
    errs["missing_init"] = check(
        "missing_init at the seeded shape on a zeroed output", out,
        seeded.missing_init_plain(torch.zeros_like(out), xg, w, bk),
        phase="analysis")
    return errs, {"oob_gather": (vals, pidx, packed),
                  "missing_init": (xg, w, bk)}


def seeded_times(operands):
    """Each seeded kernel, its plain version and one library call, warm in
    L2 (a few KB of operands), with its bound.  Returns {name: row}."""
    import torch.nn.functional as tF
    from repro_torch.analysis import seeded
    vals, pidx, packed = operands["oob_gather"]
    b, k = vals.shape
    p, g, n = packed.shape
    out = torch.empty((b, g * n), device="cuda")
    table = packed.reshape(p, g * n)[1:]
    pidx64 = pidx.long()
    touched = int(torch.unique(pidx).numel())
    nbytes = b * k * 8 + touched * g * n * 4 + b * g * n * 4
    oob = ({"kernel": lambda: seeded.oob_gather_into(out, vals, pidx, packed),
            "plain": lambda: seeded.oob_gather_plain(vals, pidx, packed),
            "library": lambda: tF.embedding_bag(
                pidx64, table, per_sample_weights=vals, mode="sum")},
           nbytes, 2 * b * k * g * n)
    xg, w, bk = operands["missing_init"]
    s_, m, kk = xg.shape
    c = w.shape[2]
    acc = torch.zeros((s_, m, c), device="cuda")
    nbytes = (xg.numel() + w.numel() + 2 * acc.numel()) * 4
    missing = ({"kernel": lambda: seeded.missing_init_into(acc, xg, w, bk),
                "plain": lambda: seeded.missing_init_plain(acc, xg, w, bk),
                "library": lambda: torch.bmm(xg, w)},
               nbytes, 2 * s_ * m * kk * c)
    rows = {}
    for name, (fns, nbytes, flops) in (("oob_gather", oob),
                                       ("missing_init", missing)):
        ms = {v: device_ms(fn) for v, fn in fns.items()}
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        rows[name] = dict(
            ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"[analysis] {name} (warm): kernel {ms['kernel']:.5f} ms, "
              f"plain {ms['plain']:.5f} ms, library {ms['library']:.5f} "
              f"ms, bound {rows[name]['bound_ms']:.7f} ms "
              f"({rows[name]['bound_by']})")
    return rows


def op_dispatch_us(calls: int = 500, repeats: int = 5):
    """Host time of one ``topk_gather`` call at the main shape through the
    custom op (what the layers call) against ``launch_into`` (the bare
    launch), in µs: the median over ``repeats`` runs of ``calls`` calls,
    synchronised at the end of each.  Both enqueue the same ~6 µs kernel
    and take longer on the host, so the difference is the op's dispatch
    and its output allocation."""
    from repro_torch.kernels.topk_gather import launch_into, topk_gather
    vals, p_idx, s_off, packed_p, route, _ = kernel_operands(
        MAIN_SHAPE, torch.bfloat16, SEED + 900)
    out = torch.empty((vals.shape[0], packed_p.shape[1] * packed_p.shape[2]),
                      device="cuda")
    fns = {"op": lambda: topk_gather(vals, p_idx, s_off, packed_p, route),
           "launch_into": lambda: launch_into(out, vals, p_idx, s_off,
                                              packed_p, route)}
    us = {}
    for name, fn in fns.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / calls * 1e6)
        us[name] = float(np.median(runs))
    extra = us["op"] - us["launch_into"]
    print(f"[analysis] topk_gather host time a call (main shape, median of "
          f"{repeats} x {calls}): custom op {us['op']:.2f} us, launch_into "
          f"{us['launch_into']:.2f} us; the op adds {extra:.2f} us a call, "
          f"{32 * extra / 1e3:.3f} ms a 32-layer decode step")


def guarded_steps(engine_c):
    """One contiguous and one paged decode step at full width, inputs on
    the card, under ``set_sync_debug_mode("error")``: any host sync in
    the step raises.  Each layout's step runs three ways: plain (telemetry
    off), with the dispatch observer on (telemetry on, the first step),
    and probed (under a support capture, whose tensors are read back after
    the guard)."""
    from repro_torch.core.api import observe_dispatch
    from repro_torch.launch.serve import Engine
    from repro_torch.obs import sparsity as obs_sparsity
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.ones(1, device="cuda").item()
    except RuntimeError:
        print("[analysis] sync debug mode 'error' raises on .item(): the "
              "guard is live")
    else:
        fail("sync debug mode 'error' let .item() through")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    engine_p = Engine(engine_c.cfg, max_seq=engine_c.max_seq,
                      n_slots=engine_c.n_slots, params=engine_c.params,
                      device="cuda", kv_layout="paged",
                      page_size=PAGE_SIZE)
    ways = {"telemetry off": contextlib.nullcontext,
            "dispatch observer on": lambda: observe_dispatch(sites.append),
            "probed": obs_sparsity.capture_supports}
    for label, engine in (("contiguous", engine_c), ("paged", engine_p)):
        step = _decode_step(engine)
        with torch.no_grad():
            step()                                    # warm-up, unguarded
            torch.cuda.synchronize()
            for way, ctx in ways.items():
                sites = []
                with ctx() as cap:
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        logits, _ = step()
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(logits.float()).all()):
                    fail(f"the guarded {label} decode step ({way}) gave "
                         "non-finite logits")
                extra = ""
                if way == "probed":
                    host = cap.to_host()             # the readback
                    if len(host) != len(engine.cfg.block_pattern) or any(
                            a[0].shape != (engine.cfg.n_layers // len(
                                engine.cfg.block_pattern), engine.n_slots, 1)
                            for a in host.values()):
                        fail(f"the probed {label} step captured "
                             f"{ {k: a[0].shape for k, a in host.items()} }")
                    extra = (f"; captured {sorted(host)}, read back after "
                             "the guard")
                if way == "dispatch observer on" and len(sites) != \
                        3 * engine.cfg.n_layers:
                    fail(f"the observer saw {len(sites)} CS layers")
                print(f"[analysis] {label} decode step ({way}) under sync "
                      f"debug mode 'error': no host sync, logits "
                      f"{tuple(logits.shape)} finite{extra}")


def observed_geometries():
    """Each shipped kernel's launch at every case of ``kernel_cases`` as
    ``torch.profiler`` saw the card run it (grid, block, shared memory),
    against the launcher's ``launch_geometry`` that the linter's
    launch-resource rule reads: grid and threads must be equal, and the
    shared memory the profiler reports (static and dynamic) at least the
    dynamic bytes.  Where the profiler records no kernel, says so."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis import kernel_cases
    from repro_torch.analysis.rules import kernel_geometry
    cases = kernel_cases("cuda")
    outs = [[torch.empty(shape, dtype=dt, device="cuda")
             for shape, dt in case.outputs] for case in cases]
    for case, out in zip(cases, outs):           # warm-up, outside the window
        case.run(out, *case.inputs)
    torch.cuda.synchronize()
    # one window for every case (later windows of one process may record
    # no kernel); each case launches one kernel, so the kernels in time
    # order are the cases' launches in order.  A spin kernel at each end
    # of the window takes what its edges may lose (phase 9's window).
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        for case, out in zip(cases, outs):
            case.run(out, *case.inputs)
            torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
    trace_path = ROOT / "build" / "analysis_launch_trace.json"
    prof.export_chrome_trace(str(trace_path))
    kernels = sorted((e for e in json.loads(trace_path.read_text())[
        "traceEvents"] if e.get("cat") == "kernel"
        and "spin_kernel" not in e["name"]), key=lambda e: e["ts"])
    if not kernels:
        print("[analysis] launch geometry against the profiler: not "
              "measured (the profiler recorded no kernel)")
        return
    if len(kernels) != len(cases):
        for e in kernels:
            print(f"[analysis]   seen {e['name'][:80]} grid "
                  f"{e['args']['grid']}")
        fail(f"the profiler saw {len(kernels)} kernels for {len(cases)} "
             "launches")
    for case, event in zip(cases, kernels):
        seen = event["args"]
        want = kernel_geometry(f"repro_torch.{case.kernel}", case.inputs)
        grid, block = tuple(seen["grid"]), seen["block"]
        threads = block[0] * block[1] * block[2]
        if (grid != tuple(want.grid) or threads != want.threads
                or seen["shared memory"] < want.smem):
            fail(f"{case.label}: the card launched {event['name'][:60]} "
                 f"on grid {grid}, block {block}, {seen['shared memory']} "
                 f"B shared memory; launch_geometry says {want}")
    print(f"[analysis] launch geometry of all {len(cases)} cases equals "
          "what the profiler saw the card launch (grid, threads; shared "
          "memory >= the dynamic bytes)")


# The verifier's fixture families: the Pallas fixture each replaces (the
# function that reaches pallas_call) and the one PyTorch call timed beside
# it.
FIXTURES = {
    "gather": ("tests/test_kernel_rules.py:70",
               "F.embedding_bag(pidx, packed rows, per_sample_weights=vals, "
               "mode='sum'): the same sum"),
    "induction": ("tests/test_kernel_rules.py:146", "x.sum(0)"),
    "accum": ("tests/test_kernel_rules.py:163",
              "torch.bmm(x, w): the function on a zeroed output"),
    "pad": ("tests/test_kernel_rules.py:226", "torch.mul(x, 2.0)"),
    "copy_scratch": ("tests/test_kernel_rules.py:268; "
                     "tests/test_analysis.py:171", "out.copy_(x)"),
}
FIXTURE_SOURCE = "src/repro_torch/analysis/csrc/fixtures.cu"


def fixture_findings():
    """Every fixture case through the guarded harness on the card; each
    must give exactly the findings ``fixtures.fixture_cases`` lists.  The
    copy's scratch geometries: ``launch-resource`` over the card's limit,
    found before any launch, and nothing within it."""
    from repro_torch.analysis import check_case, fixtures
    from repro_torch.analysis.rules import check_geometry
    for case, expect in fixtures.fixture_cases("cuda", SEED + 1000):
        found = check_case(case, "fixtures")
        got = tuple((f.rule, re.search(r"(in|out)\[\d+\]",
                                       f.message).group(0)) for f in found)
        print(f"[analysis] fixture {case.label}: "
              + (", ".join(f"{r} {ref}" for r, ref in got) or "clean"))
        if got != expect:
            for f in found:
                print(f"[analysis]   {f.message}")
            fail(f"fixture {case.label}: the harness found {got}, want "
                 f"{expect}")
    for label, (geo, over) in fixtures.resource_cases().items():
        found = check_geometry("copy_scratch", geo)
        print(f"[analysis] fixture copy_scratch {label}: "
              + ("; ".join(f.message for f in found) or "clean")
              + ("" if over else ", launched above"))
        if [f.rule for f in found] != (["launch-resource"] if over else []):
            fail(f"fixture copy_scratch {label}: geometry findings "
                 f"{[f.rule for f in found]}")


def fixture_rows(counts):
    """Each fixture family's clean launch against its plain version (exact
    for the copies, 1e-6·(1 + max|plain|) for the sums), then its time,
    its plain version's and one library call's, warm in L2 (a few hundred
    bytes), with its bound.  Returns the families' rows of the kernels
    line, with ``counts``' launches (the analysis run's)."""
    import torch.nn.functional as tF
    from repro_torch.analysis import fixtures as fx
    ops = fx.operands("cuda", SEED + 1001)
    vals, pidx, packed = ops["gather"]
    b, k = vals.shape
    p, g, n = packed.shape
    out_g = torch.empty((b, g * n), device="cuda")
    table, pidx64 = packed.reshape(p, g * n), pidx.long()
    touched = int(torch.unique(pidx).numel())
    (x_i,) = ops["induction"]
    out_i = torch.empty((x_i.shape[1],), device="cuda")
    x_a, w_a = ops["accum"]
    out_a = torch.empty((x_a.shape[0], x_a.shape[1], w_a.shape[2]),
                        device="cuda")
    plain_a = torch.empty_like(out_a)
    (x_p,) = ops["pad6"]
    out_p = torch.empty_like(x_p)
    (x_c,) = ops["copy"]
    out_c, lib_c = torch.empty_like(x_c), torch.empty_like(x_c)
    scratch = int(np.prod(fx.SCRATCH_SHAPES["within"]))
    # name: (kernel, plain, library, exact, bytes, flops)
    families = {
        "gather": (lambda: fx.gather_into(out_g, vals, pidx, packed, 0),
                   lambda: fx.gather_plain(vals, pidx, packed, 0),
                   lambda: tF.embedding_bag(pidx64, table,
                                            per_sample_weights=vals,
                                            mode="sum"),
                   out_g, False, b * k * 8 + touched * g * n * 4
                   + b * g * n * 4, 2 * b * k * g * n),
        "induction": (lambda: fx.induction_into(out_i, x_i, 0),
                      lambda: fx.induction_plain(x_i, 0),
                      lambda: x_i.sum(0), out_i, False,
                      (x_i.numel() + out_i.numel()) * 4, x_i.numel()),
        "accum": (lambda: fx.accum_into(out_a, x_a, w_a, "init", 2),
                  lambda: fx.accum_plain(plain_a, x_a, w_a, "init", 2),
                  lambda: torch.bmm(x_a, w_a), out_a, False,
                  (x_a.numel() + w_a.numel() + out_a.numel()) * 4,
                  2 * x_a.numel() * w_a.shape[2]),
        "pad": (lambda: fx.pad_into(out_p, x_p, True),
                lambda: fx.pad_plain(x_p, True),
                lambda: torch.mul(x_p, 2.0), out_p, True,
                2 * x_p.numel() * 4, x_p.numel()),
        "copy_scratch": (lambda: fx.copy_scratch_into(out_c, x_c, scratch),
                         lambda: fx.copy_scratch_plain(x_c),
                         lambda: lib_c.copy_(x_c), out_c, True,
                         2 * x_c.numel() * 4, 0),
    }
    rows = []
    for name, (kern, plain, lib, out, exact, nbytes, flops) in \
            families.items():
        kern()
        want = plain()
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        tol = 0.0 if exact else 1e-6 * (1.0 + float(want.abs().max()))
        ok = bool(torch.equal(out, want)) if exact else err <= tol
        print(f"[analysis] fixture {name} clean launch against its plain "
              f"version: max_abs_err={err:.3e} tol={tol:.3e}")
        if not ok:
            fail(f"fixture {name}: the kernel disagrees with its plain "
                 "version")
        ms = {v: device_ms(fn) for v, fn in (("kernel", kern),
                                             ("plain", plain),
                                             ("library", lib))}
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        replaces, note = FIXTURES[name]
        rows.append({"name": name, "route": "cuda",
                     "source": FIXTURE_SOURCE, "replaces": replaces,
                     "launches": counts[name], "max_abs_err": err,
                     "ms": ms["kernel"], "plain_ms": ms["plain"],
                     "bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": ("bytes" if t_bytes >= t_ops
                                  else "operations"),
                     "library_ms": ms["library"], "library_note": note})
        print(f"[analysis] fixture {name} (warm): kernel {ms['kernel']:.5f} "
              f"ms, plain {ms['plain']:.5f} ms, library {ms['library']:.5f}"
              f" ms, bound {rows[-1]['bound_ms']:.7f} ms "
              f"({rows[-1]['bound_by']})")
    return rows


def phase_analysis(engine_c):
    """Returns the seeded kernels' and the fixture families' rows of the
    kernels line."""
    from repro_torch.analysis import (lint_config, lint_kernels, self_test,
                                      trace)
    from repro_torch.analysis.lint import entry_args, resolve_config
    from repro_torch.analysis.rules import KERNEL_OPS
    from repro_torch.analysis.graph_walk import iter_nodes, op_name
    errs, operands = seeded_checks()

    reset_counts()
    failures = self_test("cuda")
    report = lint_kernels("cuda")
    fixture_findings()
    counts = read_counts()
    for f in failures:
        print(f"[analysis] self-test: {f}")
    if failures:
        fail("the self-test missed a seeded fault")
    print("[analysis] self-test: all four seeded regressions caught, the "
          "two kernel faults by guarded launches of the CUDA kernels")
    print(f"[analysis] lint_kernels: {len(report.findings)} findings over "
          f"{len(report.entries)} cases")
    if not report.ok:
        print(report.render())
        fail("lint_kernels found faults in the shipped kernels")
    print(f"[analysis] kernel launches of the self-test, lint_kernels and "
          f"fixtures run: {counts}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched by the analysis run: {missing}")

    # in a fresh process: after phases 4 and 7's profiler windows, a later
    # window of this one may record no kernel
    subprocess.run([sys.executable, "-c", "import sys; sys.path[:0] = "
                    f"[{str(ROOT / 'src')!r}, {str(ROOT)!r}]; import "
                    "chip_smoke; chip_smoke.observed_geometries()"],
                   check=True, timeout=600)

    t = time.perf_counter()
    report = lint_config("smollm-360m", device="cuda")
    print(f"[analysis] lint_config('smollm-360m') full width on fake CUDA "
          f"tensors in {time.perf_counter() - t:.1f} s: "
          + report.render().splitlines()[0])
    if not report.ok:
        print(report.render())
        fail("lint_config('smollm-360m') found faults")
    cfg = resolve_config("smollm-360m")
    fn, args = entry_args(cfg, "decode", "cuda")
    ops = collections.Counter(op_name(nd) for nd, _ in iter_nodes(
        trace(fn, *args)))
    nodes = {k: ops[k] for k in KERNEL_OPS if ops[k]}
    print(f"[analysis] kernel nodes in the traced full-width decode step: "
          f"{nodes}")
    if nodes != {"repro_torch.topk_gather": cfg.n_layers}:
        fail(f"the decode graph holds {nodes}, want {cfg.n_layers} "
             "repro_torch.topk_gather nodes and no other kernel")

    guarded_steps(engine_c)
    op_dispatch_us()
    times = seeded_times(operands)
    return ([dict({"name": name, "route": "cuda", "source": source,
                   "replaces": replaces, "launches": counts[name],
                   "max_abs_err": errs[name]}, **times[name],
                  library_note=SEEDED_LIBRARY[name])
             for name, (source, replaces) in SEEDED.items()]
            + fixture_rows(counts))


# ---------------------------------------------------------------------------
# phase 9: serving telemetry at full width
# ---------------------------------------------------------------------------

def phase4_requests(vocab):
    """Phase 4's workload: 8 requests, prompts of 16, 16 new tokens."""
    from repro_torch.runtime.scheduler import Request
    rng = np.random.default_rng(SEED)
    return [Request(uid=i, prompt=rng.integers(0, vocab, 16).tolist(),
                    max_new_tokens=16) for i in range(8)]


def layout_kw(layout):
    return ({} if layout == "contiguous" else
            dict(kv_layout="paged", page_size=PAGE_SIZE,
                 prefill_chunk=PAGED_CHUNK))


def same_tokens(cfg, params, reqs, want_out, got_out, label,
                phase="telemetry", margin=TIE_MARGIN):
    """``got_out`` against ``want_out``: equal, or parted only between the
    first run's top two tokens closer than ``margin`` (phase 7's rule)."""
    parted = 0
    for req in reqs:
        want, got = want_out[req.uid], got_out[req.uid]
        if len(got) != len(want):
            fail(f"{label}: request {req.uid} returned {len(got)} tokens, "
                 f"want {len(want)}")
        part = next((j for j, (a, b) in enumerate(zip(want, got))
                     if a != b), None)
        if part is None:
            continue
        best, gap = top2(cfg, params, list(req.prompt) + want[:part])
        print(f"[{phase}] {label}: request {req.uid} parts at step "
              f"{part}; top two {sorted(best)}, margin {gap:.3e} (bound "
              f"{margin:.3e})")
        if best != {want[part], got[part]} or not gap < margin:
            fail(f"{label}: request {req.uid} differs at step {part} "
                 "beyond a tie of the top two")
        parted += 1
    return parted


def telemetry_serve(cfg, engine_c, layout, reqs):
    """One layout with telemetry off, then on (JSONL, every step probed):
    every phase-9 check of that run.  Returns the telemetry-on snapshot."""
    from repro_torch.kernels.topk_gather import launch_geometry, static_smem
    from repro_torch.launch.serve import Engine
    from repro_torch.obs import Telemetry
    from repro_torch.obs.export import validate_jsonl
    max_seq = 33
    off = Engine(cfg, max_seq=max_seq, n_slots=4, params=engine_c.params,
                 device="cuda", **layout_kw(layout))
    out_off, _ = off.serve(reqs)
    path = ROOT / "build" / "telemetry" / f"{layout}.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    tel = Telemetry.on(jsonl_path=str(path), sparsity_every=1)
    on = Engine(cfg, max_seq=max_seq, n_slots=4, params=engine_c.params,
                device="cuda", telemetry=tel, **layout_kw(layout))
    reset_counts()
    out_on, stats = on.serve(reqs)
    counts = read_counts()
    tel.close()
    snap = on.metrics_snapshot()
    steps = stats["decode_steps"]
    parted = same_tokens(cfg, engine_c.params, reqs, out_off, out_on,
                         f"{layout} telemetry on vs off")
    print(f"[telemetry] {layout}: tokens with telemetry on equal the "
          f"telemetry-off run's ({len(reqs) - parted} identical, {parted} "
          f"parted at a tie); {steps} decode steps, "
          f"{snap['sparsity']['probe_steps']} probed; kernel launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if counts["topk_gather"] != cfg.n_layers * steps:
        fail(f"{layout}: topk_gather launched {counts['topk_gather']} "
             f"times, want {cfg.n_layers} x {steps} decode steps")
    if snap["sparsity"]["probe_steps"] != steps:
        fail(f"{layout}: {snap['sparsity']['probe_steps']} probed steps of "
             f"{steps}")
    layers = snap["sparsity"]["layers"]
    k = cfg.ffn_sparsity.k_for(cfg.d_ff)
    fracs = {name: e.get("realized_k_frac") for name, e in layers.items()}
    bad = {n: f for n, f in fracs.items()
           if f is None or not k / cfg.d_ff <= f <= 1.0}
    print(f"[telemetry] {layout}: {len(layers)} FFN layers report "
          f"realized_k_frac in [{min(fracs.values()):.6f}, "
          f"{max(fracs.values()):.6f}] (K/d_ff = {k / cfg.d_ff:.6f})")
    if len(layers) != cfg.n_layers or bad:
        fail(f"{layout}: layers {sorted(layers)[:4]}..., out of [K/d_ff, "
             f"1]: {bad}")
    paths = snap["sparsity"]["paths"]["paths"]
    topk = paths.get("topk[cuda]", {})
    n = cfg.ffn_sparsity.n
    weight_bytes = on.params["layers"][0]["ffn"]["down"]["packed_p"] \
        .element_size()
    smem = (launch_geometry(on.n_slots, k, cfg.d_model // n, n,
                            weight_bytes).smem + static_smem(weight_bytes))
    print(f"[telemetry] {layout}: dispatch summary of one decode step "
          f"{json.dumps(paths)}; est_smem_bytes a topk site {smem} B "
          "(launch geometry + static arrays)")
    if topk.get("sites") != cfg.n_layers or \
            topk.get("est_smem_bytes") != cfg.n_layers * smem:
        fail(f"{layout}: topk[cuda] {topk}, want {cfg.n_layers} sites of "
             f"{smem} B")
    n, errors = validate_jsonl(str(path))
    kinds = collections.Counter(json.loads(line)["kind"]
                                for line in path.read_text().splitlines())
    print(f"[telemetry] {layout}: {path.name} {n} events {dict(kinds)}, "
          f"schema {'OK' if not errors else errors[:3]}")
    if errors or set(kinds) != {"span", "request", "snapshot"}:
        fail(f"{layout}: the JSONL fails validate_jsonl or lacks an event "
             "kind")
    return snap


def step_variants(engine):
    """The engine's decode step at position 16, its inputs on the host as
    the serve loop hands them over: {variant: callable}, for telemetry
    off, on but unprobed (with the dispatch observer, as the first step),
    and probed (with the capture's readback)."""
    from repro_torch.core.api import observe_dispatch
    n = engine.n_slots
    tables = None
    if engine.kv_layout == "paged":
        cache = engine.new_paged_cache()
        blocks = engine.kv_geo.blocks_per_slot
        tables = np.arange(1, n * blocks + 1).reshape(n, blocks)
    else:
        cache = engine.new_cache(n)
    tokens = np.zeros((n, 1), np.int64)
    pos = np.full((n,), 16, np.int64)

    def off():
        engine._decode_step(cache, tokens, pos, tables)

    def unprobed():
        with observe_dispatch(lambda ev: None):
            engine._decode_step(cache, tokens, pos, tables)

    def probed():
        _, cap = engine._decode_step(cache, tokens, pos, tables, probed=True)
        cap.to_host()

    return {"off": off, "on, unprobed": unprobed, "on, probed": probed}


def settled(calls):
    """The activity count that ACTIVITY_AGREE or more calls saw, and more
    of them than saw any other; else None."""
    seen = collections.Counter(frozenset(c.items()) for c in calls)
    ranked = seen.most_common(2)
    if not ranked or ranked[0][1] < ACTIVITY_AGREE or (
            len(ranked) > 1 and ranked[1][1] == ranked[0][1]):
        return None
    return collections.Counter(dict(ranked[0][0]))


def activity_window(layout):
    """The device activities (kernels, copies) of the decode step of each
    variant of ``step_variants`` on a fresh engine (phase 4's weights),
    under one ``torch.profiler`` window; written as JSON to
    build/activities_<layout>.json: {variant: [{name: count} a call]}.

    Run in a process of its own (``telemetry_activities``): in a process
    that has opened profiler windows before, a window may miss the head
    or the tail of its records or none at all.  Inside the window each
    call is a host range that starts with a spin kernel and ends with a
    sync, and the calls are 2 ms apart; a device activity belongs to the
    call whose range last began before it started.  A call's records are
    then told apart by the host clock alone, with the spin's 0.5 ms
    between a range's start and its first activity.  A pad call at each
    end of the window takes what the window's edges may lose."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine
    eng = Engine(get_config("smollm-360m"), max_seq=33, n_slots=4,
                 device="cuda", **layout_kw(layout))
    variants = step_variants(eng)
    order = (["pad"] + [v for _ in range(ACTIVITY_ROUNDS) for v in variants]
             + ["pad"])
    with torch.no_grad():
        for fn in variants.values():                # warm-up
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i, v in enumerate(order):
                with record_function(f"call {i}"):
                    torch.cuda._sleep(1_000_000)
                    variants["off" if v == "pad" else v]()
                    torch.cuda.synchronize()
                time.sleep(0.002)
    t = time.perf_counter()
    trace_path = ROOT / "build" / f"activities_{layout}.trace.json"
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    trace_path.unlink()
    begins = {int(e["name"].split()[1]): e["ts"] for e in events
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("call ")}
    if sorted(begins) != list(range(len(order))):
        fail(f"{layout}: the profiler kept the ranges {sorted(begins)} of "
             f"{len(order)} calls")
    starts = [begins[i] for i in range(len(order))]
    calls = [collections.Counter() for _ in order]
    for e in events:
        if (e.get("cat") not in DEVICE_CATS
                or "spin_kernel" in e["name"]):
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0:
            calls[i][e["name"]] += 1
    print(f"[telemetry] {layout}: {len(order)} calls' trace read in "
          f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    out = {v: [dict(c) for c, w in zip(calls, order) if w == v]
           for v in variants}
    (ROOT / "build" / f"activities_{layout}.json").write_text(
        json.dumps(out))


def telemetry_activities():
    """Device activities of the decode step with telemetry off and on but
    unprobed must be the same; the probed step's extra ones (and any it
    lacks) are printed.  Each layout's window runs in a fresh process
    (``activity_window``)."""
    for layout in ("contiguous", "paged"):
        path = ROOT / "build" / f"activities_{layout}.json"
        path.unlink(missing_ok=True)
        t = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import sys; sys.path[:0] = "
                        f"[{str(ROOT / 'src')!r}, {str(ROOT)!r}]; import "
                        f"chip_smoke; chip_smoke.activity_window("
                        f"{layout!r})"], check=True, timeout=600)
        windows = {v: [collections.Counter(c) for c in calls]
                   for v, calls in json.loads(path.read_text()).items()}
        per_call = {v: [sum(c.values()) for c in w]
                    for v, w in windows.items()}
        print(f"[telemetry] {layout} decode step under torch.profiler, "
              f"activities a call: {json.dumps(per_call)} (the window's "
              f"process took {time.perf_counter() - t:.1f} s)")
        acts = {v: settled(w) for v, w in windows.items()}
        unsettled = [v for v, a in acts.items() if a is None]
        if unsettled:
            fail(f"{layout}: no count of the device activities was seen "
                 f"in {ACTIVITY_AGREE} calls of {unsettled}")
        total = {v: sum(a.values()) for v, a in acts.items()}
        print(f"[telemetry] {layout} decode step under torch.profiler: "
              + ", ".join(f"{v} {t} device activities"
                          for v, t in total.items()))
        if not total["off"]:
            fail(f"{layout}: the profiler recorded no device activity")
        if acts["on, unprobed"] != acts["off"]:
            fail(f"{layout}: telemetry on, unprobed, changes the step's "
                 f"device activities: {acts['on, unprobed'] - acts['off']}"
                 f" more, {acts['off'] - acts['on, unprobed']} fewer")
        extra = acts["on, probed"] - acts["off"]
        print(f"[telemetry] {layout}: the probed step's extra device "
              f"activities ({sum(extra.values())}):")
        for name, count in extra.most_common():
            print(f"[telemetry]   {count:4d}x {name[:100]}")
        missing = acts["off"] - acts["on, probed"]
        if missing:
            print(f"[telemetry] {layout}: activities of the unprobed step "
                  f"the probed one lacks: {dict(missing)}")


def telemetry_overhead(cfg, engine_c, reqs):
    """tok/s and the host-clock decode step with telemetry off and on
    (every step probed), in turns off, on, on, off, on each layout."""
    from repro_torch.launch.serve import Engine
    from repro_torch.obs import Telemetry
    rows = {}
    for layout in ("contiguous", "paged"):
        runs = collections.defaultdict(list)
        for turn in ("off", "on", "on", "off"):
            tel = Telemetry.on(sparsity_every=1) if turn == "on" else None
            eng = Engine(cfg, max_seq=33, n_slots=4, params=engine_c.params,
                         device="cuda", telemetry=tel, **layout_kw(layout))
            _, stats = eng.serve(reqs)
            tok_s, _, step_ms = serve_numbers(stats)
            runs[turn].append((tok_s, step_ms))
            print(f"[telemetry] overhead {layout} telemetry {turn}: "
                  f"{tok_s:.2f} tok/s, decode step {step_ms:.3f} ms (host "
                  "clock)")
        rows[layout] = {t: {"tok_s": [r[0] for r in v],
                            "decode_step_ms": [r[1] for r in v]}
                        for t, v in runs.items()}
    print(f"[telemetry] overhead {json.dumps(rows)}")


def phase_telemetry(engine_c):
    """Phase 9 on the engine of phase 4 (its weights)."""
    from repro_torch.obs import latency_columns, sparsity_columns
    cfg = engine_c.cfg
    reqs = phase4_requests(cfg.vocab_size)
    for layout in ("contiguous", "paged"):
        snap = telemetry_serve(cfg, engine_c, layout, reqs)
        print(f"[telemetry] {layout} latency_columns "
              f"{json.dumps(latency_columns(snap))}")
        print(f"[telemetry] {layout} sparsity_columns "
              f"{json.dumps(sparsity_columns(snap))}")
        print(f"[telemetry] {layout} stage totals (host clock) "
              f"{json.dumps(snap['stages'])}")
    telemetry_activities()
    telemetry_overhead(cfg, engine_c, reqs)


# ---------------------------------------------------------------------------
# phase 10: the MoE + MLA family at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "deepseek-v2-lite-16b"
# Its shared experts' down projection at decode with 4 slots (d_ff
# 2·1408 = 2816 -> 2048): B=4, K=k_for(2816)=352, P=704, G=512, N=4, R=G.
MOE_SHAPE = dict(b=4, k=352, p=704, g=512, n=4, r=512)


@contextlib.contextmanager
def router_choices(held=None):
    """Record every MoE router's expert choice made inside, in call order;
    with ``held`` (an iterator of choices, one a call) route by those
    instead, each token's weights read from its own softmax at the held
    experts.  The MoE block routes with ``repro_torch.models.moe.
    router_top_k``."""
    moe = importlib.import_module("repro_torch.models.moe")
    route, choices = moe.router_top_k, []

    def spy(probs, k):
        if held is None:
            top_p, top_e = route(probs, k)
        else:
            top_e = next(held)
            top_p = probs.gather(-1, top_e)
        choices.append(top_e)
        return top_p, top_e

    moe.router_top_k = spy
    try:
        yield choices
    finally:
        moe.router_top_k = route


def cache_bytes(cache):
    return sum(leaf.numel() * leaf.element_size()
               for layer in cache for leaf in layer.values())


def moe_kernel():
    """(c) ``topk_gather`` at the shared experts' decode shape against its
    plain version (bf16, and the support as the layer hands it over), then
    its times.  Returns the row-1 keys of that shape."""
    from repro_torch.kernels.topk_gather import topk_gather, topk_gather_plain
    vals, p_idx, s_off, packed_p, route, packed = kernel_operands(
        MOE_SHAPE, torch.bfloat16, SEED + 60)
    err = 0.0
    for label, operands in (
            ("", (vals, p_idx, s_off, packed_p, route)),
            (", bf16 values, int64 indices",
             (vals.to(torch.bfloat16), p_idx.long(), s_off.long(), packed_p,
              route))):
        err = max(err, check(f"topk_gather {MOE_SHAPE} bf16{label}",
                             topk_gather(*operands),
                             topk_gather_plain(*operands), phase="moe"))
    times = topk_times(MOE_SHAPE, vals, p_idx, s_off, packed_p, route,
                       packed, "moe")
    return {"shape": MOE_SHAPE, "max_abs_err": err, **times}


def moe_serve(params, cfg, reqs):
    """(a)+(b) on one weight set: the bf16 engine on both layouts, each
    after a warm-up, the counts set to 0 just before its run; then the
    step's launches, profile and device time.  Returns the topk_gather
    launches and decode steps of the two runs."""
    from repro_torch.launch.serve import Engine
    from repro_torch.models import transformer as T
    launches = steps = 0
    outs = {}
    for layout in ("contiguous", "paged"):
        eng = Engine(cfg, max_seq=33, n_slots=4, params=params,
                     device="cuda", **layout_kw(layout))
        eng.serve(reqs[:1])                    # warm-up
        eng.prefill_calls = 0
        reset_counts()
        outs[layout], stats = eng.serve(reqs)
        counts = read_counts()
        n, k = counts["topk_gather"], stats["decode_steps"]
        tok_s, ttft, step_ms = serve_numbers(stats)
        print(f"[moe] {MOE_ARCH} full width bf16, {layout}: {len(reqs)} "
              f"requests, {k} decode steps, {stats['prefill_calls']} "
              f"prefill calls, {tok_s:.2f} tok/s, mean TTFT {ttft:.2f} ms, "
              f"decode step {step_ms:.3f} ms (host clock); kernel launches "
              f"{counts}")
        if stats["prefill_calls"] != len(reqs):
            fail(f"moe {layout}: prefill_calls {stats['prefill_calls']}")
        for req in reqs:
            toks = outs[layout].get(req.uid, [])
            if len(toks) != req.max_new_tokens or not all(
                    0 <= t < cfg.vocab_size for t in toks):
                fail(f"moe {layout}: request {req.uid} returned {toks}")
        if n == 0 or n != cfg.n_layers * k:
            fail(f"moe {layout}: topk_gather launched {n} times, want "
                 f"{cfg.n_layers} x {k} decode steps")
        launches, steps = launches + n, steps + k
    same = sum(outs["contiguous"][r.uid] == outs["paged"][r.uid]
               for r in reqs)
    print(f"[moe] paged tokens equal to contiguous in {same} of {len(reqs)} "
          "requests (not required: a prompt bucket and a prefill chunk "
          "compete for expert capacity differently, in the reference too)")
    # (b) one fused prefill launches nothing (B·S·K >= d_ff: Hadamard), one
    # decode step launches once a layer
    toks = torch.tensor([reqs[0].prompt], device="cuda")
    with torch.no_grad():
        reset_counts()
        T.prefill(params, {"tokens": toks}, cfg, 33)
        torch.cuda.synchronize()
        in_prefill = read_counts()["topk_gather"]
        step = _decode_step(eng)
        reset_counts()
        step()
        torch.cuda.synchronize()
        in_step = read_counts()["topk_gather"]
    d_ff = cfg.n_shared_experts * cfg.d_ff
    k = cfg.ffn_sparsity.k_for(d_ff)
    print(f"[moe] topk_gather launches: one prefill of 1 x "
          f"{len(reqs[0].prompt)} tokens {in_prefill} (B·S·K = "
          f"{len(reqs[0].prompt) * k} >= d_ff {d_ff}), one decode step of 4 "
          f"slots {in_step} (4·K = {4 * k} < {d_ff})")
    if in_prefill != 0 or in_step != cfg.n_layers:
        fail(f"moe: topk_gather launched {in_prefill} times in prefill and "
             f"{in_step} in a decode step, want 0 and {cfg.n_layers}")
    for layout, e in (("contiguous", Engine(cfg, max_seq=33, n_slots=4,
                                            params=params, device="cuda")),
                      ("paged", eng)):
        acts = step_profile(e)
        print(f"[moe] one eager {layout} decode step under torch.profiler: "
              f"{sum(c for c, _ in acts.values())} device activities, "
              f"{sum(t for _, t in acts.values()):.3f} ms busy; by time:")
        for name, (count, ms) in sorted(acts.items(),
                                        key=lambda kv: -kv[1][1])[:PROFILE_TOP]:
            print(f"[moe]   {ms:8.3f} ms {count:5d}x {name[:100]}")
        try:
            dev_ms = step_device_ms(e)
        except RuntimeError as err:         # capture refused: say why
            print(f"[moe] the {layout} decode step does not capture in a "
                  f"CUDA graph: {str(err).splitlines()[0][:300]}")
        else:
            print(f"[moe] one {layout} decode step on the device alone "
                  f"(CUDA graph replay): {dev_ms:.3f} ms")
    return launches, steps


def moe_parity(cfg32):
    """(d) f32 at full width: a prefill of two prompts and 3 decode steps
    through the kernel (``use_pallas="auto"``) against the formula
    (``"off"``), with every k-WTA selection and every router choice held
    to the kernel run's."""
    from repro_torch.models import transformer as T
    params = T.init_model(cfg32, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 7)
    b, s = 2, 16
    prompt = torch.from_numpy(rng.integers(0, cfg32.vocab_size, (b, s))).cuda()
    steps = [torch.from_numpy(rng.integers(0, cfg32.vocab_size, (b, 1)))
             .cuda() for _ in range(3)]

    def run(mode):
        cfg_m = dataclasses.replace(cfg32, ffn_sparsity=dataclasses.replace(
            cfg32.ffn_sparsity, use_pallas=mode))
        with torch.no_grad():
            logits, cache = T.prefill(params, {"tokens": prompt}, cfg_m,
                                      s + 3)
            rows = [logits[:, -1]]
            for i, tok in enumerate(steps):
                logits, cache = T.serve_step(params, cache, {"tokens": tok},
                                             s + i, cfg_m)
                rows.append(logits)
        return torch.stack(rows)

    reset_counts()
    with kwta_selections() as masks, router_choices() as choices:
        got = run("auto")
    torch.cuda.synchronize()
    launches = read_counts()["topk_gather"]
    with kwta_selections(iter(masks)), router_choices(iter(choices)):
        want = run("off")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        fail("moe parity: non-finite logits")
    err = float((got - want).abs().max())
    tol = 1e-3
    print(f"[moe] f32 full width, prefill of {b} x {s} + 3 decode steps, "
          f"kernel vs formula, {len(masks)} k-WTA selections and "
          f"{len(choices)} router choices held: max_abs_err={err:.3e} (max "
          f"|logit| {float(want.abs().max()):.3f}) tol={tol:.0e}; "
          f"topk_gather launches {launches}")
    if launches != 3 * cfg32.n_layers:
        fail(f"moe parity: topk_gather launched {launches} times, want "
             f"3 steps x {cfg32.n_layers} layers")
    if not err <= tol:
        fail("moe parity: kernel path and formula path disagree")


def int8_serve(engine_c, reqs):
    """(e) smollm-360m with ``kv_cache_dtype="int8"`` at full width, phase
    4's workload on both layouts: in bf16 on phase 4's weights, tok/s,
    TTFT, the step and the cache's bytes against bf16's; in float32 (phase
    7's model), paged tokens equal to contiguous ones but at ties, by
    phase 7's rule.  The int8 rounding of a K/V row is a selection too: a
    row that differs by ~1e-7 between a fused prefill and a chunk may
    round to another level, which holding the k-WTA sets does not cover.
    So the held difference is printed, not gated, and the tie bound is
    the free difference between the layouts measured here."""
    from repro_torch.launch.serve import Engine
    outs = {}
    cfg = dataclasses.replace(engine_c.cfg, kv_cache_dtype="int8")
    for layout in ("contiguous", "paged"):
        eng = Engine(cfg, max_seq=33, n_slots=4, params=engine_c.params,
                     device="cuda", **layout_kw(layout))
        eng.serve(reqs[:1])                    # warm-up
        reset_counts()
        outs[layout], stats = eng.serve(reqs)
        n = read_counts()["topk_gather"]
        tok_s, ttft, step_ms = serve_numbers(stats)
        print(f"[moe] smollm-360m int8 KV cache, bf16, {layout}: "
              f"{tok_s:.2f} tok/s, mean TTFT {ttft:.2f} ms, decode step "
              f"{step_ms:.3f} ms (host clock); topk_gather launches {n} in "
              f"{stats['decode_steps']} decode steps")
        if n != cfg.n_layers * stats["decode_steps"]:
            fail(f"int8 {layout}: topk_gather launched {n} times")
    same = sum(outs["contiguous"][r.uid] == outs["paged"][r.uid]
               for r in reqs)
    print(f"[moe] int8 bf16 paged tokens equal to contiguous in {same} of "
          f"{len(reqs)} requests (the rule is held in float32, below)")
    int8 = Engine(cfg, max_seq=33, n_slots=4, params=engine_c.params,
                  device="cuda")
    bf16 = cache_bytes(engine_c.new_cache(4))
    q = cache_bytes(int8.new_cache(4))
    scales = cache_bytes([{k: v for k, v in c.items() if "scale" in k}
                          for c in int8.new_cache(4)])
    print(f"[moe] int8 cache of 4 slots x 33 rows: {q} B against bf16's "
          f"{bf16} B (int8 rows {q - scales} B = half, f32 scales "
          f"{scales} B)")
    if q - scales != bf16 // 2:
        fail("int8 cache rows are not half of the bf16 cache")
    cfg32, params32 = f32_model()
    cfg32 = dataclasses.replace(cfg32, kv_cache_dtype="int8")
    d = layout_logits(cfg32, params32)
    margin = max(TIE_MARGIN, d["free"])
    print(f"[moe] int8 f32 chunked prefill + paged decode vs fused prefill "
          f"+ contiguous decode: max_abs_err {d['held']:.3e} with the k-WTA "
          f"selections held (int8 rounding free), {d['free']:.3e} free "
          f"({d['flips']} of {d['selections']} selections keep another "
          f"set; max |logit| {d['max_logit']:.3f}); tie bound "
          f"{margin:.3e}")
    for layout in ("contiguous", "paged"):
        eng = Engine(cfg32, max_seq=33, n_slots=4, params=params32,
                     device="cuda", **layout_kw(layout))
        outs[layout], _ = eng.serve(reqs)
    parted = same_tokens(cfg32, params32, reqs, outs["contiguous"],
                         outs["paged"], "int8 f32 paged vs contiguous",
                         phase="moe", margin=margin)
    print(f"[moe] int8 f32 paged tokens vs contiguous: {len(reqs) - parted} "
          f"of {len(reqs)} requests identical, {parted} parted at a tie")


def phase_moe(engine_c):
    """Phase 10.  Returns row 1's keys of the MoE path: the timed shape,
    and the launches and decode steps of its serving runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(MOE_ARCH)
    t = time.perf_counter()
    params = T.init_model(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[moe] {MOE_ARCH} as shipped: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, MLA kv_lora {cfg.kv_lora_rank}, {cfg.n_experts} "
          f"routed experts top-{cfg.experts_per_token} + "
          f"{cfg.n_shared_experts} shared, bf16, "
          f"{T.param_count(params) / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
          f"random weights from seed {SEED} in "
          f"{time.perf_counter() - t:.1f} s")
    reqs = phase4_requests(cfg.vocab_size)
    launches, steps = moe_serve(params, cfg, reqs)
    del params
    torch.cuda.empty_cache()
    moe_parity(dataclasses.replace(cfg, compute_dtype="float32"))
    torch.cuda.empty_cache()
    keys = moe_kernel()
    int8_serve(engine_c, phase4_requests(engine_c.cfg.vocab_size))
    return {"moe_shape": keys, "launches_moe": launches,
            "launches_per_decode_step_moe": launches / steps}


# ---------------------------------------------------------------------------
# phase 11: training on the card
# ---------------------------------------------------------------------------

# (a)-(b): the shipped smollm-360m trained at batch 8, seq 128 for 20 steps,
# checkpointed (asynchronously) at step 10.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_SAVE = 8, 128, 20, 10
# (c): the reference test's reduced config (tests/test_train_loop.py:20-23)
RESUME_CUT = dict(d_model=64, d_ff=128, vocab_size=128, n_heads=4,
                  n_kv_heads=2, head_pad=0, n_layers=2)
# (d): the reference's GSC run (tests/test_gsc_e2e.py:17-40)
GSC_VARIANTS = ("dense", "sparse_dense", "sparse_sparse")
GSC_BATCH, GSC_STEPS, GSC_HELD_OUT = 32, 60, 5


def run_fresh(call: str, env=None, timeout: int = 600):
    """``chip_smoke.<call>`` in a process of its own (a profiler window,
    or a determinism mode that must be set before CUDA starts)."""
    import os
    subprocess.run([sys.executable, "-c", "import sys; sys.path[:0] = "
                    f"[{str(ROOT / 'src')!r}, {str(ROOT)!r}]; import "
                    f"chip_smoke; chip_smoke.{call}"], check=True,
                   timeout=timeout, env=dict(os.environ, **(env or {})))


def lm_train_setup(device="cuda"):
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    cfg = get_config("smollm-360m")
    shape = ShapeConfig("phase11", TRAIN_SEQ, TRAIN_BATCH, "train")
    ckpt_dir = ROOT / "build" / "train_ckpt"
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS,
                       ckpt_dir=str(ckpt_dir), checkpoint_every=TRAIN_SAVE,
                       log_every=1)
    return cfg, shape, tcfg


def host_tree(tree):
    """A synchronous host copy of every leaf, path -> tensor."""
    from repro_torch.tree import flatten
    return {k: t.detach().to("cpu", copy=True) for k, t in flatten(tree)}


def train_lm():
    """(a) the port's ``Trainer`` on the shipped smollm-360m at full width;
    (b)'s checkpoint at step TRAIN_SAVE, restored into a fresh Trainer.
    Returns (trainer, median host-clock step ms)."""
    import shutil
    from repro_torch import checkpoint as ckpt
    from repro_torch.data import batch_for
    from repro_torch.launch.train import Trainer
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten
    cfg, shape, tcfg = lm_train_setup()
    shutil.rmtree(tcfg.ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, tcfg, (1, 1), shape, device="cuda")
    if {t.device.type for _, t in flatten(trainer.state_tree())} != {"cuda"}:
        fail("train: the trainer's state is not all on the card")
    sp = cfg.ffn_sparsity
    print(f"[train] smollm-360m as shipped: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype} masters, {cfg.compute_dtype} compute, n={sp.n}"
          f", k_frac={sp.k_frac}, {sp.kwta_impl}; "
          f"{T.param_count(trainer.params) / 1e6:.1f} M parameters; batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} steps, "
          f"lr {tcfg.lr}, warmup {tcfg.warmup_steps}")
    losses, saved = [], {}
    check, save = trainer.guard.check, trainer.save

    def guard(loss):
        losses.append(loss)
        return check(loss)

    def save_spy(async_=True):
        if trainer.step == TRAIN_SAVE:
            saved["host"] = host_tree(trainer.state_tree())
        out = save(async_)
        if trainer.step == TRAIN_SAVE:
            saved["thread"] = out
        return out

    trainer.guard.check, trainer.save = guard, save_spy
    reset_counts()
    t = time.perf_counter()
    trainer.run(TRAIN_STEPS, lambda s: batch_for(cfg, shape, s,
                                                 seed=tcfg.seed),
                log=lambda *a: None)
    wall = time.perf_counter() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps_ms = [e.duration * 1e3 for e in trainer.monitor.events]
    med = float(np.median(steps_ms[2:]))
    rollbacks = trainer.guard.registry.snapshot()["counters"].get(
        "monitor.loss_rollbacks", 0)
    print(f"[train] losses: {' '.join(f'{x:.4f}' for x in losses)}")
    print(f"[train] host-clock step (steps 3-{TRAIN_STEPS}, loss read "
          f"back): median {med:.3f} ms, min {min(steps_ms[2:]):.3f}, max "
          f"{max(steps_ms[2:]):.3f}; first two {steps_ms[0]:.1f}, "
          f"{steps_ms[1]:.1f} ms; {TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.0f} "
          f"tokens/s; run {wall:.1f} s with its checkpoints; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    four = {k: counts[k] for k in ("topk_gather", "packed_matmul",
                                   "grouped_cs_matmul", "kwta_hist")}
    print(f"[train] kernel launches in {TRAIN_STEPS} training steps: {four} "
          f"(a step: {json.dumps({k: v / TRAIN_STEPS for k, v in four.items()})})")
    if any(four.values()):
        fail("train: a kernel of the library ran in a training step")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"train: losses {losses}")
    if rollbacks or trainer.step != TRAIN_STEPS:
        fail(f"train: the loss guard fired ({rollbacks} rollbacks)")
    if not np.mean(losses[-5:]) < losses[0]:
        fail("train: the mean of the last 5 losses is not below the first")

    # (b) the async checkpoint of step TRAIN_SAVE, written while the
    # trainer went on updating its tensors in place
    saved["thread"].join(timeout=600)
    if saved["thread"].is_alive():
        fail("train: the async checkpoint did not finish")
    t = time.perf_counter()
    fresh = Trainer(cfg, tcfg, (1, 1), shape, device="cuda")
    tree, extra = ckpt.restore(tcfg.ckpt_dir, TRAIN_SAVE, fresh.state_tree())
    fresh.params, fresh.opt = tree["params"], tree["opt"]
    got = host_tree(fresh.state_tree())
    differ = [k for k, v in saved["host"].items()
              if not (v.dtype == got[k].dtype and torch.equal(v, got[k]))]
    print(f"[train] save_async at step {extra['step']} ({len(got)} leaves, "
          f"{sum(v.numel() * v.element_size() for v in got.values()) / 2**30:.2f}"
          f" GiB) restored into a fresh Trainer in "
          f"{time.perf_counter() - t:.1f} s: {len(got) - len(differ)} of "
          f"{len(got)} leaves equal to the host copy taken at the save; "
          f"checkpoints on disk {ckpt.list_steps(tcfg.ckpt_dir)}")
    if differ or sorted(got) != sorted(saved["host"]):
        fail(f"train: the restored checkpoint differs in {differ[:5]}")
    del fresh, tree, got, saved
    shutil.rmtree(tcfg.ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return trainer, med


def train_step_window():
    """One full-width training step under ``torch.profiler``, in a fresh
    process (as phase 9's windows): the step between two spin kernels,
    after two warm-up steps and three timed ones; written as JSON to
    build/train_window.json."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.data import canonical, lm_batch
    from repro_torch.launch import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.optim import init_state
    cfg, _, tcfg = lm_train_setup()
    step, acfg = St.make_train_step(cfg, tcfg)
    params = T.init_train_params(cfg, seed=SEED, device="cuda")
    opt = init_state(params, acfg)
    batch = {k: torch.from_numpy(canonical(v)).cuda() for k, v in
             lm_batch(SEED, 0, TRAIN_BATCH, TRAIN_SEQ,
                      cfg.vocab_size).items()}
    host = []
    for i in range(5):
        t = time.perf_counter()
        float(step(params, opt, batch)[2]["loss"])
        host.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        with record_function("train step"):
            float(step(params, opt, batch)[2]["loss"])
            torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
    path = ROOT / "build" / "train_window.trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == "train step"]
    if len(ranges) != 1:
        fail(f"train window: {len(ranges)} ranges of the step")
    lo, hi = ranges[0]["ts"], ranges[0]["ts"] + ranges[0]["dur"]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if (e.get("cat") in DEVICE_CATS and "spin_kernel" not in e["name"]
                and lo <= e["ts"] <= hi):
            by_name[e["name"]][0] += 1
            by_name[e["name"]][1] += e.get("dur", 0) / 1e3
    (ROOT / "build" / "train_window.json").write_text(json.dumps({
        "host_ms": host[2:], "by_name": by_name}))


def train_profile(host_ms):
    """(a) one step's device activities, busy ms and idle share."""
    path = ROOT / "build" / "train_window.json"
    path.unlink(missing_ok=True)
    t = time.perf_counter()
    run_fresh("train_step_window()")
    w = json.loads(path.read_text())
    acts = w["by_name"]
    n = sum(c for c, _ in acts.values())
    busy = sum(ms for _, ms in acts.values())
    own = float(np.median(w["host_ms"]))
    print(f"[train] one full-width training step under torch.profiler (a "
          f"fresh process, {time.perf_counter() - t:.1f} s): {n} device "
          f"activities, {busy:.3f} ms busy; host-clock step there "
          f"{own:.3f} ms (unprofiled, median of 3), here {host_ms:.3f} ms; "
          f"device idle share {1 - busy / own:.3f} there, "
          f"{1 - busy / host_ms:.3f} here; by time:")
    for name, (count, ms) in sorted(acts.items(),
                                    key=lambda kv: -kv[1][1])[:PROFILE_TOP]:
        print(f"[train]   {ms:8.3f} ms {count:5d}x {name[:100]}")
    if n == 0:
        fail("train: the profiler saw no device activity in the step")


def packed_layers(tree, path=""):
    """(path, layer) of every packed linear layer of a params tree."""
    if isinstance(tree, dict):
        here = [(path, tree)] if "packed" in tree else []
        return here + [kv for k, v in tree.items()
                       for kv in packed_layers(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in packed_layers(v, f"{path}/{i}")]
    return []


def serve_trained(trainer):
    """(b) serving params from the trained weights: every packed_p made
    from its trained packed, phase 4's workload through topk_gather, and
    one f32 decode step, kernel against formula, selections held."""
    from repro_torch.core.layers import partition_major
    from repro_torch.launch.serve import Engine
    from repro_torch.models import transformer as T
    cfg = trainer.cfg
    params = T.serving_params(trainer.params, cfg)
    layers = packed_layers(params)
    stale = [p for p, layer in layers
             if not torch.equal(layer["packed_p"],
                                partition_major(layer["packed"]))]
    trained = packed_layers(trainer.params)
    print(f"[train] serving params from the step-{trainer.step} weights: "
          f"{len(layers)} packed layers, packed_p == partition_major(packed)"
          f" in {len(layers) - len(stale)}; the training tree holds "
          f"{sum('packed_p' in x for _, x in trained)} packed_p of "
          f"{len(trained)} packed layers")
    if stale or not layers or any("packed_p" in x for _, x in trained):
        fail(f"train: stale or misplaced packed_p in {stale[:3]}")
    eng = Engine(cfg, max_seq=33, n_slots=4, params=params, device="cuda")
    reqs = phase4_requests(cfg.vocab_size)
    eng.serve(reqs[:1])                       # warm-up
    reset_counts()
    out, stats = eng.serve(reqs)
    n = read_counts()["topk_gather"]
    tok_s, ttft, step_ms = serve_numbers(stats)
    print(f"[train] the trained weights served (phase 4's workload, bf16): "
          f"{tok_s:.2f} tok/s, mean TTFT {ttft:.2f} ms, decode step "
          f"{step_ms:.3f} ms; topk_gather launches {n} in "
          f"{stats['decode_steps']} decode steps")
    if n != cfg.n_layers * stats["decode_steps"] or not n:
        fail(f"train: topk_gather launched {n} times serving the trained "
             "weights")
    if any(len(out[r.uid]) != 16 for r in reqs):
        fail("train: a request of the trained model came back short")
    del eng, params
    # f32: one prefill (Hadamard path) and one decode step through the
    # kernel, then through the formula with every k-WTA selection held
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32 = T.serving_params(trainer.params, cfg32)
    rng = np.random.default_rng(SEED + 2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))

    def run(mode, held):
        cfg_m = dataclasses.replace(cfg32, ffn_sparsity=dataclasses.replace(
            cfg32.ffn_sparsity, use_pallas=mode))
        with torch.no_grad(), kwta_selections(held) as masks:
            _, cache = T.prefill(params32, {"tokens": prompt.cuda()}, cfg_m,
                                 20)
            reset_counts()
            logits, _ = T.serve_step(params32, cache, {"tokens": tok.cuda()},
                                     16, cfg_m)
            torch.cuda.synchronize()
        return logits, masks, read_counts()["topk_gather"]

    got, masks, launches = run("auto", None)
    want, _, off = run("off", iter(masks))
    err = float((got - want).abs().max())
    tol = 1e-3
    print(f"[train] f32 decode step on the trained weights, kernel vs "
          f"formula, {len(masks)} k-WTA selections held: max_abs_err="
          f"{err:.3e} (max |logit| {float(want.abs().max()):.3f}) tol="
          f"{tol:.0e}; topk_gather launches {launches} (formula run {off})")
    if launches != cfg.n_layers or off:
        fail(f"train: the decode step launched topk_gather {launches} "
             f"times (formula run {off})")
    if not (bool(torch.isfinite(got).all()) and err <= tol):
        fail("train: kernel and formula disagree on the trained weights")


def resume_window():
    """(c) in a fresh process under ``torch.use_deterministic_algorithms``
    (``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts): 10 straight
    steps against 5, a restart and 5 more, on the reference test's
    reduced config; written as JSON to build/train_resume.json."""
    import shutil
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_for
    from repro_torch.launch.train import Trainer
    from repro_torch.tree import flatten
    torch.use_deterministic_algorithms(True)
    cfg = get_config("smollm-360m").reduced(**RESUME_CUT)
    shape = ShapeConfig("t", 32, 4, "train")
    root = ROOT / "build" / "train_resume"
    shutil.rmtree(root, ignore_errors=True)

    def trainer(name):
        tcfg = TrainConfig(lr=1e-3, total_steps=10, checkpoint_every=5,
                           log_every=100, ckpt_dir=str(root / name))
        return Trainer(cfg, tcfg, (1, 1), shape, device="cuda")

    def batch_fn(step):
        return batch_for(cfg, shape, step, seed=0)

    t1 = trainer("a")
    t1.run(10, batch_fn, log=lambda *a: None)
    t2 = trainer("b")
    t2.run(5, batch_fn, log=lambda *a: None)
    t3 = trainer("b")
    resumed = t3.try_resume() and t3.step == 5
    t3.run(10, batch_fn, log=lambda *a: None)
    a = [t for _, t in flatten(t1.params) if t.is_floating_point()]
    b = [t for _, t in flatten(t3.params) if t.is_floating_point()]
    diffs = [float((x - y).abs().max()) for x, y in zip(a, b)]
    (ROOT / "build" / "train_resume.json").write_text(json.dumps({
        "resumed": resumed, "leaves": len(a), "max_abs_diff": max(diffs),
        "equal": sum(d == 0 for d in diffs), "steps": [t1.step, t3.step],
        "device": str(a[0].device)}))
    shutil.rmtree(root, ignore_errors=True)


def train_resume():
    path = ROOT / "build" / "train_resume.json"
    path.unlink(missing_ok=True)
    t = time.perf_counter()
    run_fresh("resume_window()", env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    r = json.loads(path.read_text())
    tol = 1e-5
    print(f"[train] resume determinism (reduced smollm, a fresh process "
          f"under use_deterministic_algorithms, {time.perf_counter() - t:.1f}"
          f" s): 10 straight steps vs 5 + restart + 5 on {r['device']}: "
          f"resumed at step 5 {r['resumed']}, max_abs_diff "
          f"{r['max_abs_diff']:.3e} over {r['leaves']} float leaves "
          f"({r['equal']} bit-equal) tol={tol:.0e}")
    if not (r["resumed"] and r["steps"] == [10, 10]
            and r["max_abs_diff"] <= tol and r["device"].startswith("cuda")):
        fail("train: resume is not deterministic")


@contextlib.contextmanager
def kwta_zeros():
    """The share of zeros in every k-WTA output of the GSC CNN made inside
    (conv-1, conv-2, linear), in call order."""
    gsc = importlib.import_module("repro_torch.models.gsc_cnn")
    orig, seen = (gsc.kwta_channel, gsc.kwta), []

    def spy(fn):
        def wrapped(*args):
            y = fn(*args)
            seen.append(float((y == 0).float().mean()))
            return y
        return wrapped

    gsc.kwta_channel, gsc.kwta = spy(orig[0]), spy(orig[1])
    try:
        yield seen
    finally:
        gsc.kwta_channel, gsc.kwta = orig


def gsc_batch_on(seed, step, device):
    from repro_torch.data import canonical, gsc_batch
    return {k: torch.from_numpy(canonical(v)).to(device)
            for k, v in gsc_batch(seed, step, GSC_BATCH).items()}


def gsc_train(variant):
    """(d) one variant at the paper's size: GSC_STEPS steps of AdamW (lr
    2e-3, wd 0.01) at batch 32, then held-out accuracy and sparsity."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import gsc_cnn as G
    from repro_torch.optim import AdamWConfig, apply_updates, init_state
    from repro_torch.tree import leaves
    cfg = G.GSCConfig(variant=variant)
    params = G.init_model(cfg, seed=SEED, device="cuda")
    acfg = AdamWConfig(lr=2e-3, weight_decay=0.01)
    opt = init_state(params, acfg)
    losses, ms = [], []
    for s in range(GSC_STEPS):
        batch = gsc_batch_on(SEED, s, "cuda")
        t = time.perf_counter()
        (loss, _), grads = value_and_grad(
            lambda p: G.loss_fn(p, batch, cfg), params)
        apply_updates(params, grads, opt, acfg)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t) * 1e3)
    with torch.no_grad(), kwta_zeros() as zeros:
        acc = [float(G.loss_fn(params, gsc_batch_on(SEED + 1, s, "cuda"),
                               cfg)[1]["accuracy"])
               for s in range(GSC_HELD_OUT)]
    nbytes = sum(t.numel() * t.element_size()
                 for t in leaves(params) if t.is_floating_point())
    stages = (np.mean(np.reshape(zeros, (GSC_HELD_OUT, -1)), axis=0)
              if zeros else [])
    print(f"[train] gsc {variant}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"in {GSC_STEPS} steps; held-out accuracy {np.mean(acc):.4f} on "
          f"{GSC_HELD_OUT} x {GSC_BATCH}; step median "
          f"{np.median(ms[5:]):.3f} ms (host clock, loss read back); "
          f"{nbytes} float bytes"
          + (f"; k-WTA zeros conv-1 {stages[0]:.4f}, conv-2 {stages[1]:.4f},"
             f" linear {stages[2]:.4f}" if len(stages) else ""))
    if not (np.isfinite(losses).all() and losses[-1] < 0.7 * losses[0]):
        fail(f"gsc {variant}: loss {losses[0]} -> {losses[-1]}")
    if cfg.activation_sparse and not (len(stages) == 3
                                      and min(stages) > 0.85):
        fail(f"gsc {variant}: realized sparsity {stages}")
    return nbytes


def gsc_parity(variant):
    """(d) one f32 forward and backward on the card against the port on
    the CPU, on the same weights and batch."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import gsc_cnn as G
    from repro_torch.tree import leaves, map_tree
    cfg = G.GSCConfig(variant=variant)
    cpu = G.init_model(cfg, seed=SEED, device="cpu")
    out = {}
    for name, params in (("cpu", cpu),
                         ("card", map_tree(lambda t: t.cuda(), cpu))):
        batch = gsc_batch_on(SEED, 0, leaves(params)[0].device)
        (loss, _), grads = value_and_grad(
            lambda p: G.loss_fn(p, batch, cfg), params)
        out[name] = float(loss), [None if g is None else g.cpu()
                                  for g in grads]
    dl = abs(out["cpu"][0] - out["card"][0])
    worst = max((float((a - b).abs().max()) / (1 + float(b.abs().max())))
                for a, b in zip(out["card"][1], out["cpu"][1])
                if b is not None)
    print(f"[train] gsc {variant} f32 forward+backward, card vs CPU: loss "
          f"{out['card'][0]:.6f}, |diff| {dl:.3e} (tol 1e-05); grads max "
          f"|diff|/(1+max|g|) {worst:.3e} (tol 1e-04)")
    if not (dl <= 1e-5 and worst <= 1e-4):
        fail(f"gsc {variant}: the card and the CPU disagree")


def phase_train():
    """Phase 11."""
    trainer, host_ms = train_lm()
    train_profile(host_ms)
    serve_trained(trainer)
    del trainer
    torch.cuda.empty_cache()
    train_resume()
    nbytes = {v: gsc_train(v) for v in GSC_VARIANTS}
    ratio = nbytes["dense"] / nbytes["sparse_sparse"]
    print(f"[train] gsc parameter compression dense / sparse-sparse: "
          f"{ratio:.2f}x (float bytes)")
    if not ratio > 8:
        fail("gsc: parameter compression is not above 8x")
    for v in GSC_VARIANTS:
        gsc_parity(v)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import build_all
    smi = device_line()
    print(f"[device] {smi}; {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    builds = build_all(["topk_gather", "packed_matmul", "grouped_cs_matmul",
                        "kwta_hist", "oob_gather", "missing_init",
                        "fixtures"])
    print(f"[build] {len(builds)} libraries in "
          f"{time.perf_counter() - t0:.2f} s, in parallel")
    for name, result in builds.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                           result.log)]
        smem = [int(b) for b in re.findall(r"(\d+) bytes smem", result.log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                                result.log))
        print(f"[build] {name}: nvcc {result.seconds:.2f} s; ptxas: "
              f"{len(regs)} kernels, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers, up to "
              f"{max(smem, default=0)} B shared memory, {spills} B spilled")
        # ptxas -v: "Function properties for <mangled name>" and its spills
        for fn, spilled in re.findall(r"Function properties for (\S+)\s+\d+ "
                                      r"bytes stack frame, (\d+) bytes spill "
                                      r"stores", result.log):
            if int(spilled):
                print(f"[build]   {spilled} B spilled by ...{fn[-48:]}")

    cfg = get_config("smollm-360m")
    t = time.perf_counter()
    row = phase_kernels()
    print(f"[kernels] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    row["launches"], steps, engine = phase_serve()
    row["launches_per_decode_step"] = row["launches"] / steps
    print(f"[serve] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_parity()
    print(f"[parity] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    rows = phase_ops(cfg)
    print(f"[ops] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    row["launches_paged"], steps = phase_paged(engine)
    row["launches_per_decode_step_paged"] = row["launches_paged"] / steps
    print(f"[paged] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    rows += phase_analysis(engine)
    print(f"[analysis] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_telemetry(engine)
    print(f"[telemetry] done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    row.update(phase_moe(engine))
    print(f"[moe] done in {time.perf_counter() - t:.1f} s")
    del engine
    torch.cuda.empty_cache()
    t = time.perf_counter()
    phase_train()
    print(f"[train] done in {time.perf_counter() - t:.1f} s")

    print(json.dumps({"kernels": [row] + rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

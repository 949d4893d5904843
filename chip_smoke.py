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
   width, cut to ``SMOLLM_LAYERS`` (4) of its 32 layers, as phases 5-10
   and 16 run it (bf16, 4 slots, 8 requests, prompt 16, gen 16, the
   engine's random weights from seed 0); the kernel launch counts show the decode
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
7. paged — the paged KV cache (``Engine(kv_layout="paged")``) on phase
   4's smollm-360m config: in float32, a 40-token prompt
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
   the linter reads; ``lint_config`` of phase 4's
   smollm-360m config on fake CUDA tensors (zero findings, one
   ``repro_torch::topk_gather`` node a layer in the decode graph); one
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
9. telemetry — ``repro_torch.obs`` on phase 4's smollm-360m config
   (bf16, 4 slots, phase 4's workload) with
   ``Telemetry.on(jsonl, sparsity_every=1)``, on the contiguous and the
   paged layout: the tokens equal a telemetry-off run's (a token may part
   only between the top two, by phase 7's rule); every FFN layer reports
   ``realized_k_frac`` in [K/d_ff, 1]; the dispatch summary holds one
   ``topk[cuda]`` site a layer with the shared memory of the launch;
   ``topk_gather`` runs once a layer a step; the JSONL passes
   ``validate_jsonl`` with every event kind.  Under ``torch.profiler``
   the decode step issues the same device activities with telemetry off
   and on but unprobed (the probed step's extra activities are printed).
   Then the latency and sparsity columns, the stage totals, and tok/s and
   the host-clock step with telemetry off and on, in turns off, on, on,
   off (the overhead row: no limit, no claim).
10. moe — the MoE + MLA family and the int8 KV cache: deepseek-v2-lite-16b
   at its shipped widths, ``MOE_LAYERS`` (4) of its 27 layers (d_model
   2048, MLA kv_lora 512, 64 routed experts top-6 + 2 shared), bf16, random weights from seed 0, serves
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
   which launches none of the kernels, as in the reference: (a)
   smollm-360m at its shipped widths, ``TRAIN_LAYERS`` (8) of its 32
   layers (float32 masters, bf16 compute) for
   20 steps of ``lm_batch`` at batch 8, seq 128 (every loss finite, the
   loss guard silent, the last five losses below the first; host-clock
   step, tokens/s, peak memory; the four kernels' launches in the steps,
   which must be 0), and one step's device activities under
   ``torch.profiler`` in a fresh process; (b) ``save_async`` at step 10
   while training goes on in place, restored into a fresh Trainer equal
   to a host copy taken at the save; serving params made from the
   step-20 weights (every ``packed_p`` equal to ``partition_major`` of
   its ``packed``) serve phase 4's workload through ``topk_gather`` (one
   launch a layer a decode step), and an f32 decode step through the kernel
   gives the formula's logits with the k-WTA selections held; (c) in a
   fresh process under ``torch.use_deterministic_algorithms``, 10
   straight steps against 5, a restart and 5 more on the reference
   test's reduced config (1e-5); (d) the GSC CNN at the paper's size in
   its three variants, 60 steps of AdamW at batch 32 each (last loss
   below 0.7 of the first), held-out accuracy, step time, the compression
   ratio and the realized k-WTA sparsity, and one f32 forward and
   backward of each variant against the port on the CPU; (e) after (c)
   in its process, (a)'s step with
   the shipped ``remat=True`` (each block's activations
   recomputed in the backward) beside ``remat=False``: one loss and
   backward from the same weights and batch, every gradient bit-equal,
   then each one's peak memory and host-clock step.
12. hybrid — the SSM/hybrid family and the modality frontends, full width
   and depth, random weights from seed 0: (a) zamba2-1.2b (2 units of 18
   Mamba2 blocks + the weight-shared attention block, whose FFN is the
   paper's at n=4, k_frac=0.125) in bf16 through ``Engine.
   generate_static`` (its serving path: the pattern has no fused
   prefill), 4 prompts of 16 tokens and 16 new ones: tok/s, the
   host-clock step, ``topk_gather`` launched exactly twice a step (the
   shared block's two invocations at 4 rows, B·K = 4096 < 8192), the
   step on the device alone (CUDA graph) and its device activities; its
   tokens against the formula engine's (a row may part only between the
   formula's top two, closer than twice the logit difference of the two
   paths on equal inputs, phase 7's rule); (b) in float32, 16 steps of 4
   rows through the kernel and the formula with every k-WTA selection
   held: logits within 1e-3; (c) xlstm-350m in float32, the chunked
   forward over 256 positions (two SSD chunks) against 256 decode steps
   (1e-3); (d) musicgen-large, a prefill from ``embeds`` (no launch) and
   3 decode steps from ``embeds`` (48 launches a step); (e) internvl2-2b,
   a prefill with 256 ``patch_embeds`` before 16 tokens (no launch) and 3
   decode steps (24 a step); (f) ``topk_gather`` at zamba2's shape (B=4,
   K=1024, P=2048, G=512, N=4), bf16 and f32, against its plain version,
   then its times beside one library call and its bound (row 1's
   ``hybrid_shape``).  Phase 8 also lints zamba2-1.2b's decode step at
   full width on fake CUDA tensors.
13. mesh — training on a mesh (``repro_torch.launch.mesh``,
   ``repro_torch.sharding``, ZeRO-1, the int8 sync, GPipe), which
   launches none of the kernels: smollm-360m at its shipped widths and
   depth (32 layers, remat on as shipped), in float32 (masters and
   compute), batch 8 x 128, ZeRO-1 on, the reference
   comparison's ``TrainConfig(lr=1e-3)`` (a 100-step warmup), under
   ``use_deterministic_algorithms``; every part in fresh processes
   (``spawn``).  (b) four gloo ranks sharing the card on mesh 2x2 (data x
   model), each step computing on the rank's param blocks (no param
   gathered): 5 steps through ``Trainer.run`` (every rank the same loss;
   each rank's param and moment bytes equal to the reference's per-device
   shards reckoned from the rule table on its stacked layout; the
   host-clock step; the gradient mean of the blocks alone; peak memory
   over the steps and the checkpoint, and in a step alone, printed; no
   param block handed to a collective), the run's step-5 checkpoint, the
   uninterrupted step 6 (its collectives by kind and bytes; the k-WTA
   selections of all 6 steps kept, the forward's and remat's
   recompute's), one loss and backward on the blocks against one on the
   params gathered whole (peaks, 0.5 GiB apart at least; losses 1e-5
   relative, selections held), and the checkpoint restored
   onto 4x1 (params and moments gathered whole bit-equal to the
   checkpoint's) for one more step; (c) on the same
   ranks, ``make_compressed_grad_sync`` on mesh 2x2 (pod x data) over a
   gradient tree of smollm's shapes (within an int8 step of the exact pod
   mean, the residual input - sent bit for bit) and ``pipeline_apply`` of
   4 full-width decoder blocks on mesh 4 (pipe), n_micro 4, against the
   blocks in sequence on each microbatch (1e-5), and which collectives
   gloo runs on CUDA tensors; (d) on the same ranks, deepseek-v2-lite-16b
   at its shipped widths, 1 of its 27 MoE layers, f32: one loss of each
   rank's rows on its blocks under the training rules of mesh 2x2 and its
   backward, with remat and without, every gradient leaf bit-equal (the
   card runs the backward, and remat's recompute, on autograd's device
   thread, which must still sum the MoE load-balancing loss over the DP
   group), and every rank's DP-mean gradient blocks within
   1e-4·(1+max|g|) of one device's, its k-WTA sets and router choices
   held; (e) the same gradient check for zamba2-1.2b at its shipped
   widths, one unit (18 Mamba2 blocks and the shared attention); (a) in
   a fresh process, the single-device
   Trainer and the Trainer on mesh 1x1 over NCCL at world size 1 (1e-6:
   bit-equal expected), (b)'s losses (1e-5 relative) and step-5 params
   (1e-5, which must lie below the smallest move of a leaf in step 5's
   update: a skipped update would part by that much) against (a)'s, and
   (b)'s checkpoint restored onto 1x1 (bit-equal to the checkpoint) for
   one more step, whose params hold to the same 1e-5.  (a) and the restores hold (b)'s k-WTA selections: the
   partitionings differ in f32 order, and a bisect threshold within an
   ulp of a unit flips it.  ``[mesh]`` lines and a ``[mesh] numbers
   {...}`` JSON line.
14. mesh-serve — ``Engine(mesh=...)``: smollm-360m at full width, random
   weights from seed 0, max_seq 48 (the contiguous cache's rows shard:
   12 a rank on 1x4, 24 on 2x2), on four gloo ranks sharing the card
   (a fresh process each), on meshes 1x4 and 2x2 (data x model), both
   layouts, against the single-device engine on the card: (a) in
   float32, four prompts prefilled and 4 decode steps fed the same tokens
   holding the single-device engine's k-WTA selections, logits within
   1e-3; (b) in bf16 phase 4's workload (1x4 contiguous, 2x2 both
   layouts; the pools replicate on both): tokens equal on every rank and
   equal to the single-device engine's but where they part between its
   top two, closer than twice the bf16 forced-logits difference (phase
   7's rule); (c) one ``topk_gather`` launch a layer a decode step on every
   rank, none in a prefill; (d) each rank's param and cache bytes equal
   to its block reckoned from the specs (``shard_shape``), beside the
   single device's; (e) no tensor handed to a collective is (or views) a
   param or cache block, and the largest a decode step moves is the (4,
   vocab) logits: the count and bytes of a step's collectives; (f) mesh
   1x1 over NCCL at world size 1 in a process of its own: tokens and
   forced logits bit-equal to the engine without a mesh.  Then each
   mesh's tok/s and host-clock decode step beside the single device's
   (no limit, no claim).  ``[mesh-serve]`` lines and a ``[mesh-serve]
   numbers {...}`` JSON line.
15. mesh-moe — ``Engine(mesh=...)`` on the MoE + MLA family:
   deepseek-v2-lite-16b at its shipped widths (MLA's 16 heads, 64 routed
   experts top-6 + 2 shared), 2 of 27 layers in float32 and in bf16
   (to keep the script within its time limit), random weights from seed
   0, max_seq 48, on
   four gloo ranks sharing the card (one torch thread each), meshes 1x4
   and 2x2, both layouts, against the single-device engine on the card.
   Each rank draws only its blocks, a layer at a time (four whole f32
   trees would not fit the card): (a) in float32, four prompts prefilled
   and 4 decode steps fed the same tokens, holding the single-device
   engine's k-WTA selections (the rank's slots and experts of each) and
   router choices, logits within 1e-3; then its blocks cast to bf16:
   (b) phase 4's workload on both layouts, tokens equal on every rank
   and equal to the single-device engine's but where they part between
   its top two (on its own path), closer than twice the bf16
   forced-logits difference; (c) each rank's param and cache bytes equal
   to its blocks reckoned from the specs (``shard_shape``); (d) one
   ``topk_gather`` launch a layer a decode step on every rank (the shared
   experts' down projection), none in a prefill; (e) no tensor handed to
   a collective is a param or cache block, the largest a decode step
   moves is the (4, vocab) logits; (f) tok/s and the host-clock decode
   step beside the single device's (no limit, no claim).  Then
   ``topk_gather`` at the ranks' decode shapes (B=2 and 4, K=352, P=704,
   G=512, N=4) against its plain version, and B=2's times (row 1's
   ``mesh_moe_shape``).  ``[mesh-moe]`` lines and a ``[mesh-moe] numbers
   {...}`` JSON line.
16. roofline — the port's census and roofline (``repro_torch.launch.hlo``,
   ``roofline``, ``dryrun``): (a) the census of phase 4's bf16 decode step
   (4 slots, every slot at position 16) run on the card: one
   ``topk_gather`` node a layer and as many launches, no host transfer, no
   collective, and the same FLOPs and bytes as a trace of the step on
   fake CUDA tensors; (b) its bound (``cell_roofline``: bf16 products on
   the tensor cores, the rest outside them, against HBM) and the bound's
   share of phase 4's step on the device alone and on the host clock,
   each in (0, 1.05] (more means the count is wrong); (c) rows 1-4's
   bounds from their modules' cost formulas (shapes and types alone)
   beside the kernels line's, never below them; (d) the dry run of
   smollm-360m, deepseek-v2-lite-16b and qwen3-moe-235b-a22b decode_32k
   and zamba2-1.2b long_500k (batch 1 under the ``decode_long`` rules: the
   shared attention's 524,288 cache rows over all 256 ranks) on 16x16 on
   fake CUDA tensors (rank 0 of a fake process group of 256): each rank's
   params and cache bytes, peak and bound.  ``[roofline]`` lines and a
   ``[roofline] numbers {...}`` JSON line.
17. mesh-ssm — ``Engine(mesh=...)`` on the SSM/hybrid patterns through
   ``generate_static`` (their serving path): zamba2-1.2b as shipped
   (each Mamba2 block on the rank's blocks of ``in_proj``'s columns, the
   conv's channels and the heads, the shared attention block as an
   attention block, its sparse FFN through ``topk_gather``) and
   xlstm-350m, random weights from seed 0, max_seq 20 (the shared
   attention's cache rows shard), on four gloo ranks sharing the card
   (one torch thread each), meshes 1x4 and 2x2, each rank drawing only
   its blocks, against the single device on the card: (a) in float32,
   19 of zamba2's 38 blocks (one unit), 4 prompts of 8 tokens stepped
   through and 3 forced steps holding the single device's k-WTA
   selections, logits within 1e-3, and ``topk_gather`` at the rank's
   decode shape against its plain version; (b) zamba2 in bf16 at full
   depth, ``generate_static`` of 4 prompts of 8 tokens and 8 new ones:
   tokens equal on every rank, their logits on equal inputs (every
   step before a row parts) within a fixed limit of the single device's
   (``MESH_SSM_GAP``), and the tokens equal to the single device's but
   where the single run's logit of the mesh's token lies within that
   limit of its largest (phase 15's tie rule); (c) 2
   ``topk_gather`` launches a step on every rank, and none by zamba2
   reduced on the CPU (the plain version); (d) each rank's param and
   cache bytes equal to its blocks reckoned from the specs; (e) a step's
   collectives, their bytes and the largest, none handed a param or
   cache block; (f) tok/s and the host-clock step beside the single
   device's (no limit, no claim); (g) xlstm-350m in bf16, 4 prompts of 4
   tokens and 4 new ones, (b)-(f) for it (no kernel: d_ff 0); (h) mesh
   1x1 over NCCL at world size 1 in a process of its own: zamba2's
   tokens and every step's logits bit-equal to the engine without a
   mesh.  ``[mesh-ssm]`` lines and a ``[mesh-ssm] numbers {...}`` JSON
   line.
18. examples — ``examples/*_torch.py`` through each one's ``main`` in this
   process on the card: quickstart (both max errors within 1e-4, the
   FLOPs and the packing dict the reference prints, the MLP's step-100
   loss below its step-0 loss); serve_lm on smollm-360m and
   deepseek-v2-lite-16b reduced, the counts at 0 just before each (every
   request served, one prefill a request, one ``topk_gather`` launch a
   topk layer a decode step as ``topk_ffn_layers`` counts them from the
   config, none in a prefill, the first launch at each operand shape held
   against the plain version on its own operands, every routed experts'
   k-WTA row keeping a count within bisect's bounds from its K-th largest
   value, each FFN layer's realized k/N in [K/d_ff, 1] and the routed
   experts' in [0, the most a row kept / d_ff]; tok/s and TTFT p50/p95,
   no limit); train_gsc's three variants at the example's 300 steps of
   batch 64 (the last loss below 0.7 of the first; held-out accuracy and
   seconds).  Then each as ``python examples/<name>_torch.py``
   in a fresh process (quickstart as shipped, serve_lm ``--requests 2
   --gen 6``, the others ``--steps 5``), all four together, each exiting
   0, and meanwhile sparse_sparse_lm's ``main`` here at its 60 steps (both
   losses finite, the census's FLOP ratio; it prints no time).
19. mesh-cuts — the meshes whose blocks cut what the reference's
   divisibility fallback cuts, on four gloo ranks sharing the card (after
   single-device references on the card): (a) smollm-360m at its shipped
   widths, ``MESH_CUTS_LAYERS`` (2) layers, with ``route_share`` 128 (640
   groups, 5 route tables, 160 groups a rank on 1x4: ranks 1 and 2 start
   inside a table and read their ``block_route``): f32 prefills and 3
   forced decode steps holding the single device's k-WTA selections
   (1e-3), one loss and backward on the blocks against the single
   device's (loss 1e-5 relative, gradients 1e-4·(1+max|g|)), bf16 tokens
   of phase 4's workload against the single device's but at ties (phase
   14's top-two rule), one ``topk_gather`` launch a layer a decode step on
   every rank and none in the prefills; (b) deepseek-v2-lite-16b at its
   shipped widths, 2 of 27 layers, f32, on 2x2 under the ``decode_long``
   rules: a row stepped through a prompt with the k-WTA selections and
   router choices held, every step's logits within 1e-3 of the single
   device's, the latent rows split over ``data`` and ``model`` (each
   rank's block reckoned and printed), one ``topk_gather`` launch a layer
   a step; (c) deepseek ``reduced(n_heads=2)`` (MLA heads cut) and
   qwen3-moe ``reduced(n_experts=2, experts_per_token=1)`` (each expert's
   groups cut) on 1x4 in f32: serving logits (prefills and forced steps,
   selections and router choices held) and one loss and backward against
   the single device's.

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
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0

sys.path.insert(0, str(ROOT / "src"))
# H100 SXM published peaks (NVIDIA data sheet), one copy for the card: the
# roofline module's HBM3 rate, float32 rate outside the tensor cores and
# dense bf16 tensor-core rate.
from repro_torch.launch.roofline import (F32_FLOPS,  # noqa: E402
                                         HBM_BW as HBM_BYTES_PER_S,
                                         PEAK_FLOPS as BF16_FLOPS)

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
# Phases 4-10 and 16 run smollm-360m at its shipped widths, cut to this
# many of its 32 layers (every layer is the same block).  A step's host
# dispatch grows with the depth, and the whole depth kept the script near
# its time limit (8 layers until the examples' phase 18 came).
SMOLLM_LAYERS = 4


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
    (G=200 at N=4: 100 vectors of 16 B, the last strip 4 of 32), the
    reduced configs' decode down projection that phase 18's serve_lm runs
    (B <= 4, K=k_for(128)=16, P=32, G=16, N=4, one route) in bf16, and the
    reference's sweep (kernels/registry.py) in f32 with all groups sharing
    one route."""
    from repro_torch.kernels.registry import TOPK_GATHER_SWEEP
    bf16 = torch.bfloat16
    return ([(dict(MAIN_SHAPE, b=b), bf16) for b in (4, 1, 2, 3, 7)]
            + [(dict(b=b, k=16, p=32, g=16, n=4, r=16), bf16)
               for b in (1, 2, 3, 4)]
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


#: phase 4's decode step: its host-clock and device-alone times (ms), for
#: phase 16's shares of its bound
SERVE_STEP_MS = {}


def smollm_config(n_layers=SMOLLM_LAYERS):
    """smollm-360m at its shipped widths, SMOLLM_LAYERS deep: the model
    of phases 4-10 and 16 (phase 11's is TRAIN_LAYERS deep)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("smollm-360m"), n_layers=n_layers)


def phase_serve():
    from repro_torch.launch.serve import Engine
    from repro_torch.runtime.scheduler import Request
    cfg = smollm_config()
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
    print(f"[serve] smollm-360m full width bf16, {cfg.n_layers} of 32 "
          f"layers: {n_req} requests, "
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
    SERVE_STEP_MS.update(host=step_ms, device=dev_ms)
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


def decode_args(engine):
    """The params, a fresh cache, tokens, positions and page tables of one
    decode step of every slot at position 16; on a paged engine the page
    tables give each slot its own pages, else they are None."""
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
    return (engine.params, cache, batch, torch.full((n,), 16, device="cuda"),
            pages)


def _decode_step(engine):
    """One decode step of every slot at position 16, as a callable."""
    from repro_torch.models import transformer as T
    params, cache, batch, pos, pages = decode_args(engine)
    return lambda: T.serve_step(params, cache, batch, pos, engine.cfg,
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
    """Phase 4's smollm-360m in float32 with random weights from SEED (the
    parity phases' model)."""
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(smollm_config(), compute_dtype="float32")
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
    # of their sums, which the layers carry into the logits
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
def kwta_selections(held=None, rows=None, experts=None):
    """Record the kept set of every bisect k-WTA call made inside, in call
    order, as boolean masks; with ``held`` (an iterator of masks, one a
    call) keep those sets instead of selecting (``rows`` of a held mask
    whose batch is larger than the call's: a rank's block of slots;
    ``experts`` = (lo, hi) of a routed experts' mask (G, E, C, F) whose
    experts are more than the call's: a rank's block of experts).  The
    serving FFN selects with ``repro_torch.core.layers.kwta_bisect``."""
    layers = importlib.import_module("repro_torch.core.layers")
    select, masks = layers.kwta_bisect, []

    def spy(x, k):
        if held is not None:
            keep = next(held)
            if rows is not None and keep.shape[0] != x.shape[0]:
                keep = keep[rows]
            if experts is not None and keep.ndim == 4 and \
                    keep.shape[1] != x.shape[1]:
                keep = keep[:, experts[0]:experts[1]]
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
    report = lint_config(smollm_config(), device="cuda")
    print(f"[analysis] lint_config('smollm-360m') full width, "
          f"{SMOLLM_LAYERS} layers, on fake CUDA tensors in "
          f"{time.perf_counter() - t:.1f} s: "
          + report.render().splitlines()[0])
    if not report.ok:
        print(report.render())
        fail("lint_config('smollm-360m') found faults")
    t = time.perf_counter()
    report = lint_config(HYBRID_ARCH, entries=("decode",), device="cuda")
    print(f"[analysis] lint_config({HYBRID_ARCH!r}) decode, full width on "
          f"fake CUDA tensors in {time.perf_counter() - t:.1f} s: "
          + report.render().splitlines()[0])
    if not report.ok or report.entries != ["decode"]:
        print(report.render())
        fail(f"lint_config({HYBRID_ARCH!r}) decode found faults")
    cfg = resolve_config(smollm_config())
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
    call whose range last began before the host call that issued it (the
    CUDA API event of the same correlation id; without one, before the
    activity started).  A call's records are then told apart
    by the host clock alone.  A pad call at each end of the window takes
    what the window's edges may lose."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.launch.serve import Engine
    eng = Engine(smollm_config(), max_seq=33, n_slots=4,
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
    # each device activity at the host time of the CUDA API call that
    # issued it (the same correlation id): the device's clock in the trace
    # may be offset from the host's by more than the spin's 0.5 ms
    issued = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat", "").startswith("cuda_")
              and "correlation" in e.get("args", {})}
    calls = [collections.Counter() for _ in order]
    for e in events:
        if (e.get("cat") not in DEVICE_CATS
                or "spin_kernel" in e["name"]):
            continue
        ts = issued.get(e.get("args", {}).get("correlation"), e["ts"])
        i = bisect.bisect_right(starts, ts) - 1
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
    (``activity_window``), the two at once: they count activities and
    time nothing."""
    layouts = ("contiguous", "paged")
    for layout in layouts:
        (ROOT / "build" / f"activities_{layout}.json").unlink(missing_ok=True)
    t = time.perf_counter()
    run_fresh(*(f"activity_window({layout!r})" for layout in layouts))
    took = time.perf_counter() - t
    for layout in layouts:
        path = ROOT / "build" / f"activities_{layout}.json"
        windows = {v: [collections.Counter(c) for c in calls]
                   for v, calls in json.loads(path.read_text()).items()}
        per_call = {v: [sum(c.values()) for c in w]
                    for v, w in windows.items()}
        print(f"[telemetry] {layout} decode step under torch.profiler, "
              f"activities a call: {json.dumps(per_call)} (the two "
              f"windows' processes, run together, took {took:.1f} s)")
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
# Its depth in this phase: 4 of its 27 layers (each the same MLA and MoE
# block), as phase 15 serves it in bf16, to keep the script within its
# time limit (8 until the examples' phase 18 came).
MOE_LAYERS = 4


@contextlib.contextmanager
def router_choices(held=None, rows=None):
    """Record every MoE router's expert choice made inside, in call order;
    with ``held`` (an iterator of choices, one a call) route by those
    instead, each token's weights read from its own softmax at the held
    experts (``rows`` of a held choice whose groups are more than the
    call's: a rank's block of slots).  The MoE block routes with
    ``repro_torch.models.moe.router_top_k``."""
    moe = importlib.import_module("repro_torch.models.moe")
    route, choices = moe.router_top_k, []

    def spy(probs, k):
        if held is None:
            top_p, top_e = route(probs, k)
        else:
            top_e = next(held)
            if rows is not None and top_e.shape[0] != probs.shape[0]:
                top_e = top_e[rows]
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


def moe_kernel(shape=MOE_SHAPE, phase="moe"):
    """(c) ``topk_gather`` at the shared experts' decode shape against its
    plain version (bf16, and the support as the layer hands it over), then
    its times.  Returns the row-1 keys of that shape."""
    from repro_torch.kernels.topk_gather import topk_gather, topk_gather_plain
    vals, p_idx, s_off, packed_p, route, packed = kernel_operands(
        shape, torch.bfloat16, SEED + 60)
    err = 0.0
    for label, operands in (
            ("", (vals, p_idx, s_off, packed_p, route)),
            (", bf16 values, int64 indices",
             (vals.to(torch.bfloat16), p_idx.long(), s_off.long(), packed_p,
              route))):
        err = max(err, check(f"topk_gather {shape} bf16{label}",
                             topk_gather(*operands),
                             topk_gather_plain(*operands), phase=phase))
    times = topk_times(shape, vals, p_idx, s_off, packed_p, route,
                       packed, phase)
    return {"shape": shape, "max_abs_err": err, **times}


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
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    t = time.perf_counter()
    params = T.init_model(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[moe] {MOE_ARCH} at its shipped widths, {cfg.n_layers} of "
          f"{get_config(MOE_ARCH).n_layers} layers, d_model "
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
# its depth: 8 of smollm-360m's 32 layers, deeper than SMOLLM_LAYERS: (e)
# requires remat to lower a step's peak, and at 4 layers the activations
# it drops no longer outweigh what it adds (2.791 against 2.788 GiB)
TRAIN_LAYERS = 8
# (c): the reference test's reduced config (tests/test_train_loop.py:20-23)
RESUME_CUT = dict(d_model=64, d_ff=128, vocab_size=128, n_heads=4,
                  n_kv_heads=2, head_pad=0, n_layers=2)
# (d): the reference's GSC run (tests/test_gsc_e2e.py:17-40)
GSC_VARIANTS = ("dense", "sparse_dense", "sparse_sparse")
GSC_BATCH, GSC_STEPS, GSC_HELD_OUT = 32, 60, 5


def run_fresh(*calls: str, env=None, timeout: int = 600):
    """Each ``chip_smoke.<call>`` in a process of its own (a profiler
    window, or a determinism mode that must be set before CUDA starts),
    all started together; raises if one fails or outlasts ``timeout``
    seconds, and leaves none running."""
    import os
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path[:0] = "
         f"[{str(ROOT / 'src')!r}, {str(ROOT)!r}]; import chip_smoke; "
         f"chip_smoke.{call}"], env=dict(os.environ, **(env or {})))
        for call in calls]
    try:
        codes = [proc.wait(timeout=timeout) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if any(codes):
        fail(f"fresh processes {list(calls)} exited with {codes}")


def lm_train_setup(device="cuda"):
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import ShapeConfig
    cfg = smollm_config(TRAIN_LAYERS)
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
    """(a) the port's ``Trainer`` on phase 4's smollm-360m;
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
    print(f"[train] smollm-360m at its shipped widths, {cfg.n_layers} of "
          f"32 layers, d_model "
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


def deterministic_windows():
    """(c) and (e), one after the other in one fresh process."""
    resume_window()
    remat_window()


def train_deterministic():
    """Runs (c) and (e) in a fresh process under
    ``torch.use_deterministic_algorithms``; returns its seconds."""
    for name in ("train_resume.json", "train_remat.json"):
        (ROOT / "build" / name).unlink(missing_ok=True)
    t = time.perf_counter()
    run_fresh("deterministic_windows()",
              env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    return time.perf_counter() - t


def train_resume(took):
    r = json.loads((ROOT / "build" / "train_resume.json").read_text())
    tol = 1e-5
    print(f"[train] resume determinism (reduced smollm, in (c) and (e)'s "
          f"fresh process under use_deterministic_algorithms, {took:.1f}"
          f" s): 10 straight steps vs 5 + restart + 5 on {r['device']}: "
          f"resumed at step 5 {r['resumed']}, max_abs_diff "
          f"{r['max_abs_diff']:.3e} over {r['leaves']} float leaves "
          f"({r['equal']} bit-equal) tol={tol:.0e}")
    if not (r["resumed"] and r["steps"] == [10, 10]
            and r["max_abs_diff"] <= tol and r["device"].startswith("cuda")):
        fail("train: resume is not deterministic")


def remat_window():
    """(e) in a fresh process under ``torch.use_deterministic_algorithms``
    (``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts): the full-width
    smollm-360m loss and backward with ``remat`` off and on from the same
    weights and batch (every gradient compared), then each one's training
    step (peak memory over a step, host-clock step of three after two
    warm-ups); written as JSON to build/train_remat.json."""
    from repro_torch.data import canonical, lm_batch
    from repro_torch.launch import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.optim import init_state
    torch.use_deterministic_algorithms(True)
    cfg, _, tcfg = lm_train_setup()
    batch = {k: torch.from_numpy(canonical(v)).cuda() for k, v in
             lm_batch(SEED, 0, TRAIN_BATCH, TRAIN_SEQ,
                      cfg.vocab_size).items()}
    params = T.init_train_params(cfg, seed=SEED, device="cuda")
    (l0, g0), (l1, g1) = (
        St.value_and_grad(lambda p, c=dataclasses.replace(cfg, remat=r):
                          T.loss_fn(p, batch, c), params)
        for r in (False, True))
    pairs = [(a, b) for a, b in zip(g0, g1) if a is not None]
    out = {"remat_shipped": cfg.remat, "loss_equal": bool(torch.equal(
        l0[0], l1[0])), "leaves": len(pairs),
        "equal": sum(bool(torch.equal(a, b)) for a, b in pairs),
        "max_abs_diff": max(float((a - b).abs().max()) for a, b in pairs)}
    del params, g0, g1, pairs
    torch.cuda.empty_cache()
    for remat in (False, True):
        step, acfg = St.make_train_step(
            dataclasses.replace(cfg, remat=remat), tcfg)
        p = T.init_train_params(cfg, seed=SEED, device="cuda")
        opt = init_state(p, acfg)
        host = []
        for i in range(5):
            if i == 2:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            float(step(p, opt, batch)[2]["loss"])
            host.append((time.perf_counter() - t) * 1e3)
        out[str(remat)] = {"peak": torch.cuda.max_memory_allocated(),
                           "host_ms": host[2:]}
        del p, opt, step
        torch.cuda.empty_cache()
    (ROOT / "build" / "train_remat.json").write_text(json.dumps(out))


def train_remat(took):
    r = json.loads((ROOT / "build" / "train_remat.json").read_text())
    off, on = r["False"], r["True"]
    print(f"[train] remat (full-width smollm-360m, batch {TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ}, in (c) and (e)'s fresh process under "
          f"use_deterministic_algorithms, {took:.1f} s; "
          f"shipped remat={r['remat_shipped']}): one loss and backward from "
          f"the same weights, remat on vs off: loss bit-equal "
          f"{r['loss_equal']}, {r['equal']} of {r['leaves']} gradient leaves "
          f"bit-equal (max |diff| {r['max_abs_diff']:.3e}); a training step's "
          f"peak max_memory_allocated off {off['peak'] / 2**30:.3f} GiB, on "
          f"{on['peak'] / 2**30:.3f} GiB; host-clock step (median of 3) off "
          f"{np.median(off['host_ms']):.3f} ms, on "
          f"{np.median(on['host_ms']):.3f} ms (the recompute: no limit, no "
          f"claim); {device_line()}")
    if not (r["loss_equal"] and r["equal"] == r["leaves"]):
        fail("train: remat changes the loss or a gradient")
    if not on["peak"] < off["peak"]:
        fail("train: remat does not lower the step's peak memory")


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
    took = train_deterministic()
    train_resume(took)
    train_remat(took)
    nbytes = {v: gsc_train(v) for v in GSC_VARIANTS}
    ratio = nbytes["dense"] / nbytes["sparse_sparse"]
    print(f"[train] gsc parameter compression dense / sparse-sparse: "
          f"{ratio:.2f}x (float bytes)")
    if not ratio > 8:
        fail("gsc: parameter compression is not above 8x")
    for v in GSC_VARIANTS:
        gsc_parity(v)


# ---------------------------------------------------------------------------
# phase 12: the SSM/hybrid family and the modality frontends at full width
# ---------------------------------------------------------------------------

HYBRID_ARCH = "zamba2-1.2b"
# Its shared attention block's FFN down projection at decode with 4 slots
# (d_ff 8192 -> 2048, gelu): B=4, K=k_for(8192)=1024, P=2048, G=512, N=4,
# R=G.
HYBRID_SHAPE = dict(b=4, k=1024, p=2048, g=512, n=4, r=512)
HYBRID_PROMPT, HYBRID_GEN = 16, 16
# xlstm-350m's chunked forward against its decode steps: two SSD chunks.
XLSTM_POSITIONS = 256


@contextlib.contextmanager
def step_logits():
    """Record the logits of every ``serve_step`` made inside (the static
    engine's steps), in call order, as the engine got them."""
    T = importlib.import_module("repro_torch.models.transformer")
    step, rows = T.serve_step, []

    def spy(*args, **kw):
        logits, cache = step(*args, **kw)
        rows.append(logits)
        return logits, cache

    T.serve_step = spy
    try:
        yield rows
    finally:
        T.serve_step = step


def static_parity(toks_k, rows_k, toks_f, rows_f, label,
                  prompt=HYBRID_PROMPT, phase="hybrid", top_two=True,
                  bound=None):
    """The kernel engine's greedy tokens against the formula engine's
    (phase 7's rule): where a row parts, the formula's top two at that
    step are the two tokens, closer than the larger of TIE_MARGIN and
    twice the logit difference the two paths show on equal inputs in this
    run (steps up to each row's first parting), or than a fixed
    ``bound``.  Without ``top_two`` (phase 15's rule, a tie of three or
    more counted as one), the second run's logit of the first run's token
    lies within that bound of its largest.  ``rows_*``: the logits of
    each of the ``prompt`` + generated steps.  Returns (rows parted, that
    difference)."""
    first = {}
    for r in range(toks_k.shape[0]):
        diff = np.nonzero(toks_k[r] != toks_f[r])[0]
        first[r] = int(diff[0]) if diff.size else toks_k.shape[1] - 1
    free = max(float((rows_k[s][r].float() - rows_f[s][r].float())
                     .abs().max())
               for r, part in first.items()
               for s in range(prompt + part))
    margin = max(TIE_MARGIN, 2 * free) if bound is None else bound
    parted = 0
    for r, part in first.items():
        if toks_k[r, part] == toks_f[r, part]:
            continue
        row = rows_f[prompt - 1 + part][r].float()
        top = torch.topk(row, 2)
        best = set(top.indices.tolist())
        gap = float(top.values[0] - top.values[1])
        if not top_two:
            best = {int(toks_k[r, part]), int(top.indices[0])}
            gap = float(top.values[0] - row[int(toks_k[r, part])])
        what = "top two" if top_two else "largest and the first run's token"
        print(f"[{phase}] {label}: row {r} parts at token {part}; the "
              f"second run's {what} {sorted(best)}, margin {gap:.3e} (bound "
              f"{margin:.3e})")
        if best != {int(toks_k[r, part]), int(toks_f[r, part])} \
                or not gap < margin:
            fail(f"{label}: row {r} differs at token {part} beyond a tie "
                 "of the top two")
        parted += 1
    return parted, free


def hybrid_serve(cfg, params):
    """(a) zamba2-1.2b bf16 through ``Engine.generate_static`` (its
    serving path: no fused prefill), the counts set to 0 just before the
    timed run: tok/s, host-clock step, launches (2 a step: the shared
    block's two invocations), the step on the device alone and its device
    activities; then its tokens against the formula engine's.  Returns
    (launches, steps)."""
    from repro_torch.launch.serve import Engine
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (4, HYBRID_PROMPT))
    max_seq = HYBRID_PROMPT + HYBRID_GEN + 1
    eng = Engine(cfg, max_seq=max_seq, n_slots=4, params=params,
                 device="cuda")
    eng.generate_static(prompts[:, :2], 2)        # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    toks = eng.generate_static(prompts, HYBRID_GEN)
    wall = time.perf_counter() - t
    counts = read_counts()
    steps = HYBRID_PROMPT + HYBRID_GEN
    launches = counts["topk_gather"]
    per_step = cfg.n_units * cfg.block_pattern.count("shared_attn")
    step_ms = wall / steps * 1e3
    print(f"[hybrid] {HYBRID_ARCH} full width bf16, generate_static of 4 "
          f"prompts x {HYBRID_PROMPT} tokens + {HYBRID_GEN} new: {steps} "
          f"steps in {wall:.3f} s, {4 * HYBRID_GEN / wall:.2f} tok/s, step "
          f"{step_ms:.3f} ms (host clock, logits argmax on the card); kernel "
          f"launches {counts}")
    if toks.shape != (4, HYBRID_GEN) or not ((toks >= 0) &
                                             (toks < cfg.vocab_size)).all():
        fail(f"hybrid: generate_static returned {toks}")
    if launches != per_step * steps:
        fail(f"hybrid: topk_gather launched {launches} times, want "
             f"{per_step} x {steps} steps")
    dev_ms = step_device_ms(eng)
    print(f"[hybrid] one decode step on the device alone (CUDA graph "
          f"replay): {dev_ms:.3f} ms; device idle share of the eager step "
          f"{1 - dev_ms / step_ms:.3f}")
    acts = step_profile(eng)
    print(f"[hybrid] one eager decode step under torch.profiler: "
          f"{sum(c for c, _ in acts.values())} device activities, "
          f"{sum(t for _, t in acts.values()):.3f} ms busy; by time:")
    for name, (count, ms) in sorted(acts.items(),
                                    key=lambda kv: -kv[1][1])[:PROFILE_TOP]:
        print(f"[hybrid]   {ms:8.3f} ms {count:5d}x {name[:100]}")
    # the same run through the kernel and through the formula, logits kept
    off = Engine(cfg, max_seq=max_seq, n_slots=4, params=params,
                 use_pallas="off", device="cuda")
    with step_logits() as rows_k:
        toks_k = eng.generate_static(prompts, HYBRID_GEN)
    with step_logits() as rows_f:
        toks_f = off.generate_static(prompts, HYBRID_GEN)
    if not np.array_equal(toks_k, toks):
        fail("hybrid: two kernel runs of generate_static differ")
    parted, free = static_parity(toks_k, rows_k, toks_f, rows_f,
                                 "bf16 kernel vs formula")
    print(f"[hybrid] bf16 tokens, kernel vs formula: {4 - parted} of 4 rows "
          f"identical, {parted} parted at a tie; logit difference on equal "
          f"inputs {free:.3e}")
    return launches, steps


def hybrid_parity(cfg32):
    """(b) zamba2-1.2b f32: 4 rows stepped through 16 positions, kernel
    (``use_pallas="auto"``) against formula (``"off"``) with every k-WTA
    selection held to the kernel run's: logits within 1e-3."""
    from repro_torch.models import transformer as T
    params = T.init_model(cfg32, seed=SEED, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(SEED + 12).integers(
        0, cfg32.vocab_size, (4, HYBRID_PROMPT))).cuda()

    def run(mode):
        cfg_m = dataclasses.replace(cfg32, ffn_sparsity=dataclasses.replace(
            cfg32.ffn_sparsity, use_pallas=mode))
        cache = T.init_cache(cfg_m, 4, HYBRID_PROMPT, "cuda")
        rows = []
        with torch.no_grad():
            for pos in range(HYBRID_PROMPT):
                logits, cache = T.serve_step(params, cache,
                                             {"tokens": toks[:, pos:pos + 1]},
                                             pos, cfg_m)
                rows.append(logits)
        return torch.stack(rows)

    reset_counts()
    with kwta_selections() as masks:
        got = run("auto")
    torch.cuda.synchronize()
    launches = read_counts()["topk_gather"]
    with kwta_selections(iter(masks)):
        want = run("off")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        fail("hybrid parity: non-finite logits")
    err = float((got - want).abs().max())
    tol = 1e-3
    print(f"[hybrid] {HYBRID_ARCH} f32 full width, 4 rows x "
          f"{HYBRID_PROMPT} steps, kernel vs formula, {len(masks)} k-WTA "
          f"selections held: max_abs_err={err:.3e} (max |logit| "
          f"{float(want.abs().max()):.3f}) tol={tol:.0e}; topk_gather "
          f"launches {launches}")
    per_step = cfg32.n_units * cfg32.block_pattern.count("shared_attn")
    if launches != per_step * HYBRID_PROMPT:
        fail(f"hybrid parity: topk_gather launched {launches} times, want "
             f"{per_step} x {HYBRID_PROMPT} steps")
    if not err <= tol:
        fail("hybrid parity: kernel path and formula path disagree")


def xlstm_parity():
    """(c) xlstm-350m f32 at full width: the chunked forward over
    XLSTM_POSITIONS positions (two SSD chunks) against as many
    ``serve_step``s from an empty state."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("xlstm-350m"),
                              compute_dtype="float32")
    params = T.init_model(cfg, seed=SEED, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(SEED + 13).integers(
        0, cfg.vocab_size, (2, XLSTM_POSITIONS))).cuda()
    t = time.perf_counter()
    with torch.no_grad():
        full, _ = T.forward(params, {"tokens": toks}, cfg)
        cache = T.init_cache(cfg, 2, XLSTM_POSITIONS, "cuda")
        rows = []
        for pos in range(XLSTM_POSITIONS):
            logits, cache = T.serve_step(params, cache,
                                         {"tokens": toks[:, pos:pos + 1]},
                                         pos, cfg)
            rows.append(logits)
    steps = torch.stack(rows, dim=1)
    torch.cuda.synchronize()
    last = float((steps[:, -1] - full[:, -1]).abs().max())
    worst = float((steps - full).abs().max())
    tol = 1e-3
    print(f"[hybrid] xlstm-350m f32 full width ({cfg.n_layers} layers, "
          f"{cfg.block_pattern.count('mlstm')} mLSTM : 1 sLSTM a unit, "
          f"chunk {cfg.ssm_chunk}): forward over {XLSTM_POSITIONS} "
          f"positions vs {XLSTM_POSITIONS} serve_steps, last position's "
          f"logits max_abs_err={last:.3e}, every position {worst:.3e} (max "
          f"|logit| {float(full.abs().max()):.3f}) tol={tol:.0e}; "
          f"{time.perf_counter() - t:.1f} s")
    if not bool(torch.isfinite(full).all()) or not worst <= tol:
        fail("xlstm: the chunked forward and the decode steps disagree")


def frontend_serve(arch):
    """(d), (e) a frontend config at full width, bf16: a fused prefill
    (``embeds``, or 256 ``patch_embeds`` before 16 tokens) that launches
    no kernel (B·S·K >= d_ff: Hadamard), then 3 decode steps (``embeds``
    or tokens) of 4 slots, each launching ``topk_gather`` once a layer
    (musicgen-large 48, internvl2-2b 24).  Returns the launches a decode
    step."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    params = T.init_model(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 14)
    b, s = 4, 16

    def embeds(n):
        return torch.from_numpy(rng.uniform(-0.5, 0.5, (b, n, cfg.d_model))
                                .astype(np.float32)).cuda()

    if cfg.frontend == "embed":
        batch = {"embeds": embeds(s)}
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, s))).cuda(),
            "patch_embeds": embeds(cfg.n_prefix)}
    rows = s + (cfg.n_prefix if cfg.frontend == "vision_prefix" else 0)
    with torch.no_grad():
        T.prefill(params, batch, cfg, rows + 3)        # warm-up
        torch.cuda.synchronize()
        reset_counts()
        logits, cache = T.prefill(params, batch, cfg, rows + 3)
        torch.cuda.synchronize()
        in_prefill = read_counts()["topk_gather"]
        finite = bool(torch.isfinite(logits).all())
        reset_counts()
        for i in range(3):
            step = ({"embeds": embeds(1)} if cfg.frontend == "embed" else
                    {"tokens": logits[:, -1:].argmax(-1)})
            logits, cache = T.serve_step(params, cache, step, rows + i, cfg)
            logits = logits[:, None]
            finite = finite and bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        in_steps = read_counts()["topk_gather"]
    print(f"[hybrid] {arch} full width bf16 ({cfg.n_layers} layers, "
          f"frontend {cfg.frontend}): prefill of {b} x {rows} rows "
          f"launches topk_gather {in_prefill} times (B·S·K >= d_ff "
          f"{cfg.d_ff}), 3 decode steps of {b} slots {in_steps} "
          f"({in_steps / 3:.0f} a step); logits finite: {finite}")
    if not finite:
        fail(f"{arch}: non-finite logits")
    if in_prefill != 0 or in_steps != 3 * cfg.n_layers:
        fail(f"{arch}: topk_gather launched {in_prefill} times in prefill "
             f"and {in_steps} in 3 decode steps, want 0 and "
             f"3 x {cfg.n_layers}")
    return in_steps / 3


def hybrid_kernel():
    """(f) ``topk_gather`` at zamba2's shape against its plain version
    (bf16 and f32, and the support as the layer hands it over), then its
    times.  Returns the row-1 keys of that shape."""
    from repro_torch.kernels.topk_gather import topk_gather, topk_gather_plain
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        vals, p_idx, s_off, packed_p, route, packed = kernel_operands(
            HYBRID_SHAPE, dtype, SEED + 70)
        cases = [("", (vals, p_idx, s_off, packed_p, route))]
        if dtype == torch.bfloat16:
            cases.append((", bf16 values, int64 indices",
                          (vals.to(dtype), p_idx.long(), s_off.long(),
                           packed_p, route)))
        for label, operands in cases:
            err = max(err, check(
                f"topk_gather {HYBRID_SHAPE} {str(dtype)[6:]}{label}",
                topk_gather(*operands), topk_gather_plain(*operands),
                phase="hybrid"))
    vals, p_idx, s_off, packed_p, route, packed = kernel_operands(
        HYBRID_SHAPE, torch.bfloat16, SEED + 70)
    times = topk_times(HYBRID_SHAPE, vals, p_idx, s_off, packed_p, route,
                       packed, "hybrid")
    return {"shape": HYBRID_SHAPE, "max_abs_err": err, **times}


def phase_hybrid():
    """Phase 12.  Returns row 1's keys of the hybrid and frontend paths:
    the timed shape, and the launches of their runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(HYBRID_ARCH)
    t = time.perf_counter()
    params = T.init_model(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[hybrid] {HYBRID_ARCH} as shipped: {cfg.n_layers} layers "
          f"({cfg.n_units} units of {len(cfg.block_pattern) - 1} mamba2 + "
          f"the shared attention block), d_model {cfg.d_model}, ssm_state "
          f"{cfg.ssm_state}, shared FFN d_ff {cfg.d_ff} at "
          f"n={cfg.ffn_sparsity.n}, k_frac={cfg.ffn_sparsity.k_frac}, "
          f"{cfg.ffn_sparsity.kwta_impl}; bf16, "
          f"{T.param_count(params) / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
          f"random weights from seed {SEED} in "
          f"{time.perf_counter() - t:.1f} s")
    launches, steps = hybrid_serve(cfg, params)
    del params
    torch.cuda.empty_cache()
    hybrid_parity(dataclasses.replace(cfg, compute_dtype="float32"))
    torch.cuda.empty_cache()
    xlstm_parity()
    torch.cuda.empty_cache()
    per_step = {arch: frontend_serve(arch)
                for arch in ("musicgen-large", "internvl2-2b")}
    torch.cuda.empty_cache()
    return {"hybrid_shape": hybrid_kernel(), "launches_hybrid": launches,
            "launches_per_decode_step_hybrid": launches / steps,
            "launches_per_decode_step_musicgen": per_step["musicgen-large"],
            "launches_per_decode_step_internvl2": per_step["internvl2-2b"]}


# ---------------------------------------------------------------------------
# phase 13: training on a mesh
# ---------------------------------------------------------------------------

MESH_STEPS = 5
MESH_DIR = ROOT / "build" / "mesh"
# cuBLAS's workspace setting for use_deterministic_algorithms, set before
# a process starts CUDA
MESH_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
# params: between (b)'s reading against (a) (1.8e-6) and the smallest
# per-leaf move of step 5's update (~4.5e-5: what a skipped ZeRO-1 slice
# update would part by), which the phase prints and holds above it
MESH_TOL = dict(world1=1e-6, loss_rel=1e-5, params=1e-5, pipe=1e-5)
MESH_LAYERS = 32
#: bisect k-WTA calls a step: one a layer in the forward and one in the
#: backward, where the shipped ``remat=True`` recomputes each block
#: (recorded and held in call order, the recompute's as the forward's)
MESH_SELECTS = 2 * MESH_LAYERS
#: (d): deepseek-v2-lite-16b at its shipped widths, cut to this many of
#: its 27 MoE layers, in float32, one loss and backward of 4 rows of
#: MESH_REMAT_SEQ tokens; (e) zamba2-1.2b at its shipped widths, one unit
#: of its pattern (18 Mamba2 blocks and the shared attention), the same
#: rows
MESH_REMAT_LAYERS, MESH_REMAT_SEQ = 1, 64
#: (d) and (e): every rank's DP-mean gradient block against the single
#: device's, the k-WTA sets (and router choices) held, within this times
#: (1 + max|g|) of the leaf
MESH_GRAD_TOL = 1e-4
#: (b): PR 25's peak max_memory_allocated of a rank in the gathered steps
#: (GiB; its last run of phase 13, steps 1-5 and the step-5 checkpoint,
#: whose gather of the whole tree sets that peak), printed beside this
#: run's over the same window; and how far a loss and backward on blocks
#: must fall below one on the params gathered whole in the same run (the
#: whole copies of the sharded leaves and their whole gradients, ~1.0 GiB
#: a rank, are gone)
MESH_PEAK_GATHERED_GIB, MESH_PEAK_FALL_GIB = 5.53, 0.5


def mesh_setup(ckpt_dir):
    """smollm-360m at its shipped widths, float32 masters and float32 compute (with bf16 compute the DP mean of
    bf16-rounded half-batch gradients differs from the whole batch's by up
    to a bf16 ulp), and the reference comparison's ``TrainConfig(lr=1e-3)``
    (tests/test_distributed.py:39: a 100-step warmup).  Under phase 11's
    2-step warmup the partitionings part by 2.2e-4 after 5 steps (Adam
    scales the f32-order parting of gradients near its eps up to a
    fraction of lr), a quarter of a step's smallest per-leaf move; under
    this warmup they part by ~1.8e-6 against moves of ~4.5e-5."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    cfg = dataclasses.replace(get_config("smollm-360m"),
                              compute_dtype="float32")
    shape = ShapeConfig("phase13", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = TrainConfig(lr=1e-3, warmup_steps=100, total_steps=1000,
                       ckpt_dir=str(ckpt_dir), checkpoint_every=1000,
                       log_every=1000)
    return cfg, shape, tcfg


def mesh_batch(cfg, shape, step, device):
    from repro_torch.data import batch_for, canonical
    return {k: torch.from_numpy(canonical(v)).to(device)
            for k, v in batch_for(cfg, shape, step, seed=0).items()}


def mesh_steps(trainer, steps):
    """Steps ``trainer.step`` .. ``steps - 1`` through
    ``Trainer.train_step`` (no checkpoint); returns each step's loss."""
    losses = []
    while trainer.step < steps:
        batch = mesh_batch(trainer.cfg, trainer.shape, trainer.step,
                           trainer.device)
        losses.append(float(trainer.train_step(batch)["loss"]))
        trainer.step += 1
    return losses


def mesh_rows(trainer):
    """This rank's rows of the global batch (its DP block)."""
    return mesh_rows_of(trainer.rules, (TRAIN_BATCH, TRAIN_SEQ))


def mesh_held(masks, steps, rows, device):
    """The k-WTA selections ``masks[step][layer]`` of ``steps`` as an
    iterator of held masks: ``rows`` of each, on ``device``.  Two
    partitionings of a step differ in f32 order, and a bisect threshold
    within an ulp of a unit flips it (the repo's parity rule: hold the
    selections)."""
    return iter([m[rows].to(device) for s in steps for m in masks[s]])


def state_bytes(trainer):
    """This rank's bytes: params, and the float leaves' moments."""
    from repro_torch.tree import leaves
    params = leaves(trainer.params)
    moments = [t for key in ("mu", "nu")
               for t, p in zip(leaves(trainer.opt[key]), params)
               if p.is_floating_point()]
    return (sum(t.numel() * t.element_size() for t in params),
            sum(t.numel() * t.element_size() for t in moments))


def full_params(trainer):
    """The trainer's params gathered whole (every rank takes part), on the
    host, path -> tensor."""
    from repro_torch.sharding.collectives import gather_leaves
    from repro_torch.tree import flatten, leaves
    whole = gather_leaves(leaves(trainer.params),
                          leaves(trainer.shardings["params"]),
                          trainer.shapes)
    return {k: t.to("cpu", copy=True) for (k, _), t in
            zip(flatten(trainer.params), whole)}


def reckoned_bytes(trainer):
    """The reference's per-device bytes on the trainer's mesh, reckoned
    from the rule table on the reference's layout (the units stacked):
    the params' ``param_sharding`` and the moments' ZeRO-1 specs."""
    from repro_torch.launch import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.sharding import NamedSharding
    from repro_torch.sharding.context import map_specs
    from repro_torch.tree import flatten
    cfg, rules, n = trainer.cfg, trainer.rules, len(trainer.cfg.block_pattern)
    info = {}
    for (path, t), shape in zip(flatten(trainer.params), trainer.shapes):
        keys = path.split("/")
        if keys[0] == "layers":
            if int(keys[1]) >= n:
                continue
            keys = ["units", f"b{keys[1]}"] + keys[2:]
            shape = (cfg.n_units, *shape)
        node = info
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = (shape, t.element_size(), t.is_floating_point())
    specs = T.param_specs(cfg)
    zspecs = St.zero1_specs(specs, map_specs(lambda s, i: i[0], specs, info),
                            rules)
    m_size = torch.empty((), dtype=trainer.acfg.moment_dtype).element_size()

    def count(spec, zspec, i):
        shape, size, is_float = i
        p = math.prod(NamedSharding(rules.mesh, rules.spec_for(
            spec, shape)).shard_shape(shape)) * size
        m = math.prod(NamedSharding(rules.mesh, rules.spec_for(
            zspec, shape)).shard_shape(shape)) * 2 * m_size
        return p, m if is_float else 0

    def total(tree):
        if isinstance(tree, dict):
            return [sum(x) for x in zip(*(total(v) for v in tree.values()))]
        return list(tree)

    return tuple(total(map_specs(count, specs, zspecs, info)))


def ckpt_leaves(step_dir, prefix=""):
    """The leaves of a checkpoint on the host, path -> tensor, those under
    ``prefix`` with it taken off."""
    manifest = json.loads((step_dir / "manifest.json").read_text())
    with np.load(step_dir / "shard_p0.npz") as data:
        return {p[len(prefix):]: torch.from_numpy(data[f"leaf_{i:05d}"])
                for i, p in enumerate(manifest["treedef"])
                if p.startswith(prefix)}


def equal_leaves(got, want):
    """How many leaves of ``want`` (path -> tensor) ``got`` holds bit for
    bit, and how many ``want`` has."""
    return (sum(k in got and torch.equal(got[k].cpu(), want[k])
                for k in want), len(want))


def step_moves(before, after):
    """The largest |after - before| of each float leaf: the smallest of
    them is how far a leaf whose update was skipped would part."""
    return [float((after[k] - before[k]).abs().max()) for k in after
            if after[k].is_floating_point()]


def collective_times(trainer, reps=3):
    """Host-clock time of the step's gradient mean alone at its size,
    median of ``reps``: the ``all_reduce`` over the DP group of one float32
    buffer of every float leaf's block (the step gathers no param)."""
    from repro_torch.sharding import dp_axes
    from repro_torch.sharding.collectives import summed
    from repro_torch.tree import leaves
    floats = [tuple(t.shape) for t in leaves(trainer.params)
              if t.is_floating_point()]
    group = trainer.mesh.group(dp_axes(trainer.mesh))

    def timed(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    return {"grad_mean": timed(lambda: summed(floats, lambda i, b: None,
                                              group, trainer.device)),
            "grad_mean_bytes": 4 * sum(math.prod(s) for s in floats)}


@contextlib.contextmanager
def param_collectives(params):
    """Watch every collective made inside (the backward's too, on any
    thread): yields ``(seen, handed)``, each a list of ``(op, bytes)``,
    ``bytes`` the largest tensor the collective took; ``handed`` those
    given a tensor sharing storage with a block of ``params``."""
    from repro_torch.sharding.collectives import observe_collectives
    from repro_torch.tree import leaves
    held = {t.untyped_storage().data_ptr() for t in leaves(params)}
    seen, handed = [], []

    def watch(op, tensors):
        rec = (op, max(t.numel() * t.element_size() for t in tensors))
        seen.append(rec)
        if any(t.untyped_storage().data_ptr() in held for t in tensors):
            handed.append(rec)

    with observe_collectives(watch):
        yield seen, handed


def collective_census(seen):
    """``{op: [count, bytes]}`` and the largest ``(op, bytes)`` of
    :func:`param_collectives`' list."""
    kinds = {}
    for op, n in seen:
        k = kinds.setdefault(op, [0, 0])
        k[0] += 1
        k[1] += n
    return kinds, max(seen, key=lambda r: r[1]) if seen else None


def fwd_bwd_peaks(trainer):
    """The loss and backward of the rank's rows of step 6's batch alone:
    on the rank's blocks (the step's own, ``steps.sharded_value_and_grad``)
    and on the params gathered whole (the step of PRs 21-25:
    ``gather_leaves``, then ``loss_fn`` under the rules), the second
    holding the first's k-WTA selections (the parity rule: two
    partitionings part at near-ties); each's loss, host-clock ms and peak
    ``max_memory_allocated`` above the state it starts from."""
    from repro_torch.launch import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.sharding import use_rules
    from repro_torch.sharding.collectives import gather_leaves
    from repro_torch.tree import leaves, unflatten
    cfg, rules, device = trainer.cfg, trainer.rules, trainer.device
    rows = mesh_rows(trainer)
    batch = {k: v[rows] for k, v in mesh_batch(
        cfg, trainer.shape, MESH_STEPS, device).items()}
    out, masks = {}, []
    for name in ("blocks", "gathered"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t = time.perf_counter()
        if name == "blocks":
            with kwta_selections() as masks:
                (loss, _), grads = St.sharded_value_and_grad(
                    cfg, rules, trainer.params, batch)
        else:
            whole = gather_leaves(leaves(trainer.params),
                                  leaves(trainer.shardings["params"]),
                                  trainer.shapes)
            with use_rules(rules), kwta_selections(iter(masks)):
                (loss, _), grads = St.value_and_grad(
                    lambda p: T.loss_fn(p, batch, cfg),
                    unflatten(trainer.params, whole))
            del whole
        loss = float(loss)
        torch.cuda.synchronize()
        out[name] = {"loss": loss, "ms": (time.perf_counter() - t) * 1e3,
                     "peak": torch.cuda.max_memory_allocated(device),
                     "above": torch.cuda.max_memory_allocated(device) - base}
        del grads
    del masks
    torch.cuda.empty_cache()
    return out


def max_diff(a, b):
    """Largest |a - b| over two path -> tensor dicts (float leaves), on
    the card."""
    return max(float((a[k].cuda() - b[k].cuda()).abs().max())
               for k in a if a[k].is_floating_point())


def gloo_cuda_probe(device):
    """Which collectives gloo runs on CUDA tensors here (the mesh path
    takes all_reduce, broadcast and all_gather_into_tensor on them, and
    sends the pipeline's ring shift through host copies)."""
    import torch.distributed as dist
    world, x = dist.get_world_size(), torch.ones(4, device=device)
    out = {}
    for name, call in (
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(4 * world, device=device), x)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                torch.empty(4, device=device), x.repeat(world)))):
        try:
            call()
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:70]}"
    return out


def compressed_sync_check(trainer):
    """(c) ``make_compressed_grad_sync`` on mesh (2, 2) (pod, data) over a
    gradient tree of smollm's shapes, each pod's drawn from its seed:
    the mean within each leaf's int8 step of the exact pod mean, and the
    residual equal to input - sent, bit for bit."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import (dequantize_int8, init_residuals,
                                   make_compressed_grad_sync, quantize_int8)
    from repro_torch.tree import flatten
    mesh = make_mesh((2, 2), ("pod", "data"), trainer.device)
    pod = mesh.coords["pod"]
    shapes = {k: s for (k, t), s in zip(flatten(trainer.params),
                                        trainer.shapes)
              if t.is_floating_point()}
    floats = list(shapes)

    def grads_of(p):
        gen = torch.Generator(device=trainer.device).manual_seed(1000 + p)
        return {k: 1e-3 * torch.randn(shapes[k], generator=gen,
                                      device=trainer.device) for k in floats}

    mine, other = grads_of(pod), grads_of(1 - pod)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, resid = make_compressed_grad_sync(mesh, "pod")(
        mine, init_residuals(mine, 1))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    worst, exact = 0.0, 0
    for k in floats:
        step = max(float(mine[k].abs().max()), float(other[k].abs().max()))
        err = float((out[k] - (mine[k] + other[k]) / 2).abs().max()) / (
            step / 127)
        worst = max(worst, err)
        sent = dequantize_int8(*quantize_int8(mine[k]))
        exact += bool(torch.equal(resid[k][0], mine[k] - sent))
    return {"leaves": len(floats), "worst_err_in_int8_steps": worst,
            "resid_exact": exact, "ms": ms,
            "numel": sum(mine[k].numel() for k in floats)}


def pipeline_check(device):
    """(c) ``pipeline_apply`` of 4 smollm decoder blocks at full width in
    float32 on mesh (4,) (pipe), n_micro 4, batch 8 x 128, against the 4
    blocks applied in sequence to each microbatch (the rows a GEMM takes
    change its f32 rounding and so the k-WTA selections at near-ties; the
    whole batch through the blocks is printed beside it)."""
    from repro_torch.core.layers import drop_partition_major
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.runtime import bubble_fraction, pipeline_apply
    from repro_torch.tree import map_tree
    cfg, shape, _ = mesh_setup(MESH_DIR / "pipe")
    mesh = make_mesh((4,), ("pipe",), device)
    stage = mesh.coords["pipe"]
    blocks = []
    for s in range(4):      # the training layout, as loss_fn takes it
        gen = torch.Generator(device=device).manual_seed(s)
        blocks.append(drop_partition_major(T._block_init("attn", gen, cfg)))
    gen = torch.Generator(device=device).manual_seed(99)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device=device)

    def stage_fn(p, h):
        pos = torch.arange(h.shape[1], device=device).expand(h.shape[0], -1)
        return T._block_apply("attn", p, h, cfg, pos)[0]

    def in_sequence(h):
        for p in blocks:
            h = stage_fn(p, h)
        return h

    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = pipeline_apply(stage_fn, mesh, "pipe",
                           map_tree(lambda p: p[None], blocks[stage]), x, 4)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        micro = torch.cat([in_sequence(m) for m in x.chunk(4)])
        whole = in_sequence(x)
    return {"max_abs_err": float((y - micro).abs().max()),
            "whole_batch_err": float((y - whole).abs().max()),
            "ref_max": float(micro.abs().max()), "ms": ms,
            "bubble": bubble_fraction(4, 4)}


def mesh_gloo(rank):
    """(b) to (e) on one of four gloo ranks sharing the card: 6 steps on
    mesh 2x2 keeping their k-WTA selections (its rows) for (a), their
    collectives and peaks, one loss and backward on the blocks against one
    on the gathered params, the step-5 checkpoint restored onto 4x1 for
    one more step holding them, the int8 sync and GPipe, and (d) and (e)'s
    gradient blocks against one device."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer
    torch.use_deterministic_algorithms(True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = {"rank": rank}
    cfg, shape, tcfg = mesh_setup(MESH_DIR / "b")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    trainer = Trainer(cfg, tcfg, make_mesh((2, 2), ("data", "model"),
                                           device), shape)
    out["build_s"] = time.perf_counter() - t
    out["bytes"] = state_bytes(trainer)
    out["reckoned"] = reckoned_bytes(trainer)
    rows = mesh_rows(trainer)
    reset_counts()
    losses, check = [], trainer.guard.check
    trainer.guard.check = lambda loss: losses.append(loss) or check(loss)
    t = time.perf_counter()
    with kwta_selections() as flat, \
            param_collectives(trainer.params) as (seen, handed):
        # Trainer.run, which checkpoints the step-5 state at its end
        trainer.run(MESH_STEPS, lambda s: batch_for_cfg(cfg, shape, s),
                    log=lambda *a: None)
        out["run_s"] = time.perf_counter() - t
        out["launches"] = read_counts()
        # the run's window ends with the step-5 checkpoint, which gathers
        # the whole tree
        out["peak"] = torch.cuda.max_memory_allocated(device)
        # the uninterrupted step 6, its collectives and peak alone
        before = len(seen)
        torch.cuda.reset_peak_memory_stats(device)
        out["loss6"] = mesh_steps(trainer, MESH_STEPS + 1)[0]
        out["peak_step"] = torch.cuda.max_memory_allocated(device)
        out["census"] = collective_census(seen[before:])
    out["handed"] = handed
    trainer.guard.check = check
    out["collectives_ms"] = collective_times(trainer)
    out["fwd_bwd"] = fwd_bwd_peaks(trainer)
    out["losses"] = losses
    out["step_ms"] = [e.duration * 1e3 for e in trainer.monitor.events]
    if len(flat) != MESH_SELECTS * (MESH_STEPS + 1):
        fail(f"mesh: {len(flat)} k-WTA selections in 6 steps")
    n = MESH_SELECTS
    masks = [[m.cpu() for m in flat[s * n:(s + 1) * n]]
             for s in range(MESH_STEPS + 1)]
    del flat
    if trainer.mesh.coords["model"] == 0:
        torch.save(masks, MESH_DIR / f"masks_{rows.start}.pt")
    full6 = full_params(trainer)
    if rank == 0:
        torch.save(full6, MESH_DIR / "b_step6.pt")
    del trainer
    torch.cuda.empty_cache()
    dist.barrier()          # masks, checkpoint and step 6 on disk: (a) may
    if rank == 0:           # start beside the rest of (b) and (c)
        (MESH_DIR / "ready").touch()
    # the step-5 checkpoint restored onto (4, 1), one more step holding
    # the selections of its rows
    t = time.perf_counter()
    wide = Trainer(cfg, tcfg, make_mesh((4, 1), ("data", "model"), device),
                   shape)
    out["resumed_4x1"] = wide.try_resume() and wide.step
    out["restore_4x1_s"] = time.perf_counter() - t
    # the restored params and moments, gathered whole, against the
    # checkpoint's leaves
    restored = wide.full_state()
    if rank == 0:
        out["restored_equal_4x1"] = equal_leaves(host_tree(restored),
                                                 ckpt_leaves(
            MESH_DIR / "b" / f"step_{MESH_STEPS:08d}"))
    del restored
    mine = mesh_rows(wide)
    within = slice(mine.start - rows.start, mine.stop - rows.start)
    with kwta_selections(mesh_held(masks, [MESH_STEPS], within, device)):
        out["loss6_4x1"] = mesh_steps(wide, MESH_STEPS + 1)[0]
    out["diff6_4x1"] = max_diff(full_params(wide), full6)
    out["bytes_4x1"] = state_bytes(wide)
    out["reckoned_4x1"] = reckoned_bytes(wide)
    del wide, full6, masks
    torch.cuda.empty_cache()
    holder = Trainer(cfg, tcfg, make_mesh((2, 2), ("data", "model"), device),
                     shape)
    out["sync"] = compressed_sync_check(holder)
    del holder
    torch.cuda.empty_cache()
    out["pipe"] = pipeline_check(device)
    out["moe_remat"] = block_grads_check(mesh_remat_cfg(), device,
                                         remat_pair=True)
    out["ssm_grads"] = block_grads_check(mesh_ssm_grads_cfg(), device)
    out["gloo_cuda"] = gloo_cuda_probe(device)
    out["peak_all"] = torch.cuda.max_memory_allocated(device)
    dist.barrier()
    return out


def mesh_remat_cfg():
    """(d)'s deepseek-v2-lite-16b: its shipped widths, MESH_REMAT_LAYERS
    deep, float32 compute, remat as shipped."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), compute_dtype="float32",
                               n_layers=MESH_REMAT_LAYERS)


def mesh_ssm_grads_cfg():
    """(e)'s zamba2-1.2b: its shipped widths, one unit of its pattern,
    float32 compute, remat as shipped."""
    from repro_torch.configs import get_config
    cfg = get_config(HYBRID_ARCH)
    return dataclasses.replace(cfg, compute_dtype="float32",
                               n_layers=len(cfg.block_pattern))


def block_grads_check(cfg, device, remat_pair=False, dims=(2, 2)):
    """(d) and (e) on mesh ``dims`` (data x model; 2x2 in phase 13, 1x4 in
    phase 19): 4 sequences of MESH_REMAT_SEQ tokens, first on the single
    device (whole params, the whole batch; its k-WTA sets and MoE router
    choices recorded), then the rank's rows on its param blocks (with the
    ``block_route`` that ``steps.shard_train_state`` gives them) under the
    training rules and shards (``steps.sharded_value_and_grad``, the
    step's own) holding them, backward on autograd's device thread.
    Every rank's gradient blocks, their mean over the DP group as the
    step takes it, against the single device's cut to the block; with
    ``remat_pair``, the same without remat against with it.  Returns the
    leaves, the largest error over (1 + max|g|) of its leaf and where,
    the losses, the collectives handed a param block, and the remat
    comparison."""
    from repro_torch.data import canonical, lm_batch
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding import make_rules, param_sharding, use_rules
    from repro_torch.sharding.collectives import dp_group, group_size, summed
    from repro_torch.tree import flatten, leaves, map_tree
    mesh = make_mesh(dims, ("data", "model"), device)
    rules = make_rules(mesh, "train")
    batch = {k: torch.from_numpy(canonical(v)).to(device) for k, v in
             lm_batch(SEED, 0, 4, MESH_REMAT_SEQ, cfg.vocab_size).items()}
    rows = mesh_rows_of(rules, batch["tokens"].shape)
    mine = {k: v[rows] for k, v in batch.items()}
    params = T.init_train_params(cfg, seed=SEED, device=device)
    t = time.perf_counter()
    with kwta_selections() as masks, router_choices() as choices:
        (loss1, _), g1 = St.value_and_grad(lambda p: T.loss_fn(p, batch, cfg),
                                           params)
    single_ms = (time.perf_counter() - t) * 1e3
    shs = param_sharding(T.layer_specs(T.param_specs(cfg), cfg), params,
                         rules)
    blocks = T.add_block_routes(map_tree(lambda sh, p: sh.take(p), shs,
                                         params), params, shs)
    want = {k: g[sh.block(p.shape)].clone() for (k, p), g, sh in
            zip(flatten(params), g1, leaves(shs)) if g is not None}
    keys = [k for k, _ in flatten(blocks)]
    del params, g1
    torch.cuda.empty_cache()
    experts, m = None, dims[1]
    if cfg.is_moe and cfg.n_experts % m == 0:
        lo = mesh.coords["model"] * (cfg.n_experts // m)
        experts = (lo, lo + cfg.n_experts // m)
    got, out = {}, {"loss_single": float(loss1), "single_ms": single_ms}
    with use_rules(rules):
        group = dp_group()
    for remat in ((True, False) if remat_pair else (True,)):
        c = dataclasses.replace(cfg, remat=remat)
        t = time.perf_counter()
        with kwta_selections(iter(masks), rows=rows, experts=experts), \
                router_choices(iter(choices), rows=rows), \
                param_collectives(blocks) as (seen, handed):
            (loss, _), grads = St.sharded_value_and_grad(c, rules, blocks,
                                                         mine)
            float(loss)
        got[remat] = (loss, grads, (time.perf_counter() - t) * 1e3)
        out.setdefault("handed", []).extend(handed)
        out.setdefault("collectives", []).append(len(seen))
    loss, grads, ms = got[True]
    floats = [i for i, g in enumerate(grads) if g is not None]
    mean = summed([tuple(grads[i].shape) for i in floats],
                  lambda j, buf: buf.copy_(grads[floats[j]]), group, device)
    worst, where = 0.0, None
    for i, g in zip(floats, mean):
        w = want[keys[i]]
        err = float((g / group_size(group) - w).abs().max()) / (
            1 + float(w.abs().max()))
        if err >= worst:
            worst, where = err, keys[i]
    out.update(loss=float(loss), leaves=len(floats), worst=worst,
               worst_leaf=where, ms=[ms], missing=len(
                   set(want) - {keys[i] for i in floats}))
    if remat_pair:
        l0, g0, ms0 = got[False]
        pairs = [(a, b) for a, b in zip(g0, grads, strict=True)
                 if a is not None]
        out.update(loss_equal=bool(torch.equal(l0, loss)),
                   equal=sum(bool(torch.equal(a, b)) for a, b in pairs),
                   max_abs_diff=max(float((a - b).abs().max())
                                    for a, b in pairs),
                   ms=[ms0, ms])
    del got, grads, mean, want, blocks
    torch.cuda.empty_cache()
    return out


def mesh_rows_of(rules, shape):
    """The rank's rows of a batch input of ``shape`` (its DP block)."""
    return rules.sharding_for(("batch", None), shape).block(shape)[0]


def batch_for_cfg(cfg, shape, step):
    from repro_torch.data import batch_for
    return batch_for(cfg, shape, step, seed=0)


def mesh_single():
    """(a) in a fresh process under ``use_deterministic_algorithms``,
    holding (b)'s k-WTA selections: the single-device Trainer (no process
    group) for 5 steps, (b)'s step-5 params against it; the Trainer on
    mesh 1x1 over NCCL at world size 1 for 5 steps against it; (b)'s
    checkpoint restored onto that 1x1 mesh for one more step against
    (b)'s uninterrupted step 6.  Writes build/mesh/single.json."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer
    torch.use_deterministic_algorithms(True)
    parts = [torch.load(MESH_DIR / f"masks_{r}.pt")
             for r in range(0, TRAIN_BATCH, TRAIN_BATCH // 2)]
    masks = [[torch.cat([p[s][j] for p in parts])
              for j in range(MESH_SELECTS)] for s in range(MESH_STEPS + 1)]
    every = slice(0, TRAIN_BATCH)
    out = {}
    cfg, shape, tcfg = mesh_setup(MESH_DIR / "single")
    single = Trainer(cfg, tcfg, (1, 1), shape, device="cuda")
    with kwta_selections(mesh_held(masks, range(MESH_STEPS), every,
                                   single.device)):
        out["single_losses"] = mesh_steps(single, MESH_STEPS - 1)
        before = host_tree(single.params)
        out["single_losses"] += mesh_steps(single, MESH_STEPS)
    want = host_tree(single.params)
    moves = step_moves(before, want)
    out["step5_move"] = [min(moves), max(moves)]
    del single, before
    torch.cuda.empty_cache()
    b5 = MESH_DIR / "b" / f"step_{MESH_STEPS:08d}"
    got = ckpt_leaves(b5, "params/")
    out["diff_b_a"] = max_diff(got, want)
    del got
    dist.init_process_group("nccl", init_method=f"file://{MESH_DIR}/store1",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg, shape, tcfg = mesh_setup(MESH_DIR / "world1")
        t = Trainer(cfg, tcfg, mesh, shape)
        out["backend"] = dist.get_backend()
        out["bytes"] = state_bytes(t)
        reset_counts()
        with kwta_selections(mesh_held(masks, range(MESH_STEPS), every,
                                       t.device)):
            out["losses"] = mesh_steps(t, MESH_STEPS)
        out["launches"] = read_counts()
        got = host_tree(t.params)
        out["diff_single"] = max_diff(got, want)
        out["equal_leaves"] = sum(torch.equal(got[k], want[k]) for k in got)
        out["leaves"] = len(got)
        del t, got, want
        torch.cuda.empty_cache()
        # (b)'s checkpoint onto 1x1, one more step
        _, _, tcfg_b = mesh_setup(MESH_DIR / "b")
        r = Trainer(cfg, tcfg_b, mesh, shape)
        out["resumed_1x1"] = r.try_resume() and r.step
        out["restored_equal_1x1"] = equal_leaves(
            host_tree(r.state_tree()), ckpt_leaves(b5))
        with kwta_selections(mesh_held(masks, [MESH_STEPS], every,
                                       r.device)):
            out["loss6_1x1"] = mesh_steps(r, MESH_STEPS + 1)[0]
        out["diff6_1x1"] = max_diff(host_tree(r.params),
                                    torch.load(MESH_DIR / "b_step6.pt"))
    finally:
        dist.destroy_process_group()
    (MESH_DIR / "single.json").write_text(json.dumps(out))


def phase_mesh():
    """Phase 13: (b) to (e) on four gloo ranks sharing the card, and (a)
    with the restore onto 1x1 in a fresh process at NCCL world size 1,
    started beside the ranks once (b) has written its selections, its
    checkpoint and its step 6 (the 4x1 restore's, the sync's and GPipe's
    times share the card with it)."""
    import os
    import shutil
    from repro_torch.launch.ranks import run_ranks
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    saved = {k: os.environ.get(k) for k in MESH_ENV}
    os.environ.update(MESH_ENV)
    done = {}

    def gloo():
        try:
            done["ranks"] = run_ranks(mesh_gloo, 4, MESH_DIR / "ranks",
                                      backend="gloo", timeout_s=600,
                                      threads=2)
        except BaseException as e:      # raised again below, in this thread
            done["error"] = e
        done["s"] = time.perf_counter() - t0

    ranks_thread = threading.Thread(target=gloo)
    ranks_thread.start()
    try:
        # (a) starts once (b) has written what it reads, and shares the
        # card with the rest of (b) and (c)
        while not (MESH_DIR / "ready").exists() and ranks_thread.is_alive():
            time.sleep(0.5)
        t = time.perf_counter()
        if (MESH_DIR / "ready").exists():
            run_fresh("mesh_single()", env=MESH_ENV)
        t_a = time.perf_counter() - t
    finally:
        ranks_thread.join()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if "error" in done:
        raise done["error"]
    ranks, t_b = done["ranks"], done["s"]
    a = r1 = json.loads((MESH_DIR / "single.json").read_text())
    r0 = ranks[0]
    tol = MESH_TOL
    four = ("topk_gather", "packed_matmul", "grouped_cs_matmul", "kwta_hist")
    failed = []

    print(f"[mesh] smollm-360m at its shipped widths ({MESH_LAYERS} layers, "
          f"d_model 960, d_ff 2560, vocab 49152; remat on, as shipped), "
          f"float32 masters and compute, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, ZeRO-1 on, {MESH_STEPS} "
          f"steps, lr 1e-3 warmup 100, use_deterministic_algorithms; (a) "
          f"and the restores hold (b)'s k-WTA selections")
    single5 = a["single_losses"]
    da = abs(np.array(a["losses"]) - np.array(single5)).max()
    print(f"[mesh] (a) mesh 1x1 over {a['backend']} at world size 1 against "
          f"the single-device Trainer: losses {a['losses']}; largest loss "
          f"difference {da:.3e}, params {a['diff_single']:.3e} "
          f"({a['equal_leaves']} of {a['leaves']} leaves bit-equal) "
          f"tol={tol['world1']:.0e}; kernel launches "
          f"{ {k: a['launches'][k] for k in four} }")
    if not (da <= tol["world1"] and a["diff_single"] <= tol["world1"]):
        failed.append("the 1x1 mesh step parts from the single-device step")

    rel = [abs(x - y) / abs(y) for x, y in zip(r0["losses"], single5)]
    print(f"[mesh] (b) mesh 2x2 (data x model), four gloo ranks sharing the "
          f"card: losses {r0['losses']} (relative to (a) "
          f"{', '.join(f'{x:.2e}' for x in rel)}; tol {tol['loss_rel']:.0e})"
          f", every rank the same loss "
          f"{all(r['losses'] == r0['losses'] for r in ranks)}; params after "
          f"step {MESH_STEPS} against (a) {r1['diff_b_a']:.3e} "
          f"(tol {tol['params']:.0e}; step {MESH_STEPS}'s update moves each "
          f"leaf by {a['step5_move'][0]:.3e} to {a['step5_move'][1]:.3e} "
          f"at most); kernel launches "
          f"{ {k: r0['launches'][k] for k in four} }")
    if not a["step5_move"][0] > tol["params"]:
        failed.append("the params bound cannot see a skipped update")
    if not (max(rel) <= tol["loss_rel"] and r1["diff_b_a"] <= tol["params"]
            and all(r["losses"] == r0["losses"] for r in ranks)):
        failed.append("the 2x2 steps part from the single-device ones")
    if any(r["launches"][k] for r in ranks for k in four) or any(
            a["launches"][k] for k in four):
        failed.append("a kernel of the library ran in a training step")
    one_p, one_m = a["bytes"]
    for r in ranks:
        print(f"[mesh] (b) rank {r['rank']}: param bytes {r['bytes'][0]} "
              f"(1x1 {one_p}, reckoned from the rules {r['reckoned'][0]}), "
              f"moment bytes {r['bytes'][1]} (1x1 {one_m}, reckoned "
              f"{r['reckoned'][1]}); on 4x1 {r['bytes_4x1']} (reckoned "
              f"{r['reckoned_4x1']}); peak max_memory_allocated "
              f"{r['peak'] / 2**30:.2f} GiB in steps 1-5 with the step-5 "
              f"checkpoint (its gather of the whole tree; the gathered "
              f"step's run: {MESH_PEAK_GATHERED_GIB:.2f}), "
              f"{r['peak_step'] / 2**30:.2f} GiB in step 6 alone, "
              f"{r['peak_all'] / 2**30:.2f} GiB in the phase")
        if tuple(r["bytes"]) != tuple(r["reckoned"]) or tuple(
                r["bytes_4x1"]) != tuple(r["reckoned_4x1"]):
            failed.append("a rank's bytes are not the reckoned shard's")
    fb = [r["fwd_bwd"] for r in ranks]
    print(f"[mesh] (b) one loss and backward of step 6's rows alone, on the "
          f"blocks / on the params gathered whole (the step of PRs 21-25): "
          f"peak max_memory_allocated a rank "
          f"{[round(f['blocks']['peak'] / 2**30, 3) for f in fb]} / "
          f"{[round(f['gathered']['peak'] / 2**30, 3) for f in fb]} GiB "
          f"(above the state {fb[0]['blocks']['above'] / 2**30:.3f} / "
          f"{fb[0]['gathered']['above'] / 2**30:.3f}; limit: "
          f"{MESH_PEAK_FALL_GIB} GiB below the gathered); host clock "
          f"{fb[0]['blocks']['ms']:.1f} / {fb[0]['gathered']['ms']:.1f} ms; "
          f"losses {fb[0]['blocks']['loss']:.6f} / "
          f"{fb[0]['gathered']['loss']:.6f}")
    for f in fb:
        if f["blocks"]["peak"] + MESH_PEAK_FALL_GIB * 2**30 > \
                f["gathered"]["peak"]:
            failed.append("the loss and backward on blocks hold as much as "
                          "on the gathered params")
        if abs(f["blocks"]["loss"] - f["gathered"]["loss"]) > \
                MESH_TOL["loss_rel"] * abs(f["gathered"]["loss"]):
            failed.append("the loss on blocks parts from the gathered one")
    steps = r0["step_ms"][1:]
    kinds, largest = r0["census"]
    print(f"[mesh] (b) host-clock step (steps 2-{MESH_STEPS}, loss read "
          f"back): median {np.median(steps):.1f} ms, min {min(steps):.1f}, "
          f"max {max(steps):.1f}; first {r0['step_ms'][0]:.1f} ms; Trainer "
          f"built in {r0['build_s']:.1f} s; run with its step-5 checkpoint "
          f"{r0['run_s']:.1f} s; no param gathered; alone, the gradient "
          f"mean over data of the blocks "
          f"({r0['collectives_ms']['grad_mean_bytes']} B) "
          f"{r0['collectives_ms']['grad_mean']:.1f} ms")
    print(f"[mesh] (b) collectives of step 6 (forward, backward and "
          f"update) on rank 0, by kind [count, bytes]: {kinds}; the "
          f"largest {largest}; handed a param block on any rank in the 6 "
          f"steps: {sum(len(r['handed']) for r in ranks)}")
    if any(r["handed"] for r in ranks):
        failed.append("a param block was handed to a collective")
    d1 = abs(r1["loss6_1x1"] - r0["loss6"]) / abs(r0["loss6"])
    d4 = abs(r0["loss6_4x1"] - r0["loss6"]) / abs(r0["loss6"])
    print(f"[mesh] (b) the step-5 checkpoint restored (resumed at "
          f"{r1['resumed_1x1']} and {r0['resumed_4x1']}) and one more step: "
          f"on 1x1 loss {r1['loss6_1x1']:.6f}, on 4x1 "
          f"{r0['loss6_4x1']:.6f}, uninterrupted 2x2 {r0['loss6']:.6f} "
          f"(relative {d1:.2e}, {d4:.2e}); params {r1['diff6_1x1']:.3e}, "
          f"{r0['diff6_4x1']:.3e}; restored params and moments bit-equal to "
          f"the checkpoint's: {r1['restored_equal_1x1']} and "
          f"{r0['restored_equal_4x1']} (equal, leaves); 4x1 restore "
          f"{r0['restore_4x1_s']:.1f} s")
    if not (r1["resumed_1x1"] == r0["resumed_4x1"] == MESH_STEPS
            and max(d1, d4) <= tol["loss_rel"]
            and max(r1["diff6_1x1"], r0["diff6_4x1"]) <= tol["params"]
            and all(e == n for e, n in (r1["restored_equal_1x1"],
                                        r0["restored_equal_4x1"]))):
        failed.append("a restore onto another mesh parts from the run")
    syncs, pipes = [r["sync"] for r in ranks], [r["pipe"] for r in ranks]
    worst = max(s["worst_err_in_int8_steps"] for s in syncs)
    print(f"[mesh] (c) make_compressed_grad_sync on mesh 2x2 (pod x data), "
          f"{syncs[0]['leaves']} leaves, {syncs[0]['numel']} values a pod: "
          f"largest error {worst:.3f} int8 steps of the exact pod mean "
          f"(tol 1); residual == input - sent on "
          f"{min(s['resid_exact'] for s in syncs)} of {syncs[0]['leaves']} "
          f"leaves; {syncs[0]['ms']:.1f} ms")
    if not (worst <= 1.0 and all(s["resid_exact"] == s["leaves"]
                                 for s in syncs)):
        failed.append("the compressed sync parts from the pod mean")
    perr = max(p["max_abs_err"] for p in pipes)
    print(f"[mesh] (c) pipeline_apply of 4 smollm decoder blocks (f32, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}) on mesh 4 (pipe), n_micro 4, "
          f"bubble {pipes[0]['bubble']:.3f}: largest |y - the blocks in "
          f"sequence on each microbatch| {perr:.3e} (|y| up to "
          f"{pipes[0]['ref_max']:.2f}; tol {tol['pipe']:.0e}); on the whole "
          f"batch at once {max(p['whole_batch_err'] for p in pipes):.3e} "
          f"(free k-WTA selections); {pipes[0]['ms']:.1f} ms")
    if not perr <= tol["pipe"]:
        failed.append("the pipeline parts from the blocks in sequence")
    mr = [r["moe_remat"] for r in ranks]
    print(f"[mesh] (d) {MOE_ARCH} at its shipped widths, {MESH_REMAT_LAYERS} "
          f"of 27 layers, f32, 4 rows of {MESH_REMAT_SEQ} on mesh 2x2, the "
          f"rank's blocks under the training rules: one loss and backward "
          f"(on autograd's device thread), remat on vs off: loss bit-equal "
          f"on every rank {all(m['loss_equal'] for m in mr)}, gradient "
          f"leaves bit-equal {[m['equal'] for m in mr]} of "
          f"{mr[0]['leaves']} (largest |diff| "
          f"{max(m['max_abs_diff'] for m in mr):.3e}); host clock off / on "
          f"{mr[0]['ms'][0]:.1f} / {mr[0]['ms'][1]:.1f} ms")
    if not all(m["loss_equal"] and m["equal"] == m["leaves"] for m in mr):
        failed.append("remat's recompute parts from the forward on a mesh")
    sg = [r["ssm_grads"] for r in ranks]
    for label, rs, what in (
            ("(d)", mr, "k-WTA sets and router choices"),
            ("(e)", sg, "k-WTA sets")):
        arch = MOE_ARCH if label == "(d)" else (
            f"{HYBRID_ARCH} at its shipped widths, one unit (19 blocks), "
            f"f32, 4 rows of {MESH_REMAT_SEQ} on mesh 2x2")
        worst = max(rs, key=lambda m: m["worst"])
        print(f"[mesh] {label} {arch}: every rank's DP-mean gradient blocks "
              f"against the single device's with its {what} held: largest "
              f"|diff| / (1 + max|g|) {worst['worst']:.3e} "
              f"({worst['worst_leaf']}; tol {MESH_GRAD_TOL:.0e}) over "
              f"{rs[0]['leaves']} leaves, unreached {rs[0]['missing']}; "
              f"losses {[m['loss'] for m in rs]} against "
              f"{rs[0]['loss_single']:.6f}; collectives a loss and backward "
              f"{rs[0]['collectives']}, handed a param block "
              f"{sum(len(m['handed']) for m in rs)}; host clock single "
              f"{rs[0]['single_ms']:.1f} ms, blocks {rs[0]['ms'][-1]:.1f} ms")
        if not all(m["worst"] <= MESH_GRAD_TOL and not m["missing"]
                   for m in rs):
            failed.append(f"{label}'s gradient blocks part from one device")
        if any(m["handed"] for m in rs):
            failed.append(f"{label} handed a param block to a collective")
    print(f"[mesh] gloo on CUDA tensors: {r0['gloo_cuda']}")
    numbers = {
        "step_ms_median": float(np.median(steps)),
        "step_ms": r0["step_ms"], "losses_2x2": r0["losses"],
        "losses_1x1": a["losses"], "param_bytes": [r["bytes"][0]
                                                   for r in ranks],
        "moment_bytes": [r["bytes"][1] for r in ranks],
        "param_bytes_1x1": one_p, "moment_bytes_1x1": one_m,
        "peak_gib": [r["peak"] / 2**30 for r in ranks],
        "peak_step6_gib": [r["peak_step"] / 2**30 for r in ranks],
        "fwd_bwd": fb[0],
        "collectives_ms": r0["collectives_ms"],
        "collectives_step6": kinds,
        "grads_err": {"d": max(m["worst"] for m in mr),
                      "e": max(m["worst"] for m in sg)},
        "e_ms": [sg[0]["single_ms"], sg[0]["ms"][-1]],
        "params_diff_2x2": r1["diff_b_a"], "step5_move": a["step5_move"],
        "sync_ms": syncs[0]["ms"], "pipe_ms": pipes[0]["ms"],
        "gloo_s": t_b, "single_s": t_a,
        "phase_s": time.perf_counter() - t0}
    print(f"[mesh] numbers {json.dumps(numbers)}")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    if failed:
        fail("mesh: " + "; ".join(failed))


# ---------------------------------------------------------------------------
# phase 14: serving on a mesh
# ---------------------------------------------------------------------------

MESH_SERVE_DIR = ROOT / "build" / "mesh_serve"
#: max_seq of phase 14: the contiguous cache's rows shard, 12 a rank on
#: (1, 4) and 24 on (2, 2)
MESH_SERVE_SEQ = 48
MESH_SERVE_MESHES = ((1, 4), (2, 2))
#: the layouts each mesh serves phase 4's workload on (checks (b)-(e));
#: (a) runs both on both.  The page pools replicate on either mesh (5 kv
#: heads), so a paged serve on 1x4 would repeat 2x2's but for the gather
#: width, at a second a decode step of gloo collectives
MESH_SERVE_LAYOUTS = {(1, 4): ("contiguous",),
                      (2, 2): ("contiguous", "paged")}
#: decode steps of check (a), after the four prompts' prefills
MESH_SERVE_FORCED = 4
MESH_SERVE_TOL = 1e-3
LAYOUTS = ("contiguous", "paged")
#: the depth of phase 14's smollm-360m (32 shipped), cut to keep the
#: whole script within its time limit beside phase 15: a decode step of
#: four gloo ranks on one card is mostly its collectives, four a layer
MESH_SERVE_LAYERS = 2


def mesh_serve_cfg():
    """smollm-360m at its shipped widths, MESH_SERVE_LAYERS deep."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("smollm-360m"),
                               n_layers=MESH_SERVE_LAYERS)


def mesh_serve_kw(layout):
    return ({} if layout == "contiguous" else
            dict(kv_layout="paged", page_size=16, prefill_chunk=16))


def forced_logits(engine, prompts, forced):
    """Four prompts prefilled into slots 0-3, then ``forced`` decode steps
    fed those tokens ((steps, 4)), on either layout (one page chain a
    slot), on the engine's mesh: the prefills' last rows and each step's
    logits, (4, vocab) float32 host arrays.  Teacher forcing gives two
    engines the same inputs however their tokens would part."""
    n = engine.n_slots
    first, tables = [], None
    with torch.no_grad(), engine.on_mesh():
        if engine.kv_layout == "paged":
            cache = engine.new_paged_cache()
            blocks = engine.kv_geo.blocks_per_slot
            tables = np.arange(1, n * blocks + 1).reshape(n, blocks)
            chunk = engine.prefill_chunk
            for slot, p in enumerate(prompts):
                for start in range(0, len(p), chunk):
                    row = engine._prefill_chunk(cache, p[start:start + chunk],
                                                tables[slot:slot + 1], start)
                first.append(row.float().cpu().numpy())
        else:
            cache = engine.new_cache(n)
            for slot, p in enumerate(prompts):
                row, frag = engine._prefill(p)
                engine._insert(cache, frag, slot)
                first.append(row)
        rows = [np.stack(first)]
        pos = np.array([len(p) for p in prompts])
        for toks in forced:
            logits, _ = engine._decode_step(cache, toks[:, None], pos, tables)
            rows.append(logits)
            pos = pos + 1
    return rows


def rows_err(a, b):
    return float(max(np.abs(x - y).max() for x, y in zip(a, b, strict=True)))


def fingerprint(params):
    """Sums of a few leaves: two processes drew the same weights."""
    return [float(params["embed"]["table"].double().sum()),
            float(params["layers"][-1]["ffn"]["down"]["packed"].double()
                  .sum()),
            float(params["layers"][0]["mixer"]["q"]["w"].double().sum())]


def serving_bytes(engine):
    """The engine's bytes on this rank: the reference's param leaves, the
    partition-major copies and a new cache of its layout."""
    from repro_torch.core.layers import drop_partition_major
    from repro_torch.tree import leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree))

    ref = nbytes(drop_partition_major(engine.params))
    cache = (engine.new_paged_cache() if engine.kv_layout == "paged"
             else engine.new_cache(engine.n_slots))
    return ref, nbytes(engine.params) - ref, nbytes(cache)


def reckoned_serving_bytes(engine, whole, rules=None):
    """The reference's per-device bytes of ``whole``'s params and the
    engine's cache, reckoned from the specs under ``rules`` (default: the
    engine's; ``shard_shape`` of each leaf, the units stacked)."""
    from repro_torch.core.layers import drop_partition_major
    from repro_torch.models import transformer as T
    from repro_torch.sharding.context import param_sharding
    from repro_torch.tree import leaves
    cfg, rules = engine.cfg, engine.rules if rules is None else rules

    def total(specs, tree):
        out = 0
        for sh, t in zip(leaves(param_sharding(specs, tree, rules)),
                         leaves(tree), strict=True):
            shape = tuple(t.shape)
            block = (sh.shard_shape((sh.unit[1], *shape))[1:] if sh.unit
                     else sh.shard_shape(shape))
            out += math.prod(block) * t.element_size()
        return out

    paged = engine.kv_layout == "paged"
    meta = (T.init_paged_cache(cfg, engine.kv_geo.n_pages,
                               engine.kv_geo.page_size, "meta") if paged
            else T.init_cache(cfg, engine.n_slots, engine.max_seq, "meta"))
    return (total(T.layer_specs(T.param_specs(cfg), cfg),
                  drop_partition_major(whole)),
            total(T.layer_cache_specs(cfg, paged), meta))


class CollectiveLog:
    """The collectives an engine runs: whether a decode step ran them, the
    bytes of the largest tensor of each (a gather's received buffer) and
    whether a tensor handed over is (or views) a param or a cache block,
    by storage, while both are alive."""

    def __init__(self, engine):
        from repro_torch.tree import leaves
        self.leaves = leaves
        self.calls, self.caches, self.in_step = [], [], False
        self.held = self._storages(engine.params)
        for name in ("new_cache", "new_paged_cache"):
            make = getattr(engine, name)
            setattr(engine, name, lambda *a, make=make: self._keep(make(*a)))
        step = engine._decode_step

        def decode_step(*a, **kw):
            self.in_step = True
            try:
                return step(*a, **kw)
            finally:
                self.in_step = False
        engine._decode_step = decode_step

    def _storages(self, tree):
        return {t.untyped_storage().data_ptr() for t in self.leaves(tree)}

    def _keep(self, cache):
        self.caches.append(cache)
        self.held |= self._storages(cache)
        return cache

    def __call__(self, op, tensors):
        big = max(tensors, key=lambda t: t.numel())
        self.calls.append((self.in_step, op,
                           big.numel() * big.element_size(),
                           sum(t.untyped_storage().data_ptr() in self.held
                               for t in tensors)))

    def summary(self, steps):
        step = [c for c in self.calls if c[0]]
        largest = max(step, key=lambda c: c[2])
        return {"per_step": len(step) / steps,
                "bytes_per_step": sum(c[2] for c in step) / steps,
                "largest": [largest[1], largest[2]],
                "ops": dict(collections.Counter(c[1] for c in step)),
                "weights_handed": sum(c[3] for c in self.calls)}


def prefill_launches(engine):
    """A box counting ``topk_gather`` launches inside the engine's
    prefills (fused or chunked); given the ``Engine`` class, inside every
    engine's."""
    from repro_torch.kernels import topk_gather
    box = [0]
    for name in ("_prefill", "_prefill_chunk"):
        fn = getattr(engine, name)

        def counted(*a, fn=fn, **kw):
            before = topk_gather.launches
            try:
                return fn(*a, **kw)
            finally:
                box[0] += topk_gather.launches - before
        setattr(engine, name, counted)
    return box


def mesh_serve_rank(rank):
    """Phase 14 on one of four gloo ranks sharing the card, for each mesh
    of MESH_SERVE_MESHES: the f32 forced logits holding the single-device
    engine's k-WTA selections, then the bf16 forced logits with free
    selections and the bf16 engine on phase 4's workload on both layouts
    (tokens, launches, collectives, bytes, times; after a one-step
    warm-up) on the mesh's MESH_SERVE_LAYOUTS."""
    import pickle
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Engine
    from repro_torch.models import transformer as T
    from repro_torch.sharding.collectives import observe_collectives
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    single = pickle.loads((MESH_SERVE_DIR / "single.pkl").read_bytes())
    cfg = mesh_serve_cfg()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    reqs = phase4_requests(cfg.vocab_size)
    prompts = [r.prompt for r in reqs[:4]]
    out = {"rank": rank}
    warm = dataclasses.replace(reqs[0], max_new_tokens=2)
    for dims in MESH_SERVE_MESHES:
        mesh = make_mesh(dims, ("data", "model"), device)
        res = {"coords": mesh.coords, "f32_err": {}}
        whole = T.init_model(cfg32, seed=SEED, device=device)
        for layout in LAYOUTS:
            eng = Engine(cfg32, MESH_SERVE_SEQ, 4, params=whole,
                         device=device, mesh=mesh, **mesh_serve_kw(layout))
            held = iter([m.to(device) for m in single["masks"][layout]])
            with kwta_selections(held, rows=eng.shards.batch_rows(4)):
                rows = forced_logits(eng, prompts, single["forced"])
            if next(held, None) is not None:
                fail("mesh_serve: k-WTA selections left over")
            res["f32_err"][layout] = rows_err(rows, single["f32_rows"][layout])
            del eng
        del whole
        torch.cuda.empty_cache()
        whole = T.init_model(cfg, seed=SEED, device=device)
        res["same_weights"] = fingerprint(whole) == single["fingerprint"]
        eng = Engine(cfg, MESH_SERVE_SEQ, 4, params=whole, device=device,
                     mesh=mesh)
        res["bf16_move"] = rows_err(
            forced_logits(eng, prompts, single["forced"]),
            single["bf16_rows"])
        for layout in MESH_SERVE_LAYOUTS[dims]:
            eng = Engine(cfg, MESH_SERVE_SEQ, 4, params=whole, device=device,
                         mesh=mesh, **mesh_serve_kw(layout))
            eng.serve([warm])
            eng.prefill_calls = 0
            log, pre = CollectiveLog(eng), prefill_launches(eng)
            reset_counts()
            with observe_collectives(log):
                toks, stats = eng.serve(reqs)
            steps = stats["decode_steps"]
            res[layout] = {
                "tokens": toks, "steps": steps, "tok_s": stats["tok_s"],
                "step_ms": stats["decode_s"] / steps * 1e3,
                "launches": read_counts()["topk_gather"],
                "prefill_launches": pre[0],
                "collectives": log.summary(steps),
                "bytes": serving_bytes(eng),
                "reckoned": reckoned_serving_bytes(eng, whole)}
            del eng, log
        del whole
        torch.cuda.empty_cache()
        out[dims] = res
    return out


def mesh_serve_nccl(rank):
    """(f) in a process of its own: the engine on mesh 1x1 over NCCL at
    world size 1 against the engine without a mesh, phase 4's workload
    (bf16) and the forced logits, bit for bit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Engine
    from repro_torch.models import transformer as T
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mesh_serve_cfg()
    reqs = phase4_requests(cfg.vocab_size)
    forced = np.random.default_rng(SEED + 14).integers(
        0, cfg.vocab_size, (MESH_SERVE_FORCED, 4))
    params = T.init_model(cfg, seed=SEED, device=device)
    mesh = make_mesh((1, 1), ("data", "model"), device)
    toks, rows = [], []
    for m in (None, mesh):
        eng = Engine(cfg, MESH_SERVE_SEQ, 4, params=params, device=device,
                     mesh=m)
        toks.append(eng.serve(reqs)[0])
        rows.append(forced_logits(eng, [r.prompt for r in reqs[:4]], forced))
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "distributed": mesh.distributed,
            "tokens_equal": toks[0] == toks[1],
            "logits_equal": all(np.array_equal(a, b)
                                for a, b in zip(*rows, strict=True))}


def phase_mesh_serve():
    """Phase 14: the single-device references on the card, then four gloo
    ranks sharing the card on meshes (1, 4) and (2, 2), then one NCCL rank
    at world size 1."""
    import pickle
    import shutil
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.launch.serve import Engine
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    shutil.rmtree(MESH_SERVE_DIR, ignore_errors=True)
    MESH_SERVE_DIR.mkdir(parents=True)
    cfg = mesh_serve_cfg()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    reqs = phase4_requests(cfg.vocab_size)
    prompts = [r.prompt for r in reqs[:4]]
    forced = np.random.default_rng(SEED + 14).integers(
        0, cfg.vocab_size, (MESH_SERVE_FORCED, 4))
    params = T.init_model(cfg, seed=SEED, device="cuda")
    one = {}
    for layout in LAYOUTS:
        eng = Engine(cfg, MESH_SERVE_SEQ, 4, params=params, device="cuda",
                     **mesh_serve_kw(layout))
        eng.serve([dataclasses.replace(reqs[0], max_new_tokens=2)])
        toks, stats = eng.serve(reqs)
        one[layout] = {"tokens": toks, "tok_s": stats["tok_s"],
                       "step_ms": stats["decode_s"] / stats["decode_steps"]
                       * 1e3, "bytes": serving_bytes(eng)}
    single = {"forced": forced, "fingerprint": fingerprint(params),
              "bf16_rows": forced_logits(
                  Engine(cfg, MESH_SERVE_SEQ, 4, params=params,
                         device="cuda"), prompts, forced),
              "f32_rows": {}, "masks": {}}
    params32 = T.init_model(cfg32, seed=SEED, device="cuda")
    for layout in LAYOUTS:
        eng = Engine(cfg32, MESH_SERVE_SEQ, 4, params=params32,
                     device="cuda", **mesh_serve_kw(layout))
        with kwta_selections() as masks:
            single["f32_rows"][layout] = forced_logits(eng, prompts, forced)
        single["masks"][layout] = [m.cpu() for m in masks]
    del params32, eng
    torch.cuda.empty_cache()
    (MESH_SERVE_DIR / "single.pkl").write_bytes(pickle.dumps(single))
    t_single = time.perf_counter() - t0
    # (f) in its own process beside the gloo ranks, which start with
    # their untimed f32 checks
    done = {}

    def nccl_rank():
        t = time.perf_counter()
        try:
            done["nccl"] = run_ranks(mesh_serve_nccl, 1,
                                     MESH_SERVE_DIR / "nccl",
                                     backend="nccl", timeout_s=600)[0]
        except BaseException as e:      # raised again below, in this thread
            done["error"] = e
        done["s"] = time.perf_counter() - t

    side = threading.Thread(target=nccl_rank)
    side.start()
    t = time.perf_counter()
    try:
        ranks = run_ranks(mesh_serve_rank, 4, MESH_SERVE_DIR / "ranks",
                          backend="gloo", timeout_s=600, threads=2)
    finally:
        side.join()
    t_gloo = time.perf_counter() - t
    if "error" in done:
        raise done["error"]
    nccl, t_nccl = done["nccl"], done["s"]
    failed = []
    logits_bytes = 4 * cfg.padded_vocab * 2
    print(f"[mesh-serve] smollm-360m at full width, cut to {cfg.n_layers} "
          f"layers of 32 (d_model 960, "
          f"15 heads on 5 kv heads, d_ff 2560, vocab {cfg.vocab_size}), "
          f"random weights from seed {SEED}, phase 4's workload (8 requests "
          f"on 4 slots, prompt 16, gen 16), max_seq {MESH_SERVE_SEQ}; four "
          f"gloo ranks sharing the card: {device_line()}")
    numbers = {"single": {k: {"tok_s": v["tok_s"], "step_ms": v["step_ms"],
                              "bytes": v["bytes"]} for k, v in one.items()}}
    for dims in MESH_SERVE_MESHES:
        name = "x".join(map(str, dims))
        rs = [r[dims] for r in ranks]
        if not all(r["same_weights"] for r in rs):
            failed.append(f"{name}: a rank drew other weights")
        errs = {lay: max(r["f32_err"][lay] for r in rs) for lay in LAYOUTS}
        print(f"[mesh-serve] {name} (a) f32, prefills and "
              f"{MESH_SERVE_FORCED} forced decode steps holding the "
              f"single-device k-WTA selections: largest |logits - single| "
              f"contiguous {errs['contiguous']:.3e}, paged "
              f"{errs['paged']:.3e} (tol {MESH_SERVE_TOL:.0e})")
        if not max(errs.values()) <= MESH_SERVE_TOL:
            failed.append(f"{name}: f32 logits part from the single device")
        move = max(r["bf16_move"] for r in rs)
        margin = max(TIE_MARGIN, 2 * move)
        numbers[name] = {"f32_err": errs, "bf16_move": move}
        for layout in MESH_SERVE_LAYOUTS[dims]:
            got = [r[layout] for r in rs]
            if any(g["tokens"] != got[0]["tokens"] for g in got):
                failed.append(f"{name} {layout}: ranks sampled other tokens")
            parted = same_tokens(cfg, params, reqs, one[layout]["tokens"],
                                 got[0]["tokens"], f"{name} {layout}",
                                 phase="mesh-serve", margin=margin)
            print(f"[mesh-serve] {name} {layout} (b) bf16 tokens against the "
                  f"single-device engine: {len(reqs) - parted} requests "
                  f"identical, {parted} parted at a tie of the top two "
                  f"(bound {margin:.3e}: twice the largest bf16 forced-logits "
                  f"difference {move:.3e}, at least {TIE_MARGIN:.0e}); every "
                  f"rank the same tokens "
                  f"{all(g['tokens'] == got[0]['tokens'] for g in got)}")
            per_step = [g["launches"] / g["steps"] for g in got]
            print(f"[mesh-serve] {name} {layout} (c) topk_gather launches a "
                  f"decode step on each rank {per_step}, in the prefills "
                  f"{[g['prefill_launches'] for g in got]}")
            if any(p != cfg.n_layers for p in per_step) or any(
                    g["prefill_launches"] for g in got):
                failed.append(f"{name} {layout}: topk_gather launches")
            for r, g in zip(rs, got):
                print(f"[mesh-serve] {name} {layout} (d) rank {r['coords']}: "
                      f"param bytes {g['bytes'][0]} (reckoned from the specs "
                      f"{g['reckoned'][0]}; single device "
                      f"{one[layout]['bytes'][0]}), partition-major copies "
                      f"{g['bytes'][1]} (single {one[layout]['bytes'][1]}), "
                      f"cache bytes {g['bytes'][2]} (reckoned "
                      f"{g['reckoned'][1]}; single {one[layout]['bytes'][2]})")
                if (g["bytes"][0], g["bytes"][2]) != tuple(g["reckoned"]):
                    failed.append(f"{name} {layout}: a rank's bytes are not "
                                  "its reckoned block's")
            c = got[0]["collectives"]
            print(f"[mesh-serve] {name} {layout} (e) a decode step's "
                  f"collectives: {c['per_step']:.1f} ({c['ops']} in all "
                  f"steps), {c['bytes_per_step'] / 1e3:.1f} kB, the largest "
                  f"{c['largest'][0]} of {c['largest'][1]} B (the (4, "
                  f"{cfg.padded_vocab}) bf16 logits are {logits_bytes} B); "
                  f"tensors handed over that are a param or cache block: "
                  f"{[g['collectives']['weights_handed'] for g in got]}")
            if any(g["collectives"]["weights_handed"] for g in got) or any(
                    g["collectives"]["largest"] != ["all_gather",
                                                    logits_bytes]
                    for g in got):
                failed.append(f"{name} {layout}: a collective moved a "
                              "weight or more than the logits")
            print(f"[mesh-serve] {name} {layout} host clock: "
                  f"{got[0]['tok_s']:.2f} tok/s, decode step "
                  f"{got[0]['step_ms']:.2f} ms (single device "
                  f"{one[layout]['tok_s']:.2f} tok/s, "
                  f"{one[layout]['step_ms']:.2f} ms)")
            numbers[name][layout] = {
                "tok_s": got[0]["tok_s"], "step_ms": got[0]["step_ms"],
                "parted": parted, "launches_per_step": per_step[0],
                "collectives": c, "bytes": [g["bytes"] for g in got]}
    print(f"[mesh-serve] (f) mesh 1x1 over {nccl['backend']} at world size "
          f"{nccl['world']} (process group up: {nccl['distributed']}) against "
          f"the engine without a mesh: tokens bit-equal "
          f"{nccl['tokens_equal']}, forced logits bit-equal "
          f"{nccl['logits_equal']}")
    if not (nccl["tokens_equal"] and nccl["logits_equal"]
            and nccl["distributed"]):
        failed.append("the 1x1 mesh over NCCL parts from the plain engine")
    numbers.update(single_s=t_single, gloo_s=t_gloo, nccl_s=t_nccl,
                   phase_s=time.perf_counter() - t0)
    print(f"[mesh-serve] numbers {json.dumps(numbers)}")
    shutil.rmtree(MESH_SERVE_DIR, ignore_errors=True)
    if failed:
        fail("mesh-serve: " + "; ".join(failed))
    return {"launches_mesh_per_decode_step": numbers["2x2"]["contiguous"][
        "launches_per_step"]}


# ---------------------------------------------------------------------------
# phase 15: the MoE + MLA family served on a mesh
# ---------------------------------------------------------------------------

MESH_MOE_DIR = ROOT / "build" / "mesh_moe"
#: the shared experts' decode down projection on a rank of 2x2's
#: contiguous layout (2 slots a rank): B=2, K=352, P=704, G=512, N=4
MESH_MOE_SHAPE = dict(MOE_SHAPE, b=2)
#: the depth of check (a), in float32 (27 shipped): a decode step of
#: four gloo ranks on one card takes ~2 s at full depth, most of it their
#: ~160 collectives
MESH_MOE_F32_LAYERS = 2
#: the depth of checks (b)-(f), in bf16 (27 shipped), cut as phase 14's
#: is to keep the script within its time limit
MESH_MOE_LAYERS = 2
#: the tokens of the single-device serve's logits kept at every step, to
#: tell a tie from a parting
MESH_MOE_TOPS = 8


def mesh_moe_cfg():
    """deepseek-v2-lite-16b at its shipped widths, MESH_MOE_LAYERS deep."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=MESH_MOE_LAYERS)


@contextlib.contextmanager
def sampled_tops(k=MESH_MOE_TOPS):
    """Record, for every token an engine's serve samples inside, the k
    largest logits of the row it was sampled from (tokens and values,
    largest first), by request uid in token order."""
    serve = importlib.import_module("repro_torch.launch.serve")
    sched = importlib.import_module("repro_torch.runtime.scheduler")
    sample, record = serve.sample_token, sched.Scheduler.record_token
    last, tops = [], collections.defaultdict(list)

    def spy_sample(logits, params, rng):
        top = np.argsort(-logits, kind="stable")[:k]
        last[:] = [([int(t) for t in top], [float(logits[t]) for t in top])]
        return sample(logits, params, rng)

    def spy_record(self, slot, token, *a, **kw):
        tops[slot.request.uid].append(last[0])
        return record(self, slot, token, *a, **kw)

    serve.sample_token, sched.Scheduler.record_token = spy_sample, spy_record
    try:
        yield tops
    finally:
        serve.sample_token, sched.Scheduler.record_token = sample, record


def tied_tokens(reqs, want_out, got_out, tops, label, margin):
    """``got_out`` against the single-device serve's ``want_out``: equal,
    or parted only at a tie: the single run's logit of the other token
    lies within ``margin`` of its largest at that step (phase 14's
    top-two rule, a tie of three or more tokens counted as one).  ``tops``: the
    single run's :func:`sampled_tops`.  Returns the requests parted."""
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
        toks, vals = tops[req.uid][part]
        place = toks.index(got[part]) if got[part] in toks else None
        gap = math.inf if place is None else vals[0] - vals[place]
        print(f"[mesh-moe] {label}: request {req.uid} parts at step {part}: "
              f"{want[part]} -> {got[part]}, the single run's "
              f"{'#' + str(place + 1) if place is not None else 'beyond #' + str(len(toks))} "
              f"token, {gap:.3e} below its largest logit (bound "
              f"{margin:.3e})")
        if toks[0] != want[part] or not gap < margin:
            fail(f"{label}: request {req.uid} differs at step {part} "
                 "beyond a tie")
        parted += 1
    return parted


def moe_fingerprint(params):
    """Sums of leaves every rank holds whole (``dkv``, the shared experts'
    down projection, the final norm): two processes drew the same
    weights."""
    layer = params["layers"][-1]
    return [float(layer["mixer"]["dkv"].double().sum()),
            float(layer["moe"]["shared"]["down"]["packed"].double().sum()),
            float(params["final_norm"]["scale"].double().sum())]


def mesh_moe_rank(rank):
    """Phase 15 on one of four gloo ranks sharing the card, for each mesh
    of MESH_SERVE_MESHES: each engine draws only the rank's blocks of
    seed 0's weights, a layer at a time.  The f32 forced logits of both
    layouts (MESH_MOE_F32_LAYERS deep) holding the single-device engine's
    k-WTA selections and router choices, then at full depth the bf16
    forced logits with free selections and the bf16 engine on phase 4's
    workload on both layouts (tokens, launches, collectives, bytes,
    times; after a warm-up of one request)."""
    import pickle
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Engine
    from repro_torch.sharding.collectives import observe_collectives
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    single = pickle.loads((MESH_MOE_DIR / "single.pkl").read_bytes())
    cfg = mesh_moe_cfg()
    cfg32 = dataclasses.replace(get_config(MOE_ARCH), compute_dtype="float32",
                                n_layers=MESH_MOE_F32_LAYERS)
    reqs = phase4_requests(cfg.vocab_size)
    prompts = [r.prompt for r in reqs[:4]]
    warm = dataclasses.replace(reqs[0], max_new_tokens=2)
    out = {"rank": rank}
    for dims in MESH_SERVE_MESHES:
        mesh = make_mesh(dims, ("data", "model"), device)
        res = {"coords": mesh.coords, "f32_err": {}}
        torch.cuda.reset_peak_memory_stats()
        for layout in LAYOUTS:
            t = time.perf_counter()
            eng = Engine(cfg32, MESH_SERVE_SEQ, 4, device=device, mesh=mesh,
                         **mesh_serve_kw(layout))
            torch.cuda.synchronize()
            res["init_s"] = time.perf_counter() - t
            rows = eng.shards.batch_rows(4)
            held = iter([m.to(device) for m in single["masks"][layout]])
            chosen = iter([c.to(device) for c in single["choices"][layout]])
            with kwta_selections(held, rows=rows, experts=eng.shards.block(
                    "model", cfg.n_experts)), \
                    router_choices(chosen, rows=rows):
                got = forced_logits(eng, prompts, single["forced"])
            if next(held, None) is not None or \
                    next(chosen, None) is not None:
                fail("mesh-moe: k-WTA selections or router choices left "
                     "over")
            res["f32_err"][layout] = rows_err(got,
                                              single["f32_rows"][layout])
            del eng
        torch.cuda.empty_cache()
        eng = Engine(cfg, MESH_SERVE_SEQ, 4, device=device, mesh=mesh)
        res["same_weights"] = moe_fingerprint(eng.params) == \
            single["fingerprint"]
        res["bf16_move"] = rows_err(
            forced_logits(eng, prompts, single["forced"]),
            single["bf16_rows"])
        del eng
        for layout in LAYOUTS:
            eng = Engine(cfg, MESH_SERVE_SEQ, 4, device=device, mesh=mesh,
                         **mesh_serve_kw(layout))
            eng.serve([warm])
            eng.prefill_calls = 0
            log, pre = CollectiveLog(eng), prefill_launches(eng)
            reset_counts()
            with observe_collectives(log):
                toks, stats = eng.serve(reqs)
            steps = stats["decode_steps"]
            res[layout] = {
                "tokens": toks, "steps": steps, "tok_s": stats["tok_s"],
                "step_ms": stats["decode_s"] / steps * 1e3,
                "prefill_calls": stats["prefill_calls"],
                "launches": read_counts()["topk_gather"],
                "prefill_launches": pre[0],
                "collectives": log.summary(steps),
                "bytes": serving_bytes(eng)}
            del eng, log
        res["peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        out[dims] = res
    return out


def moe_single(cfg, reqs, forced):
    """The single-device references of phase 15 on the card: the bf16
    engine on phase 4's workload on both layouts (with each sampled row's
    largest logits) and its forced logits, the reckoned per-rank bytes of
    each mesh and layout, then the f32 forced logits of both layouts
    (MESH_MOE_F32_LAYERS deep) with their k-WTA selections and router
    choices (pickled for the ranks).  Returns the bf16 engine's numbers by
    layout and the reckoned bytes by (mesh, layout)."""
    import pickle
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.serve import Engine
    from repro_torch.models import transformer as T
    from repro_torch.sharding import make_rules
    prompts = [r.prompt for r in reqs[:4]]
    params = T.init_model(cfg, seed=SEED, device="cuda")
    one, reckoned = {}, {}
    for layout in LAYOUTS:
        eng = Engine(cfg, MESH_SERVE_SEQ, 4, params=params, device="cuda",
                     **mesh_serve_kw(layout))
        eng.serve([dataclasses.replace(reqs[0], max_new_tokens=2)])
        with sampled_tops() as tops:
            toks, stats = eng.serve(reqs)
        one[layout] = {"tokens": toks, "tops": tops,
                       "tok_s": stats["tok_s"],
                       "step_ms": stats["decode_s"] / stats["decode_steps"]
                       * 1e3, "bytes": serving_bytes(eng)}
        for dims in MESH_SERVE_MESHES:
            rules = make_rules(Mesh(dims, ("data", "model"),
                                    torch.device("cuda")), "decode")
            reckoned[dims, layout] = reckoned_serving_bytes(eng, params,
                                                            rules)
    single = {"forced": forced, "fingerprint": moe_fingerprint(params),
              "bf16_rows": forced_logits(
                  Engine(cfg, MESH_SERVE_SEQ, 4, params=params,
                         device="cuda"), prompts, forced),
              "f32_rows": {}, "masks": {}, "choices": {}}
    del params, eng
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                n_layers=MESH_MOE_F32_LAYERS)
    params = T.init_model(cfg32, seed=SEED, device="cuda")
    for layout in LAYOUTS:
        eng = Engine(cfg32, MESH_SERVE_SEQ, 4, params=params, device="cuda",
                     **mesh_serve_kw(layout))
        with kwta_selections() as masks, router_choices() as choices:
            single["f32_rows"][layout] = forced_logits(eng, prompts, forced)
        single["masks"][layout] = [m.cpu() for m in masks]
        single["choices"][layout] = [c.cpu() for c in choices]
    del params, eng
    torch.cuda.empty_cache()
    (MESH_MOE_DIR / "single.pkl").write_bytes(pickle.dumps(single))
    return one, reckoned


def phase_mesh_moe():
    """Phase 15: the single-device references on the card, then four gloo
    ranks sharing the card on meshes (1, 4) and (2, 2), both layouts;
    then ``topk_gather`` at the ranks' decode shapes."""
    import shutil
    from repro_torch.launch.ranks import run_ranks
    t0 = time.perf_counter()
    shutil.rmtree(MESH_MOE_DIR, ignore_errors=True)
    MESH_MOE_DIR.mkdir(parents=True)
    cfg = mesh_moe_cfg()
    reqs = phase4_requests(cfg.vocab_size)
    forced = np.random.default_rng(SEED + 15).integers(
        0, cfg.vocab_size, (MESH_SERVE_FORCED, 4))
    one, reckoned = moe_single(cfg, reqs, forced)
    t_single = time.perf_counter() - t0
    t = time.perf_counter()
    ranks = run_ranks(mesh_moe_rank, 4, MESH_MOE_DIR / "ranks",
                      backend="gloo", timeout_s=900, threads=1)
    t_gloo = time.perf_counter() - t
    failed = []
    logits_bytes = 4 * cfg.padded_vocab * 2
    print(f"[mesh-moe] {MOE_ARCH} at full width, cut to {cfg.n_layers} of "
          f"27 layers in bf16 (d_model {cfg.d_model}, MLA {cfg.n_heads} "
          f"heads on "
          f"kv_lora {cfg.kv_lora_rank}, {cfg.n_experts} routed experts "
          f"top-{cfg.experts_per_token} + {cfg.n_shared_experts} shared, "
          f"vocab {cfg.vocab_size}), bf16, random weights from seed {SEED}, "
          f"phase 4's workload (8 requests on 4 slots, prompt 16, gen 16), "
          f"max_seq {MESH_SERVE_SEQ}; four gloo ranks sharing the card: "
          f"{device_line()}")
    numbers = {"single": {k: {"tok_s": v["tok_s"], "step_ms": v["step_ms"],
                              "bytes": v["bytes"]} for k, v in one.items()}}
    for layout in LAYOUTS:
        print(f"[mesh-moe] single device {layout}: {one[layout]['tok_s']:.2f}"
              f" tok/s, decode step {one[layout]['step_ms']:.2f} ms (host "
              f"clock), param bytes {one[layout]['bytes'][0]}, cache bytes "
              f"{one[layout]['bytes'][2]}")
    for dims in MESH_SERVE_MESHES:
        name = "x".join(map(str, dims))
        rs = [r[dims] for r in ranks]
        if not all(r["same_weights"] for r in rs):
            failed.append(f"{name}: a rank drew other weights")
        errs = {lay: max(r["f32_err"][lay] for r in rs) for lay in LAYOUTS}
        print(f"[mesh-moe] {name} (a) f32, {MESH_MOE_F32_LAYERS} layers, 4 "
              f"prompts prefilled and "
              f"{MESH_SERVE_FORCED} forced decode steps holding the "
              f"single-device k-WTA selections and router choices: largest "
              f"|logits - single| contiguous {errs['contiguous']:.3e}, paged "
              f"{errs['paged']:.3e} (tol {MESH_SERVE_TOL:.0e}); each rank "
              f"drew its f32 blocks in "
              f"{max(r['init_s'] for r in rs):.1f} s at most, peak "
              f"{max(r['peak'] for r in rs) / 2**30:.2f} GiB a rank")
        if not max(errs.values()) <= MESH_SERVE_TOL:
            failed.append(f"{name}: f32 logits part from the single device")
        move = max(r["bf16_move"] for r in rs)
        margin = max(TIE_MARGIN, 2 * move)
        numbers[name] = {"f32_err": errs, "bf16_move": move}
        for layout in LAYOUTS:
            got = [r[layout] for r in rs]
            if any(g["tokens"] != got[0]["tokens"] for g in got):
                failed.append(f"{name} {layout}: ranks sampled other tokens")
            if any(g["prefill_calls"] != len(reqs) for g in got):
                failed.append(f"{name} {layout}: prefill calls "
                              f"{[g['prefill_calls'] for g in got]}")
            parted = tied_tokens(reqs, one[layout]["tokens"],
                                 got[0]["tokens"], one[layout]["tops"],
                                 f"{name} {layout}", margin)
            print(f"[mesh-moe] {name} {layout} (b) bf16 tokens against the "
                  f"single-device engine: {len(reqs) - parted} requests "
                  f"identical, {parted} parted at a tie "
                  f"(bound {margin:.3e}: twice the largest bf16 forced-logits "
                  f"difference {move:.3e}, at least {TIE_MARGIN:.0e}); every "
                  f"rank the same tokens "
                  f"{all(g['tokens'] == got[0]['tokens'] for g in got)}")
            for r, g in zip(rs, got):
                want = reckoned[dims, layout]
                print(f"[mesh-moe] {name} {layout} (c) rank {r['coords']}: "
                      f"param bytes {g['bytes'][0]} (reckoned from the specs "
                      f"{want[0]}; single device {one[layout]['bytes'][0]}), "
                      f"partition-major copies {g['bytes'][1]} (single "
                      f"{one[layout]['bytes'][1]}), cache bytes "
                      f"{g['bytes'][2]} (reckoned {want[1]}; single "
                      f"{one[layout]['bytes'][2]})")
                if (g["bytes"][0], g["bytes"][2]) != tuple(want):
                    failed.append(f"{name} {layout}: a rank's bytes are not "
                                  "its reckoned block's")
            per_step = [g["launches"] / g["steps"] for g in got]
            print(f"[mesh-moe] {name} {layout} (d) topk_gather launches a "
                  f"decode step on each rank {per_step}, in the prefills "
                  f"{[g['prefill_launches'] for g in got]}")
            if any(p != cfg.n_layers for p in per_step) or any(
                    g["prefill_launches"] for g in got):
                failed.append(f"{name} {layout}: topk_gather launches")
            c = got[0]["collectives"]
            print(f"[mesh-moe] {name} {layout} (e) a decode step's "
                  f"collectives: {c['per_step']:.1f} ({c['ops']} in all "
                  f"steps), {c['bytes_per_step'] / 1e3:.1f} kB, the largest "
                  f"{c['largest'][0]} of {c['largest'][1]} B (the (4, "
                  f"{cfg.padded_vocab}) bf16 logits are {logits_bytes} B); "
                  f"tensors handed over that are a param or cache block: "
                  f"{[g['collectives']['weights_handed'] for g in got]}")
            if any(g["collectives"]["weights_handed"] for g in got) or any(
                    g["collectives"]["largest"] != ["all_gather",
                                                    logits_bytes]
                    for g in got):
                failed.append(f"{name} {layout}: a collective moved a "
                              "weight or more than the logits")
            print(f"[mesh-moe] {name} {layout} (f) host clock: "
                  f"{got[0]['tok_s']:.2f} tok/s, decode step "
                  f"{got[0]['step_ms']:.2f} ms (single device "
                  f"{one[layout]['tok_s']:.2f} tok/s, "
                  f"{one[layout]['step_ms']:.2f} ms); no claim")
            numbers[name][layout] = {
                "tok_s": got[0]["tok_s"], "step_ms": got[0]["step_ms"],
                "parted": parted, "launches_per_step": per_step[0],
                "collectives": c, "bytes": [g["bytes"] for g in got]}
    shape_4 = moe_kernel(MOE_SHAPE, "mesh-moe")
    keys = moe_kernel(MESH_MOE_SHAPE, "mesh-moe")
    numbers.update(single_s=t_single, gloo_s=t_gloo,
                   phase_s=time.perf_counter() - t0)
    print(f"[mesh-moe] numbers {json.dumps(numbers)}")
    shutil.rmtree(MESH_MOE_DIR, ignore_errors=True)
    if failed:
        fail("mesh-moe: " + "; ".join(failed))
    return {"mesh_moe_shape": keys,
            "mesh_moe_max_abs_err": max(keys["max_abs_err"],
                                        shape_4["max_abs_err"]),
            "launches_mesh_moe_per_decode_step": numbers["2x2"][
                "contiguous"]["launches_per_step"]}


# ---------------------------------------------------------------------------
# phase 16: the census and roofline of the decode step, and the dry run
# ---------------------------------------------------------------------------

# The dry run's cells on 16x16 traced here on fake CUDA tensors.
ROOFLINE_CELLS = (("smollm_360m", "decode_32k"),
                  ("deepseek_v2_lite_16b", "decode_32k"),
                  ("qwen3_moe_235b_a22b", "decode_32k"),
                  ("zamba2_1p2b", "long_500k"))
# A share of the step's bound above this means the count is wrong.
SHARE_LIMIT = 1.05


def module_bounds(cfg, kernel_rows):
    """Rows 1-4 of the kernels line: each kernel's bound from its module's
    cost formula (shapes and types alone) at the shape its row's bound was
    taken at, beside the row's (``topk_gather``'s counts the partitions
    the support touches).  The module's must be no smaller."""
    from repro_torch.launch.roofline import kernel_bound
    # the modules (the package's attributes of these names are the wrappers)
    topk_gather, packed_matmul, grouped_cs_matmul, kwta_hist = (
        importlib.import_module(f"repro_torch.kernels.{m}") for m in (
            "topk_gather", "packed_matmul", "grouped_cs_matmul",
            "kwta_hist"))
    bf16, f32 = torch.bfloat16, torch.float32
    b, k, p, g, n, r = (MAIN_SHAPE[x] for x in "bkpgnr")
    t, d, ff = TIMED_TOKENS, cfg.d_model, cfg.d_ff
    n4 = cfg.ffn_sparsity.n
    costs = {   # the up projection (d_model -> d_ff) at T=128, one route
        "topk_gather": topk_gather.cost(b, k, p, g, n, r, f32, torch.int32,
                                        bf16, f32),
        "packed_matmul": packed_matmul.cost(t, d // n4, ff // n4, n4,
                                            ff // n4, bf16, bf16),
        "grouped_cs_matmul": grouped_cs_matmul.cost(n4, t, d // n4,
                                                    ff // n4, bf16, bf16),
        "kwta_hist": kwta_hist.cost(t, ff, bf16)}
    out = {}
    for row in kernel_rows:
        if row["name"] not in costs:
            continue
        sec, by = kernel_bound(costs[row["name"]])
        out[row["name"]] = {"module_bound_ms": 1e3 * sec, "module_by": by,
                            "table_bound_ms": row["bound_ms"]}
        print(f"[roofline] {row['name']}: module bound {1e3 * sec:.6f} ms "
              f"({by}), the table's {row['bound_ms']:.6f} ms "
              f"({row['bound_by']})")
        if 1e3 * sec < row["bound_ms"] * (1 - 1e-9):
            fail(f"{row['name']}: the module's bound is below the table's")
    return out


def phase_roofline(kernel_rows):
    """(a) the census of phase 4's decode step on the card, equal to a
    fake-CUDA trace of it; (b) its bound and its shares of phase 4's
    device-alone and host-clock step; (c) rows 1-4's bounds from the
    modules; (d) the dry run of three decode_32k cells and zamba2's
    long_500k on 16x16."""
    from repro_torch.launch.dryrun import compile_cell
    from repro_torch.launch.hlo import census
    from repro_torch.launch.roofline import cell_roofline
    from repro_torch.launch.serve import Engine
    from repro_torch.tree import fake
    from repro_torch.models import transformer as T
    cfg = smollm_config()
    engine = Engine(cfg, max_seq=33, n_slots=4, device="cuda")

    def step(p, c, b, q):
        return T.serve_step(p, c, b, q, cfg)[0]

    args = decode_args(engine)[:4]
    with torch.no_grad():
        step(*args)
        torch.cuda.synchronize()
        reset_counts()
        real = census(step, *args)
        torch.cuda.synchronize()
        launches = read_counts()["topk_gather"]
        traced = census(step, *fake(lambda: decode_args(engine)[:4],
                                    "cuda"))
    ops, cost = real["ops"], real["cost"]
    print(f"[roofline] census of the bf16 decode step on the card: "
          f"{cost['flops']:.0f} flops ({cost['flops_bf16']:.0f} on the "
          f"tensor cores), {cost['bytes_accessed']:.0f} bytes, "
          f"{ops['total']} ops, {ops.get('repro_torch.topk_gather', 0)} "
          f"topk_gather nodes ({launches} launches), host transfers "
          f"{real['host_transfers']}, collectives {real['collectives']}")
    if ops.get("repro_torch.topk_gather") != cfg.n_layers or \
            launches != cfg.n_layers:
        fail(f"the census holds {ops.get('repro_torch.topk_gather')} "
             f"topk_gather nodes and {launches} launches, want "
             f"{cfg.n_layers}")
    if real["host_transfers"] or real["collectives"]["total_bytes"]:
        fail("the decode step moves data to the host or to other ranks")
    for key in ("flops", "flops_bf16", "bytes_accessed"):
        if real["cost"][key] != traced["cost"][key]:
            fail(f"{key}: the card's step counts {real['cost'][key]}, its "
                 f"fake-CUDA trace {traced['cost'][key]}")
    for key in ("argument_read_bytes", "argument_written_bytes",
                "output_bytes"):
        if real["memory"][key] != traced["memory"][key]:
            fail(f"{key}: the card's step counts {real['memory'][key]}, "
                 f"its fake-CUDA trace {traced['memory'][key]}")
    print("[roofline] the fake-CUDA trace counts the same flops and bytes")
    rec = {"ok": True, "kind": "decode", "mesh": "1x1",
           "n_units": cfg.n_units, "seq_len": engine.max_seq,
           "global_batch": engine.n_slots, "full": real}
    roof = cell_roofline(rec, cfg)
    bound_ms = 1e3 * roof["bound_s"]
    floor_ms = 1e3 * roof["floor_s"]
    shares = {k: bound_ms / SERVE_STEP_MS[k] for k in ("device", "host")}
    floor_shares = {k: floor_ms / SERVE_STEP_MS[k]
                    for k in ("device", "host")}
    print(f"[roofline] the step's bound on its eager traffic "
          f"{bound_ms:.6f} ms ({roof['bottleneck']}: compute "
          f"{1e3 * roof['compute_s']:.6f}, memory "
          f"{1e3 * roof['memory_s']:.6f}, collective "
          f"{1e3 * roof['collective_s']:.6f} ms); share of phase 4's step "
          f"on the device alone ({SERVE_STEP_MS['device']:.3f} ms) "
          f"{shares['device']:.5f}, of its host-clock step "
          f"({SERVE_STEP_MS['host']:.3f} ms) {shares['host']:.5f}")
    print(f"[roofline] the step's floor (each byte it reads of its "
          f"arguments, writes in them and outputs, moved once: "
          f"{roof['io_bytes_per_chip']:.0f} bytes) {floor_ms:.6f} ms; "
          f"share of the device-alone step {floor_shares['device']:.5f}, "
          f"of the host-clock step {floor_shares['host']:.5f}")
    if not all(0 < v <= SHARE_LIMIT for v in (*shares.values(),
                                              *floor_shares.values())):
        fail(f"a share of the step's bound lies outside (0, {SHARE_LIMIT}]: "
             "the count is wrong")
    if roof["io_bytes_per_chip"] > roof["bytes_per_chip"]:
        fail("the step's floor moves more bytes than its eager ops")
    del engine
    torch.cuda.empty_cache()
    bounds = module_bounds(cfg, kernel_rows)
    cells = {}
    for arch, shape in ROOFLINE_CELLS:
        t = time.perf_counter()
        cell = compile_cell(arch, shape, False, accounting=False,
                            device="cuda")
        mem = cell["full"]["memory"]
        key = f"{arch}|{shape}"
        cells[key] = {"argument_bytes": mem["argument_bytes"],
                      "peak_bytes_est": mem["peak_bytes_est"],
                      "bound_ms": 1e3 * cell_roofline(cell)["bound_s"],
                      "flops": cell["full"]["cost"]["flops"],
                      "collectives": cell["full"]["collectives"],
                      "seconds": time.perf_counter() - t}
        print(f"[roofline] dry run {arch} {shape} on 16x16 (fake CUDA "
              f"tensors): a rank holds {mem['argument_bytes'] / 1e9:.3f} GB "
              f"of params and cache, peak {mem['peak_bytes_est'] / 1e9:.3f} "
              f"GB, bound {cells[key]['bound_ms']:.3f} ms, collectives "
              f"{cell['full']['collectives']} "
              f"({cells[key]['seconds']:.1f} s)")
    print("[roofline] numbers " + json.dumps({
        "decode_step": {"flops": cost["flops"],
                        "flops_bf16": cost["flops_bf16"],
                        "bytes": cost["bytes_accessed"],
                        "ops": ops["total"], "bound_ms": bound_ms,
                        "bottleneck": roof["bottleneck"],
                        "io_bytes": roof["io_bytes_per_chip"],
                        "floor_ms": floor_ms,
                        "floor_share_device": floor_shares["device"],
                        "floor_share_host": floor_shares["host"],
                        "device_ms": SERVE_STEP_MS["device"],
                        "host_ms": SERVE_STEP_MS["host"],
                        "share_device": shares["device"],
                        "share_host": shares["host"],
                        "peak_bytes_est": real["memory"]["peak_bytes_est"]},
        "kernels": bounds, "dry_run": cells}))


# ---------------------------------------------------------------------------
# phase 17: the SSM/hybrid patterns served on a mesh
# ---------------------------------------------------------------------------

MESH_SSM_DIR = ROOT / "build" / "mesh_ssm"
XLSTM_ARCH = "xlstm-350m"
#: (b): generate_static of 4 prompts of this many tokens and as many new
MESH_SSM_PROMPT = MESH_SSM_GEN = 8
#: (a): one unit of zamba2 (18 Mamba2 blocks and the shared block) in
#: float32, the prompt stepped through, then this many forced steps
MESH_SSM_F32_LAYERS, MESH_SSM_FORCED = 19, 3
#: max_seq of (a) and (b): a multiple of 4, so the shared attention's
#: cache rows shard over ``model`` (its sharded softmax runs)
MESH_SSM_SEQ = 20
#: (g): xlstm-350m's prompts and new tokens
MESH_SSM_XLSTM_PROMPT = MESH_SSM_XLSTM_GEN = 4
#: (b) and (g): the largest bf16 logit difference between the mesh and
#: the single device on equal inputs (every step before a row's first
#: parting), and the tie margin of a parted token: fixed at about twice
#: the differences the sound runs showed on an H100 (zamba2 0.2129 on
#: 2x2, xlstm 0.0615 on 1x4), so a fault that widens the difference
#: cannot widen its own bound
MESH_SSM_GAP = {"zamba2": 0.43, "xlstm": 0.125}


def ssm_cfgs():
    """zamba2-1.2b and xlstm-350m as shipped (bf16), and (a)'s float32
    zamba2 cut to one unit."""
    from repro_torch.configs import get_config
    cfg = get_config(HYBRID_ARCH)
    return (cfg, get_config(XLSTM_ARCH),
            dataclasses.replace(cfg, compute_dtype="float32",
                                n_layers=MESH_SSM_F32_LAYERS))


def ssm_tokens(cfg, xcfg):
    """(a)'s and (b)'s prompts and forced tokens, (g)'s prompts."""
    rng = np.random.default_rng(SEED + 17)
    return (rng.integers(0, cfg.vocab_size,
                         (4, MESH_SSM_PROMPT + MESH_SSM_FORCED)),
            rng.integers(0, xcfg.vocab_size, (4, MESH_SSM_XLSTM_PROMPT)))


def stepped_logits(engine, toks):
    """Every column of ``toks`` (4, S) stepped through ``serve_step`` from
    a fresh cache on the engine's mesh: the logits of each step, float32
    host tensors."""
    from repro_torch.models import transformer as T
    toks = torch.from_numpy(toks).to(engine.device)
    rows = []
    with torch.no_grad(), engine.on_mesh():
        cache = engine.new_cache(toks.shape[0])
        for pos in range(toks.shape[1]):
            logits, cache = T.serve_step(engine.params, cache,
                                         {"tokens": toks[:, pos:pos + 1]},
                                         pos, engine.cfg)
            rows.append(logits.float().cpu())
    return rows


def static_run(engine, prompts, gen, log=None):
    """``generate_static`` after a short warm-up, the counts set to 0 just
    before: tokens, the logits of every step (host), the host-clock step,
    ``topk_gather`` launches, and (with ``log``, a :class:`CollectiveLog`)
    the collectives of the run."""
    from repro_torch.sharding.collectives import observe_collectives
    engine.generate_static(prompts[:, :2], 2)
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.ExitStack() as stack:
        rows = stack.enter_context(step_logits())
        if log is not None:
            log.in_step = True
            stack.enter_context(observe_collectives(log))
        t = time.perf_counter()
        toks = engine.generate_static(prompts, gen)
        wall = time.perf_counter() - t
    steps = prompts.shape[1] + gen
    return {"tokens": toks, "rows": [r.float().cpu() for r in rows],
            "step_ms": wall / steps * 1e3,
            "tok_s": prompts.shape[0] * gen / wall,
            "launches": read_counts()["topk_gather"], "steps": steps,
            "collectives": None if log is None else log.summary(steps)}


def mesh_ssm_rank(rank):
    """Phase 17 on one of four gloo ranks sharing the card, for each mesh
    of MESH_SERVE_MESHES, every engine drawing only the rank's blocks of
    seed 0's weights: (a) the f32 unit's logits holding the single-device
    k-WTA selections; ``topk_gather`` at the rank's decode shape against
    its plain version; (b) zamba2 bf16 ``generate_static`` (tokens,
    logits, launches, collectives, bytes, times); (g) xlstm-350m bf16."""
    import pickle
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Engine
    from repro_torch.kernels.topk_gather import topk_gather, topk_gather_plain
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    single = pickle.loads((MESH_SSM_DIR / "single.pkl").read_bytes())
    cfg, xcfg, cfg32 = ssm_cfgs()
    toks, xtoks = single["toks"], single["xtoks"]
    prompts = toks[:, :MESH_SSM_PROMPT]
    out = {"rank": rank}
    for dims in MESH_SERVE_MESHES:
        mesh = make_mesh(dims, ("data", "model"), device)
        res = {"coords": mesh.coords}
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg32, MESH_SSM_SEQ, 4, device=device, mesh=mesh)
        rows = eng.shards.batch_rows(4)
        held = iter([m.to(device) for m in single["masks"]])
        with kwta_selections(held, rows=rows):
            got = stepped_logits(eng, toks)
        if next(held, None) is not None:
            fail("mesh-ssm: k-WTA selections left over")
        res["f32_err"] = rows_err([g.numpy() for g in got],
                                  single["f32_rows"])
        del eng
        torch.cuda.empty_cache()
        shape = dict(HYBRID_SHAPE, b=4 if rows is None
                     else rows.stop - rows.start)
        operands = kernel_operands(shape, torch.bfloat16, SEED + 71)[:5]
        res["kernel"] = {"shape": shape, "max_abs_err": check(
            f"topk_gather {shape} bf16 on rank {rank} of {dims}",
            topk_gather(*operands), topk_gather_plain(*operands),
            phase="mesh-ssm")}
        eng = Engine(cfg, MESH_SSM_SEQ, 4, device=device, mesh=mesh)
        res["zamba2"] = static_run(eng, prompts, MESH_SSM_GEN,
                                   CollectiveLog(eng))
        res["zamba2"]["bytes"] = serving_bytes(eng)
        del eng
        eng = Engine(xcfg, 2 * MESH_SSM_XLSTM_PROMPT + 1, 4, device=device,
                     mesh=mesh)
        res["xlstm"] = static_run(eng, xtoks, MESH_SSM_XLSTM_GEN,
                                  CollectiveLog(eng))
        res["xlstm"]["bytes"] = serving_bytes(eng)
        del eng
        res["peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        out[dims] = res
    return out


def mesh_ssm_nccl(rank):
    """(h) in a process of its own: zamba2 bf16 ``generate_static`` on
    mesh 1x1 over NCCL at world size 1 against the engine without a
    mesh: tokens and every step's logits, bit for bit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Engine
    from repro_torch.models import transformer as T
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, xcfg, _ = ssm_cfgs()
    prompts = ssm_tokens(cfg, xcfg)[0][:, :MESH_SSM_PROMPT]
    params = T.init_model(cfg, seed=SEED, device=device)
    mesh = make_mesh((1, 1), ("data", "model"), device)
    runs = [static_run(Engine(cfg, MESH_SSM_SEQ, 4, params=params,
                              device=device, mesh=m),
                       prompts, MESH_SSM_GEN) for m in (None, mesh)]
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "distributed": mesh.distributed,
            "tokens_equal": bool(np.array_equal(runs[0]["tokens"],
                                                runs[1]["tokens"])),
            "logits_equal": all(torch.equal(a, b) for a, b in zip(
                runs[0]["rows"], runs[1]["rows"], strict=True))}


def ssm_single(cfg, xcfg, cfg32, toks, xtoks):
    """The single-device references of phase 17 on the card: the f32
    unit's stepped logits with its k-WTA selections (pickled for the
    ranks), zamba2's and xlstm's bf16 ``generate_static`` runs, and the
    reckoned per-rank bytes of each on each mesh."""
    import pickle
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.serve import Engine
    from repro_torch.models import transformer as T
    from repro_torch.sharding import make_rules
    params = T.init_model(cfg32, seed=SEED, device="cuda")
    eng = Engine(cfg32, MESH_SSM_SEQ, 4, params=params, device="cuda")
    with kwta_selections() as masks:
        f32_rows = [r.numpy() for r in stepped_logits(eng, toks)]
    single = {"toks": toks, "xtoks": xtoks, "f32_rows": f32_rows,
              "masks": [m.cpu() for m in masks]}
    del params, eng
    torch.cuda.empty_cache()
    (MESH_SSM_DIR / "single.pkl").write_bytes(pickle.dumps(single))
    one, reckoned = {}, {}
    for name, c, prompts, gen, seq in (
            ("zamba2", cfg, toks[:, :MESH_SSM_PROMPT], MESH_SSM_GEN,
             MESH_SSM_SEQ),
            ("xlstm", xcfg, xtoks, MESH_SSM_XLSTM_GEN,
             2 * MESH_SSM_XLSTM_PROMPT + 1)):
        params = T.init_model(c, seed=SEED, device="cuda")
        eng = Engine(c, seq, 4, params=params, device="cuda")
        one[name] = static_run(eng, prompts, gen)
        one[name]["bytes"] = serving_bytes(eng)
        for dims in MESH_SERVE_MESHES:
            rules = make_rules(Mesh(dims, ("data", "model"),
                                    torch.device("cuda")), "decode")
            reckoned[dims, name] = reckoned_serving_bytes(eng, params, rules)
        del params, eng
        torch.cuda.empty_cache()
    return one, reckoned


def cpu_launches():
    """(c) zamba2 reduced on the CPU through ``generate_static``: the
    plain version runs for CPU tensors, the kernel never."""
    from repro_torch.launch.serve import Engine
    cfg = ssm_cfgs()[0].reduced()
    reset_counts()
    toks = Engine(cfg, 8, 2, device="cpu").generate_static(
        np.zeros((2, 3), np.int64), 3)
    return toks.shape, read_counts()["topk_gather"]


def phase_mesh_ssm():
    """Phase 17: the single-device references on the card, then four gloo
    ranks sharing the card on meshes (1, 4) and (2, 2) beside one NCCL
    rank at world size 1."""
    import shutil
    from repro_torch.launch.ranks import run_ranks
    t0 = time.perf_counter()
    shutil.rmtree(MESH_SSM_DIR, ignore_errors=True)
    MESH_SSM_DIR.mkdir(parents=True)
    cfg, xcfg, cfg32 = ssm_cfgs()
    toks, xtoks = ssm_tokens(cfg, xcfg)
    one, reckoned = ssm_single(cfg, xcfg, cfg32, toks, xtoks)
    t_single = time.perf_counter() - t0
    done = {}

    def nccl_rank():
        t = time.perf_counter()
        try:
            done["nccl"] = run_ranks(mesh_ssm_nccl, 1, MESH_SSM_DIR / "nccl",
                                     backend="nccl", timeout_s=600)[0]
        except BaseException as e:      # raised again below, in this thread
            done["error"] = e
        done["s"] = time.perf_counter() - t

    side = threading.Thread(target=nccl_rank)
    side.start()
    t = time.perf_counter()
    try:
        ranks = run_ranks(mesh_ssm_rank, 4, MESH_SSM_DIR / "ranks",
                          backend="gloo", timeout_s=900, threads=1)
    finally:
        side.join()
    t_gloo = time.perf_counter() - t
    if "error" in done:
        raise done["error"]
    nccl = done["nccl"]
    failed = []
    per_step = cfg.n_units * cfg.block_pattern.count("shared_attn")
    print(f"[mesh-ssm] {HYBRID_ARCH} as shipped ({cfg.n_layers} layers: "
          f"{cfg.n_units} units of {cfg.block_pattern.count('mamba2')} "
          f"Mamba2 + the shared attention block, d_model {cfg.d_model}, "
          f"d_inner {cfg.ssm_expand * cfg.d_model}, ssm_state "
          f"{cfg.ssm_state}, {cfg.n_heads} heads, shared FFN d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}) and {XLSTM_ARCH} "
          f"({xcfg.n_layers} layers, d_model {xcfg.d_model}, {xcfg.n_heads} "
          f"heads), bf16, random weights from seed {SEED}; four gloo ranks "
          f"sharing the card: {device_line()}")
    numbers = {"single": {k: {"tok_s": v["tok_s"], "step_ms": v["step_ms"],
                              "bytes": v["bytes"]} for k, v in one.items()}}
    for name in ("zamba2", "xlstm"):
        print(f"[mesh-ssm] single device {name}: {one[name]['tok_s']:.2f} "
              f"tok/s, step {one[name]['step_ms']:.2f} ms (host clock), "
              f"param bytes {one[name]['bytes'][0]}, cache bytes "
              f"{one[name]['bytes'][2]}, topk_gather launches "
              f"{one[name]['launches']} in {one[name]['steps']} steps")
    for dims in MESH_SERVE_MESHES:
        name = "x".join(map(str, dims))
        rs = [r[dims] for r in ranks]
        err = max(r["f32_err"] for r in rs)
        print(f"[mesh-ssm] {name} (a) f32, {MESH_SSM_F32_LAYERS} of "
              f"{cfg.n_layers} blocks, 4 prompts of {MESH_SSM_PROMPT} "
              f"stepped through and {MESH_SSM_FORCED} forced steps holding "
              f"the single-device k-WTA selections: largest |logits - "
              f"single| {err:.3e} (tol {MESH_SERVE_TOL:.0e}); peak "
              f"{max(r['peak'] for r in rs) / 2**30:.2f} GiB a rank")
        if not err <= MESH_SERVE_TOL:
            failed.append(f"{name}: f32 logits part from the single device")
        numbers[name] = {"f32_err": err, "kernel": [r["kernel"] for r in rs]}
        for arch, prompt in (("zamba2", MESH_SSM_PROMPT),
                             ("xlstm", MESH_SSM_XLSTM_PROMPT)):
            got = [r[arch] for r in rs]
            if any(not np.array_equal(g["tokens"], got[0]["tokens"])
                   for g in got):
                failed.append(f"{name} {arch}: ranks took other tokens")
            parted, free = static_parity(
                got[0]["tokens"], got[0]["rows"], one[arch]["tokens"],
                one[arch]["rows"], f"{name} {arch} mesh vs single", prompt,
                "mesh-ssm", top_two=False, bound=MESH_SSM_GAP[arch])
            check_id = "(b)" if arch == "zamba2" else "(g)"
            print(f"[mesh-ssm] {name} {arch} {check_id} bf16 tokens against "
                  f"the single device: {4 - parted} of 4 rows identical, "
                  f"{parted} parted at a tie (the single run's logit of "
                  f"the mesh's token within {MESH_SSM_GAP[arch]} of its "
                  f"largest); largest logit difference on equal inputs "
                  f"{free:.3e} (limit {MESH_SSM_GAP[arch]})")
            if not free <= MESH_SSM_GAP[arch]:
                failed.append(f"{name} {arch}: bf16 logits part from the "
                              "single device on equal inputs")
            launches = [g["launches"] / g["steps"] for g in got]
            want_launches = per_step if arch == "zamba2" else 0
            print(f"[mesh-ssm] {name} {arch} (c) topk_gather launches a "
                  f"step on each rank {launches} (want {want_launches})")
            if any(x != want_launches for x in launches):
                failed.append(f"{name} {arch}: topk_gather launches")
            for r, g in zip(rs, got):
                want = reckoned[dims, arch]
                print(f"[mesh-ssm] {name} {arch} (d) rank {r['coords']}: "
                      f"param bytes {g['bytes'][0]} (reckoned from the specs "
                      f"{want[0]}; single device {one[arch]['bytes'][0]}), "
                      f"cache bytes {g['bytes'][2]} (reckoned {want[1]}; "
                      f"single {one[arch]['bytes'][2]})")
                if (g["bytes"][0], g["bytes"][2]) != tuple(want):
                    failed.append(f"{name} {arch}: a rank's bytes are not "
                                  "its reckoned block's")
            c = got[0]["collectives"]
            logits_bytes = 4 * (cfg if arch == "zamba2" else
                                xcfg).padded_vocab * 2
            print(f"[mesh-ssm] {name} {arch} (e) a step's collectives: "
                  f"{c['per_step']:.1f} ({c['ops']} in all steps), "
                  f"{c['bytes_per_step'] / 1e3:.1f} kB, the largest "
                  f"{c['largest'][0]} of {c['largest'][1]} B (the bf16 "
                  f"logits are {logits_bytes} B); tensors handed over that "
                  f"are a param or cache block: "
                  f"{[g['collectives']['weights_handed'] for g in got]}")
            if any(g["collectives"]["weights_handed"] for g in got):
                failed.append(f"{name} {arch}: a collective was handed a "
                              "param or cache block")
            print(f"[mesh-ssm] {name} {arch} (f) host clock: "
                  f"{got[0]['tok_s']:.2f} tok/s, step "
                  f"{got[0]['step_ms']:.2f} ms (single device "
                  f"{one[arch]['tok_s']:.2f} tok/s, "
                  f"{one[arch]['step_ms']:.2f} ms); no claim")
            numbers[name][arch] = {
                "tok_s": got[0]["tok_s"], "step_ms": got[0]["step_ms"],
                "parted": parted, "launches_per_step": launches[0],
                "collectives": c, "bytes": [g["bytes"] for g in got]}
    shape, cpu = cpu_launches()
    print(f"[mesh-ssm] (c) {HYBRID_ARCH} reduced on the CPU, "
          f"generate_static {shape}: topk_gather launches {cpu} (the plain "
          f"version runs for CPU tensors)")
    if cpu:
        failed.append("the CPU path launched the kernel")
    print(f"[mesh-ssm] (h) mesh 1x1 over {nccl['backend']} at world size "
          f"{nccl['world']} (process group up: {nccl['distributed']}) "
          f"against the engine without a mesh: tokens bit-equal "
          f"{nccl['tokens_equal']}, every step's logits bit-equal "
          f"{nccl['logits_equal']}")
    if not (nccl["tokens_equal"] and nccl["logits_equal"]
            and nccl["distributed"]):
        failed.append("the 1x1 mesh over NCCL parts from the plain engine")
    numbers.update(single_s=t_single, gloo_s=t_gloo, nccl_s=done["s"],
                   phase_s=time.perf_counter() - t0)
    print(f"[mesh-ssm] numbers {json.dumps(numbers)}")
    shutil.rmtree(MESH_SSM_DIR, ignore_errors=True)
    if failed:
        fail("mesh-ssm: " + "; ".join(failed))
    return {"launches_mesh_ssm_per_decode_step": numbers["2x2"]["zamba2"][
        "launches_per_step"],
        "mesh_ssm_max_abs_err": max(k["max_abs_err"] for d in
                                    MESH_SERVE_MESHES for k in
                                    numbers["x".join(map(str, d))]["kernel"])}


# ---------------------------------------------------------------------------
# phase 18: the examples
# ---------------------------------------------------------------------------

EXAMPLES_DIR = ROOT / "examples"
#: each example's run in a fresh process (quickstart at the reference's
#: defaults, the others cut to a few steps or requests)
EXAMPLE_FRESH_ARGV = {"quickstart": [],
                      "serve_lm": ["--requests", "2", "--gen", "6"],
                      "sparse_sparse_lm": ["--steps", "5"],
                      "train_gsc": ["--steps", "5"]}
EXAMPLE_SERVE_ARCHS = ("smollm-360m", "deepseek-v2-lite-16b")
#: the quickstart's numbers, as the reference prints them
QUICKSTART_FLOPS = {"dense": 2097152, "sparse_dense": 262144,
                    "sparse_sparse": 262144}
QUICKSTART_PACKING = {"dense_bytes": 524288, "packed_weight_bytes": 65536,
                      "route_bytes_random": 32768, "route_bytes_cyclic": 4096}
QUICKSTART_TOL = 1e-4
#: the GSC variants' last loss below this share of the first (phase 11 (d))
GSC_FALL = 0.7
EXAMPLE_DEVICE = ["--device", "cuda"]


def load_example(name):
    """``examples/<name>_torch.py`` as a module (its ``__main__`` block
    not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES_DIR / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def topk_ffn_layers(cfg, rows):
    """The layers whose FFN down projection takes the topk path (one
    ``topk_gather`` launch each) at a decode batch of ``rows``: an
    attention block's FFN of d_ff, or an MoE layer's shared experts of
    n_shared·d_ff, weight- and activation-sparse, whose rows·K lies below
    its padded width; counted from the config, as phase 10 counts its
    layers, and not by the dispatcher under test."""
    from repro_torch.core.masks import pad_to_multiple
    from repro_torch.models.transformer import ATTN_KINDS, layer_kinds
    sp = cfg.ffn_sparsity
    if not (sp.weight_sparse and sp.activation_sparse):
        return 0
    n = 0
    for kind in layer_kinds(cfg):
        width = pad_to_multiple(cfg.n_shared_experts * cfg.d_ff
                                if cfg.is_moe and kind == "attn"
                                else cfg.d_ff, sp.n)
        if kind in ATTN_KINDS and width and rows * sp.k_for(width) < width:
            n += 1
    return n


@contextlib.contextmanager
def captured_topk_launches():
    """``{operand shapes and types: (output, operands)}``: the first
    ``topk_gather`` launch at each shape made while the context is open,
    its output and operands cloned just after it on its stream (the
    module's ``launch_into`` wrapped, and put back after)."""
    tg = importlib.import_module("repro_torch.kernels.topk_gather")
    launch, seen = tg.launch_into, {}

    def spy(out, *operands):
        launch(out, *operands)
        key = tuple((tuple(t.shape), t.dtype) for t in (out, *operands))
        if key not in seen:
            seen[key] = (out.clone(), [t.clone() for t in operands])
    tg.launch_into = spy
    try:
        yield seen
    finally:
        tg.launch_into = launch


@contextlib.contextmanager
def checked_expert_kwta():
    """Every routed experts' k-WTA made while the context is open, held
    row by row against ``torch.topk`` of its input.  The ``bisect``
    k-WTA keeps the values at or above a threshold within its final
    interval, (max - min)·2^-iters wide, below the K-th largest value: a
    row keeps at least the non-zeros at or above its K-th largest and at
    most those above it less twice that width (slack for the float32
    probes); an empty capacity slot, a row of zeros, keeps none.  Yields
    ``[rows out of bounds, filled rows, rows, calls, most kept in a
    row]``, all but the third and fourth on the card (``moe.apply_kwta``
    wrapped, and put back after)."""
    import inspect

    from repro_torch.core.kwta import kwta_bisect
    moe = importlib.import_module("repro_torch.models.moe")
    iters = inspect.signature(kwta_bisect).parameters["iters"].default
    kwta, tally = moe.apply_kwta, [0, 0, 0, 0, 0]

    def spy(h, cfg_sp, *args, **kwargs):
        y = kwta(h, cfg_sp, *args, **kwargs)
        if cfg_sp.kwta_impl != "bisect":
            fail(f"routed experts' k-WTA is {cfg_sp.kwta_impl!r}; the row "
                 "check holds bisect's bounds")
        x = h.float()
        kth = torch.topk(x, cfg_sp.k_for(h.shape[-1])).values[..., -1:]
        width = (x.amax(-1, keepdim=True) - x.amin(-1, keepdim=True)) \
            * 2.0 ** (1 - iters)
        nonzero = x != 0
        kept = ((y[0] if isinstance(y, tuple) else y) != 0).sum(-1)
        least = (nonzero & (x >= kth)).sum(-1)
        most = (nonzero & (x >= kth - width)).sum(-1)
        tally[0] = tally[0] + ((kept < least) | (kept > most)).sum()
        tally[1] = tally[1] + nonzero.any(-1).sum()
        tally[2] += kept.numel()
        tally[3] += 1
        tally[4] = torch.maximum(torch.as_tensor(tally[4]).to(kept),
                                 kept.max())
        return y
    moe.apply_kwta = spy
    try:
        yield tally
    finally:
        moe.apply_kwta = kwta


@contextlib.contextmanager
def counted_prefills():
    """:func:`prefill_launches` of every engine made while the context is
    open (the class's prefills wrapped, and put back after)."""
    from repro_torch.launch.serve import Engine
    saved = {name: Engine.__dict__[name]
             for name in ("_prefill", "_prefill_chunk")}
    try:
        yield prefill_launches(Engine)
    finally:
        for name, fn in saved.items():
            setattr(Engine, name, fn)


def example_quickstart():
    got = load_example("quickstart").main(EXAMPLE_DEVICE)
    losses = got["losses"]
    print(f"[examples] quickstart: max errors {got['sparse_dense_err']:.3e} "
          f"(sparse-dense), {got['sparse_sparse_err']:.3e} "
          f"(sparse-sparse); FLOPs {got['flops']}; MLP loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} in {len(losses)} steps")
    if max(got["sparse_dense_err"], got["sparse_sparse_err"]) > \
            QUICKSTART_TOL:
        fail(f"quickstart: max errors {got['sparse_dense_err']}, "
             f"{got['sparse_sparse_err']} above {QUICKSTART_TOL}")
    if got["flops"] != QUICKSTART_FLOPS:
        fail(f"quickstart: FLOPs {got['flops']}")
    packing = {k: got["packing"][k] for k in QUICKSTART_PACKING}
    if packing != QUICKSTART_PACKING:
        fail(f"quickstart: packing {got['packing']}")
    if not losses[-1] < losses[0]:
        fail(f"quickstart: MLP loss {losses[0]} -> {losses[-1]}")


def example_serve(arch):
    """serve_lm on ``arch`` reduced, the counts at 0 just before: every
    request served, one prefill a request, one ``topk_gather`` launch a
    topk layer a decode step and none in a prefill, every layer's
    realized k/N in its bounds, and the kernel held against its plain
    version on the operands the decode steps gave it.  Returns the
    launches and that largest error."""
    from repro_torch.core.masks import pad_to_multiple
    from repro_torch.kernels.topk_gather import (topk_gather,
                                                 topk_gather_plain)
    mod = load_example("serve_lm")
    reset_counts()
    with counted_prefills() as in_prefill, captured_topk_launches() as \
            seen, checked_expert_kwta() as experts:
        got = mod.main(["--arch", arch] + EXAMPLE_DEVICE)
    counts = read_counts()
    cfg, stats, tel = got["cfg"], got["stats"], got["telemetry"]
    args = mod.build_parser().parse_args([])
    steps, launches = stats["decode_steps"], counts["topk_gather"]
    layers = topk_ffn_layers(cfg, args.slots)
    ttft = np.percentile(list(stats["ttft_s"].values()), [50, 95]) * 1e3
    print(f"[examples] serve_lm {arch} reduced ({cfg.n_layers} layers, "
          f"d_ff {cfg.d_ff}): {len(got['out'])} of {len(got['requests'])} "
          f"requests, {stats['prefill_calls']} prefill calls, {steps} "
          f"decode steps; topk_gather launches {launches} ({layers} topk "
          f"layers x {steps} steps), {in_prefill[0]} in prefills; "
          f"{stats['tok_s']:.2f} tok/s, TTFT p50 {ttft[0]:.3f} ms, p95 "
          f"{ttft[1]:.3f} ms (host clock; the telemetry histogram's "
          f"buckets: {tel['ttft_p50'] * 1e3:.0f}, {tel['ttft_p95'] * 1e3:.0f} "
          "ms)")
    for req in got["requests"]:
        toks = got["out"].get(req.uid, [])
        if len(toks) != req.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"serve_lm {arch}: request {req.uid} returned {toks}")
    if stats["prefill_calls"] != len(got["requests"]):
        fail(f"serve_lm {arch}: {stats['prefill_calls']} prefill calls")
    if layers == 0 or launches != layers * steps or in_prefill[0]:
        fail(f"serve_lm {arch}: topk_gather launched {launches} times, "
             f"{in_prefill[0]} in prefills; want {layers} x {steps} and 0")
    # the kernel on the operands the decode steps gave it (the shared
    # route, the compute dtype): the path's own output against the plain
    # version, and equal to a float32 launch rounded once
    worst = 0.0
    for out, operands in seen.values():
        b, k = operands[0].shape
        p, g, n = operands[3].shape
        label = (f"serve_lm {arch} topk_gather b={b} k={k} p={p} g={g} "
                 f"n={n} r={g // operands[4].shape[0]} "
                 f"{str(operands[3].dtype)[6:]}, decode step's operands")
        f32 = topk_gather(*operands)
        worst = max(worst, check(label, f32, topk_gather_plain(*operands),
                                 phase="examples"))
        if not torch.equal(out, f32.to(out.dtype)):
            fail(f"{label}: the path's output is not a float32 launch "
                 "rounded once")
    if not seen:
        fail(f"serve_lm {arch}: no topk_gather launch captured")
    # the routed experts' k-WTA, every call of the run, row by row
    mismatched, filled, most = map(int, (experts[0], experts[1], experts[4]))
    if cfg.is_moe:
        print(f"[examples]   routed experts' k-WTA: {experts[3]} calls, "
              f"{experts[2]} capacity rows ({filled} filled, at most {most} "
              f"kept in a row), {mismatched} rows keeping a count outside "
              "the bounds from their K-th largest value")
        if not experts[3] or mismatched:
            fail(f"serve_lm {arch}: the routed experts' k-WTA kept the "
                 f"wrong count in {mismatched} of {experts[2]} rows")
    # an FFN's k-WTA row (the dense FFN's, the shared experts') keeps at
    # least K of its width; a routed experts' capacity row keeps what the
    # row check above bounds where a token fills it and none where it is
    # empty, so their mean lies in [0, the most a row kept / d_ff]
    sp = cfg.ffn_sparsity
    width = pad_to_multiple(cfg.n_shared_experts * cfg.d_ff if cfg.is_moe
                            else cfg.d_ff, sp.n)
    expert_width = pad_to_multiple(cfg.d_ff, sp.n)
    for name, frac in sorted(tel["layers"].items()):
        lo, hi = ((sp.k_for(width) / width, 1.0) if ".ffn." in name else
                  (0.0, most / expert_width))
        print(f"[examples]   {name}: realized k/N {frac:.6f} "
              f"(bounds [{lo:.6f}, {hi:.6f}])")
        if frac is None or not lo <= frac <= hi:
            fail(f"serve_lm {arch}: {name} realized k/N {frac} outside "
                 f"[{lo}, {hi}]")
    if not any(".ffn." in name for name in tel["layers"]):
        fail(f"serve_lm {arch}: no FFN layer reports its sparsity")
    return launches, worst


def example_sparse_sparse_lm():
    got = load_example("sparse_sparse_lm").main(EXAMPLE_DEVICE)
    losses = {tag: got[tag]["loss"] for tag in ("dense", "sparse_sparse")}
    print(f"[examples] sparse_sparse_lm: final losses {losses}; census "
          f"FLOPs a step {got['dense']['flops']:.6e} / "
          f"{got['sparse_sparse']['flops']:.6e}, ratio {got['ratio']:.4f}")
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"sparse_sparse_lm: losses {losses}")


def example_train_gsc(smi):
    mod = load_example("train_gsc")
    steps = mod.build_parser().parse_args([]).steps     # the example's 300
    for variant in mod.VARIANTS:
        got = mod.train(variant, steps, device="cuda")
        first, last = got["printed"][0][0], got["printed"][steps - 1][0]
        print(f"[examples] train_gsc {variant}: {steps} steps at batch 64, "
              f"loss {first:.4f} -> {last:.4f}, held-out accuracy "
              f"{got['heldout']:.4f}, {got['seconds']:.3f} s ({smi})")
        if not last < GSC_FALL * first:
            fail(f"train_gsc {variant}: last loss {last} not below "
                 f"{GSC_FALL} x {first}")


def examples_fresh(meanwhile):
    """Each example as a user runs it, ``python examples/<name>_torch.py``,
    all four processes started together, ``meanwhile()`` called while they
    run; each must exit 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(EXAMPLES_DIR / f"{name}_torch.py"), *argv],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, argv in EXAMPLE_FRESH_ARGV.items()}
    try:
        meanwhile()
        outs = {name: proc.communicate(timeout=300)
                for name, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, (out, err) in outs.items():
        code = procs[name].returncode
        last = out.strip().splitlines()[-1] if out.strip() else ""
        print(f"[examples] python examples/{name}_torch.py "
              f"{' '.join(EXAMPLE_FRESH_ARGV[name])}: exit {code}; last "
              f"line: {last[:160]}")
        if code:
            print(err[-2000:])
            fail(f"examples/{name}_torch.py exited with {code}")
    print(f"[examples] the four fresh processes took "
          f"{time.perf_counter() - t:.1f} s together, sparse_sparse_lm "
          "in this process beside them")


def phase_examples():
    """Phase 18.  The runs that print a time go first, alone on the card;
    sparse_sparse_lm, which prints none, runs beside the fresh processes.
    Returns row 1's key of the examples' serving runs."""
    smi = device_line()
    t = time.perf_counter()
    example_quickstart()
    served = [example_serve(arch) for arch in EXAMPLE_SERVE_ARCHS]
    example_train_gsc(smi)
    print(f"[examples] quickstart, serve_lm and train_gsc took "
          f"{time.perf_counter() - t:.1f} s ({smi})")
    examples_fresh(example_sparse_sparse_lm)
    return {"launches_examples_serve_lm": sum(n for n, _ in served),
            "examples_max_abs_err": max(e for _, e in served)}


# ---------------------------------------------------------------------------
# phase 19: the meshes that cut a table, a head or an expert
# ---------------------------------------------------------------------------

MESH_CUTS_DIR = ROOT / "build" / "mesh_cuts"
#: (a): smollm-360m's layers, and the groups a route table serves (640
#: groups of d_ff 2560 at N=4: 5 tables, 160 groups a rank on 1x4)
MESH_CUTS_LAYERS, MESH_CUTS_SHARE = 2, 128
#: (b): deepseek-v2-lite-16b's layers, the cache rows (a multiple of the
#: 2x2 mesh's four ranks) and the prompt stepped through
MESH_CUTS_MLA_LAYERS, MESH_CUTS_SEQ, MESH_CUTS_PROMPT = 2, 32, 6
#: (c): the reduced configs whose blocks cut a head and an expert
MESH_CUTS_REDUCED = (("deepseek-v2-lite-16b", dict(n_heads=2)),
                     ("qwen3-moe-235b-a22b",
                      dict(n_experts=2, experts_per_token=1)))
MESH_CUTS_FORCED = 3


def mesh_cuts_cfgs():
    """(a)'s smollm (bf16 as shipped, and f32), (b)'s f32 deepseek, (c)'s
    f32 reduced configs."""
    from repro_torch.configs import get_config
    cfg = get_config("smollm-360m")
    cfg = dataclasses.replace(
        cfg, n_layers=MESH_CUTS_LAYERS, ffn_sparsity=dataclasses.replace(
            cfg.ffn_sparsity, route_share=MESH_CUTS_SHARE))
    f32 = dict(compute_dtype="float32")
    return (cfg, dataclasses.replace(cfg, **f32),
            dataclasses.replace(get_config(MOE_ARCH),
                                n_layers=MESH_CUTS_MLA_LAYERS, **f32),
            [get_config(a).reduced(**kw, **f32)
             for a, kw in MESH_CUTS_REDUCED])


def long_logits(params, cfg, toks, shards=None):
    """One row stepped through ``toks`` with ``serve_step`` from a fresh
    contiguous cache (on the rank's blocks under ``shards``): every step's
    logits (host) and the cache."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.serving import use_serving
    device = next(iter(params["embed"].values())).device
    toks = torch.from_numpy(toks).to(device)
    rules = None if shards is None else shards.rules
    cache = T.init_cache(cfg, 1, MESH_CUTS_SEQ, device, rules)
    rows = []
    with torch.no_grad(), use_serving(shards):
        for pos in range(toks.shape[1]):
            logits, cache = T.serve_step(params, cache,
                                         {"tokens": toks[:, pos:pos + 1]},
                                         pos, cfg)
            rows.append(logits.float().cpu().numpy())
    return rows, cache


def mesh_cuts_single():
    """The single-device references of phase 19 on the card, pickled for
    the ranks: (a) the f32 forced logits with their k-WTA selections, the
    bf16 forced logits and phase 4's workload's tokens; (b) the f32 row's
    stepped logits with its selections and router choices; (c) each
    reduced config's f32 forced logits with both."""
    import pickle
    from repro_torch.launch.serve import Engine
    from repro_torch.models import transformer as T
    cfg, cfg32, mla32, reduced = mesh_cuts_cfgs()
    reqs = phase4_requests(cfg.vocab_size)
    prompts = [r.prompt for r in reqs[:4]]
    rng = np.random.default_rng(SEED + 19)
    forced = rng.integers(0, cfg.vocab_size, (MESH_CUTS_FORCED, 4))
    single = {"forced": forced, "reduced": []}
    eng = Engine(cfg32, MESH_SERVE_SEQ, 4, device="cuda")
    with kwta_selections() as masks:
        single["f32_rows"] = forced_logits(eng, prompts, forced)
    single["masks"] = [m.cpu() for m in masks]
    del eng
    params = T.init_model(cfg, seed=SEED, device="cuda")
    eng = Engine(cfg, MESH_SERVE_SEQ, 4, params=params, device="cuda")
    single["bf16_rows"] = forced_logits(eng, prompts, forced)
    eng.serve([dataclasses.replace(reqs[0], max_new_tokens=2)])
    single["tokens"] = eng.serve(reqs)[0]
    del eng
    torch.cuda.empty_cache()
    toks = rng.integers(0, mla32.vocab_size, (1, MESH_CUTS_PROMPT))
    with kwta_selections() as masks, router_choices() as choices:
        single["long_rows"] = long_logits(
            T.init_model(mla32, seed=SEED, device="cuda"), mla32, toks)[0]
    single.update(long_toks=toks, long_masks=[m.cpu() for m in masks],
                  long_choices=[c.cpu() for c in choices])
    torch.cuda.empty_cache()
    for c in reduced:
        small = rng.integers(0, c.vocab_size, (MESH_CUTS_FORCED, 4))
        small_prompts = [[t % c.vocab_size for t in p] for p in prompts]
        eng = Engine(c, MESH_SERVE_SEQ, 4, device="cuda")
        with kwta_selections() as masks, router_choices() as choices:
            rows = forced_logits(eng, small_prompts, small)
        single["reduced"].append({
            "prompts": small_prompts, "forced": small, "rows": rows,
            "masks": [m.cpu() for m in masks],
            "choices": [x.cpu() for x in choices]})
    (MESH_CUTS_DIR / "single.pkl").write_bytes(pickle.dumps(single))
    return cfg, params, reqs, single


def held_forced(eng, prompts, forced, masks, choices=()):
    """``forced_logits`` on ``eng``'s mesh holding the single device's
    k-WTA selections (and router choices): the logits, and whether every
    held one was read."""
    device = eng.device
    held = iter([m.to(device) for m in masks])
    chosen = iter([c.to(device) for c in choices])
    experts = None
    if eng.cfg.is_moe and eng.cfg.n_experts % eng.shards.size("model") == 0:
        experts = eng.shards.block("model", eng.cfg.n_experts)
    rows = eng.shards.batch_rows(4)
    with kwta_selections(held, rows=rows, experts=experts), \
            router_choices(chosen, rows=rows):
        got = forced_logits(eng, prompts, forced)
    return got, next(held, None) is None and next(chosen, None) is None


def mesh_cuts_rank(rank):
    """Phase 19 on one of four gloo ranks sharing the card: (a) and (c) on
    mesh 1x4, (b) on 2x2 under the ``decode_long`` rules; each engine
    draws the rank's blocks of seed 0's weights."""
    import pickle
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Engine
    from repro_torch.models import transformer as T
    from repro_torch.sharding import make_rules
    from repro_torch.sharding.collectives import observe_collectives
    from repro_torch.sharding.serving import Shards
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    single = pickle.loads((MESH_CUTS_DIR / "single.pkl").read_bytes())
    cfg, cfg32, mla32, reduced = mesh_cuts_cfgs()
    reqs = phase4_requests(cfg.vocab_size)
    prompts = [r.prompt for r in reqs[:4]]
    mesh = make_mesh((1, 4), ("data", "model"), device)
    out = {"rank": rank, "coords": mesh.coords}
    # (a) the shared route
    eng = Engine(cfg32, MESH_SERVE_SEQ, 4, device=device, mesh=mesh)
    up = eng.params["layers"][0]["ffn"]["up"]
    out["route"] = {"tables": tuple(up["route"].shape),
                    "block_route": tuple(up["block_route"].shape)
                    if "block_route" in up else None,
                    "groups": eng.shards.block(
                        "model", cfg.d_ff // cfg.ffn_sparsity.n)}
    rows, ok = held_forced(eng, prompts, single["forced"], single["masks"])
    out["f32_err"], out["held_all"] = rows_err(rows, single["f32_rows"]), ok
    del eng
    out["grads"] = block_grads_check(cfg32, device, dims=(1, 4))
    eng = Engine(cfg, MESH_SERVE_SEQ, 4, device=device, mesh=mesh)
    out["bf16_move"] = rows_err(forced_logits(eng, prompts,
                                              single["forced"]),
                                single["bf16_rows"])
    eng.serve([dataclasses.replace(reqs[0], max_new_tokens=2)])
    log, pre = CollectiveLog(eng), prefill_launches(eng)
    reset_counts()
    with observe_collectives(log):
        toks, stats = eng.serve(reqs)
    out["serve"] = {"tokens": toks, "steps": stats["decode_steps"],
                    "launches": read_counts()["topk_gather"],
                    "prefill_launches": pre[0],
                    "handed": log.summary(stats["decode_steps"])[
                        "weights_handed"]}
    del eng, log
    torch.cuda.empty_cache()
    # (b) MLA's latent rows under decode_long
    mesh22 = make_mesh((2, 2), ("data", "model"), device)
    shards = Shards(make_rules(mesh22, "decode_long"), MESH_CUTS_SEQ)
    params = T.init_model(mla32, seed=SEED, device=device,
                          rules=shards.rules)
    held = iter([m.to(device) for m in single["long_masks"]])
    chosen = iter([c.to(device) for c in single["long_choices"]])
    reset_counts()
    with kwta_selections(held, experts=shards.block(
            "model", mla32.n_experts)), router_choices(chosen):
        rows, cache = long_logits(params, mla32, single["long_toks"], shards)
    axes = shards.rows_axes(False, 1)
    out["long"] = {"err": rows_err(rows, single["long_rows"]),
                   "held_all": next(held, None) is None
                   and next(chosen, None) is None,
                   "launches": read_counts()["topk_gather"],
                   "steps": len(rows), "axes": axes,
                   "block": shards.block(axes, MESH_CUTS_SEQ),
                   "ckv": tuple(cache[0]["ckv"].shape),
                   "coords": mesh22.coords}
    del params, cache
    torch.cuda.empty_cache()
    # (c) a head and an expert cut
    out["reduced"] = []
    for c, ref in zip(reduced, single["reduced"]):
        eng = Engine(c, MESH_SERVE_SEQ, 4, device=device, mesh=mesh)
        rows, ok = held_forced(eng, ref["prompts"], ref["forced"],
                               ref["masks"], ref["choices"])
        out["reduced"].append({
            "err": rows_err(rows, ref["rows"]), "held_all": ok,
            "grads": block_grads_check(c, device, dims=(1, 4))})
        del eng
    return out


def phase_mesh_cuts():
    """Phase 19: the single-device references on the card, then four gloo
    ranks sharing the card."""
    import shutil
    from repro_torch.launch.ranks import run_ranks
    t0 = time.perf_counter()
    shutil.rmtree(MESH_CUTS_DIR, ignore_errors=True)
    MESH_CUTS_DIR.mkdir(parents=True)
    cfg, params, reqs, single = mesh_cuts_single()
    t_single = time.perf_counter() - t0
    t = time.perf_counter()
    ranks = run_ranks(mesh_cuts_rank, 4, MESH_CUTS_DIR / "ranks",
                      backend="gloo", timeout_s=600, threads=2)
    t_gloo = time.perf_counter() - t
    _, _, mla32, reduced = mesh_cuts_cfgs()
    failed = []
    g = cfg.d_ff // cfg.ffn_sparsity.n
    routes = [(r["route"]["groups"], r["route"]["tables"],
               r["route"]["block_route"]) for r in ranks]
    print(f"[mesh-cuts] four gloo ranks sharing the card: {device_line()}")
    print(f"[mesh-cuts] (a) smollm-360m at full width, {cfg.n_layers} of 32 "
          f"layers, route_share {MESH_CUTS_SHARE}: {g} groups of up and "
          f"gate, {g // MESH_CUTS_SHARE} route tables, {g // 4} groups a "
          f"rank on 1x4; each rank's groups, route and block_route: "
          f"{routes}")
    if any(r["route"]["block_route"] != (g // 4, *r["route"]["tables"][1:])
           for r in ranks):
        failed.append("(a) a rank's block of groups has no route of its own")
    err = max(r["f32_err"] for r in ranks)
    print(f"[mesh-cuts] (a) f32 prefills and {MESH_CUTS_FORCED} forced decode "
          f"steps holding the single-device k-WTA selections: largest "
          f"|logits - single| {err:.3e} (tol {MESH_SERVE_TOL:.0e})")
    if not (err <= MESH_SERVE_TOL and all(r["held_all"] for r in ranks)):
        failed.append("(a) f32 logits part from the single device")
    numbers = {"a": {"f32_err": err}}

    def grads_line(label, gs):
        loss = max(abs(x["loss"] - x["loss_single"]) / abs(x["loss_single"])
                   for x in gs)
        worst = max(gs, key=lambda x: x["worst"])
        print(f"[mesh-cuts] {label} one loss and backward on the blocks "
              f"against the single device (selections and router choices "
              f"held): loss {gs[0]['loss']:.6f} (single "
              f"{gs[0]['loss_single']:.6f}, relative difference {loss:.3e}, "
              f"tol {MESH_TOL['loss_rel']:.0e}), {worst['leaves']} gradient "
              f"leaves, largest error {worst['worst']:.3e}·(1+max|g|) at "
              f"{worst['worst_leaf']} (tol {MESH_GRAD_TOL:.0e}); leaves "
              f"missing {max(x['missing'] for x in gs)}; param blocks handed "
              f"to a collective {sum(len(x['handed']) for x in gs)}")
        if not (loss <= MESH_TOL["loss_rel"] and worst["worst"] <=
                MESH_GRAD_TOL) or any(x["missing"] or x["handed"]
                                      for x in gs):
            failed.append(f"{label} gradients part from the single device")
        return {"loss_rel": loss, "grad_err": worst["worst"]}

    numbers["a"]["grads"] = grads_line("(a)", [r["grads"] for r in ranks])
    move = max(r["bf16_move"] for r in ranks)
    margin = max(TIE_MARGIN, 2 * move)
    got = [r["serve"] for r in ranks]
    if any(x["tokens"] != got[0]["tokens"] for x in got):
        failed.append("(a) ranks took other tokens")
    parted = same_tokens(cfg, params, reqs, single["tokens"],
                         got[0]["tokens"], "(a) 1x4 bf16",
                         phase="mesh-cuts", margin=margin)
    per_step = [x["launches"] / x["steps"] for x in got]
    print(f"[mesh-cuts] (a) bf16 tokens of phase 4's workload against the "
          f"single device: {len(reqs) - parted} requests identical, "
          f"{parted} parted at a tie of the top two (bound {margin:.3e}); "
          f"topk_gather launches a decode step on each rank {per_step} "
          f"(want {cfg.n_layers}), in the prefills "
          f"{[x['prefill_launches'] for x in got]}; collectives handed a "
          f"param or cache block {[x['handed'] for x in got]}")
    if any(p != cfg.n_layers for p in per_step) or any(
            x["prefill_launches"] or x["handed"] for x in got):
        failed.append("(a) topk_gather launches or a block handed over")
    numbers["a"].update(parted=parted, bf16_move=move,
                        launches_per_step=per_step[0])
    long = [r["long"] for r in ranks]
    err = max(x["err"] for x in long)
    per_step = [x["launches"] / x["steps"] for x in long]
    print(f"[mesh-cuts] (b) {MOE_ARCH} at full width, {mla32.n_layers} of 27 "
          f"layers, f32, 2x2 under decode_long: one row stepped through "
          f"{MESH_CUTS_PROMPT} tokens holding the single-device selections "
          f"and router choices, largest |logits - single| {err:.3e} (tol "
          f"{MESH_SERVE_TOL:.0e}); the latent rows ({MESH_CUTS_SEQ}) over "
          f"{long[0]['axes']}, each rank's block (reckoned "
          f"{MESH_CUTS_SEQ // 4} rows): "
          f"{[(x['coords'], x['block'], x['ckv']) for x in long]}; "
          f"topk_gather launches a step on each rank {per_step} (want "
          f"{mla32.n_layers})")
    blocks = sorted(x["block"] for x in long)
    if not (err <= MESH_SERVE_TOL and all(x["held_all"] for x in long)):
        failed.append("(b) f32 logits part from the single device")
    if tuple(long[0]["axes"]) != ("data", "model") or blocks != [
            (i * MESH_CUTS_SEQ // 4, (i + 1) * MESH_CUTS_SEQ // 4)
            for i in range(4)] or any(
            x["ckv"][1] != MESH_CUTS_SEQ // 4 for x in long):
        failed.append("(b) the latent rows are not split over both axes")
    if any(p != mla32.n_layers for p in per_step):
        failed.append("(b) topk_gather launches")
    numbers["b"] = {"err": err, "launches_per_step": per_step[0]}
    for i, ((arch, kw), c) in enumerate(zip(MESH_CUTS_REDUCED, reduced)):
        rs = [r["reduced"][i] for r in ranks]
        err = max(x["err"] for x in rs)
        label = f"(c) {arch} reduced({kw})"
        print(f"[mesh-cuts] {label}, f32, 1x4: prefills and "
              f"{MESH_CUTS_FORCED} forced decode steps holding the "
              f"single-device selections and router choices, largest "
              f"|logits - single| {err:.3e} (tol {MESH_SERVE_TOL:.0e})")
        if not (err <= MESH_SERVE_TOL and all(x["held_all"] for x in rs)):
            failed.append(f"{label} logits part from the single device")
        numbers[arch] = {"err": err, "grads": grads_line(
            label, [x["grads"] for x in rs])}
    numbers.update(single_s=t_single, gloo_s=t_gloo,
                   phase_s=time.perf_counter() - t0)
    print(f"[mesh-cuts] numbers {json.dumps(numbers)}")
    shutil.rmtree(MESH_CUTS_DIR, ignore_errors=True)
    if failed:
        fail("mesh-cuts: " + "; ".join(failed))
    return {"launches_mesh_cuts_per_decode_step": numbers["a"][
        "launches_per_step"],
        "launches_mesh_cuts_long_per_step": numbers["b"][
            "launches_per_step"]}


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
    torch.cuda.empty_cache()
    t = time.perf_counter()
    row.update(phase_hybrid())
    print(f"[hybrid] done in {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    phase_mesh()
    print(f"[mesh] done in {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    row.update(phase_mesh_serve())
    print(f"[mesh-serve] done in {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    row.update(phase_mesh_moe())
    print(f"[mesh-moe] done in {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    phase_roofline([row] + rows)
    print(f"[roofline] done in {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    row.update(phase_mesh_ssm())
    print(f"[mesh-ssm] done in {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    row.update(phase_examples())
    print(f"[examples] done in {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    row.update(phase_mesh_cuts())
    print(f"[mesh-cuts] done in {time.perf_counter() - t:.1f} s")

    print(json.dumps({"kernels": [row] + rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

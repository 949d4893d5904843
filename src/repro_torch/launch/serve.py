"""Continuous-batching inference engine: fused prefill + slot decode, on the
contiguous KV cache.

The serving subsystem the paper's throughput claim lands on: weight
sparsity (CS-packed projections) and activation sparsity (k-WTA) both cut
per-token decode cost, and the batched-decode regime is where the two
multiply — so the engine's job is to keep the decode batch full.

  * ``Engine`` owns a fixed pool of ``n_slots`` KV-cache slots (the decode
    batch) and runs:
      - *fused prefill* — ONE forward per prompt
        (:func:`repro_torch.models.transformer.prefill`) that writes the
        prompt's KV rows in bulk; prompts are padded to power-of-two
        buckets, as in the reference;
      - *slot insert* — copies the prefilled single-request cache into its
        batch row, in place;
      - *decode step* — one token for ALL slots per call, with per-slot
        positions, so requests at different depths share every matmul.
  * :class:`repro_torch.runtime.scheduler.Scheduler` owns policy: FIFO
    admission into free slots mid-flight, retirement on token budget /
    EOS, and greedy or temperature/top-k sampling on host.

``Engine.generate_static`` keeps the static-batch greedy path (stepwise
prefill through the decode step) as the correctness oracle.

The engine runs on ``cuda`` unless ``device`` names another; with the
sparse-sparse config its decode steps send every FFN down projection to
the ``topk_gather`` CUDA kernel.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --slots 4 --requests 8 --prompt-len 16 --gen 32 [--full] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device
from repro_torch.runtime.scheduler import (Request, SamplingParams, Scheduler,
                                           sample_token)


def _bucket(n: int, max_seq: int) -> int:
    """Next power-of-two prompt bucket (>= 8): prompts of one bucket run
    prefill at one shape."""
    b = 8
    while b < n:
        b *= 2
    return min(b, max_seq)


def _host_row(logits: torch.Tensor) -> np.ndarray:
    """Logits to the host for sampling (float32 holds every bf16 value)."""
    return logits.float().cpu().numpy()


class Engine:
    """Continuous-batching server for one model on one device.

    ``use_pallas`` overrides the kernel-executor flag on both sparsity
    families (cfg.ffn_sparsity / cfg.proj_sparsity): 'auto' or 'force'
    (the topk_gather kernel wrapper) or 'off' (the PyTorch formula).
    ``params`` (e.g. from :mod:`repro_torch.bridge`) must lie on
    ``device``; without them the engine draws random weights from seed 0,
    as the reference does."""

    def __init__(self, cfg, max_seq: int, n_slots: int = 4, params=None,
                 use_pallas: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        if use_pallas is not None:
            cfg = dataclasses.replace(
                cfg,
                ffn_sparsity=dataclasses.replace(
                    cfg.ffn_sparsity, use_pallas=use_pallas),
                proj_sparsity=dataclasses.replace(
                    cfg.proj_sparsity, use_pallas=use_pallas))
        self.cfg = cfg
        self.max_seq = max_seq
        self.n_slots = n_slots
        self.params = (params if params is not None
                       else T.init_model(cfg, seed=0, device=self.device))
        self.prefill_calls = 0  # one per admitted prompt (tests assert)

    def new_cache(self, batch: int):
        return T.init_cache(self.cfg, batch, self.max_seq, self.device)

    @staticmethod
    def _insert(cache, frag, slot: int):
        """Copy a (1, max_seq, ...) prefill fragment into batch row
        ``slot`` of the live cache, in place."""
        for c, f in zip(cache, frag, strict=True):
            for name, leaf in c.items():
                leaf[slot].copy_(f[name][0])
        return cache

    def _prefill(self, prompt: Sequence[int]):
        """One fused-prefill call. Returns (last-position logits (vocab,)
        on the host, cache fragment of batch 1).  Rejects prompts longer
        than ``max_seq`` rather than truncate them."""
        p_len = len(prompt)
        if p_len > self.max_seq:
            raise ValueError(
                f"prompt length {p_len} exceeds max_seq {self.max_seq}; "
                "refusing to truncate")
        bucket = _bucket(p_len, self.max_seq)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :p_len] = np.asarray(prompt, np.int64)
        logits, frag = T.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            self.cfg, self.max_seq)
        self.prefill_calls += 1
        return _host_row(logits[0, p_len - 1]), frag

    # -- continuous-batching loop -------------------------------------------
    @torch.no_grad()
    def serve(self, requests: Sequence[Request]):
        """Run every request to completion with continuous batching.

        Returns (outputs, stats): outputs maps request uid -> generated
        token list; stats has tok/s, time-to-first-token per request, the
        decode-step and prefill-call counts and the time spent in decode
        steps.
        """
        for r in requests:
            if r.max_new_tokens < 1:
                raise ValueError(f"request {r.uid}: max_new_tokens must "
                                 "be >= 1 (the first token comes from "
                                 "prefill)")
            if len(r.prompt) < 1:
                raise ValueError(f"request {r.uid}: prompt must hold at "
                                 "least one token")
            if len(r.prompt) + r.max_new_tokens > self.max_seq:
                raise ValueError(
                    f"request {r.uid}: prompt {len(r.prompt)} + "
                    f"max_new {r.max_new_tokens} exceeds max_seq "
                    f"{self.max_seq}")
        sched = Scheduler(self.n_slots)
        sched.submit_many(requests, now=0.0)
        cache = self.new_cache(self.n_slots)
        tokens = np.zeros((self.n_slots, 1), np.int64)
        pos = np.zeros((self.n_slots,), np.int64)
        n_steps = 0
        decode_s = 0.0
        t0 = time.perf_counter()
        while sched.has_work:
            for slot in sched.admit(now=time.perf_counter() - t0):
                req = slot.request
                row, frag = self._prefill(req.prompt)
                cache = self._insert(cache, frag, slot.index)
                first = sample_token(row, req.sampling, slot.rng)
                sched.record_token(slot, first, now=time.perf_counter() - t0)
                tokens[slot.index, 0] = first
                pos[slot.index] = slot.pos  # == len(prompt)
            # budget-1 requests finish at prefill
            sched.retire_done(now=time.perf_counter() - t0)
            active = sched.active_slots()
            if not active:
                continue
            t_step = time.perf_counter()
            logits, cache = T.serve_step(
                self.params, cache,
                {"tokens": torch.from_numpy(tokens).to(self.device)},
                torch.from_numpy(pos).to(self.device), self.cfg)
            logits = _host_row(logits)
            decode_s += time.perf_counter() - t_step
            n_steps += 1
            now = time.perf_counter() - t0
            for slot in active:
                nxt = sample_token(logits[slot.index], slot.request.sampling,
                                   slot.rng)
                sched.record_token(slot, nxt, now=now)
                tokens[slot.index, 0] = nxt
                slot.pos += 1
                pos[slot.index] = slot.pos
            sched.retire_done(now=time.perf_counter() - t0)
        dt = time.perf_counter() - t0
        total = sum(len(v) for v in sched.finished.values())
        stats = {
            "wall_s": dt,
            "tok_s": total / dt if dt else float("inf"),
            "decode_steps": n_steps,
            "decode_s": decode_s,
            "prefill_calls": self.prefill_calls,
            "ttft_s": dict(sched.ttft),
        }
        return sched.finished, stats

    # -- static-batch oracle -------------------------------------------------
    @torch.no_grad()
    def generate_static(self, prompts: np.ndarray, gen_len: int):
        """Static greedy path: prefill by stepping every prompt position
        through the decode step, then decode the batch in lockstep.  Exact
        but slow — the correctness oracle for the continuous engine."""
        b, p_len = prompts.shape
        cache = self.new_cache(b)
        prompts = torch.from_numpy(np.asarray(prompts, np.int64)).to(
            self.device)
        logits = None
        for pos in range(p_len):
            logits, cache = T.serve_step(self.params, cache,
                                         {"tokens": prompts[:, pos:pos + 1]},
                                         pos, self.cfg)
        out = []
        cur = logits.argmax(dim=-1)[:, None]
        for i in range(gen_len):
            out.append(cur)
            logits, cache = T.serve_step(self.params, cache, {"tokens": cur},
                                         p_len + i, self.cfg)
            cur = logits.argmax(dim=-1)[:, None]
        return torch.cat(out, dim=1).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--use-pallas", choices=("auto", "force", "off"),
                    default=None,
                    help="kernel executor override for the sparse paths "
                    "(default: the config's own setting)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "kernels' plain versions)")
    ap.add_argument("--full", action="store_true",
                    help="run the shipped config at full width (default: "
                    "its reduced() smoke config)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    engine = Engine(cfg, max_seq=args.prompt_len + args.gen + 1,
                    n_slots=args.slots, use_pallas=args.use_pallas,
                    device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).tolist(),
                    max_new_tokens=args.gen,
                    sampling=SamplingParams(temperature=args.temperature,
                                            top_k=args.top_k, seed=i))
            for i in range(args.requests)]
    out, stats = engine.serve(reqs)
    print(f"served {len(out)} requests on {engine.device}, "
          f"{stats['decode_steps']} decode steps, {stats['prefill_calls']} "
          f"prefill calls, {stats['tok_s']:.1f} tok/s; "
          f"sample: {out[0][:16]}")


if __name__ == "__main__":
    main()

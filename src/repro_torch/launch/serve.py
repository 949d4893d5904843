"""Continuous-batching inference engine: fused prefill + slot decode on the
contiguous KV cache, or chunked prefill + decode through page tables on
the paged one.

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
prefill through the decode step) as the correctness oracle; it is also
how the SSM/hybrid patterns (zamba2, xLSTM) are served, since they have no
fused prefill and ``Engine.serve`` refuses them, as the reference does.

Paged KV cache: ``Engine(kv_layout="paged")`` swaps the
``(n_slots, max_seq)`` contiguous cache for a pool of fixed-size pages
(:mod:`repro_torch.runtime.kvcache`) — prompts prefill in page-aligned
chunks interleaved with decode steps (one chunk per loop iteration,
bounding the inter-token gap in-flight requests see when a long prompt
lands), decode reads and writes through per-slot page tables, and
retirement returns pages copy-free.  Under ``kv_policy="grow"`` (the
paged default) admission takes only the prompt's pages, each chain grows
one page at a time as decode crosses page boundaries, and when the pool
runs dry the youngest-admitted slot is preempted (recompute-on-resume);
requests sharing a prompt prefix share physical pages (hash-matched at
admit) with copy-on-write on the first divergent write.
``kv_policy="reserve"`` pins every request's worst case at admit, the
scheduling oracle.  Greedy tokens equal the contiguous layout's, which
stays the default.

The engine runs on ``cuda`` unless ``device`` names another; with the
sparse-sparse config its decode steps send every FFN down projection (a
MoE block's: its shared experts') to the ``topk_gather`` CUDA kernel, on
either layout.  The cache's leaves (bf16 or int8 rows and scales, MLA's
latent and rope-key rows) go through the insert, the page pools and
copy-on-write alike.

On a mesh (``mesh=``, a :class:`repro_torch.launch.mesh.Mesh` of
(data, model), one process a rank) every rank holds exactly the
reference's per-device blocks of the weights and the cache under
``make_rules(mesh, "decode")`` (:mod:`repro_torch.sharding.serving` lists
them), runs the same scheduler on the same logits and so samples the
same tokens; a decode step moves activations between ranks, never a
weight.  The contiguous cache's slots shard over ``data`` where they
divide; the page pools hold every page on every rank, so a paged step
computes every slot.  A one-rank mesh is the engine without one.  Every
block pattern is served on a mesh of more than one rank: the GQA and MLA
families, MoE (experts parallel over ``model``), the int8 cache, the
frontends' inputs, and the SSM/hybrid patterns (Mamba2, zamba2's shared
attention block, mLSTM, sLSTM) through :meth:`Engine.generate_static`.

Telemetry: pass ``telemetry=repro_torch.obs.Telemetry.on(...)`` and the
engine traces host-clock spans around every stage (``schedule.admit`` /
``prefill`` / ``insert`` / ``decode.step`` / ``sample``, and on the paged
layout ``prefill.chunk`` / ``kv.cow``), samples queue-depth and
slot-occupancy gauges each step, keeps per-request lifecycle records
(scheduler-side), attributes the execution paths of its first decode step
(``repro_torch.core.api.observe_dispatch``), and — every
``telemetry.sparsity_every`` steps — runs the decode step under a support
capture, so realized activation sparsity and cross-step winner overlap
are measured from what actually ran.  ``Engine.metrics_snapshot()``
returns the whole picture as a JSON-ready dict, live or at end of run.
With the default ``telemetry=None`` everything degrades to null objects,
and an unprobed step issues the same device work, with no more host
syncs, whether telemetry is on or off.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --slots 4 --requests 8 --prompt-len 16 --gen 32 [--full] [--device cpu]
      [--kv-layout paged --page-size 8 --n-pages 13]
      [--telemetry] [--telemetry-jsonl PATH]
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
      --arch smollm-360m --mesh 2x2 --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from collections import deque
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.api import observe_dispatch
from repro_torch.launch.mesh import join_process_group, parse_mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device
from repro_torch.obs import DispatchStats, SparsityStats, Telemetry
from repro_torch.obs import sparsity as obs_sparsity
from repro_torch.runtime.kvcache import (NULL_PAGE, BlockAllocator, PagedKV,
                                         prefix_keys)
from repro_torch.runtime.scheduler import (Request, RequestRecord,
                                           SamplingParams, Scheduler,
                                           sample_token)
from repro_torch.sharding.serving import Shards, use_serving


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
    """Continuous-batching server for one model on one device or a mesh.

    ``use_pallas`` overrides the kernel-executor flag on both sparsity
    families (cfg.ffn_sparsity / cfg.proj_sparsity): 'auto' or 'force'
    (the topk_gather kernel wrapper) or 'off' (the PyTorch formula).
    ``params`` (e.g. from :mod:`repro_torch.bridge`) must lie on
    ``device``; without them the engine draws random weights from seed 0,
    as the reference does.

    ``kv_layout="paged"`` serves from a pool of ``n_pages`` pages of
    ``page_size`` rows (default: full backing) with prompts prefilled in
    chunks of ``prefill_chunk`` rows (a multiple of ``page_size``;
    default four pages), under ``kv_policy`` "grow" or "reserve".

    ``telemetry`` (a :class:`repro_torch.obs.Telemetry`; default off)
    receives the engine's metrics, spans and sparsity probes.

    ``mesh`` (default none: one device) serves on a (data, model) mesh:
    ``params``, when given, are whole (as :func:`repro_torch.bridge.
    params_from_jax` makes them) and each rank keeps its blocks; without
    them each rank draws only its blocks of seed 0's weights.  The engine
    runs on the mesh's device unless ``device`` says otherwise."""

    def __init__(self, cfg, max_seq: int, n_slots: int = 4, params=None,
                 use_pallas: Optional[str] = None, device=None,
                 telemetry: Optional[Telemetry] = None,
                 kv_layout: str = "contiguous", page_size: int = 16,
                 n_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 kv_policy: str = "grow", mesh=None):
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"kv_layout must be 'contiguous' or 'paged', "
                             f"got {kv_layout!r}")
        if kv_policy not in ("reserve", "grow"):
            raise ValueError(f"kv_policy must be 'reserve' or 'grow', "
                             f"got {kv_policy!r}")
        if mesh is not None and not mesh.live:
            raise RuntimeError(f"mesh {mesh.dims} has no process group of "
                               "its size: it cannot run collectives")
        self.device = resolve_device(
            device if device is not None or mesh is None else mesh.device)
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
        self.mesh = mesh
        #: the rank's place on a mesh of more than one rank, else None
        self.shards = Shards.of(mesh, max_seq)
        self.rules = None if self.shards is None else self.shards.rules
        if params is None:      # on a mesh, each rank draws only its blocks
            self.params = T.init_model(cfg, seed=0, device=self.device,
                                       rules=self.rules)
        elif self.shards is not None:   # each rank keeps its blocks
            self.params = T.param_blocks(params, cfg, self.rules)
        else:
            self.params = params
        self.prefill_calls = 0  # one per admitted prompt (tests assert)
        #: per-request lifecycle records of the last ``serve`` call
        self.records: Dict[int, RequestRecord] = {}
        self.kv_layout = kv_layout
        self.kv_policy = kv_policy
        self.kv_geo: Optional[PagedKV] = None
        if kv_layout == "paged":
            self.kv_geo = PagedKV.build(max_seq, n_slots,
                                        page_size=page_size,
                                        n_pages=n_pages)
            # page-aligned chunk bucket: long prompts prefill in slabs of
            # this many rows, one slab per serve-loop iteration
            self.prefill_chunk = (prefill_chunk if prefill_chunk is not None
                                  else min(4 * self.kv_geo.page_size,
                                           self.kv_geo.view_len))
            self.kv_geo.chunk_spans(1, self.prefill_chunk)  # validates
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry.off())
        self._sparsity = SparsityStats(self.telemetry.registry)
        self._dispatch = DispatchStats()

    def new_cache(self, batch: int):
        """The contiguous cache of ``batch`` slots (the rank's blocks on a
        mesh)."""
        return T.init_cache(self.cfg, batch, self.max_seq, self.device,
                            self.rules)

    def new_paged_cache(self):
        """The page pools (``kv_layout='paged'``): one dict per layer of
        leaves shaped (n_pages, page_size, ...), addressed through per-slot
        page tables instead of batch rows (the rank's blocks on a
        mesh)."""
        geo = self.kv_geo
        return T.init_paged_cache(self.cfg, geo.n_pages, geo.page_size,
                                  self.device, self.rules)

    def on_mesh(self):
        """The context the model calls run in: the rank's place on the
        mesh (nothing without one)."""
        return use_serving(self.shards)

    def _to_device(self, a) -> torch.Tensor:
        """Token ids, positions or page tables as int64 on the device."""
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    def _insert(self, cache, frag, slot: int):
        """Copy a (1, max_seq, ...) prefill fragment into batch row
        ``slot`` of the live cache, in place.  On a mesh whose cache holds
        a block of slots only the rank holding ``slot`` copies (the
        fragment is already the rank's block of rows or heads)."""
        rows = self.shards and self.shards.batch_rows(self.n_slots)
        if rows:
            if not rows.start <= slot < rows.stop:
                return cache
            slot -= rows.start
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
        logits, frag = T.prefill(self.params,
                                 {"tokens": self._to_device(toks)},
                                 self.cfg, self.max_seq)
        self.prefill_calls += 1
        self.telemetry.registry.counter("serve.prefill_calls").inc()
        return _host_row(logits[0, p_len - 1]), frag

    def _prefill_chunk(self, cache, tokens: Sequence[int], table: np.ndarray,
                       start: int) -> torch.Tensor:
        """One page-aligned chunk of one slot's prompt, padded to
        ``prefill_chunk`` rows, through the paged cache (written in
        place).  ``table``: the slot's (1, n_blocks) page table.  Returns
        the logits of the chunk's last true row, on the device."""
        ln = len(tokens)
        buf = np.zeros((1, self.prefill_chunk), np.int64)
        buf[0, :ln] = np.asarray(tokens, np.int64)
        logits, _ = T.prefill_chunk(
            self.params, cache, {"tokens": self._to_device(buf)}, start, ln,
            self.cfg, self._to_device(table))
        return logits[0, ln - 1]

    def _decode_step(self, cache, tokens: np.ndarray, pos: np.ndarray,
                     tables: Optional[np.ndarray] = None,
                     probed: bool = False):
        """One decode step of every slot (the cache written in place);
        with ``tables`` through the paged cache.  Returns the
        (n_slots, vocab) logits on the host and, for a ``probed`` step, the
        capture: the same step run under ``capture_supports``, whose
        tensors reach the host only after the logits have."""
        capture = (obs_sparsity.capture_supports() if probed
                   else contextlib.nullcontext())
        with capture as cap:
            logits, _ = T.serve_step(
                self.params, cache, {"tokens": self._to_device(tokens)},
                self._to_device(pos), self.cfg,
                pages=None if tables is None else self._to_device(tables))
        return _host_row(logits), cap

    def _observe_step(self):
        """The dispatch observer for this decode step: active for the
        engine's first decode step with telemetry on (sealed after it, so
        the sites describe one step), else a null context."""
        if self.telemetry.enabled and not self._dispatch.sealed:
            return observe_dispatch(self._dispatch.on_event)
        return contextlib.nullcontext()

    # -- continuous-batching loop -------------------------------------------
    @torch.no_grad()
    def serve(self, requests: Sequence[Request]):
        """Run every request to completion with continuous batching.

        Returns (outputs, stats): outputs maps request uid -> generated
        token list; stats has tok/s, time-to-first-token per request, the
        decode-step and prefill-call counts and the time spent in decode
        steps.  With ``kv_layout='paged'`` the loop of
        :meth:`_serve_paged` runs instead.  SSM/hybrid block patterns have
        no fused prefill and raise: serve them with
        :meth:`generate_static`.
        """
        with self.on_mesh():
            return self._serve(requests)

    def _serve(self, requests: Sequence[Request]):
        """The body of :meth:`serve`."""
        if not T.supports_fused_prefill(self.cfg):
            raise NotImplementedError(
                f"{self.cfg.name}: block pattern {self.cfg.block_pattern} "
                "has no fused prefill; serve with generate_static")
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
        if self.kv_layout == "paged":
            return self._serve_paged(requests)
        tel = self.telemetry
        tracer = tel.tracer
        reg = tel.registry
        g_queue = reg.gauge("serve.queue_depth")
        g_active = reg.gauge("serve.slots_active")
        g_occ = reg.gauge("serve.slot_occupancy")
        h_prefill = reg.histogram("serve.prefill_s")
        h_step = reg.histogram("serve.decode_step_s")
        h_step_recent = reg.rolling_histogram("serve.decode_step_recent_s")
        c_steps = reg.counter("serve.decode_steps")
        probe_every = tel.sparsity_every if tel.enabled else 0
        sched = Scheduler(self.n_slots, telemetry=tel)
        self.records = sched.records
        sched.submit_many(requests, now=0.0)
        cache = self.new_cache(self.n_slots)
        tokens = np.zeros((self.n_slots, 1), np.int64)
        pos = np.zeros((self.n_slots,), np.int64)
        n_steps = 0
        decode_s = 0.0
        t0 = time.perf_counter()
        while sched.has_work:
            with tracer.span("schedule.admit"):
                admitted = sched.admit(now=time.perf_counter() - t0)
            for slot in admitted:
                req = slot.request
                self._sparsity.reset_row(slot.index)
                t_pre = time.perf_counter()
                with tracer.span("prefill", uid=req.uid,
                                 prompt_len=len(req.prompt)):
                    row, frag = self._prefill(req.prompt)
                    with tracer.span("insert"):
                        cache = self._insert(cache, frag, slot.index)
                h_prefill.observe(time.perf_counter() - t_pre)
                with tracer.span("sample"):
                    first = sample_token(row, req.sampling, slot.rng)
                sched.record_token(slot, first, now=time.perf_counter() - t0)
                tokens[slot.index, 0] = first
                pos[slot.index] = slot.pos  # == len(prompt)
            # budget-1 requests finish at prefill
            sched.retire_done(now=time.perf_counter() - t0)
            active = sched.active_slots()
            g_queue.set(len(sched.queue))
            g_active.set(len(active))
            g_occ.set(len(active) / self.n_slots)
            if not active:
                continue
            probed = probe_every > 0 and n_steps % probe_every == 0
            t_step = time.perf_counter()
            # the span closes after the logits reach the host: it holds
            # the step's device time
            with tracer.span("decode.step", probed=probed), \
                    self._observe_step():
                logits, cap = self._decode_step(cache, tokens, pos,
                                                probed=probed)
            self._dispatch.seal()
            dt_step = time.perf_counter() - t_step
            decode_s += dt_step
            h_step.observe(dt_step)
            h_step_recent.observe(dt_step)
            c_steps.inc()
            n_steps += 1
            if probed:
                self._sparsity.update(cap.to_host(), cap.meta,
                                      active_rows=[s.index for s in active])
            now = time.perf_counter() - t0
            with tracer.span("sample"):
                for slot in active:
                    nxt = sample_token(logits[slot.index],
                                       slot.request.sampling, slot.rng)
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
        if tel.enabled:
            tel.emit({"kind": "snapshot",
                      "metrics": self.metrics_snapshot()})
        return sched.finished, stats

    # -- paged serve loop -----------------------------------------------------
    def _serve_paged(self, requests: Sequence[Request]):
        """Paged serve loop: admit-by-pages -> chunked prefill (one chunk
        per iteration, interleaved with decode) -> decode through the
        page tables -> retire (copy-free page reclamation).

        Differences from the contiguous loop:

        * Admission is gated on FREE PAGES, not just free slots.  Under
          ``kv_policy="reserve"`` the queue head reserves
          ``ceil((prompt + max_new) / page_size)`` pages at admit, so
          decode can never run out mid-request.  Under ``"grow"`` it
          takes only its PROMPT pages — minus any prefix pages adopted
          from the allocator's hash index — and decode pages arrive
          lazily: each iteration extends every decoding slot's chain
          (oldest-admitted first) to cover its next write, preempting the
          youngest-admitted slot when the pool is dry
          (recompute-on-resume; pre-validation of every request's worst
          case against the whole pool makes a sole survivor always able
          to finish, so eviction cannot livelock).
        * Writes into a page held by more than one chain break the
          sharing first: the allocator swaps in a private page and
          :func:`~repro_torch.models.transformer.copy_cache_page` copies
          the rows on the device before the write, so prefix sharing
          never changes any request's tokens.
        * A long prompt no longer stalls in-flight decode for its whole
          prefill: each iteration forwards at most ONE page-aligned chunk
          of the oldest prefilling slot, then decodes the slots whose
          prompts are fully cached.
        * The decode step receives the per-slot page tables; rows of
          slots that are free or still prefilling are nulled for the
          step, so their (ignored) writes sink into the null page
          instead of a live chain.

        ``REPRO_KV_CHECK=1`` runs ``alloc.check()`` every loop iteration
        (instead of only on drain).
        """
        geo = self.kv_geo
        alloc = BlockAllocator(geo.n_pages, geo.page_size)
        for r in requests:
            need = alloc.pages_needed(len(r.prompt) + r.max_new_tokens)
            if need > alloc.capacity:
                raise ValueError(
                    f"request {r.uid}: needs {need} KV pages, pool holds "
                    f"{alloc.capacity} — raise n_pages")
        grow = self.kv_policy == "grow"
        paranoid = os.environ.get("REPRO_KV_CHECK") == "1"
        tel = self.telemetry
        tracer = tel.tracer
        reg = tel.registry
        g_queue = reg.gauge("serve.queue_depth")
        g_active = reg.gauge("serve.slots_active")
        g_occ = reg.gauge("serve.slot_occupancy")
        h_chunk = reg.histogram("serve.prefill_chunk_s")
        h_step = reg.histogram("serve.decode_step_s")
        h_step_recent = reg.rolling_histogram("serve.decode_step_recent_s")
        c_steps = reg.counter("serve.decode_steps")
        c_chunks = reg.counter("serve.prefill_chunks")
        c_cow = reg.counter("serve.cow_copies")
        c_grow = reg.counter("serve.kv_grow_pages")
        probe_every = tel.sparsity_every if tel.enabled else 0
        sched = Scheduler(self.n_slots, telemetry=tel, allocator=alloc,
                          kv_policy=self.kv_policy)
        self.records = sched.records
        sched.submit_many(requests, now=0.0)
        tables = geo.empty_tables(self.n_slots)
        chunk = self.prefill_chunk
        ps = geo.page_size
        n_chunks = 0
        n_cow = 0
        n_cow_inplace = 0
        n_grown = 0
        max_concurrent = 0
        prefillq: deque = deque()  # slots mid-prompt, FIFO

        def _evict(victim):
            """Preempt ``victim``: null its page table, drop it from the
            prefill queue, hand the request back to the scheduler
            (pages released, request re-queued at the head)."""
            geo.clear_chain(tables, victim.index)
            if victim in prefillq:
                prefillq.remove(victim)
            sched.preempt(victim, now=time.perf_counter() - t0)

        def _ensure_free(n, requester):
            """Free >= ``n`` pages by preempting youngest-admitted slots
            (least service lost, FIFO order preserved on requeue).
            Returns False when ``requester`` itself was the victim —
            the caller's slot is gone and its work this iteration is
            abandoned."""
            while alloc.free_pages < n:
                victim = sched.preemption_victim()
                if victim is None:
                    raise RuntimeError(
                        "KV pool exhausted with no slot to preempt")
                _evict(victim)
                if victim is requester:
                    return False
            return True

        def _cow(slot, blk):
            """Break sharing of chain page ``blk`` before ``slot``
            writes there.  Returns False when the slot lost its chain
            while freeing a page for the copy."""
            nonlocal n_cow, n_cow_inplace
            uid = slot.request.uid
            if not alloc.page_shared(uid, blk):
                return True
            if alloc.free_pages < 1 and not _ensure_free(1, slot):
                return False
            cow = alloc.cow_page(uid, blk)
            if cow is None:
                # _ensure_free just preempted the page's only co-holder
                # (the youngest slot is typically the prefix-adopter):
                # the page is uniquely held now — write in place, no copy
                n_cow_inplace += 1
                return True
            old, new = cow
            # dispatch only: nothing waits for the copy to land
            with tracer.span("kv.cow", uid=uid, block=blk):
                T.copy_cache_page(cache, old, new)
            geo.set_chain(tables, slot.index, alloc.chain(uid))
            n_cow += 1
            c_cow.inc()
            return True

        cache = self.new_paged_cache()
        tokens = np.zeros((self.n_slots, 1), np.int64)
        pos = np.zeros((self.n_slots,), np.int64)
        n_steps = 0
        decode_s = 0.0
        t0 = time.perf_counter()
        while sched.has_work:
            if paranoid:
                alloc.check()
            with tracer.span("schedule.admit"):
                admitted = sched.admit(now=time.perf_counter() - t0,
                                       chunked=True)
            for slot in admitted:
                self._sparsity.reset_row(slot.index)
                geo.set_chain(tables, slot.index,
                              alloc.chain(slot.request.uid))
                prefillq.append(slot)
            max_concurrent = max(max_concurrent, len(sched.active_slots()))
            # ONE chunk per iteration: prefill progress is interleaved
            # with decode so in-flight slots keep emitting tokens.
            if prefillq:
                slot = prefillq[0]
                req = slot.request
                start = slot.prefill_pos
                ln = min(chunk, len(req.prompt) - start)
                # chunk rows may land in adopted prefix pages (an
                # exact-duplicate prompt re-prefills its final token into
                # the sharer's last page): break the sharing first.  _cow
                # can preempt, including this very slot — then skip the
                # chunk, the request is back in the queue.
                ok = True
                if grow:
                    for blk in range(start // ps,
                                     (start + ln - 1) // ps + 1):
                        if not _cow(slot, blk):
                            ok = False
                            break
                if ok:
                    t_pre = time.perf_counter()
                    # dispatch only: the logits stay on the device
                    with tracer.span("prefill.chunk", uid=req.uid,
                                     start=start, chunk_len=ln):
                        row = self._prefill_chunk(
                            cache, req.prompt[start:start + ln],
                            tables[slot.index:slot.index + 1], start)
                    h_chunk.observe(time.perf_counter() - t_pre)
                    c_chunks.inc()
                    n_chunks += 1
                    slot.prefill_pos += ln
                if ok and not slot.prefilling:  # last chunk
                    prefillq.popleft()
                    self.prefill_calls += 1
                    reg.counter("serve.prefill_calls").inc()
                    if grow:
                        # rows are on the device now — publish the
                        # prompt's pages for later prefix matches
                        alloc.register_chain_prefix(
                            req.uid, prefix_keys(req.prompt, ps))
                    row = _host_row(row)
                    with tracer.span("sample"):
                        first = sample_token(row, req.sampling, slot.rng)
                    sched.record_token(slot, first,
                                       now=time.perf_counter() - t0)
                    tokens[slot.index, 0] = first
                    pos[slot.index] = slot.pos  # == len(prompt)
            # budget-1 requests finish at prefill
            for slot in sched.retire_done(now=time.perf_counter() - t0):
                geo.clear_chain(tables, slot.index)
            if grow:
                # grow every decoding slot's chain to cover its next
                # write, oldest-admitted first (the youngest is the
                # preemption victim, so growing oldest-first means a
                # victim's freed pages go to the slots that keep
                # running).  A slot evicted by an earlier _ensure_free
                # in this very loop shows up as not busy — skip it.
                for slot in sorted(sched.decoding_slots(),
                                   key=lambda s: s.admit_seq):
                    if not slot.busy:
                        continue
                    uid = slot.request.uid
                    evicted = False
                    while alloc.chain_len(uid) <= slot.pos // ps:
                        if alloc.free_pages < 1 \
                                and not _ensure_free(1, slot):
                            evicted = True
                            break
                        alloc.extend(uid, 1)
                        n_grown += 1
                        c_grow.inc()
                    if evicted or not slot.busy:
                        continue
                    # the write row may sit in a page adopted from a
                    # prompt-prefix match: break the sharing first
                    if not _cow(slot, slot.pos // ps):
                        continue
                    geo.set_chain(tables, slot.index, alloc.chain(uid))
            active = sched.decoding_slots()
            g_queue.set(len(sched.queue))
            g_active.set(len(active))
            g_occ.set(len(active) / self.n_slots)
            if not active:
                continue
            # Null the page-table rows of slots sitting this step out
            # (free, or mid-prefill): their stale token/pos rows still
            # ride the batch, but their writes sink to the null page.
            step_tables = tables.copy()
            decoding = {s.index for s in active}
            for i in range(self.n_slots):
                if i not in decoding:
                    step_tables[i, :] = NULL_PAGE
            probed = probe_every > 0 and n_steps % probe_every == 0
            t_step = time.perf_counter()
            with tracer.span("decode.step", probed=probed), \
                    self._observe_step():
                logits, cap = self._decode_step(cache, tokens, pos,
                                                step_tables, probed=probed)
            self._dispatch.seal()
            dt_step = time.perf_counter() - t_step
            decode_s += dt_step
            h_step.observe(dt_step)
            h_step_recent.observe(dt_step)
            c_steps.inc()
            n_steps += 1
            if probed:
                self._sparsity.update(cap.to_host(), cap.meta,
                                      active_rows=[s.index for s in active])
            now = time.perf_counter() - t0
            with tracer.span("sample"):
                for slot in active:
                    nxt = sample_token(logits[slot.index],
                                       slot.request.sampling, slot.rng)
                    sched.record_token(slot, nxt, now=now)
                    tokens[slot.index, 0] = nxt
                    slot.pos += 1
                    pos[slot.index] = slot.pos
            for slot in sched.retire_done(now=time.perf_counter() - t0):
                geo.clear_chain(tables, slot.index)
        dt = time.perf_counter() - t0
        alloc.check()
        if alloc.used_pages:
            raise RuntimeError(f"{alloc.used_pages} KV pages still held "
                               "after the queue drained")
        total = sum(len(v) for v in sched.finished.values())
        stats = {
            "wall_s": dt,
            "tok_s": total / dt if dt else float("inf"),
            "decode_steps": n_steps,
            "decode_s": decode_s,
            "prefill_calls": self.prefill_calls,
            "prefill_chunks": n_chunks,
            "pages_capacity": alloc.capacity,
            "page_size": geo.page_size,
            "kv_policy": self.kv_policy,
            "max_concurrent": max_concurrent,
            "preemptions": sched.preemption_count,
            "prefix_hit_pages": sched.prefix_hit_pages,
            "cow_copies": n_cow,
            "cow_in_place": n_cow_inplace,
            "grown_pages": n_grown,
            "ttft_s": dict(sched.ttft),
        }
        if tel.enabled:
            tel.emit({"kind": "snapshot",
                      "metrics": self.metrics_snapshot()})
        return sched.finished, stats

    # -- telemetry read side -------------------------------------------------
    def metrics_snapshot(self) -> dict:
        """JSON-ready snapshot of everything the telemetry layer measured.

        Callable live (mid-``serve``) or at end of run:

        * ``metrics`` — registry counters/gauges/histograms (per-request
          TTFT and inter-token latency histograms, queue-depth and
          slot-occupancy gauges, stage latency histograms);
        * ``stages`` — the spans' host-clock totals and counts from the
          tracer;
        * ``requests`` — per-request lifecycle records keyed by uid, for
          every submitted request (ones still queued or decoding appear
          with ``status`` "queued"/"in_flight" and partial timings);
        * ``sparsity`` — per-layer realized k/N and cross-step winner
          overlap from the probed decode steps, plus the execution-path
          attribution of the first decode step (topk/hadamard/dense ×
          backend, est. FLOP shares, est. sparse-vs-dense decode time
          split, and the shared memory of each ``topk[cuda]`` launch).
        """
        stages = self.telemetry.tracer.totals()
        decode_total = stages.get("decode.step", {}).get("total_s")
        return {
            "enabled": self.telemetry.enabled,
            "metrics": self.telemetry.registry.snapshot(),
            "stages": stages,
            "requests": {uid: rec.to_event()
                         for uid, rec in self.records.items()},
            "sparsity": {
                "layers": self._sparsity.summary(),
                "paths": self._dispatch.summary(decode_total),
                "probe_steps": self._sparsity.probes,
            },
        }

    # -- static-batch oracle -------------------------------------------------
    @torch.no_grad()
    def generate_static(self, prompts: np.ndarray, gen_len: int):
        """Static greedy path: prefill by stepping every prompt position
        through the decode step, then decode the batch in lockstep.  Exact
        but slow — the correctness oracle for the continuous engine, and
        the serving path of the SSM/hybrid patterns, whose cache
        (:meth:`new_cache`) holds their recurrent state."""
        with self.on_mesh():
            return self._generate_static(prompts, gen_len)

    def _generate_static(self, prompts: np.ndarray, gen_len: int):
        """The body of :meth:`generate_static`."""
        b, p_len = prompts.shape
        cache = self.new_cache(b)
        prompts = self._to_device(prompts)
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


def build_parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="run the config's reduced() smoke config (the "
                    "default, as in the reference's CLI; --full overrides)")
    ap.add_argument("--full", action="store_true",
                    help="run the shipped config at full width (default: "
                    "its reduced() smoke config)")
    ap.add_argument("--kv-layout", choices=("contiguous", "paged"),
                    default="contiguous",
                    help="KV cache layout: 'paged' decouples KV memory "
                    "from max_seq*slots (block allocator + chunked "
                    "prefill); 'contiguous' is the parity oracle")
    ap.add_argument("--page-size", type=int, default=16,
                    help="token rows per KV page (paged layout)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="KV pool size in pages (default: full backing, "
                    "slots*ceil(max_seq/page_size)+1)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill chunk rows, multiple of page-size "
                    "(default: 4 pages)")
    ap.add_argument("--kv-policy", choices=("reserve", "grow"),
                    default="grow",
                    help="paged admission policy: 'grow' admits on the "
                    "prompt footprint, extends chains lazily and preempts "
                    "(recompute-on-resume) when the pool runs dry; "
                    "'reserve' pins the worst case at admit (the "
                    "scheduling oracle)")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable runtime telemetry (repro_torch.obs) and "
                    "print a metrics snapshot at end of run")
    ap.add_argument("--telemetry-jsonl", default=None, metavar="PATH",
                    help="stream telemetry events to PATH as JSON lines "
                    "(implies --telemetry)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL: serve on a mesh of that many ranks, "
                    "one process a rank under torchrun (its size is "
                    "torchrun's WORLD_SIZE)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="process group backend under torchrun")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    device = args.device
    if "WORLD_SIZE" in os.environ:
        device = join_process_group(args.backend, device)
    try:
        _serve_cli(args, cfg, device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _serve_cli(args, cfg, device):
    mesh = None if args.mesh is None else parse_mesh(args.mesh, device)
    telemetry = None
    if args.telemetry or args.telemetry_jsonl:
        telemetry = Telemetry.on(jsonl_path=args.telemetry_jsonl)
    engine = Engine(cfg, max_seq=args.prompt_len + args.gen + 1,
                    n_slots=args.slots, use_pallas=args.use_pallas,
                    device=device, telemetry=telemetry,
                    kv_layout=args.kv_layout,
                    page_size=args.page_size, n_pages=args.n_pages,
                    prefill_chunk=args.prefill_chunk,
                    kv_policy=args.kv_policy, mesh=mesh)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).tolist(),
                    max_new_tokens=args.gen,
                    sampling=SamplingParams(temperature=args.temperature,
                                            top_k=args.top_k, seed=i))
            for i in range(args.requests)]
    out, stats = engine.serve(reqs)
    if mesh is not None and mesh.rank:
        return              # every rank served the same tokens: rank 0 says
    where = "" if mesh is None else f" mesh {'x'.join(map(str, mesh.dims))}"
    line = (f"served {len(out)} requests on {engine.device}{where}, "
            f"{stats['decode_steps']} decode steps, {stats['prefill_calls']} "
            f"prefill calls, {stats['tok_s']:.1f} tok/s")
    if engine.kv_layout == "paged":
        line += (f"; paged ({stats['kv_policy']}): "
                 f"{stats['prefill_chunks']} prefill chunks, "
                 f"{stats['pages_capacity']} pages of {stats['page_size']}, "
                 f"max concurrent {stats['max_concurrent']}, "
                 f"{stats['preemptions']} preemptions, "
                 f"{stats['grown_pages']} grown pages")
    print(f"{line}; sample: {out[0][:16]}")
    if telemetry is not None:
        print(json.dumps(engine.metrics_snapshot(), indent=2,
                         sort_keys=True))
        telemetry.close()


if __name__ == "__main__":
    main()

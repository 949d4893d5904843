"""Continuous-batching scheduler: slot admission, retirement, sampling.

The serving engine (repro_torch/launch/serve.py) holds a fixed-size decode
batch of ``n_slots`` KV-cache slots; this module owns the *policy* side — a
FIFO queue of requests, which slot each admitted request occupies, per-slot
position tracking, and when a slot retires (token budget or EOS).  It is
pure Python + numpy, so policy is unit-testable without a model.

Sampling lives here too: greedy and temperature/top-k, applied on host to
the per-slot logits row the engine hands over each step.  Per-request
numpy Generators keep sampling deterministic per request regardless of
which slot the request lands in or what else shares the batch.

With a :class:`repro_torch.runtime.kvcache.BlockAllocator` admission is
also gated on KV pages, and under ``kv_policy="grow"`` the engine preempts
slots when the pool runs dry (see :class:`Scheduler`).  The reference's
telemetry hooks (metrics registry, JSONL events) are not ported yet; the
per-request records and the plain-int counters are.
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.kvcache.allocator import prefix_keys


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 -> greedy; top_k == 0 -> full-vocab sampling."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Sequence[int]
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    eos_id: Optional[int] = None


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle of one request through the engine, in seconds relative
    to the serve loop's epoch.  ``itl_*`` aggregate the inter-token
    latencies (gaps between consecutive sampled tokens after the first).
    ``status`` runs "queued" -> "in_flight" -> "finished"."""
    uid: int
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0
    n_tokens: int = 0
    itl_sum: float = 0.0
    itl_count: int = 0
    itl_max: float = 0.0
    status: str = "queued"
    preemptions: int = 0            # times evicted and re-queued

    @property
    def queue_wait_s(self) -> float:
        return max(0.0, self.t_admit - self.t_enqueue)

    @property
    def ttft_s(self) -> float:
        return max(0.0, self.t_first_token - self.t_enqueue)

    def to_event(self) -> Dict:
        """The ``kind="request"`` event of the reference's JSONL schema."""
        ev = {"kind": "request", "uid": self.uid,
              "status": self.status,
              "t_enqueue": round(self.t_enqueue, 6),
              "t_admit": round(self.t_admit, 6),
              "t_first_token": round(self.t_first_token, 6),
              "t_finish": round(self.t_finish, 6),
              "n_tokens": self.n_tokens,
              "queue_wait_s": round(self.queue_wait_s, 6),
              "ttft_s": round(self.ttft_s, 6),
              "preemptions": self.preemptions}
        if self.itl_count:
            ev["itl_mean_s"] = round(self.itl_sum / self.itl_count, 6)
            ev["itl_max_s"] = round(self.itl_max, 6)
        return ev


@dataclasses.dataclass
class Slot:
    """One row of the decode batch."""
    index: int
    request: Optional[Request] = None
    pos: int = 0                    # next cache row to be written
    generated: List[int] = dataclasses.field(default_factory=list)
    rng: Optional[np.random.Generator] = None
    admit_time: float = 0.0
    first_token_time: float = 0.0
    last_token_time: float = 0.0
    prefill_pos: int = 0            # prompt tokens already prefilled
    admit_seq: int = -1             # monotonic admission order (LRU key)

    @property
    def busy(self) -> bool:
        return self.request is not None

    @property
    def prefilling(self) -> bool:
        """Chunked prefill in progress: prompt rows not yet all written.
        The slot holds pages but does not join the decode batch until the
        engine finishes feeding its prompt chunks."""
        return (self.request is not None
                and self.prefill_pos < len(self.request.prompt))

    @property
    def done(self) -> bool:
        r = self.request
        if r is None:
            return False
        if self.generated and r.eos_id is not None \
                and self.generated[-1] == r.eos_id:
            return True
        return len(self.generated) >= r.max_new_tokens


def sample_token(logits: np.ndarray, params: SamplingParams,
                 rng: Optional[np.random.Generator]) -> int:
    """One token from a (vocab,) logits row."""
    if params.temperature <= 0.0:
        return int(np.argmax(logits))
    logits = logits.astype(np.float64) / params.temperature
    if params.top_k > 0 and params.top_k < logits.shape[-1]:
        kth = np.partition(logits, -params.top_k)[-params.top_k]
        logits = np.where(logits < kth, -np.inf, logits)
    logits = logits - logits.max()
    probs = np.exp(logits)
    probs /= probs.sum()
    return int(rng.choice(logits.shape[-1], p=probs))


class Scheduler:
    """FIFO admission into a fixed pool of decode slots.

    With ``allocator`` (a :class:`repro_torch.runtime.kvcache.BlockAllocator`)
    admission is additionally gated on KV pages, under one of two
    policies (``kv_policy``):

    * ``"reserve"`` (reserve-on-admit, the scheduling oracle): the queue
      head needs its worst-case footprint
      ``pages_needed(len(prompt) + max_new_tokens)`` free, reserved in
      full at admit, so decode can never run out of pages mid-request.
    * ``"grow"`` (grow-on-demand): the head needs only
      ``pages_needed(len(prompt))`` — minus any prompt-prefix pages
      already live in the allocator's prefix index, which are adopted
      by reference (:attr:`prefix_hit_pages`).  Decode pages are
      allocated lazily by the engine (``BlockAllocator.extend`` at page
      boundaries); when the pool runs dry the engine preempts the
      youngest-admitted slot (:meth:`preemption_victim` /
      :meth:`preempt` — recompute-on-resume: pages released, request
      re-queued at the head with its generated tokens appended to the
      prompt, sampling state stashed so greedy AND stochastic decoding
      resume token-exactly).

    Strict FIFO either way: a blocked head blocks everything behind it
    (no starvation of long prompts by short ones), and preemption evicts
    youngest-first, so a re-queued victim is still older than everything
    behind it.  Retirement releases the chain copy-free.

    ``REPRO_KV_CHECK=1`` in the environment runs the allocator's
    ``check()`` at every admission, preemption and retirement.
    """

    def __init__(self, n_slots: int, allocator=None,
                 kv_policy: str = "reserve"):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if kv_policy not in ("reserve", "grow"):
            raise ValueError(
                f"kv_policy must be 'reserve' or 'grow', got {kv_policy!r}")
        self.allocator = allocator
        self.kv_policy = kv_policy
        self.slots: List[Slot] = [Slot(i) for i in range(n_slots)]
        self.queue: Deque[Request] = deque()
        self.finished: Dict[int, List[int]] = {}
        self.ttft: Dict[int, float] = {}  # uid -> time of first token
        self.records: Dict[int, RequestRecord] = {}
        self._admit_seq = 0
        # uid -> (generated, rng, first_token_time, last_token_time) of a
        # preempted request, restored verbatim at re-admission so sampling
        # and latency accounting continue as if never evicted
        self._resume: Dict[int, Tuple] = {}
        # uid -> the ORIGINAL prompt, pinned at first preemption: a
        # resumed request's .prompt already embeds the earlier generated
        # tokens, so a second preemption must rebuild from the original
        # (orig + ALL generated), never append to the embedded copy —
        # that would duplicate the first round of tokens in the prompt
        self._orig_prompt: Dict[int, List[int]] = {}
        self.preemption_count = 0
        self.prefix_hit_pages = 0
        self._paranoid = os.environ.get("REPRO_KV_CHECK") == "1"

    def _pages_changed(self) -> None:
        if self.allocator is not None and self._paranoid:
            self.allocator.check()

    # -- queue side ---------------------------------------------------------
    def submit(self, request: Request, now: float = 0.0) -> None:
        self.queue.append(request)
        self.records[request.uid] = RequestRecord(uid=request.uid,
                                                  t_enqueue=now)

    def submit_many(self, requests: Sequence[Request],
                    now: float = 0.0) -> None:
        for r in requests:
            self.submit(r, now=now)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s.busy for s in self.slots)

    # -- slot side ----------------------------------------------------------
    def free_slots(self) -> List[Slot]:
        return [s for s in self.slots if not s.busy]

    def active_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.busy]

    def decoding_slots(self) -> List[Slot]:
        """Busy slots whose prompt is fully in the cache — the rows that
        take part in this iteration's decode step (chunk-prefilling
        slots sit out until their last chunk lands)."""
        return [s for s in self.slots if s.busy and not s.prefilling]

    def admit(self, now: float = 0.0, chunked: bool = False) -> List[Slot]:
        """Move queued requests into free slots (FIFO). Returns the slots
        that were (re)filled this call; the engine prefills each one.

        ``chunked=True`` admits with ``prefill_pos = 0`` (the engine
        feeds the prompt as paged chunks and advances ``prefill_pos``);
        otherwise the prompt is taken as fused-prefilled at admit.  With
        an allocator, the queue head must also fit the free pages
        (strict FIFO — a blocked head blocks the rest): its worst-case
        footprint under ``kv_policy="reserve"``, just its prompt under
        ``"grow"`` — where prompt-prefix pages already in the
        allocator's index are adopted by reference and skipped by
        chunked prefill (``prefill_pos`` starts past them, capped at
        ``len(prompt) - 1`` so the final logits row is always produced
        by a real chunk forward — an exact-duplicate prompt re-runs its
        last token, whose shared-page write the engine breaks with
        copy-on-write)."""
        admitted = []
        for slot in self.slots:
            if slot.busy or not self.queue:
                continue
            req = self.queue[0]
            shared_rows = 0
            if self.allocator is not None:
                a = self.allocator
                if self.kv_policy == "grow":
                    shared = []
                    if chunked:
                        shared = a.match_prefix(
                            prefix_keys(req.prompt, a.page_size))
                    need = a.pages_needed(len(req.prompt)) - len(shared)
                    if not a.can_allocate(need):
                        break  # head-of-line blocking: keep FIFO order
                    a.allocate(req.uid, need, shared=shared)
                    if shared:
                        self.prefix_hit_pages += len(shared)
                        shared_rows = min(len(shared) * a.page_size,
                                          len(req.prompt) - 1)
                else:
                    need = a.pages_needed(
                        len(req.prompt) + req.max_new_tokens)
                    if not a.can_allocate(need):
                        break  # head-of-line blocking: keep FIFO order
                    a.allocate(req.uid, need)
            self.queue.popleft()
            slot.request = req
            slot.pos = len(req.prompt)
            slot.generated = []
            slot.rng = np.random.default_rng(req.sampling.seed)
            slot.admit_time = now
            slot.first_token_time = 0.0
            slot.last_token_time = 0.0
            slot.prefill_pos = shared_rows if chunked else len(req.prompt)
            slot.admit_seq = self._admit_seq
            self._admit_seq += 1
            resume = self._resume.pop(req.uid, None)
            if resume is not None:
                (slot.generated, slot.rng, slot.first_token_time,
                 slot.last_token_time) = resume
            rec = self.records.get(req.uid)
            if rec is not None:
                rec.t_admit = now
                rec.status = "in_flight"
            admitted.append(slot)
        self._pages_changed()
        return admitted

    # -- preemption (kv_policy="grow") --------------------------------------
    def preemption_victim(self, exclude: Sequence[int] = ()) -> \
            Optional[Slot]:
        """The youngest-admitted busy slot (highest ``admit_seq``) not in
        ``exclude`` — the LRU-style eviction choice: it has received the
        least service, so recompute-on-resume re-prefills the fewest
        rows, and re-queueing it at the head preserves global FIFO
        (everything still queued is younger than any admitted slot)."""
        busy = [s for s in self.slots
                if s.busy and s.index not in exclude]
        if not busy:
            return None
        return max(busy, key=lambda s: s.admit_seq)

    def preempt(self, slot: Slot, now: float = 0.0) -> Request:
        """Evict ``slot`` (recompute-on-resume): release its pages, stash
        its sampling state, and re-queue the request AT THE HEAD with the
        tokens generated so far appended to the prompt — on re-admission
        chunked prefill rebuilds the KV rows from the extended prompt
        (KV is a pure function of the token prefix) and decode continues
        with the stashed rng, so greedy and stochastic outputs both
        match the never-preempted run.  Returns the re-queued request."""
        req = slot.request
        if req is None:
            raise ValueError(f"slot {slot.index} is not busy")
        if self.allocator is not None:
            self.allocator.release(req.uid)
        # slot.generated always holds EVERY token generated so far (the
        # resume stash restores it across evictions), so the rebuilt
        # prompt is original + all-generated even on a repeat preemption
        # of an already-resumed request (whose req.prompt embeds the
        # earlier tokens and must not be appended to again).
        orig = self._orig_prompt.setdefault(req.uid, list(req.prompt))
        resumed = dataclasses.replace(
            req, prompt=list(orig) + list(slot.generated))
        self._resume[req.uid] = (slot.generated, slot.rng,
                                 slot.first_token_time,
                                 slot.last_token_time)
        self.queue.appendleft(resumed)
        rec = self.records.get(req.uid)
        if rec is not None:
            rec.status = "queued"
            rec.preemptions += 1
        self.preemption_count += 1
        slot.request = None
        slot.rng = None
        slot.generated = []
        self._pages_changed()
        return resumed

    def record_token(self, slot: Slot, token: int, now: float = 0.0) -> None:
        rec = self.records.get(slot.request.uid)
        if not slot.generated:
            slot.first_token_time = now
            self.ttft[slot.request.uid] = now
            if rec is not None:
                rec.t_first_token = now
        else:
            itl = max(0.0, now - slot.last_token_time)
            if rec is not None:
                rec.itl_sum += itl
                rec.itl_count += 1
                rec.itl_max = max(rec.itl_max, itl)
        slot.last_token_time = now
        slot.generated.append(token)
        if rec is not None:
            rec.n_tokens += 1

    def retire_done(self, now: float = 0.0) -> List[Slot]:
        """Free every slot whose request finished; their outputs land in
        ``finished`` keyed by request uid, and their chains (if any) go
        back to the allocator. Returns the retired slots (with .request
        still attached for the caller's bookkeeping)."""
        retired = []
        for slot in self.slots:
            if slot.busy and slot.done:
                self.finished[slot.request.uid] = list(slot.generated)
                rec = self.records.get(slot.request.uid)
                if rec is not None:
                    rec.t_finish = now
                    rec.status = "finished"
                if self.allocator is not None:
                    self.allocator.release(slot.request.uid)
                self._orig_prompt.pop(slot.request.uid, None)
                retired.append(dataclasses.replace(slot))
                slot.request = None
                slot.rng = None
        if retired:
            self._pages_changed()
        return retired

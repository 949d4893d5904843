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

This is the contiguous-cache scheduler of the reference: page gating,
preemption and prefix keys come with the paged slice, telemetry later.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np


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
              "ttft_s": round(self.ttft_s, 6)}
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

    @property
    def busy(self) -> bool:
        return self.request is not None

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

    Strict FIFO: requests take free slots in arrival order.  Retirement
    (token budget or EOS) frees the slot for the queue head."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.slots: List[Slot] = [Slot(i) for i in range(n_slots)]
        self.queue: Deque[Request] = deque()
        self.finished: Dict[int, List[int]] = {}
        self.ttft: Dict[int, float] = {}  # uid -> time of first token
        self.records: Dict[int, RequestRecord] = {}

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

    def admit(self, now: float = 0.0) -> List[Slot]:
        """Move queued requests into free slots (FIFO). Returns the slots
        that were filled this call; the engine prefills each one."""
        admitted = []
        for slot in self.slots:
            if slot.busy or not self.queue:
                continue
            req = self.queue.popleft()
            slot.request = req
            slot.pos = len(req.prompt)
            slot.generated = []
            slot.rng = np.random.default_rng(req.sampling.seed)
            slot.admit_time = now
            slot.first_token_time = 0.0
            slot.last_token_time = 0.0
            rec = self.records.get(req.uid)
            if rec is not None:
                rec.t_admit = now
                rec.status = "in_flight"
            admitted.append(slot)
        return admitted

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
        ``finished`` keyed by request uid. Returns the retired slots (with
        .request still attached for the caller's bookkeeping)."""
        retired = []
        for slot in self.slots:
            if slot.busy and slot.done:
                self.finished[slot.request.uid] = list(slot.generated)
                rec = self.records.get(slot.request.uid)
                if rec is not None:
                    rec.t_finish = now
                    rec.status = "finished"
                retired.append(dataclasses.replace(slot))
                slot.request = None
                slot.rng = None
        return retired

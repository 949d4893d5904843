"""Host-side input pipeline: background prefetch + device placement.

A ``Prefetcher`` runs the (numpy, stateless) batch function for future
steps on a background thread, keeping ``depth`` batches ready.  The worker
makes numpy batches only; ``get()`` places them on the trainer's device
from the calling thread, as the reference's ``_place`` does.  Because
batches are pure functions of the step counter, the prefetcher has no
state to checkpoint and survives restarts for free (resume at step S
regenerates exactly batch S).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch


def canonical(a: np.ndarray) -> np.ndarray:
    """The array as the models take it: integers as int64 (torch's index
    type), floats as float32 (``gsc_batch``'s images are float64, which
    ``jnp.asarray`` makes float32 in the reference)."""
    if a.dtype.kind in "iu":
        return np.asarray(a, np.int64)
    if a.dtype.kind == "f":
        return np.asarray(a, np.float32)
    return a


class Prefetcher:
    def __init__(self, batch_fn: Callable[[int], Dict[str, np.ndarray]],
                 start_step: int, depth: int = 2, device=None):
        self._fn = batch_fn
        self._device = torch.device("cpu" if device is None else device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch):
        return {k: torch.from_numpy(canonical(v)).to(self._device)
                for k, v in batch.items()}

    def _worker(self):
        step = self._next
        while not self._stop.is_set():
            try:
                batch = self._fn(step)
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def get(self, expected_step: Optional[int] = None):
        step, batch = self._q.get()
        if expected_step is not None and step != expected_step:
            # a restart moved the step counter; regenerate synchronously
            batch = self._fn(expected_step)
            step = expected_step
        return step, self._place(batch)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

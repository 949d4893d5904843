"""Run a function on local ranks: each rank a fresh process (``spawn``)
joined to one process group, as torchrun starts them, for the tests and
the card's smoke run of a mesh on one host.

The group meets through a file store in ``workdir`` (no port to pick), and
each rank's return value comes back through a file there.  A rank that
raises fails the run (``torch.multiprocessing`` ends the other ranks); a
collective that waits past ``timeout_s`` raises in its rank.
"""

from __future__ import annotations

import datetime
import os
import pickle
import uuid
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist


def _entry(rank: int, fn: Callable, world: int, backend: str, store: str,
           out: str, args: Sequence, timeout_s: float, threads: int):
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, *args)
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, workdir, backend: str = "gloo",
              args: Sequence = (), timeout_s: float = 300.0,
              threads: int = 1) -> List:
    """``fn(rank, *args)`` on ``world`` spawned ranks of one ``backend``
    process group; returns each rank's result, in rank order.  ``fn``
    must be importable (a module's top-level function) and ``args``
    picklable."""
    os.makedirs(workdir, exist_ok=True)
    tag = os.path.join(str(workdir), f"ranks-{uuid.uuid4().hex}")
    torch.multiprocessing.start_processes(
        _entry, args=(fn, world, backend, f"{tag}.store", f"{tag}.out",
                      tuple(args), timeout_s, threads),
        nprocs=world, join=True, start_method="spawn")
    results = []
    for r in range(world):
        with open(f"{tag}.out.{r}", "rb") as f:
            results.append(pickle.load(f))
        os.remove(f"{tag}.out.{r}")
    return results

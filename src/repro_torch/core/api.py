"""Public sparsity configuration + execution-path dispatch.

``SparsityConfig`` is the single object model configs use to turn the
paper's technique on for a layer family.  ``choose_path`` encodes the
regime analysis of the reference (``repro.core.api``):

* sparse-sparse (``topk``) wins when B·K < D_in (small-batch serving),
* the faithful Hadamard path (``hadamard``) otherwise,
* ``dense`` (decompress then matmul) only when a config asks for it or the
  layer is not weight-sparse.

Orthogonal to *which algorithm* runs is *which backend executes it*:
``choose_executor`` maps the config's ``use_pallas`` flag (the name is the
reference's) to an :class:`Executor`.  ``auto`` and ``force`` both send the
sparse-sparse contraction to the ``topk_gather`` kernel wrapper, which
launches the CUDA kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors; ``off`` runs the formula of
:func:`repro_torch.core.functional.cs_topk_from_support`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Iterator, Literal, Optional

Path = Literal["auto", "hadamard", "dense", "topk"]

#: Backend selection for the sparse-sparse contraction (see
#: :func:`choose_executor`).
PallasMode = Literal["auto", "force", "off"]


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Per-layer-family complementary-sparsity settings.

    Attributes:
      n: weight pack factor (density 1/n). n=1 disables weight sparsity.
      k_frac: activation k-WTA keep-fraction (None disables k-WTA).
      route_share: groups sharing one route table (1 = faithful paper
        layout; 0 = all groups share one table).
      perm_kind: 'random' (faithful) or 'cyclic' (compressed routes).
      path: execution path override ('auto' dispatches by regime).
      kwta_impl: 'topk' (exact), 'hist' (paper's histogram datapath) or
        'bisect' (threshold bisection).
      kwta_partitions: local k-WTA partition count (0 = global).
      use_pallas: kernel backend ('auto'/'force' = the topk_gather kernel
        wrapper, 'off' = the PyTorch formula).
    """

    n: int = 1
    k_frac: Optional[float] = None
    route_share: int = 1
    perm_kind: str = "random"
    path: Path = "auto"
    kwta_impl: str = "topk"
    kwta_partitions: int = 0
    use_pallas: PallasMode = "auto"

    @property
    def weight_sparse(self) -> bool:
        return self.n > 1

    @property
    def activation_sparse(self) -> bool:
        return self.k_frac is not None and self.k_frac < 1.0

    def k_for(self, dim: int) -> int:
        """Static K for a given feature dim (multiple of kwta_partitions)."""
        if not self.activation_sparse:
            return dim
        k = max(1, int(round(dim * self.k_frac)))
        parts = max(1, self.kwta_partitions)
        k = max(parts, (k // parts) * parts)
        return min(k, dim)


DENSE = SparsityConfig()


@dataclasses.dataclass(frozen=True)
class Executor:
    """Resolved backend for one layer application.

    ``use_kernel=True`` sends the sparse-sparse contraction to the
    ``topk_gather`` wrapper (the CUDA kernel on a CUDA tensor, its plain
    version on a CPU tensor); ``False`` runs the PyTorch formula."""

    use_kernel: bool


def choose_executor(cfg: SparsityConfig) -> Executor:
    """Map ``cfg.use_pallas`` to a backend decision.

    The device is not consulted here: the kernel wrapper decides from the
    tensor it is given, and raises rather than fall back on a CUDA tensor.
    """
    if cfg.use_pallas not in ("auto", "force", "off"):
        raise ValueError(f"use_pallas must be 'auto', 'force' or 'off', "
                         f"got {cfg.use_pallas!r}")
    return Executor(use_kernel=cfg.use_pallas != "off")


# ---------------------------------------------------------------------------
# Dispatch observation (runtime telemetry, repro_torch.obs)
# ---------------------------------------------------------------------------

class _DispatchObs(threading.local):
    def __init__(self) -> None:
        self.stack: list = []


_DISPATCH_OBS = _DispatchObs()


@contextlib.contextmanager
def observe_dispatch(cb: Callable[[Dict], None]) -> Iterator[None]:
    """Register an observer of CS-layer dispatch decisions.

    While active (on this thread), every ``packed_linear_apply`` reports
    one event dict — ``{"path", "backend", "batch", "d_in", "d_out", "n",
    "k", "weight_bytes"}`` — describing which execution path and backend
    the layer took.  Eager PyTorch runs the layers every step, so an
    observer sees every step it is active for (the serving engine keeps
    one active for its first decode step).  Host-side only: nothing is
    added to the computation, and with no observer the notify below is a
    single thread-local list check.
    """
    _DISPATCH_OBS.stack.append(cb)
    try:
        yield
    finally:
        _DISPATCH_OBS.stack.remove(cb)


@contextlib.contextmanager
def pause_dispatch() -> Iterator[None]:
    """No dispatch observer of this thread sees an event while the block
    runs."""
    saved, _DISPATCH_OBS.stack = _DISPATCH_OBS.stack, []
    try:
        yield
    finally:
        _DISPATCH_OBS.stack = saved


def dispatch_observed() -> bool:
    """True when a dispatch observer is active on this thread (callers
    skip building the event dict otherwise)."""
    return bool(_DISPATCH_OBS.stack)


def notify_dispatch(event: Dict) -> None:
    """Deliver a dispatch event to the active observers (if any)."""
    for cb in _DISPATCH_OBS.stack:
        cb(event)


def choose_path(cfg: SparsityConfig, batch: int, d_in: int,
                x_is_sparse: bool) -> str:
    """Regime dispatch, as in the reference."""
    if cfg.path != "auto":
        return cfg.path
    if not cfg.weight_sparse:
        return "dense"
    if x_is_sparse and cfg.activation_sparse:
        k = cfg.k_for(d_in)
        if batch * k < d_in:
            return "topk"
    # Every weight-sparse layer outside the topk regime takes the faithful
    # Hadamard path (the reference's default at any pack factor).
    return "hadamard"

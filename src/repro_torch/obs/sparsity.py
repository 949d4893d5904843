"""Realized-sparsity telemetry: winner-support capture + path attribution.

The paper's throughput claim rides on the *realized* activation sparsity
at runtime, not the configured k/N (arXiv 2112.13896 §4; arXiv 2311.07625
for the activity-sparse decode regime).  The static linter
(:mod:`repro_torch.analysis`) proves the traced program keeps the
sparse-sparse structure; this module measures what actually flows through
it.  It is the port of the reference's ``repro.obs.sparsity``:

* **Support capture** — a collector that rides along the serving engine's
  *probed* decode step: the same eager step, run under
  :func:`capture_supports`.  ``apply_kwta`` reports each layer's winner
  set ``(vals, idx)`` (the tensors the k-WTA already made: no device work),
  and the bisect/hist datapaths an ``nnz`` reduction (with the readback's
  one packing copy, the only device work a probed step adds).  The per-layer loop of
  ``transformer.serve_step`` records each layer's tensors under its unit
  index (:func:`observe_site` with ``unit=``), so the labels and unit keys
  equal the reference's scan-stacked ones.  Nothing is copied to the host
  inside the step: :meth:`SupportCapture.to_host` packs every captured
  tensor into one byte buffer and copies it once, after the logits have
  reached the host.  **When no capture is active every hook returns at
  once and the step issues exactly the device work it issues without
  telemetry.**
* **SparsityStats** — host-side accumulation over probed steps: realized
  k/N per layer (winners with non-zero value / feature dim; for the
  >=-K threshold impls, the measured keep count), and cross-step winner
  overlap per layer (|support_t ∩ support_{t-1}| / K per slot, reset on
  request admission).
* **DispatchStats** — execution-path attribution fed by the observer hook
  in :mod:`repro_torch.core.api`: which path (topk / hadamard / dense) and
  backend (``cuda``: the kernel on the card; ``torch``: PyTorch ops, or a
  kernel's plain version on the CPU) each CS layer took, with the kernel
  cost model (FLOPs = 2·B·K·D_out for the sparse-sparse contraction) and,
  for ``topk[cuda]``, the shared memory of the real launch
  (``kernels/topk_gather.launch_geometry`` plus the kernel's static
  arrays).  Eager PyTorch runs every layer every step, so the engine
  observes one decode step and seals: the site list holds every layer of
  that step (the reference's scan body counts one unit).

No module here imports :mod:`repro_torch.core` or
:mod:`repro_torch.models` — the hooks point the other way.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["SupportCapture", "capture_supports", "observe_site",
           "observe_support", "observe_activation", "capture_active",
           "SparsityStats", "DispatchStats", "est_path_flops"]


# ---------------------------------------------------------------------------
# Support capture
# ---------------------------------------------------------------------------

class _Tls(threading.local):
    def __init__(self):
        self.capture: Optional["SupportCapture"] = None
        self.sites: List[str] = []
        self.unit = 0


_TLS = _Tls()


class SupportCapture:
    """One probed step's collected winner sets.

    ``entries`` maps a layer label (``b0.ffn.kwta``) to ``{unit: (tensors
    ...)}``, ``meta`` maps it to ``{"d", "kind"}``.  The tensors stay where
    the step made them until :meth:`to_host`."""

    def __init__(self):
        self.entries: Dict[str, Dict[int, tuple]] = {}
        self.meta: Dict[str, Dict] = {}

    def _label(self, base: str, unit: int) -> str:
        label = ".".join(_TLS.sites + [base]) if _TLS.sites else base
        k, out = 2, label
        while unit in self.entries.get(out, {}):
            out = f"{label}#{k}"
            k += 1
        return out

    def add(self, base: str, d: int, kind: str, tensors: tuple) -> None:
        unit = _TLS.unit
        label = self._label(base, unit)
        self.entries.setdefault(label, {})[unit] = tensors
        self.meta[label] = {"d": d, "kind": kind}

    def to_host(self) -> Dict[str, tuple]:
        """``{label: (arrays...)}`` as numpy, each stacked over its units
        ``(U, ...)`` as the reference's scan outputs are.  Every captured
        tensor goes into one byte buffer on its device and reaches the host
        in one copy (call it after the step's own readback: the copy then
        waits for nothing)."""
        flat, where = [], []
        for label in sorted(self.entries):
            units = self.entries[label]
            if sorted(units) != list(range(len(units))):
                raise ValueError(f"{label}: units {sorted(units)} are not "
                                 "0..U-1")
            for u in range(len(units)):
                for i, t in enumerate(units[u]):
                    t = t.detach().contiguous()
                    flat.append(t.reshape(-1).view(torch.uint8))
                    where.append((label, u, i, t.dtype, tuple(t.shape)))
        if not flat:
            return {}
        buf = torch.cat(flat).cpu()
        parts = torch.split(buf, [f.numel() for f in flat])
        stacked: Dict[str, List[List[np.ndarray]]] = {}
        for part, (label, u, i, dtype, shape) in zip(parts, where):
            t = part.clone().view(dtype).view(shape)   # aligned for dtype
            if dtype == torch.bfloat16:
                t = t.float()                 # numpy has no bfloat16
            arrs = stacked.setdefault(label, [])
            if len(arrs) <= i:
                arrs.append([])
            arrs[i].append(t.numpy())
        return {label: tuple(np.stack(a) for a in arrs)
                for label, arrs in stacked.items()}


def capture_active() -> bool:
    return _TLS.capture is not None


@contextlib.contextmanager
def capture_supports() -> Iterator[SupportCapture]:
    """Activate a :class:`SupportCapture` for the current thread while the
    step to probe runs.  Nested captures shadow the outer one."""
    prev = _TLS.capture
    cap = SupportCapture()
    _TLS.capture = cap
    try:
        yield cap
    finally:
        _TLS.capture = prev


@contextlib.contextmanager
def observe_site(label: str, unit: Optional[int] = None) -> Iterator[None]:
    """Push a site label (e.g. ``b0``, ``ffn``) onto the capture's label
    path; with ``unit``, also the unit index the observations inside are
    recorded under (the per-layer loop's stand-in for the reference's scan
    axis).  Host-side bookkeeping only, cheap enough to wrap every block
    unconditionally."""
    _TLS.sites.append(label)
    prev_unit = _TLS.unit
    if unit is not None:
        _TLS.unit = unit
    try:
        yield
    finally:
        _TLS.sites.pop()
        _TLS.unit = prev_unit


def observe_support(vals, idx, d: int, site: str = "kwta") -> None:
    """Report an exact-top-k winner set ``(vals (..., K), idx (..., K))``
    over a ``d``-wide axis.  No-op without an active capture."""
    cap = _TLS.capture
    if cap is None:
        return
    cap.add(site, d, "support", (vals, idx))


def observe_activation(y, site: str = "kwta") -> None:
    """Report a thresholded k-sparse activation with no index form (the
    hist/bisect >=-K datapaths): a per-row nnz reduction on the device —
    only when a capture is active, so the unprobed step is untouched."""
    cap = _TLS.capture
    if cap is None:
        return
    nnz = (y != 0).sum(dim=-1)      # a compare and a sum, no cast
    cap.add(site, y.shape[-1], "nnz", (nnz,))


# ---------------------------------------------------------------------------
# Host-side realized-sparsity accumulation
# ---------------------------------------------------------------------------

class SparsityStats:
    """Accumulates probed-step winner sets into per-layer statistics.

    Layers are keyed ``{label}.u{unit}`` (captures carry a leading unit
    axis).  Per layer: mean realized k/N (non-zero winners / feature dim)
    and mean cross-step winner overlap (support kind only).  Overlap for a
    slot row is suppressed until the row has two probed steps from the
    *same* request (:meth:`reset_row` on admission).  Winner sets are
    compared as sets, so two top-k implementations that order ties
    differently give the same overlap.
    """

    def __init__(self, registry=None):
        from .metrics import NULL_REGISTRY
        self._reg = registry if registry is not None else NULL_REGISTRY
        self._prev_idx: Dict[str, np.ndarray] = {}
        self._row_valid: Optional[np.ndarray] = None
        self._acc: Dict[str, Dict[str, float]] = {}
        self.probes = 0

    def reset_row(self, row: int) -> None:
        """A new request took slot ``row``: don't bridge overlap across it."""
        if self._row_valid is not None and row < self._row_valid.shape[0]:
            self._row_valid[row] = False

    def _layer(self, name: str, d: int, k: int) -> Dict[str, float]:
        a = self._acc.get(name)
        if a is None:
            a = self._acc[name] = {"d": d, "k": k, "realized_sum": 0.0,
                                   "realized_n": 0, "overlap_sum": 0.0,
                                   "overlap_n": 0}
        return a

    def update(self, arrays: Dict[str, tuple], meta: Dict[str, Dict],
               active_rows: Sequence[int]) -> None:
        """Fold one probed step's captured arrays into the accumulators.

        ``arrays``/``meta`` come from :meth:`SupportCapture.to_host` and the
        capture's meta dict; ``active_rows`` are the slot rows holding live
        requests this step (idle rows carry stale activations).
        """
        if not arrays or not active_rows:
            return
        self.probes += 1
        active = np.asarray(sorted(active_rows), np.int32)
        realized_fracs, overlap_means = [], []
        for label in sorted(arrays):
            m = meta[label]
            d, kind = int(m["d"]), m["kind"]
            if kind == "support":
                vals = np.asarray(arrays[label][0])
                idx = np.asarray(arrays[label][1])
                if vals.ndim == 2:          # one layer: no unit axis
                    vals, idx = vals[None], idx[None]
                # collapse any middle dims (decode carries S=1: (U,B,1,K))
                u, k = vals.shape[0], vals.shape[-1]
                vals = vals.reshape(u, -1, k)
                idx = idx.reshape(u, -1, k)
                u, b, k = idx.shape
                if self._row_valid is None or self._row_valid.shape[0] != b:
                    self._row_valid = np.zeros((b,), bool)
                realized = (vals != 0).sum(-1)                    # (U, B)
                prev = self._prev_idx.get(label)
                overlaps = None
                if prev is not None and prev.shape == idx.shape:
                    # row-offset trick: shift each (unit, row) into its own
                    # index space so one np.isin covers the whole batch
                    off = (np.arange(u * b, dtype=np.int64)
                           .reshape(u, b, 1)) * d
                    cur = idx.astype(np.int64) + off
                    old = prev.astype(np.int64) + off
                    hit = np.isin(cur.ravel(), old.ravel())
                    overlaps = hit.reshape(u, b, k).sum(-1) / k   # (U, B)
                self._prev_idx[label] = idx
                for ui in range(u):
                    a = self._layer(f"{label}.u{ui}", d, k)
                    r = realized[ui, active] / d
                    a["realized_sum"] += float(r.sum())
                    a["realized_n"] += int(active.size)
                    realized_fracs.append(float(r.mean()))
                    if overlaps is not None:
                        ok = active[self._row_valid[active]]
                        if ok.size:
                            o = overlaps[ui, ok]
                            a["overlap_sum"] += float(o.sum())
                            a["overlap_n"] += int(ok.size)
                            overlap_means.append(float(o.mean()))
            elif kind == "nnz":
                nnz = np.asarray(arrays[label][0])
                if nnz.ndim == 1:
                    nnz = nnz[None]
                nnz = nnz.reshape(nnz.shape[0], -1)  # (U, B*S), decode S=1
                u, b = nnz.shape
                for ui in range(u):
                    a = self._layer(f"{label}.u{ui}", d, -1)
                    r = nnz[ui, active] / d
                    a["realized_sum"] += float(r.sum())
                    a["realized_n"] += int(active.size)
                    realized_fracs.append(float(r.mean()))
        if self._row_valid is not None:
            self._row_valid[:] = False
            self._row_valid[active] = True
        if realized_fracs:
            self._reg.gauge("sparsity.realized_k_frac").set(
                float(np.mean(realized_fracs)))
        if overlap_means:
            self._reg.gauge("sparsity.winner_overlap").set(
                float(np.mean(overlap_means)))
        self._reg.counter("sparsity.probe_steps").inc()

    def summary(self) -> Dict[str, Dict]:
        """Per-layer means: ``{layer: {d, k, realized_k_frac,
        winner_overlap, samples}}`` (overlap absent for nnz layers)."""
        out: Dict[str, Dict] = {}
        for name, a in sorted(self._acc.items()):
            e = {"d": int(a["d"]), "samples": int(a["realized_n"])}
            if a["k"] > 0:
                e["k"] = int(a["k"])
                e["configured_k_frac"] = round(a["k"] / a["d"], 6)
            if a["realized_n"]:
                e["realized_k_frac"] = round(
                    a["realized_sum"] / a["realized_n"], 6)
            if a["overlap_n"]:
                e["winner_overlap"] = round(
                    a["overlap_sum"] / a["overlap_n"], 6)
            out[name] = e
        return out


# ---------------------------------------------------------------------------
# Execution-path attribution (fed by the repro_torch.core.api hook)
# ---------------------------------------------------------------------------

def est_path_flops(ev: Dict) -> float:
    """Cost model per CS layer application (see module docstring)."""
    b, d_in, d_out = ev["batch"], ev["d_in"], ev["d_out"]
    if ev["path"] == "topk":
        return 2.0 * b * ev.get("k", d_in) * d_out
    if ev["path"] == "dense":
        return 2.0 * b * d_in * d_out
    return 2.0 * b * d_in * d_out / max(1, ev.get("n", 1))  # hadamard


def est_topk_smem(ev: Dict) -> int:
    """Shared memory of one block of the ``topk_gather`` launch a
    ``topk[cuda]`` site makes: the launcher's dynamic bytes
    (``launch_geometry``) plus the kernel's static arrays, at the site's
    batch, K, groups, pack factor and weight type."""
    from repro_torch.kernels.topk_gather import launch_geometry, static_smem
    n = max(1, ev.get("n", 1))
    k = ev.get("k", ev["d_in"])
    geo = launch_geometry(ev["batch"], k, ev["d_out"] // n, n,
                          ev["weight_bytes"])
    return geo.smem + static_smem(ev["weight_bytes"])


class DispatchStats:
    """Records the execution-path decision of every CS layer applied while
    unsealed (the engine seals after its first decode step, so the site
    list describes exactly one decode step: every layer, in order)."""

    def __init__(self):
        self.sites: List[Dict] = []
        self._sealed = False
        self._lock = threading.Lock()

    def on_event(self, ev: Dict) -> None:
        with self._lock:
            if not self._sealed:
                self.sites.append(dict(ev))

    def seal(self) -> None:
        with self._lock:
            self._sealed = True

    @property
    def sealed(self) -> bool:
        return self._sealed

    def summary(self, decode_total_s: Optional[float] = None) -> Dict:
        """Aggregate by path+backend with est-FLOP shares; with a measured
        decode stage total, also the estimated wall-time split."""
        agg: Dict[str, Dict] = {}
        total = 0.0
        sparse = 0.0
        for ev in self.sites:
            backend = ev.get("backend", "torch")
            key = f"{ev['path']}[{backend}]"
            a = agg.setdefault(key, {"sites": 0, "est_flops": 0.0})
            fl = est_path_flops(ev)
            a["sites"] += 1
            a["est_flops"] += fl
            total += fl
            if ev["path"] == "topk":
                sparse += fl
                if backend == "cuda":
                    a.setdefault("est_smem_bytes", 0)
                    a["est_smem_bytes"] += est_topk_smem(ev)
        out: Dict = {"paths": agg}
        if total > 0:
            frac = sparse / total
            out["sparse_flop_frac_est"] = round(frac, 6)
            if decode_total_s is not None:
                out["decode_sparse_time_est_s"] = round(
                    frac * decode_total_s, 6)
                out["decode_dense_time_est_s"] = round(
                    (1.0 - frac) * decode_total_s, 6)
        return out

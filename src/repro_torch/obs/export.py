"""Telemetry exporters: JSONL event log + snapshot merging + validation.

Three consumers, three forms:

* **JSONL event log** (:class:`JsonlWriter`) — an append-only stream of
  one-line JSON events (spans from :mod:`repro_torch.obs.trace`,
  per-request lifecycle records from :mod:`repro_torch.runtime.scheduler`,
  a final metrics snapshot).  ``python -m repro_torch.obs.export
  --validate PATH`` validates this file.
* **End-of-run snapshot dict** — ``Engine.metrics_snapshot()`` returns a
  nested dict; :func:`latency_columns` / :func:`sparsity_columns` distill
  it into the flat columns a serving benchmark's rows carry (the
  reference's ``BENCH_serve.json`` schema v2).
* **Live polling** — the same snapshot dict, callable mid-run.

Event schema (one object per line; extra keys are allowed, types of the
required keys are not negotiable):

  kind="span":     name:str ts:num dur_s:num>=0 depth:int>=0
                   parent:str|null [attrs:dict]
  kind="request":  uid:int  t_enqueue:num t_admit:num t_first_token:num
                   t_finish:num n_tokens:int>=0 queue_wait_s:num>=0
                   ttft_s:num>=0 [itl_mean_s:num] [itl_max_s:num]
  kind="snapshot": metrics:dict
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["JsonlWriter", "validate_event", "validate_jsonl",
           "latency_columns", "sparsity_columns"]

SCHEMA_VERSION = 2

_NUM = (int, float)

#: kind -> {key: (types, extra predicate or None)}
_REQUIRED = {
    "span": {
        "name": (str, None),
        "ts": (_NUM, None),
        "dur_s": (_NUM, lambda v: v >= 0),
        "depth": (int, lambda v: v >= 0),
        "parent": ((str, type(None)), None),
    },
    "request": {
        "uid": (int, None),
        "t_enqueue": (_NUM, None),
        "t_admit": (_NUM, None),
        "t_first_token": (_NUM, None),
        "t_finish": (_NUM, None),
        "n_tokens": (int, lambda v: v >= 0),
        "queue_wait_s": (_NUM, lambda v: v >= 0),
        "ttft_s": (_NUM, lambda v: v >= 0),
    },
    "snapshot": {
        "metrics": (dict, None),
    },
}


class JsonlWriter:
    """Thread-safe append-only JSON-lines sink (duck-typed as the tracer/
    scheduler ``sink``: one ``write(dict)`` per event)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def write(self, event: Dict) -> None:
        line = json.dumps(event, sort_keys=True, default=str)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def validate_event(event: Dict) -> List[str]:
    """Schema problems of one event dict ([] = valid)."""
    if not isinstance(event, dict):
        return [f"event is {type(event).__name__}, not object"]
    kind = event.get("kind")
    if kind not in _REQUIRED:
        return [f"unknown kind {kind!r} (expected one of "
                f"{sorted(_REQUIRED)})"]
    problems = []
    for key, (types, pred) in _REQUIRED[kind].items():
        if key not in event:
            problems.append(f"{kind}: missing required key {key!r}")
            continue
        v = event[key]
        if isinstance(v, bool) or not isinstance(v, types):
            problems.append(f"{kind}.{key}: {type(v).__name__} is not "
                            "an accepted type")
        elif pred is not None and not pred(v):
            problems.append(f"{kind}.{key}: value {v!r} out of range")
    if kind == "span" and "attrs" in event \
            and not isinstance(event["attrs"], dict):
        problems.append("span.attrs must be an object")
    return problems


def validate_jsonl(path: str, max_errors: int = 20
                   ) -> Tuple[int, List[str]]:
    """Validate every line of a JSONL telemetry file.

    Returns ``(n_events, errors)``; an empty error list means the file
    parses and every event passes :func:`validate_event`.
    """
    n, errors = 0, []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            n += 1
            try:
                event = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: not JSON ({e.msg})")
            else:
                errors.extend(f"line {lineno}: {p}"
                              for p in validate_event(event))
            if len(errors) >= max_errors:
                errors.append("... (truncated)")
                break
    return n, errors


# ---------------------------------------------------------------------------
# Snapshot -> flat bench columns (the reference's BENCH_serve.json schema v2)
# ---------------------------------------------------------------------------

def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1e3, 2)


def latency_columns(snapshot: Dict) -> Dict:
    """TTFT / inter-token latency percentile columns from a
    ``metrics_snapshot()`` dict (absent histograms yield no columns)."""
    cols: Dict = {}
    hists = snapshot.get("metrics", {}).get("histograms", {})
    for hist, col in (("serve.ttft_s", "ttft"), ("serve.itl_s", "itl")):
        h = hists.get(hist) or {}
        if h.get("count"):
            cols[f"{col}_p50_ms"] = _ms(h["p50"])
            cols[f"{col}_p95_ms"] = _ms(h["p95"])
            cols[f"{col}_p99_ms"] = _ms(h["p99"])
            cols[f"{col}_mean_ms"] = _ms(h["mean"])
    return cols


def sparsity_columns(snapshot: Dict) -> Dict:
    """Realized-sparsity columns: mean realized k/N and winner overlap
    across layers, plus the estimated sparse-path share of decode time."""
    cols: Dict = {}
    layers = snapshot.get("sparsity", {}).get("layers", {})
    rk = [e["realized_k_frac"] for e in layers.values()
          if "realized_k_frac" in e]
    ov = [e["winner_overlap"] for e in layers.values()
          if "winner_overlap" in e]
    if rk:
        cols["realized_k_frac"] = round(sum(rk) / len(rk), 4)
    if ov:
        cols["winner_overlap"] = round(sum(ov) / len(ov), 4)
    paths = snapshot.get("sparsity", {}).get("paths", {})
    if "sparse_flop_frac_est" in paths:
        cols["sparse_flop_frac_est"] = paths["sparse_flop_frac_est"]
    return cols


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="Validate a telemetry JSONL event log.")
    ap.add_argument("--validate", metavar="PATH", required=True,
                    help="JSONL file to check against the event schema")
    ap.add_argument("--min-events", type=int, default=1,
                    help="fail if fewer events than this (default 1)")
    args = ap.parse_args(argv)
    try:
        n, errors = validate_jsonl(args.validate)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for e in errors:
        print(f"INVALID {args.validate}: {e}", file=sys.stderr)
    if not errors and n < args.min_events:
        print(f"INVALID {args.validate}: only {n} events "
              f"(need >= {args.min_events})", file=sys.stderr)
        return 1
    if errors:
        return 1
    print(f"{args.validate}: {n} events, schema OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

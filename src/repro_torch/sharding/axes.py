"""Rule tables: logical axis -> mesh axes, per (mesh, workload kind) —
the reference's ``repro.sharding.axes``.

Parallelism map:
  DP   : "batch"  -> ("pod", "data")      (pod axis folds into DP)
  TP   : "heads" / "mlp" / "vocab" / "kv" -> "model"
  EP   : "experts" -> "model"
  SP   : "kvseq" (KV-cache sequence) -> "model" for decode; for batch=1
         long-context also the DP axes.
ZeRO-1: optimizer moments additionally shard over the DP axes
(:func:`repro_torch.launch.steps.zero1_specs`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .context import MeshAxes, Rules


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def tp_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.shape else None


def make_rules(mesh, kind: str = "train") -> Rules:
    """Rule table for a workload kind: train | prefill | decode (serve) |
    decode_long.

    ``decode_long`` (batch too small to shard) moves the DP axes onto the
    KV-cache sequence dimension: sequence parallelism for a long cache.
    """
    dp: MeshAxes = dp_axes(mesh)
    tp = tp_axis(mesh)
    table: Dict[str, MeshAxes] = {
        "batch": dp,
        "seq": None,
        "embed": None,
        "heads": tp,
        "kv": tp,
        "mlp": tp,
        "vocab": tp,
        "experts": tp,
        "kvseq": None,
    }
    if kind in ("decode", "serve"):
        table["kvseq"] = tp  # shard the cache over model
    elif kind == "decode_long":
        table["batch"] = None
        table["kvseq"] = tuple(list(dp) + ([tp] if tp else []))
        table["seq"] = None
    # prefill: a tiny batch falls back to replication by divisibility
    return Rules(mesh=mesh, table=table)

"""Atomic, checksummed checkpoints of the port's trees, in the reference's
on-disk format (``repro.checkpoint.ckpt``).

Layout of one checkpoint::

    <dir>/step_00000123/
        manifest.json      # leaf paths, shapes, dtypes, crcs, step, extra
        shard_p0.npz       # this process's leaves, leaf_00000 ...
    <dir>/step_00000123.done # commit marker (written after the rename)

Properties:
  * **Atomic**: writes go to a tmp dir unique to the writer and are
    renamed; a crash mid-write leaves no half-valid checkpoint (restore
    only trusts dirs with the ``.done`` marker).
  * **Async**: ``save_async`` copies every leaf to host memory
    synchronously (a blocking copy, never ``non_blocking``), so updates in
    place after it returns do not reach the snapshot, and writes to disk
    on a background thread that touches no device tensor.
  * **Integrity**: per-leaf checksums (crc of raw bytes) in the manifest.
  * **Leaf order**: :func:`repro_torch.tree.flatten`'s (dict keys sorted,
    lists in order) stands in for the reference's treedef; the manifest
    lists the leaf paths and restore checks them.  A checkpoint of the
    reference (``treedef`` the string of a ``PyTreeDef``) is checked as
    the reference's ``restore`` checks it: by leaf count and leaf shapes.
  * **Sharded restore**: with ``shardings=`` (a tree of
    :class:`repro_torch.sharding.NamedSharding`, matching ``like_tree``)
    each process takes its own block of every full leaf, so a checkpoint
    restores onto another mesh.  Saving on a mesh gathers the full tree
    first and process 0 writes it (``Trainer.save``).

numpy has no bfloat16: a bf16 leaf is stored as its 2 bytes in ``|V2``,
as the reference's ``np.savez`` of a bfloat16 array stores them, with
``"dtype": "bfloat16"`` in the manifest, so a round trip is exact and the
reference's ``restore``, which cannot cast ``|V2``, fails loudly on one.
``restore`` also reads the ``<i2`` view that older port checkpoints hold.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.tree import flatten, leaves, unflatten

_COMMIT = threading.Lock()

def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(tree):
    """(paths, {leaf_i: numpy array}, {leaf_i: dtype name}): a blocking
    copy of every leaf to new host memory."""
    flat = flatten(tree)
    host, dtypes = {}, {}
    for i, (_, t) in enumerate(flat):
        key = f"leaf_{i:05d}"
        t = t.detach().to("cpu", copy=True)
        dtypes[key] = _dtype_name(t)
        if t.dtype == torch.bfloat16:       # numpy has no bfloat16
            host[key] = t.view(torch.int16).numpy().view(np.dtype("V2"))
        else:
            host[key] = t.numpy()
    return [p for p, _ in flat], host, dtypes


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree, extra: Optional[Dict] = None,
         process_index: int = 0) -> str:
    """Synchronous checkpoint write. Returns the committed path."""
    return _write(directory, step, *_to_host(tree), extra, process_index)


def save_async(directory: str, step: int, tree,
               extra: Optional[Dict] = None,
               process_index: int = 0) -> threading.Thread:
    """Snapshot to host now; write to disk in the background."""
    snapshot = _to_host(tree)
    t = threading.Thread(target=_write, args=(directory, step, *snapshot,
                                              extra, process_index),
                         daemon=True)
    t.start()
    return t


def _write(directory, step, paths, host, dtypes, extra,
           process_index) -> str:
    final = _step_dir(directory, step)
    # unique tmp dir per writer: concurrent saves of the same step (e.g. a
    # periodic async save racing the final sync save) must not collide
    tmp = f"{final}.tmp.{os.getpid()}.{threading.get_ident()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "treedef": paths,
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k],
                       "crc": zlib.crc32(np.ascontiguousarray(v).tobytes())}
                   for k, v in host.items()},
        "extra": extra or {},
    }
    np.savez(os.path.join(tmp, f"shard_p{process_index}.npz"), **host)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    # One commit at a time in this process: two writers of one step (e.g.
    # a periodic async save racing the final sync save) would otherwise
    # delete each other's committed files mid-rename.
    with _COMMIT:
        if os.path.isdir(final):
            # withdraw the marker first: no reader trusts a half-deleted dir
            try:
                os.remove(final + ".done")
            except FileNotFoundError:
                pass
            shutil.rmtree(final)
        try:
            os.replace(tmp, final)
        except OSError:
            # another process committed this step first — accept theirs
            shutil.rmtree(tmp, ignore_errors=True)
            if not os.path.exists(final + ".done"):
                raise
            return final
        # commit marker — restore only trusts checkpoints that have it
        with open(final + ".done", "w") as f:
            f.write("ok")
    return final


def list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name + ".done")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _check_structure(path, manifest, flat) -> None:
    """The port's leaf-path list must equal ``like``'s; the reference's
    string treedef is checked by leaf count (its shapes leaf by leaf)."""
    saved = manifest["treedef"]
    if isinstance(saved, str):
        if len(manifest["leaves"]) != len(flat):
            raise ValueError(f"{path}: checkpoint has "
                             f"{len(manifest['leaves'])} leaves "
                             f"({saved}), expected {len(flat)}")
    elif saved != [p for p, _ in flat]:
        raise ValueError(f"{path}: checkpoint leaves {saved} "
                         f"!= expected {[p for p, _ in flat]}")


def _as_tensor(arr: np.ndarray, dtype_name: str, key: str) -> torch.Tensor:
    """The stored array as a tensor of the manifest's dtype: bfloat16 is
    stored as ``|V2`` (or ``<i2`` by older port checkpoints)."""
    if arr.dtype.kind == "V":
        arr = arr.view(np.int16)
    t = torch.from_numpy(arr)
    saved = getattr(torch, dtype_name, None)
    if not isinstance(saved, torch.dtype):
        raise ValueError(f"{key}: unknown dtype {dtype_name!r}")
    return t.view(saved) if saved != t.dtype else t


def restore(directory: str, step: int, like_tree, shardings=None,
            process_index: int = 0, strict_checksum: bool = True):
    """Restore into the structure of ``like_tree``: each leaf with its
    ``like`` leaf's dtype, on its device.  With ``shardings`` (a tree of
    :class:`repro_torch.sharding.NamedSharding` or ``None`` leaves,
    matching ``like_tree``) each leaf is this process's block of the full
    stored leaf, which must have ``like``'s shape: the current mesh's
    shardings reshard a checkpoint written on another mesh.
    Returns (tree, extra)."""
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = flatten(like_tree)
    _check_structure(path, manifest, flat)
    shard = ([None] * len(flat) if shardings is None
             else leaves(shardings))
    if len(shard) != len(flat):
        raise ValueError(f"{len(shard)} shardings for {len(flat)} leaves")
    out = []
    with np.load(os.path.join(path, f"shard_p{process_index}.npz")) as data:
        for i, ((_, like), sh) in enumerate(zip(flat, shard)):
            key = f"leaf_{i:05d}"
            arr = data[key]
            meta = manifest["leaves"][key]
            if strict_checksum:
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != meta["crc"]:
                    raise IOError(f"checksum mismatch for {key} in {path}")
            t = _as_tensor(arr, meta["dtype"], key)
            if sh is not None:
                t = sh.take(t)
            if list(t.shape) != list(like.shape):
                raise ValueError(f"{key}: checkpoint shape "
                                 f"{tuple(t.shape)} != expected "
                                 f"{tuple(like.shape)}")
            out.append(t.to(device=like.device, dtype=like.dtype))
    return unflatten(like_tree, out), manifest["extra"]


def restore_latest(directory: str, like_tree, shardings=None, **kw):
    step = latest_step(directory)
    if step is None:
        return None, None, None
    tree, extra = restore(directory, step, like_tree, shardings, **kw)
    return step, tree, extra


def prune(directory: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` checkpoints (garbage collection)."""
    steps = list_steps(directory)
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
        try:
            os.remove(_step_dir(directory, s) + ".done")
        except OSError:
            pass

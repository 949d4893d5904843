"""Nested dicts and lists of tensors (the port's params, optimizer state
and checkpoints) as flat leaves in one defined, stable order: dict keys
sorted, as ``jax.tree`` orders them, lists in order.  The order stands in
for the reference's treedef."""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode


def flatten(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` pairs; a path is the keys and list indices joined
    by ``/``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def leaves(tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, new_leaves) -> object:
    """A tree of ``like``'s structure holding ``new_leaves`` in
    :func:`flatten`'s order."""
    it: Iterator = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def fake(make: Callable, device, mode: Optional[FakeTensorMode] = None):
    """The tensors ``make()`` returns, as fake tensors of the same shapes
    and types on ``device``, with no storage, all of one fake mode (one
    trace's inputs come from one call, or from calls given one ``mode``).
    ``make`` runs on the CPU under ``FakeTensorMode`` (its generator calls
    draw nothing), and its results are re-made on ``device`` from their
    shapes."""
    mode = mode or FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=device)
                        if isinstance(t, torch.Tensor) else t, make())

"""The collectives of the port's mesh step: the port's side of what GSPMD
and ``shard_map`` stage in the reference.

Each runs over the process group of a set of mesh axes
(:meth:`repro_torch.launch.mesh.Mesh.group`):

* a sum or mean (``all_reduce``): the gradient mean over the DP group,
  the batch statistics, the int8 sync's pod mean;
* gathering blocks (``all_gather_into_tensor``): a leaf whole from its
  shards, and the ZeRO-1 slices a DP group updated put back into the
  params' blocks;
* a shift to a neighbour (``batch_isend_irecv``): the pipeline's ring.

NCCL takes CUDA tensors for all three, gloo CPU tensors.  Gloo also runs
``all_reduce``, ``broadcast``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` on CUDA tensors (staging them through host
memory itself); its point-to-point sends are given host tensors, so a
CUDA tensor is sent through a host copy.

The model on a mesh (:mod:`repro_torch.sharding.serving`, serving and
training alike) runs three more, each through autograd where it records:

* :func:`gather`: every member's block stacked into one new buffer (the
  q/k/v columns, the FFN hidden, the head outputs, the logits); its
  backward is the rank's slice of the gradient;
* :func:`reduce`: a sum (the vocab-parallel embedding, row-parallel
  partial outputs, the sharded softmax) whose backward is the identity,
  or a maximum, which carries no gradient;
* :func:`enter`: the identity, whose backward sums the gradient over the
  group.  It marks a tensor that every member holds whole (replicated)
  where it feeds the member's own block of work: each member's gradient
  of it is then a part, and the parts add up to the whole.

So a replicated activation holds its whole gradient on every member, and
a split one (a block) its block's.  Without autograd (serving, under
``no_grad``) they are the plain collectives, a sum in place.

Without a process group (a one-rank mesh) every collective is the
identity and none is called.  A collective that fails raises; nothing is
retried on another device or backend.  :func:`observe_collectives` hands
an observer every collective this module runs with the tensors it was
given and fills, the backward's included (the serving and training tests
check that none is a weight; the census of :mod:`repro_torch.launch.hlo`
counts them).
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .axes import dp_axes
from .context import get_rules

#: (leaf index, member coordinates) -> that member's slices of the leaf's
#: output, or None where the member holds none of it
Place = Callable[[int, Dict[str, int]], Optional[Tuple[slice, ...]]]


_OBSERVERS: List[Callable] = []
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@contextlib.contextmanager
def observe_collectives(fn: Callable):
    """Inside, ``fn(op, tensors)`` sees every collective this module runs
    (``op`` its name, ``tensors`` what it was handed and what it
    fills)."""
    _OBSERVERS.append(fn)
    try:
        yield fn
    finally:
        _OBSERVERS.remove(fn)


def _notify(op: str, *tensors: torch.Tensor) -> None:
    for fn in _OBSERVERS:
        fn(op, tensors)


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In place: the sum (``op="sum"``) or the maximum (``"max"``) over
    ``group`` (no-op for None)."""
    if group is not None:
        _notify(f"all_reduce_{op}", t)
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    with warnings.catch_warnings():
        # newer torch marks it deprecated for a successor older torch lacks
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every member's ``x`` (one shape on all) stacked in group-rank order
    into one new buffer, ``(members, *x.shape)``; ``x[None]`` for None.
    Not differentiable (:func:`gather` is)."""
    if group is None:
        return x[None]
    return _all_gather(x, group)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    _notify("all_gather", x, out)
    _gather_into(out, x.view(-1), group)
    return out.view(n, *x.shape)


def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.member = dist.get_rank(group)
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.member], None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_gather`; where autograd records, the gradient of ``x`` is
    this member's slice of the (whole, replicated) gradient of the
    result."""
    if group is not None and _records(x):
        return _Gather.apply(x, group)
    return all_gather(x, group)


def reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` summed (or maximised) over ``group``.  Where autograd records,
    a sum is a new tensor whose gradient passes to ``x`` as it is (the
    consumer is replicated; see :func:`enter` for a split one) and a
    maximum is detached (a softmax's shift, whose gradient cancels);
    elsewhere ``x`` itself, in place."""
    if group is None:
        return x
    if _records(x):
        if op == "max":
            return all_reduce_(x.detach().clone(), group, op)
        return _Sum.apply(x, group)
    return all_reduce_(x, group, op)


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, replicated over ``group``, where it feeds work split over the
    group: the identity, whose backward sums the gradient over ``group``
    (``x`` itself where autograd does not record)."""
    if group is not None and _records(x):
        return _Enter.apply(x, group)
    return x


def summed(shapes: Sequence[Sequence[int]],
           fill: Callable[[int, torch.Tensor], None], group, device,
           dtype=torch.float32) -> List[torch.Tensor]:
    """Zero buffers of ``shapes`` in one flat tensor; ``fill(i, buf)``
    writes this rank's part of buffer ``i``; then one sum over ``group``.
    Returns the buffers (views of the flat tensor)."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.zeros(sum(sizes), dtype=dtype, device=device)
    bufs = [v.view(tuple(s)) for v, s in zip(flat.split(sizes), shapes)]
    for i, buf in enumerate(bufs):
        fill(i, buf)
    all_reduce_(flat, group)
    return bufs


def _numel(slices) -> int:
    return 0 if slices is None else math.prod(s.stop - s.start
                                              for s in slices)


def gather_pieces(mesh, axes, pieces: Sequence[Optional[torch.Tensor]],
                  outs: Sequence[torch.Tensor], place: Place) -> None:
    """One ``all_gather_into_tensor`` over the group of ``axes``: every
    member's pieces into ``outs``.  ``pieces[i]`` is this rank's piece of
    ``outs[i]`` (None where it holds none); ``place(i, coords)`` gives the
    slices of ``outs[i]`` that the member at ``coords`` holds, which fixes
    the pieces' sizes on every rank.  The pieces travel in ``outs[0]``'s
    dtype."""
    members = mesh.members(axes)
    sizes = [sum(_numel(place(i, c)) for i in range(len(outs)))
             for c in members]
    n = max(sizes)
    dtype, device = outs[0].dtype, outs[0].device
    send = torch.zeros(n, dtype=dtype, device=device)
    off = 0
    for p in pieces:
        if p is not None:
            send[off:off + p.numel()] = p.reshape(-1)
            off += p.numel()
    recv = torch.empty(len(members) * n, dtype=dtype, device=device)
    _notify("all_gather", send, recv)
    _gather_into(recv, send, mesh.group(axes))
    for g, c in enumerate(members):
        off = g * n
        for i, out in enumerate(outs):
            where = place(i, c)
            k = _numel(where)
            if k:
                out[where] = recv[off:off + k].view(
                    tuple(s.stop - s.start for s in where))
                off += k


def gather_leaves(blocks: Sequence[torch.Tensor], shardings,
                  shapes: Sequence[Sequence[int]]) -> List[torch.Tensor]:
    """The full leaves of ``shapes`` from each rank's ``blocks`` (as
    :meth:`NamedSharding.take` cuts them, an empty tensor where a rank
    holds none): one :func:`gather_pieces` a set of sharded axes and a
    dtype; a leaf no axis shards is its block."""
    out: List[Optional[torch.Tensor]] = [None] * len(blocks)
    by_key = {}
    for i, sh in enumerate(shardings):
        if sh.axes:
            by_key.setdefault((sh.axes, blocks[i].dtype), []).append(i)
        else:
            out[i] = blocks[i]
    for (axes, dtype), idx in by_key.items():
        mesh = shardings[idx[0]].mesh
        fulls = [torch.empty(tuple(shapes[i]), dtype=dtype,
                             device=blocks[i].device) for i in idx]
        gather_pieces(
            mesh, axes,
            [blocks[i] if blocks[i].numel() else None for i in idx], fulls,
            lambda j, c, idx=idx: shardings[idx[j]].block(shapes[idx[j]], c))
        for i, full in zip(idx, fulls):
            out[i] = full
    return out


def _on_host(t: torch.Tensor, group) -> bool:
    """Gloo sends CUDA tensors through host copies."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of every member of ``group`` handed to the next (group rank
    i -> i + 1, the last to the first): returns what the previous member
    sent.  One send and one receive a rank."""
    if group is None:
        return t
    n, me = dist.get_world_size(group), dist.get_rank(group)
    staged = _on_host(t, group)
    src = t.cpu() if staged else t.contiguous()
    dst = torch.empty_like(src)
    _notify("ring_shift", src, dst)
    ops = [dist.P2POp(dist.isend, src,
                      dist.get_global_rank(group, (me + 1) % n), group),
           dist.P2POp(dist.irecv, dst,
                      dist.get_global_rank(group, (me - 1) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return dst.to(t.device) if staged else dst


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In place: group rank ``src``'s ``t`` on every member (no-op for
    None)."""
    if group is not None:
        _notify("broadcast", t)
        dist.broadcast(t, dist.get_global_rank(group, src), group=group)
    return t


def dp_group():
    """The DP group of the rules in force: None without rules, DP axes or
    a process group (then a batch is the whole batch)."""
    rules = get_rules()
    if rules is None or not dp_axes(rules.mesh):
        return None
    return rules.mesh.group(dp_axes(rules.mesh))


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def batch_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (:func:`dp_group`) through autograd
    (``torch.distributed.nn.functional.all_reduce``, whose backward sums
    the gradients); ``x`` itself for None.  Batch statistics (a mean's
    numerator and count, the MoE aux loss's expert loads) go through it,
    so a DP-sharded step computes the global batch's.  The backward leaves
    each rank's gradients scaled by the group's size: the step's gradient
    mean over the group undoes it."""
    if group is None:
        return x
    _notify("all_reduce_sum", x)
    from torch.distributed.nn.functional import all_reduce
    with warnings.catch_warnings():
        # newer torch marks it deprecated for the functional collectives,
        # whose all_reduce has no backward
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(x, group=group)


def barrier(mesh) -> None:
    """Every rank of ``mesh`` reaches this point (a one-element sum)."""
    all_reduce_(torch.zeros(1, device=mesh.device),
                mesh.group(mesh.axis_names))

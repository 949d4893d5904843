"""Meshes of ranks — the reference's ``repro.launch.mesh``.

A :class:`Mesh` holds its shape and axis names, the device this process
computes on, and, when a ``torch.distributed`` process group of the
mesh's size is up, one process group for every set of axes (the ranks
that share this rank's coordinates on the other axes).  Rank ``r`` sits
at the row-major coordinates of ``r`` in the shape, as ``jax.make_mesh``
lays devices out.

Constructing a mesh never starts a process group: the caller does
(``torchrun`` and ``torch.distributed.init_process_group``).  A mesh whose
size differs from the world size raises; a mesh of more than one rank
with no process group up raises; a one-rank mesh with none runs without
collectives.  :func:`parse_mesh` reads a mesh from the command line, and
:func:`join_process_group` joins the group torchrun describes.
:func:`make_production_mesh` is the exception: it describes
the production shape for rule tables and specs, and holds process groups
only when a process group of that size is up.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import os
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import resolve_device


@dataclasses.dataclass(eq=False)
class Mesh:
    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    #: axes (in mesh order) -> this rank's process group over them; empty
    #: without a process group
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        """axis -> size, in mesh order (``jax.sharding.Mesh.shape``)."""
        return collections.OrderedDict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def distributed(self) -> bool:
        """A process group of the mesh's size is up."""
        return bool(self.groups)

    @property
    def live(self) -> bool:
        """This process can compute on the mesh: one rank, or a process
        group of its size."""
        return self.distributed or self.size == 1

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.distributed else 0

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis."""
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.dims))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def ordered(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name, a tuple of names or None) in mesh order."""
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group over ``axes`` holding this rank; None where
        no collective is needed (no process group and one rank)."""
        axes = self.ordered(axes)
        if not self.distributed:
            if self.size != 1:
                raise RuntimeError(f"mesh {self.dims} has no process group "
                                   "of its size: it cannot run collectives")
            return None
        return self.groups[axes]

    def members(self, axes):
        """The coordinates of the ranks of :meth:`group` over ``axes``, in
        their group-rank order: row-major over ``axes`` in mesh order, the
        other axes at this rank's (a group lists its ranks sorted)."""
        axes = self.ordered(axes)
        mine = self.coords
        return [dict(mine, **dict(zip(axes, idx))) for idx in
                itertools.product(*(range(self.shape[a]) for a in axes))]


def _enumerate_groups(dims, names):
    """One process group per non-empty set of axes; every rank takes part
    in creating every group, in the same order."""
    ranks = torch.arange(math.prod(dims)).reshape(dims)
    groups = {}
    for k in range(1, len(names) + 1):
        for sub in itertools.combinations(range(len(names)), k):
            rest = [i for i in range(len(names)) if i not in sub]
            grid = ranks.permute(*rest, *sub).reshape(
                -1, math.prod(dims[i] for i in sub))
            mine, _ = dist.new_subgroups_by_enumeration(grid.tolist())
            groups[tuple(names[i] for i in sub)] = mine
    return groups


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device=None) -> Mesh:
    """A mesh for this process group (e.g. (2, 2) over four ranks), on
    ``cuda`` unless ``device`` says otherwise.  Raises where the mesh's
    size is not the world size, or where it has more than one rank and no
    process group is up."""
    dims, names = tuple(int(d) for d in shape), tuple(axes)
    if len(dims) != len(names):
        raise ValueError(f"mesh shape {dims} for axes {names}")
    device = resolve_device(device)
    size = math.prod(dims)
    if not (dist.is_available() and dist.is_initialized()):
        if size != 1:
            raise RuntimeError(
                f"mesh {dims} needs a process group of {size} ranks and none "
                "is up: start the ranks with torchrun and "
                "torch.distributed.init_process_group")
        return Mesh(dims, names, device)
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"mesh {dims} has {size} ranks; the process group "
                         f"has {world}")
    return Mesh(dims, names, device, _enumerate_groups(dims, names))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production meshes: 16x16 (data, model), and 2x16x16 with a
    leading ``pod`` axis.  Without a process group of that size the mesh
    holds its shape only (rule tables and specs read it; nothing runs on
    it)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == math.prod(shape)):
        return make_mesh(shape, axes, device)
    return Mesh(shape, axes, torch.device(device or "cuda"))


def single_device_mesh(device=None) -> Mesh:
    return make_mesh((1, 1), ("data", "model"), device)


def parse_mesh(mesh, device=None) -> Mesh:
    """``"2x2"``, ``(2, 2)`` or a :class:`Mesh`: (data, model) for two
    dims, (pod, data, model) for three.  Raises where the mesh's size is
    not the process group's world size, or where it has more than one rank
    and no process group is up."""
    if isinstance(mesh, Mesh):
        if not mesh.live:
            raise RuntimeError(f"mesh {mesh.dims} has no process group of "
                               "its size")
        return mesh
    dims = (tuple(int(x) for x in mesh.split("x")) if isinstance(mesh, str)
            else tuple(mesh))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(dims))
    if axes is None:
        raise ValueError(f"mesh {dims}: two dims (data, model) or three "
                         "(pod, data, model)")
    return make_mesh(dims, axes, device)


def join_process_group(backend: str, device=None) -> str:
    """Join the process group that torchrun's environment variables
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) describe.
    Returns this rank's device: ``cuda:<LOCAL_RANK mod cards>`` unless
    ``device`` says otherwise (gloo ranks may share a card; NCCL needs a
    card a rank)."""
    if device in (None, "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "--device cpu (with --backend gloo)")
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = f"cuda:{local % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://")
    return device

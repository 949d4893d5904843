"""Logical-axis sharding context — the reference's
``repro.sharding.context``.

Parameters carry logical-spec tuples (``param_specs`` of each model
module); the launcher installs a :class:`Rules` object mapping logical
names to mesh axes for the current (mesh, workload) pair.  Outside any
rules context every helper is a no-op, so the same model code runs on one
device and on a mesh.

Divisibility guard: a logical axis only shards a dimension if the
dimension is divisible by the product of the mesh-axis sizes; otherwise
it falls back to replication (e.g. 4 kv heads cannot shard over
model=16).

A resolved spec is a tuple with one entry a dimension: ``None``, a mesh
axis, or a tuple of mesh axes (major first), canonical as
``jax.sharding.PartitionSpec`` holds it (a one-axis tuple is the axis, an
empty one ``None``).  :class:`NamedSharding` places a spec on a mesh and
cuts this rank's block out of a full tensor.

The port keeps the layers of a model as a list where the reference
stacks them on a leading unit axis; a :class:`UnitSpec` is the stacked
leaf's spec read by one unit, so a stacked leaf whose unit axis is
sharded (ZeRO-1 puts the DP axes there when they divide the unit count)
gives each rank the reference's units, whole.

``constrain`` (the reference's ``with_sharding_constraint``) returns its
tensor unchanged: the port places its activations by the blocks the
params hold (:mod:`repro_torch.sharding.serving`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]

_STATE = threading.local()


def canonical(axes: MeshAxes) -> MeshAxes:
    """One entry of a resolved spec as ``PartitionSpec`` holds it."""
    if isinstance(axes, tuple):
        if not axes:
            return None
        if len(axes) == 1:
            return axes[0]
    return axes


def _flat(axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class UnitSpec:
    """The logical spec of a stacked leaf (leading unit axis first) as
    the port's leaf of unit ``unit`` of ``n_units`` holds it."""
    spec: tuple
    unit: int
    n_units: int


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh.  ``unit`` = (u, n_units) marks the
    port's leaf of unit u of a stacked leaf: ``spec`` is the stacked
    leaf's, and the leaf is that leaf without its unit axis."""
    mesh: object
    spec: tuple
    unit: Optional[Tuple[int, int]] = None

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes of more than one rank that the spec shards over,
        in mesh order: the ranks holding distinct blocks differ on these
        axes alone."""
        used = {a for part in self.spec for a in _flat(part)
                if self.mesh.shape[a] > 1}
        return self.mesh.ordered(used)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The per-rank shape of a leaf of ``shape`` (the stacked shape of
        a unit leaf), as ``jax.sharding.NamedSharding.shard_shape``."""
        out = list(shape)
        for i, part in enumerate(self.spec):
            n = math.prod(self.mesh.shape[a] for a in _flat(part))
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                                 f"over {part}")
            out[i] //= n
        return tuple(out)

    def _slices(self, shape, coords) -> Tuple[slice, ...]:
        out = []
        for i, dim in enumerate(shape):
            part = self.spec[i] if i < len(self.spec) else None
            idx, n = 0, 1
            for a in _flat(part):
                idx = idx * self.mesh.shape[a] + coords[a]
                n *= self.mesh.shape[a]
            out.append(slice(idx * (dim // n), (idx + 1) * (dim // n)))
        return tuple(out)

    def block(self, shape: Sequence[int], coords=None
              ) -> Optional[Tuple[slice, ...]]:
        """This rank's block of the port's leaf of ``shape``: one slice a
        dimension, or None where the rank holds none of a unit leaf."""
        coords = self.mesh.coords if coords is None else coords
        if self.unit is None:
            return self._slices(shape, coords)
        u, n_units = self.unit
        first, *rest = self._slices((n_units, *shape), coords)
        return tuple(rest) if first.start <= u < first.stop else None

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of :meth:`take` of a leaf of ``shape``: ``(0,)`` where
        the rank holds none of it."""
        block = self.block(shape)
        if block is None:
            return (0,)
        return tuple(s.stop - s.start for s in block)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``: ``full`` itself where the spec
        shards it over no axis of more than one rank, else a new
        tensor."""
        if not self.axes:
            return full
        block = self.block(full.shape)
        if block is None:
            return full.new_empty((0,))
        return full[block].clone()


@dataclasses.dataclass
class Rules:
    mesh: object
    table: Dict[str, MeshAxes]

    def axis_size(self, axes: MeshAxes) -> int:
        return math.prod(self.mesh.shape[a] for a in _flat(axes))

    def resolve(self, logical: MeshAxes, dim: Optional[int]) -> MeshAxes:
        """The mesh axes of a logical name; a tuple of mesh axes (what
        ``zero1_specs`` writes) stands for itself.  The reference looks a
        tuple up as a name and replicates, so its ZeRO-1 moments never
        shard over the DP axes its docstrings name (ROADMAP Queue 3)."""
        if logical is None:
            return None
        axes = logical if isinstance(logical, tuple) else \
            self.table.get(logical)
        if axes is None:
            return None
        if dim is not None and dim % self.axis_size(axes):
            return None  # divisibility fallback -> replicate
        return axes

    def spec_for(self, logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> tuple:
        dims = list(shape) if shape is not None else [None] * len(logical_axes)
        used: set = set()
        parts = []
        for logical, dim in zip(logical_axes, dims):
            axes = self.resolve(logical, dim)
            # a mesh axis may appear at most once in a spec
            if axes is not None:
                flat = _flat(axes)
                if any(a in used for a in flat):
                    axes = None
                else:
                    used.update(flat)
            parts.append(canonical(axes))
        return tuple(parts)

    def sharding_for(self, logical_axes: Sequence[Optional[str]],
                     shape: Optional[Sequence[int]] = None,
                     unit: Optional[Tuple[int, int]] = None
                     ) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(logical_axes, shape),
                             unit)


def set_rules(rules: Optional[Rules]) -> None:
    _STATE.rules = rules


def get_rules() -> Optional[Rules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = get_rules()
    set_rules(rules)
    try:
        yield rules
    finally:
        set_rules(prev)


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's activation annotation: checks the rank and returns
    ``x`` (the port's blocks follow the params')."""
    if get_rules() is not None and len(logical_axes) != x.ndim:
        raise ValueError(f"{len(logical_axes)} axes for rank-{x.ndim} array")
    return x


def is_spec(s) -> bool:
    """True for a logical-spec tuple: elements are None, axis names, or
    tuples of axis names (a logical axis may resolve to multiple mesh
    axes, e.g. batch -> ('pod', 'data')); or a :class:`UnitSpec`."""
    if isinstance(s, UnitSpec):
        return True

    def ok(a):
        return (a is None or isinstance(a, str)
                or (isinstance(a, tuple) and all(isinstance(x, str)
                                                 for x in a)))
    return isinstance(s, tuple) and all(ok(a) for a in s)


def map_specs(fn, specs, *rest):
    """``fn(spec, *leaves)`` over the spec leaves of ``specs`` (dicts and
    lists of :func:`is_spec` leaves) and the nodes of ``rest`` at the same
    places."""
    if is_spec(specs):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(specs)]
    raise TypeError(f"not a spec tree node: {specs!r}")


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", leaf))


def param_sharding(specs_tree, params_tree, rules: Rules):
    """Resolve a logical-spec tree against the params' shapes (tensors or
    shape tuples).  A spec whose length differs from the leaf's rank
    (e.g. for an int leaf's scalar moment placeholder) resolves to full
    replication."""
    def resolve(spec, p):
        shape = _shape(p)
        if isinstance(spec, UnitSpec):
            stacked = (spec.n_units, *shape)
            if len(spec.spec) != len(stacked):
                return NamedSharding(rules.mesh, ())
            return rules.sharding_for(spec.spec, stacked,
                                      (spec.unit, spec.n_units))
        if len(spec) != len(shape):
            return NamedSharding(rules.mesh, ())
        return rules.sharding_for(spec, shape)

    return map_specs(resolve, specs_tree, params_tree)

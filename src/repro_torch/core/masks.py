"""Complementary sparsity mask generation.

The paper's central structural constraint (§3, Fig. 7): N sparse weight
structures with mutually non-overlapping non-zero positions are overlaid into
one dense structure.  We realize the *partitioned* variant (paper Fig. 5d,
their FPGA implementation's choice): the input dimension is split into
partitions of size N and, within each output group of N outputs, every
partition is owned by the N outputs as an exact permutation.

Two permutation families are supported:

* ``random`` — faithful default: an arbitrary permutation per (group,
  partition), sampled from a seeded generator.  Matches the paper's "does not
  dictate the relative positions of the non-zero elements".
* ``cyclic`` — beyond-paper, hardware-codesigned variant: the permutation is a
  cyclic shift, so the route table stores one int8 per (group, partition)
  instead of N — route storage drops from G*P*N to G*P bytes and kernel-side
  decompression becomes a vector roll.

All functions are pure numpy (mask generation is an offline preprocessing
step, exactly as the paper's "Combine ... is done offline").
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

PermKind = Literal["random", "cyclic"]


@dataclasses.dataclass(frozen=True)
class CSLayout:
    """Static description of a complementary-sparse linear layer.

    Attributes:
      d_in: input features (must be divisible by ``n``).
      d_out: output features (must be divisible by ``n``).
      n: pack factor == partition size == weights-per-partition-per-output.
         Weight density is exactly ``1/n``.
      perm_kind: permutation family (see module docstring).
    """

    d_in: int
    d_out: int
    n: int
    perm_kind: PermKind = "random"

    def __post_init__(self) -> None:
        if self.n < 1:
            raise ValueError(f"pack factor n must be >= 1, got {self.n}")
        if self.d_in % self.n:
            raise ValueError(f"d_in={self.d_in} not divisible by n={self.n}")
        if self.d_out % self.n:
            raise ValueError(f"d_out={self.d_out} not divisible by n={self.n}")

    @property
    def groups(self) -> int:  # G
        return self.d_out // self.n

    @property
    def partitions(self) -> int:  # P
        return self.d_in // self.n

    @property
    def density(self) -> float:
        return 1.0 / self.n

    @property
    def sparsity(self) -> float:
        return 1.0 - self.density

    @property
    def nnz(self) -> int:
        """Non-zeros of the *unpacked* sparse weight == packed element count."""
        return self.groups * self.partitions * self.n


def make_routes(layout: CSLayout, seed: int) -> np.ndarray:
    """Sample the complementary routing tensor.

    Returns ``route`` of shape (G, P, N) int8 where ``route[g, p, s]`` is the
    offset-within-partition of output-slot ``s``'s non-zero weight.  For every
    (g, p), ``route[g, p, :]`` is a permutation of ``range(N)`` — this *is*
    the complementarity guarantee: the N sparse columns of group g tile
    partition p with no collisions and no gaps.
    """
    g, p, n = layout.groups, layout.partitions, layout.n
    rng = np.random.default_rng(seed)
    if layout.perm_kind == "cyclic":
        shift = rng.integers(0, n, size=(g, p))
        route = (np.arange(n)[None, None, :] + shift[:, :, None]) % n
    else:
        # Batched random permutations via argsort of uniform keys.
        keys = rng.random((g, p, n))
        route = np.argsort(keys, axis=-1)
    if n > 127:
        return route.astype(np.int32)
    return route.astype(np.int8)


def routes_to_mask(layout: CSLayout, route: np.ndarray) -> np.ndarray:
    """Expand routes to the binary mask of the unpacked sparse weight.

    Returns ``mask`` (d_in, d_out) uint8 with mask[j, o] == 1 iff W[j, o] is a
    permitted non-zero.  Used to constrain training (the paper trains with a
    static binary mask, §4) and as the oracle for complementarity tests.
    """
    g, p, n = layout.groups, layout.partitions, layout.n
    mask = np.zeros((layout.d_in, layout.d_out), np.uint8)
    gg, pp, ss = np.meshgrid(
        np.arange(g), np.arange(p), np.arange(n), indexing="ij"
    )
    j = pp * n + route.astype(np.int64)  # input index
    o = gg * n + ss  # output index
    mask[j.ravel(), o.ravel()] = 1
    return mask


def validate_complementary(layout: CSLayout, route: np.ndarray) -> None:
    """Raise if ``route`` violates the complementarity invariants."""
    g, p, n = layout.groups, layout.partitions, layout.n
    if route.shape != (g, p, n):
        raise ValueError(f"route shape {route.shape} != {(g, p, n)}")
    sorted_r = np.sort(route.astype(np.int64), axis=-1)
    if not (sorted_r == np.arange(n)[None, None, :]).all():
        raise ValueError("route is not a permutation per (group, partition): "
                         "non-zero positions collide or leave gaps")


def make_mask(d_in: int, d_out: int, n: int, seed: int = 0,
              perm_kind: PermKind = "random") -> np.ndarray:
    """Convenience: complementary binary mask for a (d_in, d_out) weight."""
    layout = CSLayout(d_in, d_out, n, perm_kind)
    return routes_to_mask(layout, make_routes(layout, seed))


def conv_layout(kh: int, kw: int, c_in: int, c_out: int, n: int,
                perm_kind: PermKind = "random") -> CSLayout:
    """Layout for a conv kernel packed along the *filter* dimension (paper
    Fig. 7): the flattened (kh*kw*c_in) receptive field is the partitioned
    input dim; groups of N output channels are complementary."""
    return CSLayout(kh * kw * c_in, c_out, n, perm_kind)


def pad_to_multiple(d: int, n: int) -> int:
    """Smallest d' >= d with d' % n == 0 (for layers whose dims don't divide n)."""
    return ((d + n - 1) // n) * n

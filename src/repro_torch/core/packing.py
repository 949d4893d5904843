"""Pack / unpack between sparse dense-format weights and the complementary
packed representation.

Packed layout (pre-routed): for layout (G, P, N),

    packed[g, p, s] = W[p*N + route[g, p, s], g*N + s]

i.e. slot ``s`` of group ``g`` holds that output's (single) non-zero weight in
partition ``p``.  Because the permutation is applied to the *weights offline*,
the runtime only re-orders activations (a static gather) — this is the
paper's §3.1 remark "it may prove preferential to reorder the incoming
activations", which removes the crossbar from the runtime entirely.

The paper's "Kernel ID" augmented tensor (§3.3.1, Fig. 8b) corresponds to the
(packed, route) pair: route *is* the Kernel-ID table, except stored inverse
(weight-major) because routing has been hoisted offline.
"""

from __future__ import annotations

import numpy as np

from .masks import CSLayout, validate_complementary


def pack_dense(layout: CSLayout, w: np.ndarray, route: np.ndarray,
               validate: bool = True) -> np.ndarray:
    """Pack a (masked) dense-format weight into (G, P, N).

    ``w`` is (d_in, d_out); entries off the complementary support are ignored
    (they are zero for a correctly-trained CS network).
    """
    g, p, n = layout.groups, layout.partitions, layout.n
    if w.shape != (layout.d_in, layout.d_out):
        raise ValueError(f"w shape {w.shape} != {(layout.d_in, layout.d_out)}")
    if validate:
        validate_complementary(layout, route)
    wr = w.reshape(p, n, g, n)  # [p, i, g, s]
    pp = np.arange(p)[None, :, None]
    gg = np.arange(g)[:, None, None]
    ss = np.arange(n)[None, None, :]
    # packed[g, p, s] = wr[p, route[g,p,s], g, s]
    return wr[pp, route.astype(np.int64), gg, ss]


def unpack(layout: CSLayout, packed: np.ndarray, route: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_dense`: reconstruct the sparse (d_in, d_out) W."""
    g, p, n = layout.groups, layout.partitions, layout.n
    w = np.zeros((p, n, g, n), packed.dtype)
    pp = np.arange(p)[None, :, None]
    gg = np.arange(g)[:, None, None]
    ss = np.arange(n)[None, None, :]
    w[pp, route.astype(np.int64), gg, ss] = packed
    return w.reshape(layout.d_in, layout.d_out)


def pack_conv(layout: CSLayout, w: np.ndarray, route: np.ndarray) -> np.ndarray:
    """Pack a conv kernel (kh, kw, c_in, c_out) along the filter dimension."""
    kh, kw, c_in, c_out = w.shape
    if kh * kw * c_in != layout.d_in or c_out != layout.d_out:
        raise ValueError(f"conv kernel {w.shape} incompatible with layout "
                         f"({layout.d_in}, {layout.d_out})")
    return pack_dense(layout, w.reshape(layout.d_in, c_out), route)


def unpack_conv(layout: CSLayout, packed: np.ndarray, route: np.ndarray,
                kh: int, kw: int, c_in: int) -> np.ndarray:
    w = unpack(layout, packed, route)
    return w.reshape(kh, kw, c_in, layout.d_out)


def packed_bytes(layout: CSLayout, weight_dtype_bytes: int = 2) -> dict:
    """Storage accounting (the paper's N-fold compression claim).

    Returns dense vs packed byte counts, including route-table overhead, for
    both random-permutation (int8/route-element) and cyclic (int8/partition)
    encodings.
    """
    dense = layout.d_in * layout.d_out * weight_dtype_bytes
    packed_w = layout.nnz * weight_dtype_bytes
    route_random = layout.groups * layout.partitions * layout.n  # int8 each
    route_cyclic = layout.groups * layout.partitions  # one shift each
    return {
        "dense_bytes": dense,
        "packed_weight_bytes": packed_w,
        "route_bytes_random": route_random,
        "route_bytes_cyclic": route_cyclic,
        "compression_random": dense / (packed_w + route_random),
        "compression_cyclic": dense / (packed_w + route_cyclic),
    }

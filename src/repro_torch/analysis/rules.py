"""Graph-level lint rules for the sparsity invariants (the counterpart of
the reference's ``repro.analysis.rules``).

Each rule is a function ``(gm, ctx...) -> List[Finding]`` over a traced
entry point (:func:`~repro_torch.analysis.graph_walk.trace`).  Layer
attribution reads the scopes the model code opens (``u{u}`` units,
``b{i}_{kind}`` blocks, ``ffn_up``/``ffn_gate``/``ffn_kwta``/``ffn_down``
and ``o_proj`` families, ``cs_{path}`` execution paths, ``select`` around
every counted ``torch.topk``).

Rules
-----
``select-count``     one Select (topk) per sparse layer (paper Fig. 8a)
``dense-fallback``   the k-sparse support must reach a kernel custom op,
                     never a dense product (sparse-sparse stays sparse)
``dtype-promotion``  no float64 or complex128 value in the graph; no
                     kernel operand of a type its custom op does not
                     declare
``launch-resource``  every kernel launch's geometry fits sm_90: at most
                     1024 threads a block, 227 KB of dynamic shared
                     memory, clusters of at most 8, the grid's bounds (the
                     reference's ``pallas-resource``; its
                     ``scratch-overflow`` is the shared-memory limit here)
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.build import Geometry
from repro_torch.kernels.grouped_cs_matmul import \
    launch_geometry as grouped_geometry
from repro_torch.kernels.kwta_hist import launch_geometry as kwta_geometry
from repro_torch.kernels.packed_matmul import \
    launch_geometry as packed_geometry
from repro_torch.kernels.topk_gather import launch_geometry as topk_geometry
from repro_torch.kernels.registry import OPERAND_DTYPES

from .findings import Finding
from .graph_walk import iter_nodes, op_name, propagate_taint, values

#: Ops that implement a Select (top-k winner choice).  ``sort`` is counted
#: too: a sort-based k-WTA is a Select with a worse lowering.
SELECT_OPS = ("aten.topk", "aten.sort", "aten.argsort")
#: The port's kernels, each one custom op: the sanctioned sparse consumers.
KERNEL_OPS = tuple(OPERAND_DTYPES)
#: Dense products: touching the Select's support means a dense fallback.
DENSE_OPS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
             "aten.matmul", "aten.linear", "aten.convolution")

#: Family markers opened by models/ffn.py and models/attention.py.
_FAMILY_OF_SEG = {"o_proj": "o_proj"}
_BLOCK_SEG = re.compile(r"^b\d+_")
_UNIT_SEG = re.compile(r"^u\d+$")


def layer_key(path: str) -> str:
    """Collapse a scope path to its sparse-layer key (the reference's).

    ``b0_attn/ffn_down/cs_topk/select`` -> ``b0_attn/ffn``;
    ``b1_attn/o_proj/...`` -> ``b1_attn/o_proj``; paths outside any
    family scope collapse to their block prefix (or "")."""
    blocks: List[str] = []
    for seg in path.split("/"):
        if _BLOCK_SEG.match(seg):
            blocks.append(seg)
            continue
        fam = _FAMILY_OF_SEG.get(seg)
        if fam is None and seg.startswith("ffn_"):
            fam = "ffn"
        if fam is not None:
            return "/".join(blocks + [fam])
    return "/".join(blocks)


def unit_of(path: str) -> str:
    """The ``u{u}`` unit segment of a path ("" outside the layer stack)."""
    seg = path.split("/", 1)[0]
    return seg if _UNIT_SEG.match(seg) else ""


def select_counts(gm) -> Dict[Tuple[str, str], int]:
    """Select ops per (unit, layer key)."""
    counts: Dict[Tuple[str, str], int] = {}
    for node, path in iter_nodes(gm):
        if op_name(node) in SELECT_OPS:
            at = (unit_of(path), layer_key(path))
            counts[at] = counts.get(at, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# Rule: select-count
# ---------------------------------------------------------------------------

def rule_select_count(gm, expected: Optional[Dict[str, int]],
                      entry: str = "") -> List[Finding]:
    """One Select per sparse layer (paper Fig. 8a), in every unit.

    ``expected`` maps layer keys (:func:`layer_key`) to the Selects each
    unit should trace, from :func:`~repro_torch.analysis.lint.
    expected_selects`; ``None`` skips the rule.  The reference counts one
    scan body; the port's graph holds every unit, and each is held to
    the same map."""
    if expected is None:
        return []
    counts = select_counts(gm)
    units = sorted({unit_of(p) for _, p in iter_nodes(gm)} - {""}) or [""]
    out: List[Finding] = []
    for unit in units:
        def scope(key):
            return f"{unit}/{key}" if unit else key
        for key, exp in sorted(expected.items()):
            got = counts.get((unit, key), 0)
            if got > exp:
                out.append(Finding(
                    rule="select-count", entry=entry, scope=scope(key),
                    primitive="topk",
                    message=f"layer {scope(key) or '<entry>'} traces {got} "
                            f"Select ops, expected {exp} (one Select per "
                            f"sparse layer)"))
            elif got < exp:
                out.append(Finding(
                    rule="select-count", entry=entry, scope=scope(key),
                    primitive="topk", severity="warning",
                    message=f"layer {scope(key) or '<entry>'} traces {got} "
                            f"Select ops, model expected {exp} — the Select "
                            f"model in analysis/lint.py is out of date"))
    for (unit, key), got in sorted(counts.items()):
        if key in expected or not key:
            continue
        if key.rsplit("/", 1)[-1] in ("ffn", "o_proj"):
            where = f"{unit}/{key}" if unit else key
            out.append(Finding(
                rule="select-count", entry=entry, scope=where,
                primitive="topk",
                message=f"unmodeled sparse layer {where} traces {got} "
                        f"Select ops"))
    return out


# ---------------------------------------------------------------------------
# Rule: dense-fallback
# ---------------------------------------------------------------------------

def rule_dense_fallback(gm, entry: str = "") -> List[Finding]:
    """The k-sparse support must be consumed by a kernel custom op.

    Taint flows from every ``aten.topk`` output (the Select's support);
    the ``repro_torch::`` kernels are the sanctioned sinks.  A dense
    product touching tainted data means the sparse-sparse contraction
    fell back to dense math.  Only meaningful where the entry point is
    configured for the kernel's topk path; the caller gates on that."""
    out = []
    for node, path in propagate_taint(gm, ("aten.topk",), KERNEL_OPS,
                                      DENSE_OPS):
        name = op_name(node)
        out.append(Finding(
            rule="dense-fallback", entry=entry, scope=path, primitive=name,
            message=f"{name} consumes the k-sparse Select support in layer "
                    f"{layer_key(path) or '<entry>'} — expected the "
                    f"sparse-sparse kernel (use_pallas is on); the "
                    f"contraction fell back to dense math"))
    return out


# ---------------------------------------------------------------------------
# Rule: dtype-promotion
# ---------------------------------------------------------------------------

_WIDE_DTYPES = (torch.float64, torch.complex128)


def _operand_tensors(node):
    """The fake tensors of a node's tensor arguments, in order."""
    out = []
    for a in node.args:
        if isinstance(a, torch.fx.Node):
            vals = values(a)
            if vals and not isinstance(a.meta.get("val"), (tuple, list)):
                out.append(vals[0])
    return out


def rule_dtype_promotion(gm, entry: str = "") -> List[Finding]:
    """No 64-bit float anywhere; kernel operands of their declared types.

    A float64 value (usually a Python or numpy scalar turned into a
    float64 tensor) doubles the bytes it touches and leaves the fast
    path; a kernel operand of a type its custom op does not declare
    (``kernels/registry.OPERAND_DTYPES``) would be cast or refused."""
    out: List[Finding] = []
    for node, path in iter_nodes(gm):
        name = op_name(node)
        for v in values(node):
            if v.dtype in _WIDE_DTYPES:
                out.append(Finding(
                    rule="dtype-promotion", entry=entry, scope=path,
                    primitive=name,
                    message=f"{name} makes a {v.dtype} value in "
                            f"{layer_key(path) or '<entry>'} — 64-bit types "
                            f"must never reach the sparse kernels"))
                break
        declared = OPERAND_DTYPES.get(name)
        if declared is None:
            continue
        for i, (t, allowed) in enumerate(zip(_operand_tensors(node),
                                             declared)):
            if t.dtype not in allowed:
                out.append(Finding(
                    rule="dtype-promotion", entry=entry, scope=path,
                    primitive=name,
                    message=f"{name} operand {i} is {t.dtype}, wider than "
                            f"its declared types {list(allowed)}"))
    return out


# ---------------------------------------------------------------------------
# Rule: launch-resource
# ---------------------------------------------------------------------------

#: sm_90 limits (CUDA C++ Programming Guide, compute capability 9.0)
MAX_THREADS = 1024
MAX_DYNAMIC_SMEM = 227 * 1024          # the opt-in maximum of a block
MAX_CLUSTER = 8                        # the portable cluster size
MAX_GRID = (2**31 - 1, 65535, 65535)


def _bf16(*ts) -> bool:
    return all(t.dtype == torch.bfloat16 for t in ts)


def kernel_geometry(name: str, args) -> Geometry:
    """The launcher's geometry for a kernel custom op's operands."""
    if name == "repro_torch.topk_gather":
        vals, _, _, packed_p = args[:4]
        p, g, n = packed_p.shape
        return topk_geometry(vals.shape[0], vals.shape[1], g, n,
                             packed_p.element_size())
    if name == "repro_torch.packed_matmul":
        x, packed = args[:2]
        g, _, n = packed.shape
        return packed_geometry(x.shape[0], g, n, _bf16(x, packed))
    if name == "repro_torch.grouped_cs_matmul":
        xg, packed = args[:2]
        return grouped_geometry(xg.shape[0], xg.shape[1], packed.shape[2],
                                _bf16(xg, packed))
    if name == "repro_torch.kwta_hist":
        return kwta_geometry(args[0].shape[0])
    raise KeyError(name)


def check_geometry(kernel: str, geo: Geometry, entry: str = "",
                   scope: str = "") -> List[Finding]:
    """Hold one launch's geometry to the sm_90 limits."""
    problems = []
    if not 1 <= geo.threads <= MAX_THREADS:
        problems.append(f"{geo.threads} threads a block (limit "
                        f"{MAX_THREADS})")
    if geo.smem > MAX_DYNAMIC_SMEM:
        problems.append(f"{geo.smem} B of dynamic shared memory (limit "
                        f"{MAX_DYNAMIC_SMEM} B)")
    if not 1 <= geo.cluster <= MAX_CLUSTER:
        problems.append(f"clusters of {geo.cluster} blocks (limit "
                        f"{MAX_CLUSTER})")
    for axis, (extent, limit) in enumerate(zip(geo.grid, MAX_GRID)):
        if not 1 <= extent <= limit:
            problems.append(f"grid axis {axis} of extent {extent} (limit "
                            f"{limit})")
    if geo.grid[0] % geo.cluster:
        problems.append(f"grid axis 0 of {geo.grid[0]} is not a multiple "
                        f"of the cluster {geo.cluster}")
    return [Finding(rule="launch-resource", entry=entry, scope=scope,
                    primitive=kernel,
                    message=f"kernel {kernel}: launch {geo} has {p}")
            for p in problems]


def rule_launch_resource(gm, entry: str = "") -> List[Finding]:
    """Every kernel custom op's launch, at the traced shapes, fits sm_90."""
    out: List[Finding] = []
    for node, path in iter_nodes(gm):
        name = op_name(node)
        if name not in KERNEL_OPS:
            continue
        geo = kernel_geometry(name, _operand_tensors(node))
        out.extend(check_geometry(name, geo, entry, path))
    return out

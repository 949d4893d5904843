"""Traced FX graphs with scope paths, and taint propagation over them (the
counterpart of the reference's ``repro.analysis.jaxpr_walk``).

* :func:`trace` stages a callable with ``make_fx`` on fake tensors, so a
  full-scale configuration traces on the CPU without allocating a weight.
  The model code's :func:`~repro_torch.core.instrument.named_scope`\\ s
  annotate every node made inside them while it traces.  Ops become aten
  ops; the port's kernels are single ``repro_torch::`` custom-op nodes.
* :func:`iter_nodes` yields every op node with its scope path
  (``u0/b0_attn/ffn_down/cs_topk/select``).  PyTorch runs the layer stack
  as a Python loop, so the graph holds every layer, each under a ``u{u}``
  unit scope; the reference's scan body is one unit.
* :func:`propagate_taint` runs a forward may-analysis over the graph:
  outputs of *source* ops are tainted, taint flows through every node
  except *sinks*, and each (tainted input, *flagged* op) is reported.
  The dense-fallback rule uses it with sources ``aten.topk`` (the
  Select), the ``repro_torch::`` kernels as sinks, and the dense products
  flagged.  An in-place op's output node stands for the mutated tensor in
  later uses, so taint written into a buffer in place flows on.
"""

from __future__ import annotations

import operator
from typing import Iterator, List, NamedTuple, Sequence

import torch
import torch.fx
import torch.fx.traceback as fx_traceback
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.core.instrument import tracing_scopes


def trace(fn, *args) -> torch.fx.GraphModule:
    """``make_fx`` of ``fn(*args)`` on fake tensors (real or fake inputs,
    in nested dicts and lists), with the model's scopes on the nodes."""
    with tracing_scopes(), fx_traceback.preserve_node_meta():
        return make_fx(fn, tracing_mode="fake")(*args)


def op_name(node: torch.fx.Node) -> str:
    """``aten.topk``, ``repro_torch.topk_gather``, ``getitem``... for a
    ``call_function`` node (the op without its overload)."""
    target = node.target
    if target is operator.getitem:
        return "getitem"
    schema = getattr(target, "_schema", None)
    if schema is not None:
        return schema.name.replace("::", ".")
    return getattr(target, "__name__", str(target))


def scope_of(node: torch.fx.Node) -> str:
    return node.meta.get("custom", {}).get("scope", "")


class NodeAt(NamedTuple):
    node: torch.fx.Node
    path: str


def iter_nodes(gm: torch.fx.GraphModule) -> Iterator[NodeAt]:
    """Every op node of the graph, in order, with its scope path."""
    for node in gm.graph.nodes:
        if node.op == "call_function":
            yield NodeAt(node, scope_of(node))


def values(node: torch.fx.Node) -> List[torch.Tensor]:
    """The fake tensors a node produces (its ``meta["val"]``)."""
    val = node.meta.get("val")
    items = val if isinstance(val, (tuple, list)) else (val,)
    return [v for v in items if isinstance(v, torch.Tensor)]


def propagate_taint(gm: torch.fx.GraphModule, sources: Sequence[str],
                    sinks: Sequence[str],
                    flagged: Sequence[str]) -> List[NodeAt]:
    """Forward taint over the graph; returns the flagged hits.

    * outputs of any ``sources`` op are tainted;
    * ``sinks`` consume taint (their outputs are clean);
    * a ``flagged`` op with any tainted input is reported;
    * every other node taints its output when any input is tainted."""
    tainted = set()
    hits: List[NodeAt] = []
    for node, path in iter_nodes(gm):
        name = op_name(node)
        any_in = any(a in tainted for a in node.all_input_nodes)
        if name in flagged and any_in:
            hits.append(NodeAt(node, path))
        if name in sources or (any_in and name not in sinks):
            tainted.add(node)
    return hits

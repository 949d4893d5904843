"""Host-transfer and collective rules over a traced graph (the counterpart
of the reference's ``repro.analysis.hlo_rules``, which reads compiled HLO).

PyTorch runs eagerly, so there is no compiled module to read: the traced
aten graph is what the device is asked to run, op by op.

* ``host-transfer`` — a node that brings a value to the host or needs it
  there: a scalar read (``aten._local_scalar_dense``, ``aten.item``), an
  op whose output shape depends on the data (``aten.nonzero``,
  ``aten.masked_select``, ``aten.unique``...), or a copy from a device to
  the CPU.  A trace that stops because the code asks for a value
  (``bool(t)``, ``int(t)``, ``t.numpy()``) becomes a finding of the same
  rule, naming the line that asked (:func:`trace_error_finding`).  The ops
  are :data:`repro_torch.launch.hlo.HOST_OPS`, which the census counts.
* ``collective`` — any ``c10d`` or ``_c10d_functional`` node: the
  single-process entry points must not communicate.
"""

from __future__ import annotations

import traceback
from pathlib import Path
from typing import List, Optional

from repro_torch.launch.hlo import HOST_OPS

from .findings import Finding
from .graph_walk import iter_nodes, op_name, values

#: copies that may cross from a device to the host
_COPY_OPS = ("aten._to_copy", "aten.to", "aten.copy", "aten.copy_",
             "aten._copy_from", "aten._copy_from_and_resize")
_COLLECTIVE_NS = ("c10d.", "_c10d_functional.", "c10d_functional.")
_PACKAGE = Path(__file__).resolve().parents[1]


def _devices(node) -> set:
    return {v.device.type for a in node.all_input_nodes for v in values(a)}


def rule_host_transfer(gm, entry: str = "") -> List[Finding]:
    """Any value brought to the host on the linted path is an error: one
    round trip stalls the device queue, and the decode step must stay
    asynchronous."""
    out: List[Finding] = []
    for node, path in iter_nodes(gm):
        name = op_name(node)
        if name in HOST_OPS:
            why = "reads a tensor value on the host"
        elif name in _COPY_OPS and any(
                v.device.type == "cpu" for v in values(node)) and (
                _devices(node) - {"cpu"}):
            why = "copies a device tensor to the host"
        else:
            continue
        out.append(Finding(
            rule="host-transfer", entry=entry, scope=path, primitive=name,
            message=f"{name} {why} in {path or '<entry>'}"))
    return out


def rule_collectives(gm, entry: str = "") -> List[Finding]:
    """Collectives in a single-process entry point are errors."""
    return [Finding(
        rule="collective", entry=entry, scope=path, primitive=op_name(node),
        message=f"unexpected collective {op_name(node)} in the "
                f"{entry or 'entry'} graph")
        for node, path in iter_nodes(gm)
        if op_name(node).startswith(_COLLECTIVE_NS)]


def _data_dependent_errors() -> tuple:
    """The errors a fake-tensor trace raises where the code needs a
    tensor's value (all RuntimeErrors)."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)
    from torch.fx.experimental.symbolic_shapes import \
        GuardOnDataDependentSymNode
    return (DataDependentOutputException, DynamicOutputShapeException,
            GuardOnDataDependentSymNode)


def trace_error_finding(exc: RuntimeError,
                        entry: str = "") -> Optional[Finding]:
    """The ``host-transfer`` finding for an error that stopped a trace
    because the code asked for a tensor's value, or None for any other
    error (which the caller re-raises).  It names the op where the error
    carries one, and the innermost line of this package that asked."""
    numpy = ".numpy()" in str(exc)
    if not (numpy or isinstance(exc, _data_dependent_errors())):
        return None
    func = getattr(exc, "func", None)
    name = ("Tensor.numpy" if numpy else
            str(func) if func is not None else type(exc).__name__)
    where = ""
    for frame in reversed(traceback.extract_tb(exc.__traceback__)):
        path = Path(frame.filename).resolve()
        if _PACKAGE in path.parents and "analysis" not in path.parts[-2:]:
            where = (f" at {path.relative_to(_PACKAGE.parent)}:"
                     f"{frame.lineno} ({frame.line})")
            break
    return Finding(rule="host-transfer", entry=entry, primitive=name,
                   message=f"{name} needs a tensor's value on the host"
                           f"{where}: the trace stopped there")

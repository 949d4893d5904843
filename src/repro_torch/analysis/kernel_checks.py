"""Kernel checks as guarded launches of the real kernels (the counterpart
of the reference's kernel-body verifier, ``repro.analysis.kernel_rules``
with ``intervals``).

The reference re-interprets each Pallas kernel body over an interval
domain and proves its index accesses and its cross-step writes.  No CPU
emulation of a CUDA body exists, so here the same rule families are
checked dynamically: each kernel is launched on the card on operands laid
inside guard bands, and its outputs tell what it touched.  Refs are
numbered as the reference numbers a kernel body's operands: inputs first,
then outputs (``in[2]`` is the third input; with three inputs the output
is ``out[3]``, with two ``out[2]``).

``oob-access`` (the reference's family of that name, and its
``unmasked-pad``: a ragged edge that reads past an operand is a read
outside it here)
    Each operand is copied into the middle of a larger buffer.  The
    guard bands are 0 for float operands and an in-range value (0) for
    index operands in the clean launch; the output's guard bands carry a
    canary bit pattern.  Then one launch per float input fills only that
    input's guards with NaN.  An output that turns non-finite, or differs
    from the clean launch in any bit, means the kernel read outside that
    input: the finding names the kernel and ``in[i]``.  So does an
    output guard band that differs from the clean launch's (a read
    outside the input whose value the kernel stored outside the output,
    as an unmasked ragged block does).  A changed canary means it wrote
    outside ``out[j]``.

``grid-race`` (the reference's family of that name)
    The kernel runs twice, its outputs pre-filled with NaN and with a
    finite pattern.  The two results must agree bit for bit; where they
    do not, ``out[j]`` was read before it was written (a missing init), or
    some of it was not written at all.

``scratch-overflow`` folds into ``launch-resource`` (``rules.py``): a
block's shared memory against the card's limit, from each launcher's
geometry.

What a dynamic check cannot see:

* a read past an index operand: its guards hold in-range values so that
  the kernel may not fault, and a read that lands on one looks like a
  legal index;
* a read past a float operand whose value is multiplied by 0 in the clean
  launch and is NaN in the poisoned one is seen; one whose value is
  discarded (a masked lane) is not, and need not be;
* an unguarded overwrite whose result is deterministic (the reference's
  "last writer wins" across grid steps): every launch writes the same
  bits;
* an index operand with no declared range (the reference's "unbounded
  index" finding): every case here draws its indices over a range it
  declares, both ends included;
* any fault at shapes or index values the checked cases do not reach
  (the registry sweeps and the serving shapes).

On the CPU the same harness drives the plain versions (``*_into`` writes
the plain result into the given output).  There a view cannot be read
past: torch's bounds check raises, and the operand that was indexed
becomes the ``oob-access`` finding.  The reference's clean and faulty
fixtures of ``tests/test_kernel_rules.py`` that a dynamic check can see
are CUDA kernels with plain versions in :mod:`.fixtures`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode

from .findings import Finding

#: elements of a guard band: at least this many bytes on each side, and at
#: least the operand itself, in whole multiples of 256 bytes (the kernels'
#: 16-byte alignment holds inside the buffer)
_BAND_BYTES = 256
#: bits of the output canary
_CANARY = {4: 0x7FA1B2C3, 2: 0x7FA1}
_INT_VIEW = {4: torch.int32, 2: torch.int16}


@dataclasses.dataclass
class Case:
    """One kernel at one set of operands.

    ``run(outs, *inputs)`` writes the kernel's outputs into ``outs``: the
    kernel on CUDA tensors, its plain version on CPU tensors.  ``inputs``
    are the clean operands, the integer ones indices drawn over their
    declared ranges (their guards hold 0, in range, and are never
    poisoned); ``outputs`` the (shape, dtype) of each output."""
    kernel: str
    label: str
    run: Callable
    inputs: Sequence[torch.Tensor]
    outputs: Sequence[Tuple[tuple, torch.dtype]]


def ref_label(kind: str, idx: int, t) -> str:
    """``in[2] float32[16x4x4]``, as the reference labels a Ref."""
    shape = "x".join(str(d) for d in t.shape)
    return f"{kind}[{idx}] {str(t.dtype).replace('torch.', '')}[{shape}]"


class _Guarded:
    """An operand laid in the middle of a buffer with a guard band on each
    side; ``view`` is the operand the kernel sees."""

    def __init__(self, shape, dtype, device):
        size = torch.empty((), dtype=dtype).element_size()
        n = 1
        for d in shape:
            n *= d
        unit = _BAND_BYTES // size
        self.band = max(unit, -(-n // unit) * unit)
        self.buf = torch.empty(n + 2 * self.band, dtype=dtype, device=device)
        self.view = self.buf[self.band:self.band + n].view(shape)
        self.n = n

    def guards(self):
        return (self.buf[:self.band], self.buf[self.band + self.n:])

    def fill_guards(self, value) -> None:
        for g in self.guards():
            g.fill_(value)

    def fill_canary(self) -> None:
        for g in self.guards():
            _bits(g).fill_(_canary_bits(g))

    def canary_intact(self) -> bool:
        return all(bool((_bits(g) == _canary_bits(g)).all())
                   for g in self.guards())


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The same bytes as a signed integer tensor of the same width."""
    return t.view(_INT_VIEW[t.element_size()])


def _canary_bits(t) -> int:
    """The canary as a value of :func:`_bits`' signed type."""
    bits, top = _CANARY[t.element_size()], 1 << (8 * t.element_size())
    return bits - top if bits >= top // 2 else bits


class _IndexProbe(TorchFunctionMode):
    """Records which operand a torch call was indexing when its bounds
    check raised (the CPU's counterpart of a read outside an operand).  A
    tensor made from an operand (a reshape, a cast) stands for it."""

    def __init__(self, operands):
        super().__init__()
        self.origin = {id(t): i for i, t in enumerate(operands)}
        self.keep = list(operands)        # ids stay unique while probing
        self.culprit: Optional[int] = None

    def _first_origin(self, args):
        for a in args:
            for t in (a if isinstance(a, (list, tuple)) else (a,)):
                if isinstance(t, torch.Tensor) and id(t) in self.origin:
                    return self.origin[id(t)]
        return None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        try:
            out = func(*args, **(kwargs or {}))
        except (IndexError, RuntimeError) as e:
            if self.culprit is None and "out of bounds" in str(e):
                self.culprit = self._first_origin(args)
            raise
        src = self._first_origin(args[:1])
        if src is not None and isinstance(out, torch.Tensor):
            self.origin[id(out)] = src
            self.keep.append(out)
        return out


def _launch(case, ins, outs, out_fill) -> Optional[Tuple[int, str]]:
    """Run the case once: every input view refilled from the clean
    operands, every output view filled with ``out_fill``.  Returns None, or
    (the input indexed, the error) where a CPU bounds check raised."""
    for g, t in zip(ins, case.inputs):
        g.view.copy_(t)
    for g in outs:
        g.view.fill_(out_fill)
    cpu = ins[0].view.device.type == "cpu"
    probe = _IndexProbe([g.view for g in ins])
    try:
        with probe if cpu else contextlib.nullcontext():
            case.run([g.view for g in outs], *[g.view for g in ins])
    except (IndexError, RuntimeError) as e:
        if probe.culprit is None:
            raise
        return probe.culprit, str(e).splitlines()[0]
    if not cpu:
        torch.cuda.synchronize(ins[0].view.device)
    return None


def check_case(case: Case, entry: str = "") -> List[Finding]:
    """The ``oob-access`` and ``grid-race`` checks of one case."""
    device = case.inputs[0].device
    n_in = len(case.inputs)
    ins = [_Guarded(t.shape, t.dtype, device) for t in case.inputs]
    outs = [_Guarded(s, d, device) for s, d in case.outputs]
    for g in ins:
        g.fill_guards(0)
    for g in outs:
        g.fill_canary()
    findings: List[Finding] = []

    def find(rule, message):
        findings.append(Finding(
            rule=rule, entry=entry, primitive=case.kernel,
            message=f"kernel {case.kernel}: {message}"))

    def read_outside(i, how):
        find("oob-access", f"reads outside {ref_label('in', i, ins[i].view)}"
                           f" ({how})")

    raised = _launch(case, ins, outs, 0)
    if raised is not None:
        read_outside(raised[0], f"the bounds check raised: {raised[1]}")
        return findings
    clean = [g.view.clone() for g in outs]
    clean_bands = [[_bits(b).clone() for b in g.guards()] for g in outs]
    for i, g in enumerate(ins):
        if not g.view.dtype.is_floating_point:
            continue
        g.fill_guards(float("nan"))
        _launch(case, ins, outs, 0)
        g.fill_guards(0)
        for got, want in zip((o.view for o in outs), clean):
            if not torch.equal(_bits(got), _bits(want)):
                nonfinite = int((~torch.isfinite(got.float())
                                 & torch.isfinite(want.float())).sum())
                read_outside(i, f"with its guard bands NaN, {nonfinite} "
                                f"output values turn non-finite and the "
                                f"output changes")
                break
        else:
            for j, (o, bands) in enumerate(zip(outs, clean_bands)):
                if any(not torch.equal(_bits(b), want)
                       for b, want in zip(o.guards(), bands)):
                    read_outside(i, "with its guard bands NaN, what the "
                                    "kernel writes past "
                                    f"{ref_label('out', n_in + j, o.view)}"
                                    " changes")
                    break
    runs = []
    for fill in (float("nan"), 1.0):
        _launch(case, ins, outs, fill)
        runs.append([g.view.clone() for g in outs])
    for j, (a, b) in enumerate(zip(*runs)):
        differ = ~torch.eq(_bits(a), _bits(b))
        if bool(differ.any()):
            find("grid-race",
                 f"{ref_label('out', n_in + j, outs[j].view)} read before "
                 f"written: {int(differ.sum())} of {differ.numel()} values "
                 f"depend on what the buffer held before the launch (NaN "
                 f"against a finite pattern)")
    for j, g in enumerate(outs):              # after every launch above
        if not g.canary_intact():
            find("oob-access", f"writes outside "
                               f"{ref_label('out', n_in + j, g.view)} "
                               f"(its guard band changed)")
    return findings


def check_cases(cases: Sequence[Case], entry_prefix: str = "kernels"):
    """(entries, findings) of every case, one entry each."""
    entries, findings = [], []
    for case in cases:
        entry = f"{entry_prefix}:{case.label}"
        entries.append(entry)
        findings.extend(check_case(case, entry))
    return entries, findings

"""Structured findings emitted by the sparsity-invariant linter (a copy of
the reference's ``repro.analysis.findings``, which has no JAX in it).

A :class:`Finding` is one violated invariant, pinned to a rule id, an
entrypoint, a layer scope (the graph node's :func:`named_scope
<repro_torch.core.instrument.named_scope>` path, e.g.
``u0/b0_attn/ffn_down/cs_topk``) and the offending op.  A
:class:`Report` aggregates findings across rules/entrypoints and supports
waivers (exact rule ids or ``rule:scope-prefix`` pairs) so a known,
deliberate exception can be recorded without disabling the rule globally.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Sequence

#: Severity levels, in increasing order of badness.
SEVERITIES = ("info", "warning", "error")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated sparsity invariant.

    Attributes:
      rule: stable rule id (``select-count``, ``dense-fallback``,
        ``dtype-promotion``, ``launch-resource``, ``host-transfer``,
        ``collective``, ``oob-access``, ``grid-race``).
      message: human-readable description of the violation.
      entry: the linted entrypoint (``decode``, ``prefill``, ...).
      scope: scope path of the offending graph node ("" when the finding
        is not attributable to a scope, e.g. a kernel check).
      primitive: offending op or kernel name ("" when n/a).
      severity: ``info`` | ``warning`` | ``error``.
    """

    rule: str
    message: str
    entry: str = ""
    scope: str = ""
    primitive: str = ""
    severity: str = "error"

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    def render(self) -> str:
        where = "/".join(p for p in (self.entry, self.scope) if p)
        prim = f" [{self.primitive}]" if self.primitive else ""
        return f"{self.severity}: {self.rule} @ {where or '<module>'}" \
               f"{prim}: {self.message}"

    def matches_waiver(self, waiver: str) -> bool:
        """A waiver is ``rule`` or ``rule:scope-prefix``."""
        if ":" not in waiver:
            return self.rule == waiver
        rule, prefix = waiver.split(":", 1)
        return self.rule == rule and self.scope.startswith(prefix)


@dataclasses.dataclass
class Report:
    """Lint results: surviving findings plus the waived ones."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    waived: List[Finding] = dataclasses.field(default_factory=list)
    #: entrypoints that were actually linted (for "did it even run" checks)
    entries: List[str] = dataclasses.field(default_factory=list)

    def add(self, findings: Iterable[Finding],
            waivers: Sequence[str] = ()) -> None:
        for f in findings:
            if any(f.matches_waiver(w) for w in waivers):
                self.waived.append(f)
            else:
                self.findings.append(f)

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.waived.extend(other.waived)
        self.entries.extend(other.entries)

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.findings

    def render(self) -> str:
        lines = []
        if not self.findings:
            lines.append(f"clean: 0 findings over "
                         f"{', '.join(self.entries) or 'no entrypoints'}")
        else:
            lines.append(f"{len(self.findings)} finding(s):")
            lines.extend("  " + f.render() for f in self.findings)
        if self.waived:
            lines.append(f"{len(self.waived)} waived:")
            lines.extend("  " + f.render() for f in self.waived)
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "entries": self.entries,
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "waived": [dataclasses.asdict(f) for f in self.waived],
        }, indent=2)

"""Static analysis of the port's sparse-sparse paths (the counterpart of
the reference's ``repro.analysis``).

A linter that proves, from fake-tensor traces of the entry points and
from guarded launches of the kernels, that the complementary-sparsity
invariants hold: one Select per sparse layer (paper Fig. 8a), the k-sparse
support is consumed by the ``topk_gather`` kernel and never a dense
product, no float64 in the graph, every kernel launch fits the card, the
decode step brings nothing to the host, and every kernel stays inside its
operands and writes its outputs before it reads them.

Entry points:

* ``analysis.lint_fn(fn, *args)`` — lint any traceable callable.
* ``analysis.lint_config("smollm-360m")`` — lint a config's decode,
  paged decode, prefill and kernel entry points on fake tensors.
* ``analysis.lint_kernels()`` — the guarded kernel checks.
* ``python -m repro_torch.analysis --config smollm-360m`` — the CLI
  (``--device cpu`` runs on the CPU, with the kernels' plain versions).

Reference rules and theirs here: ``select-count``, ``dense-fallback`` and
``dtype-promotion`` keep their names; ``pallas-resource`` and
``scratch-overflow`` are ``launch-resource``; ``hlo-host-transfer`` and
``hlo-collective`` are ``host-transfer`` and ``collective`` over the
graph; ``oob-access`` (with ``unmasked-pad``) and ``grid-race`` are
guarded launches (:mod:`.kernel_checks`).
"""

from .findings import SEVERITIES, Finding, Report
from .graph_rules import rule_collectives, rule_host_transfer
from .graph_walk import iter_nodes, propagate_taint, trace
from .kernel_checks import Case, check_case
from .lint import (ENTRIES, PORTED_ENTRIES, expected_selects, family_path,
                   family_selects, kernel_cases, lint_config, lint_fn,
                   lint_kernel_pipeline, lint_kernels, seeded_regressions,
                   self_test)
from .rules import (SELECT_OPS, layer_key, rule_dense_fallback,
                    rule_dtype_promotion, rule_launch_resource,
                    rule_select_count, select_counts)

__all__ = [
    "Case", "ENTRIES", "Finding", "PORTED_ENTRIES", "Report", "SELECT_OPS",
    "SEVERITIES", "check_case", "expected_selects", "family_path",
    "family_selects", "iter_nodes", "kernel_cases", "layer_key",
    "lint_config", "lint_fn", "lint_kernel_pipeline", "lint_kernels",
    "propagate_taint", "rule_collectives", "rule_dense_fallback",
    "rule_dtype_promotion", "rule_host_transfer", "rule_launch_resource",
    "rule_select_count", "seeded_regressions", "select_counts",
    "self_test", "trace",
]

"""CLI: lint a config's entry points and the kernels for the sparsity
invariants (the reference's ``python -m repro.analysis``).

    python -m repro_torch.analysis --config smollm-360m
    python -m repro_torch.analysis --kernels
    python -m repro_torch.analysis --self-test
    python -m repro_torch.analysis --self-test --device cpu

``--kernels`` runs the guarded kernel checks (``oob-access``,
``grid-race``) and the launch-resource rule over the four shipped kernels
at the registry sweeps and the serving shapes; it composes with
``--config`` (both reports merge into one exit status).  ``--device``
defaults to ``cuda``, where the kernel checks launch the CUDA kernels and
the traces take fake CUDA tensors; ``--device cpu`` runs the plain
versions.  ``--device cuda`` without a card raises.

Exit codes: 0 clean (or all seeded regressions caught under
``--self-test``); 1 findings present (or a regression slipped through);
2 usage error.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Sparsity-invariant linter: prove the sparse-sparse "
                    "path stays sparse (one Select per layer, the kernel "
                    "consumes the support, no f64, launches fit the card, "
                    "decode stays on the device, kernels stay inside "
                    "their operands).")
    p.add_argument("--config", help="architecture config name "
                   "(e.g. smollm-360m); see repro_torch.configs.list_archs()")
    p.add_argument("--kernels", action="store_true",
                   help="run the guarded kernel checks (oob-access, "
                   "grid-race) and launch-resource over the shipped "
                   "kernels at the registry sweeps and serving shapes")
    p.add_argument("--entries", default="decode,decode_paged,prefill,kernel",
                   help="comma-separated entry points to lint (default: "
                   "every ported one; 'train' waits for the port's loss)")
    p.add_argument("--use-pallas", default="force",
                   choices=["auto", "force", "off", "config"],
                   help="override the config's executor mode while linting "
                   "('force' checks the kernel path; 'config' keeps the "
                   "config's own)")
    p.add_argument("--slots", type=int, default=4,
                   help="decode batch slots (default 4)")
    p.add_argument("--seq", type=int, default=8,
                   help="prefill sequence length (default 8)")
    p.add_argument("--reduced", action="store_true",
                   help="lint the reduced() smoke-test config instead of "
                   "the full-scale one")
    p.add_argument("--no-hlo", action="store_true",
                   help="skip the host-transfer and collective rules on the "
                   "decode steps (the reference's HLO rule pack)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the kernel checks launch and the fake "
                   "tensors live (default cuda; cpu runs the plain "
                   "versions)")
    p.add_argument("--waive", action="append", default=[],
                   metavar="RULE[:SCOPE]",
                   help="waive findings of RULE (optionally restricted "
                   "to a scope prefix); repeatable")
    p.add_argument("--json", action="store_true",
                   help="emit the report as JSON")
    p.add_argument("--fail-on-findings", action="store_true",
                   help="exit 1 when findings remain (default behavior; "
                   "kept explicit for CI readability)")
    p.add_argument("--self-test", action="store_true",
                   help="run the seeded regressions and exit 0 only if "
                   "the linter catches all of them")
    p.add_argument("--seed-regression", metavar="NAME",
                   choices=["double-topk", "f64-kernel", "oob-gather",
                            "missing-init"],
                   help="lint the named deliberately-broken pipeline and "
                   "exit by its findings (demonstrates the non-zero exit)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from repro_torch.analysis import (Report, lint_config, lint_kernels,
                                      seeded_regressions, self_test)
    from repro_torch.analysis.lint import linting_device
    if not (args.seed_regression or args.self_test or args.config
            or args.kernels):
        print("error: --config and/or --kernels is required "
              "(or use --self-test)", file=sys.stderr)
        return 2
    device = linting_device(args.device)

    if args.seed_regression:
        report = seeded_regressions()[args.seed_regression](device)
        print(report.to_json() if args.json else report.render())
        return 0 if report.ok else 1

    if args.self_test:
        failures = self_test(device)
        if failures:
            for f in failures:
                print(f, file=sys.stderr)
            return 1
        print("self-test: all seeded regressions caught")
        return 0

    report = Report()
    if args.kernels:
        report.extend(lint_kernels(device, waivers=tuple(args.waive)))
    if args.config:
        entries = tuple(e.strip() for e in args.entries.split(",")
                        if e.strip())
        mode = None if args.use_pallas == "config" else args.use_pallas
        report.extend(lint_config(
            args.config, entries=entries, use_pallas=mode, slots=args.slots,
            seq=args.seq, reduced=args.reduced, check_host=not args.no_hlo,
            device=device, waivers=tuple(args.waive)))
    print(report.to_json() if args.json else report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())

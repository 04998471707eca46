"""CLI: ``python -m sketches_tpu_torch.analysis`` -- run the port's
sketchlint, exit non-zero on violations (counterpart of
``python -m sketches_tpu.analysis``).

Default run (no arguments): AST lint + the kernel census over the
installed ``sketches_tpu_torch`` package, findings filtered through the
checked-in baseline (``analysis/baseline.json``), human-readable findings
on stdout, exit 1 if anything non-baselined remains.  The census needs
the CUDA toolkit and a card: without them it reports ``kernel-build``
and the run exits 1 (``--no-kernels`` runs the lint alone).

Useful flags::

    --no-kernels          AST layer only (the JAX CLI's --no-jaxpr)
    --json PATH           write the machine-readable report
    --root PATH           lint a different package tree (fixture tests)
    --rules a,b           run only the named rules
    --baseline PATH       override the suppression file
    --update-baseline     rewrite the baseline to suppress every current
                          finding (then justify or fix each entry!)
    --stats               per-rule finding counts + files scanned
    --budgets PATH        override the kernel budgets file
    --update-budgets      re-measure the census and rewrite the budgets
                          file (then justify the new pins in review!)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from sketches_tpu_torch.analysis import lint as lint_mod


def _default_root() -> str:
    """The installed sketches_tpu_torch package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sketches_tpu_torch.analysis",
        description="sketchlint: AST invariant lint + census of the built CUDA kernels",
    )
    parser.add_argument(
        "--root",
        default=None,
        help="package directory to lint (default: the installed"
        " sketches_tpu_torch); the kernel census only runs on the default root",
    )
    parser.add_argument(
        "--rules",
        default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--baseline",
        default=None,
        help="suppression file (default: <root>/analysis/baseline.json)",
    )
    parser.add_argument(
        "--update-baseline",
        action="store_true",
        help="rewrite the baseline to suppress every current finding",
    )
    parser.add_argument(
        "--no-kernels",
        action="store_true",
        help="skip the census of the built CUDA kernels",
    )
    parser.add_argument(
        "--json", dest="json_path", default=None,
        help="write the machine-readable JSON report here",
    )
    parser.add_argument(
        "--stats",
        action="store_true",
        help="print per-rule finding counts and the files-scanned total",
    )
    parser.add_argument(
        "--budgets",
        default=None,
        help="kernel budgets file (default: <root>/analysis/budgets.json;"
        " kernel layer only)",
    )
    parser.add_argument(
        "--update-budgets",
        action="store_true",
        help="re-measure the kernel census and rewrite the budgets file",
    )
    args = parser.parse_args(argv)

    root = os.path.abspath(args.root or _default_root())
    only = args.rules.split(",") if args.rules else None
    baseline_path = args.baseline or os.path.join(
        root, "analysis", "baseline.json"
    )

    findings = lint_mod.run_lint(root, only=only)

    report = {
        "root": root,
        "layers": {"lint": True, "kernel": False},
        "findings": [],
        "kernel": None,
    }
    # The census reads the libraries built from *this* package's csrc/,
    # so it only means something when the linted root IS that package.
    run_kernels = not args.no_kernels and root == _default_root()
    budgets_path = args.budgets or os.path.join(
        root, "analysis", "budgets.json"
    )
    if args.update_budgets:
        if not run_kernels:
            print(
                "error: --update-budgets needs the kernel layer (default"
                " root, no --no-kernels)",
                file=sys.stderr,
            )
            return 2
        from sketches_tpu_torch.analysis import kernel_audit
        from sketches_tpu_torch.resilience import EngineUnavailable

        try:
            doc = kernel_audit.measure_budgets()
        except EngineUnavailable as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        kernel_audit.write_budgets(budgets_path, doc)
        print(
            f"budgets: wrote {len(doc['entries'])} kernel entry pin(s),"
            f" {len(doc['smem_bytes'])} shared-memory pin(s) to {budgets_path}"
        )
        return 0
    if run_kernels:
        from sketches_tpu_torch.analysis import kernel_audit

        kernel_findings, kernel_report = kernel_audit.audit(
            budgets_path=budgets_path
        )
        findings.extend(kernel_findings)
        report["layers"]["kernel"] = True
        report["kernel"] = kernel_report

    if args.update_baseline:
        lint_mod.write_baseline(baseline_path, findings)
        print(
            f"baseline: wrote {len(findings)} suppression(s) to"
            f" {baseline_path}"
        )
        return 0

    baseline = lint_mod.load_baseline(baseline_path)
    active = lint_mod.apply_baseline(findings, baseline)
    suppressed = len(findings) - len(active)
    stale = sorted(
        set(baseline) - {f.fingerprint for f in findings}
    )

    report["findings"] = [f.to_dict() for f in findings]
    report["baseline"] = {
        "path": baseline_path,
        "suppressed": suppressed,
        "stale_fingerprints": stale,
    }
    if args.json_path:
        with open(args.json_path, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")

    for f in active:
        print(f)
    if args.stats:
        ctx_files = len(lint_mod.LintContext(root).files)
        print(f"stats: {ctx_files} file(s) scanned")
        if report["kernel"] is not None:
            print(f"stats: {len(report['kernel']['entries'])} kernel entries in the census")
        counts: dict = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        for rule_id in sorted(counts):
            print(f"stats: {rule_id}: {counts[rule_id]}")
        if not counts:
            print("stats: no findings")
    if stale:
        print(
            f"warning: {len(stale)} stale baseline entr"
            f"{'y' if len(stale) == 1 else 'ies'} (fixed findings --"
            " remove them): " + ", ".join(stale),
            file=sys.stderr,
        )
    n_rules_note = f" ({suppressed} baselined)" if suppressed else ""
    if active:
        first = active[0]
        print(
            f"sketchlint: {len(active)} violation(s){n_rules_note};"
            f" first offender: [{first.rule}] at {first.path}:{first.line}",
            file=sys.stderr,
        )
        return 1
    print(f"sketchlint: clean{n_rules_note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

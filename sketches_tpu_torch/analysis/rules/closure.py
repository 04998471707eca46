"""Rules ``site-detector`` / ``metric-doc`` / ``campaign-ci``: test-time
inventories become lint-time failures (counterpart of
``sketches_tpu/analysis/rules/closure.py``).

Three closure properties the repo already asserts *dynamically* --
``tests/test_torch_integrity.py``'s ``test_site_closure_is_complete``,
the telemetry README table, and the smoke's chaos campaigns -- are
promoted to ``python -m sketches_tpu_torch.analysis`` failures so a gap
fails the lint (seconds) instead of a card run (minutes), and fails it
even when the test suite is filtered:

* ``site-detector`` -- every ``faults.SITES`` member appears as a
  ``<module>.<CONST>`` key of ``tests/test_torch_integrity.py``'s
  ``DETECTORS`` table or as a member of its ``NO_SEAM`` set (a declared
  site with no seam in the port), and every key or member there is a
  declared site (a stale key is a detector probing nothing).  The JAX
  package reads ``_SITE_DETECTORS`` in ``tests/test_integrity.py``.
* ``metric-doc`` -- every ``Metric(...)`` declared in ``telemetry.py``
  has a README row.  README tokens are backticked; a ``{...}`` suffix
  is either a label set (``ingest_s{component,engine}`` -> strip) or a
  brace expansion (``ingest.variant.{stock,packed}`` -> one row per
  member), and both readings are accepted.
* ``campaign-ci`` -- every ``chaos --campaign`` choice is the first
  element of an entry of ``chip_smoke.py``'s ``CHAOS_CALLS``: the
  port's campaigns are gated on the card by the smoke, where the JAX
  package's run in CI workflows.  Every choice is named there, the
  argparse default too.

Failure modes: the aux inventories live *outside* the package, so a
scan of an installed package (no ``tests/``, no ``chip_smoke.py``)
reports the missing inventory as a finding rather than silently passing
-- suppress with the usual inline/baseline machinery if such a scan is
ever intended.  Fixture trees without ``faults.py`` / ``telemetry.py``
/ ``chaos.py`` skip the corresponding rule (nothing is declared).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Set

from sketches_tpu_torch.analysis.lint import Finding, LintContext, rule

_INTEGRITY_AUX = "tests/test_torch_integrity.py"
_SMOKE_AUX = "chip_smoke.py"
_BACKTICK = re.compile(r"`([^`\s][^`]*)`")
_EXPANSION = re.compile(r"^(.*)\{([^{}]+)\}(.*)$")


def _sites_decl(ctx: LintContext) -> Dict[str, int]:
    """``faults.SITES`` member constant names -> declaration line."""
    sf = ctx.file_in_package("faults.py")
    if sf is None or sf.tree is None:
        return {}
    for node in sf.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "SITES"
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            return {
                e.id: e.lineno
                for e in node.value.elts
                if isinstance(e, ast.Name)
            }
    return {}


def _aux_site_keys(tree: ast.AST) -> Dict[str, int]:
    """``<module>.<CONST>`` keys of the ``DETECTORS`` dict and members of
    the ``NO_SEAM`` set (``set()`` when empty) -> line number."""
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in ("DETECTORS", "NO_SEAM")
        ):
            continue
        if isinstance(node.value, ast.Dict):
            elts = node.value.keys
        elif isinstance(node.value, (ast.Set, ast.Tuple, ast.List)):
            elts = node.value.elts
        else:
            continue
        for key in elts:
            if isinstance(key, ast.Attribute) and isinstance(key.value, ast.Name):
                out[key.attr] = key.lineno
    return out


@rule("site-detector")
def check_site_detectors(ctx: LintContext) -> Iterable[Finding]:
    sites = _sites_decl(ctx)
    if not sites:
        return []
    faults_sf = ctx.file_in_package("faults.py")
    assert faults_sf is not None  # _sites_decl parsed it
    aux = ctx.aux_trees.get(_INTEGRITY_AUX)
    if aux is None or aux.tree is None:
        return [
            Finding(
                "site-detector",
                faults_sf.path,
                min(sites.values()),
                f"faults.SITES declares {len(sites)} fault sites but no"
                f" {_INTEGRITY_AUX} detector inventory was found next to"
                " the package",
            )
        ]
    detectors = _aux_site_keys(aux.tree)
    out: List[Finding] = []
    for name, lineno in sorted(sites.items()):
        if name not in detectors:
            out.append(
                Finding(
                    "site-detector",
                    faults_sf.path,
                    lineno,
                    f"fault site faults.{name} has no DETECTORS (or"
                    f" NO_SEAM) entry in {_INTEGRITY_AUX}; every site needs"
                    " a detector proving its fault is observable",
                )
            )
    for name, lineno in sorted(detectors.items()):
        if name not in sites:
            out.append(
                Finding(
                    "site-detector",
                    aux.path,
                    lineno,
                    f"DETECTORS / NO_SEAM key faults.{name} is not a"
                    " member of faults.SITES -- a detector probing an"
                    " undeclared site",
                )
            )
    return out


def _readme_metric_tokens(readme: str) -> Set[str]:
    """Every backticked README token, with ``{...}`` read both as a
    label suffix (stripped) and as a brace expansion (each member)."""
    out: Set[str] = set()
    for tok in _BACKTICK.findall(readme):
        tok = tok.strip()
        out.add(tok)
        m = _EXPANSION.match(tok)
        if m is None:
            continue
        head, members, tail = m.groups()
        out.add((head + tail).rstrip("."))
        out.add(head.rstrip(".{") + tail)
        for member in members.split(","):
            out.add(f"{head}{member.strip()}{tail}")
    return out


@rule("metric-doc")
def check_metric_docs(ctx: LintContext) -> Iterable[Finding]:
    from sketches_tpu_torch.analysis.rules.telemetry_names import _declared_metrics

    declared = _declared_metrics(ctx)
    if not declared:
        return []
    telemetry_sf = ctx.file_in_package("telemetry.py")
    assert telemetry_sf is not None  # _declared_metrics parsed it
    if ctx.readme is None:
        return [
            Finding(
                "metric-doc",
                telemetry_sf.path,
                min(declared.values()),
                f"telemetry.py declares {len(declared)} metrics but no"
                " README.md was found to document them",
            )
        ]
    documented = _readme_metric_tokens(ctx.readme)
    out: List[Finding] = []
    for name, lineno in sorted(declared.items()):
        if name not in documented:
            out.append(
                Finding(
                    "metric-doc",
                    telemetry_sf.path,
                    lineno,
                    f"declared metric {name!r} has no README row; an"
                    " operator cannot discover what the process measures",
                )
            )
    return out


def _campaign_choices(ctx: LintContext) -> Dict[str, int]:
    """``--campaign`` argparse choices (and the default) in ``chaos.py``
    -> line."""
    sf = ctx.file_in_package("chaos.py")
    if sf is None or sf.tree is None:
        return {}
    out: Dict[str, int] = {}
    for node in ast.walk(sf.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "--campaign"
        ):
            continue
        for kw in node.keywords:
            if kw.arg == "choices" and isinstance(
                kw.value, (ast.Tuple, ast.List)
            ):
                for e in kw.value.elts:
                    if isinstance(e, ast.Constant) and isinstance(
                        e.value, str
                    ):
                        out[e.value] = e.lineno
            if kw.arg == "default" and isinstance(kw.value, ast.Constant):
                if isinstance(kw.value.value, str):
                    out.setdefault(kw.value.value, node.lineno)
    return out


def _smoke_campaigns(tree: ast.AST) -> Set[str]:
    """First elements of ``CHAOS_CALLS``' entries in ``chip_smoke.py``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "CHAOS_CALLS"
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            continue
        for entry in node.value.elts:
            if (
                isinstance(entry, (ast.Tuple, ast.List))
                and entry.elts
                and isinstance(entry.elts[0], ast.Constant)
                and isinstance(entry.elts[0].value, str)
            ):
                out.add(entry.elts[0].value)
    return out


@rule("campaign-ci")
def check_campaign_ci(ctx: LintContext) -> Iterable[Finding]:
    names = _campaign_choices(ctx)
    if not names:
        return []
    chaos_sf = ctx.file_in_package("chaos.py")
    assert chaos_sf is not None  # _campaign_choices parsed it
    smoke = ctx.aux_trees.get(_SMOKE_AUX)
    if smoke is None or smoke.tree is None:
        return [
            Finding(
                "campaign-ci",
                chaos_sf.path,
                min(names.values()),
                f"chaos declares {len(names)} campaigns but no"
                f" {_SMOKE_AUX} was found next to the package",
            )
        ]
    run = _smoke_campaigns(smoke.tree)
    out: List[Finding] = []
    for name, lineno in sorted(names.items()):
        if name not in run:
            out.append(
                Finding(
                    "campaign-ci",
                    chaos_sf.path,
                    lineno,
                    f"chaos campaign {name!r} is never run by"
                    f" {_SMOKE_AUX} (no CHAOS_CALLS entry); an"
                    " unexercised campaign is dead coverage",
                )
            )
    return out

"""Rule ``telemetry-names``: metric names come from the declared inventory.

The telemetry layer's value is that an operator can enumerate what the
process measures; a stringly-typed metric name invented at a call site
(or fat-fingered once) silently forks that inventory.  Mirroring the
kill-switch registry rules:

* every ``telemetry.counter_inc/gauge_set/observe/finish_span/span/
  event(...)`` call in the package must pass a **string literal** first
  argument that matches a ``Metric(...)`` declared in ``telemetry.py``
  (a computed name cannot be checked and is flagged as such);
* ``telemetry.declare(...)`` is the *user-space* extension hook --
  library code calling it is drift by construction and is flagged.

``telemetry.py`` itself is exempt (it IS the inventory, and its API
implementation passes names through variables).  Fixture trees without
a ``telemetry.py`` simply have an empty inventory, so any telemetry
call there is flagged -- which is what the rule's own acceptance tests
exercise.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional

from sketches_tpu_torch.analysis.lint import Finding, LintContext, rule

_TELEMETRY_FILE = "telemetry.py"
_NAMED_APIS = (
    "counter_inc",
    "gauge_set",
    "observe",
    "finish_span",
    "span",
    "event",
)


def _declared_metrics(ctx: LintContext) -> Dict[str, int]:
    """Metric names declared via ``Metric(...)`` in ``telemetry.py`` ->
    line number (parsed, never imported)."""
    sf = ctx.file_in_package(_TELEMETRY_FILE)
    out: Dict[str, int] = {}
    if sf is None or sf.tree is None:
        return out
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else ""
        )
        if name != "Metric":
            continue
        metric: Optional[str] = None
        if node.args and isinstance(node.args[0], ast.Constant) and isinstance(
            node.args[0].value, str
        ):
            metric = node.args[0].value
        for kw in node.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                metric = kw.value.value
        if isinstance(metric, str):
            out[metric] = node.lineno
    return out


@rule("telemetry-names")
def check(ctx: LintContext) -> Iterable[Finding]:
    declared = _declared_metrics(ctx)
    out: List[Finding] = []
    for sf in ctx.iter_files(exclude_in_pkg=(_TELEMETRY_FILE,)):
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (
                isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "telemetry"
            ):
                continue
            if fn.attr == "declare":
                out.append(
                    Finding(
                        "telemetry-names",
                        sf.path,
                        node.lineno,
                        "telemetry.declare() in library code; library"
                        " metrics belong in the static inventory"
                        " (telemetry.METRICS), declare() is for user code",
                    )
                )
                continue
            if fn.attr not in _NAMED_APIS:
                continue
            first = node.args[0] if node.args else None
            if not (
                isinstance(first, ast.Constant)
                and isinstance(first.value, str)
            ):
                out.append(
                    Finding(
                        "telemetry-names",
                        sf.path,
                        node.lineno,
                        f"telemetry.{fn.attr}(...) metric name must be a"
                        " string literal from the declared inventory (a"
                        " computed name cannot be cross-checked)",
                    )
                )
                continue
            if first.value not in declared:
                out.append(
                    Finding(
                        "telemetry-names",
                        sf.path,
                        node.lineno,
                        f"telemetry metric {first.value!r} is not declared"
                        " in telemetry.py's Metric inventory -- stringly-"
                        "typed metric drift",
                    )
                )
    return out

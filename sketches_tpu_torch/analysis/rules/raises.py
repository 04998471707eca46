"""Rule ``taxonomy-raise``: every raise goes through the SketchError taxonomy.

The package roots its own failures in ``resilience.SketchError`` so
``except SketchError`` catches everything the package raises on its own
behalf, and so legacy ``except ValueError`` call sites keep working via
the taxonomy's dual bases.  A fresh ``raise ValueError(...)`` or
``raise RuntimeError(...)`` silently re-opens the hole: the failure
escapes the taxonomy, the health ledger, and the documented contract.

``resilience.py`` itself (the taxonomy's home) is exempt; so is the
analyzer subsystem (which sits below the package and may not import it).
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from sketches_tpu_torch.analysis.lint import Finding, LintContext, rule

#: The bare builtins the taxonomy replaces.  TypeError /
#: NotImplementedError stay allowed: they mark caller-side type bugs and
#: abstract methods, not library failure modes.
_BARE = ("ValueError", "RuntimeError")

_EXEMPT = ("resilience.py",)


@rule("taxonomy-raise")
def check(ctx: LintContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for sf in ctx.iter_files(exclude_in_pkg=_EXEMPT):
        if sf.tree is None or ctx.rel_in_package(sf.path).startswith("analysis/"):
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            target = node.exc
            if isinstance(target, ast.Call):
                target = target.func
            name = None
            if isinstance(target, ast.Name):
                name = target.id
            elif isinstance(target, ast.Attribute):
                name = target.attr
            if name in _BARE:
                out.append(
                    Finding(
                        "taxonomy-raise",
                        sf.path,
                        node.lineno,
                        f"bare `raise {name}` bypasses the SketchError"
                        " taxonomy; raise a resilience.* subclass"
                        " (SpecError/SketchValueError keep ValueError"
                        " compatibility)",
                    )
                )
    return out

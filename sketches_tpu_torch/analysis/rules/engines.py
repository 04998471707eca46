"""Rule ``engine-ladder``: the query-engine policy, ladder, and fault
dispatch cannot drift apart.

Three places must agree on the set of query engines:

1. ``kernels.choose_query_engine`` -- the ONE policy function both
   facades consult; the engines it can return are the string constants
   in its ``return`` statements.
2. ``resilience.QUERY_LADDER`` -- the degradation order.  Every
   returnable engine must be a rung, and every non-floor rung must be
   demotable by ``resilience.demote_query_tier`` (the ``tier == "..."``
   branches), or a lowering failure on that engine would re-raise
   instead of degrading.
3. The facades' fault dispatch -- ``batched.py`` and ``parallel.py``
   must each carry a ``faults.inject(faults.PALLAS_LOWERING, ...)``
   seam at query dispatch, or injected lowering faults cannot exercise
   the ladder at all.

All checks are AST-level (constants extracted, nothing imported), so a
rename in one place is caught even when the tree still imports cleanly.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

from sketches_tpu_torch.analysis.lint import Finding, LintContext, rule

_FACADES = ("batched.py", "parallel.py")


def _find_function(
    tree: ast.AST, name: str
) -> Optional[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _string_returns(fn: ast.FunctionDef) -> Set[Tuple[str, int]]:
    """String constants a function can return, including strings inside
    conditional expressions (``"a" if c else "b"``)."""
    out: Set[Tuple[str, int]] = set()

    def collect(expr: Optional[ast.AST], lineno: int) -> None:
        if expr is None:
            return
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            out.add((expr.value, lineno))
        elif isinstance(expr, ast.IfExp):
            collect(expr.body, lineno)
            collect(expr.orelse, lineno)

    for node in ast.walk(fn):
        if isinstance(node, ast.Return):
            collect(node.value, node.lineno)
    return out


def _tuple_assignment(tree: ast.AST, name: str) -> Set[str]:
    """String elements of a module-level ``NAME = ("a", "b", ...)``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            if name in targets and isinstance(
                node.value, (ast.Tuple, ast.List)
            ):
                return {
                    e.value
                    for e in node.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                }
    return set()


def _compared_tiers(fn: ast.FunctionDef) -> Set[str]:
    """String constants a function compares its ``tier`` argument against."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            for comp in node.comparators:
                if isinstance(comp, ast.Constant) and isinstance(
                    comp.value, str
                ):
                    out.add(comp.value)
    return out


def _has_lowering_dispatch(tree: ast.AST) -> bool:
    """Whether the module calls ``faults.inject(faults.PALLAS_LOWERING, ...)``."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (
            isinstance(fn, ast.Attribute)
            and fn.attr == "inject"
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "faults"
        ):
            continue
        for arg in node.args:
            if isinstance(arg, ast.Attribute) and arg.attr == "PALLAS_LOWERING":
                return True
    return False


@rule("engine-ladder")
def check(ctx: LintContext) -> Iterable[Finding]:
    out: List[Finding] = []
    kernels = ctx.file_in_package("kernels.py")
    resilience = ctx.file_in_package("resilience.py")
    if kernels is None or kernels.tree is None:
        return out
    chooser = _find_function(kernels.tree, "choose_query_engine")
    if chooser is None:
        out.append(
            Finding(
                "engine-ladder",
                kernels.path,
                1,
                "kernels.py no longer defines choose_query_engine; the"
                " engine-policy single source of truth is gone",
            )
        )
        return out
    returns = _string_returns(chooser)
    if not returns:
        out.append(
            Finding(
                "engine-ladder",
                kernels.path,
                chooser.lineno,
                "choose_query_engine returns no string engine constants;"
                " the ladder cross-check cannot see its policy",
            )
        )
        return out

    ladder: Set[str] = set()
    demotable: Set[str] = set()
    if resilience is not None and resilience.tree is not None:
        ladder = _tuple_assignment(resilience.tree, "QUERY_LADDER")
        demote = _find_function(resilience.tree, "demote_query_tier")
        if demote is not None:
            demotable = _compared_tiers(demote)

    floor = None
    if ladder:
        # The floor (last rung) re-raises instead of demoting, by design.
        # AST sets lose order, so recover it from the source tuple.
        for engine in ("xla",):
            if engine in ladder:
                floor = engine
    for engine, lineno in sorted(returns):
        if ladder and engine not in ladder:
            out.append(
                Finding(
                    "engine-ladder",
                    kernels.path,
                    lineno,
                    f"choose_query_engine can return {engine!r}, which is"
                    " not a rung of resilience.QUERY_LADDER",
                )
            )
        if demotable and engine not in demotable and engine != floor:
            out.append(
                Finding(
                    "engine-ladder",
                    kernels.path,
                    lineno,
                    f"choose_query_engine can return {engine!r}, which"
                    " resilience.demote_query_tier cannot demote -- a"
                    " lowering failure there would re-raise instead of"
                    " degrading",
                )
            )

    for facade in _FACADES:
        sf = ctx.file_in_package(facade)
        if sf is None or sf.tree is None:
            continue
        if not _has_lowering_dispatch(sf.tree):
            out.append(
                Finding(
                    "engine-ladder",
                    sf.path,
                    1,
                    f"{facade} has no faults.inject(faults.PALLAS_LOWERING,"
                    " ...) dispatch seam; injected lowering faults cannot"
                    " exercise its query ladder",
                )
            )
    return out

"""Rule ``failure-docstring``: public API documents its failure modes.

The README's failure-modes table promises that every failure path is a
*documented degradation*; this rule pushes the same discipline down to
the symbol level: every name exported through the package
``__init__.py``'s ``__all__`` must carry a docstring that says what
happens when things go wrong -- what it raises, what degrades, what an
empty/NaN result means.

"Mentions its failure modes" is checked as: the docstring of the object
(or, for classes, of the class or its ``__init__``) matches at least
one failure-vocabulary token (raise/error/fail/NaN/empty/invalid/
degrad.../quarantin.../collaps.../clamp/corrupt/unavailable/refus...).
Shallow by construction -- a lint can check vocabulary, not truth --
but it catches the common rot: a new public symbol landing with no
failure story at all.

Dunder exports (``__version__``) and module re-exports (``resilience``,
``faults``) are exempt: modules document themselves.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Tuple

from sketches_tpu_torch.analysis.lint import Finding, LintContext, rule

_FAILURE_VOCAB = re.compile(
    r"(?i)\b(rais\w*|error\w*|exception\w*|fail\w*|nan|empty|invalid|"
    r"unavailable|corrupt\w*|degrad\w*|quarantin\w*|collaps\w*|clamp\w*|"
    r"refus\w*|fallback|fall\s+back|retr(?:y|ies)|undefined|none)\b"
)


def _exported_names(init_tree: ast.AST) -> List[Tuple[str, int]]:
    for node in ast.walk(init_tree):
        if isinstance(node, ast.Assign):
            targets = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            if "__all__" in targets and isinstance(
                node.value, (ast.List, ast.Tuple)
            ):
                return [
                    (e.value, e.lineno)
                    for e in node.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                ]
    return []


def _top_level_defs(
    tree: ast.AST,
) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for node in ast.iter_child_nodes(tree):
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            out[node.name] = node
    return out


def _docstring_of(node: ast.AST) -> Optional[str]:
    doc = ast.get_docstring(node)
    if doc:
        return doc
    if isinstance(node, ast.ClassDef):
        for child in node.body:
            if isinstance(child, ast.FunctionDef) and child.name == "__init__":
                return ast.get_docstring(child)
    return None


@rule("failure-docstring")
def check(ctx: LintContext) -> Iterable[Finding]:
    init_sf = ctx.file_in_package("__init__.py")
    if init_sf is None or init_sf.tree is None:
        return []
    exported = _exported_names(init_sf.tree)
    if not exported:
        return []

    # Index every top-level def/class in the tree (the export may live in
    # any module; __init__ re-exports it).
    defs: Dict[str, Tuple[str, ast.AST]] = {}
    module_names: set = set()
    for sf in ctx.iter_files():
        if sf.tree is None:
            continue
        in_pkg = ctx.rel_in_package(sf.path)
        stem = in_pkg.rsplit("/", 1)[-1][: -len(".py")]
        module_names.add(stem if stem != "__init__" else in_pkg.split("/")[0])
        if "/" in in_pkg:
            module_names.add(in_pkg.split("/")[0])
        for name, node in _top_level_defs(sf.tree).items():
            defs.setdefault(name, (sf.path, node))

    out: List[Finding] = []
    for name, lineno in exported:
        if name.startswith("__") or name in module_names:
            continue
        hit = defs.get(name)
        if hit is None:
            # Aliased or dynamically-built exports can't be resolved
            # statically; absence from every module is its own problem
            # but not this rule's.
            continue
        path, node = hit
        doc = _docstring_of(node)
        if not doc:
            out.append(
                Finding(
                    "failure-docstring",
                    path,
                    node.lineno,
                    f"public export {name!r} has no docstring; document"
                    " what it raises / how it degrades",
                )
            )
        elif not _FAILURE_VOCAB.search(doc):
            out.append(
                Finding(
                    "failure-docstring",
                    path,
                    node.lineno,
                    f"public export {name!r} docstring never mentions a"
                    " failure mode (what it raises, what degrades, what an"
                    " empty/NaN result means)",
                )
            )
    return out

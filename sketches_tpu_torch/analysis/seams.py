"""sketchlint atomic-commit pass: torn-write seams commit by reference
swap.
(Counterpart of ``sketches_tpu/analysis/seams.py``, unchanged.)

Every method that passes a torn site (``faults.ATOMIC_SITES``:
``checkpoint.write``, ``reshard.torn``, ``window.rotate_torn``,
``window.stack_torn``, ``mesh.partition_heal``) promises the
**atomic-commit contract** the chaos campaigns probe dynamically: build
the new state functionally in locals, inject the fault *between* plan
and commit, then publish with a single reference swap -- so an
exception at the seam leaves the old state fully intact.  This pass
proves the contract structurally:

* ``seam-premutation`` -- a ``self`` mutation *before* the inject call:
  an attribute assign/augment/delete, a subscript store, or a mutator
  method (``append``/``update``/``pop``/...) on a ``self`` attribute,
  including through simple local aliases (``host = self._hosts[h]``
  followed by ``host.partitioned = True``).  Any of these means a fault
  at the seam tears the state.
* ``seam-commit`` -- the *first* ``self`` mutation after the inject is
  an in-place mutator call rather than a plain store: in-place
  publication mutates the observable object before the update is
  complete, so a concurrent reader (or a second fault) sees a torn
  commit.  Plain attribute or subscript stores are accepted -- each is
  one atomic slot write.
* ``seam-sites`` -- the declared inventory stays closed: every
  ``ATOMIC_SITES`` member is also in ``faults.SITES``, and every
  ``faults.inject(faults.X)`` call whose constant name contains
  ``TORN`` is declared atomic (an undeclared torn seam is exactly the
  unproven-contract bug).

Scope and accepted failure modes: only *methods* (first arg ``self``)
are analyzed -- module-level functions (``checkpoint.save_state``)
mutate locals and commit via ``os.replace`` by construction; alias
tracking follows pure attribute/subscript chains rooted at ``self``
(``x = self._hosts[h]``) but not call results (``meta = self._meta(n)``
is a fresh-object boundary the callee owns); mutations via a second
``self``-taking helper called pre-site are that helper's contract (it
either injects the site itself or holds no seam).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from sketches_tpu_torch.analysis.lint import Finding, LintContext, SourceFile, rule

__all__ = ["atomic_site_names", "analyze_method"]

_FAULTS_FILE = "faults.py"

#: In-place mutator method names that tear shared containers.
_MUTATORS = frozenset(
    """
    append extend insert remove pop popitem clear update setdefault
    add discard sort reverse
    """.split()
)


def _parse_faults(
    ctx: LintContext,
) -> Tuple[Dict[str, str], Set[str], Set[str]]:
    """Parse ``faults.py`` (never import): ``{const_name: site_string}``,
    the ``SITES`` member names, and the ``ATOMIC_SITES`` member names."""
    consts: Dict[str, str] = {}
    sites: Set[str] = set()
    atomic: Set[str] = set()
    sf = ctx.file_in_package(_FAULTS_FILE)
    if sf is None or sf.tree is None:
        return consts, sites, atomic
    for node in sf.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        if isinstance(node.value, ast.Constant) and isinstance(
            node.value.value, str
        ):
            consts[tgt.id] = node.value.value
        elif isinstance(node.value, (ast.Tuple, ast.List)):
            names = {
                e.id for e in node.value.elts if isinstance(e, ast.Name)
            }
            if tgt.id == "SITES":
                sites = names
            elif tgt.id == "ATOMIC_SITES":
                atomic = names
    return consts, sites, atomic


def atomic_site_names(ctx: LintContext) -> Set[str]:
    """The ``faults.<CONST>`` names declared torn-atomic (may be empty
    in fixture trees without a faults module)."""
    return _parse_faults(ctx)[2]


def _inject_site_const(node: ast.Call) -> Optional[str]:
    """``faults.inject(faults.X, ...)`` -> ``"X"`` (else None)."""
    fn = node.func
    if not (
        isinstance(fn, ast.Attribute)
        and fn.attr == "inject"
        and isinstance(fn.value, ast.Name)
        and fn.value.id == "faults"
    ):
        return None
    if not node.args:
        return None
    site = node.args[0]
    if (
        isinstance(site, ast.Attribute)
        and isinstance(site.value, ast.Name)
        and site.value.id == "faults"
    ):
        return site.attr
    return None


def _alias_root(node: ast.AST) -> Optional[str]:
    """For a pure Attribute/Subscript chain, the base name (``self`` or a
    local); any Call or other node in the chain -> None (fresh object)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


class _Mutation:
    __slots__ = ("lineno", "kind", "desc")

    def __init__(self, lineno: int, kind: str, desc: str):
        self.lineno = lineno
        self.kind = kind  # "store" (atomic slot write) | "mutate" (in-place)
        self.desc = desc


def _collect_mutations(fn: ast.AST, self_name: str = "self") -> List[_Mutation]:
    """Every self-state mutation in the method, aliases included."""
    aliases: Set[str] = {self_name}
    out: List[_Mutation] = []

    def is_self_rooted(node: ast.AST) -> bool:
        root = _alias_root(node)
        return root is not None and root in aliases

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            # Alias creation: local = pure chain rooted at self/alias.
            if (
                len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, (ast.Attribute, ast.Subscript))
                and is_self_rooted(node.value)
            ):
                aliases.add(node.targets[0].id)
                continue
            for tgt in node.targets:
                if isinstance(
                    tgt, (ast.Attribute, ast.Subscript)
                ) and is_self_rooted(tgt):
                    out.append(
                        _Mutation(
                            node.lineno, "store", ast.unparse(tgt)
                        )
                    )
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            tgt = node.target
            if isinstance(
                tgt, (ast.Attribute, ast.Subscript)
            ) and is_self_rooted(tgt):
                kind = "store" if isinstance(node, ast.AnnAssign) else "aug"
                out.append(_Mutation(node.lineno, kind, ast.unparse(tgt)))
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(
                    tgt, (ast.Attribute, ast.Subscript)
                ) and is_self_rooted(tgt):
                    out.append(
                        _Mutation(node.lineno, "mutate", ast.unparse(tgt))
                    )
        elif isinstance(node, ast.Call):
            fn_node = node.func
            if (
                isinstance(fn_node, ast.Attribute)
                and fn_node.attr in _MUTATORS
                and is_self_rooted(fn_node.value)
            ):
                out.append(
                    _Mutation(
                        node.lineno,
                        "mutate",
                        f"{ast.unparse(fn_node.value)}.{fn_node.attr}(...)",
                    )
                )
    return sorted(out, key=lambda m: m.lineno)


def analyze_method(
    sf: SourceFile,
    fn: ast.AST,
    qualname: str,
    atomic_consts: Set[str],
) -> List[Finding]:
    """Check one method against the atomic-commit contract."""
    inject_lines = [
        node.lineno
        for node in ast.walk(fn)
        if isinstance(node, ast.Call)
        and _inject_site_const(node) in atomic_consts
    ]
    if not inject_lines:
        return []
    seam = min(inject_lines)
    findings: List[Finding] = []
    mutations = _collect_mutations(fn)
    for m in mutations:
        if m.lineno < seam:
            findings.append(
                Finding(
                    "seam-premutation",
                    sf.path,
                    m.lineno,
                    f"{qualname}: mutates {m.desc} before the torn-site"
                    f" inject at line {seam}; the atomic-commit contract"
                    " requires a purely functional plan (locals only)"
                    " before the seam",
                )
            )
    post = [m for m in mutations if m.lineno > seam]
    if post and post[0].kind == "mutate":
        findings.append(
            Finding(
                "seam-commit",
                sf.path,
                post[0].lineno,
                f"{qualname}: first post-seam commit is an in-place"
                f" mutation of {post[0].desc}; commit with a single"
                " reference swap (plain store) so a reader never sees"
                " a half-applied update",
            )
        )
    return findings


def _iter_methods(tree: ast.AST) -> Iterable[Tuple[str, ast.AST]]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for item in node.body:
            if (
                isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                and item.args.args
                and item.args.args[0].arg == "self"
            ):
                yield f"{node.name}.{item.name}", item


@rule("seam-premutation")
def check_premutation(ctx: LintContext) -> Iterable[Finding]:
    atomic = atomic_site_names(ctx)
    if not atomic:
        return []
    out: List[Finding] = []
    for sf in ctx.iter_files():
        if sf.tree is None:
            continue
        for qualname, fn in _iter_methods(sf.tree):
            out.extend(
                f
                for f in analyze_method(sf, fn, qualname, atomic)
                if f.rule == "seam-premutation"
            )
    return out


@rule("seam-commit")
def check_commit(ctx: LintContext) -> Iterable[Finding]:
    atomic = atomic_site_names(ctx)
    if not atomic:
        return []
    out: List[Finding] = []
    for sf in ctx.iter_files():
        if sf.tree is None:
            continue
        for qualname, fn in _iter_methods(sf.tree):
            out.extend(
                f
                for f in analyze_method(sf, fn, qualname, atomic)
                if f.rule == "seam-commit"
            )
    return out


@rule("seam-sites")
def check_sites(ctx: LintContext) -> Iterable[Finding]:
    consts, sites, atomic = _parse_faults(ctx)
    sf = ctx.file_in_package(_FAULTS_FILE)
    if sf is None or not consts:
        return []
    out: List[Finding] = []
    for name in sorted(atomic - sites):
        out.append(
            Finding(
                "seam-sites",
                sf.path,
                1,
                f"ATOMIC_SITES member {name} is not in faults.SITES --"
                " an atomic seam the fault harness cannot arm",
            )
        )
    # Every *_TORN inject anywhere in the tree must be declared atomic.
    for src in ctx.iter_files():
        if src.tree is None:
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            const = _inject_site_const(node)
            if const is None or const in atomic:
                continue
            if "TORN" in const:
                out.append(
                    Finding(
                        "seam-sites",
                        src.path,
                        node.lineno,
                        f"faults.{const} is injected as a torn seam but is"
                        " not declared in faults.ATOMIC_SITES; declare it"
                        " so the atomic-commit contract is proven here",
                    )
                )
    return out

"""sketchlint lock-discipline pass: per-class data-race detection.
(Counterpart of ``sketches_tpu/analysis/concurrency.py``, unchanged.)

The serving tier (``serve.SketchServer``, ``fabric.ServeFabric``) keeps
its mutable state consistent with one instance ``threading.RLock``; the
convention is structural, not advisory: *every* access to an attribute
that is ever touched under ``with self._lock`` must itself hold the
lock, otherwise a reader can observe a torn multi-attribute update (the
exact bug class the chaos campaigns probe dynamically).  This pass
proves the convention at lint time, per class:

1. **Lock detection** -- an attribute assigned ``threading.Lock()`` /
   ``threading.RLock()`` anywhere in the class is a lock attribute; a
   class with none is skipped (single-threaded facades such as
   ``WindowedSketch`` are out of scope by construction).
2. **Locked-context closure** -- a statement is *locked* when it sits
   syntactically inside ``with self._lock:``, when its method's name
   ends in ``_locked`` (the caller-must-hold convention), or when
   *every* in-class call site of its method is itself locked (computed
   as a greatest fixpoint over the in-class call graph, so helper
   chains like ``flush -> _dispatch_group -> _fused_quantile`` are
   recognized without annotations).  ``__init__`` counts as a locked
   caller: construction happens-before publication.
3. **Guarded set** -- the attributes read or written at locked sites
   (lock attributes themselves excluded).  Attributes only ever touched
   outside the lock are deliberately unguarded (nothing to protect).
4. **Findings** -- ``lock-discipline``: a read/write of a guarded
   attribute at an unlocked site, or a call of a ``*_locked`` method
   from an unlocked site.  ``lock-escape``: a guarded attribute's
   *object* leaks out of the lock region -- ``return self._cache`` or
   storing ``self._cache`` onto a foreign object -- so the caller holds
   a reference the lock no longer covers; hand out a copy, a snapshot,
   or a facade instead.

Failure modes the pass accepts (documented, not bugs): accesses inside
``__init__`` never flag (pre-publication); nested functions inherit the
lock depth of their definition site (a closure stashed and called later
defeats this -- none exist in the tree, and one that appears should be
rewritten, not accommodated); attribute accesses through ``self``
only -- state reached via a second object is that object's contract.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from sketches_tpu_torch.analysis.lint import Finding, LintContext, SourceFile, rule

__all__ = ["analyze_class", "ClassReport"]

_LOCK_FACTORIES = ("Lock", "RLock")
_LOCKED_SUFFIX = "_locked"


def _is_lock_ctor(node: ast.AST) -> bool:
    """``threading.Lock()`` / ``threading.RLock()`` / bare ``RLock()``."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr in _LOCK_FACTORIES
    if isinstance(fn, ast.Name):
        return fn.id in _LOCK_FACTORIES
    return False


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``"X"`` (else None)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


@dataclasses.dataclass
class _Access:
    attr: str
    lineno: int
    locked: bool
    store: bool
    method: str


@dataclasses.dataclass
class _CallSite:
    callee: str
    lineno: int
    locked: bool
    caller: str


@dataclasses.dataclass
class _Escape:
    attr: str
    lineno: int
    how: str  # "returned" | "stored"
    method: str


class _MethodVisitor(ast.NodeVisitor):
    """Walk one method body tracking syntactic ``with self.<lock>:`` depth."""

    def __init__(self, method: str, lock_attrs: Set[str], attr_universe: Set[str]):
        self.method = method
        self.lock_attrs = lock_attrs
        self.attr_universe = attr_universe
        self.depth = 0
        self.accesses: List[_Access] = []
        self.calls: List[_CallSite] = []
        self.escapes: List[_Escape] = []

    # -- lock regions -------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        holds = any(
            _self_attr(item.context_expr) in self.lock_attrs
            for item in node.items
        )
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        if holds:
            self.depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if holds:
            self.depth -= 1

    # -- accesses and calls -------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None and attr in self.attr_universe:
            self.accesses.append(
                _Access(
                    attr,
                    node.lineno,
                    self.depth > 0,
                    isinstance(node.ctx, (ast.Store, ast.Del)),
                    self.method,
                )
            )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        callee = _self_attr(node.func)
        if callee is not None:
            self.calls.append(
                _CallSite(callee, node.lineno, self.depth > 0, self.method)
            )
        self.generic_visit(node)

    # -- escapes ------------------------------------------------------------
    def visit_Return(self, node: ast.Return) -> None:
        attr = _self_attr(node.value) if node.value is not None else None
        if attr is not None and attr in self.attr_universe:
            self.escapes.append(
                _Escape(attr, node.lineno, "returned", self.method)
            )
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        attr = _self_attr(node.value)
        if attr is not None and attr in self.attr_universe:
            for tgt in node.targets:
                # Storing the guarded object onto anything that is not a
                # plain local (an attribute/subscript of another object)
                # hands out an uncovered reference.
                base = tgt
                while isinstance(base, (ast.Attribute, ast.Subscript)):
                    base = base.value
                if isinstance(tgt, (ast.Attribute, ast.Subscript)) and not (
                    isinstance(base, ast.Name) and base.id == "self"
                ):
                    self.escapes.append(
                        _Escape(attr, node.lineno, "stored", self.method)
                    )
        self.generic_visit(node)


@dataclasses.dataclass
class ClassReport:
    """What the pass inferred for one lock-owning class (test surface)."""

    name: str
    lock_attrs: Set[str]
    guarded: Set[str]
    always_locked: Set[str]
    findings: List[Finding]


def _class_methods(
    cls: ast.ClassDef,
) -> List[Tuple[str, ast.AST]]:
    out: List[Tuple[str, ast.AST]] = []
    for node in cls.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        deco = {
            d.id if isinstance(d, ast.Name) else getattr(d, "attr", "")
            for d in node.decorator_list
        }
        if "staticmethod" in deco or "classmethod" in deco:
            continue
        if not node.args.args or node.args.args[0].arg != "self":
            continue
        out.append((node.name, node))
    return out


def analyze_class(
    sf: SourceFile, cls: ast.ClassDef
) -> Optional[ClassReport]:
    """Run the lock-discipline analysis on one class; None if lock-free."""
    methods = _class_methods(cls)

    # Pass 0: lock attributes and the stored-attribute universe.  Only
    # attributes *assigned* somewhere on self participate -- properties
    # and bound methods are computed names, not shared state.
    lock_attrs: Set[str] = set()
    attr_universe: Set[str] = set()
    for _, fn in methods:
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr is not None:
                        lock_attrs.add(attr)
            tgt_attr = None
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for tgt in targets:
                    tgt_attr = _self_attr(tgt)
                    if tgt_attr is not None:
                        attr_universe.add(tgt_attr)
    if not lock_attrs:
        return None
    attr_universe -= lock_attrs

    # Pass 1: per-method access/call/escape records with syntactic depth.
    visitors: Dict[str, _MethodVisitor] = {}
    for name, fn in methods:
        v = _MethodVisitor(name, lock_attrs, attr_universe)
        for stmt in fn.body:
            v.visit(stmt)
        visitors[name] = v

    # Pass 2: greatest-fixpoint always-locked set over the in-class call
    # graph.  Start optimistic (every convention-named or called method),
    # then evict any method with an unlocked call site.
    call_sites: Dict[str, List[_CallSite]] = {name: [] for name in visitors}
    for v in visitors.values():
        for c in v.calls:
            if c.callee in call_sites:
                call_sites[c.callee].append(c)
    always_locked: Set[str] = {
        name
        for name in visitors
        if name.endswith(_LOCKED_SUFFIX) or call_sites[name]
    }
    changed = True
    while changed:
        changed = False
        for name in sorted(always_locked):
            if name.endswith(_LOCKED_SUFFIX):
                continue
            ok = bool(call_sites[name]) and all(
                c.locked
                or c.caller == "__init__"
                or c.caller in always_locked
                for c in call_sites[name]
            )
            if not ok:
                always_locked.discard(name)
                changed = True

    def _site_locked(method: str, syntactic: bool) -> bool:
        return syntactic or method == "__init__" or method in always_locked

    # Pass 3: guarded set = attrs accessed at any locked site outside
    # __init__ (construction writes don't make an attribute shared).
    guarded: Set[str] = set()
    for v in visitors.values():
        if v.method == "__init__":
            continue
        for a in v.accesses:
            if _site_locked(a.method, a.locked):
                guarded.add(a.attr)

    # Pass 4: findings.
    findings: List[Finding] = []
    for v in visitors.values():
        if v.method == "__init__":
            continue
        for a in v.accesses:
            if a.attr in guarded and not _site_locked(a.method, a.locked):
                verb = "written" if a.store else "read"
                findings.append(
                    Finding(
                        "lock-discipline",
                        sf.path,
                        a.lineno,
                        f"{cls.name}.{a.method}: self.{a.attr} is lock-"
                        f"guarded (accessed under the instance lock"
                        f" elsewhere) but {verb} here without holding"
                        " it -- a torn read/write race",
                    )
                )
        for c in v.calls:
            if c.callee.endswith(_LOCKED_SUFFIX) and not _site_locked(
                c.caller, c.locked
            ):
                findings.append(
                    Finding(
                        "lock-discipline",
                        sf.path,
                        c.lineno,
                        f"{cls.name}.{c.caller}: calls {c.callee}() without"
                        " holding the instance lock its _locked suffix"
                        " requires",
                    )
                )
        for e in v.escapes:
            if e.attr in guarded:
                findings.append(
                    Finding(
                        "lock-escape",
                        sf.path,
                        e.lineno,
                        f"{cls.name}.{e.method}: guarded attribute"
                        f" self.{e.attr} {e.how} raw -- the reference"
                        " outlives the lock region; hand out a copy,"
                        " snapshot, or facade instead",
                    )
                )
    return ClassReport(cls.name, lock_attrs, guarded, always_locked, findings)


@rule("lock-discipline")
def check_lock_discipline(ctx: LintContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for sf in ctx.iter_files():
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                report = analyze_class(sf, node)
                if report is not None:
                    out.extend(
                        f for f in report.findings
                        if f.rule == "lock-discipline"
                    )
    return out


@rule("lock-escape")
def check_lock_escape(ctx: LintContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for sf in ctx.iter_files():
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                report = analyze_class(sf, node)
                if report is not None:
                    out.extend(
                        f for f in report.findings if f.rule == "lock-escape"
                    )
    return out

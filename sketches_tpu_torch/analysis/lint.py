"""sketchlint layer 1 for the PyTorch port: the AST rule engine
(counterpart of ``sketches_tpu/analysis/lint.py``).

A small, repo-specific static analyzer: rules (``analysis/rules/``)
encode the port's conventions -- the ``SketchError`` taxonomy, the
kill-switch registry, the engine fallback ladder, the f32 device tier,
deterministic hot paths, failure-mode docstrings, no host syncs in the
kernels' wrappers -- and this module gives them a shared scanning
context, inline suppression, and a baseline file so pre-existing
findings can be grandfathered while new ones fail the run.

Vocabulary (the JAX package's, unchanged):

* **Finding** -- one violation: rule id, file, line, message.  Its
  ``fingerprint`` is content-addressed (rule + path + message, not line
  numbers), so baselines survive unrelated edits.
* **Inline suppression** -- ``# sketchlint: ignore[rule-id]`` (or a bare
  ``# sketchlint: ignore``) on the flagged line or the line above.
  Use it for individually-justified exceptions; the comment doubles as
  the justification's anchor.
* **Baseline** -- a JSON file of fingerprints (plus required
  ``reason`` strings) that are reported but do not fail the run.  The
  intended steady state is an EMPTY baseline: fix findings instead of
  baselining them, and treat a non-empty baseline as debt.

The engine is pure stdlib (``ast``) and never imports the code under
analysis, so it scans fixture trees in tests as it scans the package.
Where a scan finds a syntax error it reports a finding and does not
raise.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence

__all__ = [
    "Finding",
    "SourceFile",
    "LintContext",
    "rule",
    "all_rules",
    "run_lint",
    "load_baseline",
    "apply_baseline",
    "write_baseline",
]

# The directive may sit anywhere inside a comment ("# why...  sketchlint:
# ignore[rule]"), so the justification and the suppression share a line.
_IGNORE_RE = re.compile(r"#.*\bsketchlint:\s*ignore(?:\[([a-z0-9_,\- ]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str  # posix-style path relative to the scanned root's parent
    line: int
    message: str
    layer: str = "lint"  # "lint" (AST) or "kernel" (the built kernels' census)

    @property
    def fingerprint(self) -> str:
        """Content-addressed id: stable across line-number drift."""
        digest = hashlib.sha256(
            f"{self.rule}|{self.path}|{self.message}".encode()
        ).hexdigest()
        return digest[:16]

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["fingerprint"] = self.fingerprint
        return out

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class SourceFile:
    """One parsed module: path, source text, AST, and per-line access."""

    def __init__(self, rel_path: str, text: str):
        self.path = rel_path
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(text, filename=rel_path)
        except SyntaxError as e:
            self.parse_error = e

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def is_suppressed(self, lineno: int, rule_id: str) -> bool:
        """``# sketchlint: ignore[...]`` on the line or the line above."""
        for ln in (lineno, lineno - 1):
            m = _IGNORE_RE.search(self.line_at(ln))
            if m:
                listed = m.group(1)
                if listed is None:
                    return True
                if rule_id in {s.strip() for s in listed.split(",")}:
                    return True
        return False


def _read(base: str, rel: str) -> Optional[SourceFile]:
    full = os.path.join(base, rel)
    if not os.path.exists(full):
        return None
    with open(full, "r", encoding="utf-8") as f:
        return SourceFile(rel, f.read())


class LintContext:
    """Everything a rule may inspect: the parsed tree plus repo documents.

    ``root`` is the *package* directory under analysis
    (``sketches_tpu_torch/`` in the live tree; a synthetic mini-package in
    fixture tests).  File paths in findings are relative to the root's
    parent so they read as repo-relative (``sketches_tpu_torch/native.py``).
    """

    #: Directory/file basenames never scanned.
    EXCLUDE_NAMES = frozenset({"__pycache__", "ddsketch_pb2.py"})

    #: Package-relative directories never scanned.  The port keeps its
    #: examples inside the package, the JAX package at the repo root,
    #: outside its scanned tree; skipping them keeps the two scans over
    #: the same kind of code (examples are user code: they declare their
    #: own metrics and read their own environment).
    EXCLUDE_IN_PKG = frozenset({"examples"})

    #: Inventories outside the package that the closure rules read: the
    #: port's fault-site detectors (``DETECTORS`` / ``NO_SEAM``, where the
    #: JAX package has ``tests/test_integrity.py``'s ``_SITE_DETECTORS``)
    #: and the smoke's chaos calls (``CHAOS_CALLS``: the port's campaigns
    #: are gated by ``chip_smoke.py`` on the card, not by a CI workflow).
    AUX_FILES = ("tests/test_torch_integrity.py", "chip_smoke.py")

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.package = os.path.basename(self.root)
        base = os.path.dirname(self.root)
        self.files: Dict[str, SourceFile] = {}
        for dirpath, dirnames, filenames in os.walk(self.root):
            top = dirpath == self.root
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in self.EXCLUDE_NAMES
                and not (top and d in self.EXCLUDE_IN_PKG)
            )
            for fn in sorted(filenames):
                if not fn.endswith(".py") or fn in self.EXCLUDE_NAMES:
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, base).replace(os.sep, "/")
                with open(full, "r", encoding="utf-8") as f:
                    self.files[rel] = SourceFile(rel, f.read())
        self.readme: Optional[str] = None
        for cand in (
            os.path.join(base, "README.md"),
            os.path.join(self.root, "README.md"),
        ):
            if os.path.exists(cand):
                with open(cand, "r", encoding="utf-8") as f:
                    self.readme = f.read()
                break
        # Absent in an installed-package scan: the closure rules then
        # report the missing inventory rather than silently passing.
        self.aux_trees: Dict[str, SourceFile] = {}
        for rel in self.AUX_FILES:
            sf = _read(base, rel)
            if sf is not None:
                self.aux_trees[rel] = sf

    # -- path helpers -------------------------------------------------------
    def rel_in_package(self, rel_path: str) -> str:
        """Path relative to the package root (``native.py``,
        ``analysis/registry.py``)."""
        prefix = self.package + "/"
        return rel_path[len(prefix):] if rel_path.startswith(prefix) else rel_path

    def file_in_package(self, in_pkg: str) -> Optional[SourceFile]:
        return self.files.get(f"{self.package}/{in_pkg}")

    def iter_files(
        self, exclude_in_pkg: Sequence[str] = ()
    ) -> Iterable[SourceFile]:
        for rel, sf in self.files.items():
            if self.rel_in_package(rel) in exclude_in_pkg:
                continue
            yield sf

    # -- registry declarations (parsed, never imported) ---------------------
    def declared_env_vars(self) -> Dict[str, int]:
        """``SKETCHES_TPU_*`` names declared in ``analysis/registry.py``
        -> line number, by parsing its ``EnvVar(name=...)`` calls."""
        sf = self.file_in_package("analysis/registry.py")
        out: Dict[str, int] = {}
        if sf is None or sf.tree is None:
            return out
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call) and _call_name(node) == "EnvVar"):
                continue
            name = None
            if node.args and isinstance(node.args[0], ast.Constant):
                name = node.args[0].value
            for kw in node.keywords:
                if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                    name = kw.value.value
            if isinstance(name, str):
                out[name] = node.lineno
        return out


def _call_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


# ---------------------------------------------------------------------------
# Rule registration
# ---------------------------------------------------------------------------

RuleFn = Callable[[LintContext], Iterable[Finding]]
_RULES: Dict[str, RuleFn] = {}


def rule(rule_id: str) -> Callable[[RuleFn], RuleFn]:
    """Register a rule function under ``rule_id`` (its inline-ignore tag).
    Raises ``KeyError`` on a duplicate id."""

    def deco(fn: RuleFn) -> RuleFn:
        if rule_id in _RULES:
            raise KeyError(f"duplicate rule id {rule_id!r}")
        _RULES[rule_id] = fn
        fn.rule_id = rule_id  # type: ignore[attr-defined]
        return fn

    return deco


def all_rules() -> Dict[str, RuleFn]:
    """Every registered rule, importing the rule modules on first use."""
    from sketches_tpu_torch.analysis import rules as _rules_pkg  # noqa: F401

    return dict(_RULES)


def run_lint(
    root: str, only: Optional[Sequence[str]] = None
) -> List[Finding]:
    """Run every (or ``only`` the named) rule over the package at ``root``.

    Returns findings sorted by (path, line, rule), inline suppressions
    already removed.  Unparseable files surface as ``syntax`` findings
    rather than crashing the run.
    """
    ctx = LintContext(root)
    findings: List[Finding] = []
    for sf in ctx.files.values():
        if sf.parse_error is not None:
            findings.append(
                Finding(
                    "syntax",
                    sf.path,
                    sf.parse_error.lineno or 1,
                    f"file does not parse: {sf.parse_error.msg}",
                )
            )
    for rule_id, fn in sorted(all_rules().items()):
        if only is not None and rule_id not in only:
            continue
        for f in fn(ctx):
            sf = ctx.files.get(f.path)
            if sf is not None and sf.is_suppressed(f.line, f.rule):
                continue
            findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


# ---------------------------------------------------------------------------
# Baseline (suppression) file
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> Dict[str, str]:
    """``{fingerprint: reason}`` from a baseline JSON file (empty if the
    file is absent; a malformed file raises ``json.JSONDecodeError``)."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out: Dict[str, str] = {}
    for entry in data.get("suppressions", []):
        out[entry["fingerprint"]] = entry.get("reason", "")
    return out


def apply_baseline(
    findings: Sequence[Finding], baseline: Dict[str, str]
) -> List[Finding]:
    """Findings NOT covered by the baseline (the ones that fail the run)."""
    return [f for f in findings if f.fingerprint not in baseline]


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    """Write every current finding as a suppression (``--update-baseline``).

    Each entry gets a placeholder reason naming the finding; a human is
    expected to either fix the finding or replace the placeholder with a
    real justification in review.
    """
    seen: Dict[str, dict] = {}
    for f in findings:
        seen.setdefault(
            f.fingerprint, {"fingerprint": f.fingerprint, "reason": str(f)}
        )
    payload = {"version": 1, "suppressions": sorted(
        seen.values(), key=lambda e: e["fingerprint"]
    )}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")

"""Rules ``env-read`` / ``env-literal`` / ``registry-doc``: the kill-switch
inventory stays closed.

UDDSketch (arXiv:2004.08604) shows how silently-drifting configuration
corrupts a sketch's guarantee; our process-level configuration surface
is the ``SKETCHES_TPU_*`` environment variables, and these rules keep
that surface enumerable:

* ``env-read`` -- ``os.environ`` / ``os.getenv`` may be touched ONLY by
  ``analysis/registry.py``.  Any other module must read its lever
  through ``registry.get``/``registry.enabled`` (which refuse
  undeclared names at runtime).
* ``env-literal`` -- a string literal that IS a ``SKETCHES_TPU_*`` name
  outside the registry must match a declared entry: a typo'd or
  undeclared switch is exactly the silent-drift bug.
* ``registry-doc`` -- the README kill-switch table and the registry
  agree in both directions (every declared variable is documented;
  every documented variable is declared).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List

from sketches_tpu_torch.analysis.lint import Finding, LintContext, rule

_ENV_NAME = re.compile(r"^SKETCHES_TPU_[A-Z0-9_]+$")
_README_TOKEN = re.compile(r"\bSKETCHES_TPU_[A-Z0-9_]+\b")

_REGISTRY_FILE = "analysis/registry.py"


def _is_environ_access(node: ast.AST) -> bool:
    """``os.environ`` (any use) or ``os.getenv``/``os.putenv`` call."""
    if isinstance(node, ast.Attribute) and node.attr in (
        "environ",
        "getenv",
        "putenv",
    ):
        base = node.value
        return isinstance(base, ast.Name) and base.id == "os"
    return False


@rule("env-read")
def check_reads(ctx: LintContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for sf in ctx.iter_files(exclude_in_pkg=(_REGISTRY_FILE,)):
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if _is_environ_access(node):
                out.append(
                    Finding(
                        "env-read",
                        sf.path,
                        node.lineno,
                        "environment access outside analysis/registry.py;"
                        " declare the variable there and read it via"
                        " registry.get/registry.enabled",
                    )
                )
    return out


@rule("env-literal")
def check_literals(ctx: LintContext) -> Iterable[Finding]:
    declared = set(ctx.declared_env_vars())
    out: List[Finding] = []
    for sf in ctx.iter_files(exclude_in_pkg=(_REGISTRY_FILE,)):
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _ENV_NAME.match(node.value)
            ):
                continue
            if node.value in declared:
                msg = (
                    f"raw {node.value!r} literal duplicates the registry;"
                    " reference registry.<VAR>.name (or the module's"
                    " re-exported *_ENV alias) instead"
                )
            else:
                msg = (
                    f"{node.value!r} is not declared in"
                    " analysis/registry.py -- an unregistered kill switch"
                )
            out.append(Finding("env-literal", sf.path, node.lineno, msg))
    return out


@rule("registry-doc")
def check_readme(ctx: LintContext) -> Iterable[Finding]:
    registry_sf = ctx.file_in_package(_REGISTRY_FILE)
    if registry_sf is None:
        return []  # fixture trees without a registry have nothing to check
    declared = ctx.declared_env_vars()
    out: List[Finding] = []
    if ctx.readme is None:
        if declared:
            out.append(
                Finding(
                    "registry-doc",
                    registry_sf.path,
                    min(declared.values()),
                    "registry declares kill switches but no README.md was"
                    " found to document them",
                )
            )
        return out
    documented = set(_README_TOKEN.findall(ctx.readme))
    for name, lineno in sorted(declared.items()):
        if name not in documented:
            out.append(
                Finding(
                    "registry-doc",
                    registry_sf.path,
                    lineno,
                    f"registered variable {name} is missing from the README"
                    " kill-switch table",
                )
            )
    for name in sorted(documented - set(declared)):
        out.append(
            Finding(
                "registry-doc",
                registry_sf.path,
                1,
                f"README documents {name} but analysis/registry.py does not"
                " declare it",
            )
        )
    return out

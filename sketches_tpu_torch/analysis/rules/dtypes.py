"""Rule ``torch-f64``: the device tier is f32; no float64 construction on
a tensor that stays on the device (counterpart of the JAX package's
``jnp-f64``, ``sketches_tpu/analysis/rules/dtypes.py``).

The JAX rule flags f64 construction on ``jnp`` paths, which matches
nothing in torch code, so the port retargets it.  The reason changes
too: Hopper runs f64 natively, but the port's kernels and their plain
versions answer bit for bit like the f32 JAX reference only while every
device value is f32, so an f64 tensor on the card is a parity hazard,
not a missing feature.  Flagged, in modules that import torch:

* ``.double()``;
* ``.to(torch.float64)`` / ``.to(torch.double)`` (positional or
  ``dtype=``);
* a ``dtype=torch.float64`` / ``dtype=torch.double`` keyword on any
  call (``torch.zeros(n, dtype=torch.float64, device=dev)``).

Allowed: an expression whose method chain ends in a host fetch
(``….double().cpu().numpy()``, ``….double().sum(0).cpu()``,
``(a.double() - b.double()).cpu()``): the f64
values are the host tier's, as numpy f64 is in the JAX rule; and reads
and comparisons (``t.dtype == torch.float64``): inspecting f64 is not
creating it.  A deliberate device f64 takes an inline suppression that
says why (the quadratic mapping's decode root, ``mapping.py``).  The
rule sees the source, not the device: a CPU tensor widened without a
fetch in the chain is flagged all the same; fetch first.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List

from sketches_tpu_torch.analysis.lint import Finding, LintContext, rule

#: Method calls that bring a tensor to the host (end the device chain).
HOST_FETCH = ("cpu", "numpy", "tolist", "item")


def _imports_torch(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "torch" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and (node.module or "").split(".")[0] == "torch":
                return True
    return False


def _is_f64(node: ast.AST) -> bool:
    """``torch.float64`` or ``torch.double``."""
    return (
        isinstance(node, ast.Attribute)
        and node.attr in ("float64", "double")
        and isinstance(node.value, ast.Name)
        and node.value.id == "torch"
    )


def _constructs_f64(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr == "double" and not node.args:
        return True
    if isinstance(fn, ast.Attribute) and fn.attr == "to":
        if any(_is_f64(a) for a in node.args):
            return True
    return any(kw.arg == "dtype" and _is_f64(kw.value) for kw in node.keywords)


def _ends_in_fetch(call: ast.Call, parents: Dict[int, ast.AST]) -> bool:
    """Whether the method chain that ``call`` starts ends in a host fetch."""
    cur: ast.AST = call
    while True:
        attr = parents.get(id(cur))
        if isinstance(attr, (ast.BinOp, ast.UnaryOp)):
            cur = attr  # arithmetic on the widened tensor: follow it
            continue
        if not (isinstance(attr, ast.Attribute) and attr.value is cur):
            return False
        outer = parents.get(id(attr))
        if not (isinstance(outer, ast.Call) and outer.func is attr):
            return False
        if attr.attr in HOST_FETCH:
            return True
        cur = outer


@rule("torch-f64")
def check(ctx: LintContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for sf in ctx.iter_files():
        if sf.tree is None or not _imports_torch(sf.tree):
            continue
        parents: Dict[int, ast.AST] = {}
        for node in ast.walk(sf.tree):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call) and _constructs_f64(node)):
                continue
            if _ends_in_fetch(node, parents):
                continue
            out.append(
                Finding(
                    "torch-f64",
                    sf.path,
                    node.lineno,
                    "float64 construction on a tensor that stays on the"
                    " device; the device tier is f32 (the kernels' parity"
                    " with the f32 reference depends on it): fetch to the"
                    " host first, or justify it inline",
                )
            )
    return out

"""Every Pallas kernel of the JAX package has its Hopper kernel in the port.

The JAX package's kernels are the functions that reach ``pl.pallas_call``.
This file finds them by parsing ``sketches_tpu/`` with ``ast`` (each call
of ``pallas_call`` and the public function of its module that reaches it),
and holds ``sketches_tpu_torch`` to four things for each one:

* ``sketches_tpu_torch/kernels.py`` defines a function of the same name;
* it defines the plain twin, ``<name>_plain``, that a CPU tensor runs;
* the wrapper launches a C entry point (``kernels._ENTRY_SOURCE``) whose
  CUDA source lies under ``sketches_tpu_torch/csrc/``;
* ``analysis/budgets.json`` pins at least one kernel entry of that source.

Both packages are read as source, not imported, so a dropped port kernel
fails here by name rather than as an import error elsewhere.  A new Pallas
site in the JAX package fails here until the port has its kernel.
"""

import ast
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "sketches_tpu"
PORT = ROOT / "sketches_tpu_torch"
PORT_KERNELS = PORT / "kernels.py"
BUDGETS = PORT / "analysis" / "budgets.json"


def _is_pallas_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr == "pallas_call") or (
        isinstance(f, ast.Name) and f.id == "pallas_call")


def _functions(tree: ast.Module) -> dict:
    return {n.name: n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _callees(fn: ast.AST, names) -> set:
    """The module-level functions ``fn`` names (calls or references)."""
    return {n.id for n in ast.walk(fn) if isinstance(n, ast.Name) and n.id in names}


def _reachers(funcs: dict, start: str) -> list:
    """The public module-level functions from which ``start`` is reached,
    ``start`` itself when it is public."""
    callers = {name: _callees(fn, funcs) - {name} for name, fn in funcs.items()}
    found, seen, todo = [], {start}, [start]
    while todo:
        name = todo.pop()
        if not name.startswith("_"):
            found.append(name)
            continue
        for caller, called in callers.items():
            if name in called and caller not in seen:
                seen.add(caller)
                todo.append(caller)
    return sorted(found)


def pallas_sites() -> list:
    """``(public function, "path:line" of its pallas_call)`` for every site
    in the JAX package, in file and line order."""
    sites = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
        funcs = _functions(tree)
        for name, fn in funcs.items():
            for call in (n for n in ast.walk(fn) if _is_pallas_call(n)):
                where = f"{path.relative_to(ROOT)}:{call.lineno}"
                reachers = _reachers(funcs, name)
                assert reachers, f"no public function reaches the pallas_call at {where}"
                sites.extend((public, where) for public in reachers)
    return sorted(set(sites), key=lambda s: (s[1].split(":")[0], int(s[1].split(":")[1]), s[0]))


SITES = pallas_sites()
_PORT_TREE = ast.parse(PORT_KERNELS.read_text(encoding="utf-8"))
_PORT_FUNCS = _functions(_PORT_TREE)


def _entry_sources() -> dict:
    """``kernels._ENTRY_SOURCE``: C entry point -> CUDA source file."""
    for node in _PORT_TREE.body:
        if (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_ENTRY_SOURCE" for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError("sketches_tpu_torch/kernels.py has no _ENTRY_SOURCE table")


def _sources_launched_by(name: str) -> set:
    """The CUDA sources of the entry points the port's ``name`` launches,
    through the module-level helpers it calls."""
    entries = _entry_sources()
    seen, todo, sources = {name}, [name], set()
    while todo:
        fn = _PORT_FUNCS[todo.pop()]
        for node in ast.walk(fn):
            if isinstance(node, ast.Constant) and node.value in entries:
                sources.add(entries[node.value])
        for callee in _callees(fn, _PORT_FUNCS) - seen:
            seen.add(callee)
            todo.append(callee)
    return sources


def _ids(sites):
    return [name for name, _ in sites]


def test_the_jax_package_has_pallas_sites_to_hold_the_port_to():
    # An empty list would pass every case below vacuously.
    assert SITES, "found no pallas_call in sketches_tpu/"
    assert all(where.startswith("sketches_tpu/") for _, where in SITES)


@pytest.mark.parametrize("name,where", SITES, ids=_ids(SITES))
def test_port_has_the_kernel_wrapper(name, where):
    assert name in _PORT_FUNCS, (
        f"sketches_tpu_torch/kernels.py has no {name}, the port of the Pallas kernel at {where}")


@pytest.mark.parametrize("name,where", SITES, ids=_ids(SITES))
def test_port_has_the_plain_twin(name, where):
    assert f"{name}_plain" in _PORT_FUNCS, (
        f"sketches_tpu_torch/kernels.py has no {name}_plain, the plain twin of {name} "
        f"(the Pallas kernel at {where})")


@pytest.mark.parametrize("name,where", SITES, ids=_ids(SITES))
def test_kernel_source_is_in_the_checkout(name, where):
    assert name in _PORT_FUNCS, f"sketches_tpu_torch/kernels.py has no {name} ({where})"
    sources = _sources_launched_by(name)
    assert len(sources) == 1, f"{name} ({where}) launches the CUDA sources {sorted(sources)}"
    (source,) = sources
    assert (PORT / "csrc" / source).is_file(), f"{name}: sketches_tpu_torch/csrc/{source} is missing"


@pytest.mark.parametrize("name,where", SITES, ids=_ids(SITES))
def test_budgets_pin_the_kernel_source(name, where):
    assert name in _PORT_FUNCS, f"sketches_tpu_torch/kernels.py has no {name} ({where})"
    entries = json.loads(BUDGETS.read_text(encoding="utf-8"))["entries"]
    for source in _sources_launched_by(name):
        pinned = [key for key in entries if key.split(":", 1)[0] == source]
        assert pinned, f"{name} ({where}): analysis/budgets.json pins no entry of {source}"

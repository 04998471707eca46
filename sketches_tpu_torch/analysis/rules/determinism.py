"""Rule ``determinism``: library code takes no wall-clock reads and no
unseeded global randomness.

The fault harness's replay guarantee ("a failing sequence replays
exactly" -- faults.py) and the benchmarks' comparability both die the
moment a hot path consults ``time.time`` or the global numpy RNG.
Flagged:

* ``time.time`` / ``time.time_ns`` / ``time.monotonic`` /
  ``time.perf_counter`` / ``datetime.now`` / ``datetime.utcnow``
  (``time.sleep`` is allowed: backoff delays affect *when*, not *what*);
* any ``np.random.*`` / ``numpy.random.*`` use except constructing an
  explicitly seeded generator (``default_rng(seed)`` /
  ``RandomState(seed)`` with at least one argument).

The one legitimate clock home is ``telemetry.py`` -- the telemetry
layer IS the package's clock boundary (``telemetry.clock`` /
``telemetry.wall_time``), so it carries an explicit rule carve-out
(:data:`_CLOCK_ALLOWED_FILES`) rather than inline suppressions: every
other module that needs a timestamp must route through telemetry, and a
clock read anywhere else stays a finding.  The RNG check applies
everywhere, carve-out included.  Tests and benches are out of scope
(the analyzer scans the package tree only).
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from sketches_tpu_torch.analysis.lint import Finding, LintContext, rule

_CLOCK_ATTRS = {
    "time": ("time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
             "perf_counter_ns"),
    "datetime": ("now", "utcnow", "today"),
}

_SEEDED_CTORS = ("default_rng", "RandomState", "Generator", "SeedSequence")

#: Package-relative files allowed to read wall clocks: the telemetry
#: module owns clock()/wall_time() and every instrumented seam calls
#: those instead of ``time`` -- confining the replay hazard to one file.
_CLOCK_ALLOWED_FILES = ("telemetry.py",)


def _attr_chain(node: ast.Attribute) -> List[str]:
    parts: List[str] = []
    cur: ast.AST = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    return parts[::-1]


@rule("determinism")
def check(ctx: LintContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for sf in ctx.iter_files():
        if sf.tree is None:
            continue
        clock_allowed = ctx.rel_in_package(sf.path) in _CLOCK_ALLOWED_FILES
        # Pre-pass: seeded-generator constructions are the sanctioned RNG
        # pattern.  Their func nodes are exempted by identity below.
        seeded_funcs: set = set()
        for node in ast.walk(sf.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _SEEDED_CTORS
                and (node.args or node.keywords)
            ):
                for sub in ast.walk(node.func):
                    seeded_funcs.add(id(sub))
        consumed = set()  # sub-attributes of already-flagged chains
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Attribute) or id(node) in seeded_funcs:
                continue
            if id(node) in consumed:
                continue
            chain = _attr_chain(node)
            if len(chain) < 2:
                continue
            root, rest = chain[0], chain[1:]
            if root in _CLOCK_ATTRS and rest[-1] in _CLOCK_ATTRS[root]:
                if clock_allowed:
                    continue
                out.append(
                    Finding(
                        "determinism",
                        sf.path,
                        node.lineno,
                        f"wall-clock read {'.'.join(chain)} in library code;"
                        " route timestamps through sketches_tpu_torch.telemetry"
                        " (the carved-out clock boundary)",
                    )
                )
            elif root in ("np", "numpy") and rest[0] == "random":
                for sub in ast.walk(node):
                    if sub is not node:
                        consumed.add(id(sub))
                out.append(
                    Finding(
                        "determinism",
                        sf.path,
                        node.lineno,
                        f"global-RNG use {'.'.join(chain)} in library code;"
                        " construct an explicitly seeded"
                        " np.random.default_rng(seed) instead",
                    )
                )
    return out

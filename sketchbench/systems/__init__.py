"""The systems a configuration file names (``"system"``; ``batched`` when
it names none), one module each.  Only these modules import the program.

A system module has:

* ``Program(config, n_streams, device)``: the system under test, with
  ``add(values, weights)``, ``query(qs) -> (tier, answers [n, Q])``,
  ``state()``, ``leaves(rows) -> {leaf: tensor}``, ``counters() ->
  {name: launches}``, ``describe() -> dict`` and ``close()``: what the
  loops and ``cell.py`` call;
* ``facts(sut, inputs, config, qs) -> dict``: what the per-layer readers
  take from ``ctx.facts`` (byte counts of the kernels, from
  ``yardstick/``), read once the traced calls have ended;
* ``judge(config, inputs, rows, prog, n_adds, limits, qs, kept) -> dict``:
  whether the run is correct, against the system's plain reference under
  ``reference/``, with the shape of ``check.judge``'s result.
"""

from __future__ import annotations

import importlib


def system(name: str):
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad system {name!r}")
    return importlib.import_module(f"sketchbench.systems.{name}")

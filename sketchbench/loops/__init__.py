"""The loops a traffic file names (``"loop"``), one module each.

A loop module has ``warm(sut, inputs, traffic)``, which makes the first
add (the facade recentres on it) and two more steps and returns the adds
made, and ``window(sut, inputs, traffic, seconds, tracer, rows, start)``,
which runs the measured window and returns its end-to-end metrics, the
host times of its untraced calls, its adds and the answers it kept.
"""

from __future__ import annotations

import importlib
import math
import time

import torch

clock = time.perf_counter


def loop(name: str):
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad loop {name!r}")
    return importlib.import_module(f"sketchbench.loops.{name}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile of every sample (no interpolation)."""
    s = sorted(xs)
    return s[max(0, math.ceil(p / 100.0 * len(s)) - 1)]

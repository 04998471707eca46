"""The traced run: ``torch.profiler`` over the first steps of the window,
with ranges the harness places around each call (``sketchbench.add``,
``sketchbench.ack``, ``sketchbench.query``, ``sketchbench.sync``) inside one range over the
traced segment (``sketchbench.traced``), and the reduction of that trace
to what the per-layer readers read (:class:`Context`).

Each device operation (kernel, copy, fill) is attributed to the harness
range whose span holds the host call that launched it (the profiler's
correlation of launch and operation).  The device is busy where some
operation runs; an idle gap is named by what the host was doing when it
began: the harness range and the innermost host event open then.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import tempfile
from typing import Dict, List, Optional

import torch

PREFIX = "sketchbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")
HARNESS = ("add", "ack", "query", "sync")


class Tracer:
    """Profiles the first ``steps`` calls of a window (none when 0)."""

    def __init__(self, steps: int, device, on_stop=None):
        self.steps = steps
        self.device = torch.device(device)
        self.on_stop = on_stop
        self.active = False
        self.prof = None
        self.facts: dict = {}
        self._segment = None

    def start(self) -> None:
        if not self.steps or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._segment = record_function(PREFIX + "traced")
        self._segment.__enter__()
        self.active = True

    def range(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(PREFIX + name)

    def stop(self) -> None:
        """End the traced segment once the device has finished its work."""
        with self.range("sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._segment.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.active = False
        if self.on_stop is not None:
            self.facts = self.on_stop()

    def export(self) -> Optional[str]:
        """Write the trace to a temporary file; returns its path."""
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(prefix="sketchbench-", suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(path)
        self.prof = None
        return path


def short_name(name: str) -> str:
    """A device operation's name without namespaces noise and arguments."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void ", "", s)
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            s = s[:i]
            break
    return s[:100]


@dataclasses.dataclass
class Op:
    name: str
    start: float  # seconds
    dur: float
    owner: Optional[str]  # "add", "query", "sync" or None


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads (``metrics/<name>.py``)."""

    cell: str
    loop: str
    device_name: str
    mem_rate: float
    ops: List[Op]
    calls: Dict[str, int]  # traced harness ranges by name
    window_s: float
    busy_s: float
    idle: Dict[str, float]  # idle seconds by what the host was doing
    host: Dict[str, List[float]]  # host seconds of untraced calls
    facts: dict  # byte counts and the route, from the harness

    def device_s(self, owner: Optional[str] = None, only: str = "", skip: str = "") -> float:
        """Device seconds of the operations launched in ``owner`` ranges,
        whose names contain ``only`` and not ``skip`` (when given)."""
        return sum(
            o.dur for o in self.ops
            if (owner is None or o.owner == owner)
            and (not only or only in o.name)
            and not (skip and skip in o.name)
        )


def _holding(intervals, t):
    """Name of the ``(start, end, name)`` interval holding ``t``, in a list
    sorted by start whose intervals do not overlap."""
    i = bisect.bisect_right(intervals, (t, float("inf"), "")) - 1
    if i >= 0 and intervals[i][0] <= t <= intervals[i][1]:
        return intervals[i][2]
    return None


def _innermost_at(intervals, points):
    """For each of the sorted ``points``, the name of the innermost of the
    nested ``(start, end, name)`` intervals (sorted by start) open then."""
    out, stack, j = [], [], 0
    for t in points:
        while j < len(intervals) and intervals[j][0] <= t:
            while stack and stack[-1][1] < intervals[j][0]:
                stack.pop()
            stack.append(intervals[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce(path: str, cell: str, loop: str, device_name: str, mem_rate: float,
           host: Dict[str, List[float]], facts: dict) -> Context:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith(PREFIX)]
    segment = next(e for e in ranges if e["name"] == PREFIX + "traced")
    tid = segment.get("tid")
    t0, t1 = segment["ts"], segment["ts"] + segment["dur"]
    harness = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
                     for e in ranges if e["name"][len(PREFIX):] in HARNESS)
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ops = []
    spans = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        s, d = e["ts"], e["dur"]
        if s + d < t0 or s > t1:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        owner = None if launch is None else _holding(harness, launch)
        ops.append(Op(e["name"], s * 1e-6, d * 1e-6, owner))
        spans.append((max(s, t0), min(s + d, t1)))
    spans.sort()
    busy, gaps, cursor = 0.0, [], t0
    for s, e in spans:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < t1:
        gaps.append((cursor, t1))
    host_events = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                         if e.get("cat") in HOST_CATS and e.get("tid") == tid
                         and not str(e.get("name", "")).startswith(PREFIX))
    idle: Dict[str, float] = {}
    for (s, e), what in zip(gaps, _innermost_at(host_events, [g[0] for g in gaps])):
        label = f"{_holding(harness, s) or 'between'}:{what or 'python'}"
        idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
    calls = {}
    for _, _, name in harness:
        calls[name] = calls.get(name, 0) + 1
    return Context(cell, loop, device_name, mem_rate, ops, calls, (t1 - t0) * 1e-6,
                   busy * 1e-6, idle, host, facts)


def breakdown(ctx: Context) -> dict:
    """The ten device operations that took most time and the ten largest
    idle totals by what the host was doing, in seconds."""
    by_op: Dict[str, float] = {}
    for o in ctx.ops:
        k = short_name(o.name)
        by_op[k] = by_op.get(k, 0.0) + o.dur
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(ctx.idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}

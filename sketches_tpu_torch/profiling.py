"""Device-time attribution of the PyTorch port: where the card's time goes
(counterpart of ``sketches_tpu.profiling``).

The telemetry layer host-times every dispatch -- but a CUDA launch
returns before the card finishes, so host spans measure *submission*,
not *execution*.  This layer wraps the engine dispatch seams in
**device-clocked** timers: when armed, each instrumented dispatch waits
for its output (``torch.cuda.synchronize`` on every CUDA device the
output lives on) and the host clock from the dispatch's start to after
the synchronize -- submission plus execution, the JAX package's
measurement -- is attributed per **engine tier** (``kernel`` / ``plain``
/ ``recenter`` / ``shards`` ingest; ``overlap`` / ``tiles`` / ``windowed``
/ ``wxla`` / ``xla`` query; ``merge`` / ``psum`` fold; the wire codec's
``encode`` / ``decode``) and per **phase** (ingest / fold / query /
decode).  Three surfaces:

* :func:`attribution` -- the measured table (calls, total/mean/min/max
  seconds per ``phase/tier``) joined against a **roofline estimate** per
  engine entry point at the JAX package's audited shapes (128 streams,
  256 bins, 128 values, 4 quantiles): ``bytes`` is the entry's top-level
  inputs plus outputs, taken from the port's tensors; ``flops`` is the
  count written beside each entry in :func:`_entry_points`; the
  light-speed time is ``max(bytes / peak bandwidth, flops / peak rate)``
  and ``x_roofline`` is how far each measured mean sits above it.
* ``telemetry.snapshot()["profiling"]`` -- the same table rides every
  armed snapshot (and survives ``telemetry.merge_snapshots``; fleet-wide
  device-time percentiles come from the ``profiling.device_s`` histogram
  this layer feeds).
* ``telemetry.chrome_trace()`` -- armed dispatches append ``X`` events on
  the device track (``telemetry.CHROME_PID_DEVICE``, one thread per
  engine tier).

Arming: OFF by default.  ``SKETCHES_TPU_PROFILING=1`` (declared in
``analysis/registry.py``) arms at process start; :func:`enable` /
:func:`disable` arm programmatically.  Every seam guards on
``profiling._ACTIVE``, so the disarmed layer costs one attribute read +
bool test per dispatch -- no clock read, no allocation, and **no
synchronize** (waiting is the measurement when armed, and the hazard
when not).

Failure modes: a synchronize that raises is a kernel fault on the card
and propagates (the JAX package swallows a failed wait; the port does
not hide one).  The roofline table is built on the CPU at the audited
shapes and an entry that fails carries an ``"error"`` row instead of
raising.  The event ring is bounded (65k) and drops with a count.  The
roofline is drawn against the card's published peaks, so at the audited
shapes ``x_roofline`` of a full-size dispatch also carries the size
ratio: compare rows with each other, not with 1.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from sketches_tpu_torch import telemetry
from sketches_tpu_torch.analysis import registry

__all__ = [
    "PROFILING_ENV",
    "PEAK_FLOPS_PER_S",
    "PEAK_HBM_BYTES_PER_S",
    "enable",
    "disable",
    "enabled",
    "reset",
    "record",
    "attribution",
    "roofline",
    "chrome_events",
]

#: Declared in ``analysis/registry.py`` (the kill-switch inventory).
PROFILING_ENV = registry.PROFILING.name

#: Peak arithmetic rate the roofline is drawn against: NVIDIA H100 SXM
#: 80GB HBM3 at its 700 W limit, float32 outside the tensor cores (the
#: arithmetic every engine of the port does).  A card set below 700 W
#: runs slower under load; ``x_roofline`` is against this ceiling.
PEAK_FLOPS_PER_S = 67e12

#: Peak HBM bandwidth the roofline is drawn against (the same card).
PEAK_HBM_BYTES_PER_S = 3.35e12

#: Operation counts behind each entry's ``flops`` (f32 operations counted
#: from the code each entry runs; the counts ``chip_smoke.py``'s bounds
#: use): an ingest does about 40 per value (split, key, clamp, masks,
#: accumulators) and one per bin it writes; a query about (1 + Q) per bin
#: it scans (scan step and threshold compares) and 60 per answer (decode).
INGEST_OPS_PER_VALUE = 40
QUERY_DECODE_OPS = 60

#: Fast-path guard: instrumented seams check this module flag before
#: doing any profiling work (one bool test per dispatch disarmed).
_ACTIVE = registry.enabled(registry.PROFILING)

_MAX_EVENTS = 65536

_lock = threading.Lock()
_stats: Dict[Tuple[str, str], Dict[str, float]] = {}
_events: List[dict] = []
_events_dropped = 0
_tier_tids: Dict[str, int] = {}
_roofline_cache: Optional[Dict[str, dict]] = None

#: Which entry point (:func:`_entry_points`) each measured ``(phase,
#: tier)`` pair dispatches into -- the join key between the measured
#: table and the roofline table.  The query tiers keep the JAX names;
#: ingest runs ``kernel`` (K1 and the fold), ``plain`` or ``recenter``
#: (the plain scatter add), or ``shards`` (``DistributedDDSketch.add``:
#: one ingest a value shard, the kernel where the shard qualifies).
_TIER_ENTRY: Dict[Tuple[str, str], str] = {
    ("query", "overlap"): "kernels.fused_quantile_tiles_overlap",
    ("query", "tiles"): "kernels.fused_quantile_tiles",
    ("query", "windowed"): "kernels.fused_quantile_windowed",
    ("query", "wxla"): "kernels.quantile_windowed_xla",
    ("query", "xla"): "batched.quantile",
    ("ingest", "kernel"): "kernels.ingest_histogram",
    ("ingest", "plain"): "batched.add",
    ("ingest", "recenter"): "batched.add",
    ("ingest", "shards"): "batched.add",
    ("fold", "merge"): "batched.merge",
    ("fold", "psum"): "batched.merge",
}


def enable(on: bool = True) -> None:
    """Arm (or, with ``on=False``, disarm) device-time attribution.

    Never raises; recorded attribution is kept (:func:`reset` clears).
    Arming makes every instrumented dispatch wait for the card -- that
    synchronize is the measurement, and the reason the layer is off by
    default.
    """
    global _ACTIVE
    _ACTIVE = bool(on)


def disable() -> None:
    """Disarm the profiling layer (seams go back to one bool test per
    dispatch, no synchronize; recorded state is kept)."""
    enable(False)


def enabled() -> bool:
    """Whether the layer is armed (env switch or :func:`enable`); False
    -- the default -- means no seam waits or records anything."""
    return _ACTIVE


def reset() -> None:
    """Clear the measured table and the device-track event ring (test
    isolation hook; the roofline cache is kept -- it is static per
    build).  Never raises."""
    global _events_dropped
    with _lock:
        _stats.clear()
        _events.clear()
        _tier_tids.clear()
        _events_dropped = 0


def _cuda_devices(obj: Any, out: set) -> set:
    """The CUDA devices any tensor in ``obj`` (a tensor, a state
    dataclass, or a list/tuple/dict of them) lives on."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), out)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _cuda_devices(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _cuda_devices(x, out)
    return out


def record(phase: str, tier: str, t0: float, sync: Any = None) -> float:
    """Close a device-clocked dispatch opened at ``t0 = telemetry.clock()``.

    Waits for ``sync`` (the dispatch's output: a tensor, a state, or a
    list of them; ``None`` for host-side phases like the wire codec) with
    ``torch.cuda.synchronize`` on each CUDA device it lives on -- CPU
    tensors need no wait -- then attributes the host-clock seconds from
    ``t0`` to after the wait to ``(phase, tier)``, feeds the mergeable
    ``profiling.device_s`` telemetry histogram, and appends one
    device-track trace event.  The seam idiom::

        _p0 = telemetry.clock() if profiling._ACTIVE else None
        out = fn(...)
        if _p0 is not None:
            profiling.record("query", tier, _p0, out)

    Returns the measured seconds; while disarmed it records nothing and
    returns 0.0.  A synchronize that raises (a kernel fault) propagates.
    """
    global _events_dropped
    if not _ACTIVE:
        return 0.0
    if sync is not None:
        for dev in _cuda_devices(sync, set()):
            torch.cuda.synchronize(dev)
    now = telemetry.clock()
    dur = max(now - t0, 0.0)
    key = (phase, tier)
    with _lock:
        st = _stats.get(key)
        if st is None:
            st = _stats[key] = {
                "calls": 0.0, "total_s": 0.0,
                "min_s": math.inf, "max_s": -math.inf,
            }
        st["calls"] += 1.0
        st["total_s"] += dur
        if dur < st["min_s"]:
            st["min_s"] = dur
        if dur > st["max_s"]:
            st["max_s"] = dur
        tid = _tier_tids.get(tier)
        if tid is None:
            tid = _tier_tids[tier] = len(_tier_tids) + 1
        if len(_events) < _MAX_EVENTS:
            _events.append(
                {
                    "name": f"{phase}/{tier}",
                    "cat": "sketches_tpu.device",
                    "ph": "X",
                    "ts": telemetry._ts_us(t0),
                    "dur": dur * 1e6,
                    "pid": telemetry.CHROME_PID_DEVICE,
                    "tid": tid,
                    "args": {"phase": phase, "tier": tier},
                }
            )
        else:
            _events_dropped += 1
    telemetry.observe("profiling.device_s", dur, phase=phase, tier=tier)
    return dur


def chrome_events() -> List[dict]:
    """The device-track Chrome-trace events (pid 2 metadata + ``X``
    events), ready to splice into ``telemetry.chrome_trace()``.  An empty
    list (bar the process metadata) is the idle steady state."""
    with _lock:
        events = list(_events)
        tids = dict(_tier_tids)
    meta: List[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": telemetry.CHROME_PID_DEVICE,
            "args": {"name": "sketches_tpu device (profiling)"},
        }
    ]
    for tier, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": telemetry.CHROME_PID_DEVICE,
                "tid": tid,
                "args": {"name": f"tier-{tier}"},
            }
        )
    return meta + events


# ---------------------------------------------------------------------------
# Roofline estimation at the audited shapes
# ---------------------------------------------------------------------------


def _entry_points() -> List[Tuple[str, Any, tuple, float]]:
    """``(name, fn, args, flops)`` for every engine a facade dispatches to,
    at the JAX package's audited shapes: 128 streams, 256 bins (2 tiles),
    128 values a stream, Q = 4; CPU tensors (the plain versions run)."""
    from sketches_tpu_torch import batched, kernels

    n, b, s = 128, 256, 128
    spec = batched.SketchSpec(n_bins=b)
    state = batched.init(spec, n, "cpu")
    values = torch.zeros((n, s), dtype=torch.float32)
    weights = torch.ones((n, s), dtype=torch.float32)
    qs = torch.tensor([0.5, 0.9, 0.99, 0.999], dtype=torch.float32)
    q = int(qs.numel())
    ingest = float(INGEST_OPS_PER_VALUE * n * s + 2 * n * b)
    full = float(2 * n * b * (1 + q) + QUERY_DECODE_OPS * n * q)
    # A 2-tile window over both stores: the scan of the window's bins.
    window = float(2 * n * 2 * 128 * (1 + q) + QUERY_DECODE_OPS * n * q)
    # One crossing tile a (stream, q), one compare a bin, then the decode.
    tile = float(2 * n * q * 128 + QUERY_DECODE_OPS * n * q)
    # One add (or min / max) an element of the state's leaves.
    merge = float(sum(getattr(state, f).numel() for f in batched.LEAVES))
    lo = 0
    return [
        ("batched.add", functools.partial(batched.add, spec), (state, values), ingest),
        ("batched.quantile", functools.partial(batched.quantile, spec), (state, qs), full),
        (
            "batched.merge",
            functools.partial(batched.merge, spec),
            (state, batched.init(spec, n, "cpu")),
            merge,
        ),
        (
            "kernels.ingest_histogram",
            functools.partial(kernels.ingest_histogram, spec),
            (values, weights, state.key_offset),
            ingest,
        ),
        ("kernels.fused_quantile", functools.partial(kernels.fused_quantile, spec),
         (state, qs), full),
        (
            "kernels.fused_quantile_windowed",
            functools.partial(kernels.fused_quantile_windowed, spec, n_wblocks=2, w_tiles=1),
            (state, qs, lo),
            window,
        ),
        (
            "kernels.fused_quantile_tiles",
            functools.partial(kernels.fused_quantile_tiles, spec, k_tiles=2),
            (state, qs),
            tile,
        ),
        (
            "kernels.fused_quantile_tiles_overlap",
            functools.partial(kernels.fused_quantile_tiles_overlap, spec, k_tiles=2),
            (state, qs),
            tile,
        ),
        (
            "kernels.quantile_windowed_xla",
            functools.partial(kernels.quantile_windowed_xla, spec, n_tiles_window=2),
            (state, qs, lo),
            window,
        ),
    ]


def _nbytes(obj: Any) -> int:
    """Bytes of every tensor in ``obj`` (tensor, state dataclass, or a
    list/tuple of them); other values count nothing."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_nbytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(x) for x in obj)
    return 0


def _entry_costs(fn, args, flops: float) -> dict:
    """Run one entry point at the audited shape -> flops, boundary bytes
    (inputs plus outputs), arithmetic intensity, and roofline seconds.
    A failure is reported in-row (``{"error": ...}``), not raised."""
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 - the row carries the failure
        return {"error": f"{type(e).__name__}: {str(e)[:200]}"}
    bytes_ = float(_nbytes(args) + _nbytes(out))
    roofline_s = max(flops / PEAK_FLOPS_PER_S, bytes_ / PEAK_HBM_BYTES_PER_S)
    return {
        "flops": flops,
        "bytes": bytes_,
        "intensity_flops_per_byte": (flops / bytes_) if bytes_ else None,
        "roofline_s": roofline_s,
    }


def roofline(refresh: bool = False) -> Dict[str, dict]:
    """Per-entry-point roofline table at the audited shapes, cached after
    the first call.  Entry points that fail carry an ``"error"`` row
    instead of raising."""
    global _roofline_cache
    if _roofline_cache is not None and not refresh:
        return _roofline_cache
    try:
        table = {name: _entry_costs(fn, args, flops) for name, fn, args, flops in _entry_points()}
    except Exception as e:  # noqa: BLE001 - attribution must not crash
        table = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
    _roofline_cache = table
    return table


def attribution() -> dict:
    """The measured-vs-roofline attribution table (JSON-safe).

    ``measured`` maps ``"phase/tier"`` to call counts and device-clocked
    seconds; ``attribution`` joins each measured row against its entry
    point's roofline estimate (``x_roofline`` = measured mean over the
    light-speed time at the audited shape).  Empty tables are the
    disarmed/idle steady state; roofline rows may carry ``"error"``
    entries (never raises).
    """
    with _lock:
        measured = {
            f"{phase}/{tier}": {
                "phase": phase,
                "tier": tier,
                "calls": st["calls"],
                "total_s": st["total_s"],
                "mean_s": st["total_s"] / st["calls"] if st["calls"] else None,
                "min_s": None if math.isinf(st["min_s"]) else st["min_s"],
                "max_s": None if math.isinf(st["max_s"]) else st["max_s"],
            }
            for (phase, tier), st in _stats.items()
        }
        dropped = _events_dropped
    roof = roofline()
    rows = []
    for key, row in sorted(measured.items()):
        entry = _TIER_ENTRY.get((row["phase"], row["tier"]))
        r = roof.get(entry) if entry else None
        roofline_s = r.get("roofline_s") if isinstance(r, dict) else None
        mean = row["mean_s"]
        rows.append(
            {
                "phase": row["phase"],
                "tier": row["tier"],
                "entry": entry,
                "calls": row["calls"],
                "total_s": row["total_s"],
                "mean_s": mean,
                "roofline_s": roofline_s,
                "x_roofline": (
                    mean / roofline_s
                    if mean is not None and roofline_s
                    else None
                ),
            }
        )
    return {
        "measured": measured,
        "roofline": roof,
        "attribution": rows,
        "peaks": {
            "flops_per_s": PEAK_FLOPS_PER_S,
            "hbm_bytes_per_s": PEAK_HBM_BYTES_PER_S,
        },
        "events_dropped": dropped,
    }

"""End-to-end request tracing and the flight recorder of the PyTorch port
(counterpart of ``sketches_tpu.tracing``).

The telemetry layer says *that* p99 is burning; this layer says *which
request* burned it and *what the system looked like* when it did:
Dapper-style trace-context propagation plus a bounded event ring that
dumps a forensic bundle when something goes wrong.  Three surfaces, with
the JAX package's names and formats:

* **Trace contexts** -- :class:`TraceContext` ``(trace_id, span_id,
  parent_id)`` 64-bit ids generated by a **deterministic splitmix64
  counter** from an injectable seed (:func:`seed_ids`) -- no ``random``,
  no clock, so a replay mints the same ids, bit-equal to the JAX
  package's for the same seed.  Contexts propagate contextvar-style
  (:func:`use` / :func:`current`): every armed telemetry span or exemplar
  downstream (facade ingest and query, the distributed fold, the wire
  codec) picks up the current context.
* **Flight recorder** -- a bounded ring (:data:`RECORDER_CAPACITY`,
  oldest overwritten, drops counted) of structured events: spans, engine
  choices, ladder downgrades, injected faults, integrity violations, and
  the elastic control plane (``elastic.reshard``,
  ``elastic.dcn_partition``; a reshard roots its own trace when none is
  bound, so its fold/regrow/verify chain resolves under ``--explain``).
  Armed exactly when telemetry is armed (``SKETCHES_TPU_FLIGHT_RECORDER=0``
  vetoes it); disarmed cost is one bool test per seam, no clock read.
* **Forensic bundles** -- :func:`dump_forensics` serializes the recorder
  ring together with the telemetry snapshot, the health ledger, an SLO
  evaluation, recent integrity reports, and the triggering trace into ONE
  JSON document (format ``sketches_tpu.forensics/1``, readable by either
  package).  ``python -m sketches_tpu_torch.tracing --explain BUNDLE
  TRACE_ID`` pretty-prints a trace's causal chain (``trigger`` follows
  the bundle's own triggering trace); ``--exemplars SNAPSHOT METRIC``
  answers "which traces sit behind the p99 bin of this latency
  histogram".

Determinism: ids come from the seeded splitmix64 counter; event
timestamps from the injectable recorder clock (:func:`configure`
``clock=``, default ``telemetry.clock``), so tests drive the ring under a
virtual clock with zero sleeps.  Failure modes: a full ring overwrites
its OLDEST events and counts the overwrites; a full bundle ring drops its
oldest bundle, counted; :func:`explain` on a trace the bundle does not
carry returns zero events (the CLI exits 1, never crashes); disarmed,
every recording entry point is a no-op after one bool test.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from sketches_tpu_torch import telemetry
from sketches_tpu_torch.analysis import registry

__all__ = [
    "FLIGHT_RECORDER_ENV",
    "RECORDER_CAPACITY",
    "BUNDLE_CAPACITY",
    "TraceContext",
    "splitmix64",
    "enable",
    "disable",
    "enabled",
    "reset",
    "configure",
    "seed_ids",
    "new_trace",
    "child_span",
    "current",
    "use",
    "bind",
    "unbind",
    "last_trace",
    "record_event",
    "events",
    "stats",
    "dump_forensics",
    "bundles",
    "last_bundle",
    "explain",
    "main",
]

#: Declared in ``analysis/registry.py`` (the kill-switch inventory).
FLIGHT_RECORDER_ENV = registry.FLIGHT_RECORDER.name

#: Default event-ring bound: the forensic question is "what were the
#: last ~2k things the system did before it burned".
RECORDER_CAPACITY = 2048

#: Bound on retained forensic bundles (oldest dropped, counted).
BUNDLE_CAPACITY = 16

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def splitmix64(x: int) -> int:
    """Scalar splitmix64 finalizer (uint64 in/out) -- the id generator
    and the exemplar-reservoir priority hash share this one function.
    Pure arithmetic; never raises on an int input."""
    x = (x + _GOLDEN) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & _M64


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One propagated trace position: the request's ``trace_id``, this
    hop's ``span_id``, and the parent hop's ``parent_id`` (0 = root).

    Ids are 64-bit ints minted by the seeded splitmix64 counter --
    deterministic, never 0.  The hex properties are the wire/JSON
    rendering (16 lowercase hex digits).  Frozen: propagation never
    mutates a context, it derives children (:func:`child_span`).
    Failure modes: none of its own -- a context is inert data.
    """

    trace_id: int
    span_id: int
    parent_id: int = 0

    @property
    def trace_hex(self) -> str:
        return format(self.trace_id & _M64, "016x")

    @property
    def span_hex(self) -> str:
        return format(self.span_id & _M64, "016x")

    @property
    def parent_hex(self) -> Optional[str]:
        return format(self.parent_id & _M64, "016x") if self.parent_id else None

    def ids(self) -> dict:
        """JSON-safe id triple (``parent_id`` None for a root span)."""
        return {
            "trace_id": self.trace_hex,
            "span_id": self.span_hex,
            "parent_id": self.parent_hex,
        }


def _raise_value_error(msg: str) -> None:
    # Lazy import: resilience imports this module at load (recorder
    # mirror), so the taxonomy root is reached at call time only.
    from sketches_tpu_torch.resilience import SketchValueError

    raise SketchValueError(msg)


# ---------------------------------------------------------------------------
# Arming (always-armed-when-telemetry-is-armed, kill switch respected)
# ---------------------------------------------------------------------------

#: Kill switch, read once at import (``SKETCHES_TPU_FLIGHT_RECORDER``).
_KILL = registry.enabled(registry.FLIGHT_RECORDER)

#: Fast-path guard: every instrumented seam checks this module flag, so
#: the disarmed layer costs one attribute read + bool test (no clock).
_ACTIVE = _KILL and telemetry._ACTIVE

_lock = threading.Lock()
_id_state = splitmix64(0)
_capacity = RECORDER_CAPACITY
_clock: Optional[Callable[[], float]] = None  # None -> telemetry.clock
_events: List[dict] = []
_head = 0
_seq = 0
_dropped = 0
_bundles: List[dict] = []
_bundles_dropped = 0
_last_trace: Optional[TraceContext] = None

_current: "contextvars.ContextVar[Optional[TraceContext]]" = (
    contextvars.ContextVar("sketches_tpu_torch_trace", default=None)
)


def _sync(telemetry_on: bool) -> None:
    """``telemetry.enable``'s hook: the recorder follows the telemetry
    arming state (kill switch still wins).  Never raises."""
    global _ACTIVE
    _ACTIVE = bool(telemetry_on) and _KILL


def enable(on: bool = True) -> None:
    """Arm (or, with ``on=False``, disarm) tracing directly.

    Normally the layer follows telemetry arming (:func:`_sync`); this
    override lets tests split them.  The kill switch still wins: with
    ``SKETCHES_TPU_FLIGHT_RECORDER=0`` arming is refused silently (the
    documented disarmed steady state, not an error).  Never raises.
    """
    global _ACTIVE
    _ACTIVE = bool(on) and _KILL


def disable() -> None:
    """Disarm tracing (seams go back to one bool test; recorded events
    and bundles are kept, never lost).  Never raises."""
    enable(False)


def enabled() -> bool:
    """Whether the recorder is armed; False (the default while telemetry
    is off) means no seam records, mints, or reads anything."""
    return _ACTIVE


def reset() -> None:
    """Clear the event ring, the bundle ring, the drop counters, the
    last-trace pointer, and re-seed the id counter to its default (test
    isolation hook; capacity/clock configuration is kept).  Never
    raises."""
    global _head, _seq, _dropped, _bundles_dropped, _id_state, _last_trace
    with _lock:
        _events.clear()
        _head = 0
        _seq = 0
        _dropped = 0
        _bundles.clear()
        _bundles_dropped = 0
        _id_state = splitmix64(0)
        _last_trace = None


def configure(
    capacity: Optional[int] = None, clock: Optional[Callable[[], float]] = None
) -> None:
    """Set the recorder ring bound and/or the recorder clock.

    ``capacity`` must be positive (``SketchValueError`` otherwise) and
    takes effect for subsequent events (an over-full ring trims oldest,
    counted as drops); ``clock`` replaces ``telemetry.clock`` as the
    event timebase (the virtual-clock test hook) -- pass
    ``telemetry.clock`` explicitly to restore the default.
    """
    global _capacity, _clock, _head, _dropped
    if capacity is not None:
        if capacity <= 0:
            _raise_value_error("recorder capacity must be positive")
        with _lock:
            if len(_events) > capacity:
                ordered = _events[_head:] + _events[:_head]
                _dropped += len(ordered) - capacity
                _events[:] = ordered[-capacity:]
                _head = 0
            _capacity = int(capacity)
    if clock is not None:
        _clock = clock


# ---------------------------------------------------------------------------
# Trace contexts
# ---------------------------------------------------------------------------


def seed_ids(seed: int) -> None:
    """Re-seed the deterministic id counter: after ``seed_ids(s)`` the
    process mints the exact same trace/span id sequence every run --
    the chaos-replay contract.  Never raises on an int seed."""
    global _id_state
    with _lock:
        _id_state = splitmix64((int(seed) ^ _GOLDEN) & _M64)


def _next_id() -> int:
    # Caller holds _lock.  0 is reserved for "no parent"; the counter
    # skips it (splitmix64 output 0 has one preimage).
    global _id_state
    _id_state = (_id_state + _GOLDEN) & _M64
    out = splitmix64(_id_state)
    return out if out else 1


def new_trace() -> TraceContext:
    """Mint a root :class:`TraceContext` (``parent_id`` 0) and remember
    it as :func:`last_trace`.  Works disarmed too (explicit callers may
    always mint); armed, the declared ``tracing.traces`` counter bumps.
    Never raises."""
    global _last_trace
    with _lock:
        tid = _next_id()
        sid = _next_id()
    ctx = TraceContext(tid, sid, 0)
    _last_trace = ctx
    if telemetry._ACTIVE:
        telemetry.counter_inc("tracing.traces")
    return ctx


def child_span(ctx: Optional[TraceContext]) -> TraceContext:
    """Derive a child context (same trace, fresh span, parent = the
    operand's span).  ``None`` falls back to a fresh root trace -- a
    caller without a context still gets a linkable span, never an
    error."""
    if ctx is None:
        return new_trace()
    with _lock:
        sid = _next_id()
    return TraceContext(ctx.trace_id, sid, ctx.span_id)


def current() -> Optional[TraceContext]:
    """The context bound to this thread/task, or None (the unbound
    steady state, not an error)."""
    return _current.get()


def bind(ctx: Optional[TraceContext]):
    """Bind ``ctx`` as the current context -> an opaque token for
    :func:`unbind` (the non-contextmanager form for hot seams).  Never
    raises."""
    return _current.set(ctx)


def unbind(token) -> None:
    """Restore the binding :func:`bind` replaced.  Never raises on a
    token from this thread; a foreign token raises ``ValueError``
    (contextvars' own contract)."""
    _current.reset(token)


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]):
    """Context manager binding ``ctx`` for the block (exception-safe:
    the previous binding is restored even when the body raises)."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def last_trace() -> Optional[TraceContext]:
    """The most recently minted root context (the chaos harness's
    "which request was in flight" read), or None if none was minted
    since the last :func:`reset`."""
    return _last_trace


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------


def _field(v: Any) -> Any:
    if isinstance(v, (int, float, bool)) or v is None:
        return v
    return str(v)[:200]


def record_event(
    kind: str, ctx: Optional[TraceContext] = None, **fields
) -> None:
    """Append one structured event to the flight-recorder ring.

    ``ctx`` defaults to the current bound context (events without one
    record with null ids -- still forensically useful, just not
    trace-linked).  A full ring overwrites its OLDEST event and counts
    the overwrite (``stats()['dropped']`` + the declared
    ``tracing.dropped`` metric); disarmed, this is a no-op after one
    bool test with no clock read.
    """
    if not _ACTIVE:
        return
    if ctx is None:
        ctx = _current.get()
    clk = _clock if _clock is not None else telemetry.clock
    now = clk()
    ev: Dict[str, Any] = {
        "kind": kind,
        "ts": now,
        "trace_id": ctx.trace_hex if ctx is not None else None,
        "span_id": ctx.span_hex if ctx is not None else None,
        "parent_id": ctx.parent_hex if ctx is not None else None,
    }
    for k, v in fields.items():
        ev[k] = _field(v)
    dropped_one = False
    global _head, _seq, _dropped
    with _lock:
        ev["seq"] = _seq
        _seq += 1
        if len(_events) < _capacity:
            _events.append(ev)
        else:
            _events[_head] = ev
            _head = (_head + 1) % _capacity
            _dropped += 1
            dropped_one = True
    if telemetry._ACTIVE:
        telemetry.counter_inc("tracing.events")
        if dropped_one:
            telemetry.counter_inc("tracing.dropped")


def events() -> List[dict]:
    """The recorded events, oldest first (a copy; at most the configured
    capacity -- older events were overwritten and counted).  An empty
    list is the disarmed/idle steady state."""
    with _lock:
        return list(_events[_head:] + _events[:_head])


def stats() -> dict:
    """JSON-safe recorder accounting (rides ``telemetry.snapshot()``
    when armed).  ``dropped`` counts ring overwrites -- a non-zero value
    means the ring wrapped, not that data was lost silently."""
    with _lock:
        return {
            "events": len(_events),
            "recorded": _seq,
            "dropped": _dropped,
            "capacity": _capacity,
            "bundles": len(_bundles),
            "bundles_dropped": _bundles_dropped,
        }


# ---------------------------------------------------------------------------
# Forensic bundles
# ---------------------------------------------------------------------------


def _trigger_trace(trace: Any) -> Optional[dict]:
    if trace is None:
        return None
    if isinstance(trace, TraceContext):
        return trace.ids()
    if isinstance(trace, dict):
        return {
            "trace_id": trace.get("trace_id"),
            "span_id": trace.get("span_id"),
            "parent_id": trace.get("parent_id"),
        }
    return {"trace_id": str(trace), "span_id": None, "parent_id": None}


def dump_forensics(
    reason: str,
    trace: Any = None,
    detail: Optional[dict] = None,
    path: Optional[str] = None,
    snapshot: Optional[dict] = None,
) -> dict:
    """Serialize the forensic picture at this instant -> the bundle dict.

    The bundle carries the recorder ring, the telemetry snapshot
    (``snapshot=`` overrides, e.g. the SLO gate's file under test; None
    + disarmed telemetry records an absent layer, not an empty one),
    the resilience health ledger, an SLO evaluation of that snapshot,
    recent integrity reports, and the triggering trace (``trace=`` a
    :class:`TraceContext`, an ids dict, or a hex string; defaults to
    the current context, then :func:`last_trace`).  The bundle lands in
    a bounded ring (:data:`BUNDLE_CAPACITY`, oldest dropped + counted)
    and optionally on disk at ``path``.  Best-effort by design: a
    section that fails to serialize records its error string instead of
    raising -- a forensic dump must never take the process down; only a
    caller-supplied unwritable ``path`` raises (``OSError``).
    """
    global _bundles_dropped
    if trace is None:
        trace = _current.get() or _last_trace
    snap = snapshot
    if snap is None and telemetry._ACTIVE:
        try:
            snap = telemetry.snapshot()
        except Exception as e:  # noqa: BLE001 - forensics must not crash
            snap = {"error": repr(e)}
    slo: Optional[dict] = None
    if isinstance(snap, dict) and "error" not in snap:
        try:
            lines, burning, evaluated = telemetry.check_slo(snap)
            slo = {"lines": lines, "burning": burning, "evaluated": evaluated}
        except Exception as e:  # noqa: BLE001
            slo = {"error": repr(e)}
    try:
        from sketches_tpu_torch import resilience

        health = resilience.health()
    except Exception as e:  # noqa: BLE001
        health = {"error": repr(e)}
    try:
        from sketches_tpu_torch import integrity

        reports = integrity.reports()
        integ = {
            "n_reports": len(reports),
            "recent": [str(r)[:500] for r in reports[-16:]],
        }
    except Exception as e:  # noqa: BLE001
        integ = {"error": repr(e)}
    bundle = {
        "format": "sketches_tpu.forensics/1",
        "reason": str(reason),
        "wall_time": telemetry.wall_time(),
        "trigger": {
            "trace": _trigger_trace(trace),
            "detail": {k: _field(v) for k, v in (detail or {}).items()},
        },
        "events": events(),
        "events_dropped": stats()["dropped"],
        "telemetry": snap,
        "slo": slo,
        "health": health,
        "integrity": integ,
    }
    with _lock:
        _bundles.append(bundle)
        while len(_bundles) > BUNDLE_CAPACITY:
            _bundles.pop(0)
            _bundles_dropped += 1
    if telemetry._ACTIVE:
        telemetry.counter_inc("tracing.dumps")
    if path:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(bundle, f, indent=1, sort_keys=True)
            f.write("\n")
    return bundle


def bundles() -> List[dict]:
    """The retained forensic bundles, oldest first (bounded at
    :data:`BUNDLE_CAPACITY`; overflow dropped + counted in
    :func:`stats`).  Empty is the nothing-burned steady state."""
    with _lock:
        return list(_bundles)


def last_bundle() -> Optional[dict]:
    """The most recent forensic bundle, or None when nothing has dumped
    (the healthy steady state, not an error)."""
    with _lock:
        return _bundles[-1] if _bundles else None


# ---------------------------------------------------------------------------
# Explain: reconstruct one trace's causal chain from a bundle
# ---------------------------------------------------------------------------


def _norm_trace_id(trace_id: Any) -> str:
    if isinstance(trace_id, int):
        return format(trace_id & _M64, "016x")
    s = str(trace_id).strip().lower()
    try:
        return format(int(s, 16) & _M64, "016x")
    except ValueError:
        return s


def explain(bundle: dict, trace_id: Any) -> Tuple[List[str], int]:
    """Reconstruct ``trace_id``'s causal chain from a forensic bundle ->
    ``(pretty lines, n matching events)``.

    ``trace_id`` accepts a hex string, an int, or the literal
    ``"trigger"`` (follow the bundle's own triggering trace).  Events
    are ordered by sequence number and indented by span parentage, with
    timestamps relative to the trace's first event.  A trace the bundle
    does not carry yields ``n == 0`` and a one-line report -- never an
    exception; a malformed bundle raises ``SketchValueError``.
    """
    if not isinstance(bundle, dict) or "events" not in bundle:
        _raise_value_error(
            "not a forensic bundle: expected a dict with an 'events' list"
            " (format sketches_tpu.forensics/1)"
        )
    if str(trace_id).strip().lower() == "trigger":
        trig = (bundle.get("trigger") or {}).get("trace") or {}
        trace_id = trig.get("trace_id")
        if trace_id is None:
            return (["bundle carries no triggering trace"], 0)
    tid = _norm_trace_id(trace_id)
    evs = [
        e for e in bundle.get("events", [])
        if isinstance(e, dict) and e.get("trace_id") == tid
    ]
    evs.sort(key=lambda e: e.get("seq", 0))
    lines: List[str] = []
    trig = (bundle.get("trigger") or {}).get("trace") or {}
    head = (
        f"trace {tid}: {len(evs)} event(s)"
        f" (bundle reason: {bundle.get('reason', '?')}"
        + (", this is the triggering trace)" if trig.get("trace_id") == tid
           else ")")
    )
    lines.append(head)
    if not evs:
        lines.append("  no events recorded for this trace in the bundle")
        return lines, 0
    # Span parentage -> indentation depth (cycle-guarded).
    parents = {
        e["span_id"]: e.get("parent_id")
        for e in evs
        if e.get("span_id")
    }

    def depth(span: Optional[str]) -> int:
        d, seen = 0, set()
        while span in parents and parents[span] and span not in seen:
            seen.add(span)
            span = parents[span]
            d += 1
        return d

    t0 = min(float(e.get("ts", 0.0)) for e in evs)
    meta = ("kind", "ts", "trace_id", "span_id", "parent_id", "seq")
    for e in evs:
        rel = float(e.get("ts", 0.0)) - t0
        pad = "  " * (1 + depth(e.get("span_id")))
        extra = " ".join(
            f"{k}={e[k]}" for k in e if k not in meta and e[k] is not None
        )
        span = (e.get("span_id") or "-")[:8]
        parent = (e.get("parent_id") or "-")[:8]
        lines.append(
            f"{pad}+{rel:.6f}s {e.get('kind', '?'):<22s}"
            f" span={span} parent={parent} {extra}".rstrip()
        )
    detail = (bundle.get("trigger") or {}).get("detail") or {}
    if trig.get("trace_id") == tid and detail:
        lines.append(
            "  trigger detail: "
            + " ".join(f"{k}={v}" for k, v in detail.items())
        )
    return lines, len(evs)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _load_json(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``--explain BUNDLE TRACE_ID`` (exit 0 when the trace
    resolves, 1 when absent, 2 on an unreadable/unrecognized file),
    ``--exemplars SNAPSHOT METRIC [--q Q]`` (exit 0 with exemplars, 1
    without), ``--dump PATH [--reason R]`` (write this process's
    forensic bundle; exit 0)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m sketches_tpu_torch.tracing",
        description="request-tracing utilities: explain a trace's causal"
        " chain from a forensic bundle, query histogram exemplars, dump"
        " the live flight recorder",
    )
    parser.add_argument(
        "--explain", nargs=2, metavar=("BUNDLE", "TRACE_ID"), default=None,
        help="pretty-print TRACE_ID's causal chain from a forensic bundle"
        " JSON (TRACE_ID 'trigger' follows the bundle's triggering trace)",
    )
    parser.add_argument(
        "--exemplars", nargs=2, metavar=("SNAPSHOT", "METRIC"), default=None,
        help="print the exemplar trace ids behind METRIC's --q bin in a"
        " telemetry snapshot JSON",
    )
    parser.add_argument("--q", type=float, default=0.99,
                        help="quantile for --exemplars (default 0.99)")
    parser.add_argument(
        "--dump", metavar="PATH", default=None,
        help="write this process's forensic bundle to PATH",
    )
    parser.add_argument("--reason", default="cli",
                        help="bundle reason for --dump")
    args = parser.parse_args(argv)
    acted = False

    if args.dump:
        acted = True
        dump_forensics(args.reason, path=args.dump)
        print(f"dump: forensic bundle -> {args.dump}")

    if args.exemplars:
        acted = True
        snap_path, metric = args.exemplars
        try:
            snap = _load_json(snap_path)
            out = telemetry.exemplars_for(snap, metric, args.q)
        except Exception as e:  # noqa: BLE001 - CLI reports, not crashes
            print(f"exemplars: cannot evaluate {metric!r}: {e}")
            return 2
        print(
            f"exemplars: {metric} q={args.q:g} -> bin {out['bin_key']}"
            f" (~{out['bin_value']:g}s, exemplar bin {out['exemplar_bin']})"
        )
        for e in out["exemplars"]:
            print(
                f"  trace {e['trace_id']}  value {e['value']:g}s"
                f"  wall {e['wall_time']:.3f}"
            )
        if not out["exemplars"]:
            print("  no exemplars recorded for this metric")
            return 1
        return 0

    if args.explain:
        bundle_path, trace_id = args.explain
        try:
            bundle = _load_json(bundle_path)
        except Exception as e:  # noqa: BLE001
            print(f"explain: cannot read {bundle_path!r}: {e}")
            return 2
        try:
            lines, n = explain(bundle, trace_id)
        except Exception as e:  # noqa: BLE001
            print(f"explain: {e}")
            return 2
        for line in lines:
            print(line)
        return 0 if n else 1

    if acted:
        return 0
    parser.print_usage()
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(main())

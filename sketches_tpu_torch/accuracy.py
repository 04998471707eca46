"""Accuracy-drift shadow audit of the PyTorch port: is the alpha contract
still true?  (Counterpart of ``sketches_tpu.accuracy``.)

A DDSketch's relative-error guarantee is structural -- until mass
collapses into the static window's edge bins (the silent-degradation
failure mode UDDSketch, arXiv:2004.08604, exists to fix), or until a bug
anywhere in the ingest/merge/query stack bends the answers.  The
integrity layer proves the *state* is well-formed; this layer proves the
*answers* are still accurate, online:

* :func:`watch` registers a sketch facade for auditing.  Each watched
  stream keeps a **bounded reservoir sample** of its ingested values
  (deterministic splitmix-hash reservoir -- no global RNG, so a failing
  sequence replays exactly, and the kept set is bit-equal to the JAX
  package's for the same batches).
* Every ``interval`` ingests the auditor replays the contract: the
  facade's p50/p90/p99 (a real query, through the facade's own route --
  on the card, its kernels) must land inside the reservoir's
  order-statistic bracket widened by alpha, and the per-stream
  ``collapsed_mass_frac`` (edge-clamped mass over total) is tracked for
  drift.
* Breaches emit the declared ``accuracy.*`` telemetry metrics and
  ring-bounded :class:`DriftReport` records (bounded memory, drops
  counted).

Arming: OFF by default.  ``SKETCHES_TPU_ACCURACY_AUDIT=1`` (declared in
``analysis/registry.py``) arms at process start; :func:`enable` /
:func:`disable` arm programmatically.  The ingest seam guards on
``accuracy._ACTIVE`` -- one attribute read + bool test per dispatch
disarmed -- and an armed ingest of an *unwatched* facade costs one dict
lookup.  An armed ingest of a watched facade fetches only the watched
rows of the batch to the host (``values[streams].cpu()``), never the
whole batch.

Failure modes: watching an object without a quantile API raises
``SketchValueError``; a garbage-collected watched facade is silently
unwatched at its next audit; streams whose reservoir holds fewer than
``MIN_SAMPLE`` values are skipped; weighted ingests are audited by value
with weights ignored (weight > 0 admits the value once); the report ring
is bounded at 1024 with further reports counted.  A facade whose query
fails audits as absent only where its ladder may survive the failure
(``resilience.survivable``): on the card a real kernel error raises out
of the audit -- and so out of the ``add`` that ran it.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sketches_tpu_torch import telemetry
from sketches_tpu_torch.analysis import registry

__all__ = [
    "ACCURACY_ENV",
    "RESERVOIR_CAP",
    "MIN_SAMPLE",
    "AUDIT_QS",
    "DriftReport",
    "enable",
    "disable",
    "enabled",
    "reset",
    "watch",
    "unwatch",
    "observe_ingest",
    "audit_now",
    "reports",
    "summary",
]

#: Declared in ``analysis/registry.py`` (the kill-switch inventory).
ACCURACY_ENV = registry.ACCURACY_AUDIT.name

#: Per-stream reservoir bound: enough that a p99 bracket is a few
#: sample ranks wide, small enough that auditing costs KBs per stream.
RESERVOIR_CAP = 4096

#: Streams with fewer reservoir values than this are skipped: order
#: statistics this sparse cannot bracket a tail quantile honestly.
MIN_SAMPLE = 64

#: Quantiles every audit pass replays against the contract.
AUDIT_QS: Tuple[float, ...] = (0.5, 0.9, 0.99)

#: Default ingest calls between audit passes per watched facade.
DEFAULT_INTERVAL = 16

#: collapsed_mass_frac growth between consecutive audits that counts as
#: drift (reported even when the quantile bracket still holds -- the
#: UDDSketch early warning).
COLLAPSE_DRIFT = 0.01

_MAX_REPORTS = 1024

_ACTIVE = registry.enabled(registry.ACCURACY_AUDIT)

_lock = threading.Lock()
_watches: Dict[str, "_Watch"] = {}
_by_id: Dict[int, str] = {}
_reports: List["DriftReport"] = []
_reports_dropped = 0
_audits_total = 0
_violations_total = 0


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One recorded accuracy breach or collapse-drift observation.

    ``kind`` is ``"rank-error"`` (a realized quantile left the
    alpha-widened order-statistic bracket) or ``"collapse-drift"``
    (edge-clamped mass fraction jumped by more than
    :data:`COLLAPSE_DRIFT` since the previous audit).  ``wall_time``
    is operator-facing only (``telemetry.wall_time``).
    """

    name: str
    stream: int
    kind: str
    quantile: float
    sketch_value: float
    sample_value: float
    rel_err: float
    collapsed_frac: float
    sample_size: int
    audit_index: int
    wall_time: float


class _Reservoir:
    """Bounded uniform sample with deterministic replacement.

    Algorithm R with the coin flips taken from a splitmix64 hash of the
    (seed, absolute position) pair instead of an RNG: the kept set is a
    pure function of the stream contents and arrival order, so a
    failing audit replays exactly.
    """

    __slots__ = ("cap", "seed", "buf", "n")

    def __init__(self, cap: int, seed: int):
        self.cap = cap
        self.seed = np.uint64(
            (seed * 0x9E3779B97F4A7C15 + 1) & 0xFFFFFFFFFFFFFFFF
        )
        self.buf: List[float] = []
        self.n = 0

    def extend(self, values: np.ndarray) -> None:
        vals = np.asarray(values, np.float64).ravel()
        vals = vals[~np.isnan(vals)]
        m = int(vals.size)
        if not m:
            return
        take = min(self.cap - len(self.buf), m)
        if take > 0:
            self.buf.extend(float(v) for v in vals[:take])
        rest = vals[take:]
        if rest.size:
            pos = (
                np.arange(self.n + take, self.n + m, dtype=np.uint64)
                ^ self.seed
            )
            j = _splitmix64(pos) % np.uint64(self.cap)
            keep = _splitmix64(pos + np.uint64(0x632BE59BD9B4E019)) % (
                np.arange(self.n + take, self.n + m, dtype=np.uint64)
                + np.uint64(1)
            )
            sel = np.nonzero(keep < np.uint64(self.cap))[0]
            for i in sel:
                self.buf[int(j[i])] = float(rest[i])
        self.n += m

    def sorted_sample(self) -> np.ndarray:
        return np.sort(np.asarray(self.buf, np.float64))


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 in, uint64 out)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class _Watch:
    __slots__ = (
        "name", "ref", "streams", "interval", "rel_acc", "reservoirs",
        "ingest_calls", "audits", "last_collapsed",
    )

    def __init__(self, name, ref, streams, interval, rel_acc):
        self.name = name
        self.ref = ref
        self.streams = streams
        self.interval = interval
        self.rel_acc = rel_acc
        import binascii

        # crc32, not hash(): string hashing is salted per process, and
        # the reservoir seed must be stable so multi-process audits of
        # the same stream replay identically (faults.py discipline).
        self.reservoirs: Dict[int, _Reservoir] = {
            s: _Reservoir(
                RESERVOIR_CAP,
                seed=binascii.crc32(f"{name}:{s}".encode()) & 0x7FFFFFFF,
            )
            for s in streams
        }
        self.ingest_calls = 0
        self.audits = 0
        self.last_collapsed: Dict[int, float] = {}


def _raise_value_error(msg: str) -> None:
    from sketches_tpu_torch.resilience import SketchValueError

    raise SketchValueError(msg)


def enable(on: bool = True) -> None:
    """Arm (or, with ``on=False``, disarm) the shadow audit.  Never
    raises; watches and recorded reports are kept (:func:`reset`
    clears)."""
    global _ACTIVE
    _ACTIVE = bool(on)


def disable() -> None:
    """Disarm the shadow audit (the ingest seam goes back to one bool
    test; watches/reports are kept, never lost)."""
    enable(False)


def enabled() -> bool:
    """Whether the audit is armed (env switch or :func:`enable`);
    False -- the default -- means no ingest is shadowed."""
    return _ACTIVE


def reset() -> None:
    """Drop every watch, reservoir, and report (test isolation hook).
    Never raises."""
    global _reports_dropped, _audits_total, _violations_total
    with _lock:
        _watches.clear()
        _by_id.clear()
        _reports.clear()
        _reports_dropped = 0
        _audits_total = 0
        _violations_total = 0


def watch(
    facade: Any,
    name: str,
    streams: Optional[Sequence[int]] = None,
    interval: int = DEFAULT_INTERVAL,
) -> str:
    """Register ``facade`` (a ``BatchedDDSketch`` / ``DistributedDDSketch``
    or anything with ``get_quantile_values``) for shadow auditing.

    ``streams`` selects which stream rows keep reservoirs (default: the
    first 8 -- auditing a million streams would cost a million
    reservoirs; pick representatives).  The facade is held weakly: a
    collected facade is silently unwatched.  Raises ``SketchValueError``
    for an object without a quantile API, a non-positive ``interval``,
    or a duplicate ``name``.
    """
    if not hasattr(facade, "get_quantile_values") and not hasattr(
        facade, "get_quantile_value"
    ):
        _raise_value_error(
            f"cannot watch {type(facade).__name__}: no quantile API"
        )
    if interval <= 0:
        _raise_value_error("interval must be positive")
    n_streams = int(getattr(facade, "n_streams", 1))
    if streams is None:
        streams = tuple(range(min(n_streams, 8)))
    else:
        streams = tuple(int(s) for s in streams)
        bad = [s for s in streams if not 0 <= s < max(n_streams, 1)]
        if bad:
            _raise_value_error(
                f"watched streams {bad} out of range for {n_streams} streams"
            )
    spec = getattr(facade, "spec", None)
    rel_acc = float(
        getattr(spec, "relative_accuracy", None)
        or getattr(facade, "relative_accuracy", 0.01)
    )
    fid = id(facade)

    def _collect(_ref, _fid=fid, _name=name):
        with _lock:
            _by_id.pop(_fid, None)
            _watches.pop(_name, None)

    with _lock:
        if name in _watches:
            _raise_value_error(f"already watching a sketch named {name!r}")
        _watches[name] = _Watch(
            name, weakref.ref(facade, _collect), streams, int(interval),
            rel_acc,
        )
        _by_id[fid] = name
    return name


def unwatch(name: str) -> None:
    """Stop auditing ``name`` (unknown names are a no-op, never an
    error); its reservoirs are dropped, its reports kept."""
    with _lock:
        w = _watches.pop(name, None)
        if w is not None:
            _by_id_inv = [k for k, v in _by_id.items() if v == name]
            for k in _by_id_inv:
                _by_id.pop(k, None)


def _2d(x):
    """A batch as 2-D (one value a stream when 1-D): torch tensors stay
    where they live, anything else becomes a numpy array."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return x[:, None] if x.ndim == 1 else x


def _host_rows(x, idx: List[int]) -> np.ndarray:
    """Rows ``idx`` of a 2-D batch (torch tensor on any device, or array
    like) as a host float64 array: only those rows leave the device."""
    if isinstance(x, torch.Tensor):
        sel = torch.as_tensor(idx, dtype=torch.long, device=x.device)
        return x.index_select(0, sel).detach().cpu().double().numpy()
    return np.asarray(np.asarray(x)[idx], np.float64)


def observe_ingest(facade: Any, values, weights=None) -> None:
    """The ingest seam: feed a watched facade's batch into its
    reservoirs and run the periodic audit.

    No-op (after one dict lookup) for unwatched facades; no-op entirely
    while disarmed.  Values with ``weights <= 0`` (padding) and NaNs
    are excluded from the sample; positive weights admit the value once
    (the documented weighted-ingest approximation).  Only the watched
    rows of ``values`` (and ``weights``) are fetched to the host.  Breaches
    land in reports, not exceptions; a query the audit cannot survive
    raises (see :func:`_sketch_quantiles`).
    """
    if not _ACTIVE:
        return
    name = _by_id.get(id(facade))
    if name is None:
        return
    with _lock:
        w = _watches.get(name)
    if w is None:
        return
    vals = _2d(values)
    idx = [s for s in w.streams if s < vals.shape[0]]
    if idx:
        rows = _host_rows(vals, idx)
        wts = None
        if weights is not None:
            wts = np.broadcast_to(_host_rows(_2d(weights), idx), rows.shape)
        for j, s in enumerate(idx):
            row = rows[j]
            if wts is not None:
                row = row[wts[j] > 0]
            w.reservoirs[s].extend(row)
    w.ingest_calls += 1
    if w.ingest_calls % w.interval == 0:
        _audit(w)


def audit_now(name: str) -> int:
    """Run one audit pass for watch ``name`` immediately -> number of
    violations found (0 is the healthy answer).  Raises
    ``SketchValueError`` for an unknown name."""
    with _lock:
        w = _watches.get(name)
    if w is None:
        _raise_value_error(f"no watch named {name!r}")
    return _audit(w)


def _on_card(facade) -> bool:
    """Whether ``facade`` lives on a CUDA device (its own ``device``, or
    its mesh's devices for a distributed facade)."""
    dev = getattr(facade, "device", None)
    if dev is not None:
        return torch.device(dev).type == "cuda"
    devs = getattr(getattr(facade, "mesh", None), "devices", None) or ()
    return any(torch.device(d).type == "cuda" for d in devs)


def _facade_collapsed(facade, streams: Sequence[int]):
    """(collapsed_low+high, count, n_streams) for the watched ``streams``
    (rows in that order), or None when the facade has no inspectable
    dense state (host-tier sketches never collapse; the moment backend
    has no bins).  Only the watched rows are fetched."""
    st = getattr(facade, "state", None)
    if st is None and hasattr(facade, "merged_state"):
        st = facade.merged_state()
    try:
        lo, hi, count = st.collapsed_low, st.collapsed_high, st.count
    except AttributeError:
        return None
    n = int(count.shape[0])
    idx = [min(s, n - 1) for s in streams]
    collapsed = _host_rows(lo, idx) + _host_rows(hi, idx)
    return collapsed, _host_rows(count, idx), n


def _sketch_quantiles(facade, streams: Sequence[int]) -> Optional[np.ndarray]:
    """The facade's values at :data:`AUDIT_QS` for the watched ``streams``
    -> ``[len(streams), Q]`` (a one-row answer serves every stream).

    A failing query audits the facade as absent (None) only where its
    ladder may survive the failure (:func:`resilience.survivable`): on
    the card a real kernel error raises."""
    from sketches_tpu_torch import resilience

    try:
        if hasattr(facade, "get_quantile_values"):
            out = facade.get_quantile_values(list(AUDIT_QS))
            if not isinstance(out, torch.Tensor):
                out = np.asarray(out)
            if out.ndim == 1:
                out = out[None, :]
            n = int(out.shape[0])
            return _host_rows(out, [min(s, n - 1) for s in streams])
        vals = [facade.get_quantile_value(q) for q in AUDIT_QS]
        if any(v is None for v in vals):
            return None
        return np.repeat(np.asarray(vals, np.float64)[None, :], len(streams), 0)
    except Exception as e:
        if not resilience.survivable(e, _on_card(facade)):
            raise
        return None


def _audit(w: _Watch) -> int:
    """One audit pass: realized-rank-error + collapse-drift checks."""
    global _audits_total, _violations_total, _reports_dropped
    facade = w.ref()
    if facade is None:
        unwatch(w.name)
        return 0
    sk_q = _sketch_quantiles(facade, w.streams)
    if sk_q is None:
        return 0
    collapsed = _facade_collapsed(facade, w.streams)
    spec = getattr(facade, "spec", None)
    # Streams whose backend CAN collapse handle threshold crossings
    # themselves (the uniform-collapse trigger); for everything else the
    # crossing becomes a declared counter instead of dying in the gauge.
    _recommendable = getattr(spec, "backend", "dense") != "uniform_collapse"
    _collapse_thr = float(getattr(spec, "collapse_threshold", 0.01))
    w.audits += 1
    violations = 0
    worst_rel_err: Dict[int, float] = {}
    now = telemetry.wall_time()
    new_reports: List[DriftReport] = []
    for i, s in enumerate(w.streams):
        sample = w.reservoirs[s].sorted_sample()
        m = int(sample.size)
        frac = 0.0
        if collapsed is not None and s < collapsed[2]:
            cnt = float(collapsed[1][i])
            frac = float(collapsed[0][i]) / cnt if cnt > 0 else 0.0
        if m >= MIN_SAMPLE:
            row = sk_q[i]
            for qi, q in enumerate(AUDIT_QS):
                got = float(row[qi])
                if not math.isfinite(got):
                    continue
                idx = q * (m - 1)
                # Order-statistic bracket: +-2 sigma of the binomial
                # rank noise a uniform m-sample carries at quantile q,
                # then widened by the alpha contract itself.
                slack = 2.0 * math.sqrt(m * q * (1.0 - q)) + 1.0
                lo_i = int(max(0, math.floor(idx - slack)))
                hi_i = int(min(m - 1, math.ceil(idx + slack)))
                lo_v, hi_v = float(sample[lo_i]), float(sample[hi_i])
                a = w.rel_acc
                lo_b = min(lo_v * (1 - a), lo_v * (1 + a))
                hi_b = max(hi_v * (1 - a), hi_v * (1 + a))
                exact = float(sample[int(round(idx))])
                rel = abs(got - exact) / max(abs(exact), 1e-12)
                worst_rel_err[s] = max(worst_rel_err.get(s, 0.0), rel)
                if not (lo_b - 1e-9 <= got <= hi_b + 1e-9):
                    violations += 1
                    new_reports.append(DriftReport(
                        name=w.name, stream=s, kind="rank-error",
                        quantile=q, sketch_value=got, sample_value=exact,
                        rel_err=rel, collapsed_frac=frac, sample_size=m,
                        audit_index=w.audits, wall_time=now,
                    ))
        prev = w.last_collapsed.get(s, 0.0)
        if _recommendable and prev <= _collapse_thr < frac:
            # Edge-clamped mass crossed the threshold on a stream that
            # cannot collapse: recommend the adaptive backend (counted
            # once per crossing, not per audit -- prev gates re-fires).
            telemetry.counter_inc(
                "accuracy.collapse_recommended", stream=s
            )
        if frac - prev > COLLAPSE_DRIFT:
            new_reports.append(DriftReport(
                name=w.name, stream=s, kind="collapse-drift",
                quantile=float("nan"), sketch_value=float("nan"),
                sample_value=float("nan"), rel_err=float("nan"),
                collapsed_frac=frac, sample_size=m,
                audit_index=w.audits, wall_time=now,
            ))
        w.last_collapsed[s] = frac
        telemetry.gauge_set(
            "accuracy.collapsed_mass_frac", frac, stream=s
        )
        if s in worst_rel_err:
            telemetry.gauge_set(
                "accuracy.rel_err", worst_rel_err[s], stream=s
            )
    with _lock:
        _audits_total += 1
        _violations_total += violations
        for r in new_reports:
            if len(_reports) < _MAX_REPORTS:
                _reports.append(r)
            else:
                _reports_dropped += 1
    telemetry.counter_inc("accuracy.audits")
    if violations:
        telemetry.counter_inc("accuracy.violations", float(violations))
    return violations


def reports() -> List[DriftReport]:
    """The recorded drift reports, oldest first (bounded at 1024; the
    overflow count is in :func:`summary`).  An empty list is the
    healthy steady state."""
    with _lock:
        return list(_reports)


def summary() -> dict:
    """JSON-safe audit summary (rides ``telemetry.snapshot()`` when the
    layer is armed).  Zero audits with watches registered means the
    interval has not elapsed yet, not a failure."""
    with _lock:
        return {
            "watched": len(_watches),
            "audits": _audits_total,
            "violations": _violations_total,
            "reports": len(_reports),
            "reports_dropped": _reports_dropped,
        }

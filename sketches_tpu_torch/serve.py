"""Overload-hardened multi-tenant serving tier (PyTorch port of
``sketches_tpu/serve.py``).

N tenants each own an isolated facade (per-tenant ``SketchSpec``, on the
card unless the tenant is registered with ``device="cpu"``); concurrent
quantile requests are admitted into a bounded queue and flushed as fused
dispatches.  Requests for one tenant fold into one multi-quantile call (the
union of their quantiles), and tenants sharing a spec and a quantile set
stack their states leaf by leaf and answer in ONE call of the ``xla``
floor, which on the card is the full-window kernel (K2,
``kernels.floor_quantile``) where the JAX package dispatches its jitted
``batched.quantile``.  Around the dispatch sits the JAX package's
robustness envelope, unchanged:

* **Admission control**: a bounded queue with a declared shed order; a
  request is refused at admission (``ServeOverload``, structured
  ``reason``) when its tenant is over quota (``tenant_quota``) or the queue
  is at depth (``queue_depth``); admitted requests are never evicted, and
  shedding is counted (``serve.shed`` + health ledger).
* **Deadline budgets**: a request whose remaining budget falls under
  ``floor_margin_s`` at flush skips to the ``xla`` floor (the tenant
  facade's ``xla`` tier, ``kernels.floor_quantile``: K2 on the card, as
  for the stacked flush); a spent budget
  answers ``DeadlineExceeded``; late answers are returned but counted.
* **Hedged retries**: a primary dispatch that fails (the armed
  ``serve.straggler`` site) or straggles past ``hedge_after_s`` is hedged
  on the floor; queries are pure, so the hedge equals the primary bit for
  bit (checked).
* **Circuit breaker per engine tier** on the non-floor rungs of
  ``overlap -> tiles -> windowed -> wxla -> xla``, with a request-count
  cooldown and a half-open probe; the floor never opens.
* **Fingerprint-keyed result cache with poison detection**: results are
  memoized under ``(tenant, content fingerprint, quantiles)``
  (:func:`sketches_tpu_torch.integrity.fingerprint`, bit-equal to the JAX
  package's), every hit is re-verified against the live fingerprint and a
  payload checksum, and a mismatch quarantines the entry and recomputes.

Windowed tenants (``add_tenant(..., window=...)``) answer
:meth:`SketchServer.quantile` with ``window=W`` through
``sketches_tpu_torch.windows``, cached under the covered-bucket digest;
:meth:`SketchServer.quantile_many` stacks same-spec windowed tenants into
one call.  Tracing: with the flight recorder armed every request roots a
trace at admission, decisions become recorder events, and cache poison
and unexpected admission errors dump forensic bundles.

A failed dispatch is hedged when the failure is a ``SketchError``; on the
card only an armed fault's ``InjectedFault`` is (``resilience.survivable``,
as the facades' ladder steps down), and a kernel error raises.  The serving
clock is injectable, so deadline, hedge and breaker behaviour replays
exactly under a virtual clock.  Kill switches: ``SKETCHES_TPU_SERVE_CACHE=0``
disables the cache, ``SKETCHES_TPU_SERVE_HEDGE=0`` hedging.

Failure modes: shed requests raise :class:`ServeOverload`, spent budgets
:class:`DeadlineExceeded`, unknown tenants ``SpecError``; an engine-floor
failure re-raises after the hedge: a request is answered, refused or failed
loudly, never hung.
"""

from __future__ import annotations

import binascii
import dataclasses
import functools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from sketches_tpu_torch import faults, integrity, resilience, telemetry, tracing
from sketches_tpu_torch.analysis import registry
from sketches_tpu_torch.resilience import (
    QUERY_LADDER,
    DeadlineExceeded,
    ServeOverload,
    SketchError,
    SpecError,
    SketchValueError,
)

__all__ = [
    "ServeConfig",
    "Ticket",
    "ServeResult",
    "SketchServer",
    "ServeOverload",
    "DeadlineExceeded",
]

#: Non-floor ladder rungs a circuit breaker may open; the ``xla`` floor
#: is the answer of last resort and never opens.
_BREAKABLE_TIERS = QUERY_LADDER[:-1]
_FLOOR_TIER = QUERY_LADDER[-1]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-envelope knobs (all bounded, all declared).

    ``max_queue_depth`` / ``tenant_quota`` bound the admission queue
    (overflow sheds with ``ServeOverload``; admitted requests are never
    evicted).  ``default_deadline_s`` is the per-request budget when the
    caller passes none; a request with less than ``floor_margin_s``
    remaining at flush skips to the floor tier.  ``hedge_after_s`` is
    the straggler threshold for hedged retries.  ``breaker_threshold``
    consecutive failures open a tier's breaker for ``breaker_cooldown``
    dispatches before the half-open probe.  ``cache_capacity`` bounds
    the result cache (LRU past capacity; 0 disables it outright).
    Invalid (non-positive) bounds raise ``SpecError``.
    """

    max_queue_depth: int = 256
    tenant_quota: int = 64
    default_deadline_s: float = 0.25
    floor_margin_s: float = 0.02
    hedge_after_s: float = 0.05
    breaker_threshold: int = 3
    breaker_cooldown: int = 8
    cache_capacity: int = 4096

    def __post_init__(self):
        if self.max_queue_depth <= 0 or self.tenant_quota <= 0:
            raise SpecError("queue depth and tenant quota must be positive")
        if self.default_deadline_s <= 0:
            raise SpecError("default_deadline_s must be positive")
        if self.breaker_threshold <= 0 or self.breaker_cooldown <= 0:
            raise SpecError("breaker threshold/cooldown must be positive")
        if self.cache_capacity < 0:
            raise SpecError("cache_capacity must be non-negative")


@dataclasses.dataclass
class Ticket:
    """One admitted (or cache-answered) quantile request.

    ``deadline`` is absolute serving-clock seconds; ``result`` is
    filled by the admission cache hit or the next :meth:`flush` --
    ``None`` until then.  A shed request never gets a ticket (admission
    raises instead).  ``trace`` is the request's root
    :class:`~sketches_tpu_torch.tracing.TraceContext` (None while the flight
    recorder is disarmed): the id that links this request to its span
    events, histogram exemplars, and forensic bundles.
    """

    id: int
    tenant: str
    qs: Tuple[float, ...]
    deadline: float
    submitted_at: float
    result: Optional["ServeResult"] = None
    trace: Optional[Any] = None


@dataclasses.dataclass
class ServeResult:
    """One answered request: per-stream values for the requested
    quantiles (``[n_streams, Q]``, NaN for empty streams), the engine
    ``tier`` that answered (``cache`` for hits), and the robustness
    accounting -- ``hedged`` (a hedge dispatch was issued),
    ``deadline_missed`` (answered after the budget; the answer is still
    exact, the miss is counted)."""

    values: np.ndarray
    tier: str
    hedged: bool = False
    deadline_missed: bool = False

    @property
    def cached(self) -> bool:
        return self.tier == "cache"


class _Breaker:
    """One engine tier's circuit breaker (request-count cooldown -- no
    wall clock, so a failing sequence replays exactly).

    closed --(``threshold`` consecutive failures)--> open
    open --(``cooldown`` skipped dispatches)--> half_open
    half_open --(probe success)--> closed; --(probe failure)--> open
    """

    __slots__ = ("threshold", "cooldown", "failures", "state", "cooldown_left")

    def __init__(self, threshold: int, cooldown: int):
        self.threshold = threshold
        self.cooldown = cooldown
        self.failures = 0
        self.state = "closed"
        self.cooldown_left = 0

    def blocks(self) -> bool:
        """Whether this dispatch must skip the tier (advances cooldown)."""
        if self.state == "open":
            self.cooldown_left -= 1
            if self.cooldown_left <= 0:
                self.state = "half_open"
            return True
        return False  # closed and half_open both allow (probe) traffic

    def record_success(self) -> None:
        self.failures = 0
        self.state = "closed"

    def record_failure(self) -> bool:
        """Count a failure -> True iff the breaker (re-)opened."""
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.threshold:
            self.state = "open"
            self.cooldown_left = self.cooldown
            self.failures = 0
            return True
        return False


class _CacheEntry:
    __slots__ = ("fp", "values", "tier", "checksum")

    def __init__(self, fp: np.ndarray, values: np.ndarray, tier: str):
        self.fp = fp
        self.values = values
        self.tier = tier
        self.checksum = _payload_checksum(fp, values)


def _payload_checksum(fp: np.ndarray, values: np.ndarray) -> int:
    """Content checksum binding a cached payload to its fingerprint
    (crc32 over both byte images; any single-bit rot in either fails
    re-verification).  Never raises on well-formed arrays."""
    crc = binascii.crc32(np.ascontiguousarray(fp).tobytes())
    return binascii.crc32(np.ascontiguousarray(values).tobytes(), crc)


def _host(values) -> np.ndarray:
    """A dispatch's answer as a host array (tensors leave their device)."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def _on_card(facade) -> bool:
    """Whether a tenant's dispatch runs the card's kernels: there only an
    armed fault is hedged (``resilience.survivable``), a kernel error
    raises."""
    return _facade_device(facade).type == "cuda"


def _facade_device(facade) -> torch.device:
    """Where a tenant's state lives (a mesh-sharded tenant: the mesh's
    first device, where its fold lands)."""
    dev = getattr(facade, "device", None)
    return dev if dev is not None else facade.mesh.devices[0]


class _Tenant:
    __slots__ = ("name", "facade", "version", "fp_cache")

    def __init__(self, name: str, facade):
        self.name = name
        self.facade = facade
        self.version = 0  # bumped on every server-mediated write
        self.fp_cache: Optional[Tuple[int, np.ndarray, bytes]] = None


class SketchServer:
    """The multi-tenant serving facade (module docstring for the full
    envelope: admission/shedding, deadlines, hedging, breakers, cache).

    Writes MUST go through :meth:`ingest`/:meth:`merge` (or be followed
    by :meth:`invalidate`): the result cache keys on content
    fingerprints that the server memoizes per tenant write-version, so
    a write behind the server's back would serve stale (but
    detectable: the live-fingerprint re-verification quarantines such
    entries on the next hit).  Unknown tenants raise ``SpecError``;
    shed requests raise ``ServeOverload``; spent deadline budgets raise
    ``DeadlineExceeded``.  Thread-safe for submit/flush under one lock
    (dispatches serialize -- the device is one resource).
    """

    def __init__(
        self,
        config: Optional[ServeConfig] = None,
        *,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.config = config or ServeConfig()
        self._clock = clock if clock is not None else telemetry.clock
        self._tenants: Dict[str, _Tenant] = {}
        self._queue: List[Ticket] = []
        self._pending_per_tenant: Dict[str, int] = {}
        self._next_id = 0
        self._lock = threading.RLock()
        # Kill switches: read once (registry discipline); disarmed cost
        # is one bool test per query / dispatch.
        self._cache_enabled = (
            registry.enabled(registry.SERVE_CACHE)
            and self.config.cache_capacity > 0
        )
        self._hedge_enabled = registry.enabled(registry.SERVE_HEDGE)
        self._cache: "Dict[Tuple[str, bytes, Tuple[float, ...]], _CacheEntry]" = {}
        self._cache_order: List[Tuple[str, bytes, Tuple[float, ...]]] = []
        self._breakers: Dict[str, _Breaker] = {}
        self._fused_fns: Dict[Any, Any] = {}
        self._stats: Dict[str, float] = {
            "requests": 0, "shed": 0, "deadline_misses": 0, "hedges": 0,
            "cache_hits": 0, "cache_misses": 0, "cache_poisoned": 0,
            "dispatches": 0, "fused_dispatches": 0, "breaker_trips": 0,
        }

    # -- tenancy ----------------------------------------------------------

    def add_tenant(
        self, name: str, n_streams: int, *, mesh=None, value_axis=None,
        stream_axis=None, window=None, **kwargs,
    ):
        """Register tenant ``name`` with its own isolated facade (and
        therefore its own ``SketchSpec``) -> the facade.

        ``kwargs`` pass through to ``BatchedDDSketch`` (``spec=``,
        ``relative_accuracy=``, ``n_bins=``, ...).  Passing any of
        ``mesh``/``value_axis``/``stream_axis`` instead builds a
        mesh-sharded ``DistributedDDSketch`` tenant -- the elastic
        fleet behind the serving tier; its read path (fingerprints,
        fused dispatch, the breaker/deadline tier exclusions) is
        API-identical, and :meth:`reshard_tenant` can later resize its
        mesh live without poisoning the cache.  Passing ``window=``
        (``True`` for the default 5s -> 1m -> 1h ladder, or a
        ``sketches_tpu_torch.windows.WindowConfig``) backs the tenant with a
        :class:`~sketches_tpu_torch.windows.WindowedSketch` on the serving
        clock: time-scoped reads then go through :meth:`quantile` with
        ``window=...`` (the queued :meth:`submit` path refuses windowed
        tenants loudly), writes ride :meth:`ingest` unchanged, and
        ``SKETCHES_TPU_WINDOWED=0`` refuses at registration.
        Re-registering an existing name raises ``SpecError`` -- tenant
        state is never silently replaced.
        """
        with self._lock:
            if name in self._tenants:
                raise SpecError(f"tenant {name!r} already registered")
            if window is not None:
                from sketches_tpu_torch.windows import WindowConfig, WindowedSketch

                config = None if window is True else window
                if config is not None and not isinstance(
                    config, WindowConfig
                ):
                    raise SpecError(
                        "window= takes True (default ladder) or a"
                        f" WindowConfig; got {type(window).__name__}"
                    )
                facade = WindowedSketch(
                    n_streams, config=config, clock=self._clock,
                    mesh=mesh, value_axis=value_axis,
                    stream_axis=stream_axis, **kwargs,
                )
            elif mesh is not None or value_axis is not None \
                    or stream_axis is not None:
                from sketches_tpu_torch.parallel import (
                    DistributedDDSketch,
                    SketchMesh,
                )

                if isinstance(mesh, SketchMesh):
                    # The layout already names its axes; honor them
                    # unless the caller overrode explicitly.
                    if value_axis is None and stream_axis is None:
                        value_axis = mesh.value_axis
                        stream_axis = mesh.stream_axis
                elif value_axis is None and stream_axis is None:
                    value_axis = "values"
                facade = DistributedDDSketch(
                    n_streams, mesh=mesh, value_axis=value_axis,
                    stream_axis=stream_axis, **kwargs,
                )
            else:
                # Per-tenant accuracy/memory contract: the spec's
                # backend picks the facade class (dense BatchedDDSketch,
                # uniform_collapse AdaptiveDDSketch, or moment
                # MomentDDSketch) -- mixed-backend fleets serve
                # correctly because cache keys are fingerprint-derived
                # and fused groups key on the (backend-carrying) spec.
                _backend = getattr(
                    kwargs.get("spec"), "backend",
                    kwargs.get("backend", "dense"),
                )
                if _backend != "dense":
                    from sketches_tpu_torch.backends import facade_for

                    facade = facade_for(n_streams, **kwargs)
                else:
                    from sketches_tpu_torch.batched import BatchedDDSketch

                    kwargs.pop("backend", None)
                    facade = BatchedDDSketch(n_streams, **kwargs)
            self._tenants[name] = _Tenant(name, facade)
            return facade

    def reshard_tenant(
        self, name: str, mesh=None, n_devices: Optional[int] = None,
        *, live_mask=None,
    ):
        """Resize a distributed tenant's mesh LIVE -- the tenant
        survives the reshard -> its ``ReshardReport``.

        Wraps :meth:`DistributedDDSketch.reshard` under the serving
        lock (no request observes a half-resharded tenant).  Because
        content fingerprints are topology-free, a clean reshard (no
        dead shards) leaves every cached ``(tenant, fingerprint, q)``
        entry VALID -- the cache survives, no recompute storm; a
        reshard that dropped mass (dead shards/hosts) changed content,
        so the tenant's write version bumps and the stale fingerprint
        is released (old entries then miss naturally).  Raises
        ``SpecError`` for a batched (non-distributed) tenant, an
        unknown tenant, or when ``SKETCHES_TPU_ELASTIC=0``; a failed
        reshard (torn, all shards dead) raises and leaves the tenant
        untouched on its old mesh.
        """
        from sketches_tpu_torch.parallel import DistributedDDSketch

        with self._lock:
            t = self._tenant(name)
            if not isinstance(t.facade, DistributedDDSketch):
                raise SpecError(
                    f"tenant {name!r} is not mesh-sharded; only"
                    " DistributedDDSketch tenants reshard"
                )
            new_facade, report = t.facade.reshard(
                mesh=mesh, n_devices=n_devices, live_mask=live_mask
            )
            t.facade = new_facade
            if report.n_dead:
                # Dead shards dropped mass: the content (and so the
                # fingerprint) changed -- stale cache entries must miss.
                t.version += 1
                t.fp_cache = None
            if tracing._ACTIVE:
                tracing.record_event(
                    "serve.reshard", tenant=name,
                    from_devices=report.from_devices,
                    to_devices=report.to_devices,
                    n_dead=report.n_dead, exact=report.exact,
                )
            return report

    def tenant(self, name: str):
        """The named tenant's facade (raises ``SpecError`` if unknown)."""
        with self._lock:
            return self._tenant(name).facade

    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            raise SpecError(f"unknown tenant {name!r}")
        return t

    # -- write path -------------------------------------------------------

    def ingest(self, name: str, values, weights=None) -> None:
        """Ingest a batch into tenant ``name`` (write path).

        Bumps the tenant's write version, so cached fingerprints (and
        therefore cached results) invalidate naturally -- the next read
        recomputes.  Ingest failures degrade/raise exactly as the
        facade's engine ladder does.
        """
        with self._lock:
            t = self._tenant(name)
            t.facade.add(values, weights)
            t.version += 1
            t.fp_cache = None
            if tracing._ACTIVE:
                tracing.record_event("serve.write", tenant=name, op="ingest")

    def merge(self, name: str, other) -> None:
        """Fold another ``BatchedDDSketch`` into tenant ``name`` (write
        path; same invalidation discipline as :meth:`ingest`).  Unequal
        specs raise ``UnequalSketchParametersError``."""
        with self._lock:
            t = self._tenant(name)
            t.facade.merge(other)
            t.version += 1
            t.fp_cache = None
            if tracing._ACTIVE:
                tracing.record_event("serve.write", tenant=name, op="merge")

    def invalidate(self, name: str) -> None:
        """Drop tenant ``name``'s memoized fingerprint after an
        out-of-band write to its facade (raises ``SpecError`` when the
        tenant is unknown).  Without this, stale entries are still
        caught -- the hit-time live-fingerprint re-verification
        quarantines them -- but at hit-time cost."""
        with self._lock:
            t = self._tenant(name)
            t.version += 1
            t.fp_cache = None

    # -- fingerprints & cache --------------------------------------------

    def _fingerprint(self, t: _Tenant) -> Tuple[np.ndarray, bytes]:
        """Tenant content fingerprint (memoized per write version)."""
        cached = t.fp_cache
        if cached is not None and cached[0] == t.version:
            return cached[1], cached[2]
        fp = integrity.fingerprint(t.facade.spec, t.facade.state)
        digest = np.ascontiguousarray(fp).tobytes()
        t.fp_cache = (t.version, fp, digest)
        return fp, digest

    def _cache_get(
        self, t: _Tenant, qs: Tuple[float, ...], ctx=None
    ) -> Optional[np.ndarray]:
        """Cache lookup with poison detection -> values (a defensive
        copy) or None.  A hit is re-verified (live fingerprint + payload
        checksum); a mismatch quarantines the entry, counts it, dumps a
        forensic bundle naming the poisoned entry (recorder armed), and
        reads as a miss -- the request recomputes."""
        fp, digest = self._fingerprint(t)
        key = (t.name, digest, qs)
        entry = self._cache.get(key)
        if entry is None:
            return None
        if faults._ACTIVE:
            flip = faults.cache_poison_flip(entry.values.nbytes)
            if flip is not None:
                # The armed adversary: silent rot in the cached payload.
                buf = np.ascontiguousarray(entry.values).copy()
                view = buf.view(np.uint8).reshape(-1)
                view[flip[0]] ^= np.uint8(1 << flip[1])
                entry.values = buf
        live_ok = entry.fp.shape == fp.shape and bool(
            np.array_equal(entry.fp, fp)
        )
        sum_ok = entry.checksum == _payload_checksum(entry.fp, entry.values)
        if not (live_ok and sum_ok):
            self._quarantine(key, ctx=ctx)
            return None
        # LRU touch.
        try:
            self._cache_order.remove(key)
        except ValueError:  # pragma: no cover - defensive
            pass
        self._cache_order.append(key)
        return entry.values.copy()

    def _quarantine(self, key, ctx=None) -> None:
        self._cache.pop(key, None)
        try:
            self._cache_order.remove(key)
        except ValueError:
            pass
        self._stats["cache_poisoned"] += 1
        resilience.bump("serve.cache_poisoned")
        if telemetry._ACTIVE:
            telemetry.counter_inc("serve.cache.poisoned")
        if tracing._ACTIVE:
            # A poisoned cache entry is silent-corruption evidence: name
            # the entry and dump the forensic picture around it.
            entry_name = {
                "tenant": key[0],
                "quantiles": ",".join(f"{q:g}" for q in key[2]),
                "fingerprint": key[1].hex()[:16],
            }
            tracing.record_event(
                "serve.cache.poisoned", ctx=ctx, **entry_name
            )
            tracing.dump_forensics(
                "serve.cache_poison", trace=ctx, detail=entry_name
            )

    def _cache_put(
        self, t: _Tenant, qs: Tuple[float, ...], fp: np.ndarray,
        digest: bytes, values: np.ndarray, tier: str,
    ) -> None:
        key = (t.name, digest, qs)
        if key not in self._cache:
            self._cache_order.append(key)
        self._cache[key] = _CacheEntry(fp, values, tier)
        while len(self._cache_order) > self.config.cache_capacity:
            old = self._cache_order.pop(0)
            self._cache.pop(old, None)

    # -- admission --------------------------------------------------------

    def _shed(self, tenant: str, reason: str, ctx=None) -> None:
        self._stats["shed"] += 1
        resilience.bump("serve.shed")
        if telemetry._ACTIVE:
            telemetry.counter_inc("serve.shed", reason=reason)
        if tracing._ACTIVE:
            tracing.record_event(
                "serve.shed", ctx=ctx, tenant=tenant, reason=reason
            )
        raise ServeOverload(
            f"request for tenant {tenant!r} shed at admission ({reason})",
            reason=reason, tenant=tenant,
        )

    def submit(
        self,
        name: str,
        quantiles: Sequence[float],
        deadline_s: Optional[float] = None,
    ) -> Ticket:
        """Admit one quantile request -> a :class:`Ticket`.

        A cache hit answers immediately (``ticket.result`` set, no
        queue slot consumed).  Otherwise admission applies the declared
        shed order -- injected-overflow fault, then tenant quota, then
        global depth -- and a refused request raises
        :class:`ServeOverload` (structured ``reason``); a deadline
        budget that is already non-positive raises
        :class:`DeadlineExceeded`.  Admitted requests are never
        evicted; :meth:`flush` answers them.  With the flight recorder
        armed every request roots a trace context (``ticket.trace``)
        and its admission decisions become recorder events; a
        ``SketchError`` escaping admission that is NOT one of the two
        structured refusals auto-dumps a forensic bundle before
        re-raising.
        """
        qs = tuple(sorted(float(q) for q in quantiles))
        if not qs:
            raise SketchValueError("a request needs at least one quantile")
        try:
            return self._submit_admitted(name, qs, deadline_s)
        except (ServeOverload, DeadlineExceeded):
            raise  # the structured refusals: handled, not forensic
        except SketchError as e:
            if tracing._ACTIVE:
                tracing.dump_forensics(
                    "serve.submit",
                    detail={"tenant": name, "error": repr(e)},
                )
            raise

    def _submit_admitted(
        self,
        name: str,
        qs: Tuple[float, ...],
        deadline_s: Optional[float],
    ) -> Ticket:
        """:meth:`submit` body (admission under the lock); split out so
        the caller can wrap it in the forensic-dump net.  Raises exactly
        as :meth:`submit` documents."""
        with self._lock:
            t = self._tenant(name)
            if self._is_windowed(t):
                raise SpecError(
                    f"tenant {name!r} is time-windowed: query it with"
                    " quantile(tenant, qs, window=...) -- the queued"
                    " submit/flush path has no window semantics"
                )
            self._stats["requests"] += 1
            now = self._clock()
            _trc = tracing.new_trace() if tracing._ACTIVE else None
            if telemetry._ACTIVE:
                telemetry.counter_inc("serve.requests")
            budget = (
                self.config.default_deadline_s
                if deadline_s is None else float(deadline_s)
            )
            if _trc is not None:
                tracing.record_event(
                    "serve.submit", ctx=_trc, tenant=name,
                    qs=",".join(f"{q:g}" for q in qs), budget_s=budget,
                )
            if budget <= 0:
                self._stats["deadline_misses"] += 1
                resilience.bump("serve.deadline_misses")
                if telemetry._ACTIVE:
                    telemetry.counter_inc("serve.deadline_misses")
                if _trc is not None:
                    tracing.record_event(
                        "serve.deadline_spent", ctx=_trc, tenant=name,
                        budget_s=budget,
                    )
                raise DeadlineExceeded(
                    f"request for tenant {name!r} arrived with a spent"
                    f" deadline budget ({budget:g}s)"
                )
            ticket = Ticket(
                id=self._next_id, tenant=name, qs=qs,
                deadline=now + budget, submitted_at=now, trace=_trc,
            )
            self._next_id += 1
            if self._cache_enabled:
                values = self._cache_get(t, qs, ctx=_trc)
                if values is not None:
                    self._stats["cache_hits"] += 1
                    if _trc is not None:
                        tracing.record_event(
                            "serve.cache.hit", ctx=_trc, tenant=name
                        )
                    if telemetry._ACTIVE:
                        telemetry.counter_inc("serve.cache.hits")
                        telemetry.observe(
                            "serve.request_s", self._clock() - now,
                            trace=_trc, source="cache",
                        )
                    ticket.result = ServeResult(values=values, tier="cache")
                    return ticket
                self._stats["cache_misses"] += 1
                if _trc is not None:
                    tracing.record_event(
                        "serve.cache.miss", ctx=_trc, tenant=name
                    )
                if telemetry._ACTIVE:
                    telemetry.counter_inc("serve.cache.misses")
            if faults._ACTIVE:
                try:
                    faults.inject(faults.SERVE_QUEUE_OVERFLOW)
                except SketchError:
                    self._shed(name, "injected", ctx=_trc)
            if self._pending_per_tenant.get(name, 0) >= self.config.tenant_quota:
                self._shed(name, "tenant_quota", ctx=_trc)
            if len(self._queue) >= self.config.max_queue_depth:
                self._shed(name, "queue_depth", ctx=_trc)
            self._queue.append(ticket)
            self._pending_per_tenant[name] = (
                self._pending_per_tenant.get(name, 0) + 1
            )
            if telemetry._ACTIVE:
                telemetry.gauge_set("serve.queue_depth", len(self._queue))
            return ticket

    # -- dispatch ---------------------------------------------------------

    def _breaker(self, tier: str) -> _Breaker:
        b = self._breakers.get(tier)
        if b is None:
            b = self._breakers[tier] = _Breaker(
                self.config.breaker_threshold, self.config.breaker_cooldown
            )
        return b

    def breaker_state(self, tier: str) -> str:
        """The named tier's breaker state (``closed`` when it has never
        failed; unknown tiers raise ``SpecError``)."""
        if tier not in QUERY_LADDER:
            raise SpecError(f"unknown engine tier {tier!r}")
        with self._lock:
            b = self._breakers.get(tier)
            return b.state if b is not None else "closed"

    def _breaker_failure(self, tier: str) -> None:
        if tier not in _BREAKABLE_TIERS:
            return
        if self._breaker(tier).record_failure():
            self._stats["breaker_trips"] += 1
            resilience.record_downgrade(
                "serve.breaker", tier, "open", "circuit breaker tripped"
            )
            if telemetry._ACTIVE:
                telemetry.counter_inc("serve.breaker.trips", tier=tier)
            if tracing._ACTIVE:
                tracing.record_event(
                    "serve.breaker", tier=tier, state="open"
                )

    def _blocked_tiers(self) -> frozenset:
        blocked = set()
        for tier, b in self._breakers.items():
            if b.blocks():
                blocked.add(tier)
        return frozenset(blocked)

    def _hedge(self, t: _Tenant, qs: Tuple[float, ...]) -> np.ndarray:
        """The hedge dispatch: the facade's ``xla`` floor
        (``kernels.floor_quantile``, K2 on the card) -- pure, so idempotent
        with the primary by construction.  A floor failure re-raises
        (nothing cheaper exists)."""
        self._stats["hedges"] += 1
        resilience.bump("serve.hedges")
        if telemetry._ACTIVE:
            telemetry.counter_inc("serve.hedges", tier=_FLOOR_TIER)
        if tracing._ACTIVE:
            tracing.record_event("serve.hedge", tier=_FLOOR_TIER)
        _, values = t.facade.get_quantile_values_resolved(
            qs, disabled_tiers=_BREAKABLE_TIERS
        )
        return _host(values)

    def _dispatch_tenant(
        self, t: _Tenant, qs: Tuple[float, ...], force_floor: bool
    ) -> Tuple[str, np.ndarray, bool]:
        """One tenant's fused dispatch through the robustness envelope
        -> ``(tier, values, hedged)``.  Stragglers (injected or slower
        than ``hedge_after_s``) are hedged on the floor tier when
        hedging is enabled; with hedging disabled a straggler's failure
        re-raises to the caller."""
        disabled = self._blocked_tiers()
        if force_floor:
            disabled = disabled | frozenset(_BREAKABLE_TIERS)
        # Resolve the tier first (plan fetch, memoized) so the armed
        # straggler site can target one rung, then dispatch on it.
        tier = t.facade._query_choice(qs, disabled)[0]
        t0 = self._clock()
        try:
            if faults._ACTIVE:
                faults.inject(faults.SERVE_STRAGGLER, tier=tier)
            tier, values = t.facade.get_quantile_values_resolved(
                qs, disabled_tiers=disabled
            )
        except SketchError as e:
            self._breaker_failure(tier)
            if not self._hedge_enabled or not resilience.survivable(e, _on_card(t.facade)):
                raise
            resilience.record_downgrade(
                "serve.dispatch", tier, _FLOOR_TIER, f"hedged: {e!r}"
            )
            return _FLOOR_TIER, self._hedge(t, qs), True
        elapsed = self._clock() - t0
        values = _host(values)
        if (
            self._hedge_enabled
            and tier != _FLOOR_TIER
            and elapsed > self.config.hedge_after_s
        ):
            # The primary straggled but completed: issue the hedge it
            # would have raced and discard the loser.  Query purity
            # makes both answers bit-identical, so discarding is safe
            # by construction (asserted, not assumed).
            self._breaker_failure(tier)
            hedged_values = self._hedge(t, qs)
            if not np.array_equal(
                hedged_values, values, equal_nan=True
            ):  # pragma: no cover - purity violation
                raise SketchError(
                    "hedge dispatch disagreed with its primary: query"
                    " purity violated"
                )
            return tier, values, True
        self._breaker_success(tier)
        return tier, values, False

    def _breaker_success(self, tier: str) -> None:
        b = self._breakers.get(tier)
        if b is not None:
            b.record_success()

    def _fused_quantile(self, spec):
        """The stacked dispatch's decode for ``spec``, memoized per spec:
        the ``xla`` floor (K2 on the card for dense and adaptive states,
        level-corrected for adaptive ones), or the moment backend's host
        solve."""
        fn = self._fused_fns.get(spec)
        if fn is None:
            backend = getattr(spec, "backend", "dense")
            if backend == "moment":
                from sketches_tpu_torch.backends.moment import quantile as _mq

                # Host maxent solve: the stacking still answers every
                # same-spec tenant in one call.
                fn = functools.partial(_mq, spec)
            else:
                from sketches_tpu_torch.windows import _dense_quantile

                fn = functools.partial(_dense_quantile, spec)
            self._fused_fns[spec] = fn
        return fn

    def _dispatch_group(
        self, tenants: List[_Tenant], qs: Tuple[float, ...]
    ) -> Tuple[str, List[np.ndarray], bool]:
        """Cross-tenant fused dispatch: stack the group's states leaf by
        leaf and answer every tenant in ONE call of the ``xla`` floor (no
        breaker applies) -> ``(tier, per-tenant values, hedged)``.  An
        injected straggler hedges by re-running the same pure dispatch."""
        states = [t.facade.state for t in tenants]
        stacked = type(states[0]).cat(states)
        fn = self._fused_quantile(tenants[0].facade.spec)
        hedged = False
        try:
            if faults._ACTIVE:
                faults.inject(faults.SERVE_STRAGGLER, tier=_FLOOR_TIER)
            out = _host(fn(stacked, qs))
        except SketchError as e:
            if not self._hedge_enabled or not resilience.survivable(
                e, _on_card(tenants[0].facade)
            ):
                raise
            self._stats["hedges"] += 1
            resilience.bump("serve.hedges")
            if telemetry._ACTIVE:
                telemetry.counter_inc("serve.hedges", tier=_FLOOR_TIER)
            if tracing._ACTIVE:
                tracing.record_event("serve.hedge", tier=_FLOOR_TIER)
            out = _host(fn(stacked, qs))
            hedged = True
        rows: List[np.ndarray] = []
        lo = 0
        for t in tenants:
            hi = lo + t.facade.n_streams
            rows.append(out[lo:hi])
            lo = hi
        return _FLOOR_TIER, rows, hedged

    # -- flush ------------------------------------------------------------

    def flush(self) -> Dict[int, ServeResult]:
        """Drain the admission queue and answer every admitted request
        -> ``{ticket id: result}`` (tickets' ``result`` fields are
        filled too).

        Requests fold per tenant into one fused multi-quantile dispatch
        (the union of their quantiles); tenants sharing a spec fold
        further into one stacked cross-tenant device call.  Requests
        within ``floor_margin_s`` of their deadline force the floor
        tier; answers landing past a deadline are returned but counted
        (``serve.deadline_misses``).  An empty queue returns ``{}``.
        Dispatch failures below the hedge/ladder floor re-raise.
        """
        with self._lock:
            batch, self._queue = self._queue, []
            self._pending_per_tenant = {}
            if telemetry._ACTIVE:
                telemetry.gauge_set("serve.queue_depth", 0)
            if not batch:
                return {}
            # Fold requests per tenant: one fused dispatch each.
            per_tenant: Dict[str, List[Ticket]] = {}
            for tk in batch:
                per_tenant.setdefault(tk.tenant, []).append(tk)
            plans: List[Tuple[_Tenant, Tuple[float, ...], List[Ticket], bool]] = []
            now = self._clock()
            for name, tickets in per_tenant.items():
                t = self._tenant(name)
                union = tuple(sorted({q for tk in tickets for q in tk.qs}))
                near = any(
                    tk.deadline - now < self.config.floor_margin_s
                    for tk in tickets
                )
                plans.append((t, union, tickets, near))
            # Tenants sharing (spec, quantile union, no floor forcing
            # needed -- the fused path IS the floor) stack into one
            # cross-tenant device dispatch.
            groups: Dict[Any, List[int]] = {}
            for i, (t, union, _tks, _near) in enumerate(plans):
                key = (t.facade.spec, union, str(_facade_device(t.facade)))
                groups.setdefault(key, []).append(i)
            out: Dict[int, ServeResult] = {}
            for key, idxs in groups.items():
                _spec, union, _dev = key
                t0 = self._clock()
                # Dispatch under a child of the first traced ticket's
                # context, so the engine-tier span (and the psum fold /
                # wire spans under it) link into the request's trace.
                _dctx = None
                if tracing._ACTIVE:
                    _primary = next(
                        (tk.trace for i in idxs for tk in plans[i][2]
                         if tk.trace is not None),
                        None,
                    )
                    if _primary is not None:
                        _dctx = tracing.child_span(_primary)
                _tok = tracing.bind(_dctx) if _dctx is not None else None
                try:
                    if len(idxs) > 1:
                        tenants = [plans[i][0] for i in idxs]
                        tier, rows, hedged = self._dispatch_group(
                            tenants, union
                        )
                        self._stats["fused_dispatches"] += 1
                        results = list(zip(idxs, rows))
                    else:
                        i = idxs[0]
                        t, union, _tks, near = plans[i]
                        tier, values, hedged = self._dispatch_tenant(
                            t, union, force_floor=near
                        )
                        results = [(i, values)]
                finally:
                    if _tok is not None:
                        tracing.unbind(_tok)
                self._stats["dispatches"] += 1
                if telemetry._ACTIVE:
                    telemetry.observe(
                        "serve.batch_s", self._clock() - t0, trace=_dctx,
                        tier=tier,
                    )
                for i, values in results:
                    t, _union, tickets, _near = plans[i]
                    if self._cache_enabled:
                        fp, digest = self._fingerprint(t)
                        self._cache_put(t, union, fp, digest, values, tier)
                    done = self._clock()
                    cols = {q: j for j, q in enumerate(union)}
                    for tk in tickets:
                        sel = [cols[q] for q in tk.qs]
                        missed = done > tk.deadline
                        if missed:
                            self._stats["deadline_misses"] += 1
                            resilience.bump("serve.deadline_misses")
                            if telemetry._ACTIVE:
                                telemetry.counter_inc("serve.deadline_misses")
                        tk.result = ServeResult(
                            values=values[:, sel], tier=tier, hedged=hedged,
                            deadline_missed=missed,
                        )
                        out[tk.id] = tk.result
                        if tk.trace is not None and tracing._ACTIVE:
                            tracing.record_event(
                                "serve.dispatch", ctx=tk.trace,
                                tenant=tk.tenant, tier=tier, hedged=hedged,
                                fused=len(idxs) > 1,
                                dispatch_span=(
                                    _dctx.span_hex if _dctx is not None
                                    else None
                                ),
                            )
                            if missed:
                                tracing.record_event(
                                    "serve.deadline_miss", ctx=tk.trace,
                                    tenant=tk.tenant,
                                )
                        if telemetry._ACTIVE:
                            telemetry.observe(
                                "serve.request_s", done - tk.submitted_at,
                                trace=tk.trace, source="dispatch",
                            )
            return out

    @staticmethod
    def _is_windowed(t: _Tenant) -> bool:
        # Cheap structural probe (no import unless windows is loaded):
        # WindowedSketch is the only facade carrying a window_plan.
        return hasattr(t.facade, "window_plan")

    def quantile(
        self,
        name: str,
        quantiles: Sequence[float],
        window: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> ServeResult:
        """``quantile(tenant, qs, window=W)``: the time-scoped read --
        "p99 over the last W seconds" -> a :class:`ServeResult`.

        For a windowed tenant the answer is ONE fused stacked-merge
        dispatch over the buckets covering ``[now - W, now)``
        (``window=None`` covers the whole retained horizon), cached
        under ``(tenant, covered-bucket fingerprint-set digest, qs)``:
        a rotation or an ingest changes the covered set's fingerprints,
        so stale entries MISS -- they can never serve a stale-wrong
        window (hits are re-verified against the live fingerprint +
        payload checksum and poisoned entries quarantine exactly like
        the unwindowed cache).  For a plain tenant ``window`` must be
        None (``SpecError``) and the call is :meth:`query`.  Spent
        deadline budgets raise :class:`DeadlineExceeded`; late answers
        are returned but counted; unknown tenants raise ``SpecError``.
        """
        qs = tuple(sorted(float(q) for q in quantiles))
        with self._lock:
            t = self._tenant(name)
            if not self._is_windowed(t):
                if window is not None:
                    raise SpecError(
                        f"tenant {name!r} is not time-windowed: register it"
                        " with add_tenant(..., window=...) to serve"
                        " window-scoped quantiles"
                    )
                return self.query(name, quantiles, deadline_s)
            if not qs:
                raise SketchValueError(
                    "a request needs at least one quantile"
                )
            self._stats["requests"] += 1
            now = self._clock()
            _trc = tracing.new_trace() if tracing._ACTIVE else None
            if telemetry._ACTIVE:
                telemetry.counter_inc("serve.requests")
            budget = (
                self.config.default_deadline_s
                if deadline_s is None else float(deadline_s)
            )
            if budget <= 0:
                self._stats["deadline_misses"] += 1
                resilience.bump("serve.deadline_misses")
                if telemetry._ACTIVE:
                    telemetry.counter_inc("serve.deadline_misses")
                raise DeadlineExceeded(
                    f"window query for tenant {name!r} arrived with a"
                    f" spent deadline budget ({budget:g}s)"
                )
            plan = t.facade.window_plan(window)
            fp = plan.fingerprint
            digest = plan.digest
            key = (t.name, digest, qs)
            if self._cache_enabled:
                entry = self._cache.get(key)
                if entry is not None:
                    if faults._ACTIVE:
                        flip = faults.cache_poison_flip(entry.values.nbytes)
                        if flip is not None:
                            buf = np.ascontiguousarray(entry.values).copy()
                            view = buf.view(np.uint8).reshape(-1)
                            view[flip[0]] ^= np.uint8(1 << flip[1])
                            entry.values = buf
                    live_ok = entry.fp.shape == fp.shape and bool(
                        np.array_equal(entry.fp, fp)
                    )
                    sum_ok = entry.checksum == _payload_checksum(
                        entry.fp, entry.values
                    )
                    if live_ok and sum_ok:
                        self._stats["cache_hits"] += 1
                        if _trc is not None:
                            tracing.record_event(
                                "serve.cache.hit", ctx=_trc, tenant=name
                            )
                        if telemetry._ACTIVE:
                            telemetry.counter_inc("serve.cache.hits")
                            telemetry.observe(
                                "serve.request_s", self._clock() - now,
                                trace=_trc, source="cache",
                            )
                        return ServeResult(
                            values=entry.values.copy(), tier="cache"
                        )
                    self._quarantine(key, ctx=_trc)
                self._stats["cache_misses"] += 1
                if telemetry._ACTIVE:
                    telemetry.counter_inc("serve.cache.misses")
            values = _host(t.facade.query_plan(plan, qs))
            self._stats["dispatches"] += 1
            if self._cache_enabled:
                if key not in self._cache:
                    self._cache_order.append(key)
                self._cache[key] = _CacheEntry(fp, values, "window")
                while len(self._cache_order) > self.config.cache_capacity:
                    old = self._cache_order.pop(0)
                    self._cache.pop(old, None)
            done = self._clock()
            missed = done > now + budget
            if missed:
                self._stats["deadline_misses"] += 1
                resilience.bump("serve.deadline_misses")
                if telemetry._ACTIVE:
                    telemetry.counter_inc("serve.deadline_misses")
            if _trc is not None:
                tracing.record_event(
                    "serve.dispatch", ctx=_trc, tenant=name,
                    tier="window", hedged=False,
                    covered=plan.n_covered,
                )
            if telemetry._ACTIVE:
                telemetry.observe(
                    "serve.request_s", done - now, trace=_trc,
                    source="dispatch",
                )
            return ServeResult(
                values=values, tier="window", deadline_missed=missed
            )

    def quantile_many(
        self,
        names: Sequence[str],
        quantiles: Sequence[float],
        window: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> Dict[str, "ServeResult"]:
        """The windowed twin of the flush path's same-spec stacking:
        answer ``quantile(qs, window=W)`` for MANY windowed tenants,
        folding each tenant's maintained window components to one state
        and stacking same-spec tenants into ONE fused quantile dispatch
        -> ``{tenant: ServeResult}``.

        Every tenant keeps its own cache entry under the existing
        ``(tenant, covered-bucket digest, qs)`` key -- hits are
        re-verified (poisoned entries quarantine) and misses fill the
        cache, so a later single-tenant :meth:`quantile` hits the entry
        this call wrote (the answers are bit-identical: the per-tenant
        fold is the same maintained component chain, pinned by test).
        Non-windowed tenants raise ``SpecError``; empty ``names``
        answers ``{}``; spent deadline budgets raise
        :class:`DeadlineExceeded`; late answers are returned but
        counted once per tenant.
        """
        qs = tuple(sorted(float(q) for q in quantiles))
        if not qs:
            raise SketchValueError("a request needs at least one quantile")
        names = list(names)
        if not names:
            return {}
        from sketches_tpu_torch.windows import _fold_mode, _fold_state_for

        with self._lock:
            tenants = [self._tenant(n) for n in names]
            for t in tenants:
                if not self._is_windowed(t):
                    raise SpecError(
                        f"tenant {t.name!r} is not time-windowed:"
                        " quantile_many serves windowed tenants only"
                    )
            now = self._clock()
            self._stats["requests"] += len(names)
            if telemetry._ACTIVE:
                telemetry.counter_inc("serve.requests", float(len(names)))
            budget = (
                self.config.default_deadline_s
                if deadline_s is None else float(deadline_s)
            )
            if budget <= 0:
                self._stats["deadline_misses"] += len(names)
                resilience.bump("serve.deadline_misses", len(names))
                if telemetry._ACTIVE:
                    telemetry.counter_inc(
                        "serve.deadline_misses", float(len(names))
                    )
                raise DeadlineExceeded(
                    "window query batch arrived with a spent deadline"
                    f" budget ({budget:g}s)"
                )
            out: Dict[str, ServeResult] = {}
            misses: List[Tuple[Any, Any, Tuple, np.ndarray]] = []
            for t in tenants:
                plan = t.facade.window_plan(window)
                fp = plan.fingerprint
                key = (t.name, plan.digest, qs)
                if self._cache_enabled:
                    entry = self._cache.get(key)
                    if entry is not None:
                        if faults._ACTIVE:
                            flip = faults.cache_poison_flip(
                                entry.values.nbytes
                            )
                            if flip is not None:
                                buf = np.ascontiguousarray(
                                    entry.values
                                ).copy()
                                view = buf.view(np.uint8).reshape(-1)
                                view[flip[0]] ^= np.uint8(1 << flip[1])
                                entry.values = buf
                        live_ok = entry.fp.shape == fp.shape and bool(
                            np.array_equal(entry.fp, fp)
                        )
                        sum_ok = entry.checksum == _payload_checksum(
                            entry.fp, entry.values
                        )
                        if live_ok and sum_ok:
                            self._stats["cache_hits"] += 1
                            if telemetry._ACTIVE:
                                telemetry.counter_inc("serve.cache.hits")
                            out[t.name] = ServeResult(
                                values=entry.values.copy(), tier="cache"
                            )
                            continue
                        self._quarantine(key, ctx=None)
                    self._stats["cache_misses"] += 1
                    if telemetry._ACTIVE:
                        telemetry.counter_inc("serve.cache.misses")
                misses.append((t, plan, key, fp))
            # Same-spec miss groups: fold each tenant's maintained
            # components to ONE state, stack along the stream axis, and
            # decode every tenant in one fused quantile dispatch.
            groups: Dict[Any, List[int]] = {}
            for i, (t, plan, _key, _fp) in enumerate(misses):
                if not plan.states:
                    self._fill_window_result(
                        t, plan, _key, _fp, qs,
                        np.full(
                            (t.facade.n_streams, len(qs)), np.nan, np.float32
                        ),
                        out,
                    )
                    continue
                key = (t.facade.spec, str(t.facade.device))
                groups.setdefault(key, []).append(i)
            for (spec, _dev), idxs in groups.items():
                if len(idxs) == 1:
                    t, plan, key, fp = misses[idxs[0]]
                    values = _host(t.facade.query_plan(plan, qs))
                    self._stats["dispatches"] += 1
                    self._fill_window_result(
                        t, plan, key, fp, qs, values, out
                    )
                    continue
                folded = []
                for i in idxs:
                    t, plan, _key, _fp = misses[i]
                    if plan.components is not None:
                        # Share the ring's per-digest folded-window
                        # cache: a repeat stacking on unchanged plans
                        # contributes zero merges to the fused dispatch.
                        folded.append(t.facade._agg_fold(plan))
                        continue
                    comps = plan.states
                    if len(comps) == 1:
                        folded.append(comps[0])
                    else:
                        mode = _fold_mode(spec, comps)
                        folded.append(_fold_state_for(spec)[mode](comps))
                stacked = type(folded[0]).cat(folded)
                fn = self._fused_quantile(spec)
                try:
                    if faults._ACTIVE:
                        faults.inject(
                            faults.SERVE_STRAGGLER, tier=_FLOOR_TIER
                        )
                    rows = _host(fn(stacked, qs))
                except SketchError as e:
                    if not self._hedge_enabled or not resilience.survivable(
                        e, stacked.device.type == "cuda"
                    ):
                        raise
                    self._stats["hedges"] += 1
                    resilience.bump("serve.hedges")
                    if telemetry._ACTIVE:
                        telemetry.counter_inc(
                            "serve.hedges", tier=_FLOOR_TIER
                        )
                    rows = _host(fn(stacked, qs))
                self._stats["dispatches"] += 1
                self._stats["fused_dispatches"] += 1
                lo = 0
                for i in idxs:
                    t, plan, key, fp = misses[i]
                    hi = lo + t.facade.n_streams
                    self._fill_window_result(
                        t, plan, key, fp, qs, rows[lo:hi].copy(), out
                    )
                    lo = hi
            done = self._clock()
            missed = done > now + budget
            if missed:
                self._stats["deadline_misses"] += len(names)
                resilience.bump("serve.deadline_misses", len(names))
                if telemetry._ACTIVE:
                    telemetry.counter_inc(
                        "serve.deadline_misses", float(len(names))
                    )
                for r in out.values():
                    if r.tier != "cache":
                        r.deadline_missed = True
            if telemetry._ACTIVE:
                for t in tenants:
                    telemetry.observe(
                        "serve.request_s", done - now,
                        source=(
                            "cache" if out[t.name].tier == "cache"
                            else "dispatch"
                        ),
                    )
            return out

    def _fill_window_result(
        self, t, plan, key, fp, qs, values, out
    ) -> None:
        """Cache-fill + result-build shared by the quantile_many paths
        (single-tenant fallback, empty coverage, fused rows)."""
        if self._cache_enabled:
            if key not in self._cache:
                self._cache_order.append(key)
            self._cache[key] = _CacheEntry(fp, values, "window")
            while len(self._cache_order) > self.config.cache_capacity:
                old = self._cache_order.pop(0)
                self._cache.pop(old, None)
        out[t.name] = ServeResult(values=values, tier="window")

    def query(
        self,
        name: str,
        quantiles: Sequence[float],
        deadline_s: Optional[float] = None,
    ) -> ServeResult:
        """Submit-and-flush convenience for the synchronous caller ->
        the request's :class:`ServeResult`.

        Shed requests raise :class:`ServeOverload`; spent budgets raise
        :class:`DeadlineExceeded`; everything the batch path counts
        (hedges, deadline misses, cache hits) is counted here too.
        Concurrent callers' queued requests flush in the same pass --
        batching is cooperative, not per-caller.
        """
        ticket = self.submit(name, quantiles, deadline_s)
        if ticket.result is not None:  # cache hit at admission
            return ticket.result
        self.flush()
        assert ticket.result is not None  # flush answers every admitted ticket
        return ticket.result

    # -- introspection ----------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Always-on serving counters (requests, shed, hedges, cache
        hits/misses/poisoned, deadline misses, dispatches, breaker
        trips) -- a copy; zeros mean nothing failed yet.  The armed
        telemetry layer mirrors these under the declared ``serve.*``
        metric names."""
        with self._lock:
            out = dict(self._stats)
            out["queue_depth"] = len(self._queue)
            out["tenants"] = len(self._tenants)
            out["cache_entries"] = len(self._cache)
            return out

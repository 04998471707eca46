"""Sharded serve fabric: replicated, failover-safe multi-process serving
(PyTorch port of ``sketches_tpu/fabric.py``).

One :class:`~sketches_tpu_torch.serve.SketchServer` is one process -- one
process death takes every tenant down.  The fabric scales the serving
tier to a fleet of virtual hosts and survives host loss and partitions
with ZERO wrong answers, leaning on the property that makes DDSketch
replication sound: full mergeability.  A read replica is just a fold of
the primary's state shipped over the existing wire seam, so a replica
read carries the same alpha contract as a primary read -- the only new
failure mode is *staleness*, and staleness is declared, bounded, and
fingerprint-verified rather than silent.

Placement
    ``tenant -> hosts`` by rendezvous (highest-random-weight) hashing:
    every host is scored ``crc32(tenant "@host" i)`` and the tenant's
    copies live on the top-``replication`` scorers (first = primary).
    Deterministic (any process computes the same placement from the
    tenant name alone), and minimal-movement: killing a host re-homes
    only that host's tenants, onto the next-ranked survivors.

Replica sync protocol
    ``sync()`` serializes the primary's state through
    ``backends.wirefmt`` (the same seam checkpoints and cross-host
    shipping use), decodes it into the replica host's facade, and
    LEDGERS the sync point: the replica's content fingerprint
    (:func:`sketches_tpu_torch.integrity.fingerprint` -- topology-free,
    merge-additive), its per-stream synced mass, the primary's write
    version, and the serving-clock sync time.  A decode failure or a
    fingerprint that disagrees with the primary aborts the sync and
    keeps the previous (still-consistent) replica.

Staleness contract
    Each tenant declares ``staleness_s``.  A replica serves ONLY when
    (a) its live fingerprint matches its ledgered sync fingerprint
    (anything else is stale-WRONG: the replica refuses loudly with
    :class:`~sketches_tpu_torch.resilience.ReplicaStale` and the read
    re-homes -- a mismatched replica never serves), and (b) its sync
    lag is within the declared bound.  Partitioned primaries degrade
    reads to declared-staleness replica reads instead of errors;
    writes to a partitioned primary refuse loudly
    (:class:`~sketches_tpu_torch.resilience.FabricUnavailable`) rather than
    fork the stream.

Failover accounting invariant
    When a host dies, each of its primary tenants re-homes onto the
    best surviving replica, and the mass ledger closes EXACTLY::

        dropped_count == expected_count - promoted_replica_synced_count

    per stream (unit weights make counts integer-valued; the equality
    is ``==``, never approximate).  The dropped mass is itemized in the
    tenant's ledger and the promoted replica's fingerprint is verified
    against its sync ledger before promotion -- a stale-wrong replica
    is skipped (and recorded), never promoted.  Every failover,
    handoff, and heal decision lands in the flight recorder with its
    triggering snapshot (:func:`sketches_tpu_torch.tracing.dump_forensics`).

Cache discipline
    The fabric keeps a small result cache keyed on ``(tenant, content
    fingerprint digest, qs)`` with a payload checksum, exactly like the
    serving tier's.  Fingerprints are topology-free, so cache entries
    survive clean replica handoffs and failovers whose content is
    unchanged -- no recompute storm on rebalance.

Every virtual host is a ``SketchServer`` in this process; a tenant's
copies live on its primary's device (the card unless registered with
``device="cpu"``), so a replica read runs the same kernels a primary read
does.

Kill switch: ``SKETCHES_TPU_FABRIC=0`` refuses fabric construction
loudly (``SpecError``); plain single-process serving is unaffected.
Fault sites: ``fabric.replica_stale`` (silent replica corruption, the
fingerprint lane's adversary), ``mesh.partition_heal`` (a heal torn
between reconciliation and the un-partition commit; the host must stay
partitioned, never half-healed), plus ``reshard.torn`` at the handoff
seam and ``wire.blob`` on sync payloads.
"""

from __future__ import annotations

import binascii
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from sketches_tpu_torch import faults, integrity, resilience, telemetry, tracing
from sketches_tpu_torch.analysis import registry
from sketches_tpu_torch.resilience import (
    FabricUnavailable,
    ReplicaStale,
    SketchValueError,
    SpecError,
)
from sketches_tpu_torch.serve import ServeConfig, SketchServer

__all__ = [
    "FabricConfig",
    "FabricResult",
    "FailoverReport",
    "HandoffReport",
    "ServeFabric",
    "ReplicaStale",
    "FabricUnavailable",
    "placement",
]


def _rendezvous_score(tenant: str, host: int) -> int:
    return binascii.crc32(f"{tenant}@host{host}".encode()) & 0xFFFFFFFF


def placement(tenant: str, n_hosts: int, replication: int) -> Tuple[int, ...]:
    """Deterministic tenant placement -> hosts ranked by rendezvous
    score (first = primary, rest = replicas).

    Highest-random-weight hashing over the host ids: any process with
    the tenant name and the host count computes the same ranking, and
    removing a host re-ranks ONLY that host's tenants (minimal
    movement -- the property that makes failover re-homing cheap).
    ``replication`` caps the returned prefix at ``n_hosts`` copies.
    Raises ``SketchValueError`` for a non-positive fleet or factor.
    """
    if n_hosts <= 0:
        raise SketchValueError("a fabric needs at least one host")
    if replication <= 0:
        raise SketchValueError("replication must be positive")
    ranked = sorted(
        range(n_hosts), key=lambda h: (-_rendezvous_score(tenant, h), h)
    )
    return tuple(ranked[: min(replication, n_hosts)])


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Fleet shape + serving knobs.

    ``replication`` counts TOTAL copies (primary included), clipped to
    the fleet size.  ``staleness_s`` is the default per-tenant bound a
    replica read may lag the primary's ledgered state;
    ``add_tenant(..., staleness_s=)`` overrides per tenant.
    ``serve_config`` seeds every virtual host's ``SketchServer``.
    ``cache_capacity`` sizes the fabric-level fingerprint-keyed result
    cache (0 disables it).  Non-positive host/replication counts and
    negative bounds raise ``SketchValueError`` at construction --
    a fleet shape that cannot serve is refused, never clamped.
    """

    n_hosts: int = 2
    replication: int = 2
    staleness_s: float = 30.0
    cache_capacity: int = 128
    serve_config: Optional[ServeConfig] = None

    def __post_init__(self):
        if self.n_hosts <= 0:
            raise SketchValueError("a fabric needs at least one host")
        if self.replication <= 0:
            raise SketchValueError("replication must be positive")
        if self.staleness_s < 0:
            raise SketchValueError("staleness_s must be non-negative")
        if self.cache_capacity < 0:
            raise SketchValueError("cache_capacity must be non-negative")


@dataclasses.dataclass
class FabricResult:
    """One answered fabric read: per-stream values for the requested
    quantiles, which ``host`` answered and in what ``role``
    (``primary`` / ``replica`` / ``cache``), the observed replica
    ``staleness_s`` (0 for primary answers), and the robustness
    accounting -- ``degraded`` (a partition forced a declared-staleness
    replica read), ``hedged`` (the answer came from a cross-host hedge
    after the primary dispatch failed)."""

    values: np.ndarray
    tier: str
    role: str
    host: int
    staleness_s: float = 0.0
    degraded: bool = False
    hedged: bool = False

    @property
    def cached(self) -> bool:
        return self.role == "cache"


@dataclasses.dataclass(frozen=True)
class FailoverReport:
    """One tenant re-homed after a host loss: the exact per-stream mass
    the dead primary held beyond the promoted replica's ledgered sync
    (``dropped_count``; ``exact`` is the ledger-closure check), plus
    any replicas that were SKIPPED because their fingerprint mismatched
    their sync ledger (the booby-trap firing during failover)."""

    tenant: str
    from_host: int
    to_host: int
    dropped_count: np.ndarray
    exact: bool
    fingerprint_hex: str
    refused_replicas: Tuple[int, ...] = ()

    @property
    def dropped_total(self) -> float:
        return float(self.dropped_count.sum())


@dataclasses.dataclass(frozen=True)
class HandoffReport:
    """One replica moved between hosts over the wire seam: the content
    fingerprint is topology-free, so ``fingerprint_hex`` is identical
    before and after a clean handoff and every fabric cache entry keyed
    on it survives (``cache_preserved``)."""

    tenant: str
    from_host: int
    to_host: int
    fingerprint_hex: str
    cache_preserved: bool


class _ReplicaLedger:
    """The sync-point record for one (tenant, host) replica: what the
    replica MUST still fingerprint to (digest), the exact per-stream
    mass it held at sync, and when/at which write version it synced."""

    __slots__ = ("digest", "synced_count", "synced_version", "synced_at")

    def __init__(self, digest: bytes, synced_count: np.ndarray,
                 synced_version: int, synced_at: float):
        self.digest = digest
        self.synced_count = synced_count
        self.synced_version = synced_version
        self.synced_at = synced_at


class _Host:
    """One virtual serving process: its own SketchServer, liveness, and
    the replica ledgers for the copies it holds."""

    __slots__ = ("server", "alive", "partitioned", "replicas")

    def __init__(self, server: SketchServer):
        self.server = server
        self.alive = True
        self.partitioned = False
        self.replicas: Dict[str, _ReplicaLedger] = {}


class _TenantMeta:
    """Fabric-side tenant bookkeeping: placement, the exact mass
    ledger, and the memoized primary fingerprint."""

    __slots__ = (
        "name", "spec", "device", "n_streams", "staleness_s", "hosts",
        "version", "expected_count", "dropped_count", "fp_memo",
    )

    def __init__(self, name: str, spec, device, n_streams: int,
                 staleness_s: float, hosts: Tuple[int, ...]):
        self.name = name
        self.spec = spec
        self.device = device
        self.n_streams = n_streams
        self.staleness_s = staleness_s
        self.hosts = list(hosts)
        self.version = 0
        self.expected_count = np.zeros(n_streams, np.float64)
        self.dropped_count = np.zeros(n_streams, np.float64)
        self.fp_memo: Optional[Tuple[int, np.ndarray, bytes]] = None


def _host_f64(x) -> np.ndarray:
    """A batch (or its weights) as a host f64 array, wherever it lies."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _payload_checksum(digest: bytes, values: np.ndarray) -> int:
    payload = digest + np.ascontiguousarray(values).tobytes()
    return binascii.crc32(payload) & 0xFFFFFFFF


class _CacheEntry:
    __slots__ = ("values", "checksum")

    def __init__(self, digest: bytes, values: np.ndarray):
        self.values = values
        self.checksum = _payload_checksum(digest, values)


class ServeFabric:
    """The sharded serving fleet (module docstring for the placement /
    sync / staleness / failover contracts).

    Writes go through :meth:`ingest` (routed to the tenant's primary
    host); reads through :meth:`quantile` (primary first, cross-host
    hedge onto a fingerprint-verified replica when the primary dispatch
    fails, declared-staleness replica reads when the primary is
    partitioned).  Operational verbs: :meth:`sync` (replica refresh),
    :meth:`kill_host` (failover drill), :meth:`partition_host` /
    :meth:`heal_partition`, :meth:`handoff_replica` (rebalancing).
    Unknown tenants raise ``SpecError``; a fabric with
    ``SKETCHES_TPU_FABRIC=0`` refuses construction loudly.  Thread-safe
    under one lock (the fleet is virtual; dispatches serialize).
    """

    def __init__(
        self,
        config: Optional[FabricConfig] = None,
        *,
        clock: Optional[Callable[[], float]] = None,
    ):
        if not registry.enabled(registry.FABRIC):
            raise SpecError(
                "the sharded serve fabric is disabled"
                " (SKETCHES_TPU_FABRIC=0): refusing to construct a"
                " ServeFabric -- unset the kill switch or serve from a"
                " single-process SketchServer"
            )
        self.config = config or FabricConfig()
        self._clock = clock if clock is not None else telemetry.clock
        self._hosts = [
            _Host(SketchServer(self.config.serve_config, clock=self._clock))
            for _ in range(self.config.n_hosts)
        ]
        self._tenants: Dict[str, _TenantMeta] = {}
        self._cache: Dict[Tuple[str, bytes, Tuple[float, ...]], _CacheEntry] = {}
        self._cache_order: List[Tuple[str, bytes, Tuple[float, ...]]] = []
        self._lock = threading.RLock()
        self._stats: Dict[str, float] = {
            "requests": 0, "primary_reads": 0, "replica_reads": 0,
            "degraded_reads": 0, "cache_hits": 0, "hedges": 0,
            "replica_syncs": 0, "sync_aborts": 0, "failovers": 0,
            "handoffs": 0, "stale_refusals": 0, "heals": 0,
        }

    # -- placement --------------------------------------------------------

    @property
    def n_hosts(self) -> int:
        with self._lock:
            return len(self._hosts)

    def placement(self, name: str) -> Tuple[int, ...]:
        """The tenant's CURRENT copy set (primary first).  Reflects
        failovers and handoffs, unlike the pure :func:`placement`
        function it started from."""
        with self._lock:
            return tuple(self._meta(name).hosts)

    def live_hosts(self) -> Tuple[int, ...]:
        """Hosts that are alive AND reachable (not partitioned)."""
        with self._lock:
            return tuple(
                i for i, h in enumerate(self._hosts)
                if h.alive and not h.partitioned
            )

    def _meta(self, name: str) -> _TenantMeta:
        m = self._tenants.get(name)
        if m is None:
            raise SpecError(f"unknown fabric tenant {name!r}")
        return m

    # -- tenancy ----------------------------------------------------------

    def add_tenant(
        self, name: str, n_streams: int, *,
        staleness_s: Optional[float] = None, **kwargs,
    ):
        """Place tenant ``name`` on its rendezvous hosts and provision
        its primary + replicas -> the primary facade.

        ``kwargs`` pass through to the primary host's
        ``SketchServer.add_tenant`` (``spec=``, ``relative_accuracy=``,
        ...); windowed and mesh-sharded tenants are refused for now
        (replication ships dense folds over the wire seam).  Placement
        skips dead/partitioned hosts at registration.  Re-registering
        raises ``SpecError``.
        """
        if kwargs.get("window") is not None or kwargs.get("mesh") is not None:
            raise SpecError(
                "fabric tenants replicate dense folds: windowed and"
                " mesh-sharded tenants are not replicable yet --"
                " register them on a single SketchServer"
            )
        with self._lock:
            if name in self._tenants:
                raise SpecError(f"fabric tenant {name!r} already registered")
            ranked = placement(name, self.n_hosts, self.config.replication)
            usable = [
                h for h in ranked
                if self._hosts[h].alive and not self._hosts[h].partitioned
            ]
            if not usable:
                raise FabricUnavailable(
                    f"no live host to place tenant {name!r} on"
                )
            primary = usable[0]
            facade = self._hosts[primary].server.add_tenant(
                name, n_streams, **kwargs
            )
            bound = (
                self.config.staleness_s
                if staleness_s is None else float(staleness_s)
            )
            if bound < 0:
                raise SketchValueError("staleness_s must be non-negative")
            meta = _TenantMeta(
                name, facade.spec, facade.device, n_streams, bound, usable
            )
            self._tenants[name] = meta
            for h in usable[1:]:
                self._provision_replica(meta, h)
            if tracing._ACTIVE:
                tracing.record_event(
                    "fabric.place", tenant=name, primary=primary,
                    replicas=str(tuple(usable[1:])),
                )
            return facade

    def _register_or_reuse(self, host: int, meta: _TenantMeta):
        """The replica facade on ``host`` (registering it on that
        host's server the first time; hosts that held this tenant in a
        past epoch reuse the registration -- tenant state is then
        REPLACED through the sync path, never merged)."""
        server = self._hosts[host].server
        try:
            return server.tenant(meta.name)
        except SpecError:
            return server.add_tenant(
                meta.name, meta.n_streams, spec=meta.spec, device=meta.device
            )

    def _provision_replica(self, meta: _TenantMeta, host: int) -> None:
        self._register_or_reuse(host, meta)
        self._sync_replica(meta, host)

    # -- fingerprints -----------------------------------------------------

    def _primary_fingerprint(self, meta: _TenantMeta) -> Tuple[np.ndarray, bytes]:
        """The primary's ledgered content fingerprint (memoized per
        write version -- the state every replica must converge to)."""
        memo = meta.fp_memo
        if memo is not None and memo[0] == meta.version:
            return memo[1], memo[2]
        facade = self._hosts[meta.hosts[0]].server.tenant(meta.name)
        fp = integrity.fingerprint(meta.spec, facade.state)
        digest = np.ascontiguousarray(fp).tobytes()
        meta.fp_memo = (meta.version, fp, digest)
        return fp, digest

    @staticmethod
    def _live_digest(meta: _TenantMeta, facade) -> bytes:
        fp = integrity.fingerprint(meta.spec, facade.state)
        return np.ascontiguousarray(fp).tobytes()

    # -- write path -------------------------------------------------------

    def ingest(self, name: str, values, weights=None) -> None:
        """Ingest a batch into the tenant's PRIMARY (write path).

        Updates the exact mass ledger from the finite values in the
        batch.  A partitioned primary refuses the write loudly
        (``FabricUnavailable``) -- the stream must not fork; a dead
        primary means a failover is pending and also refuses.
        """
        with self._lock:
            meta = self._meta(name)
            primary = self._hosts[meta.hosts[0]]
            if not primary.alive:
                raise FabricUnavailable(
                    f"tenant {name!r}: primary host {meta.hosts[0]} is"
                    " dead and not yet re-homed; run kill_host/failover"
                )
            if primary.partitioned:
                raise FabricUnavailable(
                    f"tenant {name!r}: primary host {meta.hosts[0]} is"
                    " partitioned; writes refuse rather than fork the"
                    " stream (reads degrade to declared-staleness"
                    " replicas)"
                )
            primary.server.ingest(name, values, weights)
            vals = _host_f64(values)
            finite = np.isfinite(vals)
            if weights is None:
                added = finite.sum(axis=-1).astype(np.float64)
            else:
                w = np.broadcast_to(
                    _host_f64(weights), vals.shape
                )
                added = np.where(finite, w, 0.0).sum(axis=-1)
            meta.expected_count = meta.expected_count + np.broadcast_to(
                added, meta.expected_count.shape
            )
            meta.version += 1
            meta.fp_memo = None

    # -- replica sync -----------------------------------------------------

    def sync(self, name: Optional[str] = None) -> int:
        """Refresh replicas from their primaries over the wire seam ->
        the number of replicas synced (one tenant, or every tenant with
        ``name=None``).  Dead/partitioned endpoints are skipped; an
        aborted sync (corrupt payload, fingerprint disagreement) keeps
        the previous consistent replica and is counted, never silent."""
        with self._lock:
            names = [name] if name is not None else list(self._tenants)
            n = 0
            for nm in names:
                meta = self._meta(nm)
                primary = self._hosts[meta.hosts[0]]
                if not primary.alive or primary.partitioned:
                    continue
                for h in meta.hosts[1:]:
                    host = self._hosts[h]
                    if host.alive and not host.partitioned:
                        if self._sync_replica(meta, h):
                            n += 1
            return n

    def _sync_replica(self, meta: _TenantMeta, host_id: int) -> bool:
        """Ship the primary's fold to one replica and ledger the sync
        point.  Returns False (replica untouched) on an aborted sync."""
        from sketches_tpu_torch.backends.wirefmt import (
            payload_from_bytes,
            payload_to_bytes,
        )

        primary_facade = self._hosts[meta.hosts[0]].server.tenant(meta.name)
        blobs = payload_to_bytes(meta.spec, primary_facade.state)
        if faults._ACTIVE:
            blobs = [
                faults.inject(faults.WIRE_BLOB, b, index=i)
                for i, b in enumerate(blobs)
            ]
        try:
            state = payload_from_bytes(meta.spec, blobs, device=meta.device)
        except resilience.WireDecodeError:
            self._stats["sync_aborts"] += 1
            resilience.bump("fabric.sync_aborts")
            if tracing._ACTIVE:
                tracing.record_event(
                    "fabric.sync_abort", tenant=meta.name, host=host_id,
                    reason="wire_decode",
                )
            return False
        # The wire decode NORMALIZES the window (canonical key_offset),
        # so the primary's fingerprint and the replica's agree within
        # float-summation rounding, not bitwise; the LEDGERED digest is
        # the replica's own canonical fingerprint -- decode is a fixed
        # point, so every later gate (serve-time verify, handoff,
        # promotion) compares it bit-exactly.
        fp_want, _ = self._primary_fingerprint(meta)
        fp_got = integrity.fingerprint(meta.spec, state)
        if not ServeFabric._fp_close(fp_got, fp_want):
            # The wire round-trip did not reproduce the primary's
            # content: never ledger a sync point the replica cannot
            # fingerprint back to.
            self._stats["sync_aborts"] += 1
            resilience.bump("fabric.sync_aborts")
            if tracing._ACTIVE:
                tracing.record_event(
                    "fabric.sync_abort", tenant=meta.name, host=host_id,
                    reason="fingerprint",
                )
            return False
        got_digest = np.ascontiguousarray(fp_got).tobytes()
        host = self._hosts[host_id]
        facade = self._register_or_reuse(host_id, meta)
        facade.state = state
        host.server.invalidate(meta.name)
        host.replicas[meta.name] = _ReplicaLedger(
            got_digest, meta.expected_count.copy(), meta.version,
            float(self._clock()),
        )
        self._stats["replica_syncs"] += 1
        if telemetry._ACTIVE:
            telemetry.counter_inc("fabric.replica_syncs")
        if tracing._ACTIVE:
            tracing.record_event(
                "fabric.replica_sync", tenant=meta.name, host=host_id,
                version=meta.version, digest=got_digest.hex()[:16],
            )
        return True

    @staticmethod
    def _digest_of(spec, state) -> bytes:
        fp = integrity.fingerprint(spec, state)
        return np.ascontiguousarray(fp).tobytes()

    @staticmethod
    def _fp_close(got: np.ndarray, want: np.ndarray) -> bool:
        """Cross-representation fingerprint agreement: the integrity
        layer's tolerance (the window-normalizing wire decode reorders
        the float summation; content equality survives, bit equality
        does not)."""
        tol = integrity._FP_ATOL + integrity._FP_RTOL * np.abs(want)
        return bool(np.all(np.abs(got - want) <= tol))

    # -- fabric cache -----------------------------------------------------

    def _cache_get(
        self, name: str, digest: bytes, qs: Tuple[float, ...]
    ) -> Optional[np.ndarray]:
        if self.config.cache_capacity <= 0:
            return None
        entry = self._cache.get((name, digest, qs))
        if entry is None:
            return None
        if entry.checksum != _payload_checksum(digest, entry.values):
            # Bit-rotted entry: quarantine, recompute downstream.
            self._cache.pop((name, digest, qs), None)
            return None
        self._stats["cache_hits"] += 1
        return entry.values

    def _cache_put(
        self, name: str, digest: bytes, qs: Tuple[float, ...],
        values: np.ndarray,
    ) -> None:
        if self.config.cache_capacity <= 0:
            return
        key = (name, digest, qs)
        if key not in self._cache:
            self._cache_order.append(key)
            while len(self._cache_order) > self.config.cache_capacity:
                evicted = self._cache_order.pop(0)
                self._cache.pop(evicted, None)
        self._cache[key] = _CacheEntry(digest, values)

    # -- read path --------------------------------------------------------

    def quantile(
        self, name: str, quantiles: Sequence[float],
        deadline_s: Optional[float] = None,
    ) -> FabricResult:
        """The fabric read: primary first, cross-host hedge onto a
        fingerprint-verified replica when the primary dispatch fails,
        declared-staleness replica reads when the primary is
        partitioned or dead -> a :class:`FabricResult`.

        Admission refusals (``ServeOverload`` / ``DeadlineExceeded``)
        propagate -- shedding is a declared answer, not a failover
        trigger.  A replica whose fingerprint mismatches its sync
        ledger NEVER serves (:class:`ReplicaStale`, re-homed); when no
        copy can serve, :class:`FabricUnavailable` (or the last
        ``ReplicaStale`` when refusals were the only obstacle).
        """
        qs = tuple(sorted(float(q) for q in quantiles))
        if not qs:
            raise SketchValueError("a request needs at least one quantile")
        with self._lock:
            meta = self._meta(name)
            self._stats["requests"] += 1
            primary_id = meta.hosts[0]
            primary = self._hosts[primary_id]
            if primary.alive and not primary.partitioned:
                _, digest = self._primary_fingerprint(meta)
                cached = self._cache_get(name, digest, qs)
                if cached is not None:
                    return FabricResult(
                        values=cached, tier="cache", role="cache",
                        host=primary_id,
                    )
                try:
                    res = primary.server.query(name, qs, deadline_s)
                except (resilience.ServeOverload,
                        resilience.DeadlineExceeded):
                    raise
                except Exception as e:
                    # Cross-host hedge: the primary's whole engine
                    # ladder (serve's own hedge included) failed --
                    # re-issue against a verified replica.
                    self._stats["hedges"] += 1
                    if telemetry._ACTIVE:
                        telemetry.counter_inc("fabric.hedge_cross_host")
                    if tracing._ACTIVE:
                        tracing.record_event(
                            "fabric.hedge", tenant=name,
                            primary=primary_id, error=repr(e),
                        )
                    out = self._read_replicas(meta, qs, degraded=False)
                    return dataclasses.replace(out, hedged=True)
                self._stats["primary_reads"] += 1
                self._cache_put(name, digest, qs, res.values)
                return FabricResult(
                    values=res.values, tier=res.tier, role="primary",
                    host=primary_id, hedged=res.hedged,
                )
            # Primary unreachable: a dead primary should have been
            # re-homed by kill_host; re-home lazily if it was not.  A
            # partitioned primary degrades to declared-staleness
            # replica reads.
            if not primary.alive:
                self._failover_locked(meta)
                return self.quantile(name, qs, deadline_s)
            return self._read_replicas(meta, qs, degraded=True)

    def _read_replicas(
        self, meta: _TenantMeta, qs: Tuple[float, ...], *, degraded: bool
    ) -> FabricResult:
        """Serve from the first replica that passes the fingerprint and
        staleness gates, re-homing past refusals."""
        last_refusal: Optional[ReplicaStale] = None
        for host_id in meta.hosts[1:]:
            host = self._hosts[host_id]
            if not host.alive or host.partitioned:
                continue
            ledger = host.replicas.get(meta.name)
            if ledger is None:
                continue
            facade = host.server.tenant(meta.name)
            if faults._ACTIVE:
                flips = faults.replica_stale_flips(
                    meta.n_streams, meta.spec.n_bins
                )
                if flips:
                    # The adversary silently corrupts the stored
                    # replica -- no version bump, no announcement; only
                    # the fingerprint gate below can catch it.
                    facade.state = faults.apply_state_bitflips(
                        facade.state, flips
                    )
            live = self._live_digest(meta, facade)
            if live != ledger.digest:
                self._stats["stale_refusals"] += 1
                resilience.bump("fabric.replica_stale_refusals")
                if tracing._ACTIVE:
                    tracing.record_event(
                        "fabric.replica_refused", tenant=meta.name,
                        host=host_id, reason="fingerprint",
                    )
                last_refusal = ReplicaStale(
                    f"replica of {meta.name!r} on host {host_id} does"
                    " not fingerprint to its ledgered sync state:"
                    " refusing to serve (re-homing the read)",
                    reason="fingerprint", tenant=meta.name,
                )
                continue
            staleness = max(0.0, float(self._clock()) - ledger.synced_at)
            if staleness > meta.staleness_s:
                self._stats["stale_refusals"] += 1
                resilience.bump("fabric.replica_stale_refusals")
                if tracing._ACTIVE:
                    tracing.record_event(
                        "fabric.replica_refused", tenant=meta.name,
                        host=host_id, reason="staleness",
                        staleness_s=staleness,
                    )
                last_refusal = ReplicaStale(
                    f"replica of {meta.name!r} on host {host_id} is"
                    f" {staleness:.3f}s stale, beyond the declared"
                    f" {meta.staleness_s:.3f}s bound: refusing to serve",
                    reason="staleness", tenant=meta.name,
                )
                continue
            cached = self._cache_get(meta.name, ledger.digest, qs)
            if cached is not None:
                values = cached
                tier = "cache"
            else:
                res = host.server.query(meta.name, qs)
                values = res.values
                tier = res.tier
                self._cache_put(meta.name, ledger.digest, qs, values)
            self._stats["replica_reads"] += 1
            if degraded:
                self._stats["degraded_reads"] += 1
            _trc = tracing.new_trace() if tracing._ACTIVE else None
            if telemetry._ACTIVE:
                telemetry.observe(
                    "fabric.staleness_s", staleness, trace=_trc,
                    tenant=meta.name,
                )
            if tracing._ACTIVE:
                tracing.record_event(
                    "fabric.replica_read", ctx=_trc, tenant=meta.name,
                    host=host_id, staleness_s=staleness,
                    degraded=degraded,
                )
            return FabricResult(
                values=values, tier=tier, role="replica", host=host_id,
                staleness_s=staleness, degraded=degraded,
            )
        if last_refusal is not None:
            raise last_refusal
        raise FabricUnavailable(
            f"tenant {meta.name!r}: no live copy can serve (primary"
            " unreachable, no fingerprint-verified replica in bound)"
        )

    # -- failover ---------------------------------------------------------

    def kill_host(self, host_id: int) -> List[FailoverReport]:
        """Kill a virtual host -> the failover reports for every tenant
        it was primary for.

        Each such tenant re-homes onto its best surviving
        fingerprint-verified replica with the dropped mass itemized
        exactly in its ledger; the host's REPLICA copies are simply
        dropped (their primaries re-provision on the next sync).  Every
        decision lands in the flight recorder with its triggering
        snapshot.
        """
        with self._lock:
            if not (0 <= host_id < self.n_hosts):
                raise SketchValueError(f"no host {host_id}")
            host = self._hosts[host_id]
            if not host.alive:
                return []
            host.alive = False
            host.partitioned = False
            host.replicas.clear()
            reports = []
            for meta in self._tenants.values():
                if host_id in meta.hosts[1:]:
                    meta.hosts.remove(host_id)
                    self._restore_replication(meta)
            for meta in list(self._tenants.values()):
                if meta.hosts and meta.hosts[0] == host_id:
                    reports.append(self._failover_locked(meta))
            return reports

    def _failover_locked(self, meta: _TenantMeta) -> FailoverReport:
        """Promote the best verified replica of a dead-primary tenant;
        close the mass ledger exactly."""
        dead = meta.hosts[0]
        refused: List[int] = []
        chosen: Optional[int] = None
        for host_id in meta.hosts[1:]:
            host = self._hosts[host_id]
            if not host.alive or host.partitioned:
                continue
            ledger = host.replicas.get(meta.name)
            if ledger is None:
                continue
            facade = host.server.tenant(meta.name)
            if self._live_digest(meta, facade) != ledger.digest:
                # Stale-WRONG replica: never promoted, loudly recorded.
                refused.append(host_id)
                self._stats["stale_refusals"] += 1
                resilience.bump("fabric.replica_stale_refusals")
                continue
            chosen = host_id
            break
        if chosen is None:
            raise FabricUnavailable(
                f"tenant {meta.name!r}: primary host {dead} died and no"
                " fingerprint-verified replica survives"
                + (f" (refused: {refused})" if refused else "")
            )
        ledger = self._hosts[chosen].replicas.pop(meta.name)
        dropped = meta.expected_count - ledger.synced_count
        exact = bool(np.all(dropped >= 0))
        meta.dropped_count = meta.dropped_count + dropped
        meta.expected_count = ledger.synced_count.copy()
        meta.hosts.remove(chosen)
        if dead in meta.hosts:
            meta.hosts.remove(dead)
        meta.hosts.insert(0, chosen)
        meta.version += 1
        meta.fp_memo = None
        self._stats["failovers"] += 1
        _trc = tracing.new_trace() if tracing._ACTIVE else None
        if telemetry._ACTIVE:
            telemetry.counter_inc("fabric.failovers")
        if tracing._ACTIVE:
            tracing.record_event(
                "fabric.failover", ctx=_trc, tenant=meta.name,
                from_host=dead, to_host=chosen,
                dropped=float(dropped.sum()),
                refused=str(tuple(refused)),
            )
            tracing.dump_forensics(
                "fabric.failover", trace=_trc,
                detail={
                    "tenant": meta.name, "from_host": dead,
                    "to_host": chosen,
                    "dropped_total": float(dropped.sum()),
                    "fingerprint": ledger.digest.hex()[:16],
                    "refused_replicas": list(refused),
                },
            )
        self._restore_replication(meta)
        return FailoverReport(
            tenant=meta.name, from_host=dead, to_host=chosen,
            dropped_count=dropped, exact=exact,
            fingerprint_hex=ledger.digest.hex()[:16],
            refused_replicas=tuple(refused),
        )

    def _restore_replication(self, meta: _TenantMeta) -> None:
        """Re-provision replicas on the next-ranked live hosts until
        the tenant is back at its replication factor (or the fleet runs
        out of usable hosts)."""
        want = min(self.config.replication, self.n_hosts)
        ranked = placement(meta.name, self.n_hosts, self.n_hosts)
        for h in ranked:
            if len(meta.hosts) >= want:
                break
            host = self._hosts[h]
            if h in meta.hosts or not host.alive or host.partitioned:
                continue
            meta.hosts.append(h)
            primary = self._hosts[meta.hosts[0]]
            if primary.alive and not primary.partitioned:
                self._provision_replica(meta, h)

    def revive_host(self, host_id: int) -> int:
        """A replacement process rejoins the fleet under a dead host's
        id -> the number of tenants that regained a copy.

        The revived host starts with NO serving role: any facades left
        from its previous life are ledger-less (the fabric never serves
        a replica without a sync ledger), and every under-replicated
        tenant re-provisions onto it through the normal sync path --
        the replacement holds only fingerprint-verified state.
        """
        with self._lock:
            if not (0 <= host_id < self.n_hosts):
                raise SketchValueError(f"no host {host_id}")
            host = self._hosts[host_id]
            if host.alive:
                return 0
            host.alive = True
            host.partitioned = False
            host.replicas.clear()
            n = 0
            for meta in self._tenants.values():
                before = len(meta.hosts)
                self._restore_replication(meta)
                if len(meta.hosts) > before:
                    n += 1
            if tracing._ACTIVE:
                tracing.record_event(
                    "fabric.revive", host=host_id, reprovisioned=n,
                )
            return n

    # -- partitions -------------------------------------------------------

    def partition_host(self, host_id: int) -> None:
        """Mark a host unreachable: its primaries degrade reads to
        declared-staleness replicas (writes refuse), its replicas stop
        serving and syncing.  State is untouched -- a partition is a
        connectivity fact, not a loss."""
        with self._lock:
            if not (0 <= host_id < self.n_hosts):
                raise SketchValueError(f"no host {host_id}")
            host = self._hosts[host_id]
            if not host.alive:
                raise SpecError(f"host {host_id} is dead, not partitioned")
            host.partitioned = True
            if tracing._ACTIVE:
                tracing.record_event("fabric.partition", host=host_id)

    def heal_partition(self, host_id: int) -> int:
        """Heal a partition: reconcile the host's replicas from their
        primaries, then commit the un-partition -> replicas refreshed.

        ATOMIC against the ``mesh.partition_heal`` fault: the
        reconciliation plan is computed first, the injection seam fires
        before any commit, and a torn heal leaves the host partitioned
        (degraded but consistent), never half-healed.
        """
        with self._lock:
            if not (0 <= host_id < self.n_hosts):
                raise SketchValueError(f"no host {host_id}")
            host = self._hosts[host_id]
            if not host.alive:
                raise SpecError(f"host {host_id} is dead; heal cannot revive")
            if not host.partitioned:
                return 0
            # Reconciliation plan: which replicas on this host need a
            # refresh from a reachable primary.
            plan = [
                meta for meta in self._tenants.values()
                if host_id in meta.hosts[1:]
                and self._hosts[meta.hosts[0]].alive
                and not self._hosts[meta.hosts[0]].partitioned
            ]
            if faults._ACTIVE:
                faults.inject(faults.MESH_PARTITION_HEAL)
            host.partitioned = False
            n = 0
            for meta in plan:
                if self._sync_replica(meta, host_id):
                    n += 1
            self._stats["heals"] += 1
            _trc = tracing.new_trace() if tracing._ACTIVE else None
            if tracing._ACTIVE:
                tracing.record_event(
                    "fabric.heal", ctx=_trc, host=host_id, resynced=n,
                )
                tracing.dump_forensics(
                    "fabric.heal", trace=_trc,
                    detail={"host": host_id, "resynced": n},
                )
            return n

    # -- rebalancing ------------------------------------------------------

    def handoff_replica(
        self, name: str, from_host: int, to_host: int
    ) -> HandoffReport:
        """Move a replica between hosts over the wire seam -> the
        :class:`HandoffReport`.

        The content fingerprint is topology-free, so a clean handoff
        preserves the sync ledger AND every fabric cache entry keyed on
        the fingerprint -- no recompute storm.  ATOMIC against
        ``reshard.torn`` at the handoff seam: a torn handoff raises and
        leaves the source replica intact and serving.  A payload that
        does not fingerprint back to the ledger aborts loudly
        (``ReplicaStale``) -- a corrupt copy is never installed.
        """
        from sketches_tpu_torch.backends.wirefmt import (
            payload_from_bytes,
            payload_to_bytes,
        )

        with self._lock:
            meta = self._meta(name)
            if from_host not in meta.hosts[1:]:
                raise SpecError(
                    f"host {from_host} holds no replica of {name!r}"
                )
            if to_host in meta.hosts:
                raise SpecError(
                    f"host {to_host} already holds a copy of {name!r}"
                )
            target = self._hosts[to_host]
            if not target.alive or target.partitioned:
                raise FabricUnavailable(
                    f"host {to_host} is not usable as a handoff target"
                )
            source = self._hosts[from_host]
            ledger = source.replicas.get(name)
            if ledger is None:
                raise SpecError(
                    f"host {from_host} has no sync ledger for {name!r}"
                )
            facade = source.server.tenant(name)
            blobs = payload_to_bytes(meta.spec, facade.state)
            if faults._ACTIVE:
                # The handoff is a mini-reshard: the replica moves
                # hosts.  Torn here = raise with the source intact.
                faults.inject(faults.RESHARD_TORN)
            state = payload_from_bytes(meta.spec, blobs, device=meta.device)
            if ServeFabric._digest_of(meta.spec, state) != ledger.digest:
                raise ReplicaStale(
                    f"handoff of {name!r} {from_host}->{to_host}: the"
                    " shipped payload does not fingerprint to the sync"
                    " ledger; aborting (source replica intact)",
                    reason="fingerprint", tenant=name,
                )
            new_facade = self._register_or_reuse(to_host, meta)
            new_facade.state = state
            target.server.invalidate(name)
            target.replicas[name] = _ReplicaLedger(
                ledger.digest, ledger.synced_count.copy(),
                ledger.synced_version, ledger.synced_at,
            )
            source.replicas.pop(name, None)
            meta.hosts[meta.hosts.index(from_host)] = to_host
            self._stats["handoffs"] += 1
            _trc = tracing.new_trace() if tracing._ACTIVE else None
            if tracing._ACTIVE:
                tracing.record_event(
                    "fabric.handoff", ctx=_trc, tenant=name,
                    from_host=from_host, to_host=to_host,
                    digest=ledger.digest.hex()[:16],
                )
                tracing.dump_forensics(
                    "fabric.handoff", trace=_trc,
                    detail={
                        "tenant": name, "from_host": from_host,
                        "to_host": to_host,
                        "fingerprint": ledger.digest.hex()[:16],
                    },
                )
            return HandoffReport(
                tenant=name, from_host=from_host, to_host=to_host,
                fingerprint_hex=ledger.digest.hex()[:16],
                cache_preserved=True,
            )

    def reshard_tenant(self, name: str, *args, **kwargs):
        """Pass-through to the primary host's
        ``SketchServer.reshard_tenant`` (mesh-sharded primaries only;
        fabric tenants are dense today, so this raises ``SpecError``
        until distributed tenants replicate)."""
        with self._lock:
            meta = self._meta(name)
            server = self._hosts[meta.hosts[0]].server
        return server.reshard_tenant(name, *args, **kwargs)

    # -- introspection ----------------------------------------------------

    def ledger(self, name: str) -> Dict[str, Any]:
        """The tenant's exact mass ledger: per-stream expected (live)
        and dropped (itemized at failovers) counts, plus the primary's
        current content fingerprint digest."""
        with self._lock:
            meta = self._meta(name)
            out = {
                "expected_count": meta.expected_count.copy(),
                "dropped_count": meta.dropped_count.copy(),
                "expected_total": float(meta.expected_count.sum()),
                "dropped_total": float(meta.dropped_count.sum()),
                "staleness_s": meta.staleness_s,
                "hosts": tuple(meta.hosts),
            }
            primary = self._hosts[meta.hosts[0]]
            if primary.alive and not primary.partitioned:
                _, digest = self._primary_fingerprint(meta)
                out["fingerprint"] = digest.hex()[:16]
            return out

    def stats(self) -> Dict[str, float]:
        """Always-on fabric counters (a copy) plus fleet liveness."""
        with self._lock:
            out = dict(self._stats)
            out["hosts"] = self.n_hosts
            out["live_hosts"] = len(
                [h for h in self._hosts if h.alive and not h.partitioned]
            )
            out["tenants"] = len(self._tenants)
            out["cache_entries"] = len(self._cache)
            return out

    def host_server(self, host_id: int) -> SketchServer:
        """The virtual host's underlying server (drills and tests)."""
        with self._lock:
            if not (0 <= host_id < self.n_hosts):
                raise SketchValueError(f"no host {host_id}")
            return self._hosts[host_id].server

"""Deterministic fault injection of the PyTorch port (counterpart of
``sketches_tpu.faults``; off by default, zero hot-path cost).

Resilience claims are only as good as the failures they were tested
against, so the failure modes are first-class, *injectable* events:

======================  ====================================================
site                    simulates
======================  ====================================================
``wire.blob``           blob corruption in the bulk decode (mutates the
                        blob bytes per index, deterministically)
``native.load``         native-library build/load failure (raises inside
                        ``native._load``; transient when ``times`` caps it)
``pallas.lowering``     a query-kernel build/launch failure (raises at the
                        facade dispatch, per engine ``tier``)
``pallas.ingest``       an ingest-kernel failure (the facade replays the
                        batch on the plain path)
``pallas.ingest_variant``  a lowering/compile failure of a non-stock
                        ingest construction variant (the r17 packed /
                        hifold / cmpfree rungs; the facade must degrade
                        to the stock rung, recorded in the health
                        ledger -- ``tier`` restricts to one variant)
``checkpoint.write``    a torn checkpoint write (``mode="truncate"``) or a
                        crash before the atomic rename (``mode="raise"``)
``mesh.shard``          dead value shard(s) -- consumed by
                        ``DistributedDDSketch.merge_partial`` /
                        ``reshard`` via :func:`dead_shards`
``mesh.host_loss``      a whole lost host (every value shard in one ICI
                        group dies at once) -- consumed by
                        ``DistributedDDSketch.reshard`` via
                        :func:`lost_hosts`
``dcn.partition``       a DCN network partition: some process-local
                        merged partials are unreachable at the
                        cross-host fold -- consumed by
                        ``parallel.fold_hosts`` via
                        :func:`partitioned_hosts`
``reshard.torn``        an elastic reshard interrupted between the
                        survivor fold and the regrown mesh (raises at
                        the reshard seam; the ORIGINAL fleet must
                        survive intact -- reshard is atomic)
``state.bitflip``       silent device-state corruption: a bit flipped in a
                        bin vector -- consumed by the chaos harness via
                        :func:`state_bitflips` + :func:`apply_state_bitflips`
                        (the integrity layer's adversary)
``serve.straggler``     a straggling query dispatch in the serving tier
                        (raises at the serve dispatch, per engine ``tier``)
                        -- the hedged-retry adversary
``serve.cache_poison``  silent corruption of a cached serving result --
                        consumed by the serve cache via
                        :func:`cache_poison_flip` (returns flip
                        coordinates rather than raising)
``serve.queue_overflow``  forced admission-queue overflow in the serving
                        tier (raises at admission; the request must be
                        shed with a structured error, never hang)
``window.rotate_torn``  a windowed-ring rotation interrupted between the
                        retirement plan and the commit (raises at the
                        rotation seam; the ring, ledger, and live bucket
                        must survive bit-identical -- rotation is atomic)
``window.stack_torn``   a two-stacks aggregate sync interrupted mid-update
                        (raises inside the sync; the stacks are DERIVED
                        state, so the ring must swallow the tear, drop
                        the stacks, and rebuild lazily -- recorded in the
                        health ledger, never surfaced to the query)
``window.agg_stale``    silent corruption of a maintained window
                        aggregate -- consumed by ``WindowedSketch`` via
                        :func:`agg_stale_flips` (returns flip coordinates
                        rather than raising; the stack-consistency
                        integrity audit's adversary)
``mesh.partition_heal``  a partition heal interrupted between replica
                        reconciliation and the un-partition commit
                        (raises at the fabric heal seam; the host must
                        stay partitioned -- degraded but consistent --
                        never half-healed)
``fabric.replica_stale``  silent corruption of a synced read replica --
                        consumed by the serve fabric via
                        :func:`replica_stale_flips` (returns flip
                        coordinates rather than raising; the
                        fingerprint-verified replica read's adversary)
======================  ====================================================

Site names are the JAX package's, ``pallas.*`` included: they name the
seam, not the kernel technology.  The serve, window and fabric sites are
consumed by ``serve``, ``windows`` and ``fabric``, at the JAX package's
seams.  ``pallas.ingest_variant`` sits in the facade's kernel ingest,
in the JAX order: one kernel (K1) computes every rung's contract, so the
rung is the label the facade carries for the health ledger, this site
and the ``ingest.variant.*`` counter, and a demotion to ``stock`` replays
the batch exactly.

Arming: programmatically via :func:`arm` / :func:`active` (tests), or at
process start via the ``SKETCHES_TPU_FAULTS`` environment variable --
semicolon-separated ``site[:key=value,...]`` entries, e.g.
``SKETCHES_TPU_FAULTS="native.load;wire.blob:fraction=0.01,seed=7"``.
Both are OFF by default.  The variable is shared with the JAX package:
one environment arms both.

Cost discipline: every injection seam guards on the module flag
(``if faults._ACTIVE: faults.inject(...)``), so the disabled harness
costs one attribute read + bool test per *dispatch* (not per value) --
unmeasurable next to a device dispatch.  Determinism: a plan fires on a
call-count cap (``times``) or on a seeded per-index hash (``fraction`` +
``seed``); no wall-clock, no global RNG, so a failing sequence replays
exactly.
"""

from __future__ import annotations

import binascii
import contextlib
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from sketches_tpu_torch import tracing
from sketches_tpu_torch.analysis import registry
from sketches_tpu_torch.resilience import InjectedFault, SpecError, bump

__all__ = [
    "FAULTS_ENV",
    "NATIVE_LOAD",
    "PALLAS_LOWERING",
    "PALLAS_INGEST",
    "PALLAS_INGEST_VARIANT",
    "WIRE_BLOB",
    "CHECKPOINT_WRITE",
    "MESH_SHARD",
    "MESH_HOST_LOSS",
    "DCN_PARTITION",
    "RESHARD_TORN",
    "STATE_BITFLIP",
    "SERVE_STRAGGLER",
    "SERVE_CACHE_POISON",
    "SERVE_QUEUE_OVERFLOW",
    "WINDOW_ROTATE_TORN",
    "WINDOW_STACK_TORN",
    "WINDOW_AGG_STALE",
    "MESH_PARTITION_HEAL",
    "FABRIC_REPLICA_STALE",
    "SITES",
    "arm",
    "disarm",
    "active",
    "inject",
    "dead_shards",
    "lost_hosts",
    "partitioned_hosts",
    "state_bitflips",
    "apply_state_bitflips",
    "cache_poison_flip",
    "agg_stale_flips",
    "replica_stale_flips",
    "stats",
    "corrupt_blobs",
    "ATOMIC_SITES",
]

#: Declared in ``analysis/registry.py`` (the kill-switch inventory).
FAULTS_ENV = registry.FAULTS.name

NATIVE_LOAD = "native.load"
PALLAS_LOWERING = "pallas.lowering"
PALLAS_INGEST = "pallas.ingest"
PALLAS_INGEST_VARIANT = "pallas.ingest_variant"
WIRE_BLOB = "wire.blob"
CHECKPOINT_WRITE = "checkpoint.write"
MESH_SHARD = "mesh.shard"
MESH_HOST_LOSS = "mesh.host_loss"
DCN_PARTITION = "dcn.partition"
RESHARD_TORN = "reshard.torn"
STATE_BITFLIP = "state.bitflip"
SERVE_STRAGGLER = "serve.straggler"
SERVE_CACHE_POISON = "serve.cache_poison"
SERVE_QUEUE_OVERFLOW = "serve.queue_overflow"
WINDOW_ROTATE_TORN = "window.rotate_torn"
WINDOW_STACK_TORN = "window.stack_torn"
WINDOW_AGG_STALE = "window.agg_stale"
MESH_PARTITION_HEAL = "mesh.partition_heal"
FABRIC_REPLICA_STALE = "fabric.replica_stale"

SITES = (
    NATIVE_LOAD,
    PALLAS_LOWERING,
    PALLAS_INGEST,
    PALLAS_INGEST_VARIANT,
    WIRE_BLOB,
    CHECKPOINT_WRITE,
    MESH_SHARD,
    MESH_HOST_LOSS,
    DCN_PARTITION,
    RESHARD_TORN,
    STATE_BITFLIP,
    SERVE_STRAGGLER,
    SERVE_CACHE_POISON,
    SERVE_QUEUE_OVERFLOW,
    WINDOW_ROTATE_TORN,
    WINDOW_STACK_TORN,
    WINDOW_AGG_STALE,
    MESH_PARTITION_HEAL,
    FABRIC_REPLICA_STALE,
)

#: Torn-write seams: sites whose enclosing method promises the
#: atomic-commit contract (zero ``self`` mutations before the inject,
#: commit by reference swap after it).
ATOMIC_SITES = (
    CHECKPOINT_WRITE,
    RESHARD_TORN,
    WINDOW_ROTATE_TORN,
    WINDOW_STACK_TORN,
    MESH_PARTITION_HEAL,
)

#: Fast-path guard: seams check this module flag before calling
#: :func:`inject`, so a fully disarmed harness costs one bool test.
_ACTIVE = False

_lock = threading.Lock()


class _Plan:
    """One armed site: when to fire and what to do.

    ``times=None`` fires on every matching call; ``times=k`` fires on the
    first k.  ``fraction`` + ``seed`` instead select per-``index``
    deterministically (the blob-corruption style).  ``tier`` restricts a
    ``pallas.lowering`` plan to one engine tier (or a tuple of tiers).
    ``mode`` is what firing does: ``"raise"`` (default, raises ``exc`` or
    :class:`InjectedFault`), ``"corrupt"`` / ``"truncate"`` (mutate the
    payload bytes and return them).
    """

    __slots__ = (
        "site", "times", "fraction", "seed", "mode", "tier", "shards",
        "exc", "fired", "calls",
    )

    def __init__(
        self,
        site: str,
        times: Optional[int] = None,
        fraction: Optional[float] = None,
        seed: int = 0,
        mode: str = "raise",
        tier=None,
        shards: Sequence[int] = (),
        exc: Optional[BaseException] = None,
    ):
        if mode not in ("raise", "corrupt", "truncate"):
            raise SpecError(f"Unknown fault mode {mode!r}")
        self.site = site
        self.times = times
        self.fraction = fraction
        self.seed = int(seed)
        self.mode = mode
        self.tier = (tier,) if isinstance(tier, str) else tier
        self.shards = tuple(int(s) for s in shards)
        self.exc = exc
        self.fired = 0
        self.calls = 0


_plans: Dict[str, _Plan] = {}


def arm(site: str, **kwargs) -> None:
    """Arm ``site`` with a :class:`_Plan` (see its docstring for knobs)."""
    global _ACTIVE
    if site not in SITES:
        raise SpecError(f"Unknown fault site {site!r}; expected one of {SITES}")
    with _lock:
        _plans[site] = _Plan(site, **kwargs)
        _ACTIVE = True


def disarm(site: Optional[str] = None) -> None:
    """Disarm one site (or all of them with no argument)."""
    global _ACTIVE
    with _lock:
        if site is None:
            _plans.clear()
        else:
            _plans.pop(site, None)
        _ACTIVE = bool(_plans)


@contextlib.contextmanager
def active(spec: Dict[str, Optional[dict]]) -> Iterator[Dict[str, _Plan]]:
    """Arm ``{site: kwargs}`` for the block; disarm on exit.

    Yields the armed plans so callers can assert on ``fired`` counts.
    """
    armed = []
    try:
        for site, kw in spec.items():
            arm(site, **(kw or {}))
            armed.append(site)
        yield {s: _plans[s] for s in armed}
    finally:
        for s in armed:
            disarm(s)


def stats() -> Dict[str, Tuple[int, int]]:
    """Per-armed-site ``(calls seen, faults fired)``."""
    with _lock:
        return {s: (p.calls, p.fired) for s, p in _plans.items()}


def _selected(seed: int, index: int, fraction: float) -> bool:
    """Deterministic per-index coin flip at rate ``fraction``."""
    h = binascii.crc32(f"{seed}:{index}".encode()) & 0xFFFFFFFF
    return h < fraction * 2**32


def inject(site: str, payload=None, index: Optional[int] = None, tier=None):
    """The seam call: fire the armed plan for ``site``, if any.

    Returns ``payload`` (possibly mutated for byte-mutation modes);
    raises the plan's exception in ``"raise"`` mode.  A disarmed site is
    a no-op returning ``payload`` unchanged.
    """
    plan = _plans.get(site)
    if plan is None:
        return payload
    plan.calls += 1
    if plan.tier is not None and tier is not None and tier not in plan.tier:
        return payload
    if plan.fraction is not None:
        if index is None or not _selected(plan.seed, index, plan.fraction):
            return payload
    elif plan.times is not None and plan.fired >= plan.times:
        return payload
    plan.fired += 1
    bump("faults." + site)
    if tracing._ACTIVE:
        # Injected faults are exactly the events a forensic bundle must
        # carry: the adversary's move, on the victim request's trace.
        tracing.record_event(
            "fault.injected", site=site, mode=plan.mode,
            tier=str(tier) if tier is not None else None,
        )
    if plan.mode == "raise":
        if plan.exc is not None:
            raise plan.exc
        raise InjectedFault(
            f"injected fault at {site}" + (f" (tier={tier})" if tier else "")
        )
    if plan.mode == "truncate":
        return payload[: max(1, len(payload) // 2)]
    return _corrupt(payload, plan.seed, index or 0)


def dead_shards(n_shards: int) -> Tuple[int, ...]:
    """Armed dead value-shard indices within ``[0, n_shards)`` -- the
    ``mesh.shard`` site's consumer-side read (it returns data rather than
    raising, so it does not go through :func:`inject`)."""
    if not _ACTIVE:
        return ()
    plan = _plans.get(MESH_SHARD)
    if plan is None:
        return ()
    plan.calls += 1
    dead = tuple(s for s in plan.shards if 0 <= s < n_shards)
    if dead:
        plan.fired += 1
        bump("faults." + MESH_SHARD)
    return dead


def _armed_indices(site: str, n: int) -> Tuple[int, ...]:
    """Shared consumer-side read for the index-set sites (``mesh.shard``
    style): the armed plan's in-range ``shards`` indices, counted and
    bumped when any fire.  Disarmed it returns ``()`` after one bool
    test; an empty/out-of-range plan fires nothing."""
    if not _ACTIVE:
        return ()
    plan = _plans.get(site)
    if plan is None:
        return ()
    plan.calls += 1
    hit = tuple(s for s in plan.shards if 0 <= s < n)
    if hit:
        plan.fired += 1
        bump("faults." + site)
        if tracing._ACTIVE:
            tracing.record_event(
                "fault.injected", site=site, indices=str(hit)
            )
    return hit


def lost_hosts(n_hosts: int) -> Tuple[int, ...]:
    """Armed lost-host indices within ``[0, n_hosts)`` -- the
    ``mesh.host_loss`` site's consumer-side read (returns data rather
    than raising, like :func:`dead_shards`; every value shard in a lost
    host's ICI group is treated as dead at the next reshard/fold).
    Disarmed (the default) it returns ``()`` after one bool test."""
    return _armed_indices(MESH_HOST_LOSS, n_hosts)


def partitioned_hosts(n_hosts: int) -> Tuple[int, ...]:
    """Armed DCN-partitioned host indices within ``[0, n_hosts)`` -- the
    ``dcn.partition`` site's consumer-side read (returns data rather
    than raising): those hosts' process-local merged partials are
    unreachable at the cross-host fold and must be folded around with
    their mass accounted, never silently averaged as zeros.  Disarmed
    (the default) it returns ``()`` after one bool test."""
    return _armed_indices(DCN_PARTITION, n_hosts)


def state_bitflips(n_streams: int, n_bins: int) -> Tuple[Tuple[int, int, int, int], ...]:
    """Armed device-state bit-flip coordinates -- the ``state.bitflip``
    site's consumer-side read (it returns data rather than raising, like
    :func:`dead_shards`).

    Each firing yields one ``(store, stream, bin, bit)`` tuple (store 0
    = positive bins, 1 = negative bins; bit indexes the 32-bit lane of
    the bin's dtype), derived deterministically from the plan's seed and
    its running call count, so a failing sequence replays exactly.
    Disarmed (the default) it returns ``()`` after one bool test.
    Respects the plan's ``times`` cap.
    """
    if not _ACTIVE:
        return ()
    plan = _plans.get(STATE_BITFLIP)
    if plan is None:
        return ()
    plan.calls += 1
    if plan.times is not None and plan.fired >= plan.times:
        return ()
    h = binascii.crc32(f"{plan.seed}:{plan.calls}".encode()) & 0xFFFFFFFF
    store = h & 1
    stream = (h >> 1) % max(n_streams, 1)
    bin_ = (h >> 11) % max(n_bins, 1)
    bit = (h >> 25) % 32
    plan.fired += 1
    bump("faults." + STATE_BITFLIP)
    return ((store, stream, bin_, bit),)


def apply_state_bitflips(state, flips):
    """Apply :func:`state_bitflips` coordinates to a batched state ->
    a corrupted copy (the input state is untouched), on the state's own
    device.

    The bins are cloned where they live and the named bit of each named
    bin is XORed in place through an int32 view of the clone (f32 and
    int32 bins both): the chaos model of silent in-memory corruption.  The
    flipped value may be negative, huge, or NaN -- whatever the bit
    pattern decodes to.  Returns ``state`` unchanged for an empty flip
    list.  The bins come out equal, bit for bit, to the JAX package's.
    """
    if not flips:
        return state
    import dataclasses as _dc

    stores = [state.bins_pos.clone(), state.bins_neg.clone()]
    for store, stream, bin_, bit in flips:
        view = stores[store].view(torch.int32)
        # Bit 31 as a signed int32 constant: the XOR flips the same bit.
        view[stream, bin_] ^= (1 << bit) - (1 << 32 if bit == 31 else 0)
    return _dc.replace(state, bins_pos=stores[0], bins_neg=stores[1])


def agg_stale_flips(
    n_streams: int, n_bins: int
) -> Tuple[Tuple[int, int, int, int], ...]:
    """Armed maintained-aggregate corruption coordinates -- the
    ``window.agg_stale`` site's consumer-side read (it returns data
    rather than raising, like :func:`state_bitflips`).

    Same coordinate scheme as :func:`state_bitflips` -- each firing
    yields one ``(store, stream, bin, bit)`` tuple derived
    deterministically from the plan's seed and its running call count --
    but aimed at a CACHED two-stacks window aggregate instead of a live
    bucket state: the raw bucket stays clean, so only the
    stack-consistency integrity audit can tell the cached answer went
    stale.  Disarmed (the default) it returns ``()`` after one bool
    test.  Respects the plan's ``times`` cap.
    """
    if not _ACTIVE:
        return ()
    plan = _plans.get(WINDOW_AGG_STALE)
    if plan is None:
        return ()
    plan.calls += 1
    if plan.times is not None and plan.fired >= plan.times:
        return ()
    h = binascii.crc32(f"{plan.seed}:{plan.calls}".encode()) & 0xFFFFFFFF
    store = h & 1
    stream = (h >> 1) % max(n_streams, 1)
    bin_ = (h >> 11) % max(n_bins, 1)
    bit = (h >> 25) % 32
    plan.fired += 1
    bump("faults." + WINDOW_AGG_STALE)
    if tracing._ACTIVE:
        tracing.record_event(
            "fault.injected", site=WINDOW_AGG_STALE,
            coords=str((store, stream, bin_, bit)),
        )
    return ((store, stream, bin_, bit),)


def replica_stale_flips(
    n_streams: int, n_bins: int
) -> Tuple[Tuple[int, int, int, int], ...]:
    """Armed read-replica corruption coordinates -- the
    ``fabric.replica_stale`` site's consumer-side read (it returns data
    rather than raising, like :func:`state_bitflips`).

    Same coordinate scheme as :func:`state_bitflips` -- each firing
    yields one ``(store, stream, bin, bit)`` tuple derived
    deterministically from the plan's seed and its running call count --
    but aimed at a serve-fabric READ REPLICA after its sync: the
    primary stays clean, so only the fingerprint-vs-ledger verification
    at serve time can tell the replica went stale-wrong.  The flipped
    bit is drawn from the magnitude-bearing float32 bits (top mantissa,
    high exponent) so the corruption is material whenever the bin
    carries mass -- and the high-exponent pick is material even on an
    empty bin; a uniformly random low bit would vanish into the
    fingerprint sum's rounding and drill nothing.  Disarmed (the
    default) it returns ``()`` after one bool test.  Respects the
    plan's ``times`` cap.
    """
    if not _ACTIVE:
        return ()
    plan = _plans.get(FABRIC_REPLICA_STALE)
    if plan is None:
        return ()
    plan.calls += 1
    if plan.times is not None and plan.fired >= plan.times:
        return ()
    h = binascii.crc32(f"{plan.seed}:{plan.calls}".encode()) & 0xFFFFFFFF
    store = h & 1
    stream = (h >> 1) % max(n_streams, 1)
    bin_ = (h >> 11) % max(n_bins, 1)
    bit = (21, 22, 30)[(h >> 25) % 3]
    plan.fired += 1
    bump("faults." + FABRIC_REPLICA_STALE)
    if tracing._ACTIVE:
        tracing.record_event(
            "fault.injected", site=FABRIC_REPLICA_STALE,
            coords=str((store, stream, bin_, bit)),
        )
    return ((store, stream, bin_, bit),)


def cache_poison_flip(n_bytes: int) -> Optional[Tuple[int, int]]:
    """Armed cached-result corruption coordinates -- the
    ``serve.cache_poison`` site's consumer-side read (it returns data
    rather than raising, like :func:`state_bitflips`).

    Each firing yields one ``(byte, bit)`` coordinate into a cached
    payload of ``n_bytes`` bytes, derived deterministically from the
    plan's seed and its running call count, so a failing sequence
    replays exactly.  Disarmed (the default) it returns ``None`` after
    one bool test; an empty payload also returns ``None`` (nothing to
    corrupt).  Respects the plan's ``times`` cap.
    """
    if not _ACTIVE:
        return None
    plan = _plans.get(SERVE_CACHE_POISON)
    if plan is None or n_bytes <= 0:
        return None
    plan.calls += 1
    if plan.times is not None and plan.fired >= plan.times:
        return None
    h = binascii.crc32(f"{plan.seed}:{plan.calls}".encode()) & 0xFFFFFFFF
    byte = h % n_bytes
    bit = (h >> 24) % 8
    plan.fired += 1
    bump("faults." + SERVE_CACHE_POISON)
    if tracing._ACTIVE:
        tracing.record_event(
            "fault.injected", site=SERVE_CACHE_POISON, byte=byte, bit=bit
        )
    return (byte, bit)


# ---------------------------------------------------------------------------
# Deterministic blob corruption
# ---------------------------------------------------------------------------


def _corrupt(blob: bytes, seed: int, index: int) -> bytes:
    """Structurally-invalid corruption of one wire blob, by (seed, index).

    Every mode is GUARANTEED unparseable by any protobuf parser (invalid
    wire type 7 tag, or the illegal field number 0), so a corrupted blob
    is always *detected* -- the corruption model for quarantine tests.
    (A bit flip that yields different-but-valid bytes is undetectable
    without a content checksum the DDSketch wire format does not carry;
    that is the documented limit of the quarantine contract.)
    """
    mode = (seed + index) % 3
    if mode == 0:
        return b"\xff" + blob[1:]  # tag 0xff: wire type 7 (invalid)
    if mode == 1:
        return blob + b"\xff\xff\xff\xff\xff"  # trailing invalid tag
    return b"\x00" + blob  # field number 0 (illegal)


def corrupt_blobs(
    blobs: Sequence[bytes], fraction: float, seed: int = 0
) -> Tuple[list, list]:
    """Corrupt a deterministic ~``fraction`` of ``blobs`` -> (new list,
    corrupted indices).  Test/benchmark helper sharing the exact
    selection + mutation the armed ``wire.blob`` site applies."""
    out, idx = [], []
    for i, b in enumerate(blobs):
        if _selected(seed, i, fraction):
            out.append(_corrupt(b, seed, i))
            idx.append(i)
        else:
            out.append(b)
    return out, idx


# ---------------------------------------------------------------------------
# Environment arming (process-level, for CI degraded-mode jobs)
# ---------------------------------------------------------------------------


def _coerce(v: str):
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def _parse_env(value: str) -> None:
    for part in value.split(";"):
        part = part.strip()
        if not part:
            continue
        site, _, kvs = part.partition(":")
        kwargs: dict = {}
        for kv in filter(None, (s.strip() for s in kvs.split(","))):
            k, _, v = kv.partition("=")
            if k == "shards":
                kwargs[k] = tuple(int(s) for s in v.split("|") if s)
            else:
                kwargs[k] = _coerce(v)
        arm(site.strip(), **kwargs)


_env = registry.get(registry.FAULTS)
if _env:  # pragma: no cover - exercised via subprocess in CI degraded jobs
    _parse_env(_env)

"""Seeded chaos-soak harness: every injected fault must be detected or
provably harmless.

The PyTorch port of ``sketches_tpu.chaos``: the same six campaigns,
verdict keys, outcome words, constants and rng draw order, on the port's
modules.  ``python -m sketches_tpu_torch.chaos --steps N --seed S
[--device cpu]`` drives a mixed
ingest / merge / query / checkpoint / wire workload against a small
sketch fleet (two value-partial batches, the distributed fold's shape)
with the **integrity layer armed**, while a seeded campaign scheduler
injects faults from the ``sketches_tpu_torch.faults`` sites:

========================  =================================================
site                      expected accounting
========================  =================================================
``wire.blob``             quarantine decode isolates exactly the corrupted
                          blobs; valid blobs decode bit-identically
``checkpoint.write``      torn write -> ``CheckpointCorrupt`` on restore
                          (previous checkpoint intact); crashed write ->
                          ``InjectedFault`` raised, previous file intact
``pallas.lowering``       query answers through the engine ladder with the
                          demotion recorded, or the floor re-raises
``pallas.ingest_variant`` a non-stock ingest construction rung fails to
                          lower -> the facade degrades to the stock rung
                          (health-ledger recorded), the replayed batch's
                          mass is exact, and no fault escapes
``mesh.shard``            the live-mask fold accounts the dead partial's
                          mass exactly (survivors stay an exact sketch)
``state.bitflip``         the integrity checker / fingerprint lane catches
                          the corruption -- or the answers are proven
                          unchanged within the alpha contract (harmless)
========================  =================================================

Every fault event lands in the verdict JSON as ``detected``,
``harmless``, or (the failure mode the harness exists to catch)
``undetected``; any ``undetected`` event -- or any workload-level
bookkeeping mismatch -- makes the campaign exit non-zero.  The whole
campaign is seeded (``np.random.default_rng(seed)`` plus the fault
plans' own seeds): a failing run replays exactly.

``--campaign elastic`` runs the ELASTIC campaign: one live fleet keeps
ingesting while shards and whole hosts are killed mid-stream and the
mesh is regrown onto 1/2/4/8 devices (``mesh.shard`` /
``mesh.host_loss`` / ``dcn.partition`` / ``reshard.torn``); every fault
must be **detected** or **recovered** -- the survivors' fold carries the
expected surviving mass bit-exactly, the dead capacity's mass is
itemized per stream, torn reshards leave the original fleet intact, and
the armed integrity layer's fingerprint lane verifies every reshard
boundary.

``--campaign serve`` runs the SERVING campaign instead: a seeded Zipf
tenant mix drives a :class:`sketches_tpu_torch.serve.SketchServer` (ingest /
query / batched flush) while the ``serve.*`` sites inject stragglers,
forced queue overflows, and cache poison.  The accounting contract is
the serving tier's robustness envelope: every injected fault must be
**shed** (``ServeOverload``, structured reason), **hedged** around
(answer bit-identical to a direct engine query), or **detected**
(poisoned cache entry quarantined and recomputed, answer exact) -- and
the tenants' total mass must be conserved.  Anything else is
``undetected`` and fails the run.

``--campaign windowed`` runs the TIME-WINDOW campaign: windowed rings
(a serve-fronted dense ring, an adaptive ladder ring, and -- given >= 2
devices -- a mesh-backed ring) rotate under a virtual clock while
``window.rotate_torn`` tears rotations mid-ingest, checkpoint writes
tear, wire envelopes corrupt, reshards tear mid-rotation, and the kill
switch flips.  The accounting contract: every window query is
bit-identical to the host-side oracle merge of its covered buckets,
the per-bucket mass ledger is EXACT (``==``, never approximately) at
every step, a torn rotation/reshard leaves the ring bit-identical, and
a poisoned serve cache entry recomputes -- anything else is
``undetected`` and fails the run.

``--campaign fabric`` runs the SHARDED-SERVE campaign: a 4-host
:class:`sketches_tpu_torch.fabric.ServeFabric` serves 4 tenants at
replication 3 while hosts are killed mid-ingest (tenants must re-home
onto fingerprint-verified replicas, dropped mass itemized EXACTLY per
stream), primaries are partitioned (reads degrade to declared-staleness
replicas, writes refuse, beyond-bound replicas refuse loudly), replica
state is silently corrupted (``fabric.replica_stale`` -- a corrupt
replica must NEVER serve), partition heals and replica handoffs tear
atomically, and the ``SKETCHES_TPU_FABRIC`` kill switch flips.  The
accounting contract: every served answer bit-identical to its oracle
fold, the mass ledger closes with ``==`` at every step and every
failover -- anything else is ``undetected`` and fails the run.  With
the switch disarmed the campaign probes that every construction
refuses loudly instead.

Devices: every campaign takes ``device=`` (the card by default; there is
no silent CPU run: without a card the caller passes ``device="cpu"``).  The
elastic and windowed campaigns' meshes take a device pool, ``devices=``
(as ``SketchMesh(devices=...)`` does; every CUDA device by default): the
elastic campaign regrows over 1/2/4/8 value shards clipped to the pool's
size, and the windowed campaign's mesh-backed ring needs two entries.
Entries may repeat, so value shards can share one card.  The CLI's
``--device`` stands for the JAX package's ``--platform``, and its meshes
take ``POOL`` entries of that device (8, the JAX CI's 8-device virtual
mesh).  The core campaign's quantile checks answer
through ``kernels.floor_quantile`` (K2 on the card) where the JAX
package calls its jitted ``batched.quantile``.

Failure modes: the harness itself raises ``SketchValueError`` on
invalid arguments; a campaign that cannot complete (unexpected
exception escaping an un-faulted op) records the error in the verdict
and exits 1 rather than crashing silently.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sketches_tpu_torch import faults, integrity, resilience, telemetry, tracing
from sketches_tpu_torch.batched import resolve_device
from sketches_tpu_torch.resilience import (
    CheckpointCorrupt,
    InjectedFault,
    IntegrityError,
    SketchError,
    SketchValueError,
)

__all__ = [
    "run_campaign",
    "run_serve_campaign",
    "run_elastic_campaign",
    "run_adaptive_campaign",
    "run_windowed_campaign",
    "run_fabric_campaign",
    "main",
]

#: Campaign shape: small enough that a 500+-step soak runs in CI
#: minutes, big enough that every store/seam carries real mass.
_N_STREAMS = 16
_N_BINS = 128
_BATCH = 32
_REL_ACC = 0.02

#: Per-step fault probability (when a step's op has a compatible site).
_FAULT_P = 0.25

#: Quantiles the harmless-verification compares.
_QS = (0.5, 0.9, 0.99)

#: Entries of ``--device`` in the CLI's elastic and windowed mesh pool
#: (the JAX CI's 8-device virtual mesh; value shards share the device).
POOL = 8


def _np(x, dtype=None) -> np.ndarray:
    """A host numpy copy of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _pool(devices) -> List[torch.device]:
    """A mesh campaign's device pool: ``devices`` as given, else every CUDA
    device (``SketchMesh``'s default; ``SpecError`` without a card)."""
    from sketches_tpu_torch.parallel import SketchMesh

    if devices is None:
        return list(SketchMesh().devices)
    return [torch.device(d) for d in devices]


@dataclasses.dataclass
class _Campaign:
    """Mutable campaign state: the two value-partials, the bookkeeping
    the verdict is audited against, and the fault event log."""

    spec: Any
    partials: List[Any]
    rng: Any  # a seeded np.random.default_rng(seed) Generator
    tmpdir: str
    device: Any
    expected_count: float = 0.0
    dropped_count: float = 0.0  # mass accounted lost (dead shards)
    last_good_ckpt: Optional[str] = None
    last_good_count: float = 0.0
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)


def _stack_partials(c: _Campaign):
    """The two partial states as one stacked [2, N, B] state."""
    from sketches_tpu_torch.batched import LEAVES, SketchState

    a, b = c.partials[0].state, c.partials[1].state
    return SketchState(
        **{f: torch.stack((getattr(a, f), getattr(b, f))) for f in LEAVES}
    )


def _fold(c: _Campaign, live=None):
    from sketches_tpu_torch.parallel import fold_live_partials

    if live is None:
        live = np.ones((2,), bool)
    return fold_live_partials(c.spec, _stack_partials(c), live)


def _quantiles(c: _Campaign, state) -> np.ndarray:
    from sketches_tpu_torch import kernels

    qs = torch.tensor(_QS, dtype=torch.float32, device=state.count.device)
    return _np(kernels.floor_quantile(c.spec, state, qs))


def _total_count(c: _Campaign) -> float:
    return float(
        _np(c.partials[0].state.count, np.float64).sum()
        + _np(c.partials[1].state.count, np.float64).sum()
    )


def _event(c: _Campaign, step: int, site: str, outcome: str, detail: str = ""):
    c.events.append(
        {"step": step, "site": site, "outcome": outcome, "detail": detail}
    )


# ---------------------------------------------------------------------------
# Workload ops (no fault armed)
# ---------------------------------------------------------------------------


def _op_ingest(c: _Campaign, step: int) -> None:
    vals = c.rng.lognormal(0.0, 0.5, (_N_STREAMS, _BATCH)).astype(np.float32)
    c.partials[step % 2].add(vals)
    c.expected_count += _N_STREAMS * _BATCH


def _op_query(c: _Campaign, step: int) -> None:
    folded = _fold(c)
    q = _quantiles(c, folded)
    live = q[_np(folded.count) > 0]
    if live.size and not np.isfinite(live).all():
        raise SketchError("query returned non-finite quantiles")


def _op_merge(c: _Campaign, step: int) -> None:
    from sketches_tpu_torch.batched import BatchedDDSketch

    other = BatchedDDSketch(_N_STREAMS, spec=c.spec, device=c.device)
    vals = c.rng.lognormal(0.0, 0.5, (_N_STREAMS, _BATCH)).astype(np.float32)
    other.add(vals)
    c.partials[step % 2].merge(other)
    c.expected_count += _N_STREAMS * _BATCH


def _op_checkpoint(c: _Campaign, step: int) -> None:
    from sketches_tpu_torch import checkpoint

    path = os.path.join(c.tmpdir, "soak.ckpt")
    folded = _fold(c)
    checkpoint.save_state(path, c.spec, folded)
    spec2, state2 = checkpoint.restore_state(path, c.device)
    if abs(
        float(_np(state2.count, np.float64).sum()) - _total_count(c)
    ) > 1.0:
        raise SketchError("checkpoint round trip lost mass")
    c.last_good_ckpt = path
    c.last_good_count = _total_count(c)


def _op_wire(c: _Campaign, step: int) -> None:
    from sketches_tpu_torch.pb import wire

    p = c.partials[step % 2]
    blobs = wire.state_to_bytes(c.spec, p.state)
    _, report = wire.bytes_to_state(
        c.spec, blobs, errors="quarantine", device=c.device
    )
    if report:
        raise SketchError(
            f"clean wire round trip quarantined {report.n_quarantined} blobs"
        )


_OPS = (_op_ingest, _op_query, _op_merge, _op_checkpoint, _op_wire)
_OP_WEIGHTS = (0.45, 0.2, 0.15, 0.1, 0.1)


# ---------------------------------------------------------------------------
# Fault drivers: arm a site, drive the workload through it, classify
# ---------------------------------------------------------------------------


def _fault_wire_blob(c: _Campaign, step: int) -> str:
    from sketches_tpu_torch.pb import wire

    p = c.partials[step % 2]
    blobs = wire.state_to_bytes(c.spec, p.state)
    with faults.active(
        {faults.WIRE_BLOB: dict(mode="corrupt", fraction=0.2, seed=step)}
    ) as plans:
        _, report = wire.bytes_to_state(
            c.spec, blobs, errors="quarantine", device=c.device
        )
        fired = plans[faults.WIRE_BLOB].fired
    if fired == 0:
        return "skipped"
    return "detected" if report.n_quarantined == fired else "undetected"


def _fault_checkpoint(c: _Campaign, step: int) -> str:
    from sketches_tpu_torch import checkpoint

    path = os.path.join(c.tmpdir, "torn.ckpt")
    folded = _fold(c)
    checkpoint.save_state(path, c.spec, folded)  # a good previous file
    mode = "truncate" if step % 2 else "raise"
    with faults.active({faults.CHECKPOINT_WRITE: dict(mode=mode, times=1)}):
        try:
            checkpoint.save_state(path, c.spec, folded)
            crashed = False
        except InjectedFault:
            crashed = True  # crash before the atomic rename
    if crashed:
        # The previous checkpoint must have survived the crash intact.
        checkpoint.restore_state(path, c.device)
        return "detected"
    try:
        checkpoint.restore_state(path, c.device)
    except CheckpointCorrupt:
        return "detected"
    return "undetected"


def _fault_lowering(c: _Campaign, step: int) -> str:
    # Query through a FACADE (not the pure quantile function): the
    # lowering-fault seam lives in the facade's engine-ladder dispatch.
    p = c.partials[step % 2]
    before = resilience.health()["counters"].get("downgrades", 0)
    with faults.active({faults.PALLAS_LOWERING: dict(times=1)}) as plans:
        try:
            q = _np(p.get_quantile_values(list(_QS)))
            if not np.isfinite(q[_np(p.state.count) > 0]).all():
                return "undetected"
        except (InjectedFault, resilience.EngineUnavailable):
            return "detected"  # the floor re-raised, loudly
        fired = plans[faults.PALLAS_LOWERING].fired
    if fired == 0:
        return "skipped"
    after = resilience.health()["counters"].get("downgrades", 0)
    return "detected" if after > before else "undetected"


def _fault_ingest_variant(c: _Campaign, step: int) -> str:
    # The ingest construction-rung ladder (DESIGN.md 2-r17): a variant
    # lowering failure must degrade to the stock rung -- recorded in the
    # health ledger -- with the replayed batch's mass exact, never a
    # fault escaping or a demotion all the way to the plain ingest.  The
    # campaign's own partials are 16-stream (plain engine), so this driver
    # runs a kernel-shaped facade of its own (``engine="kernel"`` on the
    # card -- K1 -- and ``"auto"`` on the CPU, whose kernel path runs
    # K1's plain version); after the first demotion the facade pins to
    # stock and later draws report "skipped".
    from sketches_tpu_torch import kernels
    from sketches_tpu_torch.batched import BatchedDDSketch

    if kernels.choose_ingest_engine(c.spec, weighted=False) == "stock":
        return "skipped"  # kill switch pinned the ladder to stock
    sk = getattr(c, "_variant_sk", None)
    if sk is None:
        sk = BatchedDDSketch(
            128, relative_accuracy=_REL_ACC, n_bins=_N_BINS,
            engine="kernel" if c.device.type == "cuda" else "auto",
            device=c.device,
        )
        c._variant_sk = sk
    vals = np.exp(
        c.rng.normal(0.0, 1.0, (128, _BATCH * 4))
    ).astype(np.float32)
    before_count = float(_np(sk.state.count, np.float64).sum())
    before = resilience.health()["counters"].get("downgrades", 0)
    with faults.active(
        {faults.PALLAS_INGEST_VARIANT: dict(times=1)}
    ) as plans:
        try:
            sk.add(vals)
        except (InjectedFault, resilience.EngineUnavailable):
            return "undetected"  # the rung must degrade, not raise
        fired = plans[faults.PALLAS_INGEST_VARIANT].fired
    if fired == 0:
        return "skipped"  # first add recenters (plain) / already demoted
    after = resilience.health()["counters"].get("downgrades", 0)
    if after <= before or not sk._kernel_ingest:
        return "undetected"
    total = float(_np(sk.state.count, np.float64).sum())
    exact = abs(total - before_count - float(vals.size)) <= 1e-6 * vals.size
    return "detected" if exact else "undetected"


def _fault_mesh_shard(c: _Campaign, step: int) -> str:
    dead = step % 2
    live = np.ones((2,), bool)
    live[dead] = False
    dead_count = float(
        _np(c.partials[dead].state.count, np.float64).sum()
    )
    survived = _fold(c, live=live)
    got = float(_np(survived.count, np.float64).sum())
    if abs(got + dead_count - _total_count(c)) > 1.0:
        return "undetected"
    # Account the loss the way merge_partial does, then restore the
    # partial (simulation: the "dead" shard is still readable).
    resilience.bump("mesh.dead_shards", 1)
    return "detected"


def _fault_bitflip(c: _Campaign, step: int) -> str:
    p = c.partials[step % 2]
    pre_state = p.state  # keep the uncorrupted pytree (flips copy)
    pre_q = _quantiles(c, _fold(c))
    fp_pre = integrity.fingerprint(c.spec, pre_state)
    with faults.active({faults.STATE_BITFLIP: dict(seed=step, times=1)}):
        flips = faults.state_bitflips(_N_STREAMS, _N_BINS)
    corrupted = faults.apply_state_bitflips(pre_state, flips)
    outcome = "undetected"
    try:
        report = integrity.verify_state(
            c.spec, corrupted, seam="chaos.bitflip", errors="quarantine"
        )
        if report:
            outcome = "detected"  # the standalone invariant checker
        else:
            # Invariants intact: the cross-boundary fingerprint (the
            # checkpoint/fold lane's comparison against the pre-flip
            # reference) is the second detector.
            try:
                fp_rep = integrity.verify_restore(
                    c.spec, corrupted, stored_fp=fp_pre,
                    seam="chaos.bitflip.fp",
                )
                if fp_rep:
                    outcome = "detected"  # quarantine mode: reported
                else:
                    # Both detectors passed: prove the flip harmless --
                    # the answers are unchanged within the alpha contract.
                    p.state = corrupted
                    post_q = _quantiles(c, _fold(c))
                    same = np.allclose(
                        post_q, pre_q, rtol=4 * _REL_ACC, atol=1e-6,
                        equal_nan=True,
                    )
                    outcome = "harmless" if same else "undetected"
            except IntegrityError:
                outcome = "detected"
    except IntegrityError:
        outcome = "detected"
    finally:
        # Repair must make the corrupted state consistent again, then
        # the campaign resumes from the uncorrupted original.
        fixed, _rep = integrity.repair(c.spec, corrupted)
        if integrity.check_state(c.spec, fixed):
            outcome = "undetected"
        p.state = pre_state
    return outcome


_FAULT_DRIVERS = {
    faults.WIRE_BLOB: _fault_wire_blob,
    faults.CHECKPOINT_WRITE: _fault_checkpoint,
    faults.PALLAS_LOWERING: _fault_lowering,
    faults.PALLAS_INGEST_VARIANT: _fault_ingest_variant,
    faults.MESH_SHARD: _fault_mesh_shard,
    faults.STATE_BITFLIP: _fault_bitflip,
}


def _classify_forensics(site: str, outcome: str, step: int) -> None:
    """Every fault classification dumps a forensic bundle while the
    flight recorder is armed: the bundle's triggering trace is the most
    recent request trace (the serve campaign's in-flight request; the
    core campaign runs untraced ops, so its bundles carry recorder
    events without a trigger trace).  Disarmed this is one bool test;
    a dump failure is swallowed -- forensics never fail a campaign."""
    if not tracing._ACTIVE:
        return
    try:
        tracing.dump_forensics(
            f"chaos.{site}",
            trace=tracing.last_trace(),
            detail={"site": site, "outcome": outcome, "step": step},
        )
    except Exception:  # noqa: BLE001 - forensics must not fail the soak
        pass


# ---------------------------------------------------------------------------
# Campaign
# ---------------------------------------------------------------------------


def run_campaign(
    steps: int,
    seed: int,
    mode: str = "raise",
    tmpdir: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """Run a seeded chaos campaign -> the verdict document (JSON-safe).

    Arms the integrity layer (``mode``: ``"raise"`` or ``"quarantine"``)
    for the duration and restores the prior arming state on exit.  The
    verdict's ``ok`` is True iff every injected fault was accounted
    ``detected`` or ``harmless``, the final fold conserves the expected
    total mass, and no unexpected error escaped an op.  Raises
    ``SketchValueError`` for non-positive ``steps``; campaign-level
    failures are *reported*, not raised.  ``device``: the card by default.
    """
    if steps <= 0:
        raise SketchValueError("steps must be positive")
    from sketches_tpu_torch.batched import BatchedDDSketch, SketchSpec

    device = resolve_device(device)

    was_active, was_mode = integrity.enabled(), integrity.mode()
    faults.disarm()
    integrity.arm(mode)
    own_tmp = None
    if tmpdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="sketches_chaos_")
        tmpdir = own_tmp.name
    try:
        spec = SketchSpec(relative_accuracy=_REL_ACC, n_bins=_N_BINS)
        c = _Campaign(
            spec=spec,
            partials=[
                BatchedDDSketch(_N_STREAMS, spec=spec, device=device)
                for _ in range(2)
            ],
            rng=np.random.default_rng(seed),
            tmpdir=tmpdir,
            device=device,
        )
        sites = tuple(_FAULT_DRIVERS)
        for step in range(steps):
            op = c.rng.choice(len(_OPS), p=_OP_WEIGHTS)
            try:
                _OPS[op](c, step)
            except Exception as e:  # un-faulted op must not fail
                c.errors.append(f"step {step} op {_OPS[op].__name__}: {e!r}")
                break
            if c.rng.random() < _FAULT_P:
                site = sites[int(c.rng.integers(len(sites)))]
                try:
                    outcome = _FAULT_DRIVERS[site](c, step)
                except Exception as e:
                    outcome = "undetected"
                    c.errors.append(f"step {step} site {site}: {e!r}")
                if outcome != "skipped":
                    _event(c, step, site, outcome)
                    _classify_forensics(site, outcome, step)
        # Final audit: the fold conserves every ingested value.
        final = float(_np(_fold(c).count, np.float64).sum())
        conserved = abs(final - c.expected_count) <= max(
            1.0, 1e-5 * c.expected_count
        )
        if not conserved:
            c.errors.append(
                f"final mass {final:g} != expected {c.expected_count:g}"
            )
        outcomes: Dict[str, int] = {}
        for ev in c.events:
            outcomes[ev["outcome"]] = outcomes.get(ev["outcome"], 0) + 1
        ok = (
            conserved
            and not c.errors
            and outcomes.get("undetected", 0) == 0
        )
        return {
            "steps": steps,
            "seed": seed,
            "mode": mode,
            "ok": ok,
            "n_faults": len(c.events),
            "outcomes": outcomes,
            "events": c.events,
            "errors": c.errors,
            "expected_count": c.expected_count,
            "final_count": final,
            "integrity_reports": len(integrity.reports()),
            "forensics": tracing.stats() if tracing.enabled() else None,
            "health": resilience.health(),
            # The end-of-campaign telemetry snapshot rides the verdict
            # when the metrics layer is armed (the CI chaos job), so the
            # artifact carries the integrity.*/resilience.* counters --
            # and stays mergeable with the other jobs' snapshots.  None
            # (not {}) when disarmed: an absent layer, not an idle one.
            "telemetry": telemetry.snapshot() if telemetry.enabled() else None,
        }
    finally:
        faults.disarm()
        if was_active:
            integrity.arm(was_mode)
        else:
            integrity.disarm()
        if own_tmp is not None:
            own_tmp.cleanup()


# ---------------------------------------------------------------------------
# Serving campaign (the serve.* sites)
# ---------------------------------------------------------------------------

#: Serving-campaign shape: a few tenants (two sharing a spec, so the
#: cross-tenant fused dispatch path is exercised), small states.
_SERVE_TENANTS = ("alpha", "beta", "gamma", "delta")
_SERVE_STREAMS = 8
_SERVE_QS = ((0.5,), (0.9,), (0.5, 0.99), (0.25, 0.5, 0.9, 0.99))


def _serve_direct(server, tenant: str, qs) -> np.ndarray:
    """The oracle for a served answer: the tenant facade's own fused
    query (bit-identical is the contract -- serving must never change
    an answer, only its latency)."""
    return _np(server.tenant(tenant).get_quantile_values(list(qs)))


def _serve_fault_straggler(server, rng, counts) -> str:
    from sketches_tpu_torch.resilience import SketchError

    tenant = _SERVE_TENANTS[int(rng.integers(len(_SERVE_TENANTS)))]
    qs = _SERVE_QS[int(rng.integers(len(_SERVE_QS)))]
    before = server.stats()["hedges"]
    with faults.active({faults.SERVE_STRAGGLER: dict(times=1)}) as plans:
        try:
            result = server.query(tenant, qs)
        except SketchError:
            return "undetected"  # a straggler must be hedged, not failed
        fired = plans[faults.SERVE_STRAGGLER].fired
    if fired == 0:
        return "skipped"  # answered from cache: no dispatch to straggle
    hedged = server.stats()["hedges"] > before
    exact = np.array_equal(
        result.values, _serve_direct(server, tenant, qs), equal_nan=True
    )
    return "hedged" if (hedged and exact) else "undetected"


def _serve_fault_overflow(server, rng, counts) -> str:
    from sketches_tpu_torch.resilience import ServeOverload

    tenant = _SERVE_TENANTS[int(rng.integers(len(_SERVE_TENANTS)))]
    before = server.stats()["shed"]
    with faults.active({faults.SERVE_QUEUE_OVERFLOW: dict(times=1)}) as plans:
        try:
            # A fresh quantile defeats the admission cache so the
            # request reaches the overflow seam.
            server.submit(tenant, (0.013 + 0.02 * (counts["overflow"] % 17),))
            fired = plans[faults.SERVE_QUEUE_OVERFLOW].fired
            if fired == 0:
                return "skipped"
            return "undetected"  # the forced overflow was not shed
        except ServeOverload as e:
            counts["overflow"] += 1
            shed_counted = server.stats()["shed"] > before
            return (
                "shed" if (e.reason == "injected" and shed_counted)
                else "undetected"
            )
    return "undetected"


def _serve_fault_cache_poison(server, rng, counts) -> str:
    tenant = _SERVE_TENANTS[int(rng.integers(len(_SERVE_TENANTS)))]
    qs = _SERVE_QS[int(rng.integers(len(_SERVE_QS)))]
    server.query(tenant, qs)  # ensure the entry exists (fill or hit)
    before = server.stats()["cache_poisoned"]
    with faults.active({faults.SERVE_CACHE_POISON: dict(times=1)}) as plans:
        result = server.query(tenant, qs)
        fired = plans[faults.SERVE_CACHE_POISON].fired
    if fired == 0:
        return "skipped"  # cache disarmed / entry evicted: nothing to poison
    detected = server.stats()["cache_poisoned"] > before
    exact = np.array_equal(
        result.values, _serve_direct(server, tenant, qs), equal_nan=True
    )
    return "detected" if (detected and exact and not result.cached) \
        else "undetected"


_SERVE_FAULT_DRIVERS = {
    faults.SERVE_STRAGGLER: _serve_fault_straggler,
    faults.SERVE_QUEUE_OVERFLOW: _serve_fault_overflow,
    faults.SERVE_CACHE_POISON: _serve_fault_cache_poison,
}


def run_serve_campaign(steps: int, seed: int, device=None) -> Dict[str, Any]:
    """Run the seeded serving chaos campaign -> the verdict document.

    Drives a 4-tenant :class:`~sketches_tpu_torch.serve.SketchServer` (two
    tenants share a spec, exercising the cross-tenant fused dispatch)
    with a seeded mixed read/write workload while the three ``serve.*``
    fault sites inject.  ``ok`` is True iff every injected fault was
    shed, hedged around, or detected (answers bit-identical to a direct
    engine query), total tenant mass is conserved, and no unexpected
    error escaped.  Raises ``SketchValueError`` for non-positive
    ``steps``; campaign-level failures are reported, not raised.
    ``device``: the card by default.
    """
    if steps <= 0:
        raise SketchValueError("steps must be positive")
    from sketches_tpu_torch import serve
    from sketches_tpu_torch.batched import SketchSpec

    device = resolve_device(device)
    faults.disarm()
    rng = np.random.default_rng(seed)
    shared = SketchSpec(relative_accuracy=_REL_ACC, n_bins=_N_BINS)
    own = SketchSpec(relative_accuracy=0.01, n_bins=_N_BINS)
    server = serve.SketchServer(
        serve.ServeConfig(max_queue_depth=64, tenant_quota=16)
    )
    specs = {"alpha": shared, "beta": shared, "gamma": own, "delta": own}
    for name in _SERVE_TENANTS:
        server.add_tenant(name, _SERVE_STREAMS, spec=specs[name], device=device)
    expected = {name: 0.0 for name in _SERVE_TENANTS}
    events: List[Dict[str, Any]] = []
    errors: List[str] = []
    counts = {"overflow": 0}
    sites = tuple(_SERVE_FAULT_DRIVERS)

    def _ingest(step: int) -> None:
        name = _SERVE_TENANTS[int(rng.integers(len(_SERVE_TENANTS)))]
        vals = rng.lognormal(0.0, 0.5, (_SERVE_STREAMS, _BATCH))
        server.ingest(name, vals.astype(np.float32))
        expected[name] += _SERVE_STREAMS * _BATCH

    def _query(step: int) -> None:
        name = _SERVE_TENANTS[int(rng.integers(len(_SERVE_TENANTS)))]
        qs = _SERVE_QS[int(rng.integers(len(_SERVE_QS)))]
        result = server.query(name, qs)
        if not np.array_equal(
            result.values, _serve_direct(server, name, qs), equal_nan=True
        ):
            raise SketchError(
                f"served answer for {name!r} diverged from the engine"
            )

    def _batch(step: int) -> None:
        tickets = []
        for name in _SERVE_TENANTS:
            qs = _SERVE_QS[int(rng.integers(len(_SERVE_QS)))]
            tickets.append(server.submit(name, qs))
        results = server.flush()
        for tk in tickets:
            if tk.result is None and tk.id not in results:
                raise SketchError("an admitted ticket went unanswered")

    ops = (_ingest, _query, _batch)
    weights = (0.4, 0.4, 0.2)
    for step in range(steps):
        op = int(rng.choice(len(ops), p=weights))
        try:
            ops[op](step)
        except Exception as e:  # un-faulted serving op must not fail
            errors.append(f"step {step} op {ops[op].__name__}: {e!r}")
            break
        if rng.random() < _FAULT_P:
            site = sites[int(rng.integers(len(sites)))]
            try:
                outcome = _SERVE_FAULT_DRIVERS[site](server, rng, counts)
            except Exception as e:
                outcome = "undetected"
                errors.append(f"step {step} site {site}: {e!r}")
            if outcome != "skipped":
                events.append({"step": step, "site": site, "outcome": outcome})
                _classify_forensics(site, outcome, step)
    # Mass audit: every ingested value is still in its tenant's sketch.
    conserved = True
    for name in _SERVE_TENANTS:
        got = float(
            _np(
                server.tenant(name).state.count, np.float64
            ).sum()
        )
        if abs(got - expected[name]) > max(1.0, 1e-5 * expected[name]):
            conserved = False
            errors.append(
                f"tenant {name!r} mass {got:g} != expected {expected[name]:g}"
            )
    outcomes: Dict[str, int] = {}
    for ev in events:
        outcomes[ev["outcome"]] = outcomes.get(ev["outcome"], 0) + 1
    ok = conserved and not errors and outcomes.get("undetected", 0) == 0
    return {
        "campaign": "serve",
        "steps": steps,
        "seed": seed,
        "ok": ok,
        "n_faults": len(events),
        "outcomes": outcomes,
        "events": events,
        "errors": errors,
        "expected_count": sum(expected.values()),
        "serve_stats": server.stats(),
        "health": resilience.health(),
        "telemetry": telemetry.snapshot() if telemetry.enabled() else None,
        # Recorder accounting rides the verdict when armed (None when
        # the layer is absent, matching the telemetry convention).
        "forensics": tracing.stats() if tracing.enabled() else None,
    }


# ---------------------------------------------------------------------------
# Elastic campaign (kill-and-regrow across mesh sizes)
# ---------------------------------------------------------------------------

#: Elastic-campaign shape: small states, batch width divisible by every
#: mesh size the campaign regrows onto (1/2/4/8).
_ELASTIC_STREAMS = 8
_ELASTIC_BATCH = 32


def _elastic_sizes(pool) -> List[int]:
    """Mesh sizes the campaign cycles over: the 1/2/4/8 curve clipped to
    the campaign's device pool (the tests and the card's smoke pass 8
    entries; a 1-entry pool still soaks the fold/accounting invariants,
    just without growth)."""
    n = len(pool)
    return [k for k in (1, 2, 4, 8) if k <= n]


def _elastic_mesh(c, k: int):
    from sketches_tpu_torch.parallel import SketchMesh

    return SketchMesh(k, n_hosts=2 if k >= 2 else 1, devices=c.pool)


@dataclasses.dataclass
class _ElasticCampaign:
    """Mutable elastic-campaign state: ONE live fleet that keeps being
    killed and regrown, a 'remote host' batched partial for the DCN
    fold, and the exact per-stream mass ledgers the verdict audits."""

    spec: Any
    fleet: Any  # the current DistributedDDSketch
    remote: Any  # a BatchedDDSketch standing in for a second host
    rng: Any
    tmpdir: str
    pool: Any  # the mesh device pool
    expected: Any = None  # np [N] f64: mass the LIVE fleet must hold
    remote_expected: Any = None  # np [N] f64: the remote host's mass
    dropped: Any = None  # np [N] f64: mass itemized lost to dead shards
    reshards: int = 0
    sizes_visited: Any = dataclasses.field(default_factory=set)
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)


def _elastic_fleet_count(c: _ElasticCampaign) -> np.ndarray:
    return _np(c.fleet.merged_state().count, np.float64)


def _elastic_audit(c: _ElasticCampaign, where: str) -> bool:
    """Exact per-stream mass accounting: the live fleet's fold must hold
    EXACTLY the expected surviving mass (unit weights -> integer-valued
    f32 counts, compared exactly)."""
    got = _elastic_fleet_count(c)
    if np.array_equal(got, c.expected):
        return True
    c.errors.append(
        f"{where}: fleet mass {got.sum():g} != expected"
        f" {c.expected.sum():g} (first bad stream"
        f" {int(np.nonzero(got != c.expected)[0][0])})"
    )
    return False


def _elastic_ingest(c: _ElasticCampaign, step: int) -> None:
    vals = c.rng.lognormal(0.0, 0.5, (_ELASTIC_STREAMS, _ELASTIC_BATCH))
    c.fleet.add(vals.astype(np.float32))
    c.expected = c.expected + _ELASTIC_BATCH


def _elastic_query(c: _ElasticCampaign, step: int) -> None:
    q = _np(c.fleet.get_quantile_values(list(_QS)))
    live = q[_elastic_fleet_count(c) > 0]
    if live.size and not np.isfinite(live).all():
        raise SketchError("elastic query returned non-finite quantiles")


def _elastic_remote_ingest(c: _ElasticCampaign, step: int) -> None:
    vals = c.rng.lognormal(0.0, 0.5, (_ELASTIC_STREAMS, _ELASTIC_BATCH))
    c.remote.add(vals.astype(np.float32))
    c.remote_expected = c.remote_expected + _ELASTIC_BATCH


def _elastic_reshard(c: _ElasticCampaign, step: int) -> None:
    """Clean grow/shrink: regrow onto the next seeded mesh size with
    ZERO lost mass (report must say exact, no dead shards)."""
    sizes = _elastic_sizes(c.pool)
    k = int(sizes[int(c.rng.integers(len(sizes)))])
    fleet, report = c.fleet.reshard(mesh=_elastic_mesh(c, k))
    c.fleet = fleet
    c.reshards += 1
    c.sizes_visited.add(k)
    if report.n_dead or not report.exact:
        raise SketchError(
            f"clean reshard to {k} devices reported n_dead="
            f"{report.n_dead} exact={report.exact}"
        )
    _elastic_audit(c, f"step {step} reshard->{k}")


def _elastic_checkpoint(c: _ElasticCampaign, step: int) -> None:
    """Partials checkpoint -> restore onto a DIFFERENT mesh size; the
    restored fold must carry the exact expected mass."""
    from sketches_tpu_torch import checkpoint

    sizes = _elastic_sizes(c.pool)
    k = int(sizes[int(c.rng.integers(len(sizes)))])
    path = os.path.join(c.tmpdir, "elastic.ckpt")
    checkpoint.save(path, c.fleet, partials=True)
    c.fleet = checkpoint.restore_distributed(path, mesh=_elastic_mesh(c, k))
    c.sizes_visited.add(k)
    _elastic_audit(c, f"step {step} ckpt-restore->{k}")


_ELASTIC_OPS = (
    _elastic_ingest, _elastic_query, _elastic_remote_ingest,
    _elastic_reshard, _elastic_checkpoint,
)
_ELASTIC_OP_WEIGHTS = (0.45, 0.15, 0.1, 0.2, 0.1)


def _elastic_fault_shard(c: _ElasticCampaign, step: int) -> str:
    """Kill one value shard mid-stream, regrow onto a different mesh
    size: the survivors' fold must be exact and the dead shard's mass
    itemized per stream -- 'recovered', anything else undetected."""
    k_now = c.fleet.n_value_shards
    if k_now < 2:
        return "skipped"
    dead = int(c.rng.integers(k_now))
    part_counts = _np(c.fleet.partials.count, np.float64)
    sizes = _elastic_sizes(c.pool)
    k_next = int(sizes[int(c.rng.integers(len(sizes)))])
    with faults.active({faults.MESH_SHARD: dict(shards=(dead,))}):
        fleet, report = c.fleet.reshard(mesh=_elastic_mesh(c, k_next))
    c.fleet = fleet
    c.reshards += 1
    c.sizes_visited.add(k_next)
    if report.dead_shards != [dead] or not report.exact:
        return "undetected"
    if not np.array_equal(report.dropped_count, part_counts[dead]):
        return "undetected"  # itemization must match the shard exactly
    if report.fingerprints_match is False:
        return "undetected"
    c.expected = c.expected - report.dropped_count
    c.dropped = c.dropped + report.dropped_count
    return (
        "recovered"
        if _elastic_audit(c, f"step {step} kill-shard-{dead}->{k_next}")
        else "undetected"
    )


def _elastic_fault_host_loss(c: _ElasticCampaign, step: int) -> str:
    """Kill a whole host (every shard in one ICI group), regrow: same
    exactness contract as a single dead shard, host itemized."""
    if c.fleet.n_hosts < 2:
        return "skipped"
    host = int(c.rng.integers(c.fleet.n_hosts))
    shards = list(c.fleet._host_shards(host))
    part_counts = _np(c.fleet.partials.count, np.float64)
    sizes = _elastic_sizes(c.pool)
    k_next = int(sizes[int(c.rng.integers(len(sizes)))])
    with faults.active({faults.MESH_HOST_LOSS: dict(shards=(host,))}):
        fleet, report = c.fleet.reshard(mesh=_elastic_mesh(c, k_next))
    c.fleet = fleet
    c.reshards += 1
    c.sizes_visited.add(k_next)
    if report.lost_hosts != (host,) or report.dead_shards != shards:
        return "undetected"
    if not report.exact or not np.array_equal(
        report.dropped_count, part_counts[shards].sum(axis=0)
    ):
        return "undetected"
    c.expected = c.expected - report.dropped_count
    c.dropped = c.dropped + report.dropped_count
    return (
        "recovered"
        if _elastic_audit(c, f"step {step} host-loss-{host}->{k_next}")
        else "undetected"
    )


def _elastic_fault_partition(c: _ElasticCampaign, step: int) -> str:
    """DCN partition at the cross-host fold: the unreachable host's
    partial is folded AROUND with its mass accounted -- detected, never
    silently zeroed.  Campaign state is untouched (the fold is a read)."""
    from sketches_tpu_torch.parallel import fold_hosts

    before = resilience.health()["counters"].get("dcn.partitions", 0)
    with faults.active({faults.DCN_PARTITION: dict(shards=(1,))}):
        folded, report = fold_hosts(
            c.spec, [c.fleet.merged_state(), c.remote.state]
        )
    got = _np(folded.count, np.float64)
    counted = resilience.health()["counters"].get("dcn.partitions", 0)
    ok = (
        report.n_dead == 1
        and report.dead_shards == [1]
        and np.array_equal(got, c.expected)
        and np.array_equal(report.dropped_count, c.remote_expected)
        and counted > before
    )
    return "detected" if ok else "undetected"


def _elastic_fault_torn(c: _ElasticCampaign, step: int) -> str:
    """A reshard torn between the survivor fold and the regrow must
    raise AND leave the original fleet fully intact (atomic reshard)."""
    sizes = _elastic_sizes(c.pool)
    k_next = int(sizes[int(c.rng.integers(len(sizes)))])
    try:
        with faults.active({faults.RESHARD_TORN: dict(times=1)}):
            c.fleet.reshard(n_devices=k_next)
        return "undetected"  # the tear did not surface
    except InjectedFault:
        pass
    return (
        "detected"
        if _elastic_audit(c, f"step {step} torn-reshard->{k_next}")
        else "undetected"
    )


_ELASTIC_FAULT_DRIVERS = {
    faults.MESH_SHARD: _elastic_fault_shard,
    faults.MESH_HOST_LOSS: _elastic_fault_host_loss,
    faults.DCN_PARTITION: _elastic_fault_partition,
    faults.RESHARD_TORN: _elastic_fault_torn,
}


def run_elastic_campaign(
    steps: int,
    seed: int,
    mode: str = "raise",
    tmpdir: Optional[str] = None,
    device=None,
    devices=None,
) -> Dict[str, Any]:
    """Run the seeded ELASTIC chaos campaign -> the verdict document.

    One live fleet ingests while the campaign kills shards and whole
    hosts mid-stream, regrows onto 1/2/4/8-device meshes (clipped to
    the device pool ``devices``: every CUDA device by default), round-trips partials checkpoints
    onto different mesh sizes, and crosses a simulated DCN fold --
    with the integrity layer armed (``mode``) so every reshard
    boundary's fingerprint lane verifies.  ``ok`` is True iff every
    injected fault was ``detected`` or ``recovered`` (kill-and-regrow
    with exact per-stream mass accounting: survivors' fold equals the
    expected surviving mass bit-exactly, dropped mass itemized), the
    final fold conserves the ledger, and no unexpected error escaped.
    Raises ``SketchValueError`` for non-positive ``steps``;
    campaign-level failures are reported, not raised.  The remote host's
    batch lives on ``device`` (the pool's first device by default).
    """
    if steps <= 0:
        raise SketchValueError("steps must be positive")
    from sketches_tpu_torch.batched import BatchedDDSketch, SketchSpec
    from sketches_tpu_torch.parallel import DistributedDDSketch

    pool = _pool(devices)
    device = resolve_device(pool[0] if device is None else device)

    was_active, was_mode = integrity.enabled(), integrity.mode()
    faults.disarm()
    integrity.arm(mode)
    own_tmp = None
    if tmpdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="sketches_elastic_")
        tmpdir = own_tmp.name
    try:
        spec = SketchSpec(relative_accuracy=_REL_ACC, n_bins=_N_BINS)
        sizes = _elastic_sizes(pool)
        k0 = sizes[-1] if len(sizes) > 1 else sizes[0]
        c = _ElasticCampaign(
            spec=spec,
            fleet=None,
            remote=BatchedDDSketch(_ELASTIC_STREAMS, spec=spec, device=device),
            rng=np.random.default_rng(seed),
            tmpdir=tmpdir,
            pool=pool,
            expected=np.zeros((_ELASTIC_STREAMS,), np.float64),
            remote_expected=np.zeros((_ELASTIC_STREAMS,), np.float64),
            dropped=np.zeros((_ELASTIC_STREAMS,), np.float64),
        )
        c.fleet = DistributedDDSketch(
            _ELASTIC_STREAMS, spec=spec, mesh=_elastic_mesh(c, k0)
        )
        c.sizes_visited.add(k0)
        fault_sites = tuple(_ELASTIC_FAULT_DRIVERS)
        for step in range(steps):
            op = c.rng.choice(len(_ELASTIC_OPS), p=_ELASTIC_OP_WEIGHTS)
            try:
                _ELASTIC_OPS[op](c, step)
            except Exception as e:  # un-faulted op must not fail
                c.errors.append(
                    f"step {step} op {_ELASTIC_OPS[op].__name__}: {e!r}"
                )
                break
            if c.rng.random() < _FAULT_P:
                site = fault_sites[int(c.rng.integers(len(fault_sites)))]
                try:
                    outcome = _ELASTIC_FAULT_DRIVERS[site](c, step)
                except Exception as e:
                    outcome = "undetected"
                    c.errors.append(f"step {step} site {site}: {e!r}")
                if outcome != "skipped":
                    c.events.append(
                        {"step": step, "site": site, "outcome": outcome}
                    )
                    _classify_forensics(site, outcome, step)
        # Final audit: surviving mass exact, dropped mass itemized --
        # every ingested value is either in the fleet or in the ledger.
        conserved = _elastic_audit(c, "final")
        outcomes: Dict[str, int] = {}
        for ev in c.events:
            outcomes[ev["outcome"]] = outcomes.get(ev["outcome"], 0) + 1
        ok = (
            conserved
            and not c.errors
            and outcomes.get("undetected", 0) == 0
        )
        return {
            "campaign": "elastic",
            "steps": steps,
            "seed": seed,
            "mode": mode,
            "ok": ok,
            "n_faults": len(c.events),
            "outcomes": outcomes,
            "events": c.events,
            "errors": c.errors,
            "reshards": c.reshards,
            "mesh_sizes_visited": sorted(int(k) for k in c.sizes_visited),
            "expected_count": float(c.expected.sum()),
            "final_count": float(_elastic_fleet_count(c).sum()),
            "dropped_count": float(c.dropped.sum()),
            "integrity_reports": len(integrity.reports()),
            "health": resilience.health(),
            "forensics": tracing.stats() if tracing.enabled() else None,
            "telemetry": telemetry.snapshot() if telemetry.enabled() else None,
        }
    finally:
        faults.disarm()
        if was_active:
            integrity.arm(was_mode)
        else:
            integrity.disarm()
        if own_tmp is not None:
            own_tmp.cleanup()


# ---------------------------------------------------------------------------
# Adaptive campaign (the accuracy-backend soak)
# ---------------------------------------------------------------------------

#: Adaptive-campaign shape: few streams, narrow windows (so regime
#: drift genuinely forces collapses), bounded per-stream value logs for
#: the alpha-contract audit.
_AD_STREAMS = 8
_AD_BINS = 128
_AD_BATCH = 32
_AD_THRESHOLD = 0.05
_AD_QS = (0.25, 0.5, 0.9)


def _ad_quantile_audit(c, step: int) -> None:
    """The alpha-contract audit: the adaptive facade's answers must sit
    within the *effective* alpha of the exact quantiles of every value
    it ever ingested (widened by the edge-clamped fraction -- clamped
    mass legitimately carries phantom ranks; raises ``SketchError`` on
    a breach)."""
    sk = c["adaptive"]
    q = _np(sk.get_quantile_values(list(_AD_QS)), np.float64)
    ea = _np(sk.effective_alpha(), np.float64)
    cf = _np(sk.collapsed_fraction(), np.float64)
    for s, vals in enumerate(c["values"]):
        if len(vals) < 8:
            continue
        arr = _np(vals, np.float64)
        # Clamped mass shifts ranks by up to its fraction: audit the
        # quantile against the exact-rank bracket widened by that shift,
        # then by the effective alpha.
        for qi, qq in enumerate(_AD_QS):
            got = float(q[s, qi])
            lo_r = max(0.0, qq - cf[s] - 0.02)
            hi_r = min(1.0, qq + cf[s] + 0.02)
            lo_v = float(np.quantile(arr, lo_r, method="lower"))
            hi_v = float(np.quantile(arr, hi_r, method="higher"))
            lo_b = lo_v - ea[s] * abs(lo_v) - 1e-6
            hi_b = hi_v + ea[s] * abs(hi_v) + 1e-6
            if not lo_b <= got <= hi_b:
                raise SketchError(
                    f"alpha contract breach: stream {s} q{qq} = {got:g}"
                    f" outside [{lo_b:g}, {hi_b:g}] at effective alpha"
                    f" {ea[s]:.4f} (collapsed frac {cf[s]:.4f})"
                )


def _ad_expected_counts(c) -> float:
    return float(
        sum(len(v) for v in c["values"]) + c["moment_count"]
    )


def _ad_actual_counts(c) -> float:
    return float(
        _np(c["adaptive"].count, np.float64).sum()
        + _np(c["moment"].count, np.float64).sum()
    )


def run_adaptive_campaign(
    steps: int, seed: int, tmpdir: Optional[str] = None, device=None
) -> Dict[str, Any]:
    """Run the seeded adaptive-backend chaos campaign -> the verdict.

    One uniform-collapse facade rides a regime-drifting workload
    (location drift + seeded scale explosions force collapses
    MID-INGEST) next to one moment facade, with the integrity layer
    armed.  Every step the campaign may: ingest, audit the alpha
    contract at the *effective* alpha (exact-value ledger), merge a
    mixed-gamma operand (count conserved exactly), round-trip the
    backend wire envelope, or checkpoint/restore -- and with
    probability the armed fault sites corrupt the wire blobs, flip
    state bits, tear checkpoint writes, or flip the
    ``SKETCHES_TPU_ADAPTIVE`` kill switch under a firing trigger
    (which must refuse loudly).  ``ok`` iff every injected fault is
    detected or provably harmless, mass is EXACTLY conserved, and the
    alpha audit never breaches.  Raises ``SketchValueError`` for
    non-positive ``steps``; campaign-level failures are reported, not
    raised.  ``device``: the card by default.
    """
    if steps <= 0:
        raise SketchValueError("steps must be positive")
    import os as _os

    from sketches_tpu_torch.backends.moment import MomentDDSketch
    from sketches_tpu_torch.backends.uniform import AdaptiveDDSketch
    from sketches_tpu_torch.backends.wirefmt import (
        payload_from_bytes,
        payload_to_bytes,
    )
    from sketches_tpu_torch.batched import SketchSpec
    from sketches_tpu_torch.resilience import SpecError, WireDecodeError

    device = resolve_device(device)
    was_active, was_mode = integrity.enabled(), integrity.mode()
    faults.disarm()
    integrity.arm("quarantine")
    own_tmp = None
    if tmpdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="sketches_adaptive_")
        tmpdir = own_tmp.name
    rng = np.random.default_rng(seed)
    aspec = SketchSpec(
        relative_accuracy=_REL_ACC, n_bins=_AD_BINS,
        backend="uniform_collapse", collapse_threshold=_AD_THRESHOLD,
    )
    mspec = SketchSpec(
        relative_accuracy=_REL_ACC, backend="moment", n_moments=8
    )
    c: Dict[str, Any] = {
        "adaptive": AdaptiveDDSketch(_AD_STREAMS, spec=aspec, device=device),
        "moment": MomentDDSketch(_AD_STREAMS, spec=mspec, device=device),
        "values": [[] for _ in range(_AD_STREAMS)],
        "moment_count": 0.0,
        "drift": 0.0,
        "scale": 0.6,
    }
    events: List[Dict[str, Any]] = []
    errors: List[str] = []

    def _ingest(step: int) -> None:
        # Regime drift: the location random-walks; seeded scale
        # explosions (~6% of steps) force mid-ingest collapses.
        c["drift"] += float(rng.normal(0.0, 0.25))
        if rng.random() < 0.06:
            c["scale"] = min(c["scale"] * 2.5, 8.0)
        vals = rng.lognormal(
            c["drift"], c["scale"], (_AD_STREAMS, _AD_BATCH)
        ).astype(np.float32)
        c["adaptive"].add(vals)
        c["moment"].add(vals)
        c["moment_count"] += vals.size
        for s in range(_AD_STREAMS):
            c["values"][s].extend(float(x) for x in vals[s])

    def _merge_mixed(step: int) -> None:
        # A fresh operand at a DIFFERENT gamma (explicitly collapsed
        # once) merges in: the mixed-gamma path, count conserved
        # exactly.
        other = AdaptiveDDSketch(_AD_STREAMS, spec=aspec, device=device)
        vals = rng.lognormal(
            c["drift"], 0.6, (_AD_STREAMS, _AD_BATCH)
        ).astype(np.float32)
        other.add(vals)
        other.collapse()
        before = _np(c["adaptive"].count, np.float64).sum()
        c["adaptive"].merge(other)
        after = _np(c["adaptive"].count, np.float64).sum()
        if after != before + vals.size:
            raise SketchError(
                f"mixed-gamma merge lost mass: {after:g} !="
                f" {before + vals.size:g}"
            )
        for s in range(_AD_STREAMS):
            c["values"][s].extend(float(x) for x in vals[s])

    def _wire_roundtrip(step: int) -> None:
        for spec, facade in ((aspec, c["adaptive"]), (mspec, c["moment"])):
            blobs = payload_to_bytes(spec, facade.state)
            st2 = payload_from_bytes(spec, blobs, device=device)
            got = float(_np(st2.count, np.float64).sum())
            want = float(_np(facade.count, np.float64).sum())
            if abs(got - want) > 0.5:
                raise SketchError(
                    f"{spec.backend} wire round trip lost mass:"
                    f" {got:g} != {want:g}"
                )

    def _checkpoint_roundtrip(step: int) -> None:
        from sketches_tpu_torch import checkpoint

        for name in ("adaptive", "moment"):
            path = _os.path.join(tmpdir, f"{name}.ckpt")
            checkpoint.save(path, c[name])
            restored = checkpoint.restore(path, device=device)
            got = float(_np(restored.count, np.float64).sum())
            want = float(_np(c[name].count, np.float64).sum())
            if abs(got - want) > 0.5:
                raise SketchError(
                    f"{name} checkpoint round trip lost mass"
                )

    def _fault_wire(step: int) -> str:
        spec, facade = (
            (aspec, c["adaptive"]) if step % 2 else (mspec, c["moment"])
        )
        blobs = payload_to_bytes(spec, facade.state)
        idx = int(rng.integers(len(blobs)))
        blob = bytearray(blobs[idx])
        if not blob:
            return "skipped"
        pos = int(rng.integers(len(blob)))
        blob[pos] ^= 1 << int(rng.integers(8))
        corrupted = list(blobs)
        corrupted[idx] = bytes(blob)
        try:
            st2 = payload_from_bytes(spec, corrupted, device=device)
        except WireDecodeError:
            return "detected"  # structural damage refused loudly
        except Exception:  # noqa: BLE001 - any loud failure is detection
            return "detected"
        got = float(_np(st2.count, np.float64).sum())
        want = float(_np(facade.count, np.float64).sum())
        if abs(got - want) <= 0.5:
            fp_a = integrity.fingerprint(spec, st2)
            fp_b = integrity.fingerprint(spec, facade.state)
            fin = np.isfinite(fp_a) & np.isfinite(fp_b)
            if np.allclose(fp_a[fin], fp_b[fin], rtol=1e-6, atol=1e-3):
                return "harmless"  # flipped a byte the format ignores
        return "detected" if _ad_fp_differs(spec, facade, st2) else \
            "undetected"

    def _ad_fp_differs(spec, facade, st2) -> bool:
        # Content changed: the fingerprint lane must notice (that IS
        # the detection -- a serve cache keyed on it would miss, never
        # serve the corrupted answer as the original).
        fp_a = integrity.fingerprint(spec, st2)
        fp_b = integrity.fingerprint(spec, facade.state)
        fin = np.isfinite(fp_a) & np.isfinite(fp_b)
        return not np.allclose(
            fp_a[fin], fp_b[fin], rtol=1e-6, atol=1e-3
        ) or bool((~fin).any())

    def _fault_bitflip(step: int) -> str:
        sk = c["adaptive"]
        pre = sk.state
        fp_pre = integrity.fingerprint(aspec, pre)
        with faults.active(
            {faults.STATE_BITFLIP: dict(seed=step, times=1)}
        ):
            flips = faults.state_bitflips(_AD_STREAMS, _AD_BINS)
        if not flips:
            return "skipped"
        from sketches_tpu_torch.backends.uniform import AdaptiveState

        corrupted = AdaptiveState(
            faults.apply_state_bitflips(pre.base, flips), pre.level
        )
        report = integrity.verify_state(
            aspec, corrupted, seam="chaos.adaptive.bitflip",
            errors="quarantine",
        )
        if report:
            return "detected"
        fp_post = integrity.fingerprint(aspec, corrupted)
        if not np.allclose(fp_post, fp_pre, rtol=1e-6, atol=1e-3):
            return "detected"  # the fingerprint lane
        q_pre = _np(sk.get_quantile_values(list(_AD_QS)))
        sk.state = corrupted
        q_post = _np(sk.get_quantile_values(list(_AD_QS)))
        sk.state = pre
        same = np.allclose(
            q_post, q_pre, rtol=4 * _REL_ACC, atol=1e-6, equal_nan=True
        )
        return "harmless" if same else "undetected"

    def _fault_ckpt(step: int) -> str:
        from sketches_tpu_torch import checkpoint
        from sketches_tpu_torch.resilience import CheckpointCorrupt

        path = _os.path.join(tmpdir, "torn_adaptive.ckpt")
        checkpoint.save(path, c["adaptive"])  # good previous file
        mode = "truncate" if step % 2 else "raise"
        with faults.active(
            {faults.CHECKPOINT_WRITE: dict(mode=mode, times=1)}
        ):
            try:
                checkpoint.save(path, c["adaptive"])
                crashed = False
            except InjectedFault:
                crashed = True
        if crashed:
            checkpoint.restore(path, device=device)  # previous file survives
            return "detected"
        try:
            checkpoint.restore(path, device=device)
        except CheckpointCorrupt:
            return "detected"
        return "undetected"

    def _fault_kill_switch(step: int) -> str:
        # Arm a collapse-worthy batch under SKETCHES_TPU_ADAPTIVE=0:
        # the trigger must refuse LOUDLY (SpecError), and the refused
        # ingest must leave the facade's mass unchanged.
        sk = c["adaptive"]
        wide = rng.lognormal(
            c["drift"], 8.0, (_AD_STREAMS, _AD_BATCH)
        ).astype(np.float32)
        before = float(_np(sk.count, np.float64).sum())
        from sketches_tpu_torch.analysis import registry as _registry

        _switch = _registry.ADAPTIVE.name
        prior = _os.environ.get(_switch)
        _os.environ[_switch] = "0"
        try:
            try:
                sk.add(wide)
            except SpecError:
                after = float(_np(sk.count, np.float64).sum())
                return "detected" if after == before else "undetected"
            # No collapse was needed for this batch: the switch had
            # nothing to refuse -- ingest went through legitimately.
            for s in range(_AD_STREAMS):
                c["values"][s].extend(float(x) for x in wide[s])
            return "harmless"
        finally:
            if prior is None:
                _os.environ.pop(_switch, None)
            else:
                _os.environ[_switch] = prior

    def _audit(step: int) -> None:
        _ad_quantile_audit(c, step)

    ops = (
        (_ingest, 0.45),
        (_audit, 0.2),
        (_merge_mixed, 0.15),
        (_wire_roundtrip, 0.1),
        (_checkpoint_roundtrip, 0.1),
    )
    op_fns = [o[0] for o in ops]
    op_ps = _np([o[1] for o in ops])
    op_ps = op_ps / op_ps.sum()
    fault_sites = {
        "wire.blob": _fault_wire,
        "state.bitflip": _fault_bitflip,
        "checkpoint.write": _fault_ckpt,
        "adaptive.kill_switch": _fault_kill_switch,
    }
    site_names = tuple(fault_sites)
    try:
        for step in range(steps):
            op = int(rng.choice(len(op_fns), p=op_ps))
            try:
                op_fns[op](step)
            except Exception as e:  # un-faulted op must not fail
                errors.append(f"step {step} op {op}: {e!r}")
                break
            if rng.random() < _FAULT_P:
                site = site_names[int(rng.integers(len(site_names)))]
                try:
                    outcome = fault_sites[site](step)
                except Exception as e:
                    outcome = "undetected"
                    errors.append(f"step {step} site {site}: {e!r}")
                if outcome != "skipped":
                    events.append(
                        {"step": step, "site": site, "outcome": outcome}
                    )
                    _classify_forensics(site, outcome, step)
        expected = _ad_expected_counts(c)
        actual = _ad_actual_counts(c)
        conserved = actual == expected  # EXACT: integer-valued ledger
        if not conserved:
            errors.append(
                f"mass ledger broke: actual {actual:g} != expected"
                f" {expected:g}"
            )
        outcomes: Dict[str, int] = {}
        for ev in events:
            outcomes[ev["outcome"]] = outcomes.get(ev["outcome"], 0) + 1
        ok = (
            conserved and not errors
            and outcomes.get("undetected", 0) == 0
        )
        return {
            "campaign": "adaptive",
            "steps": steps,
            "seed": seed,
            "ok": ok,
            "n_faults": len(events),
            "outcomes": outcomes,
            "events": events,
            "errors": errors,
            "expected_count": expected,
            "final_count": actual,
            "final_levels": _np(
                c["adaptive"].level
            ).tolist(),
            "final_effective_alpha": _np(
                c["adaptive"].effective_alpha(), np.float64
            ).round(5).tolist(),
            "integrity_reports": len(integrity.reports()),
            "health": resilience.health(),
            "telemetry": telemetry.snapshot() if telemetry.enabled()
            else None,
        }
    finally:
        faults.disarm()
        if was_active:
            integrity.arm(was_mode)
        else:
            integrity.disarm()
        if own_tmp is not None:
            own_tmp.cleanup()


# ---------------------------------------------------------------------------
# Windowed campaign (the time-window soak)
# ---------------------------------------------------------------------------

#: Windowed-campaign shape: tiny rings (bounded fused-fold arity keeps
#: the per-arity compile count CI-sized), short virtual slices so a few
#: hundred steps cross many rotation boundaries.
_WD_STREAMS = 8
_WD_BINS = 128
_WD_BATCH = 16
_WD_QS = (0.5, 0.99)
_WD_WINDOWS = (7.0, 30.0, None)


def _wd_audit_ring(name: str, wsk, expected_total: float) -> None:
    """The exact mass-ledger audit (== everywhere, the acceptance
    contract): total == live + retired, every bucket's ledger entry ==
    its device mass, the ring's total == the campaign's expectation,
    and every CACHED maintained aggregate matches its raw-state fold
    bit-for-bit (the two-stacks consistency audit -- a no-op when the
    ``SKETCHES_TPU_WINDOW_AGG`` layer is off or the stacks are
    dropped).  Raises ``SketchError`` on any breach."""
    led = wsk.ledger()
    if led["total"] != led["live"] + led["retired"]:
        raise SketchError(
            f"{name}: ledger broke: total {led['total']:g} != live"
            f" {led['live']:g} + retired {led['retired']:g}"
        )
    if led["total"] != expected_total:
        raise SketchError(
            f"{name}: ledger total {led['total']:g} != expected"
            f" {expected_total:g}"
        )
    device = wsk.device_masses()
    for rung, bid, mass in wsk.buckets():
        got = device.get((rung, bid))
        if got != mass:
            raise SketchError(
                f"{name}: bucket (rung {rung}, id {bid}) ledger"
                f" {mass:g} != device {got}"
            )
    for detail in wsk._agg_audit():
        raise SketchError(f"{name}: stack audit: {detail}")


def run_windowed_campaign(
    steps: int, seed: int, tmpdir: Optional[str] = None, device=None,
    devices=None,
) -> Dict[str, Any]:
    """Run the seeded time-window chaos campaign -> the verdict.

    Three rings rotate under one virtual clock: a dense ring served
    THROUGH the serving tier (fingerprint-set cache keys, poison
    detection), an adaptive ring with a collapse-on-retire ladder, and
    -- when the device pool ``devices`` (every CUDA device by default)
    has >= 2 entries -- a mesh-backed ring that reshards live.  Every step may ingest (clock advances), query a
    window and compare bit-identically against the host-side oracle
    merge, round-trip the windowed checkpoint or wire envelope, or
    reshard; armed fault sites tear rotations mid-ingest
    (``window.rotate_torn``), tear the two-stacks aggregate sync
    (``window.stack_torn`` -- the tear must be swallowed, the stacks
    dropped into the health ledger, and the answers stay oracle-exact),
    silently corrupt a cached maintained aggregate
    (``window.agg_stale`` -- only the stack-consistency audit can see
    it; raw buckets stay clean), tear checkpoint writes, corrupt wire
    envelopes, tear reshards mid-rotation, poison the serve cache, and
    flip the ``SKETCHES_TPU_WINDOWED`` kill switch (which must refuse
    loudly).  The per-bucket mass ledger AND the two-stacks consistency
    audit run with ``==`` after EVERY step.  ``ok`` iff every fault is detected or provably
    harmless, every oracle comparison is bit-identical, and the ledger
    never breaks.  Raises ``SketchValueError`` for non-positive
    ``steps``; campaign-level failures are reported in the verdict,
    not raised.  The other rings live on ``device`` (the pool's first
    device by default).
    """
    if steps <= 0:
        raise SketchValueError("steps must be positive")
    import os as _os

    from sketches_tpu_torch import checkpoint, serve
    from sketches_tpu_torch.analysis import registry as _registry
    from sketches_tpu_torch.backends.wirefmt import (
        windowed_from_bytes,
        windowed_to_bytes,
    )
    from sketches_tpu_torch.batched import SketchSpec
    from sketches_tpu_torch.resilience import SpecError, WireDecodeError
    from sketches_tpu_torch.windows import (
        VirtualClock,
        WindowConfig,
        WindowedSketch,
        oracle_quantile,
    )

    pool = _pool(devices)
    device = resolve_device(pool[0] if device is None else device)
    was_active, was_mode = integrity.enabled(), integrity.mode()
    faults.disarm()
    integrity.arm("quarantine")
    own_tmp = None
    if tmpdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="sketches_windowed_")
        tmpdir = own_tmp.name
    rng = np.random.default_rng(seed)
    clock = VirtualClock(0.0)
    dense_spec = SketchSpec(relative_accuracy=_REL_ACC, n_bins=_WD_BINS)
    ad_spec = SketchSpec(
        relative_accuracy=_REL_ACC, n_bins=_WD_BINS,
        backend="uniform_collapse", collapse_threshold=0.05,
    )
    cfg = WindowConfig(slices_s=(5.0, 20.0), lengths=(3, 3))
    ad_cfg = WindowConfig(
        slices_s=(5.0, 20.0), lengths=(2, 2), collapse_levels=(0, 2)
    )
    srv = serve.SketchServer(clock=clock)
    srv.add_tenant("w", _WD_STREAMS, window=cfg, spec=dense_spec, device=device)
    rings: Dict[str, Any] = {
        "dense": srv.tenant("w"),
        "adaptive": WindowedSketch(
            _WD_STREAMS, spec=ad_spec, config=ad_cfg, clock=clock,
            device=device,
        ),
    }
    if len(pool) >= 2:
        from sketches_tpu_torch.parallel import SketchMesh

        rings["mesh"] = WindowedSketch(
            _WD_STREAMS, spec=dense_spec, config=cfg, clock=clock,
            mesh=SketchMesh(2, devices=pool),
        )
    expected: Dict[str, float] = {k: 0.0 for k in rings}
    events: List[Dict[str, Any]] = []
    errors: List[str] = []

    def _batch():
        return rng.lognormal(
            float(rng.normal(0.0, 0.5)), 0.7, (_WD_STREAMS, _WD_BATCH)
        ).astype(np.float32)

    def _ingest(step: int) -> None:
        clock.advance(float(rng.uniform(0.5, 4.0)))
        for name, wsk in rings.items():
            wsk.add(_batch())
            expected[name] += _WD_STREAMS * _WD_BATCH

    def _query_oracle(step: int) -> None:
        name = ("dense", "adaptive")[step % 2]
        win = _WD_WINDOWS[int(rng.integers(len(_WD_WINDOWS)))]
        wsk = rings[name]
        got = _np(wsk.quantile(_WD_QS, window=win))
        want = _np(oracle_quantile(wsk, _WD_QS, window=win))
        if not np.array_equal(got, want, equal_nan=True):
            raise SketchError(
                f"{name}: window query diverged from the oracle merge"
                f" (window={win}, max |diff|"
                f" {np.nanmax(np.abs(got - want)):g})"
            )

    def _serve_query(step: int) -> None:
        win = _WD_WINDOWS[int(rng.integers(len(_WD_WINDOWS)))]
        res = srv.quantile("w", list(_WD_QS), window=win)
        direct = _np(rings["dense"].quantile(_WD_QS, window=win))
        if not np.array_equal(res.values, direct, equal_nan=True):
            raise SketchError(
                f"serve window answer diverged from the ring"
                f" (tier={res.tier}, window={win})"
            )

    def _checkpoint_roundtrip(step: int) -> None:
        path = _os.path.join(tmpdir, "windowed.ckpt")
        wsk = rings["dense"]
        checkpoint.save_windowed(path, wsk)
        restored = checkpoint.restore_windowed(
            path, clock=VirtualClock(clock.t), device=device
        )
        if restored.ledger() != wsk.ledger() \
                or restored.buckets() != wsk.buckets():
            raise SketchError("windowed checkpoint round trip drifted")

    def _wire_roundtrip(step: int) -> None:
        wsk = rings["adaptive"]
        blob = windowed_to_bytes(wsk)
        restored = windowed_from_bytes(
            ad_spec, blob, clock=VirtualClock(clock.t), device=device
        )
        if restored.ledger() != wsk.ledger() \
                or restored.buckets() != wsk.buckets():
            raise SketchError("windowed wire round trip drifted")

    def _reshard(step: int) -> None:
        wsk = rings.get("mesh")
        if wsk is None:
            return
        target = (1, 2)[step % 2]
        report = wsk.reshard(n_devices=target)
        if report.n_dead:
            raise SketchError("clean windowed reshard reported dead shards")

    def _fault_rotate_torn(step: int) -> str:
        name = ("dense", "adaptive")[step % 2]
        wsk = rings[name]
        clock.advance(float(rng.uniform(5.0, 12.0)))  # rotation now due
        before_led = wsk.ledger()
        before_buckets = wsk.buckets()
        faults.arm(faults.WINDOW_ROTATE_TORN, times=1)
        try:
            wsk.add(_batch())
            return "undetected"  # the tear did not surface
        except InjectedFault:
            pass
        finally:
            faults.disarm()
        if wsk.ledger() != before_led or wsk.buckets() != before_buckets:
            return "undetected"  # the tear mutated the ring
        # The interrupted rotation must complete cleanly afterwards.
        wsk.add(_batch())
        expected[name] += _WD_STREAMS * _WD_BATCH
        return "detected"

    def _fault_ckpt(step: int) -> str:
        path = _os.path.join(tmpdir, "torn_windowed.ckpt")
        wsk = rings["dense"]
        checkpoint.save_windowed(path, wsk)  # good previous file
        mode = "truncate" if step % 2 else "raise"
        with faults.active(
            {faults.CHECKPOINT_WRITE: dict(mode=mode, times=1)}
        ):
            try:
                checkpoint.save_windowed(path, wsk)
                crashed = False
            except InjectedFault:
                crashed = True
        if crashed:
            checkpoint.restore_windowed(
                path, clock=VirtualClock(clock.t), device=device
            )  # previous file must survive
            return "detected"
        try:
            checkpoint.restore_windowed(
                path, clock=VirtualClock(clock.t), device=device
            )
        except CheckpointCorrupt:
            return "detected"
        return "undetected"

    def _fault_wire(step: int) -> str:
        wsk = rings["dense"]
        blob = bytearray(windowed_to_bytes(wsk))
        if not blob:
            return "skipped"
        pos = int(rng.integers(len(blob)))
        blob[pos] ^= 1 << int(rng.integers(8))
        try:
            restored = windowed_from_bytes(
                dense_spec, bytes(blob), clock=VirtualClock(clock.t),
                device=device,
            )
        except (WireDecodeError, SpecError):
            return "detected"  # structural damage refused loudly
        except Exception:  # noqa: BLE001 - any loud failure is detection
            return "detected"
        if restored.ledger() == wsk.ledger() \
                and restored.buckets() == wsk.buckets():
            same_fp = restored.window_plan(None).digest \
                == wsk.window_plan(None).digest
            if same_fp:
                return "harmless"  # flipped a byte the format ignores
            return "detected"  # content moved: the fingerprint lane sees it
        return "detected"  # ledger drifted visibly

    def _fault_reshard_torn(step: int) -> str:
        wsk = rings.get("mesh")
        if wsk is None:
            return "skipped"
        clock.advance(float(rng.uniform(5.0, 9.0)))  # rotation pending
        before_led = wsk.ledger()
        faults.arm(faults.RESHARD_TORN, times=1)
        try:
            wsk.reshard(n_devices=2 if step % 2 else 1)
            return "undetected"
        except InjectedFault:
            pass
        finally:
            faults.disarm()
        if wsk.ledger() != before_led:
            return "undetected"
        got = _np(wsk.quantile(_WD_QS, window=30.0))
        want = _np(oracle_quantile(wsk, _WD_QS, window=30.0))
        return (
            "detected"
            if np.array_equal(got, want, equal_nan=True)
            else "undetected"
        )

    def _fault_cache_poison(step: int) -> str:
        win = 30.0
        srv.quantile("w", list(_WD_QS), window=win)  # fill the entry
        direct = _np(rings["dense"].quantile(_WD_QS, window=win))
        before = srv.stats()["cache_poisoned"]
        faults.arm(faults.SERVE_CACHE_POISON, times=1)
        try:
            res = srv.quantile("w", list(_WD_QS), window=win)
        finally:
            faults.disarm()
        if res.cached and srv.stats()["cache_poisoned"] == before:
            # The poison flip may land on a bit the checksum round-trips
            # identically only if it never fired; a served hit must have
            # re-verified clean against the live fingerprint.
            return (
                "harmless"
                if np.array_equal(res.values, direct, equal_nan=True)
                else "undetected"
            )
        return (
            "detected"
            if np.array_equal(res.values, direct, equal_nan=True)
            and srv.stats()["cache_poisoned"] == before + 1
            else "undetected"
        )

    def _fault_kill_switch(step: int) -> str:
        _switch = _registry.WINDOWED.name
        prior = _os.environ.get(_switch)
        _os.environ[_switch] = "0"
        try:
            try:
                WindowedSketch(2, spec=dense_spec, clock=clock, device=device)
                return "undetected"
            except SpecError:
                pass
            try:
                srv.add_tenant(
                    f"k{step}", 2, window=True, spec=dense_spec, device=device
                )
                return "undetected"
            except SpecError:
                return "detected"
        finally:
            if prior is None:
                _os.environ.pop(_switch, None)
            else:
                _os.environ[_switch] = prior

    def _fault_stack_torn(step: int) -> str:
        name = ("dense", "adaptive")[step % 2]
        wsk = rings[name]
        if not wsk._agg_enabled:
            return "skipped"  # kill-switch lane: the site never fires
        clock.advance(float(rng.uniform(5.0, 12.0)))  # rotation due
        before = resilience.health()["counters"].get(
            "window.stack_torn", 0
        )
        faults.arm(faults.WINDOW_STACK_TORN, times=1)
        try:
            wsk.add(_batch())  # sync tears AFTER the rotation commit
        finally:
            faults.disarm()
        expected[name] += _WD_STREAMS * _WD_BATCH
        if wsk._agg_stacks is not None:
            return "undetected"  # torn sync left stale stacks behind
        after = resilience.health()["counters"].get(
            "window.stack_torn", 0
        )
        if after != before + 1:
            return "undetected"  # the tear went unaccounted
        # The degraded path must still answer oracle-exactly (the next
        # plan rebuilds the stacks lazily, zero upfront merges).
        got = _np(wsk.quantile(_WD_QS, window=30.0))
        want = _np(oracle_quantile(wsk, _WD_QS, window=30.0))
        return (
            "detected"
            if np.array_equal(got, want, equal_nan=True)
            else "undetected"
        )

    def _fault_agg_stale(step: int) -> str:
        name = ("dense", "adaptive")[step % 2]
        wsk = rings[name]
        if not wsk._agg_enabled:
            return "skipped"  # kill-switch lane: no aggregates exist
        wsk.quantile(_WD_QS, window=30.0)  # warm the aggregate caches
        stacks = wsk._agg_stacks
        if not stacks or (
            wsk._agg_fold_cache is None and not any(
                s._combined or s._tails or s.front for s in stacks
            )
        ):
            return "skipped"  # nothing cached yet to corrupt
        faults.arm(faults.WINDOW_AGG_STALE, times=1)
        try:
            wsk.window_plan(30.0)  # plan time applies the stale flips
        finally:
            faults.disarm()
        violations = wsk._agg_audit()
        if not violations:
            # The flip landed invisibly to exact content comparison
            # (the sign bit of a zero count: -0.0 == 0.0) -- then the
            # answer must still be oracle-exact, or the audit MISSED
            # real corruption.
            got = _np(wsk.quantile(_WD_QS, window=30.0))
            want = _np(oracle_quantile(wsk, _WD_QS, window=30.0))
            return (
                "harmless"
                if np.array_equal(got, want, equal_nan=True)
                else "undetected"
            )
        # Derived state: drop the poisoned caches, rebuild lazily, and
        # the ring must answer oracle-exactly again.
        wsk._agg_invalidate()
        got = _np(wsk.quantile(_WD_QS, window=30.0))
        want = _np(oracle_quantile(wsk, _WD_QS, window=30.0))
        ok = not wsk._agg_audit() \
            and np.array_equal(got, want, equal_nan=True)
        return "detected" if ok else "undetected"

    ops = (
        (_ingest, 0.4),
        (_query_oracle, 0.2),
        (_serve_query, 0.15),
        (_checkpoint_roundtrip, 0.08),
        (_wire_roundtrip, 0.07),
        (_reshard, 0.1),
    )
    op_fns = [o[0] for o in ops]
    op_ps = _np([o[1] for o in ops])
    op_ps = op_ps / op_ps.sum()
    fault_sites = {
        "window.rotate_torn": _fault_rotate_torn,
        "checkpoint.write": _fault_ckpt,
        "wire.blob": _fault_wire,
        "reshard.torn": _fault_reshard_torn,
        "serve.cache_poison": _fault_cache_poison,
        "windowed.kill_switch": _fault_kill_switch,
        "window.stack_torn": _fault_stack_torn,
        "window.agg_stale": _fault_agg_stale,
    }
    site_names = tuple(fault_sites)
    try:
        for step in range(steps):
            op = int(rng.choice(len(op_fns), p=op_ps))
            try:
                op_fns[op](step)
            except Exception as e:  # un-faulted op must not fail
                errors.append(f"step {step} op {op}: {e!r}")
                break
            if rng.random() < _FAULT_P:
                site = site_names[int(rng.integers(len(site_names)))]
                try:
                    outcome = fault_sites[site](step)
                except Exception as e:
                    outcome = "undetected"
                    errors.append(f"step {step} site {site}: {e!r}")
                if outcome != "skipped":
                    events.append(
                        {"step": step, "site": site, "outcome": outcome}
                    )
                    _classify_forensics(site, outcome, step)
            # The acceptance contract: the ledger is exact at EVERY
            # step, not just at the end.
            try:
                for name, wsk in rings.items():
                    _wd_audit_ring(name, wsk, expected[name])
            except SketchError as e:
                errors.append(f"step {step} audit: {e!r}")
                break
        outcomes: Dict[str, int] = {}
        for ev in events:
            outcomes[ev["outcome"]] = outcomes.get(ev["outcome"], 0) + 1
        ok = not errors and outcomes.get("undetected", 0) == 0
        ledgers = {name: wsk.ledger() for name, wsk in rings.items()}
        return {
            "campaign": "windowed",
            "steps": steps,
            "seed": seed,
            "ok": ok,
            "n_faults": len(events),
            "outcomes": outcomes,
            "events": events,
            "errors": errors,
            "virtual_clock_s": clock.t,
            "ledgers": ledgers,
            "expected": expected,
            "rung_effective_alpha": rings[
                "adaptive"
            ].rung_effective_alpha(),
            "serve_stats": srv.stats(),
            "integrity_reports": len(integrity.reports()),
            "health": resilience.health(),
            "telemetry": telemetry.snapshot() if telemetry.enabled()
            else None,
        }
    finally:
        faults.disarm()
        if was_active:
            integrity.arm(was_mode)
        else:
            integrity.disarm()
        if own_tmp is not None:
            own_tmp.cleanup()


# ---------------------------------------------------------------------------
# Fabric campaign (the sharded-serve soak)
# ---------------------------------------------------------------------------

#: Fabric-campaign fleet shape: 4 virtual hosts, 3 copies per tenant --
#: small enough for a CPU soak, big enough that every host kill leaves
#: both a promotable verified replica and a survivor set to re-provision
#: onto.
_FB_HOSTS = 4
_FB_REPLICATION = 3
_FB_STREAMS = 4
_FB_BINS = 128
_FB_BATCH = 16
_FB_QS = (0.5, 0.99)
_FB_TENANTS = ("alpha", "beta", "gamma", "delta")
_FB_STALENESS_S = 600.0


def run_fabric_campaign(steps: int, seed: int, device=None) -> Dict[str, Any]:
    """Run the seeded SHARDED-SERVE-FABRIC campaign -> the verdict.

    A 4-host fabric serves 4 tenants at replication 3 under a virtual
    clock while the campaign kills whole hosts mid-ingest (the primary's
    tenants must re-home onto fingerprint-verified replicas with the
    dropped mass itemized EXACTLY), partitions primaries (reads must
    degrade to declared-staleness replicas, writes must refuse,
    beyond-bound replicas must refuse loudly), silently corrupts replica
    state (``fabric.replica_stale`` -- only the serve-time fingerprint
    gate may catch it; a corrupt replica must NEVER serve), tears
    partition heals (``mesh.partition_heal`` -- the host must stay
    partitioned, never half-healed) and replica handoffs
    (``reshard.torn`` -- the source replica must stay intact), and flips
    the ``SKETCHES_TPU_FABRIC`` kill switch (which must refuse
    construction loudly).

    The accounting contract: every served answer is bit-identical to
    the oracle fold of the mass it declares to cover (the live mirror
    for primary reads, the canonical synced snapshot for replica
    reads), and the per-stream mass ledger closes EXACTLY
    (``expected + dropped == ingested``, ``==`` never approximately)
    after every step AND every failover.  Anything else is
    ``undetected`` and fails the run.

    Under ``SKETCHES_TPU_FABRIC=0`` the campaign runs the disarmed
    drill instead: every construction probe must refuse loudly
    (``SpecError``) while single-process serving stays available; the
    verdict carries ``disarmed: True``.  Raises ``SketchValueError``
    for non-positive ``steps``; campaign-level failures land in the
    verdict's ``errors`` list, never raised.  ``device``: the card by
    default.
    """
    if steps <= 0:
        raise SketchValueError("steps must be positive")
    import os as _os

    from sketches_tpu_torch import serve
    from sketches_tpu_torch.analysis import registry as _registry
    from sketches_tpu_torch.batched import BatchedDDSketch, SketchSpec
    from sketches_tpu_torch.fabric import FabricConfig, ServeFabric
    from sketches_tpu_torch.resilience import (
        FabricUnavailable,
        ReplicaStale,
        SpecError,
    )
    from sketches_tpu_torch.windows import VirtualClock

    device = resolve_device(device)
    if not _registry.enabled(_registry.FABRIC):
        # Disarmed lane: the switch must make every fabric construction
        # refuse loudly -- and leave single-process serving untouched.
        events: List[Dict[str, Any]] = []
        errors: List[str] = []
        for step in range(steps):
            try:
                ServeFabric(FabricConfig(n_hosts=2))
                errors.append(
                    f"step {step}: disarmed fabric constructed silently"
                )
                outcome = "undetected"
            except SpecError:
                outcome = "detected"
            events.append(
                {"step": step, "site": "fabric.kill_switch",
                 "outcome": outcome}
            )
        try:
            solo = serve.SketchServer()
            solo.add_tenant("solo", 2, relative_accuracy=_REL_ACC, device=device)
            solo.ingest("solo", np.ones((2, 4), np.float32))
            solo.query("solo", (0.5,))
        except Exception as e:  # noqa: BLE001 - any break is a finding
            errors.append(f"disarmed single-process serving broke: {e!r}")
        outcomes: Dict[str, int] = {}
        for ev in events:
            outcomes[ev["outcome"]] = outcomes.get(ev["outcome"], 0) + 1
        return {
            "campaign": "fabric",
            "steps": steps,
            "seed": seed,
            "disarmed": True,
            "ok": not errors and outcomes.get("undetected", 0) == 0,
            "n_faults": len(events),
            "outcomes": outcomes,
            "events": events[:16],  # one probe per step; keep it short
            "errors": errors,
            "health": resilience.health(),
            "telemetry": telemetry.snapshot() if telemetry.enabled()
            else None,
        }

    from sketches_tpu_torch.backends.wirefmt import (
        payload_from_bytes,
        payload_to_bytes,
    )

    was_active, was_mode = integrity.enabled(), integrity.mode()
    faults.disarm()
    integrity.arm("quarantine")
    rng = np.random.default_rng(seed)
    clock = VirtualClock(0.0)
    spec = SketchSpec(relative_accuracy=_REL_ACC, n_bins=_FB_BINS)
    fab = ServeFabric(
        FabricConfig(
            n_hosts=_FB_HOSTS, replication=_FB_REPLICATION,
            staleness_s=_FB_STALENESS_S,
        ),
        clock=clock,
    )
    # The oracle: a live mirror per tenant (fed bit-identical batches ->
    # bit-identical primary state) plus the canonical synced snapshot
    # per (tenant, replica host) -- exactly what the fabric's sync
    # ledger promises each replica holds.
    mirror: Dict[str, BatchedDDSketch] = {}
    synced: Dict[str, Dict[int, Any]] = {}
    expected: Dict[str, np.ndarray] = {}
    dropped: Dict[str, np.ndarray] = {}
    total_in: Dict[str, float] = {}
    events = []
    errors = []

    def _canon(state):
        # The wire seam's normalizing round trip: content-identical,
        # canonical key window -- bit-identical to what a replica holds.
        return payload_from_bytes(
            spec, payload_to_bytes(spec, state), device=device
        )

    def _snap(nm: str):
        return (_canon(mirror[nm].state), expected[nm].copy())

    def _usable(h: int) -> bool:
        return h in fab.live_hosts()

    def _model_sync(nm: str, n_synced: int) -> None:
        reps = [h for h in fab.placement(nm)[1:] if _usable(h)]
        if n_synced != len(reps):
            raise SketchError(
                f"{nm}: fabric synced {n_synced} replicas, model expected"
                f" {len(reps)}"
            )
        snap = _snap(nm)
        for h in reps:
            synced[nm][h] = snap

    def _model_refresh(nm: str) -> None:
        # Reconcile the model's replica set with the fabric's placement
        # right after a verb that re-provisioned: a NEW replica was
        # synced from the live primary at provision time.
        reps = set(fab.placement(nm)[1:])
        for h in list(synced[nm]):
            if h not in reps:
                del synced[nm][h]
        fresh = [h for h in reps if h not in synced[nm] and _usable(h)]
        if fresh:
            snap = _snap(nm)
            for h in fresh:
                synced[nm][h] = snap

    def _model_heal(host_id: int) -> None:
        # heal_partition resynced every replica ON the healed host whose
        # primary was reachable at plan time.
        for nm in _FB_TENANTS:
            pl = fab.placement(nm)
            if host_id in pl[1:] and pl[0] != host_id:
                synced[nm][host_id] = _snap(nm)

    def _oracle_quantiles(state) -> np.ndarray:
        return _np(
            BatchedDDSketch(
                _FB_STREAMS, spec=spec, state=state, device=device
            ).get_quantile_values(list(_FB_QS))
        )

    def _batch():
        return rng.lognormal(
            float(rng.normal(0.0, 0.5)), 0.7, (_FB_STREAMS, _FB_BATCH)
        ).astype(np.float32)

    def _pick() -> str:
        return _FB_TENANTS[int(rng.integers(len(_FB_TENANTS)))]

    for nm in _FB_TENANTS:
        fab.add_tenant(nm, _FB_STREAMS, spec=spec, device=device)
        mirror[nm] = BatchedDDSketch(_FB_STREAMS, spec=spec, device=device)
        synced[nm] = {}
        expected[nm] = np.zeros(_FB_STREAMS, np.float64)
        dropped[nm] = np.zeros(_FB_STREAMS, np.float64)
        total_in[nm] = 0.0
        # Seed every tenant with mass and a sync point so replicas are
        # promotable from step 0.
        b = _batch()
        fab.ingest(nm, b)
        mirror[nm].add(b)
        expected[nm] += float(_FB_BATCH)
        total_in[nm] += float(_FB_STREAMS * _FB_BATCH)
        _model_sync(nm, fab.sync(nm))

    def _ingest(step: int) -> None:
        clock.advance(float(rng.uniform(0.5, 4.0)))
        nm = _pick()
        b = _batch()
        fab.ingest(nm, b)
        mirror[nm].add(b)
        expected[nm] += float(_FB_BATCH)
        total_in[nm] += float(_FB_STREAMS * _FB_BATCH)

    def _read(step: int) -> None:
        nm = _pick()
        res = fab.quantile(nm, _FB_QS)
        if res.role not in ("primary", "cache") or res.hedged:
            raise SketchError(
                f"{nm}: healthy-fleet read served role={res.role}"
                f" hedged={res.hedged}"
            )
        want = _np(mirror[nm].get_quantile_values(list(_FB_QS)))
        if not np.array_equal(
            _np(res.values), want, equal_nan=True
        ):
            raise SketchError(
                f"{nm}: primary answer diverged from the live oracle"
            )

    def _sync(step: int) -> None:
        nm = _pick()
        _model_sync(nm, fab.sync(nm))

    def _rebalance(step: int) -> None:
        nm = _pick()
        pl = fab.placement(nm)
        free = [h for h in fab.live_hosts() if h not in pl]
        srcs = [h for h in pl[1:] if _usable(h) and h in synced[nm]]
        if not free or not srcs:
            return
        src = srcs[int(rng.integers(len(srcs)))]
        dst = free[int(rng.integers(len(free)))]
        fab.handoff_replica(nm, src, dst)
        synced[nm][dst] = synced[nm].pop(src)

    def _audit(step: int) -> None:
        for nm in _FB_TENANTS:
            led = fab.ledger(nm)
            if not np.array_equal(led["expected_count"], expected[nm]):
                raise SketchError(f"{nm}: expected_count ledger drifted")
            if not np.array_equal(led["dropped_count"], dropped[nm]):
                raise SketchError(f"{nm}: dropped_count ledger drifted")
            if led["expected_total"] + led["dropped_total"] \
                    != total_in[nm]:
                raise SketchError(
                    f"{nm}: mass not conserved:"
                    f" {led['expected_total']} + {led['dropped_total']}"
                    f" != {total_in[nm]}"
                )
            live = _np(mirror[nm].state.count, np.float64)
            if not np.array_equal(live, expected[nm]):
                raise SketchError(f"{nm}: oracle mirror count drifted")

    def _fault_host_kill(step: int) -> str:
        live = fab.live_hosts()
        if len(live) < 3:
            return "skipped"
        victim = int(live[int(rng.integers(len(live)))])
        prims = sorted(
            nm for nm in _FB_TENANTS if fab.placement(nm)[0] == victim
        )
        reports = fab.kill_host(victim)
        if sorted(r.tenant for r in reports) != prims:
            return "undetected"
        for r in reports:
            nm = r.tenant
            snap = synced[nm].get(r.to_host)
            if snap is None:
                return "undetected"  # promoted a never-synced copy
            state_syn, count_syn = snap
            want_drop = expected[nm] - count_syn
            if not r.exact or not np.array_equal(
                r.dropped_count, want_drop
            ):
                return "undetected"  # the itemized dropped mass is wrong
            dropped[nm] = dropped[nm] + want_drop
            expected[nm] = count_syn.copy()
            # The promoted replica IS the tenant now: the live oracle
            # resets to the canonical synced snapshot.
            mirror[nm] = BatchedDDSketch(
                _FB_STREAMS, spec=spec, state=state_syn, device=device
            )
        for nm in _FB_TENANTS:
            _model_refresh(nm)
        for r in reports:
            res = fab.quantile(r.tenant, _FB_QS)
            want = _np(
                mirror[r.tenant].get_quantile_values(list(_FB_QS))
            )
            if not np.array_equal(
                _np(res.values), want, equal_nan=True
            ):
                return "undetected"  # wrong answer after failover
        # A replacement process joins under the dead host's id; every
        # under-replicated tenant re-provisions through the sync path.
        fab.revive_host(victim)
        for nm in _FB_TENANTS:
            _model_refresh(nm)
        return "re-homed"

    def _fault_partition(step: int) -> str:
        nm = _pick()
        _model_sync(nm, fab.sync(nm))
        p = fab.placement(nm)[0]
        fab.partition_host(p)
        ok = True
        try:
            res = fab.quantile(nm, _FB_QS)
            if not (res.degraded and res.role == "replica"):
                ok = False
            else:
                state_syn, _ = synced[nm][res.host]
                if not np.array_equal(
                    _np(res.values),
                    _oracle_quantiles(state_syn),
                    equal_nan=True,
                ):
                    ok = False  # degraded answer != synced oracle fold
            try:
                fab.ingest(nm, _batch())
                ok = False  # a partitioned primary must refuse writes
            except FabricUnavailable:
                pass
            # Beyond the declared bound the replica must refuse loudly,
            # never serve silently stale.
            clock.advance(_FB_STALENESS_S + 1.0)
            try:
                fab.quantile(nm, _FB_QS)
                ok = False
            except ReplicaStale as e:
                if e.reason != "staleness":
                    ok = False
        finally:
            fab.heal_partition(p)
        _model_heal(p)
        res = fab.quantile(nm, _FB_QS)
        want = _np(mirror[nm].get_quantile_values(list(_FB_QS)))
        if res.role not in ("primary", "cache") or not np.array_equal(
            _np(res.values), want, equal_nan=True
        ):
            ok = False
        return "degraded" if ok else "undetected"

    def _fault_replica_stale(step: int) -> str:
        nm = _pick()
        _model_sync(nm, fab.sync(nm))
        p = fab.placement(nm)[0]
        fab.partition_host(p)
        before = fab.stats()["stale_refusals"]
        # Fresh seed per firing: the corruption coordinates must roam,
        # not re-flip the same bit of the same bin every time.
        faults.arm(faults.FABRIC_REPLICA_STALE, times=1, seed=seed + step)
        served = None
        try:
            try:
                served = fab.quantile(nm, _FB_QS)
            except ReplicaStale:
                pass  # every reachable replica refused: loud is correct
        finally:
            faults.disarm()
        refusals = fab.stats()["stale_refusals"] - before
        if served is not None:
            state_syn, _ = synced[nm][served.host]
            right = np.array_equal(
                _np(served.values),
                _oracle_quantiles(state_syn),
                equal_nan=True,
            )
        else:
            right = True  # refusing everywhere is never a wrong answer
        fab.heal_partition(p)
        _model_heal(p)
        # Repair the corrupted copy through the sync path before the
        # next step touches it.
        _model_sync(nm, fab.sync(nm))
        if not right:
            return "undetected"  # a corrupt replica SERVED: booby trap failed
        if refusals == 0:
            # The flip landed invisibly to the content fingerprint (the
            # sign bit of a zero count): the served answer was proven
            # bit-identical above, so the corruption is harmless.
            return "harmless" if served is not None else "undetected"
        return "detected"

    def _fault_heal_torn(step: int) -> str:
        live = fab.live_hosts()
        if len(live) < 2:
            return "skipped"
        h = int(live[int(rng.integers(len(live)))])
        fab.partition_host(h)
        faults.arm(faults.MESH_PARTITION_HEAL, times=1)
        try:
            fab.heal_partition(h)
            torn = False
        except InjectedFault:
            torn = True
        finally:
            faults.disarm()
        if not torn:
            return "undetected"  # the armed tear never surfaced
        if h in fab.live_hosts():
            return "undetected"  # a torn heal half-committed
        fab.heal_partition(h)
        _model_heal(h)
        return "detected"

    def _fault_handoff_torn(step: int) -> str:
        nm = _pick()
        pl = fab.placement(nm)
        free = [h for h in fab.live_hosts() if h not in pl]
        srcs = [h for h in pl[1:] if _usable(h) and h in synced[nm]]
        if not free or not srcs:
            return "skipped"
        src = srcs[int(rng.integers(len(srcs)))]
        dst = free[int(rng.integers(len(free)))]
        faults.arm(faults.RESHARD_TORN, times=1)
        try:
            fab.handoff_replica(nm, src, dst)
            torn = False
        except InjectedFault:
            torn = True
        except SpecError:
            return "skipped"  # source had no ledger to move
        finally:
            faults.disarm()
        if not torn:
            return "undetected"
        if fab.placement(nm) != pl:
            return "undetected"  # the torn handoff moved the replica
        # The interrupted handoff must complete cleanly afterwards,
        # carrying the fingerprint (and the cache keyed on it) along.
        rep = fab.handoff_replica(nm, src, dst)
        synced[nm][dst] = synced[nm].pop(src)
        if not rep.cache_preserved:
            return "undetected"
        return "detected"

    def _fault_kill_switch(step: int) -> str:
        _switch = _registry.FABRIC.name
        prior = _os.environ.get(_switch)
        _os.environ[_switch] = "0"
        try:
            try:
                ServeFabric(FabricConfig(n_hosts=2))
                return "undetected"
            except SpecError:
                pass
        finally:
            if prior is None:
                _os.environ.pop(_switch, None)
            else:
                _os.environ[_switch] = prior
        # The switch gates construction, not the running fleet: the
        # armed fabric must still answer correctly.
        nm = _pick()
        res = fab.quantile(nm, _FB_QS)
        want = _np(mirror[nm].get_quantile_values(list(_FB_QS)))
        return (
            "detected"
            if np.array_equal(_np(res.values), want, equal_nan=True)
            else "undetected"
        )

    ops = (
        (_ingest, 0.4),
        (_read, 0.3),
        (_sync, 0.2),
        (_rebalance, 0.1),
    )
    op_fns = [o[0] for o in ops]
    op_ps = _np([o[1] for o in ops])
    op_ps = op_ps / op_ps.sum()
    fault_sites = {
        "mesh.host_loss": _fault_host_kill,
        "dcn.partition": _fault_partition,
        "fabric.replica_stale": _fault_replica_stale,
        "mesh.partition_heal": _fault_heal_torn,
        "reshard.torn": _fault_handoff_torn,
        "fabric.kill_switch": _fault_kill_switch,
    }
    site_names = tuple(fault_sites)
    try:
        for step in range(steps):
            op = int(rng.choice(len(op_fns), p=op_ps))
            try:
                op_fns[op](step)
            except Exception as e:  # un-faulted op must not fail
                errors.append(f"step {step} op {op}: {e!r}")
                break
            if rng.random() < _FAULT_P:
                site = site_names[int(rng.integers(len(site_names)))]
                try:
                    outcome = fault_sites[site](step)
                except Exception as e:
                    outcome = "undetected"
                    errors.append(f"step {step} site {site}: {e!r}")
                if outcome != "skipped":
                    events.append(
                        {"step": step, "site": site, "outcome": outcome}
                    )
                    _classify_forensics(site, outcome, step)
            # The acceptance contract: the mass ledger closes exactly at
            # EVERY step, not just at the end.
            try:
                _audit(step)
            except SketchError as e:
                errors.append(f"step {step} audit: {e!r}")
                break
        outcomes = {}
        for ev in events:
            outcomes[ev["outcome"]] = outcomes.get(ev["outcome"], 0) + 1
        ok = not errors and outcomes.get("undetected", 0) == 0
        ledgers = {}
        for nm in _FB_TENANTS:
            led = fab.ledger(nm)
            ledgers[nm] = {
                "expected_total": led["expected_total"],
                "dropped_total": led["dropped_total"],
                "ingested_total": total_in[nm],
                "hosts": list(led["hosts"]),
                "fingerprint": led.get("fingerprint"),
            }
        return {
            "campaign": "fabric",
            "steps": steps,
            "seed": seed,
            "disarmed": False,
            "ok": ok,
            "n_faults": len(events),
            "outcomes": outcomes,
            "events": events,
            "errors": errors,
            "virtual_clock_s": clock.t,
            "ledgers": ledgers,
            "fabric_stats": fab.stats(),
            "integrity_reports": len(integrity.reports()),
            "health": resilience.health(),
            "telemetry": telemetry.snapshot() if telemetry.enabled()
            else None,
        }
    finally:
        faults.disarm()
        if was_active:
            integrity.arm(was_mode)
        else:
            integrity.disarm()


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry point: run the campaign, write the verdict, exit 0 iff
    every injected fault was accounted for (1 otherwise).

    ``--device`` names the torch device every campaign runs on (the card
    by default; ``--device cpu`` runs the CPU, where each kernel runs its
    plain version); the elastic and windowed campaigns' meshes take
    ``POOL`` entries of it.  Unexpected campaign errors land
    in the verdict's ``errors`` list and fail the run rather than
    crashing.
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m sketches_tpu_torch.chaos",
        description="seeded chaos-soak campaign: inject faults with the"
        " integrity layer armed; every fault must be detected or harmless",
    )
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--campaign",
        choices=("core", "serve", "elastic", "adaptive", "windowed", "fabric"),
        default="core",
        help="core: the integrity soak over the storage/engine sites;"
        " serve: the serving-tier soak over the serve.* sites (every"
        " fault shed, hedged, or detected); elastic: the kill-and-regrow"
        " soak over the mesh.shard/mesh.host_loss/dcn.partition/"
        "reshard.torn sites across 1/2/4/8-device meshes (every fault"
        " detected or recovered with exact mass accounting); adaptive:"
        " the accuracy-backend soak (collapse mid-ingest, mixed-gamma"
        " merges, backend wire round-trips under injected corruption,"
        " kill-switch refusal -- alpha contract audited at the"
        " effective alpha, mass ledger exact); windowed: the"
        " time-window soak (rotation-mid-ingest tears, torn windowed"
        " checkpoints, wire corruption, reshard-during-rotation, serve"
        " cache poison, kill-switch refusal -- window queries"
        " bit-identical to the oracle merge, per-bucket mass ledger"
        " exact at every step); fabric: the sharded-serve soak (host"
        " kills with fingerprint-verified failover and exact"
        " dropped-mass itemization, primary partitions degrading to"
        " declared-staleness replica reads, silent replica corruption"
        " that must never serve, torn heals and handoffs, kill-switch"
        " refusal -- every answer bit-identical to its oracle fold)",
    )
    parser.add_argument(
        "--mode", choices=("raise", "quarantine"), default="raise",
        help="armed integrity behavior during the (core) soak",
    )
    parser.add_argument(
        "--out", default=None, metavar="PATH",
        help="write the verdict JSON here (stdout always gets a summary)",
    )
    parser.add_argument(
        "--forensics", default=None, metavar="PATH",
        help="write the campaign's most recent forensic bundle here"
        " (requires the flight recorder armed, i.e."
        " SKETCHES_TPU_TELEMETRY=1; explain it with"
        " python -m sketches_tpu_torch.tracing --explain PATH trigger)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device the campaign runs on (default: the card;"
        " 'cpu' runs every kernel's plain version)",
    )
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    pool = [device] * POOL

    if args.campaign == "serve":
        verdict = run_serve_campaign(args.steps, args.seed, device=device)
    elif args.campaign == "elastic":
        verdict = run_elastic_campaign(
            args.steps, args.seed, mode=args.mode, device=device, devices=pool
        )
    elif args.campaign == "adaptive":
        verdict = run_adaptive_campaign(args.steps, args.seed, device=device)
    elif args.campaign == "windowed":
        verdict = run_windowed_campaign(
            args.steps, args.seed, device=device, devices=pool
        )
    elif args.campaign == "fabric":
        verdict = run_fabric_campaign(args.steps, args.seed, device=device)
    else:
        verdict = run_campaign(
            args.steps, args.seed, mode=args.mode, device=device
        )
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(verdict, f, indent=1, sort_keys=True)
            f.write("\n")
    if args.forensics:
        bundle = tracing.last_bundle()
        if bundle is not None:
            with open(args.forensics, "w", encoding="utf-8") as f:
                json.dump(bundle, f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"chaos: forensic bundle -> {args.forensics}")
        else:
            print(
                "chaos: no forensic bundle recorded (flight recorder"
                " disarmed? arm with SKETCHES_TPU_TELEMETRY=1)"
            )
    print(
        f"chaos: {verdict['steps']} steps, seed {verdict['seed']},"
        f" {verdict['n_faults']} faults injected, outcomes"
        f" {verdict['outcomes']}, ok={verdict['ok']}"
    )
    for err in verdict["errors"]:
        print(f"chaos error: {err}")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())

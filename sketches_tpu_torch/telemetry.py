"""Self-sketching runtime telemetry of the PyTorch port (counterpart of
``sketches_tpu.telemetry``): the library instruments itself with its own
sketches.

Every timed section feeds a **host DDSketch with a LogarithmicMapping**
(the port's own ``ddsketch.BaseDDSketch`` over ``store.DenseStore``, at
``HISTOGRAM_REL_ACC`` alpha), so the p50/p99 a snapshot reports carry the
paper's relative-error guarantee rather than a bucket boundary's.  Three
surfaces, with the JAX package's names, formats and semantics:

* **Metric registry** -- process-wide counters, gauges, and
  sketch-backed latency histograms, keyed by a **declared inventory**
  (:data:`METRICS`, the JAX package's names, kinds, merge policies and
  docs: a fleet that scrapes both packages sees one HELP text per
  metric).  Recording against an undeclared name raises; user code
  extends the inventory with :func:`declare`.
* **Trace spans** -- :func:`span`/:func:`finish_span` record Chrome-trace
  ``X`` events (per-thread track, bounded ring, drops counted) and feed
  the span's histogram on exit.  :func:`call_spans` is the hot path's
  seam: ``BatchedDDSketch.add`` and its queries open one root span and
  name each layer inside it (:data:`CALL_SPANS`); while a
  ``torch.profiler`` records, every span is also a
  ``record_function`` range named ``sketches_tpu_torch.<span>``, in the
  same trace as the kernels it launches.
* **Exporters** -- :func:`snapshot` (JSON-safe dict, with the
  ``resilience.health()`` ledger bridged in), :func:`prometheus_text`
  (text exposition; histograms as summaries), :func:`chrome_trace` (host
  spans on :data:`CHROME_PID_SPANS`, the profiling layer's
  device-clocked dispatches on :data:`CHROME_PID_DEVICE`).

Arming: OFF by default.  ``SKETCHES_TPU_TELEMETRY=1`` (declared in
``analysis/registry.py``, shared with the JAX package) arms at process
start; :func:`enable` / :func:`disable` arm programmatically.  Every
instrumented seam guards on ``telemetry._ACTIVE``, so the disarmed layer
costs one attribute read + bool test per dispatch -- no clock read, no
allocation, no device synchronize (the booby-trap test in
``tests/test_torch_telemetry.py`` proves it).  A :func:`call_spans` seam
is on while the layer is armed or a torch profiler records; off, it
costs one bool and one profiler check per call and one ``None`` test per
inner span.  :func:`clock` and
:func:`wall_time` are the port's one clock boundary: the resilience
ledger, the flight recorder, profiling and the accuracy audit read time
through them.

Fleet semantics: snapshots are **mergeable**.  Every histogram summary
embeds its sketch's sparse bin state, so :func:`merge_snapshots` folds N
per-process snapshots -- of either package -- into one fleet-wide
snapshot: counters by sum, gauges by their declared ``merge`` policy,
histograms by DDSketch bin addition (the merged p50/p99 keep the
``HISTOGRAM_REL_ACC`` guarantee).  A declared :data:`SLOS` inventory is
evaluated by :func:`check_slo` against any snapshot, merged or not.

Tracing semantics: spans and histogram observations taken while the
flight recorder (``sketches_tpu_torch.tracing``) is armed link to the
current ``TraceContext`` -- chrome events carry the ids (rendered as
causal flow arrows), latency-histogram bins keep bounded ``(trace_id,
wall_time, value)`` **exemplar reservoirs** (deterministic splitmix64
bottom-k; they survive :func:`merge_snapshots` by concat +
re-reservoir, drops counted), :func:`prometheus_text` annotates quantile
lines OpenMetrics-style, and :func:`exemplars_for` answers "which traces
sit behind this histogram's p99 bin".

Timebase: a trace event's ``ts`` is wall-clock microseconds since the
Unix epoch, read as ``perf_counter`` from one ``time_ns`` /
``perf_counter_ns`` anchor taken at import, :func:`enable` and
:func:`reset`.  A ``torch.profiler`` export stamps the same clock minus
its ``baseTimeNanoseconds``, so the two exports overlay in Perfetto once
that base is added back (:func:`chrome_trace` says so in its
``otherData``).

CLI: ``python -m sketches_tpu_torch.telemetry --merge A.json B.json ...
[--out M.json]`` folds snapshot files; ``--check-slo SNAPSHOT.json``
evaluates the SLO inventory (exit 1 on any burning SLO, 2 when nothing
was evaluable).  The JAX package's bench gate (``--check-bench``) reads
its own ``bench.py`` captures and has no counterpart here: the port's
benchmark is ``sketchbench/``.

Failure modes: recording against an undeclared metric name (or the wrong
kind) raises ``SketchValueError``; a full trace ring drops the newest
events and counts them (``snapshot()['spans']['dropped']`` and the
``spans.dropped`` counter); merging snapshots with different histogram
relative accuracies (or snapshots without embedded bin state) raises
``SketchValueError``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from sketches_tpu_torch.analysis import registry

__all__ = [
    "TELEMETRY_ENV",
    "HISTOGRAM_REL_ACC",
    "Metric",
    "METRICS",
    "declare",
    "enable",
    "disable",
    "enabled",
    "reset",
    "clock",
    "wall_time",
    "counter_inc",
    "gauge_set",
    "observe",
    "finish_span",
    "span",
    "event",
    "snapshot",
    "merge_snapshots",
    "prometheus_text",
    "chrome_trace",
    "exemplars_for",
    "call_spans",
    "CALL_SPANS",
    "PROFILER_PREFIX",
    "CHROME_PID_SPANS",
    "CHROME_PID_DEVICE",
    "EXEMPLARS_PER_BIN",
    "EXEMPLAR_BINS",
    "SLO",
    "SLOS",
    "check_slo",
    "main",
]

#: Declared in ``analysis/registry.py`` (the kill-switch inventory);
#: this alias keeps the import-path convention of the other levers.
TELEMETRY_ENV = registry.TELEMETRY.name

#: Relative accuracy of every self-sketch histogram: quantiles a
#: snapshot reports are within 1% of the recorded durations' exact
#: quantiles (the DDSketch contract, applied to ourselves).
HISTOGRAM_REL_ACC = 0.01

#: Declared, collision-free Chrome-trace process-track scheme: host
#: telemetry spans render on pid 1 (one tid per thread), the profiling
#: layer's device-clocked dispatches on pid 2 (one tid per engine
#: tier).  Both pids carry ``process_name``/``thread_name`` metadata
#: events so Perfetto labels tracks instead of showing bare ids; any
#: future track must claim a fresh pid here.
CHROME_PID_SPANS = 1
CHROME_PID_DEVICE = 2

#: Per-bin exemplar-reservoir bound: each latency-histogram bin retains
#: at most this many ``(trace_id, wall_time, value)`` exemplars
#: (deterministic splitmix64 bottom-k selection keyed on the trace id --
#: no RNG, replays exactly; the ``accuracy.py`` reservoir discipline).
EXEMPLARS_PER_BIN = 4

#: Bound on distinct bins carrying exemplars per histogram series
#: (overflow dropped + counted -- the ring discipline).
EXEMPLAR_BINS = 256


@dataclasses.dataclass(frozen=True)
class Metric:
    """One declared metric: its name, kind, owning module, and doc.

    ``kind`` is ``"counter"`` (monotone float), ``"gauge"`` (last write
    wins), or ``"histogram"`` (DDSketch-backed distribution of seconds;
    spans feed these).  Recording against a name whose declared kind
    does not match the API used raises ``SketchValueError``.

    ``merge`` is the gauge fold policy :func:`merge_snapshots` applies
    across processes (``"max"``, ``"min"``, or ``"sum"``); counters
    always fold by sum and histograms by sketch merge, so the field
    only matters for gauges.
    """

    name: str
    kind: str
    owner: str
    doc: str
    merge: str = "max"


# The library's metric inventory: the JAX package's, name for name, with
# its docs verbatim (they are the HELP lines of the exposition, and one
# metric name must carry one HELP text across a fleet that runs both
# packages).  Every telemetry call in the port uses one of these names.
_DECLARED = (
    Metric("batched.ingest_batches", "counter", "sketches_tpu_torch.batched",
           "Batches ingested through BatchedDDSketch.add."),
    Metric("distributed.ingest_batches", "counter", "sketches_tpu_torch.parallel",
           "Batches ingested through DistributedDDSketch.add."),
    Metric("ingest.variant.stock", "counter", "sketches_tpu_torch.kernels",
           "Pallas ingest batches served by the stock int8 construction."),
    Metric("ingest.variant.packed", "counter", "sketches_tpu_torch.kernels",
           "Pallas ingest batches served by the packed sub-byte lo"
           " construction (DESIGN.md 2-r17)."),
    Metric("ingest.variant.hifold", "counter", "sketches_tpu_torch.kernels",
           "Pallas ingest batches served by the folded pos/neg hi"
           " construction (2-r17; dead-listed default-off rung)."),
    Metric("ingest.variant.cmpfree", "counter", "sketches_tpu_torch.kernels",
           "Pallas ingest batches served by the compare-free construction"
           " (2-r17; dead-listed default-off rung)."),
    Metric("scalar.values", "counter", "sketches_tpu_torch.ddsketch",
           "Values flushed through the JaxDDSketch scalar/bulk paths."),
    Metric("wire.blobs_encoded", "counter", "sketches_tpu_torch.pb.wire",
           "Wire blobs produced by state_to_bytes."),
    Metric("wire.blobs_decoded", "counter", "sketches_tpu_torch.pb.wire",
           "Wire blobs admitted to bytes_to_state (quarantined included)."),
    Metric("wire.blobs_quarantined", "counter", "sketches_tpu_torch.pb.wire",
           "Blobs isolated by a quarantine-mode bulk decode."),
    Metric("wire.native.decode_calls", "counter", "sketches_tpu_torch.pb.wire",
           "Bulk decode batches scanned by the native C++ structural"
           " codec (dense scans and envelope splits both count)."),
    Metric("wire.native.careful_fallbacks", "counter",
           "sketches_tpu_torch.pb.wire",
           "Blobs the native scanner handed back to the per-blob Python"
           " careful path (foreign, damaged, or pre-marked blobs)."),
    Metric("wire.native.template_miss", "counter", "sketches_tpu_torch.pb.wire",
           "Careful handoffs whose canonical mapping prefix matched but"
           " whose structure deviated from the template shape."),
    Metric("native.load_attempts", "counter", "sketches_tpu_torch.native",
           "Native-engine build/load attempts (retries included)."),
    Metric("resilience.downgrade", "counter", "sketches_tpu_torch.resilience",
           "Downgrade events recorded in the resilience health ledger."),
    Metric("integrity.checks", "counter", "sketches_tpu_torch.integrity",
           "Armed integrity verifications run at the guarded seams."),
    Metric("integrity.violations", "counter", "sketches_tpu_torch.integrity",
           "Invariant/fingerprint violations the integrity layer caught."),
    Metric("integrity.repairs", "counter", "sketches_tpu_torch.integrity",
           "Fields rewritten by integrity.repair() passes."),
    Metric("integrity.check_s", "histogram", "sketches_tpu_torch.integrity",
           "Armed integrity verification wall time (label: seam)."),
    Metric("checkpoint.bytes", "gauge", "sketches_tpu_torch.checkpoint",
           "Size of the most recently written checkpoint, in bytes."),
    Metric("ingest_s", "histogram", "sketches_tpu_torch.batched",
           "Facade ingest dispatch wall time (labels: component, engine)."),
    Metric("query_s", "histogram", "sketches_tpu_torch.batched",
           "Query dispatch wall time, labeled by the resolved engine tier"
           " (labels: component, tier)."),
    Metric("merge_s", "histogram", "sketches_tpu_torch.batched",
           "Facade merge dispatch wall time (label: component)."),
    Metric("scalar.ingest_s", "histogram", "sketches_tpu_torch.ddsketch",
           "JaxDDSketch flush/add_many wall time (label: path)."),
    Metric("distributed.fold_s", "histogram", "sketches_tpu_torch.parallel",
           "psum fold of the distributed partials (cache misses only)."),
    Metric("wire.encode_s", "histogram", "sketches_tpu_torch.pb.wire",
           "Bulk wire encode wall time per batch."),
    Metric("wire.decode_s", "histogram", "sketches_tpu_torch.pb.wire",
           "Bulk wire decode wall time per batch."),
    Metric("native.load_s", "histogram", "sketches_tpu_torch.native",
           "Native-engine build+load wall time (successful loads)."),
    Metric("checkpoint.save_s", "histogram", "sketches_tpu_torch.checkpoint",
           "Checkpoint serialize+fsync+rename wall time."),
    Metric("checkpoint.restore_s", "histogram", "sketches_tpu_torch.checkpoint",
           "Checkpoint load+validate wall time."),
    Metric("spans.dropped", "counter", "sketches_tpu_torch.telemetry",
           "Trace events dropped because the 65k span ring was full."),
    Metric("tracing.traces", "counter", "sketches_tpu_torch.tracing",
           "Root trace contexts minted (one per served/instrumented"
           " request while the recorder is armed)."),
    Metric("tracing.events", "counter", "sketches_tpu_torch.tracing",
           "Structured events recorded into the flight-recorder ring"
           " (spans, decisions, faults, downgrades)."),
    Metric("tracing.dropped", "counter", "sketches_tpu_torch.tracing",
           "Flight-recorder events overwritten because the bounded ring"
           " wrapped (the oldest event is replaced, never the newest)."),
    Metric("tracing.dumps", "counter", "sketches_tpu_torch.tracing",
           "Forensic bundles dumped (auto-triggered by SLO burns, serve"
           " errors, cache poison, chaos classifications, or explicit)."),
    Metric("profiling.device_s", "histogram", "sketches_tpu_torch.profiling",
           "Device-clocked (block_until_ready) dispatch time, attributed"
           " per phase and engine tier (labels: phase, tier)."),
    Metric("accuracy.audits", "counter", "sketches_tpu_torch.accuracy",
           "Shadow-audit passes run against watched sketches."),
    Metric("accuracy.violations", "counter", "sketches_tpu_torch.accuracy",
           "Audit passes where a realized quantile broke the alpha"
           " contract against the reservoir sample."),
    Metric("accuracy.rel_err", "gauge", "sketches_tpu_torch.accuracy",
           "Worst realized relative quantile error seen by the most"
           " recent audit pass (label: stream)."),
    Metric("accuracy.collapsed_mass_frac", "gauge", "sketches_tpu_torch.accuracy",
           "Fraction of a watched stream's mass clamped into the window"
           " edge bins at the most recent audit (label: stream)."),
    Metric("accuracy.collapse_recommended", "counter",
           "sketches_tpu_torch.accuracy",
           "Drift audits that saw a non-adaptive stream's edge-clamped"
           " mass fraction cross its spec's collapse threshold -- the"
           " signal that the stream wants the uniform_collapse backend"
           " (label: stream)."),
    Metric("backend.collapses", "counter", "sketches_tpu_torch.backends",
           "Uniform-collapse events: streams whose bins pair-merged one"
           " level (gamma -> gamma**2; alpha degraded predictably"
           " instead of tail mass clamping)."),
    Metric("backend.effective_alpha", "gauge", "sketches_tpu_torch.backends",
           "Realized relative-accuracy bound of a collapsed stream"
           " after its most recent collapse (label: stream)."),
    Metric("backend.moment_solves", "counter", "sketches_tpu_torch.backends",
           "Per-stream maximum-entropy quantile solves run by the"
           " moment backend."),
    Metric("backend.moment_fallbacks", "counter", "sketches_tpu_torch.backends",
           "Moment-backend solves that fell back down the moment ladder"
           " (fewer moments, or the uniform-density floor) because the"
           " maxent Newton solve failed to converge."),
    Metric("elastic.reshards", "counter", "sketches_tpu_torch.parallel",
           "Elastic reshard operations completed (grow, shrink, and"
           " kill-and-regrow alike; label: kind)."),
    Metric("elastic.reshard_s", "histogram", "sketches_tpu_torch.parallel",
           "Elastic reshard wall time: fold the survivors, rebuild the"
           " mesh, verify the boundary."),
    Metric("elastic.dropped_mass", "counter", "sketches_tpu_torch.parallel",
           "Total mass itemized as lost to dead shards/hosts across"
           " elastic reshards (exact per-stream accounting rides the"
           " ReshardReport)."),
    Metric("elastic.mesh_devices", "gauge", "sketches_tpu_torch.parallel",
           "Device count of the most recently built elastic mesh."),
    Metric("elastic.host_losses", "counter", "sketches_tpu_torch.parallel",
           "Whole-host (ICI-group) losses folded around during elastic"
           " reshards."),
    Metric("elastic.dcn_partitions", "counter", "sketches_tpu_torch.parallel",
           "DCN partitions detected at the cross-host fold (unreachable"
           " process-local partials folded around, accounted)."),
    Metric("elastic.dcn_fold_s", "histogram", "sketches_tpu_torch.parallel",
           "Cross-host (DCN) fold of process-local merged partials."),
    Metric("serve.requests", "counter", "sketches_tpu_torch.serve",
           "Quantile requests submitted to the serving tier (admitted,"
           " cached, and shed alike)."),
    Metric("serve.shed", "counter", "sketches_tpu_torch.serve",
           "Requests refused at admission (label: reason --"
           " queue_depth/tenant_quota/injected)."),
    Metric("serve.deadline_misses", "counter", "sketches_tpu_torch.serve",
           "Requests answered (or refused) after their deadline budget"
           " was already spent."),
    Metric("serve.hedges", "counter", "sketches_tpu_torch.serve",
           "Hedged dispatches issued for straggling/failed primary"
           " query dispatches (label: tier)."),
    Metric("serve.cache.hits", "counter", "sketches_tpu_torch.serve",
           "Queries answered from the fingerprint-keyed result cache."),
    Metric("serve.cache.misses", "counter", "sketches_tpu_torch.serve",
           "Cache-armed queries that had to dispatch to the device."),
    Metric("serve.cache.poisoned", "counter", "sketches_tpu_torch.serve",
           "Cached entries that failed re-verification against the live"
           " fingerprint/checksum and were quarantined."),
    Metric("serve.breaker.trips", "counter", "sketches_tpu_torch.serve",
           "Circuit-breaker openings per engine tier (label: tier)."),
    Metric("serve.queue_depth", "gauge", "sketches_tpu_torch.serve",
           "Admission-queue depth at the most recent submit/flush."),
    Metric("serve.request_s", "histogram", "sketches_tpu_torch.serve",
           "Per-request serving latency, submit to answer (label:"
           " source -- cache/dispatch)."),
    Metric("serve.batch_s", "histogram", "sketches_tpu_torch.serve",
           "Fused flush dispatch wall time per tenant group (label:"
           " tier)."),
    Metric("window.rotations", "counter", "sketches_tpu_torch.windows",
           "Windowed-ring bucket rotations: live time-slice buckets"
           " frozen into the ring as the clock crossed a slice"
           " boundary."),
    Metric("window.retired_mass", "counter", "sketches_tpu_torch.windows",
           "Exact mass dropped off the last ladder rung by windowed"
           " bucket retirement (the ledger's retired side)."),
    Metric("window.ladder_collapses", "counter", "sketches_tpu_torch.windows",
           "Collapse-on-retire applications: buckets brought to a"
           " coarser rung's declared collapse level as they aged down"
           " the ladder."),
    Metric("window.covered_buckets", "gauge", "sketches_tpu_torch.windows",
           "Buckets covered by the most recent window query (the fused"
           " stacked-merge dispatch's arity)."),
    Metric("window.agg_reuse", "counter", "sketches_tpu_torch.windows",
           "Window plans whose sealed-rung component was served"
           " entirely from a maintained two-stacks aggregate (zero new"
           " backend merges -- the maintained layer's hit rate)."),
    Metric("window.agg_rebuilds", "counter", "sketches_tpu_torch.windows",
           "Two-stacks aggregate rebuilds: the derived stacks were"
           " dropped (restore, ring merge, torn sync) and repopulated"
           " from the ring on the next plan."),
    Metric("window.query_merges", "counter", "sketches_tpu_torch.windows",
           "Backend merges spent ANSWERING window queries on the"
           " maintained path (component chain + suffix/back-tail"
           " combine) -- O(1) per query, vs O(covered buckets) with"
           " SKETCHES_TPU_WINDOW_AGG=0."),
    Metric("fabric.replica_syncs", "counter", "sketches_tpu_torch.fabric",
           "Replica refreshes shipped over the wire seam: a replica's"
           " state replaced by a fold of the primary's, fingerprint"
           " ledgered at the sync point."),
    Metric("fabric.failovers", "counter", "sketches_tpu_torch.fabric",
           "Tenant re-homings after a host loss: a surviving replica"
           " promoted to primary with the dropped mass itemized in the"
           " fabric's ledger."),
    Metric("fabric.hedge_cross_host", "counter", "sketches_tpu_torch.fabric",
           "Cross-host hedge dispatches: a primary read that failed or"
           " straggled was re-issued against a fingerprint-verified"
           " replica on another host."),
    Metric("fabric.staleness_s", "histogram", "sketches_tpu_torch.fabric",
           "Replica staleness observed at serve time (serving-clock"
           " seconds since the replica's ledgered sync), recorded per"
           " replica-served read (label: tenant)."),
    # The port's own: the layers inside a facade ingest and query
    # (call_spans).  Each feeds its histogram once a call, with the sum
    # over the call's chunks (label: component).
    Metric("ingest.recentre_s", "histogram", "sketches_tpu_torch.batched",
           "First-batch ingest: window offsets from the batch, recentre"
           " and the plain add, summed over the call's stream chunks."),
    Metric("ingest.slice_s", "histogram", "sketches_tpu_torch.batched",
           "Slicing the state and the operands into stream chunks,"
           " summed over an ingest call's chunks."),
    Metric("ingest.k1_s", "histogram", "sketches_tpu_torch.kernels",
           "K1's operand preparation and ingest_histogram launch, summed"
           " over an ingest call's chunks."),
    Metric("ingest.fold_s", "histogram", "sketches_tpu_torch.kernels",
           "Folding K1's per-chunk deltas into the state leaves, summed"
           " over an ingest call's chunks."),
    Metric("ingest.copy_back_s", "histogram", "sketches_tpu_torch.batched",
           "Copying each chunk's folded leaves back into the state,"
           " summed over an ingest call's chunks."),
    Metric("query.plan_window_s", "histogram", "sketches_tpu_torch.kernels",
           "plan_state_window: the occupied-window plan and its host"
           " fetch."),
    Metric("query.plan_tiles_s", "histogram", "sketches_tpu_torch.kernels",
           "plan_tile_query: the tile targets, the needed-tile bound and"
           " its host fetch."),
    Metric("query.operands_s", "histogram", "sketches_tpu_torch.kernels",
           "The route kernel's per-stream operands (tile lists, packed"
           " thresholds) and their checks."),
    Metric("query.kernel_s", "histogram", "sketches_tpu_torch.kernels",
           "The route kernel's launch (K2, K3, the tile kernel or K5)."),
)

#: The spans :func:`call_spans` opens inside a facade's ``add`` (``ingest_s``)
#: and query (``query_s``), from the call down: the first batch's recentre,
#: then per stream chunk its slice, K1, the fold and the copy back; the two
#: plans, the operands and the route kernel.
CALL_SPANS = (
    "ingest.recentre_s", "ingest.slice_s", "ingest.k1_s", "ingest.fold_s",
    "ingest.copy_back_s", "query.plan_window_s", "query.plan_tiles_s",
    "query.operands_s", "query.kernel_s",
)

#: Prefix of the port's ranges in a ``torch.profiler`` trace.
PROFILER_PREFIX = "sketches_tpu_torch."

#: Every declared metric by name (static inventory + runtime
#: :func:`declare` extensions).
METRICS: Dict[str, Metric] = {m.name: m for m in _DECLARED}

_VALID_KINDS = ("counter", "gauge", "histogram")
_VALID_MERGES = ("max", "min", "sum")

_lock = threading.Lock()

#: Fast-path guard: instrumented seams check this module flag before
#: doing any telemetry work, so the disarmed layer costs one bool test.
_ACTIVE = registry.enabled(registry.TELEMETRY)

# Trace timebase: ts fields are wall-clock microseconds since the Unix
# epoch, the profiler's clock (see the module docstring).  _anchor() and
# the clock()/wall_time() bodies are the ONLY clock reads in the package
# -- the determinism rule's telemetry.py carve-out covers exactly this
# file.
_anchor_wall_us = 0.0
_anchor_pc = 0.0


def _anchor() -> None:
    """Pair the wall clock with ``perf_counter`` (at import, enable, reset)."""
    global _anchor_wall_us, _anchor_pc
    pc_ns = time.perf_counter_ns()
    wall_ns = time.time_ns()
    _anchor_wall_us = wall_ns / 1e3
    _anchor_pc = pc_ns / 1e9


def _ts_us(t: float) -> float:
    """A :func:`clock` reading as wall-clock microseconds since the epoch."""
    return _anchor_wall_us + (t - _anchor_pc) * 1e6


_anchor()

_MAX_EVENTS = 65536

# Keyed by (name, ((label, value), ...)) -- labels canonically sorted.
_Key = Tuple[str, Tuple[Tuple[str, str], ...]]
_counters: Dict[_Key, float] = {}
_gauges: Dict[_Key, float] = {}
_hists: Dict[_Key, "_Hist"] = {}
_events: List[dict] = []
_events_dropped = 0
_tids: Dict[int, int] = {}


def _raise_value_error(msg: str) -> None:
    # Lazy import: resilience imports telemetry at module load (for the
    # ledger clock), so the taxonomy root is reached at call time only.
    from sketches_tpu_torch.resilience import SketchValueError

    raise SketchValueError(msg)


_tracing_cached = None


def _tracing():
    """The tracing module, imported lazily (tracing imports telemetry at
    load, so the reverse edge must be deferred to call time).  Armed
    code paths only -- the disarmed fast path never reaches this."""
    global _tracing_cached
    if _tracing_cached is None:
        from sketches_tpu_torch import tracing as _t

        _tracing_cached = _t
    return _tracing_cached


def declare(
    name: str, kind: str, doc: str, owner: str = "user", merge: str = "max"
) -> Metric:
    """Register a user-space metric (examples, applications, tests).

    Library code uses the static inventory instead.
    ``merge`` is the cross-process gauge fold policy (gauges only; see
    :class:`Metric`).  Raises ``SketchValueError`` on an invalid kind or
    merge policy; re-declaring an existing name with a different kind
    raises, an identical re-declaration is a no-op.
    """
    if kind not in _VALID_KINDS:
        _raise_value_error(
            f"Unknown metric kind {kind!r}; expected one of {_VALID_KINDS}"
        )
    if merge not in _VALID_MERGES:
        _raise_value_error(
            f"Unknown gauge merge policy {merge!r}; expected one of"
            f" {_VALID_MERGES}"
        )
    with _lock:
        prev = METRICS.get(name)
        if prev is not None:
            if prev.kind != kind:
                _raise_value_error(
                    f"metric {name!r} already declared with kind"
                    f" {prev.kind!r}"
                )
            return prev
        m = Metric(name, kind, owner, doc, merge)
        METRICS[name] = m
        return m


def _metric(name: str, kind: str) -> Metric:
    m = METRICS.get(name)
    if m is None:
        _raise_value_error(
            f"undeclared telemetry metric {name!r}; library metrics belong"
            " in telemetry.METRICS, user metrics go through"
            " telemetry.declare()"
        )
    if m.kind != kind:
        _raise_value_error(
            f"telemetry metric {name!r} is a {m.kind}, not a {kind}"
        )
    return m


def _key(name: str, labels: Dict[str, Any]) -> _Key:
    return (
        name,
        tuple(sorted((k, str(v)) for k, v in labels.items())),
    )


# ---------------------------------------------------------------------------
# Arming
# ---------------------------------------------------------------------------


def enable(on: bool = True) -> None:
    """Arm (or, with ``on=False``, disarm) the telemetry layer.

    Never raises; the pre-existing metric state is kept (use
    :func:`reset` to clear it).  The flight recorder
    (``sketches_tpu_torch.tracing``) follows this arming state -- it is
    always-armed-when-telemetry-is-armed unless its own kill switch
    disables it.
    """
    global _ACTIVE
    _ACTIVE = bool(on)
    _anchor()
    _tracing()._sync(_ACTIVE)


def disable() -> None:
    """Disarm the telemetry layer (instrumented seams go back to one
    bool test per dispatch; recorded state is kept, never lost)."""
    enable(False)


def enabled() -> bool:
    """Whether the layer is armed (env switch or :func:`enable`);
    False -- the default -- means no seam records anything."""
    return _ACTIVE


def reset() -> None:
    """Clear every counter/gauge/histogram/trace event (test isolation
    hook; runtime-declared metrics stay declared).  Never raises."""
    global _events_dropped
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _events.clear()
        _tids.clear()
        _events_dropped = 0
    _anchor()


# ---------------------------------------------------------------------------
# Clocks (the package's only wall-clock reads -- see module docstring)
# ---------------------------------------------------------------------------


def clock() -> float:
    """Monotonic seconds (``time.perf_counter``): span/duration timebase.

    The one sanctioned monotonic read in the package -- instrumented
    seams call this instead of touching ``time`` (which the determinism
    lint would rightly flag as a replay hazard).  Never raises.
    """
    return time.perf_counter()


def wall_time() -> float:
    """Wall-clock seconds since the epoch (``time.time``).

    Operator-facing timestamps only (the resilience ledger's event
    times); nothing may branch on it.  Never raises.
    """
    return time.time()


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------


def _sketch_state(sk) -> dict:
    """A host DDSketch's sparse bin state as a JSON-safe dict
    (``{"zero_count", "pos": {key: mass}, "neg": {key: mass}}``)."""

    def bins(store) -> Dict[str, float]:
        return {
            str(k): float(store.bins[k - store.offset]) for k in store.keys()
        }

    return {
        "zero_count": float(sk.zero_count),
        "pos": bins(sk.store),
        "neg": bins(sk.negative_store),
    }


def _sketch_from_state(state: dict, rel_acc: float):
    """Rebuild a host DDSketch from :func:`_sketch_state` output (bin
    mass and zero count only; scalar min/max/sum are the caller's)."""
    from sketches_tpu_torch.ddsketch import BaseDDSketch
    from sketches_tpu_torch.mapping import LogarithmicMapping
    from sketches_tpu_torch.store import DenseStore

    sk = BaseDDSketch(
        LogarithmicMapping(rel_acc), DenseStore(), DenseStore(),
        zero_count=float(state.get("zero_count", 0.0)),
    )
    for key, cnt in state.get("pos", {}).items():
        sk.store.add(int(key), float(cnt))
    for key, cnt in state.get("neg", {}).items():
        sk.negative_store.add(int(key), float(cnt))
    sk._count = sk.zero_count + sk.store.count + sk.negative_store.count
    return sk


def _exemplar_priority(trace_hex: str) -> int:
    """Deterministic reservoir priority of an exemplar: splitmix64 of
    its trace id.  A pure function of the id, so merge operands agree
    on selection without storing priorities (re-reservoir = bottom-k of
    the union).  An unparseable id sorts last (kept only if room)."""
    from sketches_tpu_torch import tracing as _t

    try:
        return _t.splitmix64(int(trace_hex, 16))
    except (TypeError, ValueError):
        return (1 << 64) - 1


class _Hist:
    """One histogram: a host-tier DDSketch plus exact min/max, plus a
    small per-bin exemplar reservoir linking histogram mass to traces.

    The sketch import is lazy (first armed observation), so importing
    telemetry never pays for the sketch stack; count/sum come from the
    sketch's own (exact, f64) bookkeeping.  Exemplars are recorded only
    for trace-bearing positive observations (the latency case): each
    mapping bin keeps at most :data:`EXEMPLARS_PER_BIN` entries,
    selected by the deterministic splitmix64 bottom-k priority of their
    trace ids; at most :data:`EXEMPLAR_BINS` bins carry exemplars
    (overflow dropped + counted).  Failure modes follow the sketch's:
    quantiles of an empty histogram read as None/NaN.
    """

    __slots__ = ("sketch", "min", "max", "exemplars", "exemplars_seen",
                 "exemplars_dropped")

    def __init__(self):
        from sketches_tpu_torch.ddsketch import DDSketch

        self.sketch = DDSketch(HISTOGRAM_REL_ACC)
        self.min = math.inf
        self.max = -math.inf
        self.exemplars: Dict[int, List[Tuple[int, str, float, float]]] = {}
        self.exemplars_seen = 0
        self.exemplars_dropped = 0

    def add(self, value: float, exemplar: Optional[Tuple[str, float]] = None
            ) -> None:
        self.sketch.add(value)
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if exemplar is not None and value > 0:
            self._add_exemplar(value, exemplar)

    def _add_exemplar(self, value: float, ex: Tuple[str, float]) -> None:
        trace_hex, wall = ex
        self.exemplars_seen += 1
        key = self.sketch.mapping.key(value)
        lst = self.exemplars.get(key)
        if lst is None:
            if len(self.exemplars) >= EXEMPLAR_BINS:
                self.exemplars_dropped += 1
                return
            lst = self.exemplars[key] = []
        lst.append((_exemplar_priority(trace_hex), trace_hex, wall, value))
        if len(lst) > EXEMPLARS_PER_BIN:
            lst.sort()
            lst.pop()
            self.exemplars_dropped += 1

    def summary(self) -> dict:
        sk = self.sketch
        out = {
            "count": sk.count,
            "sum": sk.sum,
            "min": None if math.isinf(self.min) else self.min,
            "max": None if math.isinf(self.max) else self.max,
            "relative_accuracy": HISTOGRAM_REL_ACC,
        }
        for q, label in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"),
                         (0.999, "p999")):
            out[label] = sk.get_quantile_value(q)
        # The sketch's sparse bin state rides along (JSON-safe: string
        # keys), so snapshots are MERGEABLE: merge_snapshots folds these
        # bins by key addition -- exactly DDSketch.merge -- and the
        # fleet-wide quantiles keep the alpha contract.
        out["state"] = _sketch_state(sk)
        if self.exemplars_seen:
            out["exemplars"] = {
                str(k): [
                    {"trace_id": t, "wall_time": w, "value": v}
                    for (_p, t, w, v) in sorted(lst)
                ]
                for k, lst in sorted(self.exemplars.items())
            }
            out["exemplars_seen"] = self.exemplars_seen
            out["exemplars_dropped"] = self.exemplars_dropped
        return out


def counter_inc(name: str, n: float = 1.0, **labels) -> None:
    """Add ``n`` to counter ``name`` (no-op while disarmed).

    Raises ``SketchValueError`` for an undeclared name or a non-counter
    metric.
    """
    if not _ACTIVE:
        return
    _metric(name, "counter")
    k = _key(name, labels)
    with _lock:
        _counters[k] = _counters.get(k, 0.0) + n


def gauge_set(name: str, value: float, **labels) -> None:
    """Set gauge ``name`` (last write wins; no-op while disarmed).

    Raises ``SketchValueError`` for an undeclared name or a non-gauge
    metric.
    """
    if not _ACTIVE:
        return
    _metric(name, "gauge")
    with _lock:
        _gauges[_key(name, labels)] = float(value)


def _trace_of(trace):
    """The effective trace context of an armed observation: the
    explicit ``trace=`` argument, else the tracing layer's current
    context (None when tracing is disarmed or nothing is bound)."""
    t = _tracing()
    if not t._ACTIVE:
        return None
    return trace if trace is not None else t.current()


def observe(name: str, seconds: float, trace=None, **labels) -> None:
    """Feed one duration into histogram ``name`` (no-op while disarmed).

    Raises ``SketchValueError`` for an undeclared name or a
    non-histogram metric; the value lands in a DDSketch, so snapshot
    quantiles are within ``HISTOGRAM_REL_ACC`` of exact.  ``trace``
    (a ``tracing.TraceContext``; defaults to the current bound context
    when the flight recorder is armed) attaches a ``(trace_id,
    wall_time, value)`` exemplar to the value's histogram bin.
    """
    if not _ACTIVE:
        return
    _metric(name, "histogram")
    ctx = _trace_of(trace)
    ex = (ctx.trace_hex, wall_time()) if ctx is not None else None
    k = _key(name, labels)
    with _lock:
        h = _hists.get(k)
        if h is None:
            h = _hists[k] = _Hist()
        h.add(float(seconds), ex)


def _tid() -> int:
    ident = threading.get_ident()
    t = _tids.get(ident)
    if t is None:
        t = _tids[ident] = len(_tids) + 1
    return t


def _append_event(ev: dict) -> None:
    # Caller holds ``_lock``: the drop counter mutates ``_counters``
    # directly (``counter_inc`` would deadlock re-acquiring the lock).
    global _events_dropped
    if len(_events) < _MAX_EVENTS:
        _events.append(ev)
    else:
        _events_dropped += 1
        k = ("spans.dropped", ())
        _counters[k] = _counters.get(k, 0.0) + 1.0


def finish_span(name: str, t0: float, trace=None, **labels) -> float:
    """Close a span opened at ``t0 = telemetry.clock()`` -> duration.

    Feeds histogram ``name`` and appends one Chrome-trace ``X`` event
    (per-thread track, bounded ring).  The explicit-``t0`` form is the
    hot-seam idiom: the seam pays ONE bool test while disarmed
    (``t0 = telemetry.clock() if telemetry._ACTIVE else None``) instead
    of a context-manager allocation.  ``trace`` (optional, defaults to
    the tracing layer's current context when armed; old callers are
    unchanged) links the span into its request's trace: the chrome
    event carries the ids (rendered as causal flow arrows by
    :func:`chrome_trace`), the histogram bin gains an exemplar, and the
    flight recorder mirrors the span.  Raises ``SketchValueError`` for
    an undeclared name; while disarmed it records nothing and returns
    0.0.
    """
    if not _ACTIVE:
        return 0.0
    _metric(name, "histogram")
    now = clock()
    dur = max(now - t0, 0.0)
    ctx = _trace_of(trace)
    ex = (ctx.trace_hex, wall_time()) if ctx is not None else None
    args = {k2: str(v) for k2, v in labels.items()}
    if ctx is not None:
        args.update(
            trace_id=ctx.trace_hex, span_id=ctx.span_hex,
            parent_id=ctx.parent_hex or "",
        )
    k = _key(name, labels)
    with _lock:
        h = _hists.get(k)
        if h is None:
            h = _hists[k] = _Hist()
        h.add(dur, ex)
        _append_event(
            {
                "name": name,
                "cat": "sketches_tpu",
                "ph": "X",
                "ts": _ts_us(t0),
                "dur": dur * 1e6,
                "pid": CHROME_PID_SPANS,
                "tid": _tid(),
                "args": args,
            }
        )
    t = _tracing()
    if t._ACTIVE:
        # Mirror the span into the flight recorder (outside _lock:
        # record_event takes the recorder's own lock and the declared
        # tracing.events counter re-enters this module's API).
        t.record_event("span", ctx=ctx, name=name, dur_s=dur, **labels)
    return dur


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("name", "labels", "t0")

    def __init__(self, name: str, labels: Dict[str, Any]):
        self.name = name
        self.labels = labels

    def __enter__(self) -> "_Span":
        self.t0 = clock()
        return self

    def __exit__(self, *exc) -> bool:
        finish_span(self.name, self.t0, **self.labels)
        return False


def span(name: str, **labels):
    """Context manager timing a section into histogram ``name``.

    Nest freely across threads: each thread renders as its own trace
    track, and nesting shows as stacked ``X`` events.  Disarmed, it
    returns a shared no-op and records nothing; the name check (raises
    ``SketchValueError`` when undeclared) runs at exit via
    :func:`finish_span`, after the timed section.
    """
    if not _ACTIVE:
        return _NOOP_SPAN
    return _Span(name, labels)


class _NoopCall:
    """The off state of :func:`call_spans`: ``with`` binds ``None``."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_CALL = _NoopCall()
_profiler_enabled = torch.autograd._profiler_enabled


class _CallSpans:
    """The spans of one call: its root span and the layers inside it.

    :meth:`enter` / :meth:`exit` open and close a span inside the root
    (they nest).  While a profiler records, each span is a
    ``record_function`` range; while telemetry is armed, each inner span
    appends one ring event and adds its duration to its name's sum, and
    the root, on a clean exit, feeds every inner histogram once with its
    sum and closes through :func:`finish_span` with :attr:`labels`.
    """

    __slots__ = ("root", "labels", "armed", "profiled", "_open", "_sums")

    def __init__(self, root: str, profiled: bool):
        self.root = root
        self.labels: Dict[str, Any] = {}
        self.armed = _ACTIVE
        self.profiled = profiled
        self._open: List[Tuple[str, Any, float]] = []
        self._sums: Dict[str, float] = {}

    def __enter__(self) -> "_CallSpans":
        self.enter(self.root)
        return self

    def enter(self, name: str) -> None:
        rf = None
        if self.profiled:
            rf = torch.profiler.record_function(PROFILER_PREFIX + name)
            rf.__enter__()
        self._open.append((name, rf, clock() if self.armed else 0.0))

    def exit(self) -> None:
        name, rf, t0 = self._open.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        if self.armed:
            dur = max(clock() - t0, 0.0)
            self._sums[name] = self._sums.get(name, 0.0) + dur
            with _lock:
                _append_event(
                    {
                        "name": name,
                        "cat": "sketches_tpu",
                        "ph": "X",
                        "ts": _ts_us(t0),
                        "dur": dur * 1e6,
                        "pid": CHROME_PID_SPANS,
                        "tid": _tid(),
                        "args": {},
                    }
                )

    def unwind(self) -> None:
        """Close every span left open inside the root (a raise inside a
        layer that the caller survives)."""
        while len(self._open) > 1:
            self.exit()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.unwind()
        _, rf, t0 = self._open.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        if self.armed and exc_type is None:
            inner = {k: v for k, v in self.labels.items() if k == "component"}
            for name, total in self._sums.items():
                observe(name, total, **inner)
            finish_span(self.root, t0, **self.labels)
        return False


def call_spans(root: str):
    """The span seam of a hot call: ``with telemetry.call_spans("ingest_s")
    as sp:`` binds a span recorder while spans are on, else ``None``.

    Spans are on while the layer is armed or a ``torch.profiler`` records
    (checked once, here).  The call passes ``sp`` down to its layers, which
    test it for ``None`` before ``sp.enter(name)`` / ``sp.exit()``
    (:data:`CALL_SPANS`) and set ``sp.labels`` for the root's histogram.
    Off, it returns a shared no-op: no clock read, no profiler call, no
    allocation.  Raises ``SketchValueError`` at exit for an undeclared
    span name while armed.
    """
    profiled = _profiler_enabled()
    if not (_ACTIVE or profiled):
        return _NOOP_CALL
    return _CallSpans(root, profiled)


def event(name: str, **labels) -> None:
    """Record an instant: counter ``name`` += 1 plus one trace ``i`` event.

    The bridge idiom for discrete occurrences (resilience downgrades).
    Raises ``SketchValueError`` for an undeclared/non-counter name;
    no-op while disarmed.
    """
    if not _ACTIVE:
        return
    _metric(name, "counter")
    k = _key(name, labels)
    with _lock:
        _counters[k] = _counters.get(k, 0.0) + 1.0
        _append_event(
            {
                "name": name,
                "cat": "sketches_tpu",
                "ph": "i",
                "s": "t",
                "ts": _ts_us(clock()),
                "pid": CHROME_PID_SPANS,
                "tid": _tid(),
                "args": {k2: str(v) for k2, v in labels.items()},
            }
        )


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------


def _render_key(k: _Key) -> str:
    name, labels = k
    if not labels:
        return name
    inner = ",".join(f'{lk}="{lv}"' for lk, lv in labels)
    return f"{name}{{{inner}}}"


def snapshot() -> dict:
    """JSON-safe snapshot of every metric plus the resilience ledger.

    ``resilience.health()`` rides along verbatim under ``"resilience"``,
    so demotion counters and the ledger can never disagree in one
    artifact; an empty snapshot (no counters, no histograms) is the
    disarmed/idle steady state, not an error.  When the profiling or
    accuracy-audit layers are armed their sections ride along too
    (``"profiling"``: the measured-vs-roofline attribution table,
    ``"accuracy"``: the drift-audit summary).  Every histogram summary
    embeds its sparse bin state, so snapshots written to disk stay
    foldable by :func:`merge_snapshots` / ``--merge``.
    """
    with _lock:
        counters = {_render_key(k): v for k, v in _counters.items()}
        gauges = {_render_key(k): v for k, v in _gauges.items()}
        hists = {_render_key(k): h.summary() for k, h in _hists.items()}
        spans = {"n_events": len(_events), "dropped": _events_dropped}
    from sketches_tpu_torch import resilience

    out = {
        "enabled": _ACTIVE,
        "histogram_relative_accuracy": HISTOGRAM_REL_ACC,
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
        "spans": spans,
        "resilience": resilience.health(),
    }
    from sketches_tpu_torch import profiling as _profiling

    if _profiling._ACTIVE:
        out["profiling"] = _profiling.attribution()
    from sketches_tpu_torch import accuracy as _accuracy

    if _accuracy._ACTIVE:
        out["accuracy"] = _accuracy.summary()
    t = _tracing()
    if t._ACTIVE:
        out["tracing"] = t.stats()
    return out


def _prom_name(name: str) -> str:
    base = name.replace(".", "_").replace("-", "_")
    if base.endswith("_s"):
        base = base[:-2] + "_seconds"
    return "sketches_tpu_" + base


def _prom_labels(labels: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _quantile_key(state: dict, q: float) -> Optional[int]:
    """The mapping key of the bin containing quantile ``q`` of an
    embedded histogram state (negative/zero mass ranks below the
    positive bins -- the positive-valued latency case this layer
    records).  None for an empty state."""
    pos = {int(k): float(v) for k, v in (state.get("pos") or {}).items()}
    neg_total = sum(float(v) for v in (state.get("neg") or {}).values())
    zero = float(state.get("zero_count", 0.0))
    total = zero + neg_total + sum(pos.values())
    if total <= 0 or not pos:
        return None
    rank = q * total
    cum = zero + neg_total
    for k in sorted(pos):
        cum += pos[k]
        if cum >= rank:
            return k
    return max(pos)


def _exemplar_near(summary: dict, key: Optional[int]) -> Optional[dict]:
    """The exemplar entry nearest bin ``key`` (exact bin preferred,
    else smallest key distance) -> entry dict + its bin, or None when
    the summary carries no exemplars."""
    ex = summary.get("exemplars")
    if not isinstance(ex, dict) or not ex or key is None:
        return None
    best = min((int(k) for k in ex), key=lambda kk: abs(kk - key))
    entries = ex[str(best)]
    if not entries:
        return None
    return {"bin": best, **entries[0]}


def prometheus_text() -> str:
    """Prometheus text exposition of the current metrics.

    Counters export with a ``_total`` suffix, histograms as summaries
    (``quantile`` label series + ``_sum``/``_count``), all under the
    ``sketches_tpu_`` prefix.  Quantile lines whose bin carries a trace
    exemplar append an OpenMetrics-style exemplar annotation
    (``# {trace_id="..."} value timestamp``) linking the bucket to the
    trace that landed there.  An empty exposition is the disarmed/idle
    steady state; parse failures are the consumer's to report.
    """
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
        hists = {k: h.summary() for k, h in _hists.items()}
    lines: List[str] = []
    seen_header = set()

    def header(name: str, prom: str, mtype: str) -> None:
        if prom in seen_header:
            return
        seen_header.add(prom)
        m = METRICS.get(name)
        if m is not None:
            lines.append(f"# HELP {prom} {m.doc}")
        lines.append(f"# TYPE {prom} {mtype}")

    for (name, labels), v in sorted(counters.items()):
        prom = _prom_name(name) + "_total"
        header(name, prom, "counter")
        lines.append(f"{prom}{_prom_labels(labels)} {v:g}")
    for (name, labels), v in sorted(gauges.items()):
        prom = _prom_name(name)
        header(name, prom, "gauge")
        lines.append(f"{prom}{_prom_labels(labels)} {v:g}")
    for (name, labels), s in sorted(hists.items()):
        prom = _prom_name(name)
        header(name, prom, "summary")
        state = s.get("state") or {}
        for q, label in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"),
                         (0.999, "p999")):
            val = s[label]
            if val is None:
                continue
            qlabel = 'quantile="%g"' % q
            line = f"{prom}{_prom_labels(labels, qlabel)} {val:g}"
            ex = _exemplar_near(s, _quantile_key(state, q))
            if ex is not None:
                line += (
                    f' # {{trace_id="{ex["trace_id"]}"}}'
                    f" {ex['value']:g} {ex['wall_time']:.3f}"
                )
            lines.append(line)
        lines.append(f"{prom}_sum{_prom_labels(labels)} {s['sum']:g}")
        lines.append(f"{prom}_count{_prom_labels(labels)} {s['count']:g}")
    return "\n".join(lines) + ("\n" if lines else "")


def exemplars_for(snap: dict, metric: str, q: float = 0.99) -> dict:
    """Which traces sit behind quantile ``q`` of histogram ``metric`` in
    a snapshot -> ``{"metric", "q", "bin_key", "bin_value",
    "exemplar_bin", "exemplars": [{trace_id, wall_time, value}, ...]}``.

    Folds the metric's label series first (so merged and single-process
    snapshots answer alike), locates the bin containing ``q`` from the
    embedded sketch state, and returns that bin's exemplar reservoir
    (nearest exemplar-bearing bin when the exact bin kept none --
    reservoirs only hold traced observations).  An empty ``exemplars``
    list means no traced observation reached the neighborhood, not an
    error.  Raises ``SketchValueError`` when the snapshot carries no
    such histogram or no embedded bin state.
    """
    rel_acc = float(
        snap.get("histogram_relative_accuracy", HISTOGRAM_REL_ACC)
    )
    series = [
        sm for k, sm in (snap.get("histograms") or {}).items()
        if _series_name(k) == metric
    ]
    if not series:
        _raise_value_error(
            f"snapshot carries no histogram named {metric!r}"
        )
    merged = (
        series[0] if len(series) == 1
        else _merge_hist_summaries(series, rel_acc)
    )
    state = merged.get("state")
    if not isinstance(state, dict):
        _raise_value_error(
            f"histogram {metric!r} carries no embedded bin state (an older"
            " snapshot); exemplars cannot be located"
        )
    key = _quantile_key(state, q)
    from sketches_tpu_torch.mapping import LogarithmicMapping

    mapping = LogarithmicMapping(rel_acc)
    ex = merged.get("exemplars") or {}
    exemplar_bin = None
    entries: List[dict] = []
    if ex and key is not None:
        exemplar_bin = min(
            (int(k) for k in ex), key=lambda kk: abs(kk - key)
        )
        entries = list(ex[str(exemplar_bin)])
    return {
        "metric": metric,
        "q": q,
        "bin_key": key,
        "bin_value": mapping.value(key) if key is not None else None,
        "exemplar_bin": exemplar_bin,
        "exemplars": entries,
    }


def _flow_events(events: List[dict]) -> List[dict]:
    """Causal flow arrows linking trace-linked spans: for every span
    whose recorded ``parent_id`` is another recorded span, emit a
    Chrome flow start (``s``) at the parent and a binding-at-enclosing
    end (``f``/``bp=e``) at the child, id'd by the child span.  Spans
    without trace ids (or with parents outside the ring) emit nothing
    -- absent linkage degrades to plain spans, never an error."""
    by_span: Dict[str, dict] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        span = (e.get("args") or {}).get("span_id")
        if span:
            by_span[span] = e
    flows: List[dict] = []
    for e in by_span.values():
        args = e.get("args") or {}
        parent = by_span.get(args.get("parent_id") or "")
        if parent is None:
            continue
        common = {
            "name": "trace", "cat": "sketches_tpu.flow",
            "id": args["span_id"],
        }
        flows.append(
            {
                **common, "ph": "s", "pid": parent["pid"],
                "tid": parent["tid"], "ts": parent["ts"],
            }
        )
        flows.append(
            {
                **common, "ph": "f", "bp": "e", "pid": e["pid"],
                "tid": e["tid"], "ts": max(e["ts"], parent["ts"]),
            }
        )
    return flows


def chrome_trace() -> dict:
    """Chrome-trace/perfetto event JSON of the recorded spans.

    The JAX package's ``traceEvents`` conventions
    (``process_name``/``thread_name`` metadata + ``X`` duration events),
    so one viewer serves both packages.  The pid scheme is declared and
    collision-free (:data:`CHROME_PID_SPANS` for host span threads,
    :data:`CHROME_PID_DEVICE` for the profiling layer's device track),
    with ``thread_name`` metadata on every track; spans carrying trace
    ids are additionally linked by causal flow events (``s``/``f``), so
    Perfetto draws the request's path across threads.  ``otherData``
    names the timebase (wall-clock microseconds, the profiler's clock).
    An empty event list is the disarmed/idle steady state.
    """
    with _lock:
        events = list(_events)
        tids = dict(_tids)
    meta: List[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": CHROME_PID_SPANS,
            "args": {"name": "sketches_tpu telemetry"},
        }
    ]
    for ident, t in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": CHROME_PID_SPANS,
                "tid": t,
                "args": {"name": f"thread-{ident}"},
            }
        )
    all_events = meta + events + _flow_events(events)
    from sketches_tpu_torch import profiling as _profiling

    if _profiling._ACTIVE:
        all_events = all_events + _profiling.chrome_events()
    return {
        "displayTimeUnit": "ms",
        "traceEvents": all_events,
        "otherData": {
            "timebase": "ts: wall-clock microseconds since the Unix epoch;"
            " a torch.profiler export's ts plus its baseTimeNanoseconds / 1000"
            " is on the same clock",
        },
    }


# ---------------------------------------------------------------------------
# Snapshot merge algebra (the paper's mergeability, applied to ourselves)
# ---------------------------------------------------------------------------


def _series_name(rendered: str) -> str:
    """The metric base name of a rendered series key (labels stripped)."""
    return rendered.split("{", 1)[0]


def _gauge_policy(rendered: str) -> str:
    m = METRICS.get(_series_name(rendered))
    return m.merge if m is not None and m.kind == "gauge" else "max"


def _merge_exemplars(summaries: List[dict]) -> Optional[Tuple[dict, int, int]]:
    """Fold the operands' exemplar reservoirs -> ``(bins, seen,
    dropped)`` or None when no operand carries exemplars.

    Concat + re-reservoir: per bin, the union of entries (deduplicated
    on the full triple) is re-selected bottom-k by the splitmix64
    priority of the trace ids -- the same deterministic discipline the
    live reservoir applies, so the fold is associative and commutative
    (bounded top-k of a multiset under a fixed total order).  The bin
    set is ring-bounded at :data:`EXEMPLAR_BINS`, keeping the LARGEST
    keys (the tail bins exemplars exist for); everything trimmed is
    counted: ``dropped == seen - kept`` by construction.
    """
    by_bin: Dict[int, Dict[Tuple[str, float, float], dict]] = {}
    seen = 0
    any_ex = False
    for sm in summaries:
        seen += int(sm.get("exemplars_seen", 0) or 0)
        ex = sm.get("exemplars")
        if not isinstance(ex, dict):
            continue
        any_ex = True
        for bk, lst in ex.items():
            bucket = by_bin.setdefault(int(bk), {})
            for e in lst:
                entry = {
                    "trace_id": str(e["trace_id"]),
                    "wall_time": float(e["wall_time"]),
                    "value": float(e["value"]),
                }
                bucket[
                    (entry["trace_id"], entry["wall_time"], entry["value"])
                ] = entry
    if not any_ex and seen == 0:
        return None
    kept = 0
    out: Dict[str, List[dict]] = {}
    for bk in sorted(sorted(by_bin, reverse=True)[:EXEMPLAR_BINS]):
        cand = sorted(
            by_bin[bk].values(),
            key=lambda e: (
                _exemplar_priority(e["trace_id"]), e["wall_time"], e["value"]
            ),
        )[:EXEMPLARS_PER_BIN]
        kept += len(cand)
        out[str(bk)] = cand
    return out, seen, max(seen - kept, 0)


def _merge_hist_summaries(summaries: List[dict], rel_acc: float) -> dict:
    """Fold N histogram summaries into one by DDSketch bin addition.

    Same-key bin mass adds (exactly ``DDSketch.merge`` on equal-gamma
    sketches), so the merged quantiles carry the single-process alpha
    contract; count/sum/min/max fold exactly; exemplar reservoirs
    concat + re-reservoir deterministically (:func:`_merge_exemplars`
    -- the fold stays associative/commutative, drops counted).  Raises
    ``SketchValueError`` when a summary has no embedded bin state (an
    older snapshot can be read, not merged).
    """
    pos: Dict[str, float] = {}
    neg: Dict[str, float] = {}
    zero = 0.0
    total_sum = 0.0
    mn, mx = math.inf, -math.inf
    for sm in summaries:
        st = sm.get("state")
        if not isinstance(st, dict):
            _raise_value_error(
                "snapshot histogram carries no embedded bin state (an older"
                " format); re-export the snapshot with this version to merge"
            )
        for out_bins, in_bins in ((pos, st.get("pos", {})),
                                  (neg, st.get("neg", {}))):
            for k, v in in_bins.items():
                out_bins[k] = out_bins.get(k, 0.0) + float(v)
        zero += float(st.get("zero_count", 0.0))
        total_sum += float(sm.get("sum", 0.0))
        if sm.get("min") is not None:
            mn = min(mn, float(sm["min"]))
        if sm.get("max") is not None:
            mx = max(mx, float(sm["max"]))
    state = {"zero_count": zero, "pos": pos, "neg": neg}
    sk = _sketch_from_state(state, rel_acc)
    out = {
        "count": sk.count,
        "sum": total_sum,
        "min": None if math.isinf(mn) else mn,
        "max": None if math.isinf(mx) else mx,
        "relative_accuracy": rel_acc,
    }
    for q, label in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"),
                     (0.999, "p999")):
        out[label] = sk.get_quantile_value(q)
    out["state"] = state
    merged_ex = _merge_exemplars(summaries)
    if merged_ex is not None:
        out["exemplars"], out["exemplars_seen"], out["exemplars_dropped"] = (
            merged_ex
        )
    return out


def _merge_health(healths: List[dict]) -> dict:
    """Fold resilience ledgers: counters sum, downgrade events
    concatenate (ring-bounded, overflow counted), conflicting tier
    entries join as ``"a|b"`` rather than silently picking one."""
    tiers: Dict[str, str] = {}
    counters: Dict[str, float] = {}
    downgrades: List[dict] = []
    dropped = 0.0
    for h in healths:
        if not isinstance(h, dict):
            continue
        for k, v in (h.get("tiers") or {}).items():
            if k in tiers and v not in tiers[k].split("|"):
                tiers[k] = tiers[k] + "|" + str(v)
            elif k not in tiers:
                tiers[k] = str(v)
        for k, v in (h.get("counters") or {}).items():
            counters[k] = counters.get(k, 0.0) + float(v)
        downgrades.extend(h.get("downgrades") or [])
        dropped += float(h.get("downgrades_dropped", 0))
    if len(downgrades) > _MAX_EVENTS:
        dropped += len(downgrades) - _MAX_EVENTS
        downgrades = downgrades[:_MAX_EVENTS]
    return {
        "tiers": tiers,
        "counters": counters,
        "downgrades": downgrades,
        "downgrades_dropped": dropped,
    }


def _merge_profiling(profs: List[dict]) -> dict:
    """Fold profiling attribution sections: measured calls/time sum,
    min/max fold; the roofline/peaks tables (static per build) come from
    the first operand carrying them.  Fleet-wide device-time
    *percentiles* live in the ``profiling.device_s`` histogram, which
    merges with full sketch fidelity."""
    measured: Dict[str, dict] = {}
    dropped = 0.0
    for p in profs:
        for k, row in (p.get("measured") or {}).items():
            agg = measured.get(k)
            if agg is None:
                agg = measured[k] = {
                    "phase": row.get("phase"),
                    "tier": row.get("tier"),
                    "calls": 0.0,
                    "total_s": 0.0,
                    "min_s": math.inf,
                    "max_s": -math.inf,
                }
            agg["calls"] += float(row.get("calls", 0))
            agg["total_s"] += float(row.get("total_s", 0.0))
            if row.get("min_s") is not None:
                agg["min_s"] = min(agg["min_s"], float(row["min_s"]))
            if row.get("max_s") is not None:
                agg["max_s"] = max(agg["max_s"], float(row["max_s"]))
        dropped += float(p.get("events_dropped", 0))
    for agg in measured.values():
        agg["mean_s"] = (
            agg["total_s"] / agg["calls"] if agg["calls"] else None
        )
        if math.isinf(agg["min_s"]):
            agg["min_s"] = None
        if math.isinf(agg["max_s"]):
            agg["max_s"] = None
    first = next((p for p in profs if p.get("roofline")), {})
    return {
        "measured": measured,
        "roofline": first.get("roofline", {}),
        "attribution": first.get("attribution", []),
        "peaks": first.get("peaks", {}),
        "events_dropped": dropped,
    }


def merge_snapshots(*snaps: dict) -> dict:
    """Fold N :func:`snapshot` documents into one fleet-wide snapshot.

    Counters fold by sum, gauges by their declared ``merge`` policy
    (``max`` for names this process has not declared), histograms by
    DDSketch bin addition -- so the merged p50/p99 carry the same
    ``HISTOGRAM_REL_ACC`` relative-error guarantee as any single
    process's, which is the paper's mergeability property applied to
    the library's own telemetry.  The fold is associative and
    commutative (bin addition is), so shard trees of any shape agree.

    Raises ``SketchValueError`` for zero operands, mismatched histogram
    relative accuracies, or histogram summaries without embedded bin
    state (older snapshots).  ``merged_from`` counts the leaf
    snapshots folded in (merged operands contribute their own count).
    """
    if not snaps:
        _raise_value_error("merge_snapshots needs at least one snapshot")
    ras = {
        float(s.get("histogram_relative_accuracy", HISTOGRAM_REL_ACC))
        for s in snaps
    }
    if len(ras) != 1:
        _raise_value_error(
            "cannot merge snapshots with different histogram relative"
            f" accuracies {sorted(ras)}: the merged quantiles would carry"
            " no single alpha contract"
        )
    rel_acc = ras.pop()

    counters: Dict[str, float] = {}
    for s in snaps:
        for k, v in (s.get("counters") or {}).items():
            counters[k] = counters.get(k, 0.0) + float(v)

    gauges: Dict[str, float] = {}
    for s in snaps:
        for k, v in (s.get("gauges") or {}).items():
            v = float(v)
            if k not in gauges:
                gauges[k] = v
                continue
            policy = _gauge_policy(k)
            if policy == "sum":
                gauges[k] += v
            elif policy == "min":
                gauges[k] = min(gauges[k], v)
            else:
                gauges[k] = max(gauges[k], v)

    by_series: Dict[str, List[dict]] = {}
    for s in snaps:
        for k, sm in (s.get("histograms") or {}).items():
            by_series.setdefault(k, []).append(sm)
    hists = {
        k: _merge_hist_summaries(sms, rel_acc)
        for k, sms in by_series.items()
    }

    spans = {
        "n_events": sum(
            int((s.get("spans") or {}).get("n_events", 0)) for s in snaps
        ),
        "dropped": sum(
            int((s.get("spans") or {}).get("dropped", 0)) for s in snaps
        ),
    }

    out = {
        "enabled": any(bool(s.get("enabled")) for s in snaps),
        "histogram_relative_accuracy": rel_acc,
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
        "spans": spans,
        "resilience": _merge_health(
            [s.get("resilience") for s in snaps if s.get("resilience")]
        ),
        "merged_from": sum(int(s.get("merged_from", 1)) for s in snaps),
    }
    profs = [s["profiling"] for s in snaps if isinstance(s.get("profiling"), dict)]
    if profs:
        out["profiling"] = _merge_profiling(profs)
    trcs = [s["tracing"] for s in snaps if isinstance(s.get("tracing"), dict)]
    if trcs:
        out["tracing"] = {
            "events": sum(int(t.get("events", 0)) for t in trcs),
            "recorded": sum(int(t.get("recorded", 0)) for t in trcs),
            "dropped": sum(int(t.get("dropped", 0)) for t in trcs),
            "capacity": max(int(t.get("capacity", 0)) for t in trcs),
            "bundles": sum(int(t.get("bundles", 0)) for t in trcs),
            "bundles_dropped": sum(
                int(t.get("bundles_dropped", 0)) for t in trcs
            ),
        }
    accs = [s["accuracy"] for s in snaps if isinstance(s.get("accuracy"), dict)]
    if accs:
        out["accuracy"] = {
            "watched": sum(int(a.get("watched", 0)) for a in accs),
            "audits": sum(int(a.get("audits", 0)) for a in accs),
            "violations": sum(int(a.get("violations", 0)) for a in accs),
            "reports": sum(int(a.get("reports", 0)) for a in accs),
            "reports_dropped": sum(
                int(a.get("reports_dropped", 0)) for a in accs
            ),
        }
    return out


# ---------------------------------------------------------------------------
# SLO gate
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declared service-level objective over the metric inventory.

    ``kind="latency"``: ``metric`` names a histogram; the bad fraction
    is the recorded mass above ``target_s`` (computed from the embedded
    sketch bins, so it carries the alpha contract; falls back to a
    p99-vs-target check on stateless summaries).  ``kind="ratio"``:
    ``metric``/``total`` name counters; the bad fraction is their
    ratio.  ``budget`` is the allowed bad fraction over ``window``;
    the **burn rate** is ``bad_fraction / budget`` and the SLO is
    burning when it exceeds ``burn_threshold``.  A metric absent from
    the snapshot (or with zero mass) is *skipped*, never a pass.
    """

    name: str
    kind: str  # "latency" | "ratio"
    metric: str
    total: str = ""
    target_s: float = 0.0
    budget: float = 0.01
    burn_threshold: float = 1.0
    window: str = "1h"
    doc: str = ""


#: The declared SLO inventory ``--check-slo`` evaluates (the JAX
#: package's).  Budgets are sized for clean production-shaped workloads,
#: with headroom for host-timed jitter but not for drift: a latency
#: regression, a quarantine storm, or an alpha-contract break burns
#: through them.
SLOS: Tuple[SLO, ...] = (
    SLO(
        "query-latency", "latency", "query_s", target_s=0.25, budget=0.05,
        window="1h",
        doc="<=5% of (warm) query dispatches above 250 ms.",
    ),
    SLO(
        "ingest-latency", "latency", "ingest_s", target_s=1.0, budget=0.05,
        window="1h",
        doc="<=5% of facade ingest dispatches above 1 s.",
    ),
    SLO(
        "wire-decode-latency", "latency", "wire.decode_s", target_s=5.0,
        budget=0.25, window="1h",
        doc="<=25% of bulk wire decodes above 5 s (a bulk decode covers"
        " up to 100k+ blobs; the ROADMAP letter targets 1 s at 100k).",
    ),
    SLO(
        "wire-quarantine", "ratio", "wire.blobs_quarantined",
        total="wire.blobs_decoded", budget=0.001, window="1h",
        doc="<=0.1% of decoded blobs quarantined: more means corrupt"
        " producers or wire drift, not isolated bit rot.",
    ),
    SLO(
        "accuracy-contract", "ratio", "accuracy.violations",
        total="accuracy.audits", budget=0.01, window="1h",
        doc="<=1% of shadow audits may breach the alpha contract"
        " (UDDSketch's silent-collapse failure mode, gated).",
    ),
    SLO(
        "serve-shed", "ratio", "serve.shed", total="serve.requests",
        budget=0.05, window="1h",
        doc="<=5% of serving requests shed at admission: shedding is the"
        " declared overload valve, but sustained shedding means the"
        " fleet is undersized, not protected.",
    ),
    SLO(
        "serve-deadline", "ratio", "serve.deadline_misses",
        total="serve.requests", budget=0.05, window="1h",
        doc="<=5% of serving requests may miss their deadline budget"
        " even after degrading to the cheapest engine tier.",
    ),
)


def check_slo(
    snap: dict, slos: Optional[Tuple[SLO, ...]] = None
) -> Tuple[List[str], int, int]:
    """Evaluate :data:`SLOS` against a snapshot -> (report lines,
    n_burning, n_evaluated).

    Works on single-process and merged snapshots alike.  SLOs whose
    metrics are absent (or have zero total mass) are skipped -- callers
    must treat ``n_evaluated == 0`` as a failure in its own right (wrong
    files beat a silent pass).
    """
    if slos is None:
        slos = SLOS
    rel_acc = float(snap.get("histogram_relative_accuracy",
                             HISTOGRAM_REL_ACC))
    hists = snap.get("histograms") or {}
    counters = snap.get("counters") or {}
    lines: List[str] = []
    burning = evaluated = 0
    for slo in slos:
        if slo.kind == "ratio":
            bad = sum(
                float(v) for k, v in counters.items()
                if _series_name(k) == slo.metric
            )
            total = sum(
                float(v) for k, v in counters.items()
                if _series_name(k) == slo.total
            )
            if total <= 0:
                lines.append(f"  skipped  {slo.name}: no {slo.total} mass")
                continue
            frac = bad / total
            detail = f"bad {bad:g}/{total:g}"
        else:
            series = [
                sm for k, sm in hists.items()
                if _series_name(k) == slo.metric
            ]
            total = sum(float(sm.get("count", 0.0)) for sm in series)
            if total <= 0:
                lines.append(
                    f"  skipped  {slo.name}: no {slo.metric} observations"
                )
                continue
            states = [
                sm["state"] for sm in series
                if isinstance(sm.get("state"), dict)
            ]
            if len(states) == len(series):
                from sketches_tpu_torch.mapping import LogarithmicMapping

                mapping = LogarithmicMapping(rel_acc)
                bad = 0.0
                for st in states:
                    for key, cnt in st.get("pos", {}).items():
                        if mapping.value(int(key)) > slo.target_s:
                            bad += float(cnt)
                frac = bad / total
                detail = f"bad {bad:g}/{total:g} above {slo.target_s:g}s"
            else:
                # Stateless (older) summary: p99 vs target is the best
                # available proxy -- burning iff p99 blows the target.
                p99 = max(
                    (float(sm["p99"]) for sm in series
                     if sm.get("p99") is not None),
                    default=0.0,
                )
                frac = slo.budget * (p99 / slo.target_s) if slo.target_s else 0.0
                detail = f"p99 {p99:g}s vs target {slo.target_s:g}s (no state)"
        if slo.budget > 0:
            burn = frac / slo.budget
        else:
            burn = math.inf if frac > 0 else 0.0
        evaluated += 1
        bad_slo = burn > slo.burn_threshold
        if bad_slo:
            burning += 1
        verdict = "BURNING" if bad_slo else "ok"
        lines.append(
            f"{verdict:>9}  {slo.name}: burn x{burn:.2f} ({detail},"
            f" budget {slo.budget:.2%}/{slo.window},"
            f" threshold x{slo.burn_threshold:g})"
        )
    return lines, burning, evaluated


def _load_json(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _slo_forensics(
    snap_doc: dict, snap_path: str, burning: int, evaluated: int
) -> None:
    """The ``--check-slo`` burn auto-trigger: dump a forensic bundle
    next to the offending snapshot (``<snapshot>.forensics.json``),
    with the p99 exemplar trace of a burning-candidate latency metric
    as the triggering trace.  Best-effort: a failed dump prints and
    moves on -- the gate's exit code is the contract, forensics are a
    bonus."""
    try:
        trigger = None
        for slo in SLOS:
            if slo.kind != "latency":
                continue
            try:
                found = exemplars_for(snap_doc, slo.metric, 0.99)
            except Exception:  # noqa: BLE001 - metric absent from snapshot
                continue
            if found["exemplars"]:
                trigger = found["exemplars"][0]["trace_id"]
                break
        t = _tracing()
        out_path = snap_path + ".forensics.json"
        t.dump_forensics(
            "slo-burn",
            trace=trigger,
            detail={
                "snapshot": snap_path, "burning": burning,
                "evaluated": evaluated,
            },
            snapshot=snap_doc,
            path=out_path,
        )
        print(f"check-slo: forensic bundle -> {out_path}")
    except Exception as e:  # noqa: BLE001 - forensics must not mask the gate
        print(f"check-slo: forensic dump failed: {e!r}")


def _dump_json(doc: dict, path: Optional[str]) -> None:
    text = json.dumps(doc, indent=1, sort_keys=True) + "\n"
    if path:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
    else:
        print(text, end="")


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry point: snapshot merge, SLO gate, and process snapshot
    dumps.

    Exit codes: 0 clean, 1 on any burning SLO, 2 when nothing was
    evaluable or no action was asked for (wrong files must not pass
    silently).
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m sketches_tpu_torch.telemetry",
        description="telemetry utilities: snapshot merge (fleet"
        " aggregation), SLO gate, snapshot dumps",
    )
    parser.add_argument(
        "--merge",
        nargs="+",
        metavar="SNAP",
        default=None,
        help="fold N snapshot JSONs (per-shard / per-job artifacts) into"
        " one fleet-wide snapshot; counters sum, gauges fold by declared"
        " policy, histograms merge as DDSketches (alpha preserved)",
    )
    parser.add_argument(
        "--check-slo",
        metavar="SNAPSHOT",
        default=None,
        help="evaluate the declared SLO inventory (telemetry.SLOS) against"
        " a snapshot JSON; exit 1 on any burning SLO, 2 if nothing was"
        " evaluable",
    )
    parser.add_argument(
        "--out",
        metavar="PATH",
        default=None,
        help="where --merge writes the merged snapshot (stdout otherwise)",
    )
    parser.add_argument(
        "--snapshot",
        metavar="PATH",
        default=None,
        help="write the current process's JSON snapshot to PATH",
    )
    parser.add_argument(
        "--prometheus",
        metavar="PATH",
        default=None,
        help="write the current process's Prometheus exposition to PATH",
    )
    args = parser.parse_args(argv)
    acted = False

    if args.snapshot:
        acted = True
        _dump_json(snapshot(), args.snapshot)
    if args.prometheus:
        acted = True
        with open(args.prometheus, "w", encoding="utf-8") as f:
            f.write(prometheus_text())

    if args.merge:
        acted = True
        merged = merge_snapshots(*[_load_json(p) for p in args.merge])
        _dump_json(merged, args.out)
        print(
            f"merge: folded {merged['merged_from']} snapshot(s)"
            + (f" -> {args.out}" if args.out else "")
        )

    if args.check_slo:
        snap_doc = _load_json(args.check_slo)
        lines, burning, evaluated = check_slo(snap_doc)
        for line in lines:
            print(line)
        if evaluated == 0:
            print(
                "check-slo: no SLO was evaluable against this snapshot"
                " (wrong file?)"
            )
            return 2
        if burning:
            print(f"check-slo: {burning}/{evaluated} SLO(s) BURNING")
            _slo_forensics(snap_doc, args.check_slo, burning, evaluated)
            return 1
        print(f"check-slo: {evaluated} SLO(s) within budget")
        return 0

    if acted:
        return 0
    parser.print_usage()
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port of the batched DDSketch on one CUDA card and check it.

    python3 chip_smoke.py

Builds the five CUDA kernels from ``sketches_tpu_torch/csrc`` (``nvcc``, all
in parallel, into ``build/sketches_tpu_torch/``), holds each against its
plain PyTorch version on the card, then drives three paths at full size:

* the README quick start -- ``BatchedDDSketch(n_streams=1 << 20,
  relative_accuracy=0.01, n_bins=512)``, four ``[2**20, 256]`` batches,
  p50/p90/p99/p999 -- once with positive lognormal(0, 2) traffic and once
  with 40% of the values negated.  The default route must resolve
  ``overlap`` for both; the same state queried with
  ``disabled_tiers=("overlap",)`` must resolve ``windowed`` (positive) and
  ``tiles`` (mixed);
* ``DistributedDDSketch`` over two value shards on the one card, four
  batches of positive traffic (the last ragged, padded with weight-0
  entries: K1's weighted instantiation), against the ``engine="plain"``
  facade on the same mesh: the default query resolves ``overlap``, and with
  ``disabled_tiers=("windowed", "wxla")`` the floor ``xla`` answers through
  one ``fused_quantile`` launch.

Right after the build, the ``analysis`` phase (``phase_analysis``) runs the
port's static analyzer in this process, both layers: the AST lint over
the tree and the census of the five built libraries (``cuobjdump``
registers, shared memory, spills, SASS, f64 and FFMA counts of every
kernel entry), which must equal the pinned ``analysis/budgets.json``
with no f64 instruction; a copy of the budgets with one pin cut must
fail the gate.  It launches no kernel.

``fused_quantile`` is also checked and timed on a 2048-bin state (262,144
streams, one mixed-sign batch through the facade: the same bytes as the
1M x 512 state).

Three host-side phases follow the device paths (wire and checkpoint at
262,144 streams):

* ``host_tier``: ``DDSketch(backend="torch")`` on the card at the default
  window (2048 bins), 4,194,304 lognormal(0, 2) values (40% negated)
  through ``add_many`` and 100,000 through scalar ``add``, once on the
  native-buffered tier and once with ``SKETCHES_TPU_NATIVE=0``; quantiles
  against numpy's exact ones, the two tiers against each other, and a
  pure-Python ``DDSketch`` merged in.  The native library must build.
* ``wire``: the first 262,144 streams of the positive and mixed final
  states through ``pb.wire`` (encode, native decode, mass conservation,
  native against pure-Python decode on 65,536 streams, against the
  host-sketch path on 4,096), and an exact round trip of a 262,144 x 512
  state on a pinned window whose decoded facade answers as the original
  on both routes.
* ``checkpoint``: that pinned facade saved and restored, the partials of a
  262,144-stream two-shard distributed facade saved and restored onto its
  mesh (the ``xla`` floor answers as before), and a corrupted file refused.

Then the ``backends`` phase (``phase_backends``): the uniform-collapse
``AdaptiveDDSketch`` at 1M x 512 against its ``engine="plain"`` twin, with
a fixed quarter of heavy-tailed streams, its merge, the ``MomentDDSketch``
on the same traffic, and both ``SketchPayload`` envelopes and checkpoints
at 262,144 streams.  ``kernels_vs_plain`` also holds K2-K5 to their plain
versions on the smallest weighted rank boundary.

Then the ``robustness`` phase (``phase_robustness``), the first that arms
anything: ``pallas.lowering`` armed once for each kernel tier in turn
on a 1M x 512 mixed-sign facade, each answer on the next tier equal to the
plain facade's bit for bit (``overlap -> tiles -> windowed -> wxla ->
xla``, four ``batched.query`` steps in the health ledger), each tier's
query timed; ``pallas.ingest`` once, the batch replayed on the plain path;
the same walk on the two-shard ``DistributedDDSketch`` down to its floor
(K2); and the integrity layer armed in raise mode at 262,144 x 512: a
clean merge and fold, a flipped bin refused at the merge by stream,
``repair``, a checkpoint's ``__fingerprint__`` verified (and a doctored
one refused), ``merge_partial`` with a dead shard, a torn and a clean
``reshard``.  It also prints the positive path's disarmed ``add`` and
``overlap`` query times beside those recorded before the layer existed.

Then the ``observability`` phase (``phase_observability``): telemetry (and
with it the flight recorder), profiling and the accuracy audit armed on
the mixed-sign quick start at 1M x 512 on a pinned window (two batches,
every one through K1; the default route and the ladder down to ``tiles``,
``windowed`` and ``xla``) and on a two-shard ``DistributedDDSketch`` (two
batches, the K2 floor).  Each device-clocked profiling row must be at
least its kernel's time alone from the ``times`` line (the fold: its byte
bound); the snapshot's counters, the Prometheus text, the Chrome trace's
host and device tracks and ``merge_snapshots(s, s)`` are checked; a
``pallas.lowering`` downgrade under a root trace must reach the ledger,
the telemetry events and the flight recorder, and ``explain`` at least
two causal events; the quick start's audits (real K5 queries) find no
violation and a 128-bin facade fed lognormal(0, 6) rows reports collapse
drift.  Disarmed again, facade ``add`` and the ``overlap`` query must come
within 3% of the same run's numbers from before anything was armed (each
side the least single call of three CUDA-event runs of 21: ``settled_ms``).

Then the time-window, serving and fabric phases (``phase_windows``,
``phase_serve``, ``phase_fabric``), at sizes set by host work
(fingerprints are host numpy, about 0.6 s a bucket at 65,536 x 512):

* ``windows``: ``WindowedSketch(65_536, relative_accuracy=0.01,
  n_bins=512, config=DEFAULT_LADDER)`` on a virtual clock, one mixed
  ``[65_536, 256]`` batch every 2.5 s for 240 s; the 60-s, 300-s and
  full-horizon answers equal ``oracle_quantile``, which decodes with the
  plain ``batched.quantile`` (the first through the fold and K5, the
  repeat through K5 on the cached fold), the 60-s one
  within alpha of exact quantiles of its batches on sampled streams; the
  exact ledger; an armed ``window.rotate_torn`` that changes nothing;
  ``check_window`` clean and then reporting a flipped bin, the envelope
  and a windowed checkpoint answering bit for bit (on a 4,096-stream ring
  of the same traffic: the codec and the npz writer are host Python); a
  uniform-collapse ring with collapse levels (0, 1, 2) within its
  effective alpha, and a moment ring of 1,024 streams.
* ``serve``: ``SketchServer`` with 16 dense tenants of 16,384 streams on
  one spec (262,144 streams: one stacked K2 launch, equal to each
  tenant's ``batched.quantile`` on the card bit for bit) and a windowed
  tenant; 400 requests (rank-Zipf(1.1) tenants, a write per four reads,
  deadlines, some inside the floor margin, answered on the floor: K2),
  every cache hit held to a cold ``batched.quantile``, sheds with their
  reasons, an armed straggler (the hedge, K2, equal to the primary) and
  cache poison (quarantined, recomputed).
* ``fabric``: ``ServeFabric`` of 4 virtual hosts and 3 copies, 4 pinned
  tenants of 16,384 streams: two sync rounds, every primary read equal to
  ``batched.quantile`` of the primary's state and every replica answer to
  the primary's, a corrupted replica refused and the read re-homed,
  partition and heal, ``fabric.replica_stale`` armed once, a handoff, and
  a killed primary whose failover report closes the mass ledger exactly.

In these three phases a call of the plain ``batched.quantile`` or of the
``wxla`` tier on a card state, outside a comparison with a reference,
fails the phase (``plain_quantile_on_card`` in each line).

Then the ``multiprocess`` phase (``phase_multiprocess``), in worker
processes the script starts as ``chip_smoke.py --mp-worker ...``: two
gloo ranks on the one card, each with two value shards of a pinned
262,144 x 512 state (hosts derived from the world size), K1 ingest, the
hierarchical fold (``psum_merge`` over ``make_global_mesh``'s cells: the
inner fold on the card, one host-staged ``all_reduce`` a leaf across the
ranks), K5 and K2 on the fold, held by rank 0 to a single-process
four-shard ``DistributedDDSketch`` of the same data; then a world of one
NCCL rank whose collective fold leaves the state bit-equal.

Last, because they arm integrity and faults globally, the chaos harness
and the examples (``phase_chaos``, ``phase_examples``):

* ``chaos``: the six campaigns through ``chaos.main([..., "--device",
  "cuda:0"])`` at the JAX tests' step counts and seeds
  (core 80/3, serve 60/5, elastic 60/3, adaptive 40/13, windowed 40/13,
  fabric 40/5; the elastic and windowed meshes on eight value shards of
  the one card): every verdict ``ok`` with nothing ``undetected``, the
  core and serve ``(step, site, outcome)`` lists equal to the port's CPU
  run of the same call; K1 (the ingest-variant driver) and K2 (the
  quantile checks) must launch.  The health ledger is reset after each
  verdict is read.
* ``examples``: the eight examples' ``main(["--device", "cuda:0"])`` in
  this process, each returning 0 with its closing line; ``wire_interop``
  must launch K5.

Every phase that arms nothing must leave ``resilience.health()`` without
a downgrade (the host-tier and wire phases turn the native kill switch
on, which records exactly one ``native`` event each); a demotion fails
the smoke with the ledger's text.  Each path (the wire and checkpoint
phases too) resets the launch counters before it runs and reads them
after.
Answers are checked against the plain facade and against exact quantiles of
sampled streams; each kernel is timed beside its plain version and its
bound; one JSON line is printed per phase.  The last line is
``{"ok": true, "device": {...}}``; any failure raises and exits non-zero.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.  Imports torch and numpy, never JAX, and needs no
protobuf.

    python3 chip_smoke.py --compare build/cmp/parent [--compare DIR ...]

also builds the ingest, full-window and overlap kernels of other trees
(each DIR holds ``sketches_tpu_torch/csrc``: a ``git archive`` of the parent
commit, or a patched copy, unpacked under the gitignored ``build/``) and
times them beside this tree's, in turns on the same card; the results ride
in the ``times`` line under ``compare``, labelled by DIR's name, with
``compare_bit_equal``: whether each tree's ingest outputs on each timed
batch equal this tree's bit for bit.

The ``kernels`` line's K1 row also carries its weighted and unit-weight
launches apart (``launches_weighted``, ``launches_unit``) and the times of
its weighted and padded weighted batches.

    python3 chip_smoke.py --checkpoint-writers

also times the port's checkpoint writer (zlib level 1) against
``np.savez_compressed`` (level 6) on the pinned state's host arrays, in
turns; the ``checkpoint`` line carries them under ``writers``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_STREAMS = 1 << 20
N_BINS = 512
BATCH = 256
N_BATCHES = 4
ALPHA = 0.01
QS = (0.5, 0.9, 0.99, 0.999)
CHECK_QS = (0.5, 0.9, 0.99)
N_SAMPLED = 4096
SEED = 20261016
# The host-tier phase: values through add_many, then through scalar add,
# then in the pure-Python sketch merged in.
HOST_VALUES = 1 << 22
HOST_SCALAR = 100_000
HOST_MERGED = 200_000
# The wire, checkpoint and envelope phases run at 262,144 streams (the first
# 262,144 of the main paths' states; the pinned and distributed states are
# built at that size): host work, which grows with the stream count.
WIRE_STREAMS = 1 << 18
# The wire phase: streams decoded by both drivers, and checked against the
# host-sketch path.
WIRE_DRIVER_SLICE = 65536
WIRE_HOST_SAMPLE = 4096
# Leaves the wire format carries: sum, min, max and the collapse counters
# are not on it.
WIRE_LEAVES = ("bins_pos", "bins_neg", "zero_count", "count", "key_offset", "pos_lo",
               "pos_hi", "neg_lo", "neg_hi", "neg_total", "tile_sums")

# Peak rates of the card for the bounds (NVIDIA data sheets): device-memory
# bytes/s by part, and f32 operations/s outside the tensor cores.
MEM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "H200": 4.8e12}
MEM_RATE_DEFAULT = 3.35e12  # H100 SXM
F32_OPS_RATE = 67e12
# Operation counts behind the operations bound (f32 ops, counted from the
# kernels' arithmetic): ingest ~40 per value (split, key, clamp, masks,
# accumulators) plus one per bin written; a query ~(1 + Q) per bin scanned
# (scan step and threshold compares) plus ~60 per output (decode).
INGEST_OPS_PER_VALUE = 40
QUERY_DECODE_OPS = 60
# Back-to-back launches per timed run of a kernel alone (event_ms inner).
KERNEL_INNER = 10


class SmokeFailure(AssertionError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, sort_keys=True), flush=True)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def event_ms(fn, *, warmup: int = 3, reps: int = 11, inner: int = 1,
             times: list | None = None) -> float:
    """Median device time of ``fn()`` in ms, each run timed with CUDA events.

    ``inner`` > 1 times that many back-to-back calls per run and divides:
    the host enqueues the next launch while the card runs the last, so a
    kernel's time excludes the host's launch overhead.  Warm-up scales with
    ``inner`` (the card's clocks settle over the first few milliseconds).
    ``times`` gets every run's time."""
    import torch

    for _ in range(warmup * inner):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / inner)
    if times is not None:
        times.extend(runs)
    return statistics.median(runs)


def settled_ms(fn, *, runs: int = 3, log: dict | None = None, **kw) -> float:
    """The least single call of ``runs`` :func:`event_ms` runs, each after a
    full garbage collection and an idle card; ``log`` gets each run's
    median and least call.  A facade call's CUDA events also time the
    host's enqueue, and the machine's host cores are shared: load there
    only ever lengthens a call, while a cost of the call itself lengthens
    every call, so the least call keeps the call's cost and drops the
    neighbours'.  With no load of its own on an H100 machine's host, the
    1M x 512 facade ``add``'s run medians (21 calls) ranged 11.32-16.58 ms
    while a run's least call was 11.22-11.30 ms in 17 of 20 runs
    (``tools/obs_gate_noise.py``; ROADMAP queue C has the readings)."""
    import gc

    import torch

    meds, least = [], []
    for _ in range(runs):
        gc.collect()
        torch.cuda.synchronize()
        calls: list = []
        meds.append(event_ms(fn, times=calls, **kw))
        least.append(min(calls))
    if log is not None:
        log.setdefault("medians", []).extend(meds)
        log.setdefault("least", []).extend(least)
    return min(least)


# K1's weighted launches ride beside the five wrappers' counts under this key.
K1_WEIGHTED = "ingest_histogram.weighted"


def launch_counts() -> dict:
    """The wrappers' launch counts, and K1's weighted launches apart
    (``K1_WEIGHTED``; its unit-weight launches are the rest of
    ``ingest_histogram``'s)."""
    from sketches_tpu_torch import kernels

    return {**kernels.launch_counts(), K1_WEIGHTED: kernels.ingest_histogram.weighted_launches}


def c_entry(lib, name: str):
    """``name`` of a loaded kernel library, typed as the port binds it."""
    import ctypes

    from sketches_tpu_torch import kernels

    fn = getattr(lib, name)
    fn.argtypes = kernels._ENTRY_ARGS[name]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, *args):
    """A no-argument call of C entry ``fn`` on the current stream."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*args, stream)
        require(err == 0, f"launch failed with CUDA error {err}")

    return run


def alternate_ms(runs: dict) -> dict:
    """Time each labelled launcher in turns a, b, ..., b, a (one card, one
    call) -> {label: [first median, second median]}."""
    order = list(runs) + list(reversed(list(runs)))
    got = {k: [] for k in runs}
    for k in order:
        got[k].append(event_ms(runs[k], inner=KERNEL_INNER))
    return got


def host_us(fn, *, calls: int = 200, reps: int = 5) -> float:
    """Host time of one ``fn()`` launch in microseconds: the wall time of
    enqueueing ``calls`` back-to-back launches (the card drains them
    afterwards), divided; median of ``reps``."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def mean(xs) -> float:
    return sum(xs) / len(xs)


def sm_clock_mhz():
    """The card's current SM clock in MHz from ``nvidia-smi`` (None when it
    cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def mem_rate(name: str) -> float:
    return next((r for k, r in MEM_RATE.items() if k in name), MEM_RATE_DEFAULT)


def bound(bytes_moved: float, ops: float, rate: float) -> dict:
    t_bytes = bytes_moved / rate * 1e3
    t_ops = ops / F32_OPS_RATE * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": bytes_moved,
    }


def max_abs_diff(a, b) -> float:
    """Largest |a - b| over positions where neither is NaN (NaN positions
    must agree, infinities must match exactly)."""
    import torch

    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    require(torch.equal(nan_a, nan_b), "NaN positions differ")
    keep = ~nan_a
    a, b = a[keep].double(), b[keep].double()
    inf = torch.isinf(a) | torch.isinf(b)
    require(torch.equal(a[inf], b[inf]), "infinities differ")
    d = (a[~inf] - b[~inf]).abs()
    return float(d.max()) if d.numel() else 0.0


def require_rel(a, b, rtol: float, what: str) -> float:
    """|a - b| <= rtol * |b| everywhere (NaN positions equal, infinities
    equal: an empty stream's min and max); returns the largest absolute
    difference."""
    import torch

    err = max_abs_diff(a, b)
    keep = ~torch.isnan(b)
    a, b = a[keep].double(), b[keep].double()
    ok = ((a == b) | ((a - b).abs() <= rtol * b.abs())).all()
    require(bool(ok), f"{what}: relative difference above {rtol}")
    return err


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_card() -> dict:
    import torch

    require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    name = torch.cuda.get_device_name(0)
    card = {
        "kind": name,
        "count": torch.cuda.device_count(),
        "smi": smi[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "mem_rate_Bps": mem_rate(name),
    }
    emit("card", **card)
    return card


def phase_build() -> None:
    """The five kernels (nvcc, in parallel), then the native host library
    (g++); the host tier must come up native."""
    from sketches_tpu_torch import _build, native

    t0 = time.perf_counter()
    per_source = _build.build()
    t1 = time.perf_counter()
    native_status = native.status()
    native_s = time.perf_counter() - t1
    total = time.perf_counter() - t0
    require(native_status["tier"] == "native" and native_status["wire"] == "native",
            f"the native host library did not build or load: {native_status['reason']}")
    resources = {
        src: [ln.strip() for ln in _build.build_log(src).splitlines()
              if "registers" in ln or "spill" in ln]
        for src in _build.SOURCES
    }
    emit("build", seconds=total, per_source=per_source, ptxas=resources,
         native=native_status, native_seconds=native_s)


def phase_analysis() -> dict:
    """The port's sketchlint over this tree, both layers, in this process
    (``analysis.__main__.main(["--stats", "--json", ...])``): it must exit
    0, the census of the five built libraries must equal the pinned
    ``analysis/budgets.json`` entry for entry, and no entry may hold an f64
    instruction.  Then the doctored-budget step: a copy of the budgets with
    one SASS pin halved must exit 1 with a ``kernel-budget`` finding.  One
    line a kernel entry is printed.  Launches no kernel."""
    import contextlib
    import io
    import tempfile

    from sketches_tpu_torch.analysis import __main__ as cli
    from sketches_tpu_torch.analysis import kernel_audit

    t0 = time.perf_counter()
    pinned_path = ROOT / "sketches_tpu_torch" / "analysis" / "budgets.json"
    pinned = kernel_audit.load_budgets(str(pinned_path))
    require(pinned is not None, "analysis: analysis/budgets.json is missing")

    def run(argv, json_path):
        # The CLI's summary goes to stderr: kept with its output, so that the
        # doctored step's expected finding is not read as this run's fault.
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            rc = cli.main([*argv, "--json", json_path])
        with open(json_path, encoding="utf-8") as f:
            return rc, buf.getvalue(), json.load(f)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_analysis_") as tmp:
        rc, text, report = run(["--stats"], os.path.join(tmp, "report.json"))
        require(rc == 0, f"analysis: the CLI exited {rc}: {text[-3000:]}")
        kernel = report["kernel"]
        entries = kernel["entries"]
        differ = sorted(k for k in set(entries) | set(pinned["entries"])
                        if entries.get(k) != pinned["entries"].get(k))
        require(not differ, f"analysis: the census differs from budgets.json at {differ[:6]}:"
                            f" {[(entries.get(k), pinned['entries'].get(k)) for k in differ[:2]]}")
        require(all(e["f64"] == 0 for e in entries.values()),
                "analysis: a kernel entry holds f64 instructions")
        require(kernel["smem"]["ok"] and kernel["smem"]["quantile"]["measured"],
                f"analysis: shared-memory report {kernel['smem']}")
        cut = sorted(pinned["entries"])[0]
        doctored = json.loads(json.dumps(pinned))
        doctored["entries"][cut]["sass"] //= 2
        doctored_path = os.path.join(tmp, "doctored.json")
        kernel_audit.write_budgets(doctored_path, doctored)
        drc, dout, dreport = run(["--budgets", doctored_path], os.path.join(tmp, "doctored_report.json"))
        rules = sorted({f["rule"] for f in dreport["findings"]})
        require(drc == 1 and rules == ["kernel-budget"],
                f"analysis: the doctored budgets gave exit {drc} and {rules}: {dout[-2000:]}")
    for key, e in sorted(entries.items()):
        print(f"analysis: {key}: registers {e['registers']}, shared {e['shared']} B,"
              f" stack {e['stack']} B, local {e['local']} B, spills {e['spill_stores']}/"
              f"{e['spill_loads']} B, SASS {e['sass']}, f64 {e['f64']}, FFMA {e['ffma']}",
              flush=True)
    out = {
        "nvcc": kernel["nvcc"], "entries": len(entries), "smem": kernel["smem"],
        "stats": [ln for ln in text.splitlines() if ln.startswith(("stats:", "sketchlint:"))],
        "doctored": {"cut": f"{cut} sass", "exit": drc, "rules": rules},
        "seconds": time.perf_counter() - t0,
    }
    emit("analysis", **out)
    return out


def _edge_values(gen, n, s, device):
    """Mixed-sign test values with zeros, NaN, subnormals and values beyond
    both edges of a window centred near 1."""
    import torch

    v = torch.empty((n, s), device=device).log_normal_(0.0, 2.0, generator=gen)
    u = torch.rand((n, s), device=device, generator=gen)
    v = torch.where(u < 0.4, -v, v)
    v = torch.where((u > 0.40) & (u < 0.45), torch.zeros_like(v), v)
    v = torch.where((u > 0.45) & (u < 0.47), torch.full_like(v, float("nan")), v)
    v = torch.where((u > 0.47) & (u < 0.49), torch.full_like(v, 1e-40), v)
    v = torch.where((u > 0.49) & (u < 0.51), torch.full_like(v, 1e30), v)
    v = torch.where((u > 0.51) & (u < 0.53), torch.full_like(v, -1e-30), v)
    return v.contiguous()


def phase_kernels_vs_plain(device) -> dict:
    """Each kernel against its plain version on the card, at the entry
    step's width (1024 streams x 2048 bins, batch 256) and at 512 bins; the
    overlap kernel with and without the negative store, at ring lookahead 1,
    4 and 8."""
    import torch

    from sketches_tpu_torch import batched, kernels

    gen = torch.Generator(device=device).manual_seed(SEED)
    errs = {"ingest_histogram": 0.0, "fused_quantile": 0.0, "fused_quantile_windowed": 0.0,
            "fused_quantile_tiles": 0.0, "fused_quantile_tiles_overlap": 0.0}
    n, s = 1024, 256
    checked = 0
    sum_rel = 0.0  # the sum column's error, relative to sum |v * w|
    for mapping in ("logarithmic", "linear_interpolated", "quadratic_interpolated",
                    "cubic_interpolated"):
        for n_bins in (2048, 512):
            spec = batched.SketchSpec(ALPHA, mapping_name=mapping, n_bins=n_bins)
            v = _edge_values(gen, n, s, device)
            koff = torch.randint(-n_bins // 2 - 64, -n_bins // 2 + 64, (n,), device=device,
                                 generator=gen, dtype=torch.int32)
            w = torch.rand((n, s), device=device, generator=gen) * 3.0 - 0.5
            for weighted in (False, True):
                got = kernels.ingest_histogram(spec, v, w if weighted else None, koff,
                                               weighted=weighted)
                ref = kernels.ingest_histogram_plain(spec, v, w if weighted else None, koff,
                                                     weighted=weighted)
                torch.cuda.synchronize()
                sum_col = kernels._COL["sum"]
                other = [c for c in range(got[2].shape[1]) if c != sum_col]
                pairs = [(got[0], ref[0]), (got[1], ref[1]),
                         (got[2][:, other], ref[2][:, other])]
                for a, b in pairs:
                    if weighted:
                        # f32 sums over up to S terms, taken in another order.
                        require_rel(a, b, 1e-5, "weighted ingest")
                    else:
                        require(torch.equal(a, b), f"unit-weight ingest differs ({mapping}, {n_bins})")
                    errs["ingest_histogram"] = max(errs["ingest_histogram"], max_abs_diff(a, b))
                # The sum column: mixed signs cancel, so an absolute tolerance
                # of 1e-5 * sum |v * w| over the live values.
                wl = w if weighted else torch.ones_like(v)
                scale = torch.nansum(torch.where(wl > 0, v * wl, 0.0).abs(), dim=-1)
                a, b = got[2][:, sum_col], ref[2][:, sum_col]
                both_nan = torch.isnan(a) & torch.isnan(b)
                ok = both_nan | ((a - b).abs() <= 1e-5 * scale)
                require(bool(ok.all()), f"sum column differs ({mapping}, {n_bins}, {weighted})")
                rel = torch.where(both_nan, 0.0, (a - b).abs() / scale.clamp(min=1e-30))
                sum_rel = max(sum_rel, float(rel.amax()))
                if weighted:
                    again = kernels.ingest_histogram(spec, v, w, koff, weighted=True)
                    same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                               for x, y in zip(got, again))
                    require(same, "weighted ingest is not bit-identical run to run")
                checked += 1

    qs = torch.tensor([0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0, -0.1, 1.1], device=device)
    for n_bins in (2048, 512):
        spec = batched.SketchSpec(ALPHA, n_bins=n_bins)
        for mixed in (False, True):
            v = torch.empty((n, s), device=device).log_normal_(0.0, 1.5, generator=gen)
            if mixed:
                v = torch.where(torch.rand((n, s), device=device, generator=gen) < 0.4, -v, v)
            st = batched.init(spec, n, device)
            st = batched.recenter(spec, st, batched.auto_offset(spec, st, v))
            st = batched.add(spec, st, v)
            # Empty streams: zero their mass so they answer NaN.
            empty = torch.arange(n, device=device) % 97 == 0
            st.count = torch.where(empty, 0.0, st.count)
            lo_w, n_w, w_t, with_neg = kernels.plan_state_window(spec, st)
            glo, ghi = int(st.occ_lo.amin()), int(st.occ_hi.amax())
            for w_tiles in (1, 2, 4):
                lo_b = glo // 128 // w_tiles
                nwb = ghi // 128 // w_tiles - lo_b + 1
                packed = kernels._windowed_packed(st, qs)
                for wn in ({with_neg, True} if not mixed else {True}):
                    got = kernels.fused_quantile_windowed(
                        spec, st, qs, lo_b, n_wblocks=nwb, w_tiles=w_tiles, with_neg=wn)
                    ref = kernels.fused_quantile_windowed_plain(
                        spec, st, packed, lo_b * w_tiles * 128, nwb * w_tiles, wn, qs.numel())
                    ref = torch.where(kernels._valid(st, qs), ref, float("nan"))
                    # Equal bucket index <=> values within 1e-6 (buckets are
                    # a factor gamma ~ 1.02 apart); the decode's exp may
                    # differ by an ulp between the kernel and torch.
                    errs["fused_quantile_windowed"] = max(
                        errs["fused_quantile_windowed"], require_rel(got, ref, 1e-6, "windowed"))
            k_tiles, with_neg_t = kernels.plan_tile_query(spec, st, qs)
            packed = kernels._tiles_packed(spec, st, qs)
            for wn in ({with_neg_t, True}):
                got = kernels.fused_quantile_tiles(spec, st, qs, k_tiles=k_tiles, with_neg=wn)
                ref = kernels.fused_quantile_tiles_plain(spec, st, packed, wn, qs.numel())
                errs["fused_quantile_tiles"] = max(
                    errs["fused_quantile_tiles"], require_rel(got, ref, 1e-6, "tiles"))
            # And both against the full-window plain quantile.
            full = batched.quantile(spec, st, qs)
            got = kernels.fused_quantile_tiles(spec, st, qs, k_tiles=k_tiles, with_neg=with_neg_t)
            require_rel(got, full, 1e-6, "tiles vs batched.quantile")
            # K5 against its plain version, and equal to K3 exactly.
            for wn in (False, True):
                for lookahead in (1, 4, 8):
                    got = kernels.fused_quantile_tiles_overlap(
                        spec, st, qs, k_tiles=k_tiles, with_neg=wn, lookahead=lookahead)
                    bn = kernels._stream_block(n)
                    lists_pos, lists_neg, packed = kernels._tile_query_operands(
                        spec, st, qs, bn, k_tiles)
                    ref = kernels.fused_quantile_tiles_overlap_plain(
                        spec, st, lists_pos, lists_neg, packed, bn, wn, qs.numel())
                    errs["fused_quantile_tiles_overlap"] = max(
                        errs["fused_quantile_tiles_overlap"], require_rel(got, ref, 1e-6, "overlap"))
                    tiles = kernels.fused_quantile_tiles(spec, st, qs, k_tiles=k_tiles, with_neg=wn)
                    same = torch.equal(torch.isnan(got), torch.isnan(tiles)) and torch.equal(
                        got.nan_to_num(), tiles.nan_to_num())
                    require(same, f"overlap differs from tiles ({n_bins}, {mixed}, {wn})")
            # K2 against its plain version and the plain quantile, at 9
            # quantiles and at the main path's 4.
            for qk in (qs, qs[:4]):
                got = kernels.fused_quantile(spec, st, qk)
                ref = kernels.fused_quantile_plain(spec, st, qk)
                errs["fused_quantile"] = max(
                    errs["fused_quantile"], require_rel(got, ref, 1e-6, "fused_quantile"))
                require_rel(got, batched.quantile(spec, st, qk), 1e-6,
                            "fused_quantile vs batched.quantile")
    boundary = _weighted_rank_boundary(device, errs)
    torch.cuda.synchronize()
    emit("kernels_vs_plain", ingest_cases=checked, max_abs_err=errs,
         ingest_sum_col_max_rel=sum_rel, weighted_rank_boundary=boundary,
         tolerance="unit-weight ingest bit-identical; weighted ingest rtol 1e-5; sum column"
         " atol 1e-5*sum|v*w|; queries equal bucket (values rtol 1e-6: decode exp ulps);"
         " overlap equal to tiles exactly; max_abs_err of the ingest covers histograms and"
         " every column but sum; the weighted rank boundary: each query kernel equal to its"
         " plain version bit for bit")
    return errs


# The smallest weighted rank boundary (one stream, alpha 0.02, 256 bins):
# its third prefix sum, accumulated in f32, equals rank = count - 1 at q = 1,
# and the JAX package (and the pure-Python DDSketch) answers 2.6642716.
BOUNDARY_FIRST = ((0.43233886, 0.20904201), (1.0375978, 0.97834975))
BOUNDARY_SECOND = (2.7012644, 0.36471483)
BOUNDARY_ANSWER = 2.6642716


def _weighted_rank_boundary(device, errs) -> dict:
    """The boundary stream tiled over 256 streams through the facade, then
    K2, K3, K4 and K5 each against its plain version on the card: equal bit
    for bit, and the answer at q = 1 is the reference's."""
    import torch

    from sketches_tpu_torch import batched, kernels

    n = 256
    sk = batched.BatchedDDSketch(n, relative_accuracy=0.02, n_bins=256, device=device)
    v1, w1 = (torch.tensor(x, device=device).repeat(n, 1) for x in BOUNDARY_FIRST)
    sk.add(v1, w1).add(torch.tensor(BOUNDARY_SECOND, device=device).repeat(n, 1))
    spec, st = sk.spec, sk.state
    qs = torch.tensor([1.0, 0.5, 0.0], device=device)
    lo_w, n_w, w_t, with_neg = kernels.plan_state_window(spec, st)
    k_tiles, with_neg_t = kernels.plan_tile_query(spec, st, qs)
    bn = kernels._stream_block(n)
    lists_pos, lists_neg, packed = kernels._tile_query_operands(spec, st, qs, bn, k_tiles)
    windowed_plain = kernels.fused_quantile_windowed_plain(
        spec, st, kernels._windowed_packed(st, qs), lo_w * w_t * 128, n_w * w_t, with_neg,
        qs.numel())
    pairs = {
        "fused_quantile": (kernels.fused_quantile(spec, st, qs),
                           kernels.fused_quantile_plain(spec, st, qs)),
        "fused_quantile_windowed": (
            kernels.fused_quantile_windowed(spec, st, qs, lo_w, n_wblocks=n_w, w_tiles=w_t,
                                            with_neg=with_neg),
            torch.where(kernels._valid(st, qs), windowed_plain, float("nan"))),
        "fused_quantile_tiles": (
            kernels.fused_quantile_tiles(spec, st, qs, k_tiles=k_tiles, with_neg=with_neg_t),
            kernels.fused_quantile_tiles_plain(spec, st, kernels._tiles_packed(spec, st, qs),
                                               with_neg_t, qs.numel())),
        "fused_quantile_tiles_overlap": (
            kernels.fused_quantile_tiles_overlap(spec, st, qs, k_tiles=k_tiles,
                                                 with_neg=with_neg_t),
            kernels.fused_quantile_tiles_overlap_plain(spec, st, lists_pos, lists_neg, packed,
                                                       bn, with_neg_t, qs.numel())),
    }
    out = {}
    for name, (got, ref) in pairs.items():
        require(torch.equal(got, ref), f"weighted rank boundary: {name} differs from its plain"
                                       " version")
        answer = got[0, 0].item()
        require(answer == float(np.float32(BOUNDARY_ANSWER)),
                f"weighted rank boundary: {name} answers {answer}, the reference"
                f" {BOUNDARY_ANSWER}")
        errs[name] = max(errs[name], max_abs_diff(got, ref))
        out[name] = answer
    return out


def _exact_lower(x, qs):
    """Exact lower quantiles of each row of ``x``, NaN entries (padding)
    left out."""
    import torch

    q = torch.tensor(qs, dtype=torch.float64, device=x.device)
    return torch.nanquantile(x.double(), q, dim=1, interpolation="lower").T


def phase_main_path(device, name: str, negate: float, expect_tier: str) -> dict:
    """The quick start at full size through the facade, on the card: the
    default route (``overlap``), then the same state with the overlap tier
    disabled (``expect_tier``)."""
    import torch

    from sketches_tpu_torch import BatchedDDSketch, batched, kernels

    gen = torch.Generator(device=device).manual_seed(SEED + int(negate * 100))
    sk = BatchedDDSketch(n_streams=N_STREAMS, relative_accuracy=ALPHA, n_bins=N_BINS)
    ref = BatchedDDSketch(n_streams=N_STREAMS, relative_accuracy=ALPHA, n_bins=N_BINS,
                          engine="plain")
    require(sk.engine == "kernel" and sk.device.type == "cuda", "facade is not on the kernel path")
    sample = torch.randperm(N_STREAMS, device=device, generator=gen)[:N_SAMPLED]
    kept = []
    chunk = batched._stream_chunk(N_STREAMS, N_BINS) or N_STREAMS
    chunks = -(-N_STREAMS // chunk)
    kernels.reset_launch_counts()
    per_batch = []
    add_ms = []
    abs_sum = torch.zeros(N_STREAMS, dtype=torch.float64, device=device)
    for b in range(N_BATCHES):
        v = torch.empty((N_STREAMS, BATCH), device=device).log_normal_(0.0, 2.0, generator=gen)
        if negate:
            v = torch.where(torch.rand(v.shape, device=device, generator=gen) < negate, -v, v)
        kept.append(v[sample])
        abs_sum += v.abs().sum(-1, dtype=torch.float64)
        before = kernels.ingest_histogram.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sk.add(v)
        torch.cuda.synchronize()
        add_ms.append((time.perf_counter() - t0) * 1e3)
        per_batch.append(kernels.ingest_histogram.launches - before)
        ref.add(v)
        del v
    tier, got = sk.get_quantile_values_resolved(QS)
    torch.cuda.synchronize()
    after_default = kernels.launch_counts()
    ladder_tier, ladder = sk.get_quantile_values_resolved(QS, disabled_tiers=("overlap",))
    torch.cuda.synchronize()
    launches = launch_counts()
    require(per_batch == [0] + [chunks] * (N_BATCHES - 1),
            f"ingest launches per batch {per_batch}, expected 0 then {chunks} each")
    require(tier == "overlap", f"{name} traffic resolved {tier!r}, expected 'overlap'")
    require(after_default["fused_quantile_tiles_overlap"] == 1,
            "the overlap kernel did not launch once on the default route")
    require(ladder_tier == expect_tier,
            f"{name} traffic without overlap resolved {ladder_tier!r}, expected {expect_tier!r}")
    qkey = {"windowed": "fused_quantile_windowed", "tiles": "fused_quantile_tiles"}[ladder_tier]
    require(launches[qkey] == 1, f"{qkey} launched {launches[qkey]} times, expected 1")
    err_ladder = require_rel(got, ladder, 1e-6, f"{name}: overlap vs {ladder_tier}")

    # The state and the answer against the plain facade on the card.
    for f in batched.LEAVES:
        a, b = getattr(sk.state, f), getattr(ref.state, f)
        if f == "sum":
            # f32 sums of the same values in another order: within
            # 1e-5 * sum |v| of the stream.
            require(bool(((a - b).abs() <= 1e-5 * abs_sum).all()),
                    "sum leaf differs from the plain facade")
        else:
            require(torch.equal(a, b), f"leaf {f} differs from the plain facade")
    ref_tier, ref_vals = ref.get_quantile_values_resolved(QS)
    err_plain = require_rel(got, ref_vals, 1e-6, f"{name}: kernel facade vs plain facade")
    require(bool(torch.isfinite(got).all()) and got.shape == (N_STREAMS, len(QS)),
            "answers are not finite [N, Q]")

    # Against exact lower quantiles of the sampled streams: alpha * |x|
    # plus one ulp (errors reach the bound exactly at bucket edges).
    exact = _exact_lower(torch.cat(kept, dim=1), CHECK_QS)
    est = got[sample][:, : len(CHECK_QS)].double()
    ulp = torch.finfo(torch.float32).eps * exact.abs()
    bad = (est - exact).abs() > ALPHA * exact.abs() + ulp
    require(not bool(bad.any()), f"{name}: {int(bad.sum())} sampled quantiles outside alpha")
    rel = ((est - exact).abs() / exact.abs()).amax().item()
    out = {
        "tier": tier, "ladder_tier": ladder_tier, "plain_tier": ref_tier,
        "ingest_launches_per_batch": per_batch, "launches": launches,
        "max_rel_err_vs_exact": rel, "max_abs_diff_vs_plain": err_plain,
        "max_abs_diff_overlap_vs_ladder": err_ladder, "add_ms_per_batch": add_ms,
    }

    # Per-batch ingest through the facade (kernel path incl. the fold) and
    # the plain facade's, on the steady state.
    v = torch.empty((N_STREAMS, BATCH), device=device).log_normal_(0.0, 2.0, generator=gen)
    out["facade_add_ms"] = event_ms(lambda: sk.add(v), warmup=1)
    out["plain_facade_add_ms"] = event_ms(lambda: ref.add(v), warmup=1)
    out["values_per_s"] = N_STREAMS * BATCH / (out["facade_add_ms"] / 1e3)
    out["facade_query_ms"] = event_ms(lambda: sk.get_quantile_values(QS))
    out["facade_ladder_query_ms"] = event_ms(
        lambda: sk.get_quantile_values_resolved(QS, disabled_tiers=("overlap",)))
    out["plain_facade_query_ms"] = event_ms(lambda: ref.get_quantile_values(QS))
    emit(f"main_path_{name}", **out)
    out["facade"] = sk
    del ref
    return out


def phase_distributed(device) -> dict:
    """``DistributedDDSketch`` over two value shards on the one card, at the
    quick start's width, against the plain engine on the same mesh.  The
    last batch is ragged: padded to the width with weight-0 entries (NaN
    and +-inf under them), as the facade asks, and weight 1 on the live
    values, so it takes K1's weighted instantiation while every mass stays
    an integer and the two engines' states stay equal."""
    import torch

    from sketches_tpu_torch import batched, kernels
    from sketches_tpu_torch.parallel import DistributedDDSketch, SketchMesh

    gen = torch.Generator(device=device).manual_seed(SEED + 77)
    mesh = SketchMesh(devices=[device, device])
    dist = DistributedDDSketch(N_STREAMS, mesh=mesh, relative_accuracy=ALPHA, n_bins=N_BINS)
    ref = DistributedDDSketch(N_STREAMS, mesh=mesh, relative_accuracy=ALPHA, n_bins=N_BINS,
                              engine="plain")
    require(dist.engine == "kernel" and ref.engine == "plain", "distributed engines")
    sample = torch.randperm(N_STREAMS, device=device, generator=gen)[:N_SAMPLED]
    kept = []
    abs_sum = torch.zeros(N_STREAMS, dtype=torch.float64, device=device)
    add_ms, plain_add_ms = [], []
    kernels.reset_launch_counts()
    for b in range(N_BATCHES):
        if b < N_BATCHES - 1:
            v = torch.empty((N_STREAMS, BATCH), device=device).log_normal_(
                0.0, 2.0, generator=gen)
            w, live = None, torch.ones_like(v, dtype=torch.bool)
        else:
            v, w = padded_batch(gen, N_STREAMS, BATCH, device)
            live = w > 0
            w = live.float()
        kept.append(torch.where(live, v, float("nan"))[sample])
        abs_sum += torch.where(live, v.abs(), 0.0).sum(-1, dtype=torch.float64)
        for facade, times in ((dist, add_ms), (ref, plain_add_ms)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            facade.add(v, w)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        del v, w, live
    ingest_launches = kernels.ingest_histogram.launches
    weighted_launches = kernels.ingest_histogram.weighted_launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tier, got = dist.get_quantile_values_resolved(QS)
    torch.cuda.synchronize()
    first_query_ms = (time.perf_counter() - t0) * 1e3
    after_default = kernels.launch_counts()
    floor_tier, floor = dist.get_quantile_values_resolved(QS, disabled_tiers=("windowed", "wxla"))
    torch.cuda.synchronize()
    launches = launch_counts()
    require(ingest_launches == 2 * N_BATCHES and weighted_launches == 2,
            f"{ingest_launches} ingest launches ({weighted_launches} weighted), expected one"
            f" per value shard per batch (the padded batch's two weighted)")
    require(tier == "overlap", f"distributed default resolved {tier!r}, expected 'overlap'")
    require(after_default["fused_quantile_tiles_overlap"] == 1, "overlap did not launch once")
    require(floor_tier == "xla", f"distributed floor resolved {floor_tier!r}, expected 'xla'")
    require(launches["fused_quantile"] == 1,
            f"fused_quantile launched {launches['fused_quantile']} times, expected 1")
    err_floor = require_rel(floor, got, 1e-6, "distributed: xla vs overlap")

    # Partials and the merged state against the plain engine's.
    for row_k, row_p in zip(dist.shard_partials(), ref.shard_partials()):
        for pk, pp in zip(row_k, row_p):
            for f in batched.LEAVES:
                a, b = getattr(pk, f), getattr(pp, f)
                if f == "sum":
                    require(bool(((a - b).abs() <= 1e-5 * abs_sum).all()), "partial sum differs")
                else:
                    require(torch.equal(a, b), f"partial leaf {f} differs from the plain engine")
    mk, mp = dist.merged_state(), ref.merged_state()
    for f in batched.LEAVES:
        a, b = getattr(mk, f), getattr(mp, f)
        if f == "sum":
            require(bool(((a - b).abs() <= 1e-5 * abs_sum).all()), "merged sum differs")
        else:
            require(torch.equal(a, b), f"merged leaf {f} differs from the plain engine")
    ref_tier, ref_vals = ref.get_quantile_values_resolved(QS)
    err_plain = require_rel(got, ref_vals, 1e-6, "distributed: kernel vs plain engine")
    require(bool(torch.isfinite(got).all()) and got.shape == (N_STREAMS, len(QS)),
            "distributed answers are not finite [N, Q]")
    exact = _exact_lower(torch.cat(kept, dim=1), CHECK_QS)
    est = got[sample][:, : len(CHECK_QS)].double()
    ulp = torch.finfo(torch.float32).eps * exact.abs()
    bad = (est - exact).abs() > ALPHA * exact.abs() + ulp
    require(not bool(bad.any()), f"distributed: {int(bad.sum())} sampled quantiles outside alpha")
    rel = ((est - exact).abs() / exact.abs()).amax().item()
    out = {
        "tier": tier, "floor_tier": floor_tier, "plain_tier": ref_tier, "launches": launches,
        "max_rel_err_vs_exact": rel, "max_abs_diff_vs_plain": err_plain,
        "max_abs_diff_floor_vs_default": err_floor, "add_ms_per_batch": add_ms,
        "plain_add_ms_per_batch": plain_add_ms, "first_query_ms": first_query_ms,
        "query_ms": event_ms(lambda: dist.get_quantile_values(QS)),
        "floor_query_ms": event_ms(
            lambda: dist.get_quantile_values_resolved(QS, disabled_tiers=("windowed", "wxla"))),
        "plain_query_ms": event_ms(lambda: ref.get_quantile_values(QS)),
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
    }
    emit("distributed", **out)
    out["facade"] = dist
    del ref
    return out


def build_compare(trees) -> dict:
    """Compile other trees' ingest.cu, quantile.cu and overlap.cu (the same
    C entry points) with this tree's flags, every tree at once -> {tree
    name: {entry name: function}}."""
    from concurrent.futures import ThreadPoolExecutor

    from sketches_tpu_torch import _build

    sources = {"sk_ingest": "ingest.cu", "sk_quantile": "quantile.cu", "sk_overlap": "overlap.cu"}
    csrcs = {Path(t).name: Path(t).resolve() / "sketches_tpu_torch" / "csrc" for t in trees}
    require(len(csrcs) == len(trees), "--compare trees need distinct names")
    # One build a distinct library: trees that share a source share its
    # library (named by content), and two builds of one file would race.
    todo = {}
    for c in csrcs.values():
        for src in sources.values():
            todo.setdefault(_build.library_path(src, c), (src, c))
    with ThreadPoolExecutor(max(1, len(todo))) as pool:
        list(pool.map(lambda job: _build.build([job[0]], job[1]), todo.values()))
    return {label: {e: c_entry(_build.library(src, c), e) for e, src in sources.items()}
            for label, c in csrcs.items()}


def padded_batch(gen, n: int, s: int, device):
    """A ragged batch padded to width ``s`` (the public way to send one):
    row r's first L_r values are live, L_r drawn from 0..s; lognormal(0, 2)
    values with weights in (0, 2); the padding has weight 0 over NaN, +inf
    and -inf values."""
    import torch

    v = torch.empty((n, s), device=device).log_normal_(0.0, 2.0, generator=gen)
    w = torch.rand((n, s), device=device, generator=gen) * 2.0
    live = torch.randint(0, s + 1, (n, 1), device=device, generator=gen)
    pad = torch.arange(s, device=device)[None, :] >= live
    junk = torch.tensor([float("nan"), float("inf"), -float("inf")], device=device)
    fill = junk[torch.randint(0, 3, (n, s), device=device, generator=gen)]
    return torch.where(pad, fill, v).contiguous(), torch.where(pad, 0.0, w).contiguous()


def time_ingest(device, rate: float, others: dict) -> dict:
    """K1 alone at the main path's launch shape, one stream chunk x 256
    values: lognormal values (the ``kernels`` line's row), a constant batch
    (every value in one bin, the heaviest skew), a weighted call and a
    padded weighted batch (:func:`padded_batch`), timed in turns (lognormal,
    constant, weighted, padded, padded, weighted, constant, lognormal); each
    ``ms`` is the mean of its two turns, ``turns_ms`` both of them and
    ``sm_mhz`` the SM clock read just before the first; ``host_us`` is the
    host's time to launch it.  ``others`` ({label: sk_ingest of another
    build}) are timed beside this kernel in turns, on each of the four
    batches, and their host times beside its own; ``compare_bit_equal``
    says, for each, whether its outputs on each batch equal this build's
    bit for bit."""
    import torch

    from sketches_tpu_torch import batched, kernels

    spec = batched.SketchSpec(ALPHA, n_bins=N_BINS)
    n = batched._stream_chunk(N_STREAMS, N_BINS) or N_STREAMS
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    v = torch.empty((n, BATCH), device=device).log_normal_(0.0, 2.0, generator=gen)
    const = torch.full_like(v, 3.7)
    w = torch.rand((n, BATCH), device=device, generator=gen) * 2.0
    vp, wp = padded_batch(gen, n, BATCH, device)
    koff = torch.full((n,), -(N_BINS // 2) + 64, dtype=torch.int32, device=device)
    ncols = kernels._ncols(spec.n_tiles)
    hist_pos = torch.empty((n, N_BINS), dtype=torch.float32, device=device)
    hist_neg = torch.empty_like(hist_pos)
    cols = torch.empty((n, ncols), dtype=torch.float32, device=device)
    consts = kernels._mapping_consts(spec.mapping, device)

    def run(fn, x, weights=None, outs=(hist_pos, hist_neg, cols)):
        return launcher(fn, x.data_ptr(), None if weights is None else weights.data_ptr(),
                        koff.data_ptr(), *(o.data_ptr() for o in outs),
                        consts.data_ptr(), spec.mapping.kernel_id, n, BATCH, N_BINS, ncols)

    def outputs(fn, x, weights=None):
        outs = (torch.empty_like(hist_pos), torch.empty_like(hist_neg), torch.empty_like(cols))
        run(fn, x, weights, outs)()
        torch.cuda.synchronize()
        return outs

    def plain(x, weights=None):
        return lambda: kernels.ingest_histogram_plain(spec, x, weights, koff,
                                                      weighted=weights is not None)

    fn = kernels._entry("sk_ingest")
    batches = {"lognormal": (v,), "constant": (const,), "weighted": (v, w), "padded": (vp, wp)}
    sm_mhz = sm_clock_mhz()
    turns = alternate_ms({label: run(fn, *b) for label, b in batches.items()})
    bytes_moved = 4 * (n * BATCH + n + 2 * n * N_BINS + n * ncols)
    ops = INGEST_OPS_PER_VALUE * n * BATCH + 2 * n * N_BINS
    out = {"ms": mean(turns["lognormal"]), "turns_ms": turns["lognormal"],
           "plain_ms": event_ms(plain(v)), "shape": [n, BATCH, N_BINS], "sm_mhz": sm_mhz,
           "host_us": host_us(run(fn, v)), **bound(bytes_moved, ops, rate)}
    out["constant"] = {"ms": mean(turns["constant"]), "turns_ms": turns["constant"],
                       "plain_ms": event_ms(plain(const))}
    # A padded batch reads every value and weight; its ops count only the
    # live values.
    live = int((wp > 0).sum())
    out["weighted"] = {"ms": mean(turns["weighted"]), "turns_ms": turns["weighted"],
                       "plain_ms": event_ms(plain(v, w)),
                       **bound(bytes_moved + 4 * n * BATCH, ops, rate)}
    out["padded"] = {"ms": mean(turns["padded"]), "turns_ms": turns["padded"],
                     "plain_ms": event_ms(plain(vp, wp)), "live_share": live / (n * BATCH),
                     **bound(bytes_moved + 4 * n * BATCH,
                             INGEST_OPS_PER_VALUE * live + 2 * n * N_BINS, rate)}
    # The padded batch against the plain version, and bit-identical again.
    got, again = outputs(fn, vp, wp), outputs(fn, vp, wp)
    require(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                for x, y in zip(got, again)), "padded ingest is not bit-identical run to run")
    ref = kernels.ingest_histogram_plain(spec, vp, wp, koff, weighted=True)
    sc = kernels._COL["sum"]
    keep = [c for c in range(ncols) if c != sc]
    for a, b in ((got[0], ref[0]), (got[1], ref[1]), (got[2][:, keep], ref[2][:, keep])):
        require_rel(a, b, 1e-5, "padded weighted ingest")
    scale = torch.nansum(torch.where(wp > 0, vp * wp, 0.0).abs(), dim=-1)
    require(bool(((got[2][:, sc] - ref[2][:, sc]).abs() <= 1e-5 * scale).all()),
            "padded weighted ingest: sum column differs")
    del got, again, ref
    if others:
        cmp_turns = {
            label: alternate_ms({"this": run(fn, *b), **{k: run(f, *b) for k, f in others.items()}})
            for label, b in batches.items()
        }
        out["compare"] = {label: {k: mean(t) for k, t in got.items()}
                          for label, got in cmp_turns.items()}
        out["compare_turns_ms"] = cmp_turns
        out["compare_host_us"] = {k: host_us(run(f, v)) for k, f in others.items()}
        out["compare_bit_equal"] = {}
        for k, f in others.items():
            same = {}
            for label, b in batches.items():
                mine, theirs = outputs(fn, *b), outputs(f, *b)
                same[label] = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                                  for x, y in zip(mine, theirs))
                del mine, theirs
            out["compare_bit_equal"][k] = same
    return out


def _distinct_tiles(spec, packed, q: int, device) -> int:
    """Distinct crossing tiles this run's data needs: one per distinct
    (stream, store tile) among the live ranks."""
    import torch

    n = packed.shape[0]
    ut = packed[:, q: 2 * q].long()
    live = (packed[:, 2 * q: 3 * q] < 0.5) & (packed[:, 3 * q: 4 * q] < 0.5)
    per_row = 2 * spec.n_tiles
    ids = torch.where(live, torch.arange(n, device=device)[:, None] * per_row + ut, -1)
    return torch.unique(ids[ids >= 0]).numel()


def time_query(device, facade, tier: str, rate: float, lookahead: int = 8,
               others: dict = None) -> dict:
    """One query kernel alone on a main path's final state, with the
    operands the wrapper builds prepared beforehand: ``windowed``,
    ``tiles``, ``overlap`` (ring depth from ``lookahead``, the wrapper's
    default 8) or ``xla`` (``fused_quantile``, with its launch geometry).
    ``others`` ({label: the same C entry of another build}) are timed
    beside this tree's kernel in turns."""
    import torch

    from sketches_tpu_torch import kernels

    spec, st = facade.spec, facade.state
    qs = torch.tensor(QS, dtype=torch.float32, device=device)
    n, q = st.n_streams, len(QS)
    lo_w, n_w, w_t, with_neg = kernels.plan_state_window(spec, st)
    consts = kernels._mapping_consts(spec.mapping, device).data_ptr()
    out = torch.empty((n, q), dtype=torch.float32, device=device)
    pos = st.bins_pos.data_ptr()
    mid = spec.mapping.kernel_id
    if tier == "windowed":
        packed = kernels._windowed_packed(st, qs)
        lo_bin, ntw = lo_w * w_t * 128, n_w * w_t
        entry = "sk_windowed"
        args = (pos, st.bins_neg.data_ptr() if with_neg else None, packed.data_ptr(),
                out.data_ptr(), consts, mid, n, spec.n_bins, q, packed.shape[1], lo_bin, ntw)

        def plain():
            kernels.fused_quantile_windowed_plain(spec, st, packed, lo_bin, ntw, with_neg, q)

        stores = 2 if with_neg else 1
        bytes_moved = 4 * (stores * n * ntw * 128 + packed.numel() + n * q)
        ops = stores * n * ntw * 128 * (1 + q) + QUERY_DECODE_OPS * n * q
        extra = {"window_tiles": ntw, "with_neg": with_neg}
    elif tier == "tiles":
        k_tiles, with_neg = kernels.plan_tile_query(spec, st, qs)
        packed = kernels._tiles_packed(spec, st, qs)
        entry = "sk_tiles"
        args = (pos, st.bins_neg.data_ptr() if with_neg else None, packed.data_ptr(),
                out.data_ptr(), consts, mid, n, spec.n_bins, q, packed.shape[1])

        def plain():
            kernels.fused_quantile_tiles_plain(spec, st, packed, with_neg, q)

        distinct = _distinct_tiles(spec, packed, q, device)
        bytes_moved = 4 * (distinct * 128 + packed.numel() + n * q)
        ops = distinct * 128 * 2 + QUERY_DECODE_OPS * n * q
        extra = {"distinct_tiles": distinct, "k_tiles": k_tiles, "with_neg": with_neg}
    elif tier == "overlap":
        k_tiles, with_neg = kernels.plan_tile_query(spec, st, qs)
        bn = kernels._stream_block(n)
        depth = kernels._overlap_depth((2 if with_neg else 1) * k_tiles, lookahead)
        lists_pos, lists_neg, packed = kernels._tile_query_operands(spec, st, qs, bn, k_tiles)
        entry = "sk_overlap"
        args = (pos, st.bins_neg.data_ptr() if with_neg else None, lists_pos.data_ptr(),
                lists_neg.data_ptr() if with_neg else None, packed.data_ptr(), out.data_ptr(),
                consts, mid, n, spec.n_bins, q, packed.shape[1], bn, k_tiles, depth)

        def plain():
            kernels.fused_quantile_tiles_overlap_plain(
                spec, st, lists_pos, lists_neg, packed, bn, with_neg, q)

        # The bound counts the tiles the answer needs (as for K3); the
        # kernel reads every fresh list entry's slab of its block.
        distinct = _distinct_tiles(spec, packed, q, device)
        lists = torch.cat([lists_pos, lists_neg], 1) if with_neg else lists_pos
        fresh = torch.ones_like(lists, dtype=torch.bool)
        for half in range(2 if with_neg else 1):
            sl = slice(half * k_tiles + 1, (half + 1) * k_tiles)
            fresh[:, sl] = lists[:, sl] != lists[:, half * k_tiles: (half + 1) * k_tiles - 1]
        bytes_read = int(fresh.sum()) * bn * 128 * 4
        bytes_moved = 4 * (distinct * 128 + packed.numel() + lists.numel() + n * q)
        ops = distinct * 128 * 2 + QUERY_DECODE_OPS * n * q
        extra = {"distinct_tiles": distinct, "k_tiles": k_tiles, "with_neg": with_neg,
                 "depth": depth, "block_streams": bn, "slab_bytes_read": bytes_read}
    else:
        entry = "sk_quantile"
        args = (pos, st.bins_neg.data_ptr(), st.zero_count.data_ptr(), st.count.data_ptr(),
                st.key_offset.data_ptr(), qs.data_ptr(), out.data_ptr(), consts, mid, n,
                spec.n_bins, q)

        def plain():
            kernels.fused_quantile_plain(spec, st, qs)

        bytes_moved = 4 * (2 * n * spec.n_bins + 3 * n + q + n * q)
        ops = 2 * n * spec.n_bins * (1 + q) + QUERY_DECODE_OPS * n * q
        extra = {"with_neg": True, "shape": [n, spec.n_bins, q],
                 "geometry": quantile_geometry(mid, spec.n_bins)}
    run = launcher(kernels._entry(entry), *args)
    ms = event_ms(run, inner=KERNEL_INNER)
    plain_ms = event_ms(plain)
    if others:
        turns = alternate_ms({"this": run, **{k: launcher(f, *args) for k, f in others.items()}})
        extra["compare"] = {k: mean(v) for k, v in turns.items()}
        extra["compare_turns_ms"] = turns
    return {"ms": ms, "plain_ms": plain_ms, **extra, **bound(bytes_moved, ops, rate)}


def quantile_geometry(mapping_id: int, n_bins: int) -> dict:
    """The launch geometry ``sk_quantile`` takes for this call (its
    ``sk_quantile_shape`` report: rows a ring slot, consumer warps (one
    slot each), threads and dynamic shared memory a CTA, CTAs an SM)."""
    import ctypes

    from sketches_tpu_torch import _build

    fn = _build.library("quantile.cu").sk_quantile_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 7)()
    err = fn(mapping_id, n_bins, vals)
    require(err == 0, f"sk_quantile_shape failed with CUDA error {err}")
    keys = ("rows_per_slot", "consumer_warps", "threads", "smem_bytes", "ctas_per_sm", "sms",
            "wide")
    return dict(zip(keys, list(vals)))


def phase_wide_state(device, rate: float, others: dict) -> dict:
    """``fused_quantile`` on a 2048-bin state: 262,144 streams, one
    mixed-sign lognormal batch through the facade (4.3 GB of bins, as the
    1M x 512 state), checked against its plain version and timed."""
    import torch

    from sketches_tpu_torch import BatchedDDSketch, kernels

    n, n_bins = N_STREAMS // 4, N_BINS * 4
    gen = torch.Generator(device=device).manual_seed(SEED + 2048)
    sk = BatchedDDSketch(n_streams=n, relative_accuracy=ALPHA, n_bins=n_bins)
    v = torch.empty((n, BATCH), device=device).log_normal_(0.0, 2.0, generator=gen)
    v = torch.where(torch.rand(v.shape, device=device, generator=gen) < 0.4, -v, v)
    sk.add(v)
    del v
    qs = torch.tensor(QS, dtype=torch.float32, device=device)
    got = kernels.fused_quantile(sk.spec, sk.state, qs)
    err = require_rel(got, kernels.fused_quantile_plain(sk.spec, sk.state, qs), 1e-6,
                      "fused_quantile at 2048 bins")
    require(bool(torch.isfinite(got).all()), "2048-bin answers are not finite")
    out = time_query(device, sk, "xla", rate, others=others)
    out["max_abs_err"] = err
    return out


def _quantile_ok(est, exact) -> bool:
    """|est - exact| <= alpha * |exact| plus one f32 ulp."""
    slack = (ALPHA + float(np.finfo(np.float32).eps)) * abs(exact)
    return abs(est - exact) <= slack


def phase_host_tier(device) -> dict:
    """``DDSketch(backend="torch")`` on the card at the default window (2048
    bins, alpha 0.01), on the native-buffered tier and on the device-flush
    tier (``SKETCHES_TPU_NATIVE=0``: each 16,384-value chunk goes to the
    card): ``add_many`` then scalar ``add``, quantiles against numpy's
    exact lower ones, the tiers against each other, then a pure-Python
    ``DDSketch`` merged into the native-tier sketch."""
    import os

    import torch

    from sketches_tpu_torch import DDSketch, native

    r = np.random.RandomState(SEED + 5)
    n_all = HOST_VALUES + HOST_SCALAR
    values = r.lognormal(0.0, 2.0, n_all) * np.where(r.rand(n_all) < 0.4, -1.0, 1.0)
    bulk, scalar = values[:HOST_VALUES], values[HOST_VALUES:].tolist()
    exact = np.quantile(values, QS, method="lower")
    out, sketches = {}, {}
    for tier in ("native", "device"):
        if tier == "device":
            os.environ[native.NATIVE_ENV] = "0"
        native.reset()
        try:
            status = native.status()
            if tier == "native":
                require(status["tier"] == "native",
                        f"the native library did not build or load: {status['reason']}")
            sk = DDSketch(ALPHA, backend="torch", device=device)
            require(sk.flush_tier == tier, f"flush tier {sk.flush_tier}, expected {tier}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sk.add_many(bulk)
            torch.cuda.synchronize()
            t_many = time.perf_counter() - t0
            t0 = time.perf_counter()
            for x in scalar:
                sk.add(x)
            require(sk.count == n_all, "count after the scalar adds")  # flushes
            torch.cuda.synchronize()
            t_scalar = time.perf_counter() - t0
            t0 = time.perf_counter()
            sk._settle()
            torch.cuda.synchronize()
            t_settle = time.perf_counter() - t0
            got = [sk.get_quantile_value(q) for q in QS]
        finally:
            os.environ.pop(native.NATIVE_ENV, None)
            native.reset()
        bad = [q for q, g, e in zip(QS, got, exact) if not _quantile_ok(g, e)]
        require(not bad, f"{tier} tier: quantiles {bad} outside alpha of the exact ones")
        require(sk.device == sk._state.device == device, "the sketch is not on the card")
        sketches[tier] = sk
        out[tier] = {
            "status": status, "add_many_s": t_many, "add_many_values_per_s": HOST_VALUES / t_many,
            "scalar_add_s": t_scalar, "scalar_values_per_s": HOST_SCALAR / t_scalar,
            "settle_s": t_settle, "quantiles": got,
            "max_rel_err_vs_exact": max(abs(g - e) / abs(e) for g, e in zip(got, exact)),
            "key_offset": int(sk._state.key_offset[0]),
        }
    a, b = sketches["native"], sketches["device"]
    for f in ("count", "sum", "zero_count"):
        require(getattr(a, f) == getattr(b, f), f"the tiers' {f} differ")
    require((a._min, a._max) == (b._min, b._max), "the tiers' min/max differ")
    # The native tier keys with the f64 scalar path, the device tier with
    # the f32 array path: a value at a bucket edge may land one bucket
    # apart, so the answers agree within one bucket (a factor gamma).
    gamma = (1 + ALPHA) / (1 - ALPHA)
    diff = max(abs(x - y) / abs(y) for x, y in zip(out["native"]["quantiles"],
                                                    out["device"]["quantiles"]))
    require(diff <= gamma - 1 + 1e-6, f"the tiers' quantiles differ by {diff}")
    out["tiers_max_rel_diff"] = diff
    out["tiers_equal_quantiles"] = sum(
        x == y for x, y in zip(out["native"]["quantiles"], out["device"]["quantiles"]))

    # A pure-Python sketch merged into the native-tier sketch.
    from sketches_tpu_torch import DDSketch as PySketch

    extra = r.lognormal(0.0, 2.0, HOST_MERGED) * np.where(r.rand(HOST_MERGED) < 0.4, -1.0, 1.0)
    py = PySketch(ALPHA)
    for x in extra.tolist():
        py.add(x)
    count0, sum0 = a.count, a.sum
    t0 = time.perf_counter()
    a.merge(py)
    torch.cuda.synchronize()
    t_merge = time.perf_counter() - t0
    require(a.count == count0 + py.count == n_all + HOST_MERGED, "merged count")
    require(a.sum == sum0 + py.sum, "merged sum")
    union = np.quantile(np.concatenate([values, extra]), QS, method="lower")
    merged = [a.get_quantile_value(q) for q in QS]
    bad = [q for q, g, e in zip(QS, merged, union) if not _quantile_ok(g, e)]
    require(not bad, f"merged quantiles {bad} outside alpha")
    out["merge"] = {"values": HOST_MERGED, "s": t_merge, "quantiles": merged,
                    "max_rel_err_vs_exact": max(abs(g - e) / abs(e)
                                                for g, e in zip(merged, union))}
    out["exact"] = exact.tolist()
    emit("host_tier", values=n_all, **out)
    return out


def _leaves_equal(a, b, leaves) -> list:
    """The leaves of ``leaves`` on which two states differ."""
    import torch

    return [f for f in leaves if not torch.equal(getattr(a, f), getattr(b, f))]


def _mass(st):
    return st.bins_pos.double().sum(-1) + st.bins_neg.double().sum(-1) + st.zero_count.double()


def _copy_times(device, st, leaves) -> tuple:
    """Seconds of one device-to-host copy of ``leaves`` and of the
    host-to-device copy back (pageable host memory, as the codec's)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = [getattr(st, f).cpu() for f in leaves]
    d2h = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = [h.to(device) for h in host]
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t0
    del host, back
    return d2h, h2d


def _same_answers(a, b) -> bool:
    import torch

    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        a.nan_to_num(), b.nan_to_num())


def phase_wire(device, facades: dict) -> dict:
    """``pb.wire`` on the first 262,144 streams of the main paths' final
    states (512 bins), then an exact round trip of a third 262,144 x 512
    state built on a pinned window."""
    import os

    import torch

    from sketches_tpu_torch import BatchedDDSketch, batched, kernels, native
    from sketches_tpu_torch.pb import wire

    require(native.status()["wire"] == "native",
            f"the native wire scanner is not loaded: {native.status()['reason']}")
    out = {}
    kernels.reset_launch_counts()
    for name, sk in facades.items():
        spec, st = sk.spec, sk.state.map(lambda x: x[:WIRE_STREAMS])
        d2h, _ = _copy_times(device, st, ("bins_pos", "bins_neg", "zero_count", "key_offset"))
        t0 = time.perf_counter()
        blobs = wire.state_to_bytes(spec, st)
        t_enc = time.perf_counter() - t0
        n_bytes = sum(map(len, blobs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = wire.bytes_to_state(spec, blobs, device=device)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        _, h2d = _copy_times(device, back, batched.LEAVES)
        # Streams are centred on their own windows and decode onto the
        # spec's: edge mass may fold into the edge bins, never vanish.
        require(torch.equal(_mass(back), _mass(st)), f"{name}: decode lost mass")
        require(torch.equal(back.count, st.count), f"{name}: decoded counts differ")
        row = {
            "blobs": len(blobs), "bytes": n_bytes, "encode_s": t_enc, "decode_s": t_dec,
            "encode_MBps": n_bytes / t_enc / 1e6, "decode_MBps": n_bytes / t_dec / 1e6,
            "d2h_s": d2h, "d2h_share_of_encode": d2h / t_enc,
            "h2d_s": h2d, "h2d_share_of_decode": h2d / t_dec,
            "collapsed_on_decode": float((back.collapsed_low + back.collapsed_high).sum()),
        }
        if name == "mixed_sign":
            part = blobs[:WIRE_DRIVER_SLICE]
            t0 = time.perf_counter()
            nat = wire.bytes_to_state(spec, part, device=device)
            torch.cuda.synchronize()
            t_nat = time.perf_counter() - t0
            os.environ[native.NATIVE_ENV] = "0"  # the pure-Python walker
            native.reset()
            try:
                require(native.wire_scanner() is None, "the kill switch left the scanner on")
                t0 = time.perf_counter()
                py = wire.bytes_to_state(spec, part, device=device)
                torch.cuda.synchronize()
                t_py = time.perf_counter() - t0
            finally:
                os.environ.pop(native.NATIVE_ENV, None)
                native.reset()
            diff = _leaves_equal(nat, py, batched.LEAVES)
            require(not diff, f"native and Python decodes differ on {diff}")
            idx = np.sort(np.random.RandomState(SEED + 9).choice(
                st.n_streams, WIRE_HOST_SAMPLE, replace=False))
            sel = torch.from_numpy(idx).to(device)
            sub = st.map(lambda x: x[sel])
            via_host = batched.from_host_sketches(
                spec, batched.to_host_sketches(spec, sub), device)
            via_wire = wire.bytes_to_state(spec, [blobs[i] for i in idx.tolist()], device=device)
            diff = _leaves_equal(via_host, via_wire, WIRE_LEAVES)
            require(not diff, f"decode differs from the host-sketch path on {diff}")
            # The host sketches carry the source's collapse counters; the
            # wire does not.
            for f in ("collapsed_low", "collapsed_high"):
                require(torch.equal(getattr(via_host, f), getattr(via_wire, f) + getattr(sub, f)),
                        f"{f} differs from the host-sketch path")
            row.update(driver_slice=WIRE_DRIVER_SLICE, driver_native_s=t_nat,
                       driver_python_s=t_py, host_sketch_sample=WIRE_HOST_SAMPLE)
        out[name] = row
        del blobs, back
    torch.cuda.empty_cache()

    # A third state on one pinned window: an exact round trip.
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    pinned = BatchedDDSketch(n_streams=WIRE_STREAMS, relative_accuracy=ALPHA, n_bins=N_BINS,
                             key_offset=-(N_BINS // 2), device=device)
    for _ in range(N_BATCHES):
        pinned.add(torch.empty((WIRE_STREAMS, BATCH), device=device).log_normal_(
            0.0, 2.0, generator=gen))
    spec, st = pinned.spec, pinned.state
    t0 = time.perf_counter()
    blobs = wire.state_to_bytes(spec, st)
    t_enc = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = wire.bytes_to_state(spec, blobs, device=device)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    again = wire.state_to_bytes(spec, back)
    require(again == blobs, "encode -> decode -> encode changed the bytes")
    n_bytes = sum(map(len, blobs))
    del again, blobs
    diff = _leaves_equal(back, st, WIRE_LEAVES)
    require(not diff, f"the pinned round trip changed {diff}")
    dec = BatchedDDSketch(WIRE_STREAMS, spec=spec, state=back, device=device)
    tier_a, a = pinned.get_quantile_values_resolved(QS)
    tier_b, b = dec.get_quantile_values_resolved(QS)
    require(tier_a == tier_b == "overlap", f"pinned default routes {tier_a}, {tier_b}")
    require(_same_answers(a, b), "the decoded facade answers differently (default route)")
    tier_a, a = pinned.get_quantile_values_resolved(QS, disabled_tiers=("overlap",))
    tier_b, b = dec.get_quantile_values_resolved(QS, disabled_tiers=("overlap",))
    require(tier_a == tier_b and tier_a in ("windowed", "tiles"),
            f"pinned ladder routes {tier_a}, {tier_b}")
    require(_same_answers(a, b), f"the decoded facade answers differently ({tier_a})")
    require(bool(torch.isfinite(a).all()), "pinned answers are not finite")
    out["pinned"] = {"blobs": WIRE_STREAMS, "bytes": n_bytes, "encode_s": t_enc, "decode_s": t_dec,
                     "encode_MBps": n_bytes / t_enc / 1e6, "decode_MBps": n_bytes / t_dec / 1e6,
                     "ladder_tier": tier_a, "key_offset": spec.key_offset}
    del back, dec
    out["launches"] = launch_counts()
    emit("wire", **out)
    out["pinned_facade"] = pinned
    return out


def _flip_inside(path: Path) -> None:
    """Flip one bit in the middle of the largest member's compressed bytes."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        info = max(z.infolist(), key=lambda i: i.compress_size)
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = np.frombuffer(f.read(4), "<u2")
        pos = info.header_offset + 30 + int(name_len) + int(extra_len) + info.compress_size // 2
        f.seek(pos)
        byte = f.read(1)[0]
        f.seek(pos)
        f.write(bytes([byte ^ 0x10]))


def _time_writers(pinned) -> list:
    """Seconds and bytes of the port's npz writer (``checkpoint._npz_bytes``,
    zlib level 1) and of ``np.savez_compressed`` (level 6, the JAX
    package's writer) on the same host arrays of ``pinned``, in memory, in
    turns a, b, a."""
    import io

    import numpy as np

    from sketches_tpu_torch import checkpoint

    arrays = checkpoint._state_arrays(pinned.spec, pinned.state)

    def numpy_writer():
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        return buf.getbuffer().nbytes

    turns = []
    for name, write in (("port_level1", lambda: len(checkpoint._npz_bytes(arrays))),
                        ("savez_compressed_level6", numpy_writer),
                        ("port_level1", lambda: len(checkpoint._npz_bytes(arrays)))):
        t0 = time.perf_counter()
        n = write()
        turns.append({"writer": name, "s": time.perf_counter() - t0, "bytes": n})
    return turns


def phase_checkpoint(device, pinned, writers=False) -> dict:
    """``checkpoint`` on the pinned 262,144 x 512 facade and on the partials
    of a two-shard distributed facade of 262,144 streams (four batches of
    positive traffic), through a directory under ``build/``; with
    ``writers``, also the two npz writers timed on the pinned state."""
    import tempfile

    import torch

    from sketches_tpu_torch import batched, checkpoint, kernels
    from sketches_tpu_torch.parallel import DistributedDDSketch, SketchMesh
    from sketches_tpu_torch.resilience import CheckpointCorrupt

    out = {}
    kernels.reset_launch_counts()
    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    dist = DistributedDDSketch(WIRE_STREAMS, mesh=SketchMesh(devices=[device, device]),
                               relative_accuracy=ALPHA, n_bins=N_BINS)
    for _ in range(N_BATCHES):
        dist.add(torch.empty((WIRE_STREAMS, BATCH), device=device).log_normal_(
            0.0, 2.0, generator=gen))
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = Path(tmp) / "pinned.npz"
        d2h, h2d = _copy_times(device, pinned.state, batched.LEAVES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(str(path), pinned)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = checkpoint.restore(str(path), device=device)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        require(back.device == device and back.engine == pinned.engine == "kernel",
                "restored off the card or off the kernel path")
        diff = _leaves_equal(back.state, pinned.state, batched.LEAVES)
        require(not diff, f"the restored state differs on {diff}")
        tier_a, a = pinned.get_quantile_values_resolved(QS)
        tier_b, b = back.get_quantile_values_resolved(QS)
        require(tier_a == tier_b == "overlap" and _same_answers(a, b),
                "the restored facade answers differently")
        out["pinned"] = {"save_s": t_save, "restore_s": t_restore,
                         "file_bytes": path.stat().st_size, "d2h_s": d2h,
                         "d2h_share_of_save": d2h / t_save, "h2d_s": h2d,
                         "h2d_share_of_restore": h2d / t_restore}
        del back
        path.unlink()
        if writers:
            out["writers"] = _time_writers(pinned)

        floor = ("windowed", "wxla")
        tier, before = dist.get_quantile_values_resolved(QS, disabled_tiers=floor)
        require(tier == "xla", f"distributed floor resolved {tier}")
        dpath = Path(tmp) / "partials.npz"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(str(dpath), dist, partials=True)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = checkpoint.restore_distributed(str(dpath), mesh=SketchMesh(devices=[device, device]))
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        ref = dist.merged_state()
        diff = _leaves_equal(again.merged_state(), ref, batched.LEAVES)
        require(not diff, f"the restored fold differs on {diff}")
        tier, after = again.get_quantile_values_resolved(QS, disabled_tiers=floor)
        require(tier == "xla" and _same_answers(after, before),
                "the restored distributed facade answers differently on the xla floor")
        out["partials"] = {"save_s": t_save, "restore_s": t_restore,
                           "file_bytes": dpath.stat().st_size,
                           "shards": int(dist.n_value_shards)}
        del again
        dpath.unlink()

        # One flipped bit inside a member's compressed bytes is refused.
        small = Path(tmp) / "small.npz"
        sub = batched.BatchedDDSketch(
            WIRE_HOST_SAMPLE, spec=pinned.spec, device=device,
            state=pinned.state.map(lambda x: x[:WIRE_HOST_SAMPLE].clone()))
        checkpoint.save(str(small), sub)
        _flip_inside(small)
        try:
            checkpoint.restore(str(small), device=device)
        except CheckpointCorrupt as e:
            out["corrupt_refused"] = str(e)[:200]
        else:
            raise SmokeFailure("a checkpoint with a flipped bit restored")
    out["launches"] = launch_counts()
    emit("checkpoint", **out)
    return out


# The backends phase: a fixed quarter of the streams (chosen from the seed)
# draws lognormal(0, 6), the rest lognormal(0, 2); the moment solve runs on
# the sampled streams.  The moment envelope is the JAX package's
# (tests/test_backends.py::TestMoment::test_error_envelope_on_datasets): 5%
# relative error below q = 0.95, 15% from it, on a large-sample stream.
HEAVY_SIGMA = 6.0
MOMENT_QS = (0.1, 0.25, 0.5, 0.75, 0.9, 0.99)
MOMENT_MID_TOL, MOMENT_TAIL_TOL = 0.05, 0.15
MOMENT_RESTORE_CHECK = 512


def _event_pair_ms(pairs) -> float:
    """Total ms of recorded (start, end) CUDA event pairs (synchronizes)."""
    import torch

    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs)


def _record(fn, pairs):
    """``fn`` wrapped to record a CUDA event pair around each call."""
    import torch

    def run(*args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kwargs)
        b.record()
        pairs.append((a, b))
        return out

    return run


def _heavy_traffic(device, n, seed, light_sigma=2.0):
    """(per-stream sigma [n], heavy mask [n], generator): a fixed quarter of
    the streams draws lognormal(0, 6), the rest lognormal(0, light_sigma)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    heavy = torch.zeros(n, dtype=torch.bool, device=device)
    heavy[torch.randperm(n, device=device, generator=gen)[: n // 4]] = True
    sigma = torch.where(heavy, HEAVY_SIGMA, light_sigma)
    return sigma, heavy, gen


def _lognormal_rows(sigma, gen):
    import torch

    z = torch.randn((sigma.shape[0], BATCH), device=sigma.device, generator=gen)
    return torch.exp(z * sigma[:, None])


def _adaptive_alpha_check(spec, levels, koff, clamped_low, clamped_high, kept, est, qs):
    """Sampled answers against exact lower quantiles: within
    ``effective_alpha(level) * |x|`` plus the f32 error of the corrected
    decode (its exponent argument ~ ln|x| rounds once or twice: (2 + 2 |ln x|)
    ulp), for values whose level bucket lies inside the stream's window.

    Mass that clamped at a window edge stays at that edge key when a later
    collapse or recentre brings the key inside the window (the backend's
    counted failure mode, as in the JAX package): ``collapsed_high`` values
    sit below their true keys and ``collapsed_low`` values above theirs.  So
    the answer at order statistic ``i`` lies between the exact order
    statistics ``i - collapsed_high`` and ``i + collapsed_low``, each with
    the bound above: for a stream with no clamped mass, the exact quantile.
    Returns (checked, outside the window, streams with clamped mass,
    answers off the exact quantile's bound but inside that bracket, largest
    error / bound at the exact quantile)."""
    import torch

    from sketches_tpu_torch.backends import uniform

    srt = torch.sort(kept.double(), dim=1).values
    n = srt.shape[1]
    q = torch.tensor(qs, dtype=torch.float64, device=kept.device)
    idx = torch.floor(q * (n - 1)).long()[None, :].expand(srt.shape[0], -1)
    exact = srt.gather(1, idx)
    lvl = levels.to(torch.int32)
    k0 = spec.mapping.key_array(exact.float().abs())
    m = torch.bitwise_left_shift(torch.ones_like(lvl), lvl)[:, None]
    k_level = -((-k0) // m)
    inside = (k_level >= koff[:, None]) & (k_level <= koff[:, None] + spec.n_bins - 1)
    alpha = uniform.effective_alpha(spec, lvl).double()[:, None]
    eps = float(np.finfo(np.float32).eps)
    est = est.double()

    def slack(x):
        return (alpha + eps * (2 + 2 * x.abs().log().abs())) * x.abs()

    ratio = (est - exact).abs() / slack(exact)
    lo = srt.gather(1, (idx - clamped_high.long()[:, None]).clamp(0, n - 1))
    hi = srt.gather(1, (idx + clamped_low.long()[:, None]).clamp(0, n - 1))
    ok = (est >= lo - slack(lo)) & (est <= hi + slack(hi))
    bad = inside & ~ok
    require(not bool(bad.any()), f"adaptive: {int(bad.sum())} sampled answers outside"
                                 " effective_alpha")
    clamped = (clamped_low + clamped_high) > 0
    return (int(inside.sum()), int((~inside).sum()), int(clamped.sum()),
            int((inside & (ratio > 1)).sum()), float(ratio[inside & (ratio <= 1)].max()))


def _moment_close(card, cpu, scales, what) -> float:
    """A card moment leaf against the CPU's: NaN positions equal; an
    infinity on one side only where the other side's finite sum is within a
    factor 2 of f32's largest (the overflow edge, which two summation
    orders may straddle); elsewhere within 1e-5 of the f64 sum of the
    terms' magnitudes (``scales``; ``None`` = exact).  Returns the largest
    relative error."""
    import torch

    a, b = card.cpu().double(), cpu.double()
    require(torch.equal(torch.isnan(a), torch.isnan(b)), f"moment {what}: NaN positions")
    inf = torch.isinf(a) | torch.isinf(b)
    both = torch.isinf(a) & torch.isinf(b)
    require(torch.equal(a[both], b[both]), f"moment {what}: infinities differ")
    edge = float(2.0 ** 127)
    one = inf & ~both
    require(bool((torch.where(torch.isinf(a), b, a)[one].abs() >= edge).all()),
            f"moment {what}: an infinity away from the overflow edge")
    ok = ~torch.isnan(a) & ~inf
    d = (a - b).abs()[ok]
    if scales is None:
        require(bool((d == 0).all()), f"moment {what} differs from the CPU's")
        return 0.0
    s = scales[ok]
    require(bool((d <= 1e-5 * s).all()), f"moment {what}: above 1e-5 * sum |term|")
    return float((d / s.clamp(min=1e-300)).max()) if d.numel() else 0.0


def _moment_scales(kept, k):
    """f64 sums over each row of |v|**j and |ln v|**j, j = 1..k (positive
    unit-weight values), and of |v|: the moment leaves' error scales."""
    import torch

    a = kept.double().abs()
    la = a.log().abs()
    p = torch.stack([(a ** j).sum(-1) for j in range(1, k + 1)], -1)
    lp = torch.stack([(la ** j).sum(-1) for j in range(1, k + 1)], -1)
    return p, lp, a.sum(-1)


def phase_backends(device) -> dict:
    """The accuracy backends on the card.

    * ``AdaptiveDDSketch(1 << 20, relative_accuracy=0.01, n_bins=512)`` and
      its ``engine="plain"`` twin take four ``[2**20, 256]`` batches (a fixed
      quarter of the streams lognormal(0, 6), the rest lognormal(0, 2)):
      state bit for bit equal, levels, counts, effective alpha on 4096
      sampled streams, K1 on ``add`` and K5 on the default route; ``add``
      and its guard-plus-collapse share, and the query on the default,
      ``windowed`` and ``xla`` routes, timed.  Then the heavy facade merges
      into a fresh one holding one lognormal(0, 2) batch.
    * ``MomentDDSketch(1 << 20, n_moments=12)`` takes the same batches: 120
      bytes a stream, the card's state against the CPU's on the sampled
      streams, the host solve on them, the envelope on their pooled fold.
    * At 262,144 streams: the ``SketchPayload`` envelope and checkpoints of
      a pinned adaptive facade (a quarter lognormal(0, 6), the rest
      lognormal(0, 1)) and of the moment state's first 262,144 streams.
    """
    import tempfile

    import torch

    from sketches_tpu_torch import batched, checkpoint, kernels
    from sketches_tpu_torch.backends import moment, uniform, wirefmt

    out = {}
    sigma, heavy, gen = _heavy_traffic(device, N_STREAMS, SEED + 61)
    ad = uniform.AdaptiveDDSketch(n_streams=N_STREAMS, relative_accuracy=ALPHA, n_bins=N_BINS)
    twin = uniform.AdaptiveDDSketch(n_streams=N_STREAMS, relative_accuracy=ALPHA,
                                    n_bins=N_BINS, engine="plain")
    mom = moment.MomentDDSketch(N_STREAMS, n_moments=12)
    require(ad.engine == "kernel" and twin.engine == "plain" and ad.device.type == "cuda"
            and mom.device.type == "cuda", "backend facades are not on the card")
    require(mom.bytes_per_stream() == 120, f"moment bytes a stream {mom.bytes_per_stream()}")
    nbytes = sum(getattr(mom.state, f).nbytes for f in moment.FIELDS)
    require(nbytes == 120 * N_STREAMS, f"moment state holds {nbytes} bytes")
    sample = torch.randperm(N_STREAMS, device=device, generator=gen)[:N_SAMPLED]
    kept = []
    guard, adds, mom_adds, stats, collapses = [], [], [], [], []
    ad._preguard = _record(ad._preguard, guard)
    ad._maybe_collapse = _record(ad._maybe_collapse, guard)
    # Inside the guard: its fused statistics passes and the collapses.
    ad._guard_stats = _record(ad._guard_stats, stats)
    ad._apply_collapse = _record(ad._apply_collapse, collapses)
    timed_add = _record(ad.add, adds)
    timed_mom_add = _record(mom.add, mom_adds)
    cpu_mom = moment.init(mom.spec, N_SAMPLED, "cpu")
    kernels.reset_launch_counts()
    per_batch_guard, abs_sum = [], torch.zeros(N_STREAMS, dtype=torch.float64, device=device)
    guard_parts = []
    for _ in range(N_BATCHES):
        v = _lognormal_rows(sigma, gen)
        kept.append(v[sample])
        abs_sum += v.abs().sum(-1, dtype=torch.float64)
        marks = (len(guard), len(stats), len(collapses))
        timed_add(v)
        per_batch_guard.append(_event_pair_ms(guard[marks[0]:]))
        guard_parts.append({"stats_passes": len(stats) - marks[1],
                            "stats_ms": _event_pair_ms(stats[marks[1]:]),
                            "collapses": len(collapses) - marks[2],
                            "collapse_ms": _event_pair_ms(collapses[marks[2]:])})
        twin.add(v)
        timed_mom_add(v)
        cpu_mom = moment.add(mom.spec, cpu_mom, kept[-1].cpu())
        del v
    ingest_launches = kernels.ingest_histogram.launches
    tier, got = ad.get_quantile_values_resolved(QS)
    torch.cuda.synchronize()
    launches = launch_counts()
    require(ingest_launches > 0, "add launched no ingest kernel")
    require(tier == "overlap" and launches["fused_quantile_tiles_overlap"] == 1,
            f"the adaptive default route resolved {tier!r} without one overlap launch")
    win_tier, win = ad.get_quantile_values_resolved(QS, disabled_tiers=("overlap",))
    xla_off = ("overlap", "tiles", "windowed", "wxla")
    xla_tier, xla = ad.get_quantile_values_resolved(QS, disabled_tiers=xla_off)
    torch.cuda.synchronize()
    launches = launch_counts()  # the main path's, before any timing
    require(win_tier == "windowed" and launches["fused_quantile_windowed"] == 1,
            f"without overlap the adaptive facade resolved {win_tier!r}")
    require(xla_tier == "xla", f"the floor resolved {xla_tier!r}")
    require(_same_answers(got, win) and _same_answers(got, xla),
            "the adaptive routes answer differently")

    # State and levels against the plain twin, counts, levels.
    require(torch.equal(ad.level, twin.level), "levels differ from the plain facade")
    for f in batched.LEAVES:
        a, b = getattr(ad.state.base, f), getattr(twin.state.base, f)
        if f == "sum":
            require(bool(((a - b).abs() <= 1e-5 * abs_sum).all()), "sum differs from the plain"
                                                                     " facade")
        else:
            require(torch.equal(a, b), f"leaf {f} differs from the plain facade")
    level = ad.level
    require(int(level.max()) <= ad.spec.max_collapses, "a level beyond max_collapses")
    require(bool((level[heavy] >= 1).all()), "a heavy stream did not collapse")
    require(bool((ad.count == N_BATCHES * BATCH).all()), "count differs from the values")
    twin_tier, twin_vals = twin.get_quantile_values_resolved(QS)
    require(_same_answers(got, twin_vals), "the plain facade answers differently")
    base = ad.state.base
    checked, outside, clamped_streams, shifted, ratio = _adaptive_alpha_check(
        ad.spec, level[sample], base.key_offset[sample], base.collapsed_low[sample],
        base.collapsed_high[sample], torch.cat(kept, 1), got[sample], QS)
    require(bool(torch.isfinite(got).all()) and got.shape == (N_STREAMS, len(QS)),
            "adaptive answers are not finite [N, Q]")
    collapses = {int(k): int(c) for k, c in enumerate(torch.bincount(level.cpu()))}
    heavy_levels = {int(k): int(c) for k, c in enumerate(torch.bincount(level[heavy].cpu()))}
    add_ms = [a.elapsed_time(b) for a, b in adds]
    out["adaptive"] = {
        "tier": tier, "ladder_tier": win_tier, "floor_tier": xla_tier, "plain_tier": twin_tier,
        "levels": collapses, "heavy_levels": heavy_levels, "launches": launches,
        "add_ms_per_batch": add_ms, "guard_ms_per_batch": per_batch_guard,
        "guard_parts_per_batch": guard_parts,
        "steady_add_ms": statistics.median(add_ms[1:]),
        "steady_guard_share": statistics.median(
            g / a for g, a in zip(per_batch_guard[1:], add_ms[1:])),
        "alpha_checked": checked, "alpha_outside_window": outside,
        "alpha_streams_with_clamped_mass": clamped_streams,
        "alpha_inside_clamp_bracket_only": shifted, "alpha_max_err_over_bound": ratio,
        "collapsed_fraction_max": float(ad.collapsed_fraction().max()),
        "query_ms": event_ms(lambda: ad.get_quantile_values(QS)),
        "windowed_query_ms": event_ms(
            lambda: ad.get_quantile_values_resolved(QS, disabled_tiers=("overlap",))),
        "xla_query_ms": event_ms(lambda: ad.get_quantile_values_resolved(
            QS, disabled_tiers=xla_off)),
        "plain_query_ms": event_ms(lambda: twin.get_quantile_values(QS)),
    }
    del twin, twin_vals, win, xla
    torch.cuda.empty_cache()

    # Merge the heavy facade into a fresh one holding lognormal(0, 2).
    fresh = uniform.AdaptiveDDSketch(n_streams=N_STREAMS, relative_accuracy=ALPHA,
                                     n_bins=N_BINS)
    fresh.add(_lognormal_rows(torch.full_like(sigma, 2.0), gen))
    spec = ad.spec
    pair_max = torch.maximum(fresh.level, ad.level)
    a2 = uniform.collapse_to(spec, fresh.state, pair_max)
    b2 = uniform.collapse_to(spec, ad.state, pair_max)
    lo, hi, occ = uniform._union_span(spec, a2.base, b2.base)
    wider = occ & (hi - lo + 1 > spec.n_bins) & (pair_max < spec.max_collapses)
    del a2, b2
    count0 = fresh.count + ad.count
    fresh_levels = {int(k): int(c) for k, c in enumerate(torch.bincount(fresh.level.cpu()))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.merge(ad)
    torch.cuda.synchronize()
    t_merge = time.perf_counter() - t0
    require(torch.equal(fresh.count, count0), "merge did not conserve count")
    require(torch.equal(fresh.level[~wider], pair_max[~wider]),
            "merged levels differ from the pairwise max")
    require(bool((fresh.level[wider] > pair_max[wider]).all()),
            "a merged union wider than the window did not collapse further")
    out["merge"] = {"s": t_merge, "fresh_levels": fresh_levels,
                    "streams_collapsed_past_pairwise_max": int(wider.sum())}
    del fresh
    torch.cuda.empty_cache()

    # Moment: the card against the CPU on the sampled streams, the host
    # solve, the envelope on the pooled fold of the sampled streams.
    kept_all = torch.cat(kept, 1)
    sub = mom.state.map(lambda x: x[sample])
    p_scale, lp_scale, v_scale = (x.cpu() for x in _moment_scales(kept_all, 12))
    errs = {}
    for f in moment.FIELDS:
        scale = {"powers": p_scale, "log_powers": lp_scale, "sum": v_scale}.get(f)
        errs[f] = _moment_close(getattr(sub, f), getattr(cpu_mom, f), scale, f)
    t0 = time.perf_counter()
    answers = moment.quantile(mom.spec, sub, MOMENT_QS)
    t_solve = time.perf_counter() - t0
    require(np.isfinite(answers).all(), "moment answers are not finite")
    host_vals = kept_all.double().cpu().numpy()
    exact = np.quantile(host_vals, MOMENT_QS, axis=1, method="lower").T
    rel = np.abs(answers - exact) / np.abs(exact)
    heavy_s = heavy[sample].cpu().numpy()
    pooled = {}
    for name, rows in (("light", ~heavy_s), ("heavy", heavy_s)):
        idx = torch.from_numpy(np.nonzero(rows)[0]).to(device)
        part = sub.map(lambda x: x[idx])
        fold = moment.merge_axis(mom.spec, part.map(lambda x: x[:, None]), axis=0)
        est = moment.quantile(mom.spec, fold, MOMENT_QS)[0]
        want = np.quantile(host_vals[rows].ravel(), MOMENT_QS, method="lower")
        prel = np.abs(est - want) / np.abs(want)
        tol = np.where(np.asarray(MOMENT_QS) >= 0.95, MOMENT_TAIL_TOL, MOMENT_MID_TOL)
        require(bool((prel <= tol).all()), f"moment {name} fold outside the envelope: {prel}")
        pooled[name] = {"streams": int(rows.sum()), "rel_err": prel.tolist()}
    mom_ms = [a.elapsed_time(b) for a, b in mom_adds]
    out["moment"] = {
        "bytes_per_stream": mom.bytes_per_stream(), "add_ms_per_batch": mom_ms,
        "steady_add_ms": statistics.median(mom_ms[1:]),
        "solve_s": t_solve, "solve_streams": N_SAMPLED,
        "solve_ms_per_stream": t_solve / N_SAMPLED * 1e3,
        "card_vs_cpu_max_rel": errs, "pooled_envelope": pooled,
        "per_stream_rel_err_median": np.median(rel, 0).tolist(),
        "per_stream_rel_err_max": rel.max(0).tolist(),
    }
    del sub, kept, kept_all, host_vals, ad
    torch.cuda.empty_cache()

    # The envelope and checkpoints at 262,144 streams.
    kernels.reset_launch_counts()
    n = WIRE_STREAMS
    sig2, heavy2, gen2 = _heavy_traffic(device, n, SEED + 67, light_sigma=1.0)
    pinned = uniform.AdaptiveDDSketch(n_streams=n, relative_accuracy=ALPHA, n_bins=N_BINS,
                                      key_offset=-(N_BINS // 2))
    for _ in range(N_BATCHES):
        pinned.add(_lognormal_rows(sig2, gen2))
    base = pinned.state.base
    occ_lo = base.key_offset + base.occ_lo
    occ_hi = base.key_offset + base.occ_hi
    spec = pinned.spec
    require(bool(((occ_lo >= spec.key_offset) & (occ_hi <= spec.key_offset + N_BINS - 1)).all()),
            "the pinned adaptive state holds mass outside the spec's window: its decode"
            " would fold it")
    require(bool((pinned.level[heavy2] >= 1).all()), "a heavy pinned stream did not collapse")
    env = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blobs = wirefmt.payload_to_bytes(spec, pinned.state)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = wirefmt.payload_from_bytes(spec, blobs, device=device)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    require(wirefmt.payload_to_bytes(spec, back) == blobs,
            "adaptive envelope: encode -> decode -> encode changed the bytes")
    dec = uniform.AdaptiveDDSketch(n, spec=spec, state=back)
    tier_a, a = pinned.get_quantile_values_resolved(QS)
    tier_b, b = dec.get_quantile_values_resolved(QS)
    require(_same_answers(a, b), "the decoded adaptive state answers differently")
    env["adaptive"] = {"blobs": n, "bytes": sum(map(len, blobs)), "encode_s": t_enc,
                       "decode_s": t_dec, "tiers": [tier_a, tier_b],
                       "levels": {int(k): int(c) for k, c in
                                  enumerate(torch.bincount(pinned.level.cpu()))}}
    del blobs, back, dec
    mspec = mom.spec
    mstate = mom.state.map(lambda x: x[:n].clone())
    del mom
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    blobs = wirefmt.payload_to_bytes(mspec, mstate)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = wirefmt.payload_from_bytes(mspec, blobs, device=device)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    diff = [f for f in moment.FIELDS if not torch.equal(getattr(back, f), getattr(mstate, f))]
    require(not diff, f"moment envelope round trip changed {diff}")
    require(wirefmt.payload_to_bytes(mspec, back) == blobs,
            "moment envelope: encode -> decode -> encode changed the bytes")
    env["moment"] = {"blobs": n, "bytes": sum(map(len, blobs)), "encode_s": t_enc,
                     "decode_s": t_dec}
    del blobs, back
    out["envelope"] = env

    ck = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mfacade = moment.MomentDDSketch(n, spec=mspec, state=mstate)
        for name, facade in (("adaptive", pinned), ("moment", mfacade)):
            path = Path(tmp) / f"{name}.npz"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save(str(path), facade)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            restored = checkpoint.restore(str(path), device=device)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            require(type(restored) is type(facade) and restored.spec == facade.spec,
                    f"{name}: restored as {type(restored).__name__}")
            if name == "adaptive":
                require(torch.equal(restored.level, facade.level), "restored levels differ")
                diff = _leaves_equal(restored.state.base, facade.state.base, batched.LEAVES)
                tier_a, a = facade.get_quantile_values_resolved(QS)
                tier_b, b = restored.get_quantile_values_resolved(QS)
                require(tier_a == tier_b and _same_answers(a, b),
                        "the restored adaptive facade answers differently")
            else:
                diff = [f for f in moment.FIELDS
                        if not torch.equal(getattr(restored.state, f), getattr(facade.state, f))]
                head = slice(0, MOMENT_RESTORE_CHECK)
                a = moment.quantile(mspec, facade.state.map(lambda x: x[head]), MOMENT_QS)
                b = moment.quantile(mspec, restored.state.map(lambda x: x[head]), MOMENT_QS)
                require(np.array_equal(a, b), "the restored moment state answers differently")
            require(not diff, f"{name}: the restored state differs on {diff}")
            ck[name] = {"save_s": t_save, "restore_s": t_restore,
                        "file_bytes": path.stat().st_size}
            del restored
            path.unlink()
    out["checkpoint"] = ck
    at_262k = launch_counts()
    out["launches"] = {k: launches[k] + at_262k[k] for k in launches}
    emit("backends", **out)
    return out


# ---------------------------------------------------------------------------
# The robustness phase: the demotion ladder, the ingest demotion and the
# armed integrity layer (fault sites armed here and nowhere else).
# ---------------------------------------------------------------------------

# The ladder walk's tiers, in order, and what each query must resolve after
# the previous tier was armed to fail.
LADDER_WALK = (("overlap", "tiles"), ("tiles", "windowed"), ("windowed", "wxla"),
               ("wxla", "xla"))
# Per-call exclusions that resolve each tier on mixed traffic (the timing
# facade shares the walked facade's state, without its demotions).
TIER_EXCLUSIONS = {"overlap": (), "tiles": ("overlap",), "windowed": ("overlap", "tiles"),
                   "wxla": ("windowed",), "xla": ("windowed", "wxla")}
# The positive path's facade ``add`` and ``overlap`` query times recorded
# before the robustness layer existed, on the same card model (PERF.md,
# section 5): printed beside this run's as a record, not a gate.
BASELINE_ADD_MS = 11.257
BASELINE_OVERLAP_QUERY_MS = 15.222


def require_ledger(phase: str, expected=()) -> None:
    """The health ledger after a phase that armed nothing: exactly the
    ``(component, from, to, reason)`` events ``expected`` (the kill switch a
    phase turns on deliberately records one), else the phase fails with the
    ledger's text.  Clears the ledger for the next phase."""
    from sketches_tpu_torch import resilience

    got = resilience.health()["downgrades"]
    seen = [(e["component"], e["from_tier"], e["to_tier"], e["reason"]) for e in got]
    require(seen == list(expected), f"{phase}: the health ledger recorded {json.dumps(got)}")
    resilience.reset()


def native_kill_switch_events(n: int) -> list:
    """What ``SKETCHES_TPU_NATIVE=0`` records each time a phase turns it on."""
    return [("native", "native", "python", "disabled via SKETCHES_TPU_NATIVE=0")] * n


def expect_raise(exc, fn, what: str):
    """Run ``fn``; it must raise ``exc``, which is returned."""
    try:
        fn()
    except exc as e:
        return e
    raise SmokeFailure(f"{what}: no {exc.__name__} raised")


def _ledger_steps() -> list:
    from sketches_tpu_torch import resilience

    return [(e["component"], e["from_tier"], e["to_tier"])
            for e in resilience.health()["downgrades"]]


def _mixed_batch(gen, n, device):
    import torch

    v = torch.empty((n, BATCH), device=device).log_normal_(0.0, 2.0, generator=gen)
    return torch.where(torch.rand(v.shape, device=device, generator=gen) < 0.4, -v, v)


def _ladder_walk(device) -> dict:
    """``pallas.lowering`` armed once for each kernel tier in turn on the
    1M x 512 mixed-sign facade: each answer on the next tier equals the
    plain facade's bit for bit; then ``pallas.ingest`` once on a fifth
    batch, replayed on the plain path."""
    import torch

    from sketches_tpu_torch import BatchedDDSketch, batched, faults, kernels, resilience

    gen = torch.Generator(device=device).manual_seed(SEED + 91)
    sk = BatchedDDSketch(n_streams=N_STREAMS, relative_accuracy=ALPHA, n_bins=N_BINS,
                         device=device)
    ref = BatchedDDSketch(n_streams=N_STREAMS, relative_accuracy=ALPHA, n_bins=N_BINS,
                          engine="plain", device=device)
    abs_sum = torch.zeros(N_STREAMS, dtype=torch.float64, device=device)
    kernels.reset_launch_counts()
    for _ in range(N_BATCHES):
        v = _mixed_batch(gen, N_STREAMS, device)
        abs_sum += v.abs().sum(-1, dtype=torch.float64)
        sk.add(v)
        ref.add(v)
        del v
    want_tier, want = ref.get_quantile_values_resolved(QS)
    tier0, got0 = sk.get_quantile_values_resolved(QS)
    require(tier0 == "overlap", f"the walk starts on {tier0!r}, not 'overlap'")
    require(_same_answers(got0, want), "overlap differs from the plain facade")
    require_ledger("ladder walk (before arming)")
    walk = []
    for armed, nxt in LADDER_WALK:
        faults.arm(faults.PALLAS_LOWERING, tier=armed, times=1)
        tier, got = sk.get_quantile_values_resolved(QS)
        torch.cuda.synchronize()
        require(faults.stats()[faults.PALLAS_LOWERING][1] == 1,
                f"the armed {armed} fault did not fire")
        faults.disarm()
        require(tier == nxt, f"with {armed} failing the facade answered on {tier!r}, not {nxt!r}")
        require(_same_answers(got, want),
                f"the {tier} answer differs from the plain facade's ({want_tier})")
        walk.append(tier)
    steps = _ledger_steps()
    require(steps == [("batched.query", a, b) for a, b in LADDER_WALK],
            f"the ledger holds {steps}")
    require(sorted(sk._query_disabled) == ["overlap", "tiles", "windowed", "wxla"],
            f"persistent demotions {sorted(sk._query_disabled)}")
    launches = launch_counts()
    resilience.reset()

    # Each tier's query, timed on a facade sharing the walked state.
    twin = BatchedDDSketch(N_STREAMS, spec=sk.spec, state=sk.state, device=device)
    tier_ms = {}
    for tier, excl in TIER_EXCLUSIONS.items():
        got_tier, got = twin.get_quantile_values_resolved(QS, disabled_tiers=excl)
        require(got_tier == tier, f"timing: {excl} resolved {got_tier!r}, not {tier!r}")
        require(_same_answers(got, want), f"timing: {tier} differs from the plain facade")
        tier_ms[tier] = event_ms(lambda e=excl: twin.get_quantile_values_resolved(
            QS, disabled_tiers=e))
    del twin

    # The ingest demotion: one fault, the batch replayed on the plain path.
    v = _mixed_batch(gen, N_STREAMS, device)
    abs_sum += v.abs().sum(-1, dtype=torch.float64)
    before = kernels.ingest_histogram.launches
    faults.arm(faults.PALLAS_INGEST, times=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sk.add(v)
    torch.cuda.synchronize()
    demoted_add_ms = (time.perf_counter() - t0) * 1e3
    require(faults.stats()[faults.PALLAS_INGEST] == (1, 1), "the ingest fault did not fire once")
    faults.disarm()
    ref.add(v)
    del v
    require(kernels.ingest_histogram.launches == before,
            "the demoted batch launched the ingest kernel")
    require(_ledger_steps() == [("batched.ingest", "kernel", "plain")],
            f"the ledger holds {_ledger_steps()} after the ingest fault")
    require(not sk._kernel_ingest, "the facade kept the ingest kernel")
    for f in batched.LEAVES:
        a, b = getattr(sk.state, f), getattr(ref.state, f)
        if f == "sum":
            require(bool(((a - b).abs() <= 1e-5 * abs_sum).all()),
                    "sum after the ingest demotion differs from the plain twin")
        else:
            require(torch.equal(a, b), f"leaf {f} after the ingest demotion differs from the"
                                       " plain twin")
    resilience.reset()
    del sk, ref
    torch.cuda.empty_cache()
    return {"tiers": [tier0] + walk, "tier_query_ms": tier_ms, "launches": launches,
            "ingest_demoted_add_ms": demoted_add_ms}


def _distributed_walk(device) -> dict:
    """The same walk on ``DistributedDDSketch`` over two value shards on the
    card, down to its ``xla`` floor (K2), against the plain engine."""
    import torch

    from sketches_tpu_torch import faults, kernels, resilience
    from sketches_tpu_torch.parallel import DistributedDDSketch, SketchMesh

    gen = torch.Generator(device=device).manual_seed(SEED + 92)
    mesh = SketchMesh(devices=[device, device])
    dist = DistributedDDSketch(N_STREAMS, mesh=mesh, relative_accuracy=ALPHA, n_bins=N_BINS)
    ref = DistributedDDSketch(N_STREAMS, mesh=mesh, relative_accuracy=ALPHA, n_bins=N_BINS,
                              engine="plain")
    kernels.reset_launch_counts()
    for _ in range(N_BATCHES):
        v = _mixed_batch(gen, N_STREAMS, device)
        dist.add(v)
        ref.add(v)
        del v
    _, want = ref.get_quantile_values_resolved(QS)
    del ref
    torch.cuda.empty_cache()
    tier0, got = dist.get_quantile_values_resolved(QS)
    require(tier0 == "overlap" and _same_answers(got, want),
            f"distributed walk: the default route ({tier0}) differs from the plain engine")
    walk = []
    for armed, nxt in LADDER_WALK:
        faults.arm(faults.PALLAS_LOWERING, tier=armed, times=1)
        tier, got = dist.get_quantile_values_resolved(QS)
        torch.cuda.synchronize()
        faults.disarm()
        require(tier == nxt, f"distributed: with {armed} failing it answered on {tier!r}")
        require(_same_answers(got, want), f"distributed: the {tier} answer differs from the"
                                          " plain engine's")
        walk.append(tier)
    steps = _ledger_steps()
    require(steps == [("distributed.query", a, b) for a, b in LADDER_WALK],
            f"the distributed ledger holds {steps}")
    launches = launch_counts()
    require(launches["fused_quantile"] == 1, "the distributed floor did not launch K2 once")
    floor_ms = event_ms(lambda: dist.get_quantile_values(QS))
    resilience.reset()
    del dist
    torch.cuda.empty_cache()
    return {"tiers": [tier0] + walk, "floor_query_ms": floor_ms, "launches": launches}


def _flip_material_bit(state, stream: int):
    """One bin of ``stream`` with mass, and a flip of its bit 30 (the top
    exponent bit: the mass becomes tiny or infinite, never a rounding)."""
    k = int(state.bins_pos[stream].argmax())
    return (0, stream, k, 30)


def _armed_integrity(device) -> dict:
    """The integrity layer armed in raise mode at 262,144 x 512."""
    import tempfile
    import zipfile

    import torch

    from sketches_tpu_torch import (
        BatchedDDSketch,
        batched,
        checkpoint,
        faults,
        integrity,
        resilience,
    )
    from sketches_tpu_torch.checkpoint import _npz_bytes
    from sketches_tpu_torch.parallel import DistributedDDSketch, SketchMesh
    from sketches_tpu_torch.resilience import IntegrityError, InjectedFault

    n = WIRE_STREAMS
    gen = torch.Generator(device=device).manual_seed(SEED + 93)
    a = BatchedDDSketch(n, relative_accuracy=ALPHA, n_bins=N_BINS, device=device)
    b = BatchedDDSketch(n, relative_accuracy=ALPHA, n_bins=N_BINS, device=device)
    mesh = SketchMesh(devices=[device, device])
    dist = DistributedDDSketch(n, mesh=mesh, relative_accuracy=ALPHA, n_bins=N_BINS)
    for _ in range(2):
        for sk in (a, b, dist):
            sk.add(_mixed_batch(gen, n, device))
    out = {}
    integrity.arm("raise")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fp = integrity.fingerprint(a.spec, a.state)
        out["fingerprint_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        clean = integrity.check_state(a.spec, a.state)
        out["check_state_s"] = time.perf_counter() - t0
        require(not clean and fp.shape == (n,) and bool(np.isfinite(fp).all()),
                "the clean state fails its own check")

        # A clean merge and a clean fold pass the armed seams.
        t0 = time.perf_counter()
        a.merge(b)
        torch.cuda.synchronize()
        out["armed_merge_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dist.merged_state()
        out["armed_fold_s"] = time.perf_counter() - t0

        # One flipped bin in an operand: refused at the merge, by stream.
        s = SEED % n
        flip = _flip_material_bit(b.state, s)
        bad = BatchedDDSketch(n, spec=b.spec, state=faults.apply_state_bitflips(b.state, [flip]),
                              device=device)
        before = a.state.count.clone()
        err = expect_raise(IntegrityError, lambda: a.merge(bad), "a flipped operand bin")
        require(err.report.seam == "merge.operand" and err.report.indices == [s],
                f"the merge refused at {err.report.seam} on streams {err.report.indices}")
        require(integrity.check_state(b.spec, bad.state).indices == [s],
                "check_state does not name the flipped stream")
        require(torch.equal(a.state.count, before), "the refused merge changed the state")
        del bad

        # repair rewrites a desynced count / neg_total / tile_sums.
        st = a.state
        broken = batched.SketchState(**{f: getattr(st, f).clone() for f in batched.LEAVES})
        broken.count[1] += 5
        broken.neg_total[2] += 3
        broken.tile_sums[3, 0] += 7
        found = integrity.check_state(a.spec, broken)
        require(found.indices == [1, 2, 3], f"check_state found {found.counters}")
        t0 = time.perf_counter()
        fixed, repairs = integrity.repair(a.spec, broken)
        out["repair_s"] = time.perf_counter() - t0
        require(sorted(repairs.counters) == ["count", "neg_total", "tile_sums"],
                f"repair rewrote {repairs.counters}")
        diff = _leaves_equal(fixed, st, batched.LEAVES)
        require(not diff and fixed.device == st.device, f"the repaired state differs on {diff}")
        del broken, fixed

        # A checkpoint carries __fingerprint__ and verifies it on restore.
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            path = Path(tmp) / "armed.npz"
            t0 = time.perf_counter()
            checkpoint.save(str(path), a)
            out["armed_save_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = checkpoint.restore(str(path), device=device)
            out["armed_restore_s"] = time.perf_counter() - t0
            require(not _leaves_equal(back.state, a.state, batched.LEAVES),
                    "the armed restore differs")
            with zipfile.ZipFile(path) as z:
                require("__fingerprint__.npy" in z.namelist(),
                        "the armed checkpoint has no __fingerprint__")
            del back
            path.unlink()
            # A file whose fingerprint member was altered (the first 4,096
            # streams: rewriting the whole archive is host time, not a check).
            small = Path(tmp) / "doctored.npz"
            sub = BatchedDDSketch(WIRE_HOST_SAMPLE, spec=a.spec, device=device,
                                  state=a.state.map(lambda x: x[:WIRE_HOST_SAMPLE].clone()))
            checkpoint.save(str(small), sub)
            with np.load(small) as z:
                members = {k: np.asarray(z[k]) for k in z.files}
            s_small = s % WIRE_HOST_SAMPLE
            members["__fingerprint__"][s_small] += 1.0
            small.write_bytes(_npz_bytes(members))
            err = expect_raise(IntegrityError,
                               lambda: checkpoint.restore(str(small), device=device),
                               "a doctored __fingerprint__")
            require(err.report.indices == [s_small],
                    f"the doctored file failed on {err.report.indices}")

        # merge_partial with a dead shard: the dropped mass, exactly.
        faults.arm(faults.MESH_SHARD, shards=(1,))
        survived, rep = dist.merge_partial()
        faults.disarm()
        dead_count = dist.partials.count[1].double().cpu().numpy()
        require(rep.dead_shards == [1] and np.array_equal(rep.dropped_count, dead_count),
                "merge_partial's dropped mass is not the dead partial's count")
        del survived

        # A torn reshard leaves the fleet's answers bit-identical.
        tier, q0 = dist.get_quantile_values_resolved(QS)
        faults.arm(faults.RESHARD_TORN, times=1)
        expect_raise(InjectedFault, lambda: dist.reshard(mesh=SketchMesh(devices=[device])),
                     "reshard.torn")
        faults.disarm()
        tier1, q1 = dist.get_quantile_values_resolved(QS)
        require(tier1 == tier and _same_answers(q0, q1), "the torn reshard changed the answers")

        # A clean reshard carries matching fingerprints across.
        t0 = time.perf_counter()
        new, rep = dist.reshard(mesh=SketchMesh(devices=[device]))
        out["armed_reshard_s"] = time.perf_counter() - t0
        require(rep.exact and rep.fingerprints_match is True,
                f"reshard: exact {rep.exact}, fingerprints_match {rep.fingerprints_match}")
        del new
        out["violations_counted"] = resilience.health()["counters"].get("integrity.violations")
    finally:
        faults.disarm()
        integrity.disarm()
        integrity.reset()
        resilience.reset()
    del a, b, dist
    torch.cuda.empty_cache()
    return out


def phase_robustness(device, disarmed: dict) -> dict:
    """The robustness layer on the card: the query ladder walk and the ingest
    demotion at 1,048,576 x 512, the distributed walk down to K2, the armed
    integrity checks at 262,144 x 512, and the disarmed layer's cost on the
    positive path (this run's main-path times beside the baseline's)."""
    from sketches_tpu_torch import resilience

    resilience.reset()
    t0 = time.perf_counter()
    out = {"batched": _ladder_walk(device)}
    out["distributed"] = _distributed_walk(device)
    out["armed_integrity"] = _armed_integrity(device)
    out["disarmed"] = {
        "facade_add_ms": disarmed["facade_add_ms"],
        "overlap_query_ms": disarmed["facade_query_ms"],
        "baseline_facade_add_ms": BASELINE_ADD_MS,
        "baseline_overlap_query_ms": BASELINE_OVERLAP_QUERY_MS,
        "note": "positive main path, this run; the baseline from PERF.md section 5, recorded"
                " before the robustness layer on the same card model; a record, not a gate",
    }
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: out["batched"]["launches"][k] + out["distributed"]["launches"][k]
                       for k in out["batched"]["launches"]}
    require(resilience.health()["downgrades"] == [], "the robustness phase left the ledger dirty")
    emit("robustness", **out)
    return out


# ---------------------------------------------------------------------------
# The observability phase: telemetry, the flight recorder, profiling and the
# accuracy audit armed on the mixed-sign quick start, then disarmed.
# ---------------------------------------------------------------------------

OBS_BATCHES = 2
# The quick start's window for mixed traffic, pinned so that every batch
# takes K1 (an auto-centred facade's first batch takes the plain recenter).
OBS_KEY_OFFSET = -256
OBS_WATCHED = tuple(range(8))
OBS_COLLAPSE_STREAMS = 1 << 16
OBS_COLLAPSE_SIGMA = 6.0
# Disarmed facade add and overlap query against the same run's numbers
# from before anything was armed.
OBS_DISARMED_TOL = 0.03
# One series line of the Prometheus text exposition, and the OpenMetrics
# exemplar annotation a quantile line may carry after " # ".
PROM_LINE = r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.eE+-]+$"
PROM_EXEMPLAR = r'^\{trace_id="[0-9a-f]{16}"\} [0-9.eE+-]+ [0-9.]+$'


def _obs_checks_exports() -> tuple:
    """Snapshot, Prometheus text and Chrome trace of the armed run: each
    timed on the host, each checked -> (summary, snapshot)."""
    import re

    from sketches_tpu_torch import telemetry

    out = {}
    t0 = time.perf_counter()
    snap = telemetry.snapshot()
    out["snapshot_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    text = telemetry.prometheus_text()
    out["prometheus_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace = json.loads(json.dumps(telemetry.chrome_trace()))
    out["chrome_s"] = time.perf_counter() - t0
    n_series = n_exemplars = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, _, exemplar = line.partition(" # ")
        require(re.match(PROM_LINE, series), f"prometheus line does not parse: {line!r}")
        if exemplar:
            require(re.match(PROM_EXEMPLAR, exemplar), f"exemplar does not parse: {line!r}")
            n_exemplars += 1
        n_series += 1
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    pids = {e["pid"] for e in xs}
    require({telemetry.CHROME_PID_SPANS, telemetry.CHROME_PID_DEVICE} <= pids,
            f"the chrome trace lacks the host or the device track: pids {sorted(pids)}")
    merged = telemetry.merge_snapshots(snap, snap)
    require(all(merged["counters"][k] == 2 * v for k, v in snap["counters"].items()),
            "merge_snapshots(s, s) did not double the counters")
    alpha = telemetry.HISTOGRAM_REL_ACC
    p99_moved = 0
    for k, h in snap["histograms"].items():
        m = merged["histograms"][k]
        require(m["count"] == 2 * h["count"], f"{k}: merged count")
        for store in ("pos", "neg"):
            require(m["state"][store] == {b: 2 * c for b, c in h["state"][store].items()},
                    f"{k}: merged bins are not the single snapshot's, doubled")
        if h["p99"] is None:
            continue
        # The sketch's rank is q * (n - 1): with every observation counted
        # twice, p99 sits at the single snapshot's quantile q' below.
        n = h["count"]
        single = telemetry._sketch_from_state(h["state"], alpha)
        want = single.get_quantile_value(min(1.0, 0.99 * (2 * n - 1) / (2 * (n - 1)))
                                         if n > 1 else 0.99)
        require(abs(m["p99"] - want) <= alpha * abs(want),
                f"{k}: merged p99 {m['p99']} against {want} (single p99 {h['p99']})")
        p99_moved += m["p99"] != h["p99"]
    out.update(prometheus_series=n_series, prometheus_exemplars=n_exemplars,
               chrome_events=len(trace["traceEvents"]), chrome_x_pids=sorted(pids),
               histograms=len(snap["histograms"]), counters=len(snap["counters"]),
               merged_p99_moved_by_rank=p99_moved)
    return out, snap


def phase_observability(device, card: dict, times: dict) -> dict:
    """The four observability layers on the card: armed on the 1M x 512
    mixed-sign quick start (two batches, the default route and the ladder
    down to ``xla``) and a two-shard distributed add and floor query;
    the profiling table against this run's kernel-alone times, the
    exports, a traced downgrade, the accuracy audits (clean, and collapse
    drift on a 128-bin facade), then the disarmed cost."""
    import torch

    from sketches_tpu_torch import (
        BatchedDDSketch,
        accuracy,
        faults,
        kernels,
        profiling,
        resilience,
        telemetry,
        tracing,
    )
    from sketches_tpu_torch.parallel import DistributedDDSketch, SketchMesh

    t_phase = time.perf_counter()
    require(not (telemetry.enabled() or profiling.enabled() or accuracy.enabled()),
            "a layer was armed before the observability phase")
    require(tracing.events() == [], "an earlier phase left flight-recorder events")
    require(profiling.attribution()["measured"] == {}, "an earlier phase left profiling rows")
    gen = torch.Generator(device=device).manual_seed(SEED + 808)

    def facade(n=N_STREAMS, **kw):
        return BatchedDDSketch(n_streams=n, relative_accuracy=ALPHA, **kw)

    # The disarmed numbers first, before anything is armed.
    timing = facade(n_bins=N_BINS, key_offset=OBS_KEY_OFFSET)
    for _ in range(OBS_BATCHES):
        timing.add(_mixed_batch(gen, N_STREAMS, device))
    v_time = _mixed_batch(gen, N_STREAMS, device)
    runs = {"before": {"add_ms": {}, "overlap_query_ms": {}},
            "after": {"add_ms": {}, "overlap_query_ms": {}}}
    before = {"add_ms": settled_ms(lambda: timing.add(v_time), warmup=2, reps=21,
                                   log=runs["before"]["add_ms"])}
    require(timing.get_quantile_values_resolved(QS)[0] == "overlap", "timing facade route")
    before["overlap_query_ms"] = settled_ms(lambda: timing.get_quantile_values(QS), reps=21,
                                            log=runs["before"]["overlap_query_ms"])

    # 1. Armed: the quick start, its ladder, the distributed floor.
    sk = facade(n_bins=N_BINS, key_offset=OBS_KEY_OFFSET)
    mesh = SketchMesh(devices=[device, device])
    dist = DistributedDDSketch(N_STREAMS, mesh=mesh, relative_accuracy=ALPHA, n_bins=N_BINS,
                               key_offset=OBS_KEY_OFFSET)
    telemetry.enable()
    profiling.enable()
    accuracy.enable()
    tracing.seed_ids(1)
    accuracy.watch(sk, "quickstart", streams=OBS_WATCHED, interval=1)
    kernels.reset_launch_counts()
    for _ in range(OBS_BATCHES):
        sk.add(_mixed_batch(gen, N_STREAMS, device))
    routes = {}
    for want, off in (("overlap", ()), ("tiles", ("overlap",)),
                      ("windowed", ("overlap", "tiles")), ("xla", ("windowed", "wxla"))):
        tier, got = sk.get_quantile_values_resolved(QS, disabled_tiers=off)
        require(tier == want, f"observability: {off} resolved {tier!r}, expected {want!r}")
        require(bool(torch.isfinite(got).all()), f"observability: {tier} answers not finite")
        routes[want] = off
    for _ in range(OBS_BATCHES):
        dist.add(_mixed_batch(gen, N_STREAMS, device))
    tier, got = dist.get_quantile_values_resolved(QS, disabled_tiers=("windowed", "wxla"))
    require(tier == "xla" and bool(torch.isfinite(got).all()), "distributed floor")
    audit = accuracy.summary()
    require(audit["audits"] == OBS_BATCHES and audit["violations"] == 0,
            f"the quick start's audits: {audit}, {accuracy.reports()[:4]}")

    # 2. The profiling table against the kernel-alone times.
    att = profiling.attribution()
    rows = {f"{r['phase']}/{r['tier']}": r for r in att["attribution"]}
    fold_bytes = 3 * sum(getattr(sk.state, f).numel() * getattr(sk.state, f).element_size()
                         for f in ("bins_pos", "bins_neg"))
    floors = {
        "ingest/kernel": times["ingest"]["ms"],
        "query/overlap": times["overlap_mixed"]["ms"],
        "query/tiles": times["tiles"]["ms"],
        "query/windowed": times["windowed"]["ms"],
        "query/xla": times["fused_quantile"]["ms"],
        # No kernel folds the partials: the floor is the bytes the fold must
        # move (two partials' bins read, the fold's written).
        "fold/psum": fold_bytes / card["mem_rate_Bps"] * 1e3,
    }
    table = {}
    for key, floor_ms in floors.items():
        require(key in rows, f"profiling has no {key} row: {sorted(rows)}")
        r = rows[key]
        mean_ms = r["mean_s"] * 1e3
        require(mean_ms >= floor_ms, f"{key}: device-clocked mean {mean_ms:.4f} ms is below"
                                     f" its kernel-alone floor {floor_ms:.4f} ms")
        require(r["x_roofline"] is not None, f"{key}: no roofline joined")
        table[key] = {"calls": r["calls"], "mean_ms": mean_ms, "floor_ms": floor_ms,
                      "x_roofline": r["x_roofline"], "entry": r["entry"]}

    # 3. The exports.
    c = telemetry.snapshot()["counters"]
    require(c.get("batched.ingest_batches") == OBS_BATCHES
            and c.get("distributed.ingest_batches") == OBS_BATCHES,
            f"ingest counters {c}")
    # Every batch of both facades went through K1, labelled with the
    # JAX facades' default unit-weight rung.
    require(c.get("ingest.variant.packed") == 2 * OBS_BATCHES, f"ingest.variant.packed {c}")
    exports, snap = _obs_checks_exports()

    # 5. Collapse drift on a 128-bin facade fed lognormal(0, 6) rows.
    narrow = facade(OBS_COLLAPSE_STREAMS, n_bins=128)
    accuracy.watch(narrow, "narrow", streams=OBS_WATCHED, interval=1)
    for _ in range(OBS_BATCHES):
        narrow.add(torch.empty((OBS_COLLAPSE_STREAMS, BATCH), device=device)
                   .log_normal_(0.0, OBS_COLLAPSE_SIGMA, generator=gen))
    drift = [r for r in accuracy.reports() if r.name == "narrow" and r.kind == "collapse-drift"]
    fracs = [v for k, v in telemetry.snapshot()["gauges"].items()
             if k.startswith("accuracy.collapsed_mass_frac")]
    require(drift and max(fracs) > 0, "the 128-bin lognormal(0, 6) facade reported no collapse drift")

    # 4. A traced downgrade: ledger, telemetry and flight recorder.
    small = facade(OBS_COLLAPSE_STREAMS, n_bins=N_BINS, key_offset=OBS_KEY_OFFSET)
    small.add(_mixed_batch(gen, OBS_COLLAPSE_STREAMS, device))
    require(resilience.health()["downgrades"] == [],
            f"the armed path recorded {resilience.health()['downgrades']}")
    with tracing.use(tracing.new_trace()) as ctx:
        faults.arm(faults.PALLAS_LOWERING, tier="overlap", times=1)
        try:
            tier, _ = small.get_quantile_values_resolved(QS)
        finally:
            faults.disarm()
    require(tier == "tiles", f"the traced downgrade answered on {tier!r}")
    steps = _ledger_steps()
    require(steps == [("batched.query", "overlap", "tiles")], f"ledger {steps}")
    key = 'resilience.downgrade{component="batched.query",from_tier="overlap",to_tier="tiles"}'
    require(telemetry.snapshot()["counters"].get(key) == 1, "the downgrade is not in telemetry")
    require(any(e.get("name") == "resilience.downgrade" and e.get("ph") == "i"
                for e in telemetry.chrome_trace()["traceEvents"]),
            "the downgrade is not in the telemetry event stream")
    recorded = [e for e in tracing.events()
                if e["kind"] == "resilience.downgrade" and e["trace_id"] == ctx.trace_hex]
    require(len(recorded) == 1, "the downgrade is not in the flight recorder")
    bundle = tracing.dump_forensics("observability")
    lines, n_events = tracing.explain(bundle, "trigger")
    require(n_events >= 2, f"explain found {n_events} causal events: {lines}")
    launches = launch_counts()
    for name in kernels.launch_counts():
        if not name.startswith("fetch."):  # host fetches, not launches
            require(launches[name] > 0, f"the armed path never launched {name}")
    armed_s = time.perf_counter() - t_phase

    # 6. Disarm and reset all four layers; the disarmed cost.
    telemetry.disable()
    telemetry.reset()
    tracing.reset()
    profiling.disable()
    profiling.reset()
    accuracy.disable()
    accuracy.reset()
    resilience.reset()
    require(not tracing.enabled(), "the flight recorder stayed armed")
    after = {"overlap_query_ms": settled_ms(lambda: timing.get_quantile_values(QS), reps=21,
                                            log=runs["after"]["overlap_query_ms"])}
    after["add_ms"] = settled_ms(lambda: timing.add(v_time), warmup=2, reps=21,
                                 log=runs["after"]["add_ms"])
    cost = {k: after[k] / before[k] - 1.0 for k in before}
    for k, rel in cost.items():
        require(abs(rel) <= OBS_DISARMED_TOL,
                f"disarmed {k}: {after[k]:.4f} ms against {before[k]:.4f} ms before arming"
                f" (runs {runs})")
    require(tracing.events() == [] and profiling.attribution()["measured"] == {},
            "the disarmed layers recorded")

    # The same facade calls, disarmed, timed with CUDA events: the ratio of
    # each device-clocked row to its call.
    v_add = _mixed_batch(gen, N_STREAMS, device)
    event = {
        "ingest/kernel": event_ms(lambda: sk.add(v_add), warmup=1, reps=5),
        "query/overlap": event_ms(lambda: sk.get_quantile_values(QS), reps=5),
        "query/tiles": event_ms(
            lambda: sk.get_quantile_values_resolved(QS, disabled_tiers=routes["tiles"]), reps=5),
        "query/windowed": event_ms(
            lambda: sk.get_quantile_values_resolved(QS, disabled_tiers=routes["windowed"]),
            reps=5),
        # The xla row holds one batched call (the plain full window) and one
        # distributed floor call (K2): the mean of the two calls' times.
        "query/xla": mean([
            event_ms(lambda: sk.get_quantile_values_resolved(QS, disabled_tiers=routes["xla"]),
                     warmup=1, reps=3),
            event_ms(lambda: dist.get_quantile_values_resolved(
                QS, disabled_tiers=("windowed", "wxla")), reps=5)]),
        "fold/psum": event_ms(lambda: (dist._invalidate(), dist.merged_state()), reps=5),
    }
    for key, row in table.items():
        row["event_ms"] = event[key]
        row["mean_over_event"] = row["mean_ms"] / event[key]
    out = {
        "card": card["smi"], "profiling": table, "exports": exports,
        "counters": {k: snap["counters"][k] for k in
                     ("batched.ingest_batches", "distributed.ingest_batches",
                      "ingest.variant.packed", "accuracy.audits")},
        "accuracy": {"quickstart": audit, "collapse_drift_reports": len(drift),
                     "max_collapsed_mass_frac": max(fracs)},
        "tracing": {"explain_events": n_events, "explain": lines},
        "disarmed": {"before": before, "after": after, "relative": cost, "runs": runs},
        "launches": launches, "armed_s": armed_s,
        "seconds": time.perf_counter() - t_phase,
        "note": "armed rows: host clock across torch.cuda.synchronize (profiling.record);"
                " x_roofline against the roofline at the audited shape (128 streams x 256"
                " bins); floors: this run's kernel-alone times (fold: its bytes bound);"
                " event_ms: the same facade calls disarmed, CUDA events, median of 5",
    }
    del sk, dist, timing, narrow, small
    torch.cuda.empty_cache()
    emit("observability", **out)
    return out


# ---------------------------------------------------------------------------
# Time windows, the serving tier and the serve fabric
# ---------------------------------------------------------------------------

# The windows path: the default ladder (12 x 5 s, 60 x 1 min, 24 x 1 h) at
# 65,536 streams (fingerprints are host numpy over each covered bucket, so
# the 1M quick start's width would cost about 10 s a bucket), one
# [65,536, 256] mixed batch every 2.5 s of virtual time for 240 s.
WIN_STREAMS = 1 << 16
WIN_STEP_S = 2.5
WIN_BATCHES = 96
WIN_QS = (0.01, 0.25, 0.5, 0.9, 0.99)
WIN_WINDOWS = (60.0, 300.0, None)
# The envelope and checkpoint round trips run on the first streams of the
# same traffic: the codec and the npz writer are host-bound Python.
WIN_ROUNDTRIP_STREAMS = 4096
AGG_ENV = "SKETCHES_TPU_WINDOW_AGG"
# Backend rings: uniform collapse at the dense ring's width; moment at
# 1,024 streams (its host maxent solve is about 2.18 ms a stream).
WIN_ADAPTIVE_BATCHES = 30
WIN_MOMENT_STREAMS = 1024
WIN_MOMENT_BATCHES = 12
# The serve path: 16 dense tenants of 16,384 streams on one spec (262,144
# streams, one stacked K2 launch) and a windowed tenant of 16,384 streams.
SERVE_TENANTS = 16
SERVE_STREAMS = 1 << 14
SERVE_REQUESTS = 400
SERVE_ROUND = 10
SERVE_QSETS = ((0.5, 0.99), (0.5, 0.9, 0.99), (0.99,))
SERVE_ZIPF = 1.1
# Serving-clock (virtual) seconds: a tick per request and the default
# budget; a few requests carry 0.01 s, inside the 0.02 s floor margin.
SERVE_TICK_S = 0.05
SERVE_DEADLINE_S = 1.0
# The fabric path: 4 virtual hosts, 3 copies, 4 tenants of 16,384 streams
# on a pinned window (a pinned state crosses the wire exactly).
FAB_HOSTS = 4
FAB_COPIES = 3
FAB_TENANTS = 4


class _Uncounted:
    """Launches and plain quantile calls inside this block (comparisons
    with a reference) leave the launch counters and the
    :class:`_PlainOnCard` count as they were."""

    def __enter__(self):
        from sketches_tpu_torch import kernels

        self._saved = {f: f.launches for f in kernels._KERNEL_WRAPPERS}
        self._weighted = kernels.ingest_histogram.weighted_launches
        self._plain = _PlainOnCard.calls

    def __exit__(self, *exc):
        from sketches_tpu_torch import kernels

        for f, n in self._saved.items():
            f.launches = n
        kernels.ingest_histogram.weighted_launches = self._weighted
        _PlainOnCard.calls = self._plain
        return False


class _PlainOnCard:
    """Counts calls of the plain full-window queries on a card state
    between :meth:`start` and :meth:`stop`, outside :class:`_Uncounted`
    blocks: ``batched.quantile`` and the windowed ``wxla`` tier
    (``kernels.quantile_windowed_xla``), which no main path may run on the
    card (the facades' floor, the serving tier's floor, hedge and stacked
    flush and the window fold-decode answer with K2 there, the ladder with
    K3-K5)."""

    calls = 0

    def start(self) -> "_PlainOnCard":
        from sketches_tpu_torch import batched, kernels

        _PlainOnCard.calls = 0
        self._real = [(batched, "quantile", batched.quantile),
                      (kernels, "quantile_windowed_xla", kernels.quantile_windowed_xla)]
        for mod, name, real in self._real:
            def counted(spec, state, *a, _real=real, **k):
                if state.device.type == "cuda":
                    _PlainOnCard.calls += 1
                return _real(spec, state, *a, **k)

            setattr(mod, name, counted)
        return self

    def stop(self) -> None:
        for mod, name, real in self._real:
            setattr(mod, name, real)

    def check(self, phase: str) -> int:
        require(_PlainOnCard.calls == 0,
                f"{phase}: the main path ran a plain quantile on the card"
                f" {_PlainOnCard.calls} times")
        return _PlainOnCard.calls


class _FingerprintMeter:
    """Counts ``integrity.fingerprint`` calls and their host seconds between
    :meth:`start` and :meth:`stop`."""

    def start(self) -> "_FingerprintMeter":
        from sketches_tpu_torch import integrity

        self.calls, self.seconds = 0, 0.0
        self._real = integrity.fingerprint

        def counted(spec, state):
            t0 = time.perf_counter()
            try:
                return self._real(spec, state)
            finally:
                self.calls += 1
                self.seconds += time.perf_counter() - t0

        integrity.fingerprint = counted
        return self

    def stop(self) -> None:
        from sketches_tpu_torch import integrity

        integrity.fingerprint = self._real


class _agg_off:
    """``SKETCHES_TPU_WINDOW_AGG=0`` while windowed rings are built (the
    switch is read at construction)."""

    def __enter__(self):
        os.environ[AGG_ENV] = "0"

    def __exit__(self, *exc):
        del os.environ[AGG_ENV]
        return False


def _sync_s(fn):
    """Host seconds of ``fn()`` up to the card finishing it -> (s, result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _covered_batches(w, plan, stamps):
    """Indices of the batches (ingested at ``stamps``) inside ``plan``'s
    buckets: each batch sits in its rung-0 slice while that slice is on the
    ring, else in the coarser bucket it retired into."""
    live = {(r, b) for r, b, _m in w.buckets()}
    keys = set(plan.keys)
    out = []
    for i, t in enumerate(stamps):
        for r in range(w.config.n_rungs):
            key = (r, int(np.floor(t / w.config.slices_s[r])))
            if key in live:
                if key in keys:
                    out.append(i)
                break
    return out


def _window_ring_checks(w, device) -> dict:
    """The round trips of a ring: ``check_window`` clean, then one flipped
    bin reported; the envelope and a checkpoint answering bit for bit."""
    import tempfile

    import torch

    from sketches_tpu_torch import checkpoint, faults, integrity, windows
    from sketches_tpu_torch.backends import wirefmt

    out = {}
    out["check_window_s"], report = _sync_s(lambda: integrity.check_window(w))
    require(not report, f"windows: check_window on a clean ring: {report.violations[:3]}")
    bucket = next(b for r in w._rungs for b in r.values())
    stream = int(torch.argmax(bucket.state.count))
    bin_ = int(torch.argmax(bucket.state.bins_pos[stream]))
    clean = bucket.state
    bucket.state = faults.apply_state_bitflips(clean, ((0, stream, bin_, 30),))
    try:
        report = integrity.check_window(w)
    finally:
        bucket.state = clean
    require(bool(report) and stream in report.indices,
            f"windows: a flipped bin in bucket {bucket.id} was not reported")
    out["flipped_bin_report"] = {"stream": stream, "counters": report.counters}
    qs = list(WIN_QS)
    want = w.quantile(qs, window=None)
    with _Uncounted():
        require(torch.equal(want, windows.oracle_quantile(w, qs, window=None)),
                "windows: the re-merge lane differs from oracle_quantile")
    out["envelope_encode_s"], blob = _sync_s(lambda: wirefmt.windowed_to_bytes(w))
    with _agg_off():
        out["envelope_decode_s"], back = _sync_s(lambda: wirefmt.windowed_from_bytes(
            w.spec, blob, clock=windows.VirtualClock(w._clock())))
    require(back.ledger() == w.ledger() and back.buckets() == w.buckets(),
            "windows: the envelope round trip changed the ledger")
    require(torch.equal(back.quantile(qs, window=None), want),
            "windows: the envelope round trip answers differently")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "ring.npz")
        out["checkpoint_save_s"], _ = _sync_s(lambda: checkpoint.save_windowed(path, w))
        with _agg_off():
            out["checkpoint_restore_s"], back = _sync_s(lambda: checkpoint.restore_windowed(
                path, clock=windows.VirtualClock(w._clock())))
        out["checkpoint_bytes"] = Path(path).stat().st_size
    require(back.ledger() == w.ledger() and back.buckets() == w.buckets(),
            "windows: the checkpoint round trip changed the ledger")
    require(torch.equal(back.quantile(qs, window=None), want),
            "windows: the checkpoint round trip answers differently")
    out["envelope_bytes"] = len(blob)
    return out


def _adaptive_ring(device) -> dict:
    """A uniform-collapse ring on the default ladder with collapse levels
    (0, 1, 2): 65,536 streams, a fixed quarter of them lognormal(0, 6), 30
    batches; the full-horizon answer equal to the oracle and, on sampled
    streams, within the fold's per-stream effective alpha of the exact
    lower quantiles (``_adaptive_alpha_check``: clamped mass bracketed, as
    in the backends phase)."""
    import torch

    from sketches_tpu_torch import batched, windows

    spec = batched.SketchSpec(relative_accuracy=ALPHA, n_bins=N_BINS, backend="uniform_collapse")
    cfg = windows.WindowConfig(windows.DEFAULT_LADDER.slices_s, windows.DEFAULT_LADDER.lengths,
                               collapse_levels=(0, 1, 2))
    clk = windows.VirtualClock(0.0)
    w = windows.WindowedSketch(WIN_STREAMS, spec=spec, config=cfg, clock=clk)
    sigma, heavy, gen = _heavy_traffic(device, WIN_STREAMS, SEED + 12)
    sample = torch.randperm(WIN_STREAMS, device=device, generator=gen)[:N_SAMPLED]
    kept, add_s = [], []
    for _ in range(WIN_ADAPTIVE_BATCHES):
        clk.advance(WIN_STEP_S)
        v = _lognormal_rows(sigma, gen)
        kept.append(v[sample])
        dt, _ = _sync_s(lambda: w.add(v))
        add_s.append(dt)
        del v
    led = w.ledger()
    require(led["total"] == WIN_ADAPTIVE_BATCHES * WIN_STREAMS * BATCH
            and led["total"] == led["live"] + led["retired"],
            f"windows: adaptive ledger not exact: {led}")
    qs = list(CHECK_QS)
    plan = w.window_plan(None)
    est = w.query_plan(plan, qs)
    with _Uncounted():
        ref = windows.oracle_quantile(w, qs, window=None)
        folded = windows._fold_state_for(spec)[windows._fold_mode(spec, plan.states)](
            plan.states)
    require(torch.equal(est, ref), "windows: adaptive answer differs from oracle_quantile")
    base = folded.base
    checked, outside, clamped, bracketed, worst = _adaptive_alpha_check(
        spec, folded.level[sample], base.key_offset[sample], base.collapsed_low[sample],
        base.collapsed_high[sample], torch.cat(kept, dim=1), est[sample], qs)
    return {
        "streams": WIN_STREAMS, "batches": WIN_ADAPTIVE_BATCHES, "ledger": led,
        "rung_effective_alpha": w.rung_effective_alpha(),
        "levels": torch.bincount(folded.level).tolist(),
        "heavy_streams": int(heavy.sum()),
        "alpha_check": {"checked": checked, "outside_window": outside,
                        "clamped_streams": clamped, "bracketed": bracketed,
                        "max_err_over_bound": worst},
        "add_ms_median": statistics.median(add_s) * 1e3,
    }


def _moment_ring(device, gen) -> dict:
    """A moment ring of 1,024 streams: ledger exact, answers equal to the
    oracle (the host solve over the same fold)."""
    import torch

    from sketches_tpu_torch import batched, windows

    spec = batched.SketchSpec(relative_accuracy=ALPHA, backend="moment", n_moments=12)
    clk = windows.VirtualClock(0.0)
    w = windows.WindowedSketch(WIN_MOMENT_STREAMS, spec=spec, clock=clk)
    for _ in range(WIN_MOMENT_BATCHES):
        clk.advance(WIN_STEP_S)
        w.add(torch.empty((WIN_MOMENT_STREAMS, BATCH), device=device)
              .log_normal_(0.0, 2.0, generator=gen))
    led = w.ledger()
    require(led["total"] == WIN_MOMENT_BATCHES * WIN_MOMENT_STREAMS * BATCH
            and led["total"] == led["live"] + led["retired"], f"windows: moment ledger {led}")
    qs = list(MOMENT_QS)
    dt, got = _sync_s(lambda: w.quantile(qs, window=60.0))
    require(np.array_equal(got, windows.oracle_quantile(w, qs, window=60.0), equal_nan=True),
            "windows: moment answer differs from oracle_quantile")
    require(bool(np.isfinite(got).all()), "windows: moment answers not finite")
    return {"streams": WIN_MOMENT_STREAMS, "batches": WIN_MOMENT_BATCHES, "ledger": led,
            "query_s": dt}


def phase_windows(device) -> dict:
    """``WindowedSketch`` on the default ladder at 65,536 x 512 on the card:
    96 mixed batches over 240 s of virtual time, window queries against
    ``oracle_quantile`` bit for bit and against exact quantiles, the exact
    ledger, an armed torn rotation, round trips, and the uniform-collapse
    and moment rings."""
    import torch

    from sketches_tpu_torch import BatchedDDSketch, faults, integrity, kernels, resilience
    from sketches_tpu_torch import windows

    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    clk = windows.VirtualClock(0.0)
    w = windows.WindowedSketch(WIN_STREAMS, relative_accuracy=ALPHA, n_bins=N_BINS,
                               config=windows.DEFAULT_LADDER, clock=clk)
    # The round-trip ring takes the full re-merge lane (the
    # SKETCHES_TPU_WINDOW_AGG=0 kill switch, read at construction): its
    # window answers fold every covered bucket and decode with K2, and
    # its restored copies, built in the same lane, must answer alike.
    with _agg_off():
        rt = windows.WindowedSketch(WIN_ROUNDTRIP_STREAMS, relative_accuracy=ALPHA,
                                    n_bins=N_BINS, config=windows.DEFAULT_LADDER, clock=clk)
    require(rt.agg_stats()["enabled"] == 0.0, "windows: the kill switch was not read")
    require(w.device.type == "cuda", "windows: the ring is not on the card")
    sample = torch.randperm(WIN_STREAMS, device=device, generator=gen)[:N_SAMPLED]
    kernels.reset_launch_counts()
    kept, stamps, roll_ms, add_ms = [], [], [], []
    fps = _FingerprintMeter().start()
    plain = _PlainOnCard().start()
    try:
        for _ in range(WIN_BATCHES):
            clk.advance(WIN_STEP_S)
            v = _mixed_batch(gen, WIN_STREAMS, device)
            kept.append(v[sample])
            stamps.append(clk())
            rotations = w.ledger()["rotations"]
            dt, _ = _sync_s(lambda: w._roll(clk()))
            if w.ledger()["rotations"] > rotations:
                roll_ms.append(dt * 1e3)
            dt, _ = _sync_s(lambda: w.add(v))
            add_ms.append(dt * 1e3)
            rt.add(v[:WIN_ROUNDTRIP_STREAMS])
            del v
        ingested = float(WIN_BATCHES * WIN_STREAMS * BATCH)
        led = w.ledger()
        require(led["total"] == ingested and led["live"] + led["retired"] == ingested
                and w.total_mass == ingested, f"windows: ledger not exact: {led}")
        qs = list(WIN_QS)
        answers = {}
        for win in WIN_WINDOWS:
            plan_s, plan = _sync_s(lambda: w.window_plan(win))
            before = kernels.launch_counts()
            first_s, got = _sync_s(lambda: w.query_plan(plan, qs))
            repeat_s, again = _sync_s(lambda: w.quantile(qs, window=win))
            after = kernels.launch_counts()
            with _Uncounted():
                want = windows.oracle_quantile(w, qs, window=win)
            require(torch.equal(got, want) and torch.equal(again, want),
                    f"windows: window={win} differs from oracle_quantile")
            require(bool(torch.isfinite(got).all()) and got.shape == (WIN_STREAMS, len(qs)),
                    f"windows: window={win} answers not finite [N, Q]")
            # The fold's throwaway facade decodes both: its overlap route,
            # once each (the first query also plans it).
            k5 = after["fused_quantile_tiles_overlap"] - before["fused_quantile_tiles_overlap"]
            require(after["fused_quantile"] == before["fused_quantile"] and k5 == 2,
                    f"windows: the queries at window={win} did not decode through K5")
            answers[str(win)] = {
                "covered_buckets": plan.n_covered, "components": len(plan.components or ()),
                "plan_s": plan_s, "first_query_ms": first_s * 1e3,
                "repeat_query_ms": repeat_s * 1e3,
            }
            if win == WIN_WINDOWS[0]:
                plan60, got60 = plan, got
        # The 60-s window against exact lower quantiles of its batches.
        idx = _covered_batches(w, plan60, stamps)
        exact = _exact_lower(torch.cat([kept[i] for i in idx], dim=1), qs)
        est = got60[sample].double()
        ulp = torch.finfo(torch.float32).eps * exact.abs()
        bad = (est - exact).abs() > ALPHA * exact.abs() + ulp
        require(not bool(bad.any()), f"windows: {int(bad.sum())} 60-s answers outside alpha")
        rel60 = ((est - exact).abs() / exact.abs()).amax().item()
        # Repeat query (K5 on the cached fold) against a plain facade query and
        # a K2 decode of the same folded state, all by CUDA events.
        folded = w._agg_fold(plan60)
        fac = BatchedDDSketch(WIN_STREAMS, spec=w.spec, state=folded)
        require(fac.state is folded and fac._window_plan is None and not fac._tile_plans,
                "windows: the decode facade copied or pre-planned the fold")
        with _Uncounted():
            timing = {
                "repeat_window_query_ms": event_ms(lambda: w.query_plan(plan60, qs)),
                "plain_facade_query_ms": event_ms(lambda: fac.get_quantile_values(qs)),
                "k2_decode_ms": event_ms(lambda: kernels.floor_quantile(w.spec, folded, qs)),
                "fold_and_decode_ms": event_ms(lambda: (
                    w.__setattr__("_agg_fold_cache", None), w.query_plan(plan60, qs)), reps=5),
            }
        w.query_plan(plan60, qs)  # the fold cache back in place
        # An armed torn rotation mutates nothing.
        before = (w.buckets(), w.ledger(), integrity.fingerprint(w.spec, w._live.state))
        clk.advance(w.config.slices_s[0])  # into the next slice: a rotation
        v = _mixed_batch(gen, WIN_STREAMS, device)
        faults.arm(faults.WINDOW_ROTATE_TORN, times=1)
        try:
            expect_raise(resilience.InjectedFault, lambda: w.add(v), "windows: torn rotation")
        finally:
            faults.disarm()
        after = (w.buckets(), w.ledger(), integrity.fingerprint(w.spec, w._live.state))
        require(after[0] == before[0] and after[1] == before[1]
                and np.array_equal(after[2], before[2]),
                "windows: a torn rotation changed the ring")
        w.add(v)
        led = w.ledger()
        require(led["total"] == ingested + WIN_STREAMS * BATCH
                and led["total"] == led["live"] + led["retired"],
                f"windows: ledger after the completed rotation: {led}")
        del v
        checks = _window_ring_checks(rt, device)
        backends = {"uniform_collapse": _adaptive_ring(device),
                    "moment": _moment_ring(device, gen)}
    finally:
        fps.stop()
        plain.stop()
    plain_on_card = plain.check("windows")
    launches = launch_counts()
    for name in ("ingest_histogram", "fused_quantile", "fused_quantile_tiles_overlap"):
        require(launches[name] > 0, f"windows: {name} never launched")
    out = {
        "streams": WIN_STREAMS, "batches": WIN_BATCHES + 1, "ledger": led,
        "buckets": len(w.buckets()), "windows": answers, "max_rel_err_60s_vs_exact": rel60,
        "batches_in_60s": len(idx), "rotation_ms_median": statistics.median(roll_ms),
        "rotations_timed": len(roll_ms), "add_ms_median": statistics.median(add_ms),
        "agg": w.agg_stats(), "times": timing, "roundtrip_ring": {
            "streams": WIN_ROUNDTRIP_STREAMS, **checks},
        "backends": backends, "fingerprints": {"calls": fps.calls, "host_s": fps.seconds},
        "plain_quantile_on_card": plain_on_card,
        "launches": launches, "seconds": time.perf_counter() - t_phase,
    }
    del w, rt, kept, fac, folded
    torch.cuda.empty_cache()
    emit("windows", **out)
    return out


def _zipf_tenants(rng, names, n):
    """``n`` tenant picks, rank-Zipf(1.1) over ``names`` (rank 1 hottest)."""
    ranks = np.arange(1, len(names) + 1, dtype=np.float64)
    p = ranks ** -SERVE_ZIPF
    return [names[i] for i in rng.choice(len(names), size=n, p=p / p.sum())]


def phase_serve(device) -> dict:
    """``SketchServer`` on the card: 16 dense tenants of 16,384 streams on
    one spec and a windowed tenant; 400 requests (Zipf tenants, one write
    per four reads, deadlines on every request, a few inside the floor
    margin), the stacked flush held to each tenant's own quantile, cache
    hits to cold recomputes, an armed straggler and cache poison, sheds
    with their reasons."""
    import torch

    from sketches_tpu_torch import batched, faults, kernels, resilience, serve, windows

    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    rng = np.random.default_rng(SEED + 10)
    clk = windows.VirtualClock(0.0)
    cfg = serve.ServeConfig(max_queue_depth=SERVE_TENANTS, tenant_quota=4,
                            default_deadline_s=SERVE_DEADLINE_S, floor_margin_s=0.02)
    srv = serve.SketchServer(cfg, clock=clk)
    names = [f"t{i:02d}" for i in range(SERVE_TENANTS)]
    kernels.reset_launch_counts()
    for name in names:
        srv.add_tenant(name, SERVE_STREAMS, relative_accuracy=ALPHA, n_bins=N_BINS)
    srv.add_tenant("win", SERVE_STREAMS, relative_accuracy=ALPHA, n_bins=N_BINS,
                   window=windows.WindowConfig((5.0, 60.0), (12, 5)))
    require(len({srv.tenant(n).spec for n in names}) == 1
            and srv.tenant(names[0]).device.type == "cuda",
            "serve: tenants do not share one spec on the card")
    for name in names + ["win"]:
        for _ in range(2):
            clk.advance(1.0)
            srv.ingest(name, _mixed_batch(gen, SERVE_STREAMS, device))
    fps = _FingerprintMeter().start()
    plain = _PlainOnCard().start()
    try:
        # One stacked flush over all 262,144 streams: one K2 launch.
        qs = SERVE_QSETS[1]
        tickets = [srv.submit(n, qs) for n in names]
        before = kernels.launch_counts()["fused_quantile"]
        flush_s, _ = _sync_s(srv.flush)
        require(kernels.launch_counts()["fused_quantile"] == before + 1
                and srv.stats()["fused_dispatches"] == 1,
                "serve: the 16-tenant flush was not one stacked K2 launch")
        cpu_bit, cpu_diff = True, 0.0
        with _Uncounted():
            for tk in tickets:
                f = srv.tenant(tk.tenant)
                got = torch.from_numpy(tk.result.values)
                require(tk.result.tier == "xla" and not tk.result.hedged,
                        f"serve: stacked flush answered {tk.result.tier}")
                require(torch.equal(got, batched.quantile(f.spec, f.state, qs).cpu()),
                        "serve: the stacked flush differs from batched.quantile on the card")
                cpu = batched.quantile(f.spec, f.state.map(lambda t: t.cpu()), qs)
                cpu_bit = cpu_bit and torch.equal(got, cpu)
                cpu_diff = max(cpu_diff, require_rel(got, cpu, 1e-6, "serve: vs the CPU copy"))
            group = [srv._tenant(n) for n in names]
            stacked_ms = event_ms(lambda: srv._dispatch_group(group, qs), reps=5)
            tenant_ms = event_ms(lambda: srv._dispatch_tenant(group[0], qs, False), reps=5)
        # Faults: one straggler hedged, one poisoned cache entry.
        hot, hot_qs = names[0], SERVE_QSETS[2]
        cold = srv.tenant(hot).get_quantile_values(list(hot_qs)).cpu().numpy()
        faults.arm(faults.SERVE_STRAGGLER, times=1)
        try:
            res = srv.query(hot, hot_qs)
        finally:
            faults.disarm()
        require(res.hedged and res.tier == "xla" and np.array_equal(res.values, cold),
                "serve: the hedged straggler differs from the primary")
        hedges = [e for e in resilience.health()["downgrades"]
                  if e["component"] == "serve.dispatch"]
        require(len(hedges) == 1, "serve: the hedge was not recorded once")
        resilience.reset()
        require(srv.query(hot, hot_qs).cached, "serve: no cache entry to poison")
        faults.arm(faults.SERVE_CACHE_POISON, times=1)
        try:
            res = srv.query(hot, hot_qs)
        finally:
            faults.disarm()
        require(not res.cached and np.array_equal(res.values, cold)
                and srv.stats()["cache_poisoned"] == 1,
                "serve: the poisoned entry was not quarantined and recomputed")
        # The traffic: rank-Zipf tenants (the windowed one fourth), a write
        # per four reads, reads submitted in rounds and flushed; every fifth
        # round runs until the queue sheds on depth.
        order = _zipf_tenants(rng, names[:3] + ["win"] + names[3:], SERVE_REQUESTS)
        latencies, sheds = [], {}
        hits = n_reads = n_writes = n_window = near = rounds = 0
        pending = []

        def flush():
            nonlocal pending, rounds
            srv.flush()
            done = time.perf_counter()
            for tk, t0 in pending:
                latencies.append(done - t0)
            pending, rounds = [], rounds + 1

        faults.arm(faults.SERVE_QUEUE_OVERFLOW, times=1)
        for i, name in enumerate(order):
            clk.advance(SERVE_TICK_S)
            if i % 5 == 4:
                srv.ingest(name, _mixed_batch(gen, SERVE_STREAMS, device))
                n_writes += 1
                continue
            n_reads += 1
            qs_i = SERVE_QSETS[int(rng.integers(len(SERVE_QSETS)))]
            if name == "win":
                n_window += 1
                t0 = time.perf_counter()
                res = srv.quantile("win", qs_i, window=60.0)
                latencies.append(time.perf_counter() - t0)
                with _Uncounted():
                    want = windows.oracle_quantile(srv.tenant("win"), qs_i, window=60.0)
                require(np.array_equal(res.values, want.cpu().numpy(), equal_nan=True),
                        "serve: windowed answer differs from oracle_quantile")
                continue
            deadline = 0.01 if i % 37 == 0 else None
            near += deadline is not None
            t0 = time.perf_counter()
            try:
                tk = srv.submit(name, qs_i, deadline_s=deadline)
            except serve.ServeOverload as e:
                require(e.reason in ("tenant_quota", "queue_depth", "injected")
                        and e.tenant == name, f"serve: shed without a reason: {e!r}")
                sheds[e.reason] = sheds.get(e.reason, 0) + 1
                if e.reason == "queue_depth":
                    flush()
                continue
            if tk.result is not None:  # a cache hit at admission
                latencies.append(time.perf_counter() - t0)
                hits += 1
                with _Uncounted():
                    f = srv.tenant(name)
                    want = batched.quantile(f.spec, f.state, list(tk.qs))
                require(np.array_equal(tk.result.values, want.cpu().numpy()),
                        "serve: a cache hit differs from a cold recompute")
                continue
            pending.append((tk, t0))
            if len(pending) >= SERVE_ROUND and rounds % 5 != 4:
                flush()
        faults.disarm()
        flush()
        stats = srv.stats()
        require(set(sheds) == {"tenant_quota", "queue_depth", "injected"}
                and sheds["injected"] == 1, f"serve: sheds {sheds}")
    finally:
        fps.stop()
        plain.stop()
        faults.disarm()
    plain_on_card = plain.check("serve")
    launches = launch_counts()
    for name in ("ingest_histogram", "fused_quantile", "fused_quantile_tiles_overlap"):
        require(launches[name] > 0, f"serve: {name} never launched")
    lat = sorted(latencies)
    out = {
        "tenants": SERVE_TENANTS, "streams_per_tenant": SERVE_STREAMS,
        "stacked_streams": SERVE_TENANTS * SERVE_STREAMS,
        "stacked_flush_s": flush_s, "stacked_dispatch_ms": stacked_ms,
        "tenant_dispatch_ms": tenant_ms, "cpu_copy_bit_identical": cpu_bit,
        "cpu_copy_max_abs_diff": cpu_diff,
        "requests": {"reads": n_reads, "writes": n_writes, "window_reads": n_window,
                     "near_floor": near},
        "latency_ms": {"p50": 1e3 * lat[len(lat) // 2],
                       "p99": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))]},
        "cache_hit_rate": stats["cache_hits"] / max(1, stats["cache_hits"]
                                                    + stats["cache_misses"]),
        "cache_hits_checked": hits, "sheds": sheds, "rounds": rounds, "stats": stats,
        "fingerprints": {"calls": fps.calls, "host_s": fps.seconds},
        "plain_quantile_on_card": plain_on_card,
        "launches": launches, "seconds": time.perf_counter() - t_phase,
    }
    del srv
    torch.cuda.empty_cache()
    emit("serve", **out)
    return out


def phase_fabric(device) -> dict:
    """``ServeFabric`` of 4 virtual hosts, 3 copies, 4 tenants of 16,384
    streams on the card: ingest, two sync rounds, a primary killed (the
    dropped mass closes the ledger exactly), a corrupted replica refused,
    partition and heal, a handoff, ``fabric.replica_stale`` armed once;
    every replica answer equal to the primary's bit for bit."""
    import torch

    from sketches_tpu_torch import batched, fabric, faults, kernels, resilience, windows

    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    clk = windows.VirtualClock(0.0)
    fab = fabric.ServeFabric(fabric.FabricConfig(n_hosts=FAB_HOSTS, replication=FAB_COPIES,
                                                 staleness_s=600.0), clock=clk)
    names = [f"f{i}" for i in range(FAB_TENANTS)]
    qs = SERVE_QSETS[1]
    kernels.reset_launch_counts()
    fps = _FingerprintMeter().start()
    plain = _PlainOnCard().start()
    try:
        t0 = time.perf_counter()
        for n in names:
            fab.add_tenant(n, SERVE_STREAMS, relative_accuracy=ALPHA, n_bins=N_BINS,
                           key_offset=-256)
        place_s = time.perf_counter() - t0
        require(all(fab.placement(n) == fabric.placement(n, FAB_HOSTS, FAB_COPIES)
                    for n in names), "fabric: placement differs from rendezvous")
        ingested = {n: 0.0 for n in names}

        def ingest(n):
            fab.ingest(n, _mixed_batch(gen, SERVE_STREAMS, device))
            ingested[n] += float(SERVE_STREAMS * BATCH)

        sync_s = []
        for _round in range(2):
            for n in names:
                ingest(n)
            dt, synced = _sync_s(fab.sync)
            require(synced == FAB_TENANTS * (FAB_COPIES - 1), f"fabric: synced {synced}")
            sync_s.append(dt / synced)
        read_ms, primary = [], {}
        for n in names:
            dt, res = _sync_s(lambda: fab.quantile(n, qs))
            read_ms.append(dt * 1e3)
            require(res.role == "primary", f"fabric: {n} read from {res.role}")
            f = fab.host_server(fab.placement(n)[0]).tenant(n)
            with _Uncounted():
                want = batched.quantile(f.spec, f.state, qs).cpu().numpy()
            require(np.array_equal(res.values, want),
                    f"fabric: the primary read of {n} differs from batched.quantile")
            primary[n] = res.values
        # Every replica answers the primary's values bit for bit.
        for n in names:
            for h in fab.placement(n)[1:]:
                got = fab.host_server(h).query(n, qs).values
                require(np.array_equal(got, primary[n]),
                        f"fabric: replica of {n} on host {h} differs from the primary")
        # A corrupted replica is refused and the read re-homes.
        victim = names[0]
        pl = fab.placement(victim)
        facade = fab.host_server(pl[1]).tenant(victim)
        stream = int(torch.argmax(facade.state.count))
        bin_ = int(torch.argmax(facade.state.bins_pos[stream]))
        facade.state = faults.apply_state_bitflips(facade.state, ((0, stream, bin_, 30),))
        fab.partition_host(pl[0])
        dt, res = _sync_s(lambda: fab.quantile(victim, qs))
        require(res.role == "replica" and res.host == pl[2] and res.degraded
                and np.array_equal(res.values, primary[victim]),
                "fabric: the corrupted replica was not refused and re-homed")
        require(fab.stats()["stale_refusals"] == 1, "fabric: refusal not counted")
        expect_raise(resilience.FabricUnavailable, lambda: fab.ingest(
            victim, _mixed_batch(gen, SERVE_STREAMS, device)), "fabric: partitioned write")
        heal_s, resynced = _sync_s(lambda: fab.heal_partition(pl[0]))
        require(fab.sync(victim) == FAB_COPIES - 1, "fabric: the repair sync failed")
        # The armed replica-stale site: corrupted at read time, refused.
        fab.partition_host(pl[0])
        faults.arm(faults.FABRIC_REPLICA_STALE, times=1, seed=3)
        try:
            res = fab.quantile(victim, qs)
        finally:
            faults.disarm()
        require(np.array_equal(res.values, primary[victim]),
                "fabric: the armed replica-stale read answered differently")
        fab.heal_partition(pl[0])
        fab.sync(victim)
        # Handoff of a replica to the free host.
        free = next(h for h in fab.live_hosts() if h not in fab.placement(victim))
        handoff_s, rep = _sync_s(lambda: fab.handoff_replica(victim, fab.placement(victim)[1],
                                                               free))
        require(rep.cache_preserved and free in fab.placement(victim), "fabric: handoff")
        # Kill a primary after post-sync ingest: the ledger closes exactly.
        killed = fab.placement(names[1])[0]
        for n in names:
            if fab.placement(n)[0] == killed:
                ingest(n)
        expected = {n: fab.ledger(n)["expected_count"].copy() for n in names}
        failover_s, reports = _sync_s(lambda: fab.kill_host(killed))
        require(reports, "fabric: killing a primary produced no failover")
        for r in reports:
            led = fab.ledger(r.tenant)
            require(r.exact and float(r.dropped_count.sum()) == float(SERVE_STREAMS * BATCH)
                    and np.array_equal(r.dropped_count + led["expected_count"],
                                       expected[r.tenant])
                    and led["expected_total"] + led["dropped_total"] == ingested[r.tenant],
                    f"fabric: failover of {r.tenant} did not close the ledger exactly")
            res = fab.quantile(r.tenant, qs)
            require(res.role in ("primary", "cache") and bool(np.isfinite(res.values).all()),
                    f"fabric: {r.tenant} does not answer after failover")
        stats = fab.stats()
    finally:
        fps.stop()
        plain.stop()
        faults.disarm()
    plain_on_card = plain.check("fabric")
    launches = launch_counts()
    for name in ("ingest_histogram", "fused_quantile_tiles_overlap"):
        require(launches[name] > 0, f"fabric: {name} never launched")
    out = {
        "hosts": FAB_HOSTS, "copies": FAB_COPIES, "tenants": FAB_TENANTS,
        "streams_per_tenant": SERVE_STREAMS, "place_s": place_s,
        "sync_s_per_replica": sync_s, "read_ms": read_ms, "heal_s": heal_s,
        "heal_resynced": resynced, "handoff_s": handoff_s, "failover_s": failover_s,
        "failovers": [{"tenant": r.tenant, "from": r.from_host, "to": r.to_host,
                       "dropped_total": r.dropped_total, "exact": r.exact}
                      for r in reports],
        "stats": stats, "fingerprints": {"calls": fps.calls, "host_s": fps.seconds},
        "plain_quantile_on_card": plain_on_card,
        "launches": launches, "seconds": time.perf_counter() - t_phase,
    }
    del fab
    torch.cuda.empty_cache()
    emit("fabric", **out)
    return out


# ---------------------------------------------------------------------------
# The multi-process mesh over torch.distributed (ROADMAP A7)
# ---------------------------------------------------------------------------

# Host-staged (gloo) folds: the standing cut of host-bound parts (PERF.md
# section 4) to 262,144 streams.
MP_STREAMS = 1 << 18
MP_SHARDS = 4  # value shards of the whole mesh, two a rank
MP_LOCAL = 2
MP_KEY_OFFSET = -256  # one pinned window on every rank (offsets fold with max)
MP_TIMEOUT_S = 300


def _mp_seconds(fn):
    """``fn()`` and its host seconds up to a synchronize of the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _mp_state_bytes(st) -> int:
    from sketches_tpu_torch.batched import LEAVES

    return sum(getattr(st, f).numel() * getattr(st, f).element_size() for f in LEAVES)


def _mp_gloo_rank(rank: int, world: int) -> dict:
    """One rank of the two-rank gloo job on the one card: its two value
    shards' slices through K1 (a pinned-window ``DistributedDDSketch`` over
    its cells), the hierarchical fold (the inner fold on the card, then one
    host-staged ``all_reduce`` a leaf), and the folded state on the default
    route (K5) and the ``xla`` floor (K2).  Rank 0 then holds the fold and
    the answers to a single-process ``DistributedDDSketch`` over all four
    value shards, fed the same data."""
    import torch
    import torch.distributed as dist

    from sketches_tpu_torch import kernels
    from sketches_tpu_torch.batched import LEAVES, BatchedDDSketch
    from sketches_tpu_torch.parallel import (DistributedDDSketch, SketchMesh, make_global_mesh,
                                             make_hierarchical_mesh, psum_merge)

    dev = torch.device("cuda", 0)
    g = make_global_mesh(("values",), devices=[dev] * MP_LOCAL)
    mesh = make_hierarchical_mesh(devices=g.devices, ranks=g.ranks)
    require(mesh.n_hosts == world, f"n_hosts {mesh.n_hosts} is not the world size {world}")
    built = mesh.build()
    require(built.shape == {"dcn": world, "ici": MP_LOCAL}, f"mesh shape {built.shape}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    data = torch.empty((MP_SHARDS, MP_STREAMS, BATCH), device=dev).log_normal_(0.0, 2.0,
                                                                             generator=gen)
    mine = data[rank * MP_LOCAL : (rank + 1) * MP_LOCAL].permute(1, 0, 2).reshape(
        MP_STREAMS, MP_LOCAL * BATCH).contiguous()
    kw = dict(relative_accuracy=ALPHA, n_bins=N_BINS, key_offset=MP_KEY_OFFSET)
    kernels.reset_launch_counts()
    local = DistributedDDSketch(MP_STREAMS, mesh=SketchMesh(devices=[dev] * MP_LOCAL), **kw)
    require(local.engine == "kernel", f"the local facade's engine is {local.engine}")
    dist.barrier()
    _, ingest_s = _mp_seconds(lambda: local.add(mine))
    dist.barrier()
    folded, fold_s = _mp_seconds(
        lambda: psum_merge(local.shard_partials()[0], axis_name=("dcn", "ici"), mesh=mesh))
    facade = BatchedDDSketch(MP_STREAMS, spec=local.spec, state=folded)
    (tier, ans), query_s = _mp_seconds(lambda: facade.get_quantile_values_resolved(list(QS)))
    (tier_floor, ans_floor), floor_s = _mp_seconds(
        lambda: facade.get_quantile_values_resolved(list(QS), disabled_tiers=("windowed", "wxla")))
    launches = launch_counts()
    require((tier, tier_floor) == ("overlap", "xla"), f"tiers {tier}, {tier_floor}")
    require(int(folded.count[0]) == MP_SHARDS * BATCH, f"count {int(folded.count[0])}")
    fold_bytes = _mp_state_bytes(folded)
    out = {"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(dev),
           "mesh": built.shape, "ingest_s": ingest_s, "fold_s": fold_s,
           "query_overlap_s": query_s, "query_xla_s": floor_s, "fold_bytes": fold_bytes,
           "fold_host_staged_GBps": fold_bytes / fold_s / 1e9, "launches": launches,
           "tiers": [tier, tier_floor]}
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        ref = DistributedDDSketch(MP_STREAMS, mesh=SketchMesh(devices=[dev] * MP_SHARDS), **kw)
        ref.add(data.permute(1, 0, 2).reshape(MP_STREAMS, MP_SHARDS * BATCH))
        want = ref.merged_state()
        diff = [f for f in LEAVES if f != "sum"
                and not torch.equal(getattr(folded, f), getattr(want, f))]
        require(not diff, f"the two-rank fold differs from one process's in {diff}")
        sum_rel = require_rel(folded.sum, want.sum, 1e-6, "folded sum")
        ref_tier, ref_ans = ref.get_quantile_values_resolved(list(QS))
        ref_floor_tier, ref_floor = ref.get_quantile_values_resolved(
            list(QS), disabled_tiers=("windowed", "wxla"))
        require((ref_tier, ref_floor_tier) == ("overlap", "xla"),
                f"reference tiers {ref_tier}, {ref_floor_tier}")
        for a, b, what in ((ans, ref_ans, "overlap"), (ans_floor, ref_floor, "xla")):
            require(torch.equal(torch.isnan(a), torch.isnan(b))
                    and torch.equal(a.nan_to_num(), b.nan_to_num()),
                    f"the two-rank fold's {what} answers differ from one process's")
        out["reference"] = {"value_shards": MP_SHARDS, "leaves_bit_equal": len(LEAVES) - 1,
                            "sum_max_abs_err": sum_rel, "answers_bit_equal": ["overlap", "xla"]}
    return out


def _mp_nccl_rank() -> dict:
    """A world of one NCCL rank: ``make_global_mesh`` on the card and the
    collective fold of a K1-ingested state, which must leave it bit-equal
    (the NCCL path is wired; NCCL takes one rank a card)."""
    import torch
    import torch.distributed as dist

    from sketches_tpu_torch import kernels
    from sketches_tpu_torch.batched import LEAVES, BatchedDDSketch
    from sketches_tpu_torch.parallel import make_global_mesh, psum_merge

    dev = torch.device("cuda", 0)
    mesh = make_global_mesh(("values",))
    built = mesh.build()
    require(built.devices.reshape(-1).tolist() == [dev], f"mesh devices {built.devices}")
    require(built.groups == {(0,): dist.group.WORLD}, f"groups {built.groups}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    v = torch.empty((MP_STREAMS, BATCH), device=dev).log_normal_(0.0, 2.0, generator=gen)
    kernels.reset_launch_counts()
    b = BatchedDDSketch(MP_STREAMS, relative_accuracy=ALPHA, n_bins=N_BINS,
                        key_offset=MP_KEY_OFFSET, device=dev)
    _, ingest_s = _mp_seconds(lambda: b.add(v))
    before = b.state.map(lambda x: x.clone())
    folded, fold_s = _mp_seconds(lambda: psum_merge(b.state, axis_name="values", mesh=mesh))
    launches = launch_counts()
    diff = [f for f in LEAVES if not torch.equal(getattr(folded, f), getattr(before, f))]
    require(not diff, f"the world-of-one fold changed {diff}")
    fold_bytes = _mp_state_bytes(folded)
    out = {"rank": 0, "world": 1, "backend": dist.get_backend(), "device": str(dev),
           "ingest_s": ingest_s, "fold_s": fold_s, "fold_bytes": fold_bytes,
           "fold_GBps": fold_bytes / fold_s / 1e9, "launches": launches,
           "state_bit_equal": True}
    dist.destroy_process_group()
    return out


def mp_worker(argv) -> int:
    """``chip_smoke.py --mp-worker BACKEND RANK WORLD RENDEZVOUS OUT``: one
    rank of the ``multiprocess`` phase, in a fresh interpreter; its report
    goes to OUT as JSON."""
    import torch
    import torch.distributed as dist

    backend, rank, world, rdv, out_path = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{rdv}", world_size=world, rank=rank)
    t0 = time.perf_counter()
    out = _mp_gloo_rank(rank, world) if backend == "gloo" else _mp_nccl_rank()
    out["seconds"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(out, sort_keys=True))
    return 0


def _mp_run(backend: str, world: int, tmp: str) -> list:
    """Start ``world`` worker processes of ``backend`` and wait for them ->
    their reports; fails on a non-zero exit or past the time limit, after
    stopping every worker."""
    rdv = os.path.join(tmp, f"rendezvous_{backend}")
    outs = [os.path.join(tmp, f"{backend}{r}.json") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mp-worker",
                               backend, str(r), str(world), rdv, outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + MP_TIMEOUT_S
    logs, late = [], False
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(0.1, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            late = True
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    for p in procs:
        p.wait()
    transcript = "\n".join(f"--- {backend} rank {r} (rc {p.returncode}) ---\n{log[-4000:]}"
                            for r, (p, log) in enumerate(zip(procs, logs)))
    require(not late, f"multiprocess {backend}: a worker passed {MP_TIMEOUT_S} s\n{transcript}")
    require(all(p.returncode == 0 for p in procs),
            f"multiprocess {backend}: a worker failed\n{transcript}")
    return [json.loads(Path(o).read_text()) for o in outs]


def phase_multiprocess(device) -> dict:
    """(a) Two gloo ranks on the one card, each with two value shards, the
    hosts derived from the world size: K1 ingest, the hierarchical fold
    (inner on the card, outer host-staged), K5 and K2 on the folded state;
    rank 0 holds it to a single-process four-shard ``DistributedDDSketch``
    (every leaf but ``sum`` bit-equal, ``sum`` rtol 1e-6, answers bit-equal
    on both routes).  (b) One NCCL rank: the collective fold on a world of
    one leaves the state bit-equal.  Workers are fresh interpreters (the
    kernels are built already, so none compiles); their launches come back
    in their reports."""
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as tmp:
        gloo = _mp_run("gloo", 2, tmp)
        nccl = _mp_run("nccl", 1, tmp)
    total: dict = {}
    for rep in gloo + nccl:
        _sum_launches(total, rep["launches"])
    for k in ("ingest_histogram", "fused_quantile", "fused_quantile_tiles_overlap"):
        require(total.get(k, 0) > 0, f"multiprocess: {k} never launched")
    out = {"gloo": gloo, "nccl": nccl, "launches": total,
           "streams": MP_STREAMS, "value_shards": MP_SHARDS, "batch": BATCH,
           "seconds": time.perf_counter() - t_phase,
           "note": "gloo takes CUDA tensors and stages them through the host; NCCL takes one"
                   " rank a card"}
    emit("multiprocess", **out)
    return out


# ---------------------------------------------------------------------------
# The chaos harness and the examples (ROADMAP A11)
# ---------------------------------------------------------------------------

# The six campaigns at the JAX tests' step counts and seeds; the elastic and
# windowed meshes draw on ``chaos.POOL`` (8) entries of the card (value shards
# share it).
CHAOS_CALLS = (("core", 80, 3), ("serve", 60, 5), ("elastic", 60, 3),
               ("adaptive", 40, 13), ("windowed", 40, 13), ("fabric", 40, 5))
# Campaigns whose card events must equal the port's own CPU run of the call.
CHAOS_CPU_TWINS = ("core", "serve")
# Each example and (a part of) its closing line.
EXAMPLES = (
    ("chaos_drill", "drill complete: corruption detected, crash recovered exactly"),
    ("latency_monitoring", "proto round-trip"),
    ("wire_interop", "re-export: 4096/4096 blobs byte-identical"),
    ("distributed_mesh", "elastic drill passed"),
    ("heterogeneous_fleet", "OK"),
    ("serve_load", "verdict           ok"),
    ("windowed_dashboard", "windowed dashboard passed"),
    ("fleet_dashboard", "SLO(s) within budget"),
)


def _sum_launches(total: dict, launches: dict) -> None:
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def _events(verdict) -> list:
    return [(e["step"], e["site"], e["outcome"]) for e in verdict["events"]]


def phase_chaos(device) -> dict:
    """The six chaos campaigns on the card through the CLI
    (``chaos.main([..., "--device", "cuda:0"])``), each
    verdict ``ok`` with nothing ``undetected``; the core and serve
    campaigns' ``(step, site, outcome)`` lists equal to the port's own
    CPU run of the same call.  K1 (the ingest-variant driver's 128-stream
    facade) and K2 (every quantile check, the facades' floor) must launch.
    The health ledger is read into each row and reset after it."""
    import contextlib
    import io
    import tempfile

    from sketches_tpu_torch import chaos, faults, integrity, kernels, resilience

    t_phase = time.perf_counter()
    cpu_runs = {"core": chaos.run_campaign, "serve": chaos.run_serve_campaign}
    rows, total = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as tmp:
        for name, steps, seed in CHAOS_CALLS:
            path = os.path.join(tmp, f"{name}.json")
            kernels.reset_launch_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = chaos.main(["--campaign", name, "--steps", str(steps), "--seed", str(seed),
                                 "--device", str(device),
                                 "--out", path])
            seconds = time.perf_counter() - t0
            launches = launch_counts()
            with open(path, encoding="utf-8") as f:
                verdict = json.load(f)
            require(rc == 0 and verdict["ok"] and not verdict["outcomes"].get("undetected"),
                    f"chaos {name}: rc {rc}, outcomes {verdict['outcomes']},"
                    f" errors {verdict['errors'][:3]}")
            row = {"steps": steps, "seed": seed, "n_faults": verdict["n_faults"],
                   "outcomes": verdict["outcomes"], "seconds": seconds,
                   "tiers": verdict["health"]["tiers"],
                   "health_counters": verdict["health"]["counters"],
                   "launches": launches, "summary": buf.getvalue().strip().splitlines()[-1]}
            for key in ("mesh_sizes_visited", "reshards", "serve_stats", "fabric_stats"):
                if key in verdict:
                    row[key] = verdict[key]
            resilience.reset()
            if name in cpu_runs:
                t0 = time.perf_counter()
                cpu = cpu_runs[name](steps, seed, device="cpu")
                row["cpu_seconds"] = time.perf_counter() - t0
                card_ev, cpu_ev = _events(verdict), _events(cpu)
                diff = [(a, b) for a, b in zip(card_ev, cpu_ev) if a != b]
                require(card_ev == cpu_ev,
                        f"chaos {name}: the card's events differ from the CPU run's:"
                        f" {len(card_ev)} against {len(cpu_ev)}, first differences {diff[:4]}")
                row["events_equal_cpu"] = True
                resilience.reset()
            _sum_launches(total, launches)
            rows[name] = row
    faults.disarm()
    integrity.disarm()
    integrity.reset()
    resilience.reset()
    for k in ("ingest_histogram", "fused_quantile"):
        require(total.get(k, 0) > 0, f"chaos: {k} never launched")
    out = {"campaigns": rows, "pool": [str(device)] * chaos.POOL, "launches": total,
           "seconds": time.perf_counter() - t_phase}
    emit("chaos", **out)
    return out


def phase_examples(device) -> dict:
    """The eight examples on the card through their entry points
    (``main(["--device", "cuda:0"])``, in this process so that each one's
    launches are counted; ``fleet_dashboard``'s shards are processes of
    their own, whose launches are not).  Each must return 0 and print its
    closing line; ``wire_interop`` must launch K5."""
    import contextlib
    import importlib
    import io

    import torch

    from sketches_tpu_torch import faults, integrity, kernels, resilience, telemetry, tracing

    t_phase = time.perf_counter()
    rows, total = {}, {}
    for name, closing in EXAMPLES:
        module = importlib.import_module(f"sketches_tpu_torch.examples.{name}")
        kernels.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = module.main(["--device", str(device)])
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        lines = buf.getvalue().strip().splitlines()
        require(rc == 0 and lines and closing in lines[-1],
                f"example {name}: rc {rc}, output ends {lines[-3:]}")
        rows[name] = {"seconds": seconds, "launches": launches, "closing": lines[-1],
                      "lines": len(lines)}
        if name == "wire_interop":
            rows[name]["bridge"] = next(ln for ln in lines if ln.startswith("stream 7"))
        _sum_launches(total, launches)
        for layer in (telemetry, tracing):
            layer.disable()
            layer.reset()
        faults.disarm()
        integrity.disarm()
        integrity.reset()
        resilience.reset()
        torch.cuda.empty_cache()
    require(rows["wire_interop"]["launches"]["fused_quantile_tiles_overlap"] > 0,
            "examples: wire_interop never launched fused_quantile_tiles_overlap")
    out = {"examples": rows, "launches": total, "seconds": time.perf_counter() - t_phase,
           "note": "fleet_dashboard's shards run as processes of their own: their launches"
                   " are not in its row"}
    emit("examples", **out)
    return out


def main(argv=None) -> int:
    import argparse

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--mp-worker"]:
        return mp_worker(argv[1:])

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", type=Path, action="append", default=[], metavar="DIR",
                    help="another tree holding sketches_tpu_torch/csrc (e.g. a git archive of"
                         " the parent commit): time its ingest, full-window and overlap"
                         " kernels beside this tree's, in turns; may be repeated")
    ap.add_argument("--checkpoint-writers", action="store_true",
                    help="also time the port's npz writer (zlib level 1) against"
                         " np.savez_compressed (level 6) on the pinned 1M x 512 state")
    opts = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    if not (ROOT / "sketches_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: sketches_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = phase_card()
    rate = card["mem_rate_Bps"]
    phase_build()
    phase_analysis()
    require_ledger("analysis")
    trees = build_compare(opts.compare) if opts.compare else {}
    ingest_others = {k: t["sk_ingest"] for k, t in trees.items()}
    overlap_others = {k: t["sk_overlap"] for k, t in trees.items()}
    quantile_others = {k: t["sk_quantile"] for k, t in trees.items()}
    require_ledger("build")
    errs = phase_kernels_vs_plain(device)
    require_ledger("kernels_vs_plain")
    phase_host_tier(device)
    # The device-flush tier is reached through the native kill switch.
    require_ledger("host_tier", native_kill_switch_events(1))

    pos = phase_main_path(device, "positive", 0.0, "windowed")
    t_win = time_query(device, pos["facade"], "windowed", rate)
    t_over = time_query(device, pos["facade"], "overlap", rate, others=overlap_others)
    require_ledger("main_path_positive")
    mixed = phase_main_path(device, "mixed_sign", 0.4, "tiles")
    t_tiles = time_query(device, mixed["facade"], "tiles", rate)
    t_over_mixed = time_query(device, mixed["facade"], "overlap", rate, others=overlap_others)
    t_full = time_query(device, mixed["facade"], "xla", rate, others=quantile_others)
    require_ledger("main_path_mixed_sign")
    wire = phase_wire(device, {"positive": pos.pop("facade"), "mixed_sign": mixed.pop("facade")})
    pinned = wire.pop("pinned_facade")
    # The pure-Python decode is reached through the native kill switch.
    require_ledger("wire", native_kill_switch_events(1))
    torch.cuda.empty_cache()
    t_full_2048 = phase_wide_state(device, rate, quantile_others)
    torch.cuda.empty_cache()
    t_ingest = time_ingest(device, rate, ingest_others)
    require_ledger("times")
    emit("times", card=card["smi"], ingest=t_ingest, windowed=t_win, tiles=t_tiles,
         overlap=t_over, overlap_mixed=t_over_mixed, fused_quantile=t_full,
         fused_quantile_2048=t_full_2048,
         note=f"kernel alone at the main path's shapes, CUDA events, median of 11 runs of"
              f" {KERNEL_INNER} back-to-back launches after warm-up (ingest batches and"
              f" compare: the same, in turns a, b, ..., b, a, mean of the two medians);"
              f" plain versions median of"
              f" 11 single calls; bound = max(bytes/mem rate, f32 ops/67 TFLOP/s); overlap"
              f" on the positive and the mixed final state, fused_quantile on the mixed one"
              f" and on a 262,144 x 2048 mixed state")
    torch.cuda.reset_peak_memory_stats(device)
    dist = phase_distributed(device)
    dist.pop("facade")
    require_ledger("distributed")
    torch.cuda.empty_cache()
    ckpt = phase_checkpoint(device, pinned, opts.checkpoint_writers)
    require_ledger("checkpoint")
    del pinned
    torch.cuda.empty_cache()
    backends = phase_backends(device)
    require_ledger("backends")
    torch.cuda.empty_cache()
    robust = phase_robustness(device, pos)
    torch.cuda.empty_cache()
    obs = phase_observability(device, card, {
        "ingest": t_ingest, "windowed": t_win, "tiles": t_tiles,
        "overlap_mixed": t_over_mixed, "fused_quantile": t_full})
    require_ledger("observability")
    torch.cuda.empty_cache()
    win = phase_windows(device)
    require_ledger("windows")
    serving = phase_serve(device)
    require_ledger("serve")
    fab = phase_fabric(device)
    require_ledger("fabric")
    torch.cuda.empty_cache()
    mp = phase_multiprocess(device)
    require_ledger("multiprocess")
    # Last: the campaigns and the examples arm integrity and faults globally.
    chaos_out = phase_chaos(device)
    examples_out = phase_examples(device)

    def launched(name):
        return sum(path["launches"].get(name, 0)
                   for path in (pos, mixed, dist, wire, ckpt, backends, robust, obs, win,
                                serving, fab, mp, chaos_out, examples_out))

    src = "sketches_tpu_torch/csrc/"
    rows = [
        ("ingest_histogram", "ingest.cu", "sketches_tpu/kernels.py:233 (_ingest_kernel)",
         t_ingest),
        ("fused_quantile", "quantile.cu",
         "sketches_tpu/kernels.py:777 (_quantile_kernel, _select_quantiles)", t_full),
        ("fused_quantile_windowed", "windowed.cu",
         "sketches_tpu/kernels.py:883 (_windowed_kernel)", t_win),
        ("fused_quantile_tiles", "tiles.cu",
         "sketches_tpu/kernels.py:1510 (_tiles_kernel, _count_and_decode)", t_tiles),
        ("fused_quantile_tiles_overlap", "overlap.cu",
         "sketches_tpu/kernels.py:1814 (_overlap_kernel)", t_over),
    ]
    for name, *_ in rows:
        require(launched(name) > 0, f"{name} never launched on a main path")
    table = [
        {
            "name": name, "route": "cuda", "source": src + file, "replaces": replaces,
            "launches": launched(name), "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
        }
        for name, file, replaces, t in rows
    ]
    # K5 runs on both traffic mixes' default route: the row's numbers are
    # the positive state's; the mixed state's ride beside.
    table[4].update(ms_mixed=t_over_mixed["ms"], plain_ms_mixed=t_over_mixed["plain_ms"],
                    bound_ms_mixed=t_over_mixed["bound_ms"])
    table[1].update(ms_2048=t_full_2048["ms"], bound_ms_2048=t_full_2048["bound_ms"],
                    plain_ms_2048=t_full_2048["plain_ms"])
    table[0].update(ms_constant=t_ingest["constant"]["ms"],
                    ms_weighted=t_ingest["weighted"]["ms"],
                    bound_ms_weighted=t_ingest["weighted"]["bound_ms"],
                    plain_ms_weighted=t_ingest["weighted"]["plain_ms"],
                    ms_padded=t_ingest["padded"]["ms"],
                    launches_weighted=launched(K1_WEIGHTED),
                    launches_unit=launched("ingest_histogram") - launched(K1_WEIGHTED))
    emit("done", seconds=time.perf_counter() - t_start)
    print(card["smi"])
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                              "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

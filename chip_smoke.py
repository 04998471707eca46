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
  batches of positive traffic, against the ``engine="plain"`` facade on the
  same mesh: the default query resolves ``overlap``, and with
  ``disabled_tiers=("windowed", "wxla")`` the floor ``xla`` answers through
  one ``fused_quantile`` launch.

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

Each path (the wire and checkpoint phases too) resets the launch counters
before it runs and reads them after.
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
in the ``times`` line under ``compare``, labelled by DIR's name.

    python3 chip_smoke.py --checkpoint-writers

also times the port's checkpoint writer (zlib level 1) against
``np.savez_compressed`` (level 6) on the pinned state's host arrays, in
turns; the ``checkpoint`` line carries them under ``writers``.
"""

from __future__ import annotations

import json
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


def event_ms(fn, *, warmup: int = 3, reps: int = 11, inner: int = 1) -> float:
    """Median device time of ``fn()`` in ms, each run timed with CUDA events.

    ``inner`` > 1 times that many back-to-back calls per run and divides:
    the host enqueues the next launch while the card runs the last, so a
    kernel's time excludes the host's launch overhead.  Warm-up scales with
    ``inner`` (the card's clocks settle over the first few milliseconds)."""
    import torch

    for _ in range(warmup * inner):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


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


def compare_ms(runs: dict) -> dict:
    """{label: mean of its two turns} from :func:`alternate_ms`."""
    return {k: mean(v) for k, v in alternate_ms(runs).items()}


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
    """|a - b| <= rtol * |b| everywhere (NaN positions equal); returns the
    largest absolute difference."""
    import torch

    err = max_abs_diff(a, b)
    keep = ~torch.isnan(b)
    ok = ((a[keep].double() - b[keep].double()).abs() <= rtol * b[keep].double().abs()).all()
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
    import torch

    q = torch.tensor(qs, dtype=torch.float64, device=x.device)
    return torch.quantile(x.double(), q, dim=1, interpolation="lower").T


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
    launches = kernels.launch_counts()
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
    quick start's width, against the plain engine on the same mesh."""
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
    for _ in range(N_BATCHES):
        v = torch.empty((N_STREAMS, BATCH), device=device).log_normal_(0.0, 2.0, generator=gen)
        kept.append(v[sample])
        abs_sum += v.abs().sum(-1, dtype=torch.float64)
        for facade, times in ((dist, add_ms), (ref, plain_add_ms)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            facade.add(v)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        del v
    ingest_launches = kernels.ingest_histogram.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tier, got = dist.get_quantile_values_resolved(QS)
    torch.cuda.synchronize()
    first_query_ms = (time.perf_counter() - t0) * 1e3
    after_default = kernels.launch_counts()
    floor_tier, floor = dist.get_quantile_values_resolved(QS, disabled_tiers=("windowed", "wxla"))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require(ingest_launches == 2 * N_BATCHES,
            f"{ingest_launches} ingest launches, expected one per value shard per batch")
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
    with ThreadPoolExecutor(len(csrcs)) as pool:
        list(pool.map(lambda c: _build.build(list(sources.values()), c), csrcs.values()))
    return {label: {e: c_entry(_build.library(src, c), e) for e, src in sources.items()}
            for label, c in csrcs.items()}


def time_ingest(device, rate: float, others: dict) -> dict:
    """K1 alone at the main path's launch shape, one stream chunk x 256
    values: lognormal values (the ``kernels`` line's row), a constant batch
    (every value in one bin, the heaviest skew) and a weighted call, timed
    in turns (lognormal, constant, weighted, weighted, constant, lognormal);
    each ``ms`` is the mean of its two turns, ``turns_ms`` both of them and
    ``sm_mhz`` the SM clock read just before the first; ``host_us`` is the
    host's time to launch it.  ``others`` ({label: sk_ingest of another
    build}) are timed beside this kernel in turns, on each of the three
    batches, and their host times beside its own."""
    import torch

    from sketches_tpu_torch import batched, kernels

    spec = batched.SketchSpec(ALPHA, n_bins=N_BINS)
    n = batched._stream_chunk(N_STREAMS, N_BINS) or N_STREAMS
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    v = torch.empty((n, BATCH), device=device).log_normal_(0.0, 2.0, generator=gen)
    const = torch.full_like(v, 3.7)
    w = torch.rand((n, BATCH), device=device, generator=gen) * 2.0
    koff = torch.full((n,), -(N_BINS // 2) + 64, dtype=torch.int32, device=device)
    ncols = kernels._ncols(spec.n_tiles)
    hist_pos = torch.empty((n, N_BINS), dtype=torch.float32, device=device)
    hist_neg = torch.empty_like(hist_pos)
    cols = torch.empty((n, ncols), dtype=torch.float32, device=device)
    consts = kernels._mapping_consts(spec.mapping, device)

    def run(fn, x, weights=None):
        return launcher(fn, x.data_ptr(), None if weights is None else weights.data_ptr(),
                        koff.data_ptr(), hist_pos.data_ptr(), hist_neg.data_ptr(),
                        cols.data_ptr(), consts.data_ptr(), spec.mapping.kernel_id, n, BATCH,
                        N_BINS, ncols)

    def plain(x, weights=None):
        return lambda: kernels.ingest_histogram_plain(spec, x, weights, koff,
                                                      weighted=weights is not None)

    fn = kernels._entry("sk_ingest")
    batches = {"lognormal": (v,), "constant": (const,), "weighted": (v, w)}
    sm_mhz = sm_clock_mhz()
    turns = alternate_ms({label: run(fn, *b) for label, b in batches.items()})
    bytes_moved = 4 * (n * BATCH + n + 2 * n * N_BINS + n * ncols)
    ops = INGEST_OPS_PER_VALUE * n * BATCH + 2 * n * N_BINS
    out = {"ms": mean(turns["lognormal"]), "turns_ms": turns["lognormal"],
           "plain_ms": event_ms(plain(v)), "shape": [n, BATCH, N_BINS], "sm_mhz": sm_mhz,
           "host_us": host_us(run(fn, v)), **bound(bytes_moved, ops, rate)}
    out["constant"] = {"ms": mean(turns["constant"]), "turns_ms": turns["constant"],
                       "plain_ms": event_ms(plain(const))}
    out["weighted"] = {"ms": mean(turns["weighted"]), "turns_ms": turns["weighted"],
                       "plain_ms": event_ms(plain(v, w)),
                       **bound(bytes_moved + 4 * n * BATCH, ops, rate)}
    if others:
        out["compare"] = {
            label: compare_ms({"this": run(fn, *b), **{k: run(f, *b) for k, f in others.items()}})
            for label, b in batches.items()
        }
        out["compare_host_us"] = {k: host_us(run(f, v)) for k, f in others.items()}
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
    out["launches"] = kernels.launch_counts()
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
    out["launches"] = kernels.launch_counts()
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
    launches = kernels.launch_counts()
    require(ingest_launches > 0, "add launched no ingest kernel")
    require(tier == "overlap" and launches["fused_quantile_tiles_overlap"] == 1,
            f"the adaptive default route resolved {tier!r} without one overlap launch")
    win_tier, win = ad.get_quantile_values_resolved(QS, disabled_tiers=("overlap",))
    xla_off = ("overlap", "tiles", "windowed", "wxla")
    xla_tier, xla = ad.get_quantile_values_resolved(QS, disabled_tiers=xla_off)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the main path's, before any timing
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
    at_262k = kernels.launch_counts()
    out["launches"] = {k: launches[k] + at_262k[k] for k in launches}
    emit("backends", **out)
    return out


def main(argv=None) -> int:
    import argparse

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
    trees = build_compare(opts.compare) if opts.compare else {}
    ingest_others = {k: t["sk_ingest"] for k, t in trees.items()}
    overlap_others = {k: t["sk_overlap"] for k, t in trees.items()}
    quantile_others = {k: t["sk_quantile"] for k, t in trees.items()}
    errs = phase_kernels_vs_plain(device)
    phase_host_tier(device)

    pos = phase_main_path(device, "positive", 0.0, "windowed")
    t_win = time_query(device, pos["facade"], "windowed", rate)
    t_over = time_query(device, pos["facade"], "overlap", rate, others=overlap_others)
    mixed = phase_main_path(device, "mixed_sign", 0.4, "tiles")
    t_tiles = time_query(device, mixed["facade"], "tiles", rate)
    t_over_mixed = time_query(device, mixed["facade"], "overlap", rate, others=overlap_others)
    t_full = time_query(device, mixed["facade"], "xla", rate, others=quantile_others)
    wire = phase_wire(device, {"positive": pos.pop("facade"), "mixed_sign": mixed.pop("facade")})
    pinned = wire.pop("pinned_facade")
    torch.cuda.empty_cache()
    t_full_2048 = phase_wide_state(device, rate, quantile_others)
    torch.cuda.empty_cache()
    t_ingest = time_ingest(device, rate, ingest_others)
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
    torch.cuda.empty_cache()
    ckpt = phase_checkpoint(device, pinned, opts.checkpoint_writers)
    del pinned
    torch.cuda.empty_cache()
    backends = phase_backends(device)
    torch.cuda.empty_cache()

    def launched(name):
        return sum(path["launches"][name] for path in (pos, mixed, dist, wire, ckpt, backends))

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
                    ms_weighted=t_ingest["weighted"]["ms"])
    emit("done", seconds=time.perf_counter() - t_start)
    print(card["smi"])
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                              "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

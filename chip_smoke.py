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

Each path resets the launch counters before it runs and reads them after.
Answers are checked against the plain facade and against exact quantiles of
sampled streams; each kernel is timed beside its plain version and its
bound; one JSON line is printed per phase.  The last line is
``{"ok": true, "device": {...}}``; any failure raises and exits non-zero.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.  Imports torch and numpy, never JAX.

    python3 chip_smoke.py --compare build/cmp/parent [--compare DIR ...]

also builds the ingest and overlap kernels of other trees (each DIR holds
``sketches_tpu_torch/csrc``: a ``git archive`` of the parent commit, or a
patched copy, unpacked under the gitignored ``build/``) and times them
beside this tree's, in turns on the same card; the results ride in the
``times`` line under ``compare``, labelled by DIR's name.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
    from sketches_tpu_torch import _build

    t0 = time.perf_counter()
    per_source = _build.build()
    total = time.perf_counter() - t0
    resources = {
        src: [ln.strip() for ln in _build.build_log(src).splitlines()
              if "registers" in ln or "spill" in ln]
        for src in _build.SOURCES
    }
    emit("build", seconds=total, per_source=per_source, ptxas=resources)


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
            # K2 against its plain version and the plain quantile.
            got = kernels.fused_quantile(spec, st, qs)
            ref = kernels.fused_quantile_plain(spec, st, qs)
            errs["fused_quantile"] = max(
                errs["fused_quantile"], require_rel(got, ref, 1e-6, "fused_quantile"))
            require_rel(got, full, 1e-6, "fused_quantile vs batched.quantile")
    torch.cuda.synchronize()
    emit("kernels_vs_plain", ingest_cases=checked, max_abs_err=errs,
         ingest_sum_col_max_rel=sum_rel,
         tolerance="unit-weight ingest bit-identical; weighted ingest rtol 1e-5; sum column"
         " atol 1e-5*sum|v*w|; queries equal bucket (values rtol 1e-6: decode exp ulps);"
         " overlap equal to tiles exactly; max_abs_err of the ingest covers histograms and"
         " every column but sum")
    return errs


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
    return out


def build_compare(trees) -> dict:
    """Compile other trees' ingest.cu and overlap.cu (the same C entry
    points) with this tree's flags, every tree at once -> {tree name:
    {entry name: function}}."""
    from concurrent.futures import ThreadPoolExecutor

    from sketches_tpu_torch import _build

    sources = {"sk_ingest": "ingest.cu", "sk_overlap": "overlap.cu"}
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
    default 8) or ``xla`` (``fused_quantile``).  ``others`` ({label:
    sk_overlap of another build}) are timed beside the overlap kernel in
    turns."""
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
        extra = {"with_neg": True}
    run = launcher(kernels._entry(entry), *args)
    ms = event_ms(run, inner=KERNEL_INNER)
    plain_ms = event_ms(plain)
    if others:
        extra["compare"] = compare_ms(
            {"this": run, **{k: launcher(f, *args) for k, f in others.items()}})
    return {"ms": ms, "plain_ms": plain_ms, **extra, **bound(bytes_moved, ops, rate)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", type=Path, action="append", default=[], metavar="DIR",
                    help="another tree holding sketches_tpu_torch/csrc (e.g. a git archive of"
                         " the parent commit): time its ingest and overlap kernels beside"
                         " this tree's, in turns; may be repeated")
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
    errs = phase_kernels_vs_plain(device)

    pos = phase_main_path(device, "positive", 0.0, "windowed")
    t_win = time_query(device, pos["facade"], "windowed", rate)
    t_over = time_query(device, pos["facade"], "overlap", rate, others=overlap_others)
    del pos["facade"]
    torch.cuda.empty_cache()
    mixed = phase_main_path(device, "mixed_sign", 0.4, "tiles")
    t_tiles = time_query(device, mixed["facade"], "tiles", rate)
    # lookahead 8 (the default: depth 8 on the 8-step mixed walk) and 4; the
    # kernel caps its ring at 4 slots, so both run the same configuration.
    t_over_mixed = time_query(device, mixed["facade"], "overlap", rate, others=overlap_others)
    t_over_mixed4 = time_query(device, mixed["facade"], "overlap", rate, lookahead=4,
                               others=overlap_others)
    t_full = time_query(device, mixed["facade"], "xla", rate)
    del mixed["facade"]
    torch.cuda.empty_cache()
    t_ingest = time_ingest(device, rate, ingest_others)
    emit("times", card=card["smi"], ingest=t_ingest, windowed=t_win, tiles=t_tiles,
         overlap=t_over, overlap_mixed=t_over_mixed, overlap_mixed_lookahead4=t_over_mixed4,
         fused_quantile=t_full,
         note=f"kernel alone at the main path's shapes, CUDA events, median of 11 runs of"
              f" {KERNEL_INNER} back-to-back launches after warm-up (ingest batches and"
              f" compare: the same, in turns a, b, ..., b, a, mean of the two medians);"
              f" plain versions median of"
              f" 11 single calls; bound = max(bytes/mem rate, f32 ops/67 TFLOP/s); overlap"
              f" on the positive and the mixed final state, fused_quantile on the mixed one")
    torch.cuda.reset_peak_memory_stats(device)
    dist = phase_distributed(device)
    torch.cuda.empty_cache()

    def launched(name):
        return sum(path["launches"][name] for path in (pos, mixed, dist))

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
    # the positive state's; the mixed state's (lookahead 8 and 4) ride beside.
    table[4].update(ms_mixed=t_over_mixed["ms"], plain_ms_mixed=t_over_mixed["plain_ms"],
                    bound_ms_mixed=t_over_mixed["bound_ms"],
                    ms_mixed_lookahead4=t_over_mixed4["ms"])
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

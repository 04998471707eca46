"""The span seam of the port's hot path (``telemetry.call_spans``) and the
host-fetch counters (``kernels.launch_counts``'s ``fetch.*`` keys), on the
CPU.

* Under ``torch.profiler``, a facade chunked over streams exports every
  span of ``add`` and of each query route as a ``user_annotation`` range
  named ``sketches_tpu_torch.<span>``: the chunk spans once per chunk, each
  inside the call's ``ingest_s`` / ``query_s`` range.
* Disarmed and with no profiler recording, no seam reads a clock or enters
  the profiler (both booby-trapped), on every path.
* Armed, each span's histogram takes one observation per call (the chunk
  spans their sum), and a span's ring ``ts`` lies within 1 ms of the
  profiler's range start plus its ``baseTimeNanoseconds``.
* ``fetch.*`` rises by one per plan and by nothing on a steady-state
  ``add``, and resets with the launch counts.
"""

import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import kernels as tk
from sketches_tpu_torch import telemetry as tt
from torch_obs_common import reset_layers
from torch_robust_common import ALPHA, QS, mixed_batches
from torch_worker_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 512
BINS = 512
CHUNKS = 4  # of 128 streams at _CHUNK_ELEMS = 2**16 and 512 bins
P = tt.PROFILER_PREFIX
CHUNK_SPANS = {
    "kernel": ("ingest.slice_s", "ingest.k1_s", "ingest.fold_s", "ingest.copy_back_s"),
    "recenter": ("ingest.slice_s", "ingest.recentre_s", "ingest.copy_back_s"),
    "plain": ("ingest.slice_s", "ingest.copy_back_s"),
}
#: Each query route's disabled tiers and the spans inside its ``query_s``
#: (the ``xla`` floor's kernel is ``batched.quantile`` on the CPU, K2 on the
#: card).
ROUTES = {
    "overlap": ((), ("query.plan_window_s", "query.plan_tiles_s", "query.operands_s",
                     "query.kernel_s")),
    "tiles": (("overlap",), ("query.plan_window_s", "query.plan_tiles_s", "query.operands_s",
                             "query.kernel_s")),
    "windowed": (("overlap", "tiles"), ("query.plan_window_s", "query.operands_s",
                                        "query.kernel_s")),
    "wxla": (("windowed",), ("query.plan_window_s",)),
    "xla": (("windowed", "wxla"), ("query.kernel_s",)),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    reset_layers()
    tk.reset_launch_counts()
    monkeypatch.setattr(tb, "_CHUNK_ELEMS", 1 << 16)
    assert tb._stream_chunk(N, BINS) * CHUNKS == N
    yield
    reset_layers()


def _batches(seed=1, n_batches=2):
    return mixed_batches(N, 128, seed=seed, n_batches=n_batches)


def _facade(engine="auto"):
    return tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=BINS, device="cpu",
                              engine=engine)


def _warm(engine="auto"):
    """A facade past its first (recentring) batch."""
    sk = _facade(engine)
    sk.add(_batches(seed=9, n_batches=1)[0])
    return sk


def _ranges(prof, tmp_path):
    """The exported trace's program ranges, as ``(name, ts, end, base_us)``
    sorted by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    return sorted(
        (e["name"][len(P):], e["ts"], e["ts"] + e["dur"], base_us)
        for e in doc["traceEvents"]
        if e.get("cat") == "user_annotation" and e["name"].startswith(P)
    )


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _check_nesting(ranges, root, n_roots, want):
    roots = [r for r in ranges if r[0] == root]
    assert len(roots) == n_roots
    inner = [r for r in ranges if r[0] != root]
    assert sorted({r[0] for r in inner}) == sorted(want)
    assert all(any(_inside(r, o) for o in roots) for r in inner)
    return inner


# ---------------------------------------------------------------------------
# (a) The profiler's trace names every span
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", sorted(CHUNK_SPANS))
def test_profiled_add_exports_every_ingest_span_once_a_chunk(path, tmp_path):
    sk = _facade() if path == "recenter" else _warm("plain" if path == "plain" else "auto")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sk.add(_batches()[0])
    inner = _check_nesting(_ranges(prof, tmp_path), "ingest_s", 1, CHUNK_SPANS[path])
    for name in CHUNK_SPANS[path]:
        assert sum(r[0] == name for r in inner) == CHUNKS, name


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_profiled_query_exports_every_span_of_its_route(route, tmp_path):
    sk = _warm()
    sk.add(_batches()[0])
    disabled, want = ROUTES[route]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tier, out = sk.get_quantile_values_resolved(QS, disabled_tiers=disabled)
    assert tier == route and out.shape == (N, len(QS))
    inner = _check_nesting(_ranges(prof, tmp_path), "query_s", 1, want)
    assert len(inner) == len(want)  # each once: one plan, one operand build, one kernel


def test_a_raise_out_of_a_profiled_call_closes_its_ranges(tmp_path):
    """A chunk that raises past ``add`` leaves no range open: each closes,
    inside the call's, and the next call's ranges nest as usual."""
    sk = _warm()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError):
            sk.add(np.ones((N, 3, 2), np.float32))  # no [N, S] batch
        sk.add(_batches()[0])
    ranges = _ranges(prof, tmp_path)
    roots = [r for r in ranges if r[0] == "ingest_s"]
    assert len(roots) == 2
    assert all(any(_inside(r, o) for o in roots) for r in ranges if r[0] != "ingest_s")


def test_a_survived_query_fault_unwinds_into_the_next_tier(tmp_path):
    """An armed fault in the overlap tier demotes the query to ``tiles``
    inside one ``query_s`` range; both tiers' spans close inside it."""
    from sketches_tpu_torch import faults

    sk = _warm()
    faults.arm(faults.PALLAS_LOWERING, tier="overlap", times=1)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tier, _ = sk.get_quantile_values_resolved(QS)
    finally:
        faults.disarm()
    assert tier == "tiles"
    inner = _check_nesting(_ranges(prof, tmp_path), "query_s", 1, ROUTES["tiles"][1])
    assert sum(r[0] == "query.kernel_s" for r in inner) == 1


# ---------------------------------------------------------------------------
# (b) Off: no clock, no profiler
# ---------------------------------------------------------------------------


def _booby_trap(monkeypatch):
    def boom(*a, **k):  # pragma: no cover - firing is the failure
        raise AssertionError("a span seam ran while spans were off")

    for mod, name in ((tt, "clock"), (torch.profiler, "record_function"),
                      (torch.ops.profiler, "_record_function_enter_new")):
        monkeypatch.setattr(mod, name, boom)


@pytest.mark.parametrize("path", sorted(CHUNK_SPANS))
def test_disarmed_unprofiled_add_reads_no_clock_and_enters_no_profiler(path, monkeypatch):
    sk = _facade() if path == "recenter" else _warm("plain" if path == "plain" else "auto")
    _booby_trap(monkeypatch)
    sk.add(_batches()[0])
    assert tt.snapshot()["spans"] == {"n_events": 0, "dropped": 0}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_disarmed_unprofiled_query_reads_no_clock_and_enters_no_profiler(route, monkeypatch):
    sk = _warm()
    _booby_trap(monkeypatch)
    tier, _ = sk.get_quantile_values_resolved(QS, disabled_tiers=ROUTES[route][0])
    assert tier == route
    assert tt.snapshot()["histograms"] == {}


def test_call_spans_is_a_shared_no_op_while_off():
    assert tt.call_spans("ingest_s") is tt.call_spans("query_s")
    with tt.call_spans("ingest_s") as sp:
        assert sp is None


# ---------------------------------------------------------------------------
# (c) Armed: one observation a call, the ring on the profiler's clock
# ---------------------------------------------------------------------------


def test_armed_spans_observe_once_a_call_with_the_chunk_sum():
    sk = _warm()
    tt.enable()
    for v in _batches():
        sk.add(v)
        sk.get_quantile_values_resolved(QS)
    snap = tt.snapshot()
    hists = snap["histograms"]
    for name in CHUNK_SPANS["kernel"] + ROUTES["overlap"][1]:
        assert hists[f'{name}{{component="batched"}}']["count"] == 2, name
    assert hists['ingest_s{component="batched",engine="kernel"}']["count"] == 2
    assert hists['query_s{component="batched",tier="overlap"}']["count"] == 2
    # The ring keeps every range: four chunk spans a chunk and the call, an
    # add; four spans and the call, a query.
    assert snap["spans"]["n_events"] == 2 * (CHUNKS * 4 + 1) + 2 * (4 + 1)
    # A chunk span's observation is its chunks' sum: no more than the call.
    for name in CHUNK_SPANS["kernel"]:
        assert hists[f'{name}{{component="batched"}}']["max"] <= (
            hists['ingest_s{component="batched",engine="kernel"}']["max"] * 1.0001)


def test_ring_timestamps_lie_on_the_profilers_clock(tmp_path):
    sk = _warm()
    tt.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sk.add(_batches()[0])
        sk.get_quantile_values_resolved(QS)
    profiled = _ranges(prof, tmp_path)
    ring = sorted((e["name"], e["ts"]) for e in tt.chrome_trace()["traceEvents"]
                  if e.get("ph") == "X")
    assert [name for name, _ in ring] == sorted(r[0] for r in profiled)
    for name in {name for name, _ in ring}:
        mine = sorted(ts for n, ts in ring if n == name)
        theirs = sorted(r[1] + r[3] for r in profiled if r[0] == name)
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1e3, name  # 1 ms, in us


def test_chrome_trace_names_its_timebase():
    doc = tt.chrome_trace()
    assert "Unix epoch" in doc["otherData"]["timebase"]
    assert "baseTimeNanoseconds" in doc["otherData"]["timebase"]


def test_reset_and_enable_re_anchor_the_timebase(monkeypatch):
    tt.reset()
    before = tt._ts_us(tt.clock())
    assert math.isclose(before / 1e6, tt.wall_time(), abs_tol=0.05)
    tt.enable()
    assert math.isclose(tt._ts_us(tt.clock()) / 1e6, tt.wall_time(), abs_tol=0.05)


def test_an_undeclared_span_raises_while_armed():
    from sketches_tpu_torch.resilience import SketchValueError

    tt.enable()
    with pytest.raises(SketchValueError):
        with tt.call_spans("ingest_s") as sp:
            sp.enter("ingest.no_such_s")
            sp.exit()


# ---------------------------------------------------------------------------
# (d) Host fetches
# ---------------------------------------------------------------------------


def _fetches():
    return {k: v for k, v in tk.launch_counts().items() if k.startswith("fetch.")}


def test_fetches_rise_once_a_plan_and_never_on_a_steady_add():
    sk = _warm()
    tk.reset_launch_counts()
    assert set(_fetches().values()) == {0}
    for v in _batches():
        sk.add(v)
    assert set(_fetches().values()) == {0}
    sk.get_quantile_values_resolved(QS)  # overlap: both plans
    assert _fetches()["fetch.window_stats"] == _fetches()["fetch.plan_tile_query"] == 1
    sk.get_quantile_values_resolved(QS)  # plans cached on an unchanged state
    sk.get_quantile_values_resolved(QS, disabled_tiers=("overlap", "tiles"))
    assert sum(_fetches().values()) == 2
    sk.add(_batches(seed=3, n_batches=1)[0])
    sk.get_quantile_values_resolved(QS, disabled_tiers=("overlap", "tiles"))  # window only
    assert _fetches()["fetch.window_stats"] == 2 and _fetches()["fetch.plan_tile_query"] == 1
    tk.reset_launch_counts()
    assert set(_fetches().values()) == {0}


def test_validated_and_policy_adds_count_their_fetches():
    sk = _warm()
    tk.reset_launch_counts()
    v = _batches()[0]
    sk.add_validated(v, np.ones_like(v))
    assert _fetches()["fetch.add_validated"] == 1
    assert sk.maybe_recenter(threshold=0.0)  # lognormal(0, 2) collapses at 512 bins
    sk.add(v)
    assert _fetches()["fetch.add_policy"] == 1
    sk.add(v)
    assert _fetches()["fetch.add_policy"] == 1


def test_telemetry_cli_has_no_bench_gate(capsys):
    for flag in ("--check-bench", "--check-bench-latest", "--bench-snapshot"):
        with pytest.raises(SystemExit) as e:
            tt.main([flag, "a.json", "b.json"])
        assert e.value.code == 2, flag
    assert not hasattr(tt, "check_bench") and not hasattr(tt, "snapshot_from_bench")
    capsys.readouterr()

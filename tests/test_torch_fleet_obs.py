"""The port's fleet observability -- the snapshot merge algebra, the SLO gate,
device-time profiling and the accuracy shadow audit -- against the JAX
package's, on the CPU.

* Merge algebra and SLO gate: the port folds and judges snapshots (its own
  and JAX's) to JAX's **exact** answers; the CLIs give JAX's exit codes.
* Profiling: disarmed, no seam enters the layer; armed, the attribution
  table joins every measured row to a roofline entry at the JAX package's
  audited shapes (128 streams, 256 bins, 128 values, Q = 4), and each
  entry's ``bytes`` equals a hand count of its inputs plus outputs.  (The
  JAX package's roofline walks jaxprs, which its own suite cannot do
  under this JAX; the port counts from its tensors.)
* Accuracy: the splitmix reservoir keeps a **bit-equal** sample, and the
  audit files **equal** ``DriftReport``s (wall clock fixed) on the same
  data: a clean stream, contract-breaking answers, collapse drift, and
  the collapse recommendation (the counterpart of ``tests/test_backends.py``'s
  ``TestCollapseRecommended``).  An ingest fetches only the watched rows.

JAX results are waited for before the port's side runs.
"""

import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from sketches_tpu import accuracy as ja
from sketches_tpu import batched as jb
from sketches_tpu import resilience as jr
from sketches_tpu import telemetry as jt
from sketches_tpu.backends import uniform as JU
from sketches_tpu_torch import accuracy as ta
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import kernels as tk
from sketches_tpu_torch import parallel as tp
from sketches_tpu_torch import profiling as tpf
from sketches_tpu_torch import resilience as tr
from sketches_tpu_torch import telemetry as tt
from sketches_tpu_torch.backends import uniform as TU
from torch_obs_common import reset_layers
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    reset_layers()
    yield
    reset_layers()


# ---------------------------------------------------------------------------
# Merge algebra
# ---------------------------------------------------------------------------


def _snapshot_with(telemetry, durations, counters=(), gauges=()):
    telemetry.enable()
    telemetry.reset()
    for d in durations:
        telemetry.observe("query_s", float(d), component="fleet")
    for name, n in counters:
        telemetry.counter_inc(name, n)
    for name, v in gauges:
        telemetry.gauge_set(name, v)
    snap = telemetry.snapshot()
    telemetry.reset()
    telemetry.disable()
    return snap


def _three(telemetry, seed=7):
    rng = np.random.RandomState(seed)
    return [
        _snapshot_with(telemetry, rng.lognormal(-5, 1, 50),
                       counters=[("wire.blobs_decoded", float(rng.randint(1, 100)))])
        for _ in range(3)
    ]


def test_merge_folds_equal_jax():
    a, b, c = _three(tt)
    ja_, jb_, jc_ = _three(jt)
    assert [a, b, c] == [ja_, jb_, jc_]  # equal snapshots from equal observations
    m = tt.merge_snapshots
    folds = [m(m(a, b), c), m(a, m(b, c)), m(a, b, c), m(c, b, a)]
    jm = jt.merge_snapshots
    want = [jm(jm(a, b), c), jm(a, jm(b, c)), jm(a, b, c), jm(c, b, a)]
    assert folds == want
    for f in folds:
        assert f["merged_from"] == 3
        assert f["counters"] == folds[2]["counters"]
        assert f["histograms"]['query_s{component="fleet"}']["state"] == (
            folds[2]["histograms"]['query_s{component="fleet"}']["state"])


def test_merged_quantiles_match_the_single_process():
    union = np.random.RandomState(3).lognormal(-6, 1.2, 900)
    merged = tt.merge_snapshots(*[_snapshot_with(tt, union[i::3]) for i in range(3)])
    single = _snapshot_with(tt, union)
    series = 'query_s{component="fleet"}'
    mh, sh = merged["histograms"][series], single["histograms"][series]
    assert mh["state"] == sh["state"] and mh["count"] == union.size
    for q, label in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
        assert mh[label] == sh[label]
        exact = np.quantile(union, q, method="lower")
        assert abs(mh[label] - exact) <= 2 * tt.HISTOGRAM_REL_ACC * abs(exact) + 1e-12


def test_gauge_policies_match_jax():
    for telemetry in (jt, tt):
        telemetry.declare("fleet.qps", "gauge", "test", merge="sum")
        telemetry.declare("fleet.oldest", "gauge", "test", merge="min")
    snaps = [_snapshot_with(tt, [], gauges=[("fleet.qps", v), ("fleet.oldest", v),
                                            ("checkpoint.bytes", v)]) for v in (3.0, 5.0)]
    got = tt.merge_snapshots(*snaps)
    assert got == jt.merge_snapshots(*snaps)
    assert got["gauges"] == {"fleet.qps": 8.0, "fleet.oldest": 3.0, "checkpoint.bytes": 5.0}


def test_refusals_match_jax():
    a = _snapshot_with(tt, [0.01])
    b = json.loads(json.dumps(a))
    b["histogram_relative_accuracy"] = 0.05
    stateless = json.loads(json.dumps(a))
    for sm in stateless["histograms"].values():
        sm.pop("state")
    for args in ((a, b), (stateless, stateless), ()):
        with pytest.raises(jr.SketchValueError):
            jt.merge_snapshots(*args)
        with pytest.raises(tr.SketchValueError):
            tt.merge_snapshots(*args)


def test_spans_and_resilience_fold_like_jax():
    tt.enable()
    with tt.span("query_s", component="fleet"):
        pass
    tr.record_downgrade("t.query", "tiles", "windowed", "x")
    snap = tt.snapshot()
    other = json.loads(json.dumps(snap))
    other["resilience"]["tiers"]["t.query"] = "xla"
    for pair in ((snap, snap), (snap, other)):
        assert tt.merge_snapshots(*pair) == jt.merge_snapshots(*pair)
    m = tt.merge_snapshots(snap, other)
    # The span and the downgrade's trace instant, twice.
    assert m["spans"]["n_events"] == 2 * snap["spans"]["n_events"] == 4
    assert set(m["resilience"]["tiers"]["t.query"].split("|")) == {"windowed", "xla"}


def test_merge_cli_matches_jax(tmp_path, capsys):
    paths = []
    for i, s in enumerate(_three(tt, seed=9)):
        p = tmp_path / f"s{i}.json"
        p.write_text(json.dumps(s))
        paths.append(str(p))
    outs = []
    for name, telemetry in (("j", jt), ("t", tt)):
        out = tmp_path / f"{name}.json"
        assert telemetry.main(["--merge", *paths, "--out", str(out)]) == 0
        outs.append(json.loads(out.read_text()))
    capsys.readouterr()
    assert outs[1] == outs[0] and outs[1]["merged_from"] == 3


# ---------------------------------------------------------------------------
# SLO gate
# ---------------------------------------------------------------------------

SLO_CASES = {
    "clean": ([0.001] * 100, [("wire.blobs_decoded", 1000.0), ("wire.blobs_quarantined", 0.0)]),
    "latency_burn": ([0.001] * 90 + [0.9] * 10, []),
    "ratio_burn": ([], [("wire.blobs_decoded", 1000.0), ("wire.blobs_quarantined", 50.0)]),
    "empty": ([], []),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_gate_matches_jax(case, tmp_path, capsys):
    durations, counters = SLO_CASES[case]
    snap = _snapshot_with(tt, durations, counters=counters)
    got = tt.check_slo(snap)
    assert got == jt.check_slo(snap)
    assert got[1] == {"clean": 0, "latency_burn": 1, "ratio_burn": 1, "empty": 0}[case]
    rcs = []
    for name, telemetry in (("j", jt), ("t", tt)):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(snap))
        rcs.append(telemetry.main(["--check-slo", str(p)]))
    capsys.readouterr()
    assert rcs[1] == rcs[0] == {"clean": 0, "latency_burn": 1, "ratio_burn": 1, "empty": 2}[case]
    if rcs[1] == 1:  # a burn dumps a forensic bundle beside the snapshot
        assert json.loads((tmp_path / "t.json.forensics.json").read_text())["reason"] == "slo-burn"


def test_checked_in_and_doctored_bench_snapshots_match_jax(tmp_path, capsys):
    """The checked-in snapshot passes both packages' ``--check-slo``; one the
    JAX package derives from a doctored bench capture burns in both (the
    port has no bench-derived snapshots of its own)."""
    path = os.path.join(ROOT, "SNAPSHOT_bench_r05.json")
    assert tt.main(["--check-slo", path]) == jt.main(["--check-slo", path]) == 0
    with open(os.path.join(ROOT, "BENCH_local_r05.json")) as f:
        bench = json.load(f)
    bench["configs"]["serde_bulk"]["from_bytes_s"] = 500.0
    p = tmp_path / "burning.json"
    p.write_text(json.dumps(jt.snapshot_from_bench(bench)))
    assert tt.main(["--check-slo", str(p)]) == jt.main(["--check-slo", str(p)]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


def _workload(n=128, batches=2):
    spec = tb.SketchSpec(relative_accuracy=0.02, n_bins=256)
    sk = tb.BatchedDDSketch(n, spec=spec, device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(batches):
        sk.add(rng.lognormal(0, 0.5, (n, 128)).astype(np.float32))
    sk.get_quantile_values([0.5, 0.99])
    d = tp.DistributedDDSketch(n, mesh=tp.SketchMesh(2, devices=["cpu"] * 2), spec=spec)
    d.add(rng.lognormal(0, 0.5, (n, 256)).astype(np.float32))
    d.get_quantile_values([0.5])
    return sk


def test_disarmed_profiling_never_enters_the_layer(monkeypatch):
    def bomb(*a, **k):  # pragma: no cover - firing is the failure
        raise AssertionError("profiling.record on a disarmed seam")

    monkeypatch.setattr(tpf, "record", bomb)
    _workload()
    assert tpf.attribution()["measured"] == {}


def _state_bytes(n, b):
    # bins_pos, bins_neg [n, b] f32; zero_count, count, sum, min, max,
    # collapsed_low, collapsed_high, neg_total [n] f32; key_offset, pos_lo,
    # pos_hi, neg_lo, neg_hi [n] int32; tile_sums [n, 2 * b / 128] f32.
    return 2 * n * b * 4 + 8 * n * 4 + 5 * n * 4 + n * (2 * b // 128) * 4


def test_armed_attribution_table_at_the_audited_shapes(monkeypatch):
    def bomb(*a, **k):  # pragma: no cover - CPU tensors need no wait
        raise AssertionError("synchronize on CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", bomb)
    tpf.enable()
    sk = _workload()
    other = tb.BatchedDDSketch(128, spec=sk.spec, device="cpu")
    other.add(np.ones((128, 16), np.float32))
    sk.merge(other)
    att = tpf.attribution()
    measured = att["measured"]
    assert measured["ingest/kernel"]["calls"] == 2 and measured["ingest/kernel"]["total_s"] > 0
    assert measured["ingest/shards"]["calls"] == 1
    assert measured["fold/merge"]["calls"] == 1 and measured["fold/psum"]["calls"] == 1
    assert measured["query/overlap"]["calls"] == 2  # the batched and the distributed query
    roof = att["roofline"]
    assert all("error" not in row and row["flops"] > 0 and row["roofline_s"] > 0
               for row in roof.values()), roof
    # Bytes: each entry's inputs plus outputs at 128 streams x 256 bins,
    # 128 values a stream, Q = 4.
    n, b, s, q = 128, 256, 128, 4
    st = _state_bytes(n, b)
    out_q = n * q * 4 + q * 4  # answers [n, Q] f32 plus the qs operand
    hand = {
        "batched.add": 2 * st + n * s * 4,
        "batched.merge": 3 * st,
        "batched.quantile": st + out_q,
        "kernels.fused_quantile": st + out_q,
        "kernels.fused_quantile_windowed": st + out_q,
        "kernels.fused_quantile_tiles": st + out_q,
        "kernels.fused_quantile_tiles_overlap": st + out_q,
        "kernels.quantile_windowed_xla": st + out_q,
        # values, weights, key_offset in; two histograms and the packed
        # column block out.
        "kernels.ingest_histogram": 2 * n * s * 4 + n * 4 + 2 * n * b * 4
        + n * tk._ncols(b // 128) * 4,
    }
    assert {k: v["bytes"] for k, v in roof.items()} == hand
    assert roof["batched.add"]["flops"] == tpf.INGEST_OPS_PER_VALUE * n * s + 2 * n * b
    rows = {(r["phase"], r["tier"]): r for r in att["attribution"]}
    for key in (("ingest", "kernel"), ("ingest", "shards"), ("fold", "merge"),
                ("fold", "psum"), ("query", "overlap")):
        r = rows[key]
        assert r["entry"] and r["roofline_s"] and r["x_roofline"] == r["mean_s"] / r["roofline_s"]
    assert att["peaks"] == {"flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def test_profiling_rides_snapshot_trace_and_merge():
    tt.enable()
    tpf.enable()
    _workload()
    snap = tt.snapshot()
    assert any(k.startswith("profiling.device_s") for k in snap["histograms"])
    events = tt.chrome_trace()["traceEvents"]
    device = [e for e in events if e.get("pid") == tt.CHROME_PID_DEVICE]
    assert any(e["ph"] == "X" for e in device)
    assert {e["args"]["name"] for e in device if e.get("name") == "thread_name"} >= {
        "tier-kernel", "tier-overlap"}
    merged = tt.merge_snapshots(snap, snap)
    assert merged == jt.merge_snapshots(snap, snap)
    row, m_row = snap["profiling"]["measured"]["ingest/kernel"], (
        merged["profiling"]["measured"]["ingest/kernel"])
    assert m_row["calls"] == 2 * row["calls"]
    assert m_row["total_s"] == pytest.approx(2 * row["total_s"])
    tpf.reset()
    assert tpf.attribution()["measured"] == {}


# ---------------------------------------------------------------------------
# Accuracy audit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap, seed, parts", [(256, 42, 7), (64, 0, 1), (4096, 9, 3), (16, 5, 40)])
def test_reservoir_is_bit_equal_to_jax(cap, seed, parts):
    data = np.random.RandomState(seed).lognormal(0, 1, 20000)
    data[::97] = np.nan
    t, j = ta._Reservoir(cap, seed=seed), ja._Reservoir(cap, seed=seed)
    for chunk in np.array_split(data, parts):
        t.extend(chunk)
        j.extend(chunk)
    assert t.buf == j.buf and t.n == j.n
    assert np.array_equal(t.sorted_sample(), j.sorted_sample())


def _fixed_wall(monkeypatch):
    for telemetry in (jt, tt):
        monkeypatch.setattr(telemetry, "wall_time", lambda: 1700000000.0)


def _reports_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            assert a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b)), f.name


def _audit_both(build, feed, monkeypatch):
    """The same facade and feed in both packages, audited -> the port's and
    JAX's (reports, summary, accuracy counters and gauges)."""
    _fixed_wall(monkeypatch)
    out = []
    for pkg, telemetry, accuracy in (("jax", jt, ja), ("port", tt, ta)):
        telemetry.enable()
        accuracy.enable()
        sk = build(pkg)
        accuracy.watch(sk, "w", **feed["watch"])
        for v in feed["batches"]:
            res = sk.add(v)
            if pkg == "jax":
                jax.block_until_ready(res.state)
        snap = telemetry.snapshot()
        acc = {k: v for k, v in snap["counters"].items() if k.startswith("accuracy.")}
        out.append((accuracy.reports(), accuracy.summary(), acc, snap["gauges"]))
    return out


def test_clean_stream_audits_alike(monkeypatch):
    rng = np.random.RandomState(11)
    batches = [tb_mid(rng.lognormal(0, 0.5, (4, 128))) for _ in range(6)]

    def build(pkg):
        if pkg == "jax":
            return jb.BatchedDDSketch(4, spec=jb.SketchSpec(relative_accuracy=0.02, n_bins=256),
                                      engine="xla")
        return tb.BatchedDDSketch(4, spec=tb.SketchSpec(relative_accuracy=0.02, n_bins=256),
                                  device="cpu", engine="plain")

    (jrep, jsum, jacc, jg), (trep, tsum, tacc, tg) = _audit_both(
        build, {"watch": {"streams": (0, 1), "interval": 2}, "batches": batches}, monkeypatch)
    assert trep == jrep == []
    assert tsum == jsum == {"watched": 1, "audits": 3, "violations": 0, "reports": 0,
                            "reports_dropped": 0}
    assert tacc == jacc
    assert tg.keys() == jg.keys()
    for k in tg:
        assert tg[k] == pytest.approx(jg[k], rel=1e-5, abs=1e-9), k


def tb_mid(v):
    """Values moved to the middle of their bucket at alpha 0.02 (both
    packages key them alike)."""
    g = 1.02 / 0.98
    k = np.ceil(np.log(np.abs(v)) / np.log(g))
    return (np.sign(v) * g ** (k - 0.5)).astype(np.float32)


class LyingSketch:
    """A quantile API that answers 1e6 whatever the data."""

    n_streams = 1
    spec = tb.SketchSpec(relative_accuracy=0.01, n_bins=128)

    def get_quantile_values(self, qs):
        return np.full((1, len(qs)), 1e6, np.float64)


def test_contract_breaking_answers_file_equal_reports(monkeypatch):
    _fixed_wall(monkeypatch)
    data = np.random.RandomState(5).lognormal(0, 0.5, (1, 256))
    got = []
    for telemetry, accuracy in ((jt, ja), (tt, ta)):
        telemetry.enable()
        accuracy.enable()
        liar = LyingSketch()
        accuracy.watch(liar, "liar", streams=(0,), interval=1)
        accuracy.observe_ingest(liar, data)
        got.append((accuracy.reports(), accuracy.summary(),
                    telemetry.snapshot()["counters"]["accuracy.violations"]))
    _reports_equal(got[1][0], got[0][0])
    assert got[1][1:] == got[0][1:]
    assert got[1][1]["violations"] == len(ta.AUDIT_QS)
    assert all(r.kind == "rank-error" and r.rel_err > 1.0 for r in got[1][0])


def test_collapse_drift_files_equal_reports(monkeypatch):
    rng = np.random.RandomState(2)
    wide = tb_mid(10.0 ** rng.uniform(-6, 6, (1, 256)))

    def build(pkg):
        if pkg == "jax":
            return jb.BatchedDDSketch(1, spec=jb.SketchSpec(relative_accuracy=0.02, n_bins=64),
                                      engine="xla")
        return tb.BatchedDDSketch(1, spec=tb.SketchSpec(relative_accuracy=0.02, n_bins=64),
                                  device="cpu", engine="plain")

    feed = {"watch": {"streams": (0,), "interval": 1},
            "batches": [np.full((1, 64), 1.0, np.float32), wide]}
    (jrep, jsum, jacc, _), (trep, tsum, tacc, _) = _audit_both(build, feed, monkeypatch)
    _reports_equal(trep, jrep)
    assert tsum == jsum and tacc == jacc
    drift = [r for r in trep if r.kind == "collapse-drift"]
    assert drift and max(r.collapsed_frac for r in drift) > ta.COLLAPSE_DRIFT


@pytest.mark.parametrize("backend", ["dense", "uniform_collapse"])
def test_collapse_recommendation_matches_jax(backend, monkeypatch):
    """A 64-bin window cannot hold lognormal(0, 4) rows: the audit of a
    dense stream recommends the uniform-collapse backend (counted once per
    crossing); an adaptive stream handles the crossing itself."""
    _fixed_wall(monkeypatch)
    rng = np.random.RandomState(9)
    batches = [rng.lognormal(0, 4.0, (2, 512)).astype(np.float32) for _ in range(3)]
    got = []
    for pkg, telemetry, accuracy in (("jax", jt, ja), ("port", tt, ta)):
        telemetry.enable()
        accuracy.enable()
        if backend == "dense":
            kw = dict(spec=(jb if pkg == "jax" else tb).SketchSpec(relative_accuracy=0.02,
                                                                   n_bins=64),
                      auto_recenter=False)
            sk = (jb.BatchedDDSketch(2, engine="xla", **kw) if pkg == "jax"
                  else tb.BatchedDDSketch(2, device="cpu", engine="plain", **kw))
        else:
            kw = dict(relative_accuracy=0.01, n_bins=128, collapse_threshold=0.3)
            sk = (JU.AdaptiveDDSketch(2, engine="xla", **kw) if pkg == "jax"
                  else TU.AdaptiveDDSketch(2, device="cpu", engine="plain", **kw))
        accuracy.watch(sk, "clamping", streams=(0, 1), interval=1)
        for v in batches:
            sk.add(v)
            accuracy.observe_ingest(sk, np.ones((2, 1), np.float32))
        accuracy.audit_now("clamping")
        counters = telemetry.snapshot()["counters"]
        got.append(({k: v for k, v in counters.items() if k.startswith("accuracy.")},
                    accuracy.summary(), accuracy.reports()))
    assert got[1][:2] == got[0][:2]
    _reports_equal(got[1][2], got[0][2])
    hits = [v for k, v in got[1][0].items() if k.startswith("accuracy.collapse_recommended")]
    assert (sum(hits) >= 1.0) if backend == "dense" else hits == []


def test_ingest_fetches_only_the_watched_rows(monkeypatch):
    fetched = []
    real = ta._host_rows

    def spy(x, idx):
        fetched.append((tuple(x.shape), list(idx)))
        return real(x, idx)

    monkeypatch.setattr(ta, "_host_rows", spy)
    ta.enable()
    sk = tb.BatchedDDSketch(64, relative_accuracy=0.01, n_bins=512, device="cpu")
    ta.watch(sk, "few", streams=(3, 17), interval=2)
    rng = np.random.RandomState(1)
    for _ in range(2):
        sk.add(rng.lognormal(0, 1, (64, 128)).astype(np.float32),
               np.ones((64, 1), np.float32))
    assert ta.summary()["audits"] == 1
    assert fetched and all(idx == [3, 17] for _, idx in fetched)


def test_audit_failure_off_the_card_audits_as_absent():
    class Broken:
        n_streams = 2
        spec = tb.SketchSpec(relative_accuracy=0.01, n_bins=128)
        device = torch.device("cpu")

        def get_quantile_values(self, qs):
            raise RuntimeError("no answer")

    ta.enable()
    b = Broken()
    ta.watch(b, "broken", interval=1)
    ta.observe_ingest(b, np.ones((2, 128)))
    assert ta.summary()["audits"] == 0 and ta.reports() == []


def test_distributed_facade_audits_clean():
    ta.enable()
    d = tp.DistributedDDSketch(32, mesh=tp.SketchMesh(2, devices=["cpu"] * 2),
                               relative_accuracy=0.01, n_bins=512)
    ta.watch(d, "dist", interval=1)
    rng = np.random.RandomState(4)
    for _ in range(2):
        d.add(rng.lognormal(0, 1, (32, 128)).astype(np.float32))
    assert ta.summary() == {"watched": 1, "audits": 2, "violations": 0, "reports": 0,
                            "reports_dropped": 0}


def test_watch_refuses_junk():
    sk = tb.BatchedDDSketch(2, relative_accuracy=0.01, n_bins=128, device="cpu")
    for args, kw in (((object(), "junk"), {}), ((sk, "oob"), {"streams": (99,)}),
                     ((sk, "bad"), {"interval": 0})):
        with pytest.raises(tr.SketchValueError):
            ta.watch(*args, **kw)
    ta.watch(sk, "dup")
    with pytest.raises(tr.SketchValueError):
        ta.watch(sk, "dup")
    ta.unwatch("dup")
    ta.unwatch("never")
    assert ta.summary()["watched"] == 0


def test_disarmed_audit_never_enters_the_layer(monkeypatch):
    def bomb(*a, **k):  # pragma: no cover - firing is the failure
        raise AssertionError("accuracy.observe_ingest on a disarmed seam")

    monkeypatch.setattr(ta, "observe_ingest", bomb)
    _workload()

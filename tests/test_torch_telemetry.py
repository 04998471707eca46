"""The port's telemetry layer (``sketches_tpu_torch.telemetry``) and the seams
that feed it, against the JAX package's, on the CPU.

* Inventories: the declared metrics (names, kinds, merge policies, docs;
  the port's own spans, ``CALL_SPANS``, after JAX's), the SLOs and the four
  layers' public names equal JAX's, but for the JAX package's bench gate
  and the port's span seam (``torch_obs_common``).
* Disarmed, every ported seam reads no clock, never synchronizes, never
  enters the profiler, and records nothing (the clock, ``profiling.record``,
  ``accuracy.observe_ingest``, ``tracing.record_event``,
  ``torch.cuda.synchronize``, ``record_function`` and the profiler's
  range op are booby-trapped while every group of seams runs, and a
  chunked facade, with integrity and a fault site armed).
* The same observations give **equal** histogram bin states and **equal**
  ``prometheus_text`` (exemplars included, under a fixed wall clock and a
  seeded id counter); ``merge_snapshots`` of a JAX and a port snapshot is
  **equal** in both packages.
* ``--check-slo`` passes the checked-in ``SNAPSHOT_bench_r05.json`` and
  ``--merge`` folds it as JAX does.
* Armed, each group of seams (facade, distributed, wire, checkpoint, host
  tier, backends) gives JAX's series names, the port's engine labels
  mapped (``ENGINE_LABELS``).

JAX results are waited for before the port's side runs.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from sketches_tpu import accuracy as ja
from sketches_tpu import batched as jb
from sketches_tpu import checkpoint as jck
from sketches_tpu import faults as jf
from sketches_tpu import integrity as ji
from sketches_tpu import native as jn
from sketches_tpu import parallel as jp
from sketches_tpu import profiling as jpf
from sketches_tpu import telemetry as jt
from sketches_tpu import tracing as jtr
from sketches_tpu.backends import moment as JM
from sketches_tpu.backends import uniform as JU
from sketches_tpu.backends import wirefmt as JW
from sketches_tpu.ddsketch import DDSketch as JDDSketch
from sketches_tpu.pb import wire as jw
from sketches_tpu_torch import accuracy as ta
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import checkpoint as tck
from sketches_tpu_torch import faults as tf
from sketches_tpu_torch import integrity as ti
from sketches_tpu_torch import native as tn
from sketches_tpu_torch import parallel as tp
from sketches_tpu_torch import profiling as tpf
from sketches_tpu_torch import telemetry as tt
from sketches_tpu_torch import tracing as ttr
from sketches_tpu_torch.backends import moment as TM
from sketches_tpu_torch.backends import uniform as TU
from sketches_tpu_torch.backends import wirefmt as TW
from sketches_tpu_torch.ddsketch import DDSketch as TDDSketch
from sketches_tpu_torch.pb import wire as tw
from torch_obs_common import (
    TELEMETRY_JAX_ONLY,
    TELEMETRY_PORT_ONLY,
    arm_telemetry,
    jax_series,
    map_row,
    reset_layers,
)
from torch_robust_common import ALPHA, QS, mixed_batches
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 128
LADDER = ((), ("overlap",), ("overlap", "tiles"), ("windowed",), ("windowed", "wxla"))


@pytest.fixture(autouse=True)
def _clean():
    reset_layers()
    yield
    tn.reset()
    jn.reset()
    reset_layers()


# ---------------------------------------------------------------------------
# Inventories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(jt._DECLARED)), ids=[m.name for m in jt._DECLARED])
def test_metric_inventory_matches_jax(i):
    j, t = jt._DECLARED[i], tt._DECLARED[i]
    assert (t.name, t.kind, t.merge, t.doc) == (j.name, j.kind, j.merge, j.doc)
    assert t.owner == j.owner.replace("sketches_tpu.", "sketches_tpu_torch.")


def test_inventories_have_equal_sizes():
    # JAX's inventory, then the port's own spans, each a histogram.
    extra = tt._DECLARED[len(jt._DECLARED):]
    assert tuple(m.name for m in extra) == tt.CALL_SPANS
    assert {m.kind for m in extra} == {"histogram"}
    assert [dataclasses.asdict(s) for s in tt.SLOS] == [dataclasses.asdict(s) for s in jt.SLOS]


@pytest.mark.parametrize("pair", [(jt, tt), (jtr, ttr), (jpf, tpf), (ja, ta)],
                         ids=["telemetry", "tracing", "profiling", "accuracy"])
def test_public_names_and_constants_match_jax(pair):
    j, t = pair
    if t is tt:
        assert [n for n in t.__all__ if n not in TELEMETRY_PORT_ONLY] == [
            n for n in j.__all__ if n not in TELEMETRY_JAX_ONLY]
    else:
        assert t.__all__ == j.__all__
    for name in j.__all__:
        if t is tt and name in TELEMETRY_JAX_ONLY:
            continue
        assert callable(getattr(t, name)) == callable(getattr(j, name)), name
        # Constants only: the inventories compare above, and the peaks are
        # the card's, not the TPU's.
        if (name.isupper() and not callable(getattr(j, name))
                and name not in ("METRICS", "SLOS") and not name.startswith("PEAK")):
            assert getattr(t, name) == getattr(j, name), name


# ---------------------------------------------------------------------------
# Every ported seam, per group: the same drive in both packages
# ---------------------------------------------------------------------------


def _port_facade(tmp):
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    for v in mixed_batches(N, 128, seed=1):
        t.add(v)
    for dis in LADDER:
        t.get_quantile_values_resolved(QS, disabled_tiers=dis)
    other = tb.BatchedDDSketch(N, spec=t.spec, device="cpu")
    other.add(np.ones((N, 128), np.float32))
    t.merge(other)


def _jax_facade(tmp):
    j = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="pallas")
    for v in mixed_batches(N, 128, seed=1):
        jax.block_until_ready(j.add(v).state)
    for dis in LADDER:
        jax.block_until_ready(j.get_quantile_values_resolved(QS, disabled_tiers=dis)[1])
    other = jb.BatchedDDSketch(N, spec=j.spec, engine="pallas")
    other.add(np.ones((N, 128), np.float32))
    jax.block_until_ready(j.merge(other).state)


# The distributed group runs the plain engines (JAX ``xla``): the kernel
# tiers' series are the facade group's.
def _port_distributed(tmp):
    mesh = tp.SketchMesh(2, devices=["cpu"] * 2)
    d = tp.DistributedDDSketch(N, mesh=mesh, relative_accuracy=ALPHA, n_bins=512, engine="plain")
    e = tp.DistributedDDSketch(N, mesh=mesh, relative_accuracy=ALPHA, n_bins=512, engine="plain")
    for v in mixed_batches(N, 256, seed=2):
        d.add(v)
        e.add(v)
    for dis in ((), ("wxla",)):
        d.get_quantile_values_resolved(QS, disabled_tiers=dis)
    d.merge(e)
    d.reshard(n_devices=1)
    tp.fold_hosts(d.spec, [d.merged_state(), e.merged_state()], reachable=[True, False])


def _jax_distributed(tmp):
    def fleet():
        jm = jp.SketchMesh(2, devices=jax.devices()[:2])
        return jp.DistributedDDSketch(N, mesh=jm, value_axis=jm.value_axis,
                                      stream_axis=jm.stream_axis, relative_accuracy=ALPHA,
                                      n_bins=512, engine="xla")

    d, e = fleet(), fleet()
    for v in mixed_batches(N, 256, seed=2):
        jax.block_until_ready(d.add(v).partials)
        jax.block_until_ready(e.add(v).partials)
    for dis in ((), ("wxla",)):
        jax.block_until_ready(d.get_quantile_values_resolved(QS, disabled_tiers=dis)[1])
    jax.block_until_ready(d.merge(e).partials)
    d.reshard(n_devices=1)
    jp.fold_hosts(d.spec, [d.merged_state(), e.merged_state()], reachable=[True, False])


def _filled(pkg):
    v = mixed_batches(N, 128, seed=3, n_batches=1)[0]
    if pkg == "port":
        sk = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, key_offset=-256,
                                device="cpu", engine="plain")
        return sk.add(v)
    sk = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, key_offset=-256,
                            engine="xla")
    jax.block_until_ready(sk.add(v).state)
    return sk


def _port_wire(tmp):
    sk = _filled("port")
    blobs = tw.state_to_bytes(sk.spec, sk.state)
    tw.bytes_to_state(sk.spec, blobs, device="cpu")
    bad, _ = tf.corrupt_blobs(blobs, 0.1, seed=3)
    tw.bytes_to_state(sk.spec, bad, errors="quarantine", device="cpu")


def _jax_wire(tmp):
    sk = _filled("jax")
    blobs = jw.state_to_bytes(sk.spec, sk.state)
    jax.block_until_ready(jw.bytes_to_state(sk.spec, blobs).bins_pos)
    bad, _ = jf.corrupt_blobs(blobs, 0.1, seed=3)
    jw.bytes_to_state(sk.spec, bad, errors="quarantine")


def _port_checkpoint(tmp):
    sk = _filled("port")
    path = str(tmp / "t.npz")
    tck.save_state(path, sk.spec, sk.state)
    tck.restore_state(path, device="cpu")


def _jax_checkpoint(tmp):
    sk = _filled("jax")
    path = str(tmp / "j.npz")
    jck.save_state(path, sk.spec, sk.state)
    jax.block_until_ready(jck.restore_state(path)[1].bins_pos)


def _host_values():
    return np.random.RandomState(4).lognormal(0, 2, 4096)


def _port_host(tmp):
    tn.reset()
    tn.available()
    sk = TDDSketch(ALPHA, backend="torch", device="cpu")
    sk.add_many(_host_values())
    sk.add(1.5)
    sk.get_quantile_value(0.5)


def _jax_host(tmp):
    jn.reset()
    jn.available()
    sk = JDDSketch(ALPHA, backend="jax")
    sk.add_many(_host_values())
    sk.add(1.5)
    sk.get_quantile_value(0.5)


def _heavy(seed, n=32):
    return np.random.RandomState(seed).lognormal(0, 6, (n, 128)).astype(np.float32)


def _port_backends(tmp):
    a = TU.AdaptiveDDSketch(32, relative_accuracy=ALPHA, n_bins=128, device="cpu", engine="plain")
    for s in (5, 6):
        a.add(_heavy(s))
    TW.payload_from_bytes(a.spec, TW.payload_to_bytes(a.spec, a.state), device="cpu")
    m = TM.MomentDDSketch(8, n_moments=8, device="cpu")
    m.add(_heavy(7, 8))
    m.get_quantile_values([0.5, 0.99])


def _jax_backends(tmp):
    a = JU.AdaptiveDDSketch(32, relative_accuracy=ALPHA, n_bins=128, engine="xla")
    for s in (5, 6):
        a.add(_heavy(s))
    JW.payload_from_bytes(a.spec, JW.payload_to_bytes(a.spec, a.state))
    m = JM.MomentDDSketch(8, n_moments=8)
    m.add(_heavy(7, 8))
    m.get_quantile_values([0.5, 0.99])


GROUPS = {
    "facade": (_port_facade, _jax_facade),
    "distributed": (_port_distributed, _jax_distributed),
    "wire": (_port_wire, _jax_wire),
    "checkpoint": (_port_checkpoint, _jax_checkpoint),
    "host": (_port_host, _jax_host),
    "backends": (_port_backends, _jax_backends),
}


def test_disarmed_seams_read_no_clock_never_synchronize_and_record_nothing(
    monkeypatch, tmp_path
):
    """Every group of seams, disarmed, with the integrity layer and a fault
    site armed (their seams test the telemetry and tracing flags too), and
    a facade chunked over streams, so every span seam of ``add`` runs: a
    clock read, a profiling or accuracy call, a recorder event, a
    synchronize or a profiler range anywhere fails the test."""

    def boom(*a, **k):  # pragma: no cover - firing is the failure
        raise AssertionError("the disarmed observability layer was entered")

    for mod, name in ((tt, "clock"), (tpf, "record"), (ta, "observe_ingest"),
                      (ttr, "record_event"), (torch.cuda, "synchronize"),
                      (torch.profiler, "record_function"),
                      (torch.ops.profiler, "_record_function_enter_new")):
        monkeypatch.setattr(mod, name, boom)
    ti.arm("quarantine")
    tf.arm(tf.PALLAS_LOWERING, tier="overlap", times=1)
    for port, _ in GROUPS.values():
        port(tmp_path)
    monkeypatch.setattr(tb, "_CHUNK_ELEMS", 1 << 16)  # 128-stream chunks at 512 bins
    chunked = tb.BatchedDDSketch(4 * N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    for v in mixed_batches(4 * N, 128, seed=5):
        chunked.add(v)
    for dis in LADDER:
        chunked.get_quantile_values_resolved(QS, disabled_tiers=dis)
    assert ti.reports() == [] and tf.stats()[tf.PALLAS_LOWERING][1] == 1
    snap = tt.snapshot()
    assert snap["counters"] == {} and snap["gauges"] == {} and snap["histograms"] == {}
    assert snap["spans"] == {"n_events": 0, "dropped": 0}
    assert "profiling" not in snap and "accuracy" not in snap and "tracing" not in snap
    assert ttr.events() == [] and ttr.stats()["recorded"] == 0


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_armed_seams_give_jax_series_names(group, tmp_path, monkeypatch):
    port, jax_side = GROUPS[group]
    # The port's K1 computes the stock construction: the JAX side takes
    # its stock rung too (its packed default is a TPU construction).
    monkeypatch.setenv("SKETCHES_TPU_INGEST_PACKED", "0")
    for pkg in ((jt, jpf), (tt, tpf)):
        pkg[0].enable()
        pkg[1].enable()
    jax_side(tmp_path)
    port(tmp_path)
    js, ts = jt.snapshot(), tt.snapshot()
    for section in ("counters", "gauges", "histograms"):
        assert jax_series(ts[section]) == sorted(js[section]), section
    assert sorted(map_row(k) for k in ts["profiling"]["measured"]) == sorted(
        js["profiling"]["measured"])
    if group in ("facade", "wire"):
        # Deterministic counts agree too (the batches, the blobs).
        for k, v in js["counters"].items():
            if not k.startswith("tracing."):
                assert ts["counters"][k] == v, k


# ---------------------------------------------------------------------------
# Bin states, exposition and the cross-package merge
# ---------------------------------------------------------------------------


def _observe_all(telemetry, tracing, durations, seed):
    """The same observations into one package: traced latencies (exemplars),
    counters, a gauge, untraced histogram values."""
    tracing.seed_ids(seed)
    for i, d in enumerate(durations):
        with tracing.use(tracing.new_trace()):
            telemetry.observe("query_s", float(d), component="fleet", tier="overlap")
        telemetry.observe("ingest_s", float(d) * 3.0, component="fleet")
        if i % 7 == 0:
            telemetry.counter_inc("batched.ingest_batches")
    telemetry.counter_inc("wire.blobs_decoded", 1000.0)
    telemetry.counter_inc("wire.blobs_quarantined", 2.0)
    telemetry.gauge_set("checkpoint.bytes", 123456.0)
    telemetry.gauge_set("accuracy.rel_err", 0.004, stream=3)


def _snapshots(monkeypatch, durations, seed):
    for t in (jt, tt):
        monkeypatch.setattr(t, "wall_time", lambda: 1700000000.25)
    arm_telemetry()
    _observe_all(jt, jtr, durations, seed)
    _observe_all(tt, ttr, durations, seed)
    return jt.snapshot(), tt.snapshot(), jt.prometheus_text(), tt.prometheus_text()


def _durations(seed, n=400):
    return np.random.RandomState(seed).lognormal(-5.0, 1.2, n)


def test_equal_observations_give_equal_bins_and_exposition(monkeypatch):
    js, ts, jtext, ttext = _snapshots(monkeypatch, _durations(11), seed=3)
    assert ts["histograms"] == js["histograms"]
    for k, h in ts["histograms"].items():
        assert h["state"] == js["histograms"][k]["state"], k
    assert ts["counters"] == js["counters"] and ts["gauges"] == js["gauges"]
    assert ttext == jtext
    assert "# {trace_id=" in ttext  # the exemplar annotations are compared too


def test_cross_package_merge_is_equal(monkeypatch):
    js, _, _, _ = _snapshots(monkeypatch, _durations(12), seed=4)
    reset_layers()
    _, ts, _, _ = _snapshots(monkeypatch, _durations(13, 250), seed=5)
    for a, b in ((js, ts), (ts, js)):
        assert tt.merge_snapshots(a, b) == jt.merge_snapshots(a, b)
    merged = tt.merge_snapshots(js, ts, ts)
    assert merged == jt.merge_snapshots(js, ts, ts)
    assert merged["merged_from"] == 3
    assert merged["counters"]["batched.ingest_batches"] == (
        js["counters"]["batched.ingest_batches"] + 2 * ts["counters"]["batched.ingest_batches"])


# ---------------------------------------------------------------------------
# The checked-in snapshot through the CLI
# ---------------------------------------------------------------------------


def test_bench_snapshot_regenerates_the_checked_in_fixture(tmp_path, capsys):
    """The checked-in SLO fixture (made by the JAX package's
    ``--bench-snapshot``) passes the port's ``--check-slo``, and the port's
    ``--merge`` folds it as the JAX package does."""
    path = os.path.join(ROOT, "SNAPSHOT_bench_r05.json")
    with open(path) as f:
        checked_in = json.load(f)
    assert tt.main(["--check-slo", path]) == jt.main(["--check-slo", path]) == 0
    merged = tmp_path / "merged.json"
    assert tt.main(["--merge", path, path, "--out", str(merged)]) == 0
    with open(merged) as f:
        assert json.load(f) == jt.merge_snapshots(checked_in, checked_in)

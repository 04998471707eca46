"""The port's request tracing and flight recorder (``sketches_tpu_torch.tracing``)
against the JAX package's, on the CPU.

* Ids are **bit-equal** for a seed: ``splitmix64``, ``seed_ids``,
  ``new_trace`` and ``child_span`` mint the same 64-bit ids in both.
* An armed ladder walk (two ingests, then ``pallas.lowering`` armed on
  every kernel tier, under one root trace) records the **same events**
  in the same order -- kind, ids, sequence numbers and fields, the port's
  engine labels mapped -- with both recorders and both telemetry clocks on
  one fixed virtual time.  (The JAX facade runs its Pallas kernels in
  interpret mode on its stock construction; the port's, their plain
  versions.)
* ``dump_forensics`` / ``explain`` give equal lines; the CLIs give equal
  exit codes and output.
* The recorder ring bounds, drops and trims alike.

The serve-driven cases of ``tests/test_tracing.py`` wait for the port of
the serving tier.
"""

import json

import jax
import numpy as np
import pytest

from sketches_tpu import batched as jb
from sketches_tpu import faults as jf
from sketches_tpu import resilience as jr
from sketches_tpu import telemetry as jt
from sketches_tpu import tracing as jtr
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import faults as tf
from sketches_tpu_torch import resilience as tr
from sketches_tpu_torch import telemetry as tt
from sketches_tpu_torch import tracing as ttr
from torch_obs_common import ENGINE_LABELS, arm_telemetry, reset_layers
from torch_robust_common import ALPHA, QS, mixed_batches

N = 128
FLOOR_PLAN = {"tier": ("overlap", "tiles", "windowed", "wxla")}


@pytest.fixture(autouse=True)
def _clean():
    reset_layers()
    yield
    reset_layers()


# ---------------------------------------------------------------------------
# Ids
# ---------------------------------------------------------------------------


def test_splitmix64_is_bit_equal():
    xs = np.random.RandomState(0).randint(0, 2**63, size=256, dtype=np.int64).tolist()
    xs += [0, 1, 2**64 - 1, 0x9E3779B97F4A7C15]
    assert [ttr.splitmix64(x) for x in xs] == [jtr.splitmix64(x) for x in xs]


def _mint(tracing, seed):
    tracing.seed_ids(seed)
    out = []
    for i in range(12):
        root = tracing.new_trace()
        child = tracing.child_span(root)
        grand = tracing.child_span(child if i % 2 else None)
        out += [root.ids(), child.ids(), grand.ids(),
                (root.trace_id, root.span_id, child.parent_id)]
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 2**40 + 3, 2**64 - 1])
def test_seeded_ids_are_bit_equal(seed):
    assert _mint(ttr, seed) == _mint(jtr, seed)
    assert ttr.last_trace() == jtr.last_trace() or (
        ttr.last_trace().ids() == jtr.last_trace().ids())


def test_contexts_bind_alike():
    ttr.seed_ids(3)
    ctx = ttr.new_trace()
    with pytest.raises(RuntimeError):
        with ttr.use(ctx):
            assert ttr.current() is ctx
            raise RuntimeError("boom")
    assert ttr.current() is None
    token = ttr.bind(ctx)
    assert ttr.current() is ctx
    ttr.unbind(token)
    assert ttr.current() is None


# ---------------------------------------------------------------------------
# The armed ladder walk, event for event
# ---------------------------------------------------------------------------


def _freeze_clocks(monkeypatch):
    for telemetry, tracing in ((jt, jtr), (tt, ttr)):
        monkeypatch.setattr(telemetry, "clock", lambda: 5.0)
        monkeypatch.setattr(telemetry, "wall_time", lambda: 1700000000.5)
        tracing.configure(clock=lambda: 5.0)


def _walk(monkeypatch):
    """Two ingests and a query with every kernel tier armed to fail, under
    one root trace, in both packages -> (JAX events, port events)."""
    monkeypatch.setenv("SKETCHES_TPU_INGEST_PACKED", "0")
    _freeze_clocks(monkeypatch)
    arm_telemetry()
    j = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="pallas")
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    out = []
    for tracing, faults, sk, wait in ((jtr, jf, j, jax.block_until_ready),
                                      (ttr, tf, t, lambda x: x)):
        tracing.seed_ids(11)
        with tracing.use(tracing.new_trace()):
            for v in mixed_batches(N, 128, seed=21):
                wait(sk.add(v).state)
            faults.arm(faults.PALLAS_LOWERING, **FLOOR_PLAN)
            tier, vals = sk.get_quantile_values_resolved(QS)
            wait(vals)
            faults.disarm()
        assert tier == "xla"
        out.append(tracing.events())
    return out


def _mapped(events):
    return [{k: (ENGINE_LABELS.get(v, v) if k == "engine" else v) for k, v in e.items()}
            for e in events]


def test_armed_ladder_walk_records_the_same_events(monkeypatch):
    jev, tev = _walk(monkeypatch)
    assert [e["kind"] for e in tev] == [e["kind"] for e in jev]
    assert _mapped(tev) == jev
    kinds = [e["kind"] for e in tev]
    assert kinds.count("fault.injected") == kinds.count("resilience.downgrade") == 4
    assert {e["trace_id"] for e in tev} == {tev[0]["trace_id"]}
    assert tr.health()["downgrades"][-1]["to_tier"] == jr.health()["downgrades"][-1]["to_tier"]


def test_forensics_explain_and_cli_match_jax(monkeypatch, tmp_path, capsys):
    _walk(monkeypatch)
    paths = {}
    for name, tracing in (("jax", jtr), ("port", ttr)):
        paths[name] = tmp_path / f"{name}.json"
        bundle = tracing.dump_forensics("walk", path=str(paths[name]))
        lines, n = tracing.explain(bundle, "trigger")
        paths[name + "_lines"] = (lines, n)
    lines, n = paths["port_lines"]
    mapped = [line.replace("engine=kernel", "engine=pallas") for line in lines]
    assert (mapped, n) == paths["jax_lines"]
    assert n >= 2 and "this is the triggering trace" in lines[0]
    bundle = json.loads(paths["port"].read_text())
    assert bundle["format"] == "sketches_tpu.forensics/1"
    assert bundle["health"]["downgrades"] and bundle["telemetry"]["counters"]
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    for args in (["--explain", "{b}", "trigger"], ["--explain", "{b}", "deadbeefdeadbeef"],
                 ["--explain", str(tmp_path / "missing.json"), "trigger"],
                 ["--explain", str(bad), "trigger"], []):
        got = []
        for name, tracing in (("jax", jtr), ("port", ttr)):
            rc = tracing.main([a.replace("{b}", str(paths[name])) for a in args])
            out = capsys.readouterr().out.replace(str(paths[name]), "B")
            got.append((rc, out.replace("engine=kernel", "engine=pallas")))
        assert got[1][0] == got[0][0], args
        if args and "missing" not in args[1]:
            assert got[1][1] == got[0][1], args


def test_explain_on_unknown_traces_and_malformed_bundles():
    for tracing, err in ((jtr, jr.SketchValueError), (ttr, tr.SketchValueError)):
        bundle = tracing.dump_forensics("empty")
        lines, n = tracing.explain(bundle, "deadbeefdeadbeef")
        assert n == 0 and len(lines) == 2
        with pytest.raises(err):
            tracing.explain({"not": "a bundle"}, "0")


def test_exemplars_cli_matches_jax(monkeypatch, tmp_path, capsys):
    _freeze_clocks(monkeypatch)
    arm_telemetry()
    outs = []
    for telemetry, tracing in ((jt, jtr), (tt, ttr)):
        tracing.seed_ids(13)
        for d in (0.25, 0.5, 0.125):
            telemetry.observe("query_s", d, trace=tracing.new_trace())
        snap = tmp_path / "snap.json"
        snap.write_text(json.dumps(telemetry.snapshot()))
        rcs = [tracing.main(["--exemplars", str(snap), "query_s", "--q", "0.5"]),
               tracing.main(["--exemplars", str(snap), "no.such_s"])]
        outs.append((rcs, capsys.readouterr().out))
    assert outs[1] == outs[0]
    assert outs[1][0] == [0, 2]


# ---------------------------------------------------------------------------
# The recorder ring
# ---------------------------------------------------------------------------


def _ring(tracing):
    tracing.enable(True)
    ticks = iter(np.arange(1000) * 1e-3)
    tracing.configure(capacity=8, clock=lambda: float(next(ticks)))
    for i in range(20):
        tracing.record_event("tick", i=i, label=f"e{i}")
    first = (tracing.events(), tracing.stats())
    tracing.configure(capacity=4)
    return first, (tracing.events(), tracing.stats())


def test_recorder_ring_bounds_and_trims_alike():
    got, want = _ring(ttr), _ring(jtr)
    assert got == want
    (evs, st), (trimmed, st2) = got
    assert [e["i"] for e in evs] == list(range(12, 20)) and st["dropped"] == 12
    assert [e["i"] for e in trimmed] == [16, 17, 18, 19] and st2["dropped"] == 16
    with pytest.raises(tr.SketchValueError):
        ttr.configure(capacity=0)


def test_recorder_follows_telemetry_and_its_kill_switch(monkeypatch):
    tt.enable()
    assert ttr.enabled()
    tt.disable()
    assert not ttr.enabled()
    monkeypatch.setattr(ttr, "_KILL", False)
    tt.enable()
    assert not ttr.enabled()

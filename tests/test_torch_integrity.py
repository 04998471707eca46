"""The port's integrity layer (``sketches_tpu_torch.integrity``) against the
JAX package's, on the CPU, and every guarded seam of the port.

Tolerances, with their reasons:

* **Exact (bit for bit)** for fingerprints of states built from the same
  numpy leaves (``convert``) and of mid-bucket unit-weight ingests: both
  packages fetch the same f32/int32 arrays to the host and run the same
  numpy code, so the f64 sums are taken in the same order.
* **Exact** for check reports (stream, invariant, detail), for ``repair``
  results, and for states and answers with the layer armed against the
  same run disarmed (checks read, never write).
* The seams' own comparisons use the JAX package's tolerances
  (``_FP_RTOL`` 1e-5 / ``_FP_ATOL`` 1e-3 for fingerprints, ``_RTOL`` 1e-4 /
  ``_ATOL`` 1e-2 for float counters).
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketches_tpu import batched as jb
from sketches_tpu import checkpoint as jc
from sketches_tpu import integrity as ji
from sketches_tpu import resilience as jr
from sketches_tpu.backends import moment as JM
from sketches_tpu.backends import uniform as JU
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import checkpoint as tc
from sketches_tpu_torch import convert
from sketches_tpu_torch import ddsketch as td
from sketches_tpu_torch import faults as tf
from sketches_tpu_torch import integrity as ti
from sketches_tpu_torch import native as tn
from sketches_tpu_torch import parallel as tp
from sketches_tpu_torch import resilience as tr
from sketches_tpu_torch.backends import moment as TM
from sketches_tpu_torch.backends import uniform as TU
from sketches_tpu_torch.pb import wire as tw
from torch_robust_common import ALPHA, QS, mixed_batches, reset_both
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

N_BINS = 256


@pytest.fixture(autouse=True)
def _clean():
    reset_both()
    yield
    reset_both()


# ---------------------------------------------------------------------------
# States from one set of numpy leaves
# ---------------------------------------------------------------------------


def _leaves(seed, n=24, n_bins=N_BINS, k=None, int_bins=False, margin=0):
    """Consistent dense leaves (``[k, n, ...]`` when ``k``): random integer
    masses around a per-stream window (none within ``margin`` bins of its
    edges), stream 0 empty."""
    r = np.random.RandomState(seed)
    shape = (n,) if k is None else (k, n)
    bd = np.int32 if int_bins else np.float32
    inside = np.zeros(n_bins, bool)
    inside[margin:n_bins - margin] = True
    bp = (r.randint(0, 6, shape + (n_bins,)) * (r.rand(*shape, n_bins) < 0.3) * inside).astype(bd)
    bn = (r.randint(0, 6, shape + (n_bins,)) * (r.rand(*shape, n_bins) < 0.1) * inside).astype(bd)
    zero = r.randint(0, 3, shape).astype(bd)
    bp[..., 0, :] = 0
    bn[..., 0, :] = 0
    zero[..., 0] = 0
    count = (bp.sum(-1) + bn.sum(-1) + zero).astype(bd)
    empty = count == 0
    vmax = np.where(empty, -np.inf, r.uniform(1, 50, shape)).astype(np.float32)
    vmin = np.where(empty, np.inf, -r.uniform(1, 50, shape)).astype(np.float32)
    total = np.where(empty, 0, r.uniform(-1, 1, shape) * count).astype(np.float32)
    rows = (-1, n_bins)
    plo, phi = (x.reshape(shape) for x in tb.occupied_bounds_np(bp.reshape(rows)))
    nlo, nhi = (x.reshape(shape) for x in tb.occupied_bounds_np(bn.reshape(rows)))
    off = -(n_bins // 2) + r.randint(-30, 30, shape)
    return {
        "bins_pos": bp, "bins_neg": bn, "zero_count": zero, "count": count,
        "sum": total, "min": vmin, "max": vmax,
        "collapsed_low": np.zeros(shape, bd), "collapsed_high": np.zeros(shape, bd),
        "key_offset": off.astype(np.int32),
        "pos_lo": plo.astype(np.int32), "pos_hi": phi.astype(np.int32),
        "neg_lo": nlo.astype(np.int32), "neg_hi": nhi.astype(np.int32),
        "neg_total": bn.sum(-1).astype(bd),
        "tile_sums": tb.tile_sums_np(bp.reshape(rows), bn.reshape(rows)).astype(bd).reshape(
            shape + (-1,)),
    }


def _specs(int_bins=False, **kw):
    kw = dict(relative_accuracy=ALPHA, n_bins=N_BINS, **kw)
    if int_bins:
        return jb.SketchSpec(**kw, bin_dtype=jnp.int32), tb.SketchSpec(**kw, bin_dtype=torch.int32)
    return jb.SketchSpec(**kw), tb.SketchSpec(**kw)


def _pair(leaves, tspec):
    return (jb.SketchState(**{f: jnp.asarray(a) for f, a in leaves.items()}),
            convert.state_from_numpy(tspec, leaves, device="cpu"))


def _moment_leaves(seed, n=24, k=6):
    r = np.random.RandomState(seed)
    count = r.randint(1, 100, n).astype(np.float32)
    return {
        "count": count, "zero_count": np.floor(count * 0.1).astype(np.float32),
        "neg_count": np.floor(count * 0.3).astype(np.float32),
        "sum": r.normal(0, 10, n).astype(np.float32),
        "min": -r.uniform(1, 9, n).astype(np.float32), "max": r.uniform(1, 9, n).astype(np.float32),
        "powers": r.normal(0, 1e3, (n, k)).astype(np.float32),
        "log_powers": r.normal(0, 10, (n, k)).astype(np.float32),
    }


def _bits(x):
    return np.asarray(x, np.float64).view(np.uint64)


# ---------------------------------------------------------------------------
# Fingerprints: bit-equal to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int_bins", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_and_stacked_fingerprints_bit_equal(seed, int_bins):
    jspec, tspec = _specs(int_bins)
    for k in (None, 3):
        js, ts = _pair(_leaves(seed, k=k, int_bins=int_bins), tspec)
        got, want = ti.fingerprint(tspec, ts), ji.fingerprint(jspec, js)
        assert got.shape == want.shape == ((24,) if k is None else (3, 24))
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [3, 4])
def test_adaptive_and_moment_fingerprints_bit_equal(seed):
    jspec, tspec = _specs(backend="uniform_collapse", max_collapses=3)
    leaves = _leaves(seed)
    level = np.random.RandomState(seed).randint(0, 4, 24).astype(np.int32)
    jbase, tbase = _pair(leaves, tspec)
    ja = JU.AdaptiveState(base=jbase, level=jnp.asarray(level))
    ta = convert.adaptive_from_numpy(tspec, {**leaves, "level": level}, device="cpu")
    np.testing.assert_array_equal(_bits(ti.fingerprint(tspec, ta)), _bits(ji.fingerprint(jspec, ja)))
    mj, mt = _specs(backend="moment", n_moments=6)
    ml = _moment_leaves(seed)
    jm = JM.MomentState(**{f: jnp.asarray(a) for f, a in ml.items()})
    tm = convert.moment_from_numpy(mt, ml, device="cpu")
    np.testing.assert_array_equal(_bits(ti.fingerprint(mt, tm)), _bits(ji.fingerprint(mj, jm)))


def test_ingested_state_fingerprints_bit_equal():
    """Mid-bucket unit-weight ingests give equal states in both packages,
    hence bit-equal fingerprints (weighted bins agree only to rtol 1e-5)."""
    n = 256
    j = jb.BatchedDDSketch(n, relative_accuracy=ALPHA, n_bins=512, engine="xla")
    t = tb.BatchedDDSketch(n, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    for v in mixed_batches(n, 128, seed=21):
        jax.block_until_ready(j.add(v).state)
        t.add(v)
    np.testing.assert_array_equal(_bits(ti.fingerprint(t.spec, t.state)),
                                  _bits(ji.fingerprint(j.spec, j.state)))


def test_host_fingerprints_bit_equal():
    from sketches_tpu import ddsketch as jd

    r = np.random.RandomState(5)
    v = r.lognormal(0, 2, 5000) * np.where(r.rand(5000) < 0.3, -1, 1)
    a, b = td.DDSketch(0.02), jd.DDSketch(0.02)
    for x in np.concatenate([v, [0.0, 0.0]]):
        a.add(float(x))
        b.add(float(x))
    assert _bits(ti.fingerprint_host(a)) == _bits(ji.fingerprint_host(b))
    assert ti.fingerprint_host(td.DDSketch(0.02)) == 0.0


def test_fingerprint_is_additive_and_recenter_free():
    _, tspec = _specs()
    la, lb = _leaves(6, margin=8), _leaves(7, margin=8)
    a = convert.state_from_numpy(tspec, la, device="cpu")
    b = convert.state_from_numpy(tspec, {**lb, "key_offset": la["key_offset"]}, device="cpu")
    merged = tb.merge_aligned(tspec, a, b)
    np.testing.assert_allclose(ti.fingerprint(tspec, merged),
                               ti.fingerprint(tspec, a) + ti.fingerprint(tspec, b),
                               rtol=ti._FP_RTOL, atol=ti._FP_ATOL)
    moved = tb.recenter(tspec, a, a.key_offset - 3)
    np.testing.assert_allclose(ti.fingerprint(tspec, moved), ti.fingerprint(tspec, a),
                               rtol=ti._FP_RTOL, atol=ti._FP_ATOL)


# ---------------------------------------------------------------------------
# The checker and repair: the same findings and fixes as the JAX package
# ---------------------------------------------------------------------------


def _corrupted(leaves, n_bins=N_BINS):
    c = {f: a.copy() for f, a in leaves.items()}
    c["bins_pos"][1, 5] = -3
    c["bins_neg"][2, 7] = np.nan if c["bins_neg"].dtype.kind == "f" else -1
    c["count"][3] += 7
    c["neg_total"][4] += 5
    c["tile_sums"][5, 0] += 9
    c["pos_lo"][6] = n_bins + 3
    c["sum"][7] = 1e30
    c["sum"][0] = 5.0  # stream 0 is empty
    c["zero_count"][9] = -2
    c["collapsed_low"][10] = -1
    return c


@pytest.mark.parametrize("int_bins", [False, True])
def test_corruption_classes_caught_like_jax(int_bins):
    jspec, tspec = _specs(int_bins)
    js, ts = _pair(_corrupted(_leaves(8, int_bins=int_bins)), tspec)
    got, want = ti.check_state(tspec, ts, seam="s"), ji.check_state(jspec, js, seam="s")
    assert got.violations == [ti.IntegrityViolation(v.stream, v.invariant, v.detail)
                              for v in want.violations]
    assert got.n_violations == want.n_violations and got.indices == want.indices
    assert set(got.counters) >= {"negative_mass", "mass_conservation", "neg_total",
                                 "tile_sums", "occupied_bounds", "sum_bound", "empty_identity"}
    # Stacked partials index as k * n + stream.
    stacked = {f: np.stack([a, a]) for f, a in _corrupted(_leaves(8, int_bins=int_bins)).items()}
    js2, ts2 = _pair(stacked, tspec)
    assert ti.check_state(tspec, ts2).indices == ji.check_state(jspec, js2).indices
    assert max(ti.check_state(tspec, ts2).indices) >= 24


def test_moment_and_adaptive_invariants_like_jax():
    mj, mt = _specs(backend="moment", n_moments=6)
    ml = _moment_leaves(9)
    ml["count"][2] = -5
    ml["zero_count"][3] = ml["count"][3] + 10
    ml["min"][4], ml["max"][4] = 3.0, -3.0
    got = ti.check_state(mt, convert.moment_from_numpy(mt, ml, device="cpu"))
    want = ji.check_state(mj, JM.MomentState(**{f: jnp.asarray(a) for f, a in ml.items()}))
    assert [(v.stream, v.invariant) for v in got.violations] == [
        (v.stream, v.invariant) for v in want.violations] and got
    jspec, tspec = _specs(backend="uniform_collapse", max_collapses=3)
    leaves = _leaves(10)
    level = np.array([0, -1, 5] + [1] * 21, np.int32)
    jbase, _ = _pair(leaves, tspec)
    got = ti.check_state(tspec, convert.adaptive_from_numpy(tspec, {**leaves, "level": level},
                                                            device="cpu"))
    want = ji.check_state(jspec, JU.AdaptiveState(base=jbase, level=jnp.asarray(level)))
    assert got.violations == [ti.IntegrityViolation(*dataclasses.astuple(v)) for v in want.violations]
    assert got.counters == {"level_nonnegative": 1, "level_cap": 1}


@pytest.mark.parametrize("int_bins", [False, True])
def test_repair_matches_jax(int_bins):
    jspec, tspec = _specs(int_bins)
    js, ts = _pair(_corrupted(_leaves(11, int_bins=int_bins)), tspec)
    fixed, rep = ti.repair(tspec, ts)
    jfixed, jrep = ji.repair(jspec, js)
    assert [(v.stream, v.invariant) for v in rep.violations] == [
        (v.stream, v.invariant) for v in jrep.violations]
    assert rep.n_violations == jrep.n_violations > 0
    for f in tb.LEAVES:
        np.testing.assert_array_equal(getattr(fixed, f).numpy(), np.asarray(getattr(jfixed, f)),
                                      err_msg=f)
        assert getattr(fixed, f).dtype == getattr(ts, f).dtype, f
    assert fixed.device == ts.device
    # Sum clamped but still beyond a repaired count's bound is not among
    # the seeded faults: the repaired state passes the checker.
    assert not ti.check_state(tspec, fixed)
    with pytest.raises(tr.SketchValueError):
        ti.repair(tspec, convert.state_from_numpy(tspec, {f: np.stack([a, a]) for f, a in
                                                          _leaves(11, int_bins=int_bins).items()},
                                                  device="cpu"))


def test_check_dispatch_and_arming():
    _, tspec = _specs()
    assert not ti.enabled() and ti.mode() == "raise"
    ti.arm("quarantine")
    assert ti.enabled() and ti.mode() == "quarantine"
    with pytest.raises(tr.SketchValueError):
        ti.arm("explode")
    ti.disarm()
    sk = tb.BatchedDDSketch(8, spec=tspec, state=convert.state_from_numpy(
        tspec, {f: a[:8] for f, a in _leaves(12).items()}, device="cpu"))
    assert not ti.check(sk)
    h = td.DDSketch(0.02)
    h.add(1.5)
    assert not ti.check(h)
    h._count += 3
    assert ti.check(h).counters == {"mass_conservation": 1}
    t = td.DDSketch(0.02, backend="torch", device="cpu")
    t.add_many(np.arange(1.0, 50.0))
    assert not ti.check(t)
    with pytest.raises(tr.SketchValueError):
        ti.check(object())
    with pytest.raises(tr.IntegrityError) as info:
        ti.verify(h, seam="user", errors="raise")
    assert info.value.report.seam == "user" and ti.reports()[-1] is info.value.report


# ---------------------------------------------------------------------------
# Every guarded seam catches a corrupt operand
# ---------------------------------------------------------------------------


def _batched(seed, n=128):
    sk = tb.BatchedDDSketch(n, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    for v in mixed_batches(n, 128, seed=seed):
        sk.add(v)
    return sk


def _poison(state, stream=3):
    """A copy with one negative bin mass at ``stream``."""
    bins = state.bins_pos.clone()
    bins[..., stream, 10] = -5
    return dataclasses.replace(state, bins_pos=bins)


def _dist(seed, n=128, k=2, n_hosts=1):
    d = tp.DistributedDDSketch(n, mesh=tp.SketchMesh(k, devices=["cpu"] * k, n_hosts=n_hosts),
                               relative_accuracy=ALPHA, n_bins=512)
    for v in mixed_batches(n, 128 * k, seed=seed):
        d.add(v)
    return d


def _seam_batched_merge():
    a, b = _batched(30), _batched(31)
    b.state = _poison(b.state)
    a.merge(b)


def _seam_distributed_fold():
    d = _dist(32)
    d.partials = _poison(d.partials)
    d.merged_state()


def _seam_distributed_query():
    d = _dist(47)
    d.partials = _poison(d.partials)
    d.get_quantile_values(QS)


def _seam_fold_live_partials():
    d = _dist(33)
    tp.fold_live_partials(d.spec, _poison(d.partials), np.ones(2, bool))


def _seam_distributed_merge():
    a, b = _dist(34), _dist(35)
    a.merged_state()
    ti.disarm()  # the fold lane is not under test here
    b.partials = _poison(b.partials)
    b.merged_state()
    ti.arm("raise")
    a.merge(b)


def _seam_reshard():
    d = _dist(36)
    ti.disarm()
    d.partials = _poison(d.partials)
    ti.arm("raise")
    d.reshard(n_devices=1)


def _seam_fold_hosts():
    a, b = _batched(37), _batched(38)
    tp.fold_hosts(a.spec, [a.state, _poison(b.state)])


def _seam_wire_encode():
    sk = _batched(39)
    tw.state_to_bytes(sk.spec, _poison(sk.state))


def _seam_checkpoint_save(tmp_path):
    sk = _batched(40)
    tc.save_state(str(tmp_path / "c.npz"), sk.spec, _poison(sk.state))


def _seam_checkpoint_restore(tmp_path):
    sk = _batched(41)
    path = str(tmp_path / "c.npz")
    tc.save_state(path, sk.spec, sk.state)
    _doctor_fingerprint(path)
    tc.restore_state(path, device="cpu")


def _seam_host_merge():
    a, b = td.DDSketch(0.02), td.DDSketch(0.02)
    a.add(1.0)
    b.add(2.0)
    b._count += 5
    a.merge(b)


def _seam_torch_merge():
    a = td.DDSketch(0.02, backend="torch", device="cpu")
    b = td.DDSketch(0.02, backend="torch", device="cpu")
    a.add_many(np.arange(1.0, 20.0))
    b.add_many(np.arange(3.0, 9.0))
    b._settle()
    b._state = _poison(b._state, stream=0)
    a.merge(b)


def _seam_adaptive_merge():
    a = TU.AdaptiveDDSketch(64, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    b = TU.AdaptiveDDSketch(64, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    for sk, seed in ((a, 42), (b, 43)):
        for v in mixed_batches(64, 128, seed=seed):
            sk.add(v)
    b._inner.state = _poison(b._inner.state)
    a.merge(b)


def _seam_moment_merge():
    spec = tb.SketchSpec(ALPHA, backend="moment", n_moments=6)
    a = TM.MomentDDSketch(24, spec=spec, device="cpu")
    b = TM.MomentDDSketch(24, spec=spec, device="cpu")
    a.add(mixed_batches(24, 64, seed=44)[0])
    b.add(mixed_batches(24, 64, seed=45)[0])
    b._state = dataclasses.replace(b._state, count=b._state.count - 1e6)
    a.merge(b)


SEAMS = {
    "batched.merge": _seam_batched_merge,
    "distributed.fold": _seam_distributed_fold,
    "distributed.query": _seam_distributed_query,
    "fold_live_partials": _seam_fold_live_partials,
    "distributed.merge": _seam_distributed_merge,
    "elastic.reshard": _seam_reshard,
    "fold_hosts": _seam_fold_hosts,
    "wire.encode": _seam_wire_encode,
    "checkpoint.save": _seam_checkpoint_save,
    "checkpoint.restore": _seam_checkpoint_restore,
    "host.merge": _seam_host_merge,
    "jax.merge": _seam_torch_merge,
    "adaptive.merge": _seam_adaptive_merge,
    "moment.merge": _seam_moment_merge,
}


def _run(fn, tmp_path):
    return fn(tmp_path) if fn.__code__.co_argcount else fn()


@pytest.mark.parametrize("seam", sorted(SEAMS))
def test_every_seam_catches_a_corrupt_operand(seam, tmp_path):
    ti.arm("raise")
    with pytest.raises(tr.IntegrityError) as info:
        _run(SEAMS[seam], tmp_path)
    assert info.value.report and tr.health()["counters"]["integrity.violations"] >= 1
    ti.disarm()


@pytest.mark.parametrize("seam", ["batched.merge", "wire.encode", "checkpoint.restore"])
def test_quarantine_mode_records_and_goes_on(seam, tmp_path):
    ti.arm("quarantine")
    _run(SEAMS[seam], tmp_path)
    reps = ti.reports()
    assert reps and all(r for r in reps)
    assert tr.health()["counters"]["integrity.violations"] == sum(r.n_violations for r in reps)
    ti.reset()
    assert ti.reports() == [] and ti.enabled()


def test_wire_decode_seam_checks_the_decoded_state(monkeypatch):
    sk = _batched(46)
    blobs = tw.state_to_bytes(sk.spec, sk.state)
    seen = []
    monkeypatch.setattr(ti, "verify_state", lambda spec, st, seam: seen.append(seam))
    ti.arm("raise")
    tw.bytes_to_state(sk.spec, blobs, device="cpu")
    assert seen == ["wire.decode"]


# ---------------------------------------------------------------------------
# Armed seams change no answers; disarmed seams do no integrity work
# ---------------------------------------------------------------------------


def _workload(tmp_path):
    out = {}
    a, b = _batched(50), _batched(51)
    a.merge(b)
    out["batched"] = a.state
    out["q"] = a.get_quantile_values_resolved(QS)[1]
    d, e = _dist(52), _dist(53)
    d.merge(e)
    out["dist"] = d.merged_state()
    out["dq"] = d.get_quantile_values(QS)
    new, rep = d.reshard(n_devices=1)
    out["reshard"] = new.merged_state()
    out["folded"], _ = tp.fold_hosts(a.spec, [a.state, b.state])
    blobs = tw.state_to_bytes(a.spec, a.state)
    out["wire"] = tw.bytes_to_state(a.spec, blobs, device="cpu")
    path = str(tmp_path / f"w{ti.enabled()}.npz")
    tc.save_state(path, a.spec, a.state)
    out["ckpt"] = tc.restore_state(path, device="cpu")[1]
    h1, h2 = td.DDSketch(0.02), td.DDSketch(0.02)
    h1.add(1.0)
    h2.add(2.0)
    h1.merge(h2)
    t1 = td.DDSketch(0.02, backend="torch", device="cpu")
    t2 = td.DDSketch(0.02, backend="torch", device="cpu")
    t1.add_many(np.arange(1.0, 30.0))
    t2.add_many(np.arange(2.0, 9.0))
    t1.merge(t2)
    out["host"] = (h1.count, t1.get_quantile_value(0.5))
    return out, rep


def test_armed_seams_change_no_answers(tmp_path):
    plain, rep0 = _workload(tmp_path)
    ti.arm("raise")
    armed, rep1 = _workload(tmp_path)
    ti.disarm()
    assert rep0.fingerprints_match is None and rep1.fingerprints_match is True
    for k, v in plain.items():
        if isinstance(v, tb.SketchState):
            for f in tb.LEAVES:
                assert torch.equal(getattr(v, f), getattr(armed[k], f)), (k, f)
        elif isinstance(v, torch.Tensor):
            assert torch.equal(v.nan_to_num(), armed[k].nan_to_num()), k
        else:
            assert v == armed[k], k
    assert ti.reports() == []


def test_disarmed_seams_do_no_integrity_work(monkeypatch, tmp_path):
    """Booby-trap every integrity entry point the guarded seams call; one
    call anywhere on a disarmed dispatch fails the test."""

    def boom(*a, **k):  # pragma: no cover - firing is the failure
        raise AssertionError("integrity work on the disarmed path")

    for name in ("check", "check_state", "check_host", "verify", "verify_state",
                 "verify_fold", "verify_reshard", "verify_restore", "verify_moment_merge",
                 "premerge", "postmerge", "fingerprint", "fingerprint_host",
                 "_fingerprint_arrays", "_fingerprint_moment", "_host"):
        monkeypatch.setattr(ti, name, boom)
    _workload(tmp_path)  # add, query, merges, folds, reshard, wire, checkpoint, host tier
    d = _dist(54)
    d.merge_partial()
    a = TU.AdaptiveDDSketch(16, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    a.add(mixed_batches(16, 128, seed=55)[0])
    a.merge(a)
    spec = tb.SketchSpec(ALPHA, backend="moment", n_moments=6)
    m = TM.MomentDDSketch(8, spec=spec, device="cpu")
    m.add(mixed_batches(8, 64, seed=56)[0])
    m.merge(m)
    TM.fold_hosts(spec, [m.state, m.state])


# ---------------------------------------------------------------------------
# Closure: every fault site the port wires has a detector
# ---------------------------------------------------------------------------


def _detect_native_load():
    tf.arm(tf.NATIVE_LOAD)
    tn.reset()
    try:
        ok = not tn.available()
    finally:
        tf.disarm()
        tn.reset()
    return ok and tr.health()["tiers"].get("native") == "python"


def _detect_pallas_lowering():
    sk = _batched(60)
    tf.arm(tf.PALLAS_LOWERING, times=1)
    tier, _ = sk.get_quantile_values_resolved(QS)
    return tier != "overlap" and tr.health()["tiers"].get("batched.query") == "tiles"


def _detect_pallas_ingest():
    sk = _batched(61)
    tf.arm(tf.PALLAS_INGEST, times=1)
    before = float(sk.state.count.double().sum())
    sk.add(mixed_batches(128, 128, seed=62)[0])
    return (tr.health()["tiers"].get("batched.ingest") == "plain"
            and float(sk.state.count.double().sum()) == before + 128 * 128)


def _detect_pallas_ingest_variant():
    """A non-stock ingest rung that fails degrades to the stock rung
    (ledger-recorded): the kernel path survives and the replayed batch's
    mass is exact.  ``engine="auto"`` takes the kernel path here (K1's
    plain version); ``engine="kernel"`` demands a card."""
    from sketches_tpu_torch import kernels as tk

    spec = tb.SketchSpec(relative_accuracy=0.02, n_bins=128)
    n = tk._BN
    if tk.choose_ingest_engine(spec, weighted=False) == "stock":
        return True  # kill switch pinned the ladder: nothing to degrade
    sk = tb.BatchedDDSketch(n, spec=spec, engine="auto", device="cpu")
    tf.arm(tf.PALLAS_INGEST_VARIANT, times=1)
    try:
        sk.add(np.full((n, tk._BS), 1.0, np.float32))
    finally:
        tf.disarm()
    return (
        tr.health()["tiers"].get("batched.ingest_variant") == "stock"
        and sk._kernel_ingest
        and float(sk.state.count.double().sum()) == float(n * tk._BS)
    )


def _detect_wire_blob():
    sk = _batched(63, n=64)
    blobs = tw.state_to_bytes(sk.spec, sk.state)
    with tf.active({tf.WIRE_BLOB: dict(mode="corrupt", fraction=0.3, seed=9)}) as plans:
        _, report = tw.bytes_to_state(sk.spec, blobs, errors="quarantine", device="cpu")
        fired = plans[tf.WIRE_BLOB].fired
    return fired > 0 and report.n_quarantined == fired


def _detect_checkpoint_write(tmp_path):
    sk = _batched(64, n=16)
    path = str(tmp_path / "t.npz")
    with tf.active({tf.CHECKPOINT_WRITE: dict(mode="truncate", times=1)}):
        tc.save_state(path, sk.spec, sk.state)
    try:
        tc.restore_state(path, device="cpu")
    except tr.CheckpointCorrupt:
        pass
    else:
        return False
    tc.save_state(path, sk.spec, sk.state)
    before = open(path, "rb").read()
    with tf.active({tf.CHECKPOINT_WRITE: dict(times=1)}):
        try:
            tc.save_state(path, sk.spec, _batched(65, n=16).state)
        except tr.InjectedFault:
            pass
    return open(path, "rb").read() == before and not any(
        f.startswith("t.npz.tmp") for f in os.listdir(tmp_path))


def _detect_mesh_shard():
    d = _dist(66, n=32, k=4)
    tf.arm(tf.MESH_SHARD, shards=(0,))
    _, report = d.merge_partial()
    return report.n_dead == 1 and tr.health()["counters"].get("mesh.dead_shards") == 1


def _detect_mesh_host_loss():
    d = _dist(67, n=32, k=4, n_hosts=2)
    tf.arm(tf.MESH_HOST_LOSS, shards=(1,))
    _, report = d.reshard(n_devices=2)
    return report.lost_hosts == (1,) and report.dead_shards == [2, 3] and report.exact


def _detect_dcn_partition():
    a, b = _batched(68, n=32), _batched(69, n=32)
    tf.arm(tf.DCN_PARTITION, shards=(1,))
    folded, report = tp.fold_hosts(a.spec, [a.state, b.state])
    return report.dead_shards == [1] and torch.equal(folded.count, a.state.count)


def _detect_reshard_torn():
    d = _dist(70, n=32)
    before = ti.fingerprint(d.spec, d.merged_state())
    tf.arm(tf.RESHARD_TORN, times=1)
    try:
        d.reshard(n_devices=1)
        return False
    except tr.InjectedFault:
        pass
    return np.array_equal(ti.fingerprint(d.spec, d.merged_state()), before)


def _detect_state_bitflip():
    """Sampled, as the JAX package's detector: every flip is caught by the
    checker or the fingerprint, or leaves the content unchanged within
    ``np.allclose`` (a -0.0 pattern, or a low mantissa bit below the
    documented detection floor)."""
    sk = _batched(71, n=8)
    fp0 = ti.fingerprint(sk.spec, sk.state)
    for seed in range(16):
        tf.arm(tf.STATE_BITFLIP, seed=seed, times=1)
        bad = tf.apply_state_bitflips(sk.state, tf.state_bitflips(8, sk.spec.n_bins))
        tf.disarm()
        if ti.check_state(sk.spec, bad) or not np.allclose(ti.fingerprint(sk.spec, bad), fp0):
            continue
        return (np.allclose(bad.bins_pos.double().numpy(), sk.state.bins_pos.double().numpy())
                and np.allclose(bad.bins_neg.double().numpy(), sk.state.bins_neg.double().numpy()))
    return True


def _server(seed, **cfg):
    from sketches_tpu_torch import serve as ts

    srv = ts.SketchServer(ts.ServeConfig(**cfg), clock=lambda: 0.0)
    srv.add_tenant("a", 8, relative_accuracy=ALPHA, n_bins=128, device="cpu")
    srv.ingest("a", mixed_batches(8, 64, seed=seed)[0])
    return srv


def _detect_serve_straggler():
    srv = _server(72, cache_capacity=0)
    want = srv.tenant("a").get_quantile_values([0.5]).numpy()
    tf.arm(tf.SERVE_STRAGGLER, times=1)
    res = srv.query("a", [0.5])
    return res.hedged and res.tier == "xla" and np.array_equal(res.values, want)


def _detect_serve_cache_poison():
    srv = _server(73)
    want = srv.query("a", [0.9]).values
    tf.arm(tf.SERVE_CACHE_POISON, times=1)
    res = srv.query("a", [0.9])
    return (not res.cached and np.array_equal(res.values, want)
            and srv.stats()["cache_poisoned"] == 1)


def _detect_serve_queue_overflow():
    srv = _server(74)
    tf.arm(tf.SERVE_QUEUE_OVERFLOW, times=1)
    try:
        srv.query("a", [0.5])
    except tr.ServeOverload as e:
        return e.reason == "injected" and srv.stats()["shed"] == 1
    return False


def _ring(seed, steps=8):
    from sketches_tpu_torch import windows as tw

    clk = tw.VirtualClock(0.0)
    w = tw.WindowedSketch(8, relative_accuracy=ALPHA, n_bins=128,
                          config=tw.WindowConfig((5.0, 20.0), (3, 3)), clock=clk, device="cpu")
    for b in mixed_batches(8, 16, seed=seed, n_batches=steps):
        clk.advance(3.0)
        w.add(b)
    return w, clk


def _detect_window_rotate_torn():
    w, clk = _ring(75)
    before = (w.ledger(), w.buckets())
    clk.advance(12.0)
    tf.arm(tf.WINDOW_ROTATE_TORN, times=1)
    try:
        w.add(mixed_batches(8, 16, seed=76)[0])
        return False
    except tr.InjectedFault:
        pass
    return (w.ledger(), w.buckets()) == before and not ti.check_window(w)


def _detect_window_stack_torn():
    w, _ = _ring(77)
    tf.arm(tf.WINDOW_STACK_TORN, times=1)
    w.window_plan(25.0)
    return w._agg_stacks is None and tr.health()["tiers"].get("windows.agg") == "rebuild"


def _detect_window_agg_stale():
    w, _ = _ring(78)
    w.quantile([0.5], window=25.0)
    tf.arm(tf.WINDOW_AGG_STALE, times=1)
    w.window_plan(25.0)
    return ti.check_window(w).counters.get("window_agg", 0) > 0


def _fabric(seed):
    from sketches_tpu_torch import fabric as tfab

    fab = tfab.ServeFabric(tfab.FabricConfig(n_hosts=4, replication=3), clock=lambda: 0.0)
    fab.add_tenant("t", 8, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    # Data inside the spec's window: the replica sync's wire decode keeps
    # it there, so the synced fingerprint matches the primary's.
    fab.ingest("t", np.random.RandomState(seed).lognormal(0, 0.5, (8, 64)).astype(np.float32))
    assert fab.sync("t") == 2
    return fab


def _detect_mesh_partition_heal():
    fab = _fabric(79)
    h = fab.placement("t")[1]
    fab.partition_host(h)
    tf.arm(tf.MESH_PARTITION_HEAL, times=1)
    try:
        fab.heal_partition(h)
        return False
    except tr.InjectedFault:
        pass
    tf.disarm()
    return h not in fab.live_hosts() and fab.heal_partition(h) == 1


def _detect_fabric_replica_stale():
    """Sampled: each armed read corrupts a replica at read time; a flip
    material enough to move the fingerprint is refused, and whatever serves
    answers the primary's values."""
    fab = _fabric(80)
    want = fab.quantile("t", [0.5]).values
    fab.partition_host(fab.placement("t")[0])
    for seed in range(8):
        tf.arm(tf.FABRIC_REPLICA_STALE, seed=seed, times=1)
        res = fab.quantile("t", [0.5])
        tf.disarm()
        if not np.array_equal(res.values, want, equal_nan=True):
            return False
        fab.sync("t")
    return fab.stats()["stale_refusals"] >= 1


DETECTORS = {
    tf.NATIVE_LOAD: _detect_native_load,
    tf.PALLAS_LOWERING: _detect_pallas_lowering,
    tf.PALLAS_INGEST: _detect_pallas_ingest,
    tf.PALLAS_INGEST_VARIANT: _detect_pallas_ingest_variant,
    tf.WIRE_BLOB: _detect_wire_blob,
    tf.CHECKPOINT_WRITE: _detect_checkpoint_write,
    tf.MESH_SHARD: _detect_mesh_shard,
    tf.MESH_HOST_LOSS: _detect_mesh_host_loss,
    tf.DCN_PARTITION: _detect_dcn_partition,
    tf.RESHARD_TORN: _detect_reshard_torn,
    tf.STATE_BITFLIP: _detect_state_bitflip,
    tf.SERVE_STRAGGLER: _detect_serve_straggler,
    tf.SERVE_CACHE_POISON: _detect_serve_cache_poison,
    tf.SERVE_QUEUE_OVERFLOW: _detect_serve_queue_overflow,
    tf.WINDOW_ROTATE_TORN: _detect_window_rotate_torn,
    tf.WINDOW_STACK_TORN: _detect_window_stack_torn,
    tf.WINDOW_AGG_STALE: _detect_window_agg_stale,
    tf.MESH_PARTITION_HEAL: _detect_mesh_partition_heal,
    tf.FABRIC_REPLICA_STALE: _detect_fabric_replica_stale,
}
#: Declared sites with no seam in the port (none left).
NO_SEAM = set()


def test_site_closure_is_complete():
    wired, none = set(DETECTORS), NO_SEAM
    assert not wired & none and wired | none == set(tf.SITES)
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "sketches_tpu_torch")
    # How a seam reads each site: the index-set and coordinate sites
    # through their consumer functions, the others through inject().
    consumers = {
        tf.MESH_SHARD: "dead_shards", tf.MESH_HOST_LOSS: "lost_hosts",
        tf.DCN_PARTITION: "partitioned_hosts", tf.STATE_BITFLIP: "state_bitflips",
        tf.WINDOW_AGG_STALE: "agg_stale_flips", tf.FABRIC_REPLICA_STALE: "replica_stale_flips",
        tf.SERVE_CACHE_POISON: "cache_poison_flip",
    }
    users = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py") and name != "faults.py":
                text = open(os.path.join(dirpath, name)).read()
                for site in tf.SITES:
                    token = consumers.get(site) or next(
                        k for k in tf.__all__ if getattr(tf, k, None) == site)
                    if re.search(rf"\bfaults\.{token}\b", text):
                        users.setdefault(site, []).append(name)
    # Every wired site is read somewhere in the package: state.bitflip by
    # the chaos drivers, every other site at its seam.
    assert set(users) == wired


@pytest.mark.parametrize("site", sorted(DETECTORS))
def test_every_wired_site_is_detected(site, tmp_path):
    assert _run(DETECTORS[site], tmp_path), site


# ---------------------------------------------------------------------------
# Checkpoints with __fingerprint__ across the two packages
# ---------------------------------------------------------------------------


def _doctor_fingerprint(path):
    with np.load(path) as d:
        members = {k: np.asarray(d[k]) for k in d.files}
    members["__fingerprint__"] = members["__fingerprint__"] * 1.5 + 10.0
    np.savez_compressed(path, **members)  # path ends in .npz: written in place


def _jax_backend_state(kind, seed):
    if kind == "dense":
        jspec, tspec = _specs()
        leaves = _leaves(seed)
        return jspec, tspec, _pair(leaves, tspec)[0]
    mj, mt = _specs(backend="moment", n_moments=6)
    ml = _moment_leaves(seed)
    return mj, mt, JM.MomentState(**{f: jnp.asarray(a) for f, a in ml.items()})


@pytest.mark.parametrize("kind", ["dense", "moment"])
def test_armed_checkpoints_verify_across_packages(kind, tmp_path):
    jspec, tspec, jst = _jax_backend_state(kind, 80)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    ji.arm("raise")
    ti.arm("raise")
    jc.save_state(jpath, jspec, jst)
    spec, st = tc.restore_state(jpath, device="cpu")  # verifies __fingerprint__
    tc.save_state(tpath, spec, st)
    jc.restore_state(tpath)  # and the JAX package verifies the port's
    with np.load(jpath) as a, np.load(tpath) as b:
        np.testing.assert_array_equal(_bits(a["__fingerprint__"]), _bits(b["__fingerprint__"]))
    for path in (jpath, tpath):
        _doctor_fingerprint(path)
        with pytest.raises(tr.IntegrityError) as mine:
            tc.restore_state(path, device="cpu")
        with pytest.raises(jr.IntegrityError) as theirs:
            jc.restore_state(path)
        assert (mine.value.report.counters == theirs.value.report.counters
                == {"fingerprint": 24})
    ji.disarm()
    ti.disarm()
    assert tc.restore_state(jpath, device="cpu")  # disarmed: the member is read past


# ---------------------------------------------------------------------------
# The accuracy backends under the integrity layer (the port's counterpart of
# the JAX package's TestIntegrityDispatch and armed adaptive merge)
# ---------------------------------------------------------------------------


def test_adaptive_fingerprint_sensitive_to_level():
    spec = tb.SketchSpec(ALPHA, n_bins=N_BINS, backend="uniform_collapse", max_collapses=3)
    sk = TU.AdaptiveDDSketch(2, spec=spec, device="cpu")
    sk.add(np.ones((2, 16), np.float32))
    fp0 = ti.fingerprint(spec, sk.state)
    sk.collapse()
    fp1 = ti.fingerprint(spec, sk.state)
    assert not np.allclose(fp0, fp1)
    jspec = jb.SketchSpec(ALPHA, n_bins=N_BINS, backend="uniform_collapse", max_collapses=3)
    for st, fp in ((sk.state, fp1),):
        leaves = {f: getattr(st.base, f).numpy() for f in tb.LEAVES}
        js = JU.AdaptiveState(base=jb.SketchState(**{f: jnp.asarray(a) for f, a in leaves.items()}),
                              level=jnp.asarray(st.level.numpy()))
        np.testing.assert_array_equal(_bits(fp), _bits(ji.fingerprint(jspec, js)))


def test_moment_fingerprint_is_merge_additive():
    spec = tb.SketchSpec(ALPHA, backend="moment", n_moments=8)
    r = np.random.RandomState(8)
    a, b = (TM.add(spec, TM.init(spec, 2, "cpu"),
                   torch.from_numpy(r.lognormal(0, 1.0, (2, 128)).astype(np.float32)))
            for _ in range(2))
    fp_sum = ti.fingerprint(spec, a) + ti.fingerprint(spec, b)
    np.testing.assert_allclose(ti.fingerprint(spec, TM.merge(spec, a, b)), fp_sum,
                               rtol=1e-6, atol=1e-3)


def test_moment_checker_and_armed_merge():
    spec = tb.SketchSpec(ALPHA, backend="moment", n_moments=8)
    sk = TM.MomentDDSketch(2, spec=spec, device="cpu")
    sk.add(np.ones((2, 16), np.float32))
    bad = dataclasses.replace(sk.state, count=torch.tensor([-5.0, 16.0]))
    report = ti.check_state(spec, bad, seam="test")
    assert report and any(v.invariant == "count_nonnegative" for v in report.violations)
    ti.arm("raise")
    other = TM.MomentDDSketch(2, spec=spec, device="cpu")
    other.add(2.0 * np.ones((2, 16), np.float32))
    sk.merge(other)  # the additive fingerprint lane passes
    np.testing.assert_array_equal(sk.count.double().numpy(), [32.0, 32.0])


def test_armed_mixed_level_adaptive_merge_verifies():
    """The merge lane fingerprints the level-aligned operands, so a merge
    that collapses one side passes armed."""
    spec = tb.SketchSpec(ALPHA, n_bins=N_BINS, backend="uniform_collapse", max_collapses=3)
    ti.arm("raise")
    a = TU.AdaptiveDDSketch(2, spec=spec, device="cpu")
    b = TU.AdaptiveDDSketch(2, spec=spec, device="cpu")
    r = np.random.RandomState(8)
    a.add(r.lognormal(0, 0.5, (2, 128)).astype(np.float32))
    b.add(r.lognormal(0, 0.5, (2, 128)).astype(np.float32))
    b.collapse()
    a.merge(b)
    assert float(a.count.double().sum()) == 512.0 and int(a.level.min()) == 1
    assert ti.reports() == []

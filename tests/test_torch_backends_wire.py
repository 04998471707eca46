"""The port's ``SketchPayload`` envelope (``sketches_tpu_torch.backends.wirefmt``)
and its checkpoints of the backend states, against the JAX package, on the CPU.

Tolerance: **exact**.  The envelope of a state is the same bytes in both
packages, each package decodes the other's blobs into equal states (dense
sub-blobs decode onto the spec's window in both), the native scanners and
the Python walker decode alike, and a checkpoint written by either package
restores in the other with every leaf bit-identical.  The refusals mirror
the JAX package's (``tests/test_backends.py::TestWire``): the same error
class, on the native scanner's path and on the walker's.

The states are built by the port and handed to the JAX package as numpy
arrays (``convert``), so both sides encode the same state.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketches_tpu import batched as jb
from sketches_tpu import checkpoint as jc
from sketches_tpu import native as jnative
from sketches_tpu.backends import moment as JM
from sketches_tpu.backends import uniform as JU
from sketches_tpu.backends import wirefmt as JW
from sketches_tpu.resilience import WireDecodeError as JWireDecodeError
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import checkpoint as tc
from sketches_tpu_torch import convert, native
from sketches_tpu_torch.backends import moment as TM
from sketches_tpu_torch.backends import uniform as TU
from sketches_tpu_torch.backends import wirefmt as TW
from sketches_tpu_torch.pb import proto as tpb
from sketches_tpu_torch.resilience import CheckpointCorrupt, SpecError, WireDecodeError
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

LEAVES = tb.LEAVES
QS = [0.1, 0.5, 0.9, 0.99]
N = 24


def _specs(backend, **kw):
    kw = dict(relative_accuracy=0.01, backend=backend, **kw)
    if backend == "uniform_collapse":
        kw.setdefault("n_bins", 128)
    return jb.SketchSpec(**kw), tb.SketchSpec(**kw)


def _adaptive(seed=1):
    """A port adaptive facade whose streams collapsed (lognormal(1, 3) at
    128 bins), and the same state as the JAX package's."""
    sj, st = _specs("uniform_collapse", collapse_threshold=0.05)
    r = np.random.RandomState(seed)
    t = TU.AdaptiveDDSketch(N, spec=st, device="cpu")
    v = r.lognormal(1.0, 3.0, (N, 512)) * np.where(r.rand(N, 512) < 0.3, -1, 1)
    t.add(v.astype(np.float32))
    assert int(t.level.min()) >= 1
    return sj, st, t, _to_jax_adaptive(t.state)


def _to_jax_adaptive(a):
    leaves = convert.adaptive_to_numpy(a)
    return JU.AdaptiveState(
        jb.SketchState(**{f: jnp.asarray(leaves[f]) for f in LEAVES}),
        jnp.asarray(leaves["level"]),
    )


def _moment(seed=2, k=10):
    sj, st = _specs("moment", n_moments=k)
    r = np.random.RandomState(seed)
    v = r.lognormal(0, 2.0, (N, 256)).astype(np.float32)
    v[:4] = r.lognormal(0, 6.0, (4, 256)).astype(np.float32)  # saturated power sums
    v[4, :8] = [0.0, np.nan, -3.0, 1e-40, 0.0, -1.5, 2.0, 7.0]
    w = np.where(r.rand(N, 256) < 0.1, 0.0, 1.0).astype(np.float32)
    w[-1] = 0.0  # an empty stream
    t = TM.MomentDDSketch(N, spec=st, device="cpu").add(v, w)
    return sj, st, t, _to_jax_moment(t.state)


def _to_jax_moment(m):
    return JM.MomentState(**{f: jnp.asarray(v) for f, v in convert.moment_to_numpy(m).items()})


def _build(backend):
    return _adaptive() if backend == "uniform_collapse" else _moment()


def _assert_states_equal(got, ref):
    """A port backend state against a JAX one, every leaf bit for bit."""
    if isinstance(got, TU.AdaptiveState):
        np.testing.assert_array_equal(got.level.numpy(), np.asarray(ref.level))
        pairs = [(getattr(got.base, f), getattr(ref.base, f), f) for f in LEAVES]
    else:
        pairs = [(getattr(got, f), getattr(ref, f), f) for f in TM.FIELDS]
    for g, r, f in pairs:
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, f
        np.testing.assert_array_equal(g, r, err_msg=f)


@pytest.fixture(params=["native", "python"])
def decode_tier(request, monkeypatch):
    """The native scanner (built with g++ at first use), or the pure-Python
    walker with ``SKETCHES_TPU_NATIVE=0``.  The switch is the JAX
    package's too, and its engine caches a load made under it: both
    engines load afresh before and after."""
    if request.param == "python":
        monkeypatch.setenv(native.NATIVE_ENV, "0")
    jnative.reset()
    native.reset()
    if request.param == "native":
        assert native.wire_scanner() is not None, native.status()
    else:
        assert native.wire_scanner() is None
    yield request.param
    monkeypatch.delenv(native.NATIVE_ENV, raising=False)
    jnative.reset()
    native.reset()


# ---------------------------------------------------------------------------
# Byte identity and cross decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["uniform_collapse", "moment"])
def test_envelope_bytes_equal_jax_and_each_decodes_the_other(backend):
    sj, st, t, jstate = _build(backend)
    blobs_j = JW.payload_to_bytes(sj, jstate)
    blobs_t = TW.payload_to_bytes(st, t.state)
    assert blobs_t == blobs_j and all(b[:1] == b"\x08" for b in blobs_t)
    ref = jax.block_until_ready(JW.payload_from_bytes(sj, blobs_t))  # JAX reads the port's
    got = TW.payload_from_bytes(st, blobs_j, device="cpu")  # the port reads JAX's
    _assert_states_equal(got, ref)
    assert TW.payload_to_bytes(st, got) == JW.payload_to_bytes(sj, ref)
    if backend == "moment":
        # The moment envelope carries every leaf: an exact round trip.
        _assert_states_equal(got, jstate)
        assert TW.payload_to_bytes(st, got) == blobs_t
    else:
        np.testing.assert_array_equal(got.level.numpy(), t.level.numpy())
        assert torch.equal(got.base.count, t.state.base.count)


def test_adaptive_round_trip_inside_the_window_answers_alike():
    """Streams whose occupied level keys lie inside the spec's window decode
    exactly, so the decoded state re-encodes to the same bytes and answers
    as the encoded one did (every answer, bit for bit)."""
    r = np.random.RandomState(3)
    t = TU.AdaptiveDDSketch(N, relative_accuracy=0.01, n_bins=128, key_offset=-64,
                            collapse_threshold=0.05, device="cpu")
    t.add(r.lognormal(0, 0.2, (N, 256)).astype(np.float32))
    t.collapse(np.arange(N) % 2 == 0)
    blobs = TW.payload_to_bytes(t.spec, t.state)
    back = TW.payload_from_bytes(t.spec, blobs, device="cpu")
    assert TW.payload_to_bytes(t.spec, back) == blobs
    d = TU.AdaptiveDDSketch(N, spec=t.spec, state=back, device="cpu")
    np.testing.assert_array_equal(d.get_quantile_values(QS).numpy(),
                                  t.get_quantile_values(QS).numpy())


@pytest.mark.parametrize("backend", ["uniform_collapse", "moment"])
def test_native_scanner_and_python_walker_decode_alike(backend, decode_tier):
    sj, st, t, jstate = _build(backend)
    blobs = TW.payload_to_bytes(st, t.state)
    # A non-canonical envelope (an unknown trailing field): the scanner
    # hands it to the walker, which skips the field (proto3).
    blobs[5] = blobs[5] + b"\x48\x01"
    got = TW.payload_from_bytes(st, blobs, device="cpu")
    _assert_states_equal(got, jax.block_until_ready(JW.payload_from_bytes(sj, blobs)))


# ---------------------------------------------------------------------------
# Refusals (the JAX package's, mirrored)
# ---------------------------------------------------------------------------


def _refusal_cases():
    sa, ta, fa, ja = _adaptive()
    sm, tm, fm, jm = _moment(k=8)
    a_blobs = TW.payload_to_bytes(ta, fa.state)
    m_blobs = TW.payload_to_bytes(tm, fm.state)
    j12, t12 = _specs("moment", n_moments=12)
    jd, td = jb.SketchSpec(n_bins=128), tb.SketchSpec(n_bins=128)
    over = a_blobs[0][:-1] + bytes([11])  # level 11 > max_collapses (10)
    return {
        "unknown_enum": ((sa, ta), [b"\x08\x07" + a_blobs[0][2:]], "Backend enum value 7"),
        "backend_mismatch": ((sm, tm), a_blobs, "spec wants"),
        "envelope_under_dense": ((jd, td), a_blobs, "dense"),
        "truncated": ((sa, ta), [a_blobs[0][: len(a_blobs[0]) // 2]], None),
        "moment_k_mismatch": ((j12, t12), m_blobs, "k="),
        "moment_truncated": ((sm, tm), [m_blobs[0][:-5]], None),
        "level_out_of_range": ((sa, ta), [over], "collapse level"),
    }


@pytest.mark.parametrize("case", ["unknown_enum", "backend_mismatch", "envelope_under_dense",
                                  "truncated", "moment_k_mismatch", "moment_truncated",
                                  "level_out_of_range"])
def test_decode_refusals_mirror_jax(case, decode_tier):
    (sj, st), blobs, match = _refusal_cases()[case]
    with pytest.raises(JWireDecodeError, match=match):
        JW.payload_from_bytes(sj, blobs)
    with pytest.raises(WireDecodeError, match=match):
        TW.payload_from_bytes(st, blobs, device="cpu")


def test_encode_refusals_and_the_windowed_envelope():
    sa, ta, fa, _ = _adaptive()
    _, tm = _specs("moment")
    with pytest.raises(SpecError, match="MomentState"):
        TW.payload_to_bytes(tm, fa.state)
    with pytest.raises(SpecError, match="AdaptiveState"):
        TW.payload_to_bytes(ta, fa.state.base)
    with pytest.raises(SpecError, match="SketchState"):
        TW.payload_to_bytes(tb.SketchSpec(n_bins=128), fa.state)
    # The windowed envelope: a whole ring round-trips, and a non-ring or an
    # empty blob is refused by name.
    from sketches_tpu_torch.windows import VirtualClock, WindowConfig, WindowedSketch

    clk = VirtualClock(0.0)
    ring = WindowedSketch(4, spec=ta, config=WindowConfig((5.0, 20.0), (2, 2)), clock=clk,
                          device="cpu")
    for step in range(6):
        clk.advance(3.0)
        ring.add(np.random.RandomState(step).lognormal(0, 1, (4, 8)).astype(np.float32))
    blob = TW.windowed_to_bytes(ring)
    back = TW.windowed_from_bytes(ta, blob, clock=VirtualClock(clk.t), device="cpu")
    assert back.ledger() == ring.ledger() and back.buckets() == ring.buckets()
    assert TW.windowed_to_bytes(back) == blob
    with pytest.raises(SpecError, match="WindowedSketch"):
        TW.windowed_to_bytes(None)
    with pytest.raises(WireDecodeError, match="windowed"):
        TW.windowed_from_bytes(ta, b"")
    empty = TW.payload_from_bytes(tm, [], device="cpu")
    assert empty.n_streams == 0 and empty.n_moments == tm.n_moments


def test_proto_bridge_dispatches_backends():
    for backend in ("uniform_collapse", "moment"):
        sj, st, t, jstate = _build(backend)
        blobs = tpb.batched_to_bytes(st, t.state)
        assert blobs == TW.payload_to_bytes(st, t.state)
        back = tpb.batched_from_bytes(st, blobs, device="cpu")
        assert isinstance(back, TU.AdaptiveState if backend == "uniform_collapse"
                          else TM.MomentState)
        with pytest.raises(SpecError, match="dense"):
            tpb.batched_to_proto(st, t.state)
        with pytest.raises(SpecError, match="dense"):
            tpb.batched_from_proto(st, [], device="cpu")


# ---------------------------------------------------------------------------
# Checkpoints of the backend states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["uniform_collapse", "moment"])
def test_checkpoints_cross_between_the_packages(backend, tmp_path):
    sj, st, t, jstate = _build(backend)
    from_jax = str(tmp_path / "jax.npz")
    jc.save_state(from_jax, sj, jstate)
    spec, state = tc.restore_state(from_jax, device="cpu")
    assert spec == st
    _assert_states_equal(state, jstate)
    restored = tc.restore(from_jax, device="cpu")
    assert type(restored) is type(t) and restored.spec == t.spec
    got, want = restored.get_quantile_values(QS), t.get_quantile_values(QS)
    if backend == "uniform_collapse":
        got, want = got.numpy(), want.numpy()
    np.testing.assert_array_equal(got, want)
    from_port = str(tmp_path / "port.npz")
    tc.save(from_port, t)
    jspec, jback = jc.restore_state(from_port)
    assert jspec == sj
    _assert_states_equal(t.state, jax.block_until_ready(jback))
    # Both packages write the same members, spec JSON and digest.
    with np.load(from_jax) as a, np.load(from_port) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_corrupted_or_mismatched_backend_checkpoints_refused(tmp_path):
    sj, st, t, _ = _moment()
    path = str(tmp_path / "m.npz")
    tc.save(path, t)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    bad = str(tmp_path / "bad.npz")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorrupt):
        tc.restore(bad, device="cpu")
    _, ta, fa, _ = _adaptive()
    apath = str(tmp_path / "a.npz")
    tc.save(apath, fa)
    with np.load(apath) as d:
        members = {k: np.asarray(d[k]) for k in d.files if k not in ("level", "__checksum__")}
    np.savez_compressed(str(tmp_path / "nolevel.npz"), **members)
    with pytest.raises(CheckpointCorrupt, match="level"):
        tc.restore_state(str(tmp_path / "nolevel.npz"), device="cpu")
    with pytest.raises(SpecError, match="partials"):
        tc.save(str(tmp_path / "p.npz"), t, partials=True)
    with pytest.raises(SpecError, match="MomentState"):
        tc.save_state(str(tmp_path / "x.npz"), st, fa.state)
    meta = json.loads(bytes(members["__spec__"]))
    assert meta["backend"] == "uniform_collapse" and meta["n_bins"] == 128

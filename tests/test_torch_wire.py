"""The port's wire format (``sketches_tpu_torch.pb``) against
``sketches_tpu.pb`` on the same states and blobs, on the CPU.

Tolerance: **exact** throughout.  For one state (the JAX package's, carried
over with ``convert.state_from_numpy``) the two encoders must emit the same
bytes; decoding either package's blobs must give bit-identical states in
both packages and on both of the port's decode drivers (native scanner and
pure-Python walker), compared leaf by leaf through
``convert.state_to_numpy``; quarantine reports must name the same blobs
with the same reasons, error classes and messages.

JAX results are waited for (``jax.block_until_ready``) before the port's
side runs.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketches_tpu import batched as jb
from sketches_tpu import native as jn
from sketches_tpu.pb import DDSketchProto as JProto
from sketches_tpu.pb import ddsketch_pb2 as jpb
from sketches_tpu.pb import wire as jw
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import convert
from sketches_tpu_torch import native as tn
from sketches_tpu_torch import pb as tpb
from sketches_tpu_torch.pb import wire as tw
from sketches_tpu_torch.pb.proto import messages
from sketches_tpu_torch.resilience import BlobTooLarge, WireDecodeError
from tests.test_wire import (
    ddsketch_bytes,
    index_mapping_bytes,
    length_delimited,
    sint32_field,
    store_bytes,
    varint,
)
from torch_proc_common import run
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

ROOT = Path(__file__).resolve().parent.parent

SPECS = {
    "log-128": dict(relative_accuracy=0.02, n_bins=128),
    "log-512-offset": dict(relative_accuracy=0.01, n_bins=512, key_offset=-100),
    "linear-256": dict(relative_accuracy=0.01, n_bins=256, mapping_name="linear_interpolated"),
    "quadratic-512": dict(
        relative_accuracy=0.01, n_bins=512, mapping_name="quadratic_interpolated"
    ),
    "cubic-300": dict(relative_accuracy=0.01, n_bins=300, mapping_name="cubic_interpolated"),
    "log-256-int": dict(relative_accuracy=0.02, n_bins=256, int_bins=True),
}


@pytest.fixture(params=["native", "python"])
def driver(request, monkeypatch):
    """The port's decode driver: the native scanner, or the pure-Python
    walker (``SKETCHES_TPU_NATIVE=0``).  The switch is the JAX package's
    too, and its engine caches a load made under it: both engines load
    afresh before and after, so no later test inherits a disabled one."""
    if request.param == "python":
        monkeypatch.setenv(tn.NATIVE_ENV, "0")
    jn.reset()
    tn.reset()
    assert tn.status()["wire"] == request.param
    yield request.param
    monkeypatch.delenv(tn.NATIVE_ENV, raising=False)
    jn.reset()
    tn.reset()


def _specs(name):
    kw = dict(SPECS[name])
    if kw.pop("int_bins", False):
        return jb.SketchSpec(**kw, bin_dtype=jnp.int32), tb.SketchSpec(**kw, bin_dtype=torch.int32)
    return jb.SketchSpec(**kw), tb.SketchSpec(**kw)


def _jax_state(jspec, n, seed, recentre=False, empty=True):
    """Mixed-sign lognormal streams with zeros (the zero count), a quarter
    of them empty, optionally each stream's window slid to its own offset
    (some mass collapses into the edge bins)."""
    r = np.random.RandomState(seed)
    v = (
        r.lognormal(0, 1.5, (n, 64))
        * np.where(r.rand(n, 64) < 0.3, -1.0, 1.0)
        * (r.rand(n, 64) > 0.1)
    ).astype(np.float32)
    w = np.ones((n, 64), np.float32)
    if empty:
        w[: n // 4] = 0.0
    st = jb.add(jspec, jb.init(jspec, n), jnp.asarray(v), jnp.asarray(w))
    if recentre:
        offs = jspec.key_offset + r.randint(-80, 80, n).astype(np.int32)
        st = jb.recenter(jspec, st, jnp.asarray(offs))
    return jax.block_until_ready(st)


def _leaves(state):
    if isinstance(state, tb.SketchState):
        return convert.state_to_numpy(state)
    return {f: np.asarray(getattr(state, f)) for f in tb.LEAVES}


def _assert_states_equal(got, ref):
    g, r = _leaves(got), _leaves(ref)
    for f in tb.LEAVES:
        assert g[f].dtype == r[f].dtype, f
        np.testing.assert_array_equal(g[f], r[f], err_msg=f)


def _to_port(tspec, jstate):
    return convert.state_from_numpy(tspec, _leaves(jstate), device="cpu")


def _linear(name):
    return SPECS[name].get("mapping_name") == "linear_interpolated"


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recentre", [False, True], ids=["spec_window", "recentred"])
@pytest.mark.parametrize("name", list(SPECS))
def test_encode_byte_identical_to_jax(name, recentre):
    jspec, tspec = _specs(name)
    jst = _jax_state(jspec, 48, seed=7, recentre=recentre)
    ref = jw.state_to_bytes(jspec, jst)
    got = tw.state_to_bytes(tspec, _to_port(tspec, jst))
    assert len(got) == len(ref) == 48
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"stream {i}"
    assert tpb.batched_to_bytes(tspec, _to_port(tspec, jst)) == ref


def test_encode_equals_object_bridge():
    jspec, tspec = _specs("cubic-300")
    tst = _to_port(tspec, _jax_state(jspec, 16, seed=8, recentre=True))
    slow = [tpb.DDSketchProto.to_proto(sk).SerializeToString()
            for sk in tb.to_host_sketches(tspec, tst)]
    assert slow == tw.state_to_bytes(tspec, tst)
    msgs = tpb.batched_to_proto(tspec, tst)
    assert [m.SerializeToString() for m in msgs] == slow


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recentre", [False, True], ids=["spec_window", "recentred"])
@pytest.mark.parametrize("name", list(SPECS))
def test_decode_bit_identical_to_jax(name, recentre, driver):
    jspec, tspec = _specs(name)
    jst = _jax_state(jspec, 48, seed=9, recentre=recentre)
    blobs = jw.state_to_bytes(jspec, jst)
    lin = dict(assume_native_linear=True) if _linear(name) else {}
    ref = jax.block_until_ready(jw.bytes_to_state(jspec, blobs, **lin))
    got = tw.bytes_to_state(tspec, blobs, device="cpu", **lin)
    _assert_states_equal(got, ref)
    # The port's own blobs are the same bytes, so JAX reads them back alike.
    mine = tw.state_to_bytes(tspec, _to_port(tspec, jst))
    _assert_states_equal(jw.bytes_to_state(jspec, mine, **lin), got)


def _foreign_blobs(gamma):
    mapping = index_mapping_bytes(gamma, 0)
    s1 = store_bytes(contiguous=[3.0, 4.0], offset=0)
    s2 = store_bytes(contiguous=[5.0], offset=1)
    run = length_delimited(2, np.array([1.0, 2.0]).tobytes())
    big_off = length_delimited(1, mapping) + length_delimited(
        2, run + varint(3 << 3) + varint((1 << 35) | 6)
    )
    return [
        ddsketch_bytes(  # sparse both stores + zero count, keys out of window
            mapping,
            pos=store_bytes(bin_counts={-500: 2.0, 0: 1.0, 500: 3.0}),
            neg=store_bytes(bin_counts={2: 1.5}),
            zero_count=4.0,
        ),
        ddsketch_bytes(  # dense unpacked + sparse overlap in one store
            mapping,
            pos=store_bytes(bin_counts={10: 1.0}, contiguous=[2.0, 3.0], offset=9, packed=False),
        ),
        ddsketch_bytes(mapping),  # empty
        # a repeated store field (legal protobuf: the occurrences merge)
        length_delimited(1, mapping) + length_delimited(2, s1) + length_delimited(2, s2),
        # a dense run hanging over both window edges, negative masses
        ddsketch_bytes(mapping, neg=store_bytes(contiguous=[1.0, -2.0, 3.0] * 60, offset=-120)),
        # an offset varint past 32 bits (sint32 truncates)
        big_off,
        # an unknown field after the stores
        ddsketch_bytes(mapping, pos=s1) + sint32_field(9, 5),
        # fields in another order
        length_delimited(2, s1) + length_delimited(1, mapping),
    ]


def test_decode_foreign_shapes_like_jax(driver):
    jspec, tspec = _specs("log-128")
    blobs = _foreign_blobs(jspec.mapping.gamma)
    ref = jax.block_until_ready(jw.bytes_to_state(jspec, blobs))
    got = tw.bytes_to_state(tspec, blobs, device="cpu")
    _assert_states_equal(got, ref)
    # and the object bridge reads each foreign message as JAX's does
    for b in blobs:
        a = JProto.from_proto(jpb.DDSketch.FromString(b))
        t = tpb.DDSketchProto.from_proto(messages().DDSketch.FromString(b))
        assert list(t.store.bins) == list(a.store.bins) and t.store.offset == a.store.offset
        assert list(t.negative_store.bins) == list(a.negative_store.bins)
        assert (t.count, t.zero_count) == (a.count, a.zero_count)


def _records(report):
    return [(r.index, r.kind, r.error, r.message) for r in report.records]


def test_quarantine_reports_match_jax(driver):
    jspec, tspec = _specs("log-128")
    blobs = list(jw.state_to_bytes(jspec, _jax_state(jspec, 96, seed=23)))
    r = np.random.RandomState(99)
    for i in range(0, 96, 11):  # deterministic corruption sites
        b = bytearray(blobs[i])
        b[r.randint(len(b))] ^= 0xFF
        blobs[i] = bytes(b[: r.randint(1, len(b))] if i % 2 else b)
    blobs[5] = b"\x00" * 4096  # garbage, and over the limit
    other = jb.SketchSpec(relative_accuracy=0.05, n_bins=128)
    blobs[7] = jw.state_to_bytes(other, _jax_state(other, 1, seed=3, empty=False))[0]
    blobs[8] = ddsketch_bytes(index_mapping_bytes(jspec.mapping.gamma, 7))  # unknown enum
    kw = dict(errors="quarantine", max_blob_bytes=2048)
    jstate, jrep = jw.bytes_to_state(jspec, blobs, **kw)
    jax.block_until_ready(jstate)
    tstate, trep = tw.bytes_to_state(tspec, blobs, device="cpu", **kw)
    _assert_states_equal(tstate, jstate)
    assert _records(trep) == _records(jrep)
    kinds = trep.counters
    assert kinds.get("over_limit") and kinds.get("mapping_mismatch") and kinds.get("invalid")
    assert (trep.total, trep.n_ok, bool(trep)) == (96, 96 - trep.n_quarantined, True)
    # raise mode: the first bad blob raises what JAX raises
    with pytest.raises(Exception) as ref_err:
        jw.bytes_to_state(jspec, blobs, max_blob_bytes=2048)
    with pytest.raises(type(ref_err.value)) as got_err:
        tw.bytes_to_state(tspec, blobs, device="cpu", max_blob_bytes=2048)
    assert str(got_err.value) == str(ref_err.value)
    with pytest.raises(BlobTooLarge) as got_err:
        tw.bytes_to_state(tspec, blobs[5:6], device="cpu", max_blob_bytes=2048)
    assert str(got_err.value) == "blob 0: 4096 bytes exceeds max_blob_bytes=2048"


def test_linear_refusal_matches_jax(driver):
    jspec, tspec = _specs("linear-256")
    blobs = jw.state_to_bytes(jspec, _jax_state(jspec, 8, seed=4))
    with pytest.raises(ValueError) as ref:
        jw.bytes_to_state(jspec, blobs)
    with pytest.raises(WireDecodeError) as got:
        tw.bytes_to_state(tspec, blobs, device="cpu")
    assert str(got.value) == str(ref.value)
    _, jrep = jw.bytes_to_state(jspec, blobs, errors="quarantine")
    _, trep = tw.bytes_to_state(tspec, blobs, device="cpu", errors="quarantine")
    assert _records(trep) == _records(jrep) and trep.n_quarantined == 8
    with pytest.raises(WireDecodeError):
        tpb.KeyMappingProto.from_proto(jpb.DDSketch.FromString(blobs[0]).mapping)


def test_fuzz_mutations_match_jax(driver):
    jspec, tspec = _specs("log-128")
    blobs = jw.state_to_bytes(jspec, _jax_state(jspec, 8, seed=41, empty=False))
    r = np.random.RandomState(42)
    outcomes = set()
    for trial in range(90):
        blob = bytearray(blobs[trial % len(blobs)])
        op = trial % 3
        if op == 0:
            i = r.randint(len(blob))
            blob[i] ^= 1 << r.randint(8)
        elif op == 1:
            blob = blob[: r.randint(1, len(blob))]
        else:
            i = r.randint(min(32, len(blob)))
            blob[i] = 0x80 | blob[i]
        blob = bytes(blob)
        try:
            ref = jax.block_until_ready(jw.bytes_to_state(jspec, [blob]))
        except Exception as e:  # noqa: BLE001 - differential harness
            with pytest.raises(Exception) as got:
                tw.bytes_to_state(tspec, [blob], device="cpu")
            assert type(got.value).__name__ == type(e).__name__
            assert str(got.value) == str(e)
            outcomes.add("raise")
            continue
        _assert_states_equal(tw.bytes_to_state(tspec, [blob], device="cpu"), ref)
        outcomes.add("ok")
    assert outcomes == {"ok", "raise"}


def test_protos_round_trip_like_jax():
    jspec, tspec = _specs("quadratic-512")
    jst = _jax_state(jspec, 24, seed=5)
    msgs = [jpb.DDSketch.FromString(b) for b in jw.state_to_bytes(jspec, jst)]
    ref = jax.block_until_ready(jw.protos_to_state(jspec, msgs))
    _assert_states_equal(tw.protos_to_state(tspec, msgs, device="cpu"), ref)
    _assert_states_equal(tpb.batched_from_proto(tspec, msgs, device="cpu"), ref)
    blobs = [m.SerializeToString() for m in msgs]
    _assert_states_equal(tpb.batched_from_bytes(tspec, blobs, device="cpu"), ref)


def test_host_sketch_bridges_match_jax():
    jspec, tspec = _specs("log-512-offset")
    jst = _jax_state(jspec, 16, seed=6, recentre=True)
    tst = _to_port(tspec, jst)
    jh, th = jb.to_host_sketches(jspec, jst), tb.to_host_sketches(tspec, tst)
    for a, t in zip(jh, th):
        for sa, st in ((a.store, t.store), (a.negative_store, t.negative_store)):
            assert (list(st.bins), st.offset, st.count) == (list(sa.bins), sa.offset, sa.count)
        assert (t._collapsed_low, t._collapsed_high) == (a._collapsed_low, a._collapsed_high)
    ref = jax.block_until_ready(jb.from_host_sketches(jspec, jh))
    _assert_states_equal(tb.from_host_sketches(tspec, th, device="cpu"), ref)
    lo, hi = tb.occupied_bounds_np(np.zeros((3, 7)))
    assert lo.tolist() == [7, 7, 7] and hi.tolist() == [-1, -1, -1]


def test_non_dense_and_bad_options_refuse():
    from sketches_tpu_torch.resilience import SketchValueError, SpecError

    from sketches_tpu_torch.resilience import WireDecodeError

    spec = tb.SketchSpec(0.01, n_bins=128, backend="moment")
    dense = tb.SketchSpec(0.01, n_bins=128)
    st = tb.init(dense, 2, "cpu")
    # Non-dense specs ride the SketchPayload envelope: a dense state under a
    # moment spec, and dense blobs under it, are refused.
    with pytest.raises(SpecError, match="MomentState"):
        tpb.batched_to_bytes(spec, st)
    with pytest.raises(WireDecodeError, match="spec wants 'moment'"):
        tpb.batched_from_bytes(spec, tpb.batched_to_bytes(dense, st), device="cpu")
    with pytest.raises(SketchValueError):
        tw.bytes_to_state(tb.SketchSpec(), [], device="cpu", errors="ignore")


_NO_PROTOBUF = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "google.protobuf" or name.startswith("google.protobuf."):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import os
import numpy as np, torch
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import native
from sketches_tpu_torch.pb import wire
from sketches_tpu_torch.resilience import EngineUnavailable
spec = tb.SketchSpec(0.01, n_bins=128)
v = torch.from_numpy(np.random.RandomState(0).lognormal(0, 1, (4, 32)).astype(np.float32))
st = tb.add(spec, tb.init(spec, 4, "cpu"), v)
blobs = wire.state_to_bytes(spec, st)
for driver in ("native", "python"):
    back = wire.bytes_to_state(spec, blobs, device="cpu")
    assert torch.equal(back.bins_pos, st.bins_pos)
    for mode in ("raise", "quarantine"):
        try:
            wire.bytes_to_state(spec, blobs + [b"\x0a\x01"], device="cpu",
                                errors=mode)
        except EngineUnavailable as e:
            assert "protobuf is not installed" in str(e)
        else:
            raise SystemExit("a foreign blob decoded without protobuf")
assert not [m for m in sys.modules if m.startswith("google.protobuf")]
print("ok")
"""


def test_canonical_codec_runs_without_protobuf():
    out = run([sys.executable, "-c", _NO_PROTOBUF], cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"

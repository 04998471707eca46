"""The port's dense checkpoints (``sketches_tpu_torch.checkpoint``) against
``sketches_tpu.checkpoint``, on the CPU.

Tolerance: **exact**.  A checkpoint is the state's raw arrays plus the spec
JSON and a sha256 digest over both, so a file written by either package
must verify and restore in the other with every leaf bit-identical
(compared as numpy arrays), and the two packages must write the same spec
JSON and the same digest for the same state.
"""

import io
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketches_tpu import batched as jb
from sketches_tpu import checkpoint as jc
from sketches_tpu import integrity
from sketches_tpu import parallel as jp
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import checkpoint as tc
from sketches_tpu_torch import convert
from sketches_tpu_torch import parallel as tp
from sketches_tpu_torch.resilience import (
    CheckpointCorrupt,
    ShardLossError,
    SketchValueError,
    SpecError,
)
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

QS = [0.5, 0.9, 0.99]


def _leaves(state):
    if isinstance(state, tb.SketchState):
        return convert.state_to_numpy(state)
    return {f: np.asarray(getattr(state, f)) for f in tb.LEAVES}


def _assert_equal(got, ref):
    g, r = _leaves(got), _leaves(ref)
    for f in tb.LEAVES:
        assert g[f].dtype == r[f].dtype and g[f].shape == r[f].shape, f
        np.testing.assert_array_equal(g[f], r[f], err_msg=f)


def _members(path):
    with np.load(path) as d:
        return {k: np.asarray(d[k]) for k in d.files}


def _jax_state(jspec, n=32, seed=0):
    r = np.random.RandomState(seed)
    v = (r.lognormal(0, 2, (n, 128)) * np.where(r.rand(n, 128) < 0.4, -1, 1)).astype(np.float32)
    st = jb.add(jspec, jb.init(jspec, n), jnp.asarray(v))
    st = jb.recenter(jspec, st, jnp.asarray(jspec.key_offset + r.randint(-40, 40, n), jnp.int32))
    return jax.block_until_ready(st)


SPECS = {
    "log-512": dict(relative_accuracy=0.01, n_bins=512),
    "cubic-300": dict(relative_accuracy=0.02, n_bins=300, mapping_name="cubic_interpolated"),
    "log-256-int": dict(relative_accuracy=0.02, n_bins=256, int_bins=True),
}


def _specs(name):
    kw = dict(SPECS[name])
    if kw.pop("int_bins", False):
        return jb.SketchSpec(**kw, bin_dtype=jnp.int32), tb.SketchSpec(**kw, bin_dtype=torch.int32)
    return jb.SketchSpec(**kw), tb.SketchSpec(**kw)


@pytest.mark.parametrize("name", list(SPECS))
def test_jax_checkpoint_restores_in_the_port(name, tmp_path):
    jspec, tspec = _specs(name)
    jst = _jax_state(jspec)
    path = str(tmp_path / "jax.npz")
    jc.save_state(path, jspec, jst)
    spec, st = tc.restore_state(path, device="cpu")
    assert spec == tspec
    _assert_equal(st, jst)


@pytest.mark.parametrize("name", list(SPECS))
def test_port_checkpoint_restores_in_jax_with_equal_digest(name, tmp_path):
    jspec, tspec = _specs(name)
    jst = _jax_state(jspec, seed=1)
    tst = convert.state_from_numpy(tspec, _leaves(jst), device="cpu")
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tc.save_state(mine, tspec, tst)
    jc.save_state(theirs, jspec, jst)
    a, b = _members(mine), _members(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert bytes(a["__checksum__"]) == bytes(b["__checksum__"])
    assert json.loads(bytes(a["__spec__"])) == json.loads(bytes(b["__spec__"]))
    spec, back = jc.restore_state(mine)
    assert spec == jspec
    _assert_equal(jax.block_until_ready(back), jst)


def test_facade_round_trip_keeps_answers(tmp_path):
    jspec, tspec = _specs("log-512")
    tst = convert.state_from_numpy(tspec, _leaves(_jax_state(jspec, seed=2)), device="cpu")
    sk = tb.BatchedDDSketch(32, spec=tspec, state=tst, device="cpu")
    path = str(tmp_path / "sk.npz")
    tc.save(path, sk)
    back = tc.restore(path, device="cpu")
    assert isinstance(back, tb.BatchedDDSketch) and back.spec == sk.spec
    _assert_equal(back.state, sk.state)
    assert torch.equal(back.get_quantile_values(QS).nan_to_num(), sk.get_quantile_values(QS).nan_to_num())
    ref = jc.restore(path)  # the JAX facade reads it too
    np.testing.assert_array_equal(np.asarray(ref.count), sk.count.numpy())
    with pytest.raises(SpecError):
        tc.save(path, sk, partials=True)


def _distributed(k, n=16, seed=3):
    mesh = tp.SketchMesh(devices=["cpu"] * k)
    d = tp.DistributedDDSketch(n, mesh=mesh, relative_accuracy=0.01, n_bins=512)
    r = np.random.RandomState(seed)
    for _ in range(2):
        d.add(r.lognormal(0, 1, (n, 8 * k)).astype(np.float32))
    return d


def test_partials_round_trip_and_live_mask(tmp_path):
    d = _distributed(4)
    path = str(tmp_path / "partials.npz")
    tc.save(path, d, partials=True)
    spec, st = tc.restore_state(path, device="cpu")
    assert st.bins_pos.shape == (4, 16, 512)
    _assert_equal(st, d.partials)
    back = tc.restore_distributed(path, mesh=tp.SketchMesh(devices=["cpu"] * 2))
    _assert_equal(back.merged_state(), d.merged_state())
    live = [True, False, True, True]
    part = tc.restore_distributed(path, mesh=tp.SketchMesh(devices=["cpu"] * 2), live_mask=live)
    kept = st.count[[0, 2, 3]].sum(0)
    assert torch.equal(part.merged_state().count, kept)
    with pytest.raises(ShardLossError):
        tc.restore_distributed(path, mesh=tp.SketchMesh(devices=["cpu"]), live_mask=[False] * 4)
    # JAX reads the stacked partials file as well
    jspec, jst = jc.restore_state(path)
    _assert_equal(jax.block_until_ready(jst), st)


def test_folded_distributed_checkpoint(tmp_path):
    d = _distributed(2, seed=4)
    path = str(tmp_path / "folded.npz")
    tc.save(path, d)
    back = tc.restore_distributed(path, mesh=tp.SketchMesh(devices=["cpu"] * 4))
    _assert_equal(back.merged_state(), d.merged_state())
    with pytest.raises(SketchValueError):
        tc.restore_distributed(path, mesh=tp.SketchMesh(devices=["cpu"] * 2), live_mask=[True])
    # a JAX distributed facade's folded checkpoint restores onto the port's mesh
    jd = jp.DistributedDDSketch(16, mesh=jp.SketchMesh(2), relative_accuracy=0.01, n_bins=512)
    jd.add(np.random.RandomState(5).lognormal(0, 1, (16, 16)).astype(np.float32))
    jpath = str(tmp_path / "jax_folded.npz")
    jc.save(jpath, jd)
    ref = jax.block_until_ready(jd.merged_state())
    back = tc.restore_distributed(jpath, mesh=tp.SketchMesh(devices=["cpu"] * 2))
    _assert_equal(back.merged_state(), ref)


def _small(tmp_path):
    jspec, tspec = _specs("log-512")
    tst = convert.state_from_numpy(tspec, _leaves(_jax_state(jspec, n=8, seed=6)), device="cpu")
    path = str(tmp_path / "ck.npz")
    tc.save_state(path, tspec, tst)
    return path, tst


@pytest.mark.parametrize("cut", [1, 100, 0.5, 0.9])
def test_truncated_checkpoint_raises_corrupt(tmp_path, cut):
    path, _ = _small(tmp_path)
    data = open(path, "rb").read()
    n = int(len(data) * cut) if isinstance(cut, float) else len(data) - cut
    with open(path, "wb") as f:
        f.write(data[:n])
    with pytest.raises(CheckpointCorrupt):
        tc.restore_state(path, device="cpu")


def _data_spans(path):
    """(start, length) of each member's compressed bytes in the archive."""
    spans = []
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        for info in z.infolist():
            f.seek(info.header_offset + 26)
            name_len, extra_len = np.frombuffer(f.read(4), "<u2")
            spans.append((info.header_offset + 30 + int(name_len) + int(extra_len),
                          info.compress_size))
    return spans


def test_flipped_byte_raises_corrupt(tmp_path):
    """One flipped bit anywhere in a member's compressed bytes: the port
    refuses with CheckpointCorrupt where the JAX package refuses too."""
    path, _ = _small(tmp_path)
    data = open(path, "rb").read()
    spans = _data_spans(path)
    assert len(spans) == 18
    bad_path = str(tmp_path / "bad.npz")
    for start, length in spans:
        for frac in (0.1, 0.5, 0.9):
            bad = bytearray(data)
            bad[start + int(length * frac)] ^= 0x10
            with open(bad_path, "wb") as f:
                f.write(bad)
            with pytest.raises(CheckpointCorrupt):
                tc.restore_state(bad_path, device="cpu")
            with pytest.raises(Exception):
                jc.restore_state(bad_path)


def test_checksum_mismatch_and_missing_members_raise_corrupt(tmp_path):
    path, tst = _small(tmp_path)
    arrays = _members(path)
    arrays["bins_pos"] = arrays["bins_pos"] + 1.0  # content changed after the digest
    forged = str(tmp_path / "forged.npz")
    np.savez_compressed(forged, **arrays)
    with pytest.raises(CheckpointCorrupt, match="checksum mismatch"):
        tc.restore_state(forged, device="cpu")
    del arrays["count"], arrays["__checksum__"]
    np.savez_compressed(forged, **arrays)
    with pytest.raises(CheckpointCorrupt):
        tc.restore_state(forged, device="cpu")
    with pytest.raises(FileNotFoundError):
        tc.restore_state(str(tmp_path / "nope.npz"), device="cpu")


def test_older_formats_restore_like_jax(tmp_path):
    """No checksum, no per-stream offsets, no occupied bounds and no tile
    sums: both packages derive the missing leaves alike."""
    path, _ = _small(tmp_path)
    legacy = str(tmp_path / "legacy.npz")
    drop = ("__checksum__", "key_offset", "pos_lo", "pos_hi", "neg_lo", "neg_hi",
            "neg_total", "tile_sums")
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(legacy, "w") as zout:
        for item in zin.namelist():
            if item[:-4] not in drop:
                zout.writestr(item, zin.read(item))
    _, ref = jc.restore_state(legacy)
    _, got = tc.restore_state(legacy, device="cpu")
    _assert_equal(got, jax.block_until_ready(ref))


def test_armed_jax_fingerprint_is_read_past(tmp_path):
    jspec, tspec = _specs("log-512")
    jst = _jax_state(jspec, seed=7)
    path = str(tmp_path / "armed.npz")
    integrity.arm("raise")
    try:
        jc.save_state(path, jspec, jst)
    finally:
        integrity.disarm()
    assert "__fingerprint__" in _members(path)
    _, st = tc.restore_state(path, device="cpu")
    _assert_equal(st, jst)


def test_non_dense_and_windowed_refuse(tmp_path):
    path, _ = _small(tmp_path)
    arrays = _members(path)
    meta = json.loads(bytes(arrays["__spec__"]))
    meta["backend"] = "moment"
    arrays["__spec__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    del arrays["__checksum__"]
    other = str(tmp_path / "moment.npz")
    np.savez_compressed(other, **arrays)
    # A moment spec over dense members: the moment leaves are missing.
    with pytest.raises(CheckpointCorrupt, match="missing state members"):
        tc.restore_state(other, device="cpu")
    spec = tb.SketchSpec(0.01, n_bins=128, backend="moment")
    with pytest.raises(SpecError, match="MomentState"):
        tc.save_state(str(tmp_path / "x.npz"), spec, tb.init(tb.SketchSpec(0.01, n_bins=128), 2, "cpu"))
    # Windowed checkpoints: a ring round-trips; a plain checkpoint or a
    # non-ring is refused by name.
    from sketches_tpu_torch.windows import VirtualClock, WindowConfig, WindowedSketch

    clk = VirtualClock(0.0)
    ring = WindowedSketch(4, spec=tb.SketchSpec(0.01, n_bins=128),
                          config=WindowConfig((5.0, 20.0), (2, 2)), clock=clk, device="cpu")
    for step in range(6):
        clk.advance(3.0)
        ring.add(np.random.RandomState(step).lognormal(0, 1, (4, 8)).astype(np.float32))
    wpath = str(tmp_path / "w.npz")
    tc.save_windowed(wpath, ring)
    back = tc.restore_windowed(wpath, clock=VirtualClock(clk.t), device="cpu")
    assert back.ledger() == ring.ledger() and back.buckets() == ring.buckets()
    assert torch.equal(back.quantile([0.5], window=None), ring.quantile([0.5], window=None))
    with pytest.raises(SpecError, match="WindowedSketch"):
        tc.save_windowed(str(tmp_path / "x.npz"), None)
    with pytest.raises(CheckpointCorrupt, match="not a windowed"):
        tc.restore_windowed(path, device="cpu")


def test_atomic_write_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    path, tst = _small(tmp_path)
    before = open(path, "rb").read()

    def crash(src, dst):
        raise OSError("simulated crash before the rename")

    monkeypatch.setattr(os, "replace", crash)
    spec = tb.SketchSpec(0.01, n_bins=512)
    with pytest.raises(OSError):
        tc.save_state(path, spec, tb.init(spec, 8, "cpu"))
    monkeypatch.undo()
    assert open(path, "rb").read() == before
    assert os.listdir(tmp_path) == ["ck.npz"]
    _, st = tc.restore_state(path, device="cpu")
    _assert_equal(st, tst)
    # a bare path keeps its own suffix
    other = str(tmp_path / "state.ckpt")
    tc.save_state(other, spec, tst)
    assert os.path.exists(other) and io.BytesIO(open(other, "rb").read()).read(2) == b"PK"

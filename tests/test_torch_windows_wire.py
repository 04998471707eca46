"""Windowed checkpoints and the windowed wire envelope of the port against
the JAX package's, on the CPU: round trips of every backend, files and
blobs crossing between the two packages in both directions, and the loud
refusals.  Envelope bytes compare byte for byte; answers as in
``test_torch_windows`` (``torch_window_common``)."""

import numpy as np
import pytest
from sketches_tpu import checkpoint as jc
from sketches_tpu import integrity as ji
from sketches_tpu import windows as jw
from sketches_tpu.backends import wirefmt as jwf
from sketches_tpu_torch import BatchedDDSketch
from sketches_tpu_torch import checkpoint as tc
from sketches_tpu_torch import faults as tf
from sketches_tpu_torch import integrity as ti
from sketches_tpu_torch import resilience as tr
from sketches_tpu_torch import windows as tw
from sketches_tpu_torch.backends import wirefmt as twf
from torch_window_common import (
    ADAPTIVE,
    CFG,
    DENSE,
    MOMENT,
    Pair,
    configs,
    host,
    reset_all,
    same_answers,
)
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

BACKENDS = [
    (DENSE, CFG),
    (ADAPTIVE, configs((5.0, 20.0), (2, 2), (0, 1))),
    (MOMENT, configs((5.0, 20.0), (2, 2))),
]
IDS = ["dense", "uniform_collapse", "moment"]


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()


def _driven(spec=DENSE, cfg=CFG, seed=10, steps=8, n=4):
    p = Pair(spec=spec, config=cfg, n=n)
    p.drive(np.random.default_rng(seed), steps, width=8)
    return p


# ---------------------------------------------------------------------------
# Checkpoint: ring + ladder + ledger, atomically
# ---------------------------------------------------------------------------


class TestCheckpoint:
    @pytest.mark.parametrize("spec,cfg", BACKENDS, ids=IDS)
    def test_roundtrip_all_backends(self, tmp_path, spec, cfg):
        p = _driven(spec, cfg)
        path = str(tmp_path / f"{spec[1].backend}.ckpt")
        tc.save_windowed(path, p.t)
        restored = tc.restore_windowed(path, clock=tw.VirtualClock(p.ct.t), device="cpu")
        assert restored.ledger() == p.t.ledger() and restored.buckets() == p.t.buckets()
        got = host(restored.quantile([0.5, 0.9], window=30.0))
        assert np.array_equal(got, host(p.t.quantile([0.5, 0.9], window=30.0)), equal_nan=True)

    @pytest.mark.parametrize("spec,cfg", BACKENDS, ids=IDS)
    def test_files_cross_between_the_packages(self, tmp_path, spec, cfg):
        """A port file restores in the JAX package and a JAX file in the
        port, ring and ledger intact, answering alike."""
        p = _driven(spec, cfg, seed=14)
        port_path, jax_path = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
        tc.save_windowed(port_path, p.t)
        jc.save_windowed(jax_path, p.j)
        in_jax = jc.restore_windowed(port_path, clock=jw.VirtualClock(p.cj.t))
        in_port = tc.restore_windowed(jax_path, clock=tw.VirtualClock(p.ct.t), device="cpu")
        assert in_jax.ledger() == in_port.ledger() == p.t.ledger()
        assert in_jax.buckets() == in_port.buckets() == p.t.buckets()
        got = host(in_port.quantile([0.5, 0.9], window=30.0))
        want = host(in_jax.quantile([0.5, 0.9], window=30.0))
        if spec is MOMENT:
            assert np.array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)], rtol=1e-3)
        else:
            assert same_answers(got, want)
        if spec is not MOMENT:
            assert in_jax.window_plan(None).digest == in_port.window_plan(None).digest

    def test_armed_fingerprints_roundtrip(self, tmp_path):
        p = _driven(steps=5)
        ti.arm("raise")
        path = str(tmp_path / "armed.ckpt")
        tc.save_windowed(path, p.t)
        restored = tc.restore_windowed(path, clock=tw.VirtualClock(p.ct.t), device="cpu")
        assert restored.ledger() == p.t.ledger()
        ji.arm("raise")  # the JAX package verifies the port's fingerprints
        assert jc.restore_windowed(path, clock=jw.VirtualClock(p.cj.t)).ledger() == p.j.ledger()

    def test_torn_write_refuses_previous_survives(self, tmp_path):
        p = Pair(n=4)
        p.advance(1.0)
        p.add(np.ones((4, 8), np.float32))
        path = str(tmp_path / "torn.ckpt")
        tc.save_windowed(path, p.t)
        with tf.active({tf.CHECKPOINT_WRITE: dict(mode="raise", times=1)}):
            with pytest.raises(tr.InjectedFault):
                tc.save_windowed(path, p.t)
        restored = tc.restore_windowed(path, clock=tw.VirtualClock(p.ct.t), device="cpu")
        assert restored.total_mass == p.t.total_mass
        with tf.active({tf.CHECKPOINT_WRITE: dict(mode="truncate", times=1)}):
            tc.save_windowed(path, p.t)
        with pytest.raises(tr.CheckpointCorrupt):
            tc.restore_windowed(path, clock=tw.VirtualClock(p.ct.t), device="cpu")

    def test_batched_checkpoint_is_not_windowed(self, tmp_path):
        sk = BatchedDDSketch(4, spec=DENSE[1], device="cpu")
        sk.add(np.ones((4, 8), np.float32))
        path = str(tmp_path / "plain.ckpt")
        tc.save(path, sk)
        with pytest.raises(tr.CheckpointCorrupt, match="not a windowed"):
            tc.restore_windowed(path, device="cpu")
        with pytest.raises(tr.SpecError, match="WindowedSketch"):
            tc.save_windowed(str(tmp_path / "x.ckpt"), sk)


# ---------------------------------------------------------------------------
# Wire envelope
# ---------------------------------------------------------------------------


class TestWire:
    @pytest.mark.parametrize("spec,cfg", BACKENDS[:2], ids=IDS[:2])
    def test_bytes_equal_the_jax_packages(self, spec, cfg):
        p = _driven(spec, cfg, seed=12)
        blob = twf.windowed_to_bytes(p.t)
        assert blob[:1] == b"\x08"
        assert blob == jwf.windowed_to_bytes(p.j)

    def test_roundtrip_and_bit_identity(self):
        p = _driven(seed=12)
        blob = twf.windowed_to_bytes(p.t)
        restored = twf.windowed_from_bytes(DENSE[1], blob, clock=tw.VirtualClock(p.ct.t),
                                           device="cpu")
        assert restored.ledger() == p.t.ledger() and restored.buckets() == p.t.buckets()
        got = host(restored.quantile([0.5, 0.99], window=25.0))
        assert np.array_equal(got, host(p.t.quantile([0.5, 0.99], window=25.0)), equal_nan=True)
        assert twf.windowed_to_bytes(restored) == blob

    @pytest.mark.parametrize("spec,cfg", BACKENDS, ids=IDS)
    def test_blobs_cross_between_the_packages(self, spec, cfg):
        p = _driven(spec, cfg, seed=15)
        in_port = twf.windowed_from_bytes(spec[1], jwf.windowed_to_bytes(p.j),
                                          clock=tw.VirtualClock(p.ct.t), device="cpu")
        in_jax = jwf.windowed_from_bytes(spec[0], twf.windowed_to_bytes(p.t),
                                         clock=jw.VirtualClock(p.cj.t))
        assert in_port.ledger() == in_jax.ledger() == p.j.ledger()
        assert in_port.buckets() == in_jax.buckets()
        if spec is not MOMENT:
            # The dense decode places each stream on the spec's window (the
            # envelope carries no sum/min/max), so the decoded rings are
            # compared with each other, not with the live ones.
            assert twf.windowed_to_bytes(in_port) == jwf.windowed_to_bytes(in_jax)
            assert in_port.window_plan(None).digest == in_jax.window_plan(None).digest

    def test_old_reader_refuses_loudly(self):
        p = Pair(n=2)
        p.advance(1.0)
        p.add(np.ones((2, 4), np.float32))
        blob = twf.windowed_to_bytes(p.t)
        with pytest.raises(tr.WireDecodeError, match="windowed|envelope"):
            twf.payload_from_bytes(DENSE[1], [blob], device="cpu")
        with pytest.raises(tr.WireDecodeError, match="windowed"):
            twf.payload_from_bytes(MOMENT[1], [blob], device="cpu")

    def test_plain_blob_refused_by_windowed_reader(self):
        sk = BatchedDDSketch(2, spec=DENSE[1], device="cpu")
        sk.add(np.ones((2, 4), np.float32))
        blob = twf.payload_to_bytes(DENSE[1], sk.state)[0]
        with pytest.raises(tr.WireDecodeError):
            twf.windowed_from_bytes(DENSE[1], blob, device="cpu")
        with pytest.raises(tr.SpecError, match="WindowedSketch"):
            twf.windowed_to_bytes(sk)

    def test_config_mismatch_refuses(self):
        p = Pair(n=2)
        p.advance(1.0)
        p.add(np.ones((2, 4), np.float32))
        blob = twf.windowed_to_bytes(p.t)
        with pytest.raises(tr.WireDecodeError, match="ladder"):
            twf.windowed_from_bytes(DENSE[1], blob, config=tw.WindowConfig((5.0,), (4,)),
                                    device="cpu")

    def test_truncated_blob_refuses(self):
        p = Pair(n=2)
        p.advance(1.0)
        p.add(np.ones((2, 4), np.float32))
        blob = twf.windowed_to_bytes(p.t)
        with pytest.raises(tr.WireDecodeError):
            twf.windowed_from_bytes(DENSE[1], blob[: len(blob) // 2], device="cpu")

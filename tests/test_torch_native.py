"""The port's native engine bindings (``sketches_tpu_torch.native``) against
``sketches_tpu.native``, on the CPU.

Both bind the same C++ sources (``native/``); the port builds its own copy
of the library into ``build/sketches_tpu_torch/``.  Tolerance: **exact** --
the same compiled arithmetic on the same f64 inputs, so bins, counters,
quantiles and the lifted ``to_state`` leaves must be equal (the state's
leaves compared as numpy arrays through ``convert.state_to_numpy``).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from sketches_tpu import batched as jb
from sketches_tpu import native as jn
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import convert
from sketches_tpu_torch import native as tn
from sketches_tpu_torch._build import BUILD_DIR
from sketches_tpu_torch.pb import wire
from sketches_tpu_torch.resilience import (
    EngineUnavailable,
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
)
from torch_proc_common import run
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

MAPPINGS = (
    "logarithmic",
    "linear_interpolated",
    "quadratic_interpolated",
    "cubic_interpolated",
)


@pytest.fixture(autouse=True)
def _fresh_load():
    # Both packages read one kill switch, SKETCHES_TPU_NATIVE, and each
    # caches its first load's outcome for the process: a JAX engine first
    # loaded under the switch, by an earlier test on this worker, would
    # stay "disabled" here.  Every test starts from a fresh load of both.
    jn.reset()
    tn.reset()
    yield
    jn.reset()
    tn.reset()


def _values(seed, n=20_000):
    r = np.random.RandomState(seed)
    v = r.lognormal(0, 2, n) * np.where(r.rand(n) < 0.4, -1, 1)
    v[r.rand(n) < 0.03] = 0.0
    v[:3] = [np.nan, 1e30, -1e-320]
    return v


def _pair(mapping, n_bins=512, key_offset=-200):
    return (
        jn.NativeDDSketch(0.01, n_bins, key_offset, mapping=mapping),
        tn.NativeDDSketch(0.01, n_bins, key_offset, mapping=mapping),
    )


@pytest.mark.parametrize("mapping", MAPPINGS)
def test_bins_counters_and_quantiles_equal_jax(mapping):
    a, b = _pair(mapping)
    v = _values(0)
    w = np.random.RandomState(1).exponential(1.0, v.size) + 0.01
    a.add_batch(v, w)
    b.add_batch(v, w)
    for x in (3.5, -2.25, 0.0):
        a.add(x, 2.0)
        b.add(x, 2.0)
    for x, y in zip(a.bins(), b.bins()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a._counters(), b._counters())
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0, -1.0, 2.0):
        assert a.get_quantile_value(q) == b.get_quantile_value(q)
    assert (b.collapsed_low, b.collapsed_high) == (a.collapsed_low, a.collapsed_high)


@pytest.mark.parametrize("mapping", MAPPINGS)
def test_to_state_equals_jax(mapping):
    a, b = _pair(mapping)
    v = _values(2)
    a.add_batch(v)
    b.add_batch(v)
    js = jax.block_until_ready(a.to_state())
    ts = b.to_state("cpu")
    ref = {f: np.asarray(getattr(js, f)) for f in tb.LEAVES}
    got = convert.state_to_numpy(ts)
    for f in tb.LEAVES:
        assert got[f].dtype == ref[f].dtype, f
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


@pytest.mark.parametrize("mapping", MAPPINGS)
def test_from_state_round_trip_equals_jax(mapping):
    r = np.random.RandomState(3)
    v = (r.lognormal(0, 1, (4, 256)) * np.where(r.rand(4, 256) < 0.3, -1, 1)).astype(np.float32)
    jspec = jb.SketchSpec(0.01, mapping_name=mapping, n_bins=512)
    tspec = tb.SketchSpec(0.01, mapping_name=mapping, n_bins=512)
    jst = jax.block_until_ready(jb.add(jspec, jb.init(jspec, 4), v))
    leaves = {f: np.asarray(getattr(jst, f)) for f in tb.LEAVES}
    tst = convert.state_from_numpy(tspec, leaves, device="cpu")
    for stream in (0, 3):
        a = jn.NativeDDSketch.from_state(jspec, jst, stream)
        b = tn.NativeDDSketch.from_state(tspec, tst, stream)
        assert b.key_offset == a.key_offset
        for x, y in zip(a.bins(), b.bins()):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a._counters(), b._counters())


def test_probes_and_merge():
    a, b = _pair("logarithmic")
    with pytest.raises(SketchValueError):
        b.add(1.0, 0.0)
    with pytest.raises(SketchValueError):
        b.add_batch(np.ones(3), np.ones(2))
    assert b.get_quantile_value(0.5) is None  # empty
    b.add_batch(np.arange(1, 101, dtype=np.float64))
    c = tn.NativeDDSketch(0.01, 512, -200)
    c.add_batch(np.arange(101, 201, dtype=np.float64))
    b.merge(c)
    assert b.count == 200.0 and b.avg == pytest.approx(100.5)
    with pytest.raises(UnequalSketchParametersError):
        b.merge(tn.NativeDDSketch(0.01, 512, -200, mapping="cubic_interpolated"))
    with pytest.raises(UnequalSketchParametersError):
        b.merge(tn.NativeDDSketch(0.01, 256, -200))
    with pytest.raises(SpecError):
        tn.NativeDDSketch(0.01, mapping="nope")


def test_library_builds_into_the_port_build_dir():
    assert tn.available()
    path = tn.library_path()
    assert path.parent == BUILD_DIR and path.is_file()
    assert path.name.startswith("libddsketch_host-")
    assert tn.status() == {"tier": "native", "wire": "native", "reason": None}


def test_failed_build_degrades_after_bounded_retries(monkeypatch):
    calls = []

    def broken():
        calls.append(1)
        raise OSError("no compiler")

    monkeypatch.setattr(tn, "_build", broken)
    monkeypatch.setattr(tn, "_BACKOFF_BASE_S", 0.0)
    assert not tn.available()
    assert len(calls) == tn._MAX_LOAD_ATTEMPTS
    st = tn.status()
    assert st["tier"] == "python" and st["wire"] == "python"
    assert "no compiler" in st["reason"]
    assert tn.wire_scanner() is None
    assert len(calls) == tn._MAX_LOAD_ATTEMPTS  # the outcome is cached
    with pytest.raises(EngineUnavailable):
        tn.NativeDDSketch()


def test_kill_switch(monkeypatch):
    monkeypatch.setenv(tn.NATIVE_ENV, "0")
    assert not tn.available()
    assert tn.status()["reason"] == "disabled via SKETCHES_TPU_NATIVE=0"
    monkeypatch.setenv(tn.NATIVE_ENV, "1")
    tn.reset()
    assert tn.available()


def test_stale_wire_abi_degrades_to_the_python_walker():
    class HostOnlyLib:
        def __getattr__(self, name):  # every symbol lookup misses
            raise AttributeError(name)

    assert tn._bind_wire(HostOnlyLib()) is False

    class OtherAbi:
        def __init__(self, lib):
            self._lib = lib
            self.ddsk_wire_abi_version = lambda: tn.WIRE_ABI_VERSION + 1
            self.ddsk_wire_scan_dense = lib.ddsk_wire_scan_dense

    assert tn.available()
    assert tn._bind_wire(OtherAbi(tn._lib)) is False

    spec = tb.SketchSpec(0.02, n_bins=128)
    r = np.random.RandomState(61)
    v = (r.lognormal(0, 1, (8, 64)) * np.where(r.rand(8, 64) < 0.5, -1, 1)).astype(np.float32)
    st = tb.add(spec, tb.init(spec, 8, "cpu"), torch.from_numpy(v))
    blobs = wire.state_to_bytes(spec, st)
    assert tn.wire_scanner() is not None
    ref = wire.bytes_to_state(spec, blobs, device="cpu")
    tn._wire_ok = False  # the stale-library outcome
    assert tn.wire_scanner() is None
    degraded = wire.bytes_to_state(spec, blobs, device="cpu")
    a, b = convert.state_to_numpy(ref), convert.state_to_numpy(degraded)
    for f in tb.LEAVES:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_a_wire_test_on_the_python_walker_leaves_the_jax_engine_loadable():
    """One worker's order that once failed this module's 13 comparisons
    with the JAX engine: a wire test on the pure-Python walker (the kill
    switch set) makes the process's first JAX engine load, then this
    module's comparisons run.  Each side loads afresh, so both pass."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
               "-p", "no:randomly",
               "tests/test_torch_wire.py::test_decode_foreign_shapes_like_jax[python]",
               "tests/test_torch_native.py::test_to_state_equals_jax[logarithmic]",
               "tests/test_torch_native.py::test_probes_and_merge"], cwd=root, timeout=300)
    assert out.returncode == 0 and "3 passed" in out.stdout, out.stdout + out.stderr

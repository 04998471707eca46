"""The port's fault-injection harness (``sketches_tpu_torch.faults``) and
kill-switch registry (``sketches_tpu_torch.analysis.registry``) against the
JAX package's, on the CPU.

Every selector is pure host code, so the comparison is exact: the same
plan and the same arguments give the same indices, coordinates and bytes,
byte for byte, over a grid of seeds and fractions.  ``apply_state_bitflips``
is compared bit for bit on the same bins.  The environment parser
(``SKETCHES_TPU_FAULTS``, shared by both packages) arms the same plans.
"""

import importlib

import numpy as np
import pytest
import torch

from sketches_tpu import faults as jf
from sketches_tpu import resilience as jr
from sketches_tpu.analysis import registry as jreg
from sketches_tpu_torch import faults as tf
from sketches_tpu_torch import resilience as tr
from sketches_tpu_torch.analysis import registry as treg
from torch_robust_common import reset_both
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

SEEDS = [0, 1, 7, 12345]
FRACTIONS = [0.0, 0.01, 0.3, 1.0]


@pytest.fixture(autouse=True)
def _clean():
    reset_both()
    yield
    reset_both()


# ---------------------------------------------------------------------------
# Surface
# ---------------------------------------------------------------------------


def test_sites_and_exports_match_jax():
    assert tf.SITES == jf.SITES and len(tf.SITES) == 19
    assert tf.ATOMIC_SITES == jf.ATOMIC_SITES
    assert set(jf.__all__) <= set(tf.__all__)
    for name in jf.__all__:
        if name.isupper():
            assert getattr(tf, name) == getattr(jf, name), name


def test_registry_matches_jax():
    assert set(jreg.__all__) == set(treg.__all__)
    assert [v.name for v in treg.declared()] == [v.name for v in jreg.declared()]
    for tv, jv in zip(treg.declared(), jreg.declared()):
        assert (tv.name, tv.default, tv.doc) == (jv.name, jv.default, jv.doc)
        assert tv.owner == jv.owner.replace("sketches_tpu.", "sketches_tpu_torch.", 1)
        assert treg.lookup(tv.name) is tv
    with pytest.raises(KeyError):
        treg.get("SKETCHES_TPU_UNDECLARED")


@pytest.mark.parametrize("value, on", [(None, True), ("0", False), ("1", True), ("yes", True)])
def test_registry_reads_like_jax(monkeypatch, value, on):
    from sketches_tpu_torch import kernels, native
    from sketches_tpu_torch.backends import uniform

    for var in (treg.OVERLAP, treg.NATIVE, treg.ADAPTIVE):
        if value is None:
            monkeypatch.delenv(var.name, raising=False)
        else:
            monkeypatch.setenv(var.name, value)
        assert treg.enabled(var) is jreg.enabled(var.name) is on
        assert treg.get(var) == jreg.get(var.name)
    # The three readers of the port go through the registry, under their
    # historical aliases.
    assert (kernels.OVERLAP_ENV, native.NATIVE_ENV, uniform.ADAPTIVE_ENV) == (
        "SKETCHES_TPU_OVERLAP", "SKETCHES_TPU_NATIVE", "SKETCHES_TPU_ADAPTIVE")
    assert kernels.overlap_enabled() is on and uniform.adaptive_enabled() is on


# ---------------------------------------------------------------------------
# Deterministic selectors: byte-equal to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fraction", FRACTIONS)
def test_selected_and_corrupt_blobs_byte_equal(seed, fraction):
    r = np.random.RandomState(seed)
    blobs = [r.bytes(int(n)) for n in r.randint(1, 40, 300)]
    assert [tf._selected(seed, i, fraction) for i in range(2000)] == [
        jf._selected(seed, i, fraction) for i in range(2000)
    ]
    got, idx = tf.corrupt_blobs(blobs, fraction, seed)
    want, jidx = jf.corrupt_blobs(blobs, fraction, seed)
    assert idx == jidx and got == want
    for i, b in enumerate(blobs[:30]):
        assert tf._corrupt(b, seed, i) == jf._corrupt(b, seed, i)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize(
    "site, fn, args",
    [
        ("STATE_BITFLIP", "state_bitflips", (1000, 512)),
        ("WINDOW_AGG_STALE", "agg_stale_flips", (64, 2048)),
        ("FABRIC_REPLICA_STALE", "replica_stale_flips", (3, 128)),
        ("SERVE_CACHE_POISON", "cache_poison_flip", (4096,)),
    ],
)
def test_coordinate_selectors_byte_equal(seed, site, fn, args):
    out = {}
    for mod in (jf, tf):
        mod.arm(getattr(mod, site), seed=seed, times=5)
        out[mod] = [getattr(mod, fn)(*args) for _ in range(8)]
        out[mod].append(mod.stats())
        mod.disarm()
    assert out[tf] == out[jf]
    assert sum(1 for x in out[tf][:8] if x) == 5  # the times cap


@pytest.mark.parametrize(
    "site, fn",
    [("MESH_SHARD", "dead_shards"), ("MESH_HOST_LOSS", "lost_hosts"),
     ("DCN_PARTITION", "partitioned_hosts")],
)
@pytest.mark.parametrize("shards, n", [((1,), 4), ((0, 3, 9), 4), ((5,), 2), ((), 8)])
def test_index_selectors_byte_equal(site, fn, shards, n):
    out = {}
    for mod, res in ((jf, jr), (tf, tr)):
        mod.arm(getattr(mod, site), shards=shards)
        out[mod] = ([getattr(mod, fn)(n) for _ in range(3)], mod.stats(),
                    res.health()["counters"])
        mod.disarm()
    assert out[tf] == out[jf]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", ["raise", "corrupt", "truncate"])
def test_inject_plans_match_jax(seed, mode):
    """The same plan fires on the same calls, with the same payloads, in
    both packages (``times`` cap, per-index fraction, tier filter)."""
    payload = bytes(range(40))
    logs = {}
    for mod in (jf, tf):
        log = []
        plans = {
            mod.PALLAS_LOWERING: dict(tier=("tiles", "wxla"), times=2, mode=mode, seed=seed),
            mod.WIRE_BLOB: dict(fraction=0.25, seed=seed, mode=mode),
        }
        with mod.active(plans) as armed:
            for i, tier in enumerate(["overlap", "tiles", "windowed", "wxla", "tiles", "xla"]):
                try:
                    log.append(mod.inject(mod.PALLAS_LOWERING, payload=payload, index=i, tier=tier))
                except Exception as e:  # noqa: BLE001 - the injected fault is the datum
                    log.append(type(e).__name__ + str(e))
            for i in range(40):
                try:
                    log.append(mod.inject(mod.WIRE_BLOB, payload=payload, index=i))
                except Exception as e:  # noqa: BLE001
                    log.append(type(e).__name__ + str(e))
            log.append({s: (p.calls, p.fired) for s, p in armed.items()})
        assert not mod._ACTIVE
        logs[mod] = log
    assert logs[tf] == logs[jf]


def test_injected_fault_type_and_counters():
    tf.arm(tf.CHECKPOINT_WRITE, times=1)
    with pytest.raises(tr.InjectedFault, match="checkpoint.write"):
        tf.inject(tf.CHECKPOINT_WRITE)
    assert tf.inject(tf.CHECKPOINT_WRITE, payload=b"x") == b"x"  # capped
    assert tr.health()["counters"] == {"faults.checkpoint.write": 1}
    assert isinstance(tr.InjectedFault("x"), tr.SketchError)


def test_arm_refuses_unknown_sites_and_modes():
    with pytest.raises(tr.SpecError):
        tf.arm("no.such.site")
    with pytest.raises(tr.SpecError):
        tf.arm(tf.WIRE_BLOB, mode="explode")
    assert not tf._ACTIVE


def test_disarmed_is_inert():
    payload = b"\x01\x02"
    assert not tf._ACTIVE and tf.stats() == {}
    for site in tf.SITES:
        assert tf.inject(site, payload=payload, index=3, tier="overlap") is payload
    assert tf.dead_shards(4) == tf.lost_hosts(4) == tf.partitioned_hosts(4) == ()
    assert tf.state_bitflips(8, 128) == tf.agg_stale_flips(8, 128) == ()
    assert tf.replica_stale_flips(8, 128) == ()
    assert tf.cache_poison_flip(64) is None
    assert tr.health() == {"tiers": {}, "counters": {}, "downgrades": [], "downgrades_dropped": 0}


@pytest.mark.parametrize("spec", [
    "native.load",
    "native.load:times=2;wire.blob:fraction=0.01,seed=7,mode=corrupt",
    "mesh.shard:shards=1|3;pallas.lowering:tier=tiles,times=1",
    " ;checkpoint.write:mode=truncate,times=1; ",
])
def test_env_parser_arms_the_same_plans(monkeypatch, spec):
    """``SKETCHES_TPU_FAULTS`` (shared by both packages) is read at import:
    the port's module, reloaded under it, arms the plans the JAX parser
    arms from the same string."""
    monkeypatch.setenv(treg.FAULTS.name, spec)
    importlib.reload(tf)
    try:
        got = {s: {k: getattr(p, k) for k in p.__slots__ if k not in ("exc",)}
               for s, p in tf._plans.items()}
        assert tf._ACTIVE
    finally:
        monkeypatch.delenv(treg.FAULTS.name)
        importlib.reload(tf)
    jf._parse_env(spec)
    want = {s: {k: getattr(p, k) for k in p.__slots__ if k not in ("exc",)}
            for s, p in jf._plans.items()}
    assert got == want
    assert not tf._ACTIVE and tf._plans == {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_apply_state_bitflips_matches_jax(dtype, seed):
    from sketches_tpu import batched as jb
    from sketches_tpu_torch import convert

    r = np.random.RandomState(seed)
    leaves = {
        "bins_pos": r.randint(0, 50, (16, 256)).astype(np.float32),
        "bins_neg": r.randint(0, 50, (16, 256)).astype(np.float32),
    }
    if dtype == torch.int32:
        leaves = {k: v.astype(np.int32) for k, v in leaves.items()}
    spec = convert.spec_from_fields(n_bins=256, bin_dtype=str(dtype).split(".")[-1])
    port = convert.state_from_numpy(spec, _full_leaves(leaves, spec), device="cpu")
    jstate = jb.init(jb.SketchSpec(n_bins=256, bin_dtype=np.dtype(str(dtype).split(".")[-1])), 16)
    import dataclasses

    import jax.numpy as jnp

    jstate = dataclasses.replace(jstate, bins_pos=jnp.asarray(leaves["bins_pos"]),
                                 bins_neg=jnp.asarray(leaves["bins_neg"]))
    tf.arm(tf.STATE_BITFLIP, seed=seed)
    flips = [tf.state_bitflips(16, 256)[0] for _ in range(6)] + [(0, 2, 7, 31), (1, 5, 0, 31)]
    bad = tf.apply_state_bitflips(port, flips)
    jbad = jf.apply_state_bitflips(jstate, flips)
    for f in ("bins_pos", "bins_neg"):
        np.testing.assert_array_equal(
            getattr(bad, f).numpy().view(np.uint32), np.asarray(getattr(jbad, f)).view(np.uint32))
        # The input state is untouched.
        np.testing.assert_array_equal(getattr(port, f).numpy(), leaves[f])
    assert tf.apply_state_bitflips(port, ()) is port


def _full_leaves(bins, spec):
    """A consistent state's leaves around the given bins."""
    from sketches_tpu_torch import batched as tb

    bp, bn = bins["bins_pos"], bins["bins_neg"]
    n = bp.shape[0]
    plo, phi = tb.occupied_bounds_np(bp)
    nlo, nhi = tb.occupied_bounds_np(bn)
    bd = bp.dtype
    return {
        "bins_pos": bp, "bins_neg": bn,
        "zero_count": np.zeros(n, bd),
        "count": (bp.sum(-1) + bn.sum(-1)).astype(bd),
        "sum": np.zeros(n, np.float32),
        "min": np.full(n, -1.0, np.float32), "max": np.full(n, 1.0, np.float32),
        "collapsed_low": np.zeros(n, bd), "collapsed_high": np.zeros(n, bd),
        "key_offset": np.full(n, spec.key_offset, np.int32),
        "pos_lo": plo.astype(np.int32), "pos_hi": phi.astype(np.int32),
        "neg_lo": nlo.astype(np.int32), "neg_hi": nhi.astype(np.int32),
        "neg_total": bn.sum(-1).astype(bd),
        "tile_sums": tb.tile_sums_np(bp, bn).astype(bd),
    }

"""The port's mappings (``sketches_tpu_torch.mapping``) against the JAX
package's, on the same f32 inputs.

Tolerances, with their reasons:

* Keys are compared **exactly**: on dense grids of positive normal values
  (FLT_MIN and +inf included) and on values one ulp either side of every
  bucket edge and representative of 2048-bin windows, ``value(k) * (1 +-
  2**-23)``.  That is the domain of ``key_array``; the sketches route
  |v| < FLT_MIN, NaN and negatives elsewhere before keying, which
  ``_keys_and_masks`` (compared exactly below, subnormals, NaN and -inf
  included) pins.  One known fault: at exact bucket edges the logarithmic
  mapping's key follows its backend's f32 ``log``, and torch's differs from
  XLA:CPU's by an ulp on some values (ROADMAP queue C);
  ``test_log_key_at_bucket_edges`` pins exactly where.
* Decoded values are compared at **rtol 1e-6**: the logarithmic and
  interpolated decodes' ``exp``/``exp2`` may differ by one ulp between
  XLA:CPU and torch.  The quadratic decode is compared **exactly**: its
  ``sqrt`` is taken in f64 and rounded once, which is correctly rounded as
  XLA:CPU's f32 ``sqrt`` is (torch's CPU f32 ``sqrt`` is not).
* The scalar path is the same ``math`` code in both packages: **exact**.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketches_tpu import batched as jb
from sketches_tpu import mapping as jm
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import mapping as tm
from sketches_tpu_torch.resilience import SpecError

NAMES = (
    "logarithmic",
    "linear_interpolated",
    "quadratic_interpolated",
    "cubic_interpolated",
)
F32 = np.float32
TINY = np.finfo(F32).tiny


def _edge_grid(jmap, lo_key, n_keys=2048):
    """For every key of a window: its representative ``value(k)`` and its
    exact upper bucket edge (the scalar path's inverse of the mapping's own
    log approximation), each scaled by (1 +- 2**-23) and nudged one f32 ulp
    either way."""
    keys = np.arange(lo_key, lo_key + n_keys)
    reps = np.array([jmap.value(int(k)) for k in keys], np.float64)
    edges = np.array([jmap._pow_gamma(float(k)) for k in keys], np.float64)
    out = []
    with np.errstate(over="ignore"):
        for base in (reps, edges):
            for scale in (1.0 - 2.0**-23, 1.0, 1.0 + 2.0**-23):
                e = (base * scale).astype(F32)
                out += [e, np.nextafter(e, F32(np.inf)), np.nextafter(e, F32(0))]
    g = np.concatenate(out)
    return g[np.isfinite(g) & (g >= TINY)]


def _dense_grid(seed):
    r = np.random.RandomState(seed)
    specials = np.array(
        [TINY, np.nextafter(TINY, F32(1)), 1.0, 2.0, 0.5, 3.0, np.finfo(F32).max, np.inf],
        F32,
    )
    pow2 = (2.0 ** np.arange(-126, 128)).astype(F32)
    return np.concatenate([r.lognormal(0, 8, 50_000).astype(F32), specials, pow2])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("alpha", [0.01, 0.002])
def test_key_array_matches_jax_exactly(name, alpha):
    j, t = jm.mapping_from_name(name, alpha), tm.mapping_from_name(name, alpha)
    grid = _dense_grid(1)
    if name != "logarithmic":
        # No transcendental on the interpolated mappings' key path: exact
        # at every bucket edge too.
        grid = np.concatenate([grid, _edge_grid(j, -1024), _edge_grid(j, 3000)])
    kj = np.asarray(j.key_array(jnp.asarray(grid)))
    kt = t.key_array(torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(kt, kj)


@pytest.mark.parametrize("alpha", [0.01, 0.002])
def test_log_key_at_bucket_edges(alpha):
    """Logarithmic keys at exact bucket edges: ceil(log(v) * m) is the same
    arithmetic in both packages, but torch's f32 ``log`` and XLA:CPU's
    differ by one ulp on some values, which moves an edge value by one key
    (ROADMAP queue C).  Pinned exactly: every key equals the reference
    formula evaluated on the port's own ``log``, the keys agree exactly
    wherever the two logs agree, and the disagreements are exactly the
    values where the logs differ."""
    j, t = jm.mapping_from_name("logarithmic", alpha), tm.mapping_from_name("logarithmic", alpha)
    grid = np.concatenate([_edge_grid(j, -1024), _edge_grid(j, 3000)])
    kj = np.asarray(j.key_array(jnp.asarray(grid)))
    kt = t.key_array(torch.from_numpy(grid)).numpy()
    log_j = np.asarray(jnp.log(jnp.asarray(grid)))
    log_t = torch.log(torch.from_numpy(grid)).numpy()
    same_log = log_j == log_t
    np.testing.assert_array_equal(kt[same_log], kj[same_log])
    m = np.float32(t._multiplier)
    np.testing.assert_array_equal(kt, np.ceil(log_t * m).astype(np.int32))
    np.testing.assert_array_equal(kj, np.ceil(log_j * m).astype(np.int32))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("lo_key", [-1024, 4000, -8000])
def test_value_array_matches_jax_on_a_2048_bin_window(name, lo_key):
    """Every key of a 2048-bin window decodes within rtol 1e-6; keys whose
    representative lies beyond f32 saturate identically."""
    j, t = jm.mapping_from_name(name, 0.01), tm.mapping_from_name(name, 0.01)
    keys = np.arange(lo_key, lo_key + 2048, dtype=np.int32)
    vj = np.asarray(j.value_array(jnp.asarray(keys)))
    vt = t.value_array(torch.from_numpy(keys)).numpy()
    assert vt.dtype == np.float32
    np.testing.assert_allclose(vt, vj, rtol=1e-6)
    sat = (vj == np.finfo(F32).max) | (vj == TINY)
    np.testing.assert_array_equal(vt[sat], vj[sat])


@pytest.mark.parametrize("alpha", [0.01, 0.05])
def test_quadratic_decode_matches_jax_exactly(alpha):
    """Keys -4000..4000 decode bit for bit as JAX eager does (key -51 at
    alpha 0.01 is 0.38553876; an f32 ``sqrt`` that is not correctly rounded
    gives 0.3855388)."""
    j = jm.mapping_from_name("quadratic_interpolated", alpha)
    t = tm.mapping_from_name("quadratic_interpolated", alpha)
    keys = np.arange(-4000, 4001, dtype=np.int32)
    vj = np.asarray(j.value_array(jnp.asarray(keys)))
    vt = t.value_array(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(vt, vj)
    if alpha == 0.01:
        assert vt[keys == -51][0] == F32(0.38553876)


@pytest.mark.parametrize("name", NAMES)
def test_keys_and_masks_classify_specials_like_jax(name):
    """Subnormals, +-0, NaN, +-inf, FLT_MIN and negatives: the three-way
    split, the clamped index and both clamp masks are exact."""
    spec_j = jb.SketchSpec(0.01, mapping_name=name, n_bins=512)
    spec_t = tb.SketchSpec(0.01, mapping_name=name, n_bins=512)
    row = np.array(
        [0.0, -0.0, 1e-40, -1e-40, TINY, -TINY, np.nextafter(TINY, F32(0)), np.nan,
         np.inf, -np.inf, 1.0, -1.0, 1e30, -1e-30, 3.5, -7.25],
        F32,
    )
    vals = np.stack([row, row[::-1], row * 2, row / 3]).astype(F32)
    koff = np.array([-256, -200, -300, 0], np.int32)
    got = tb._keys_and_masks(spec_t, torch.from_numpy(koff), torch.from_numpy(vals))
    ref = jb._keys_and_masks(spec_j, jnp.asarray(koff), jnp.asarray(vals))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("name", NAMES)
def test_scalar_path_matches_jax(name):
    j, t = jm.mapping_from_name(name, 0.01), tm.mapping_from_name(name, 0.01)
    for v in [1e-30, 0.37, 1.0, 2.0, 1234.5, 1e20, math.pi]:
        assert t.key(v) == j.key(v)
    for k in range(-500, 500, 7):
        assert t.value(k) == j.value(k)
    assert (t.gamma, t._multiplier, t.min_possible, t.max_possible) == (
        j.gamma, j._multiplier, j.min_possible, j.max_possible,
    )


def test_mapping_errors_and_identity():
    with pytest.raises(SpecError):
        tm.mapping_from_name("nope", 0.01)
    for bad in (0.0, 1.0, -0.5):
        with pytest.raises(SpecError):
            tm.LogarithmicMapping(bad)
    a, b = tm.mapping_from_name("cubic_interpolated", 0.01), tm.CubicallyInterpolatedMapping(0.01)
    assert a == b and hash(a) == hash(b)
    assert a != tm.LogarithmicMapping(0.01)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_constants_are_the_array_paths_f32_constants(name):
    """The constants handed to the CUDA kernels are the f32 roundings the
    JAX array path uses (weak-typed Python floats)."""
    j = jm.mapping_from_name(name, 0.01)
    c = tm.mapping_from_name(name, 0.01).kernel_constants()
    assert c.dtype == np.float32 and c.shape == (19,)
    cub = jm.CubicallyInterpolatedMapping
    want = [j._multiplier, 1.0 / j._multiplier, math.log(2.0 / (1.0 + j.gamma)),
            2.0 / (1.0 + j.gamma), 1.0 / 3.0, cub.A, cub.B, cub.C, *cub._INV_POLY]
    np.testing.assert_array_equal(c, np.asarray(want, F32))


def test_zero_threshold():
    assert tm.zero_threshold(torch.float32) == float(TINY)
    assert tm.zero_threshold(np.float32) == jm.zero_threshold(np.float32)

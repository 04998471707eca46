"""Shared helpers of the time-window, serving and fabric parity tests
(``test_torch_windows``, ``test_torch_windows_wire``, ``test_torch_serve``,
``test_torch_fabric``).

Both packages get the same seeded numpy batches and the same virtual-clock
op log.  The batches sit mid-bucket (XLA:CPU's f32 ``log`` is not
correctly rounded; half a bucket from an edge both packages key a value
alike), so bucket ledgers, fingerprints, plan digests and envelope bytes
compare bit for bit.  Decoded answers compare through :func:`same_answers`:
equal NaN positions, equal bucket keys, and values within rtol 1e-6 (the
JAX package decodes under ``jit``, whose ``exp`` may differ from torch's by
an ulp; ROADMAP queue C, "jitted decode").  A port answer is held to the
port's own :func:`oracle_quantile` bit for bit.
"""

import jax
import numpy as np
import torch
from sketches_tpu import batched as jb
from sketches_tpu import telemetry as jt
from sketches_tpu import windows as jw
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import telemetry as tt
from sketches_tpu_torch import windows as tw
from torch_robust_common import reset_both

ALPHA = 0.02
GAMMA = (1 + ALPHA) / (1 - ALPHA)
QS = [0.25, 0.5, 0.99]


def specs(**kw):
    """The same spec in both packages (JAX first)."""
    kw = {"relative_accuracy": ALPHA, **kw}
    if kw.get("backend", "dense") != "moment":
        kw.setdefault("n_bins", 128)
    jkw = dict(kw)
    if "bin_dtype" in kw:
        import jax.numpy as jnp

        jkw["bin_dtype"] = jnp.int32
        kw["bin_dtype"] = torch.int32
    return jb.SketchSpec(**jkw), tb.SketchSpec(**kw)


DENSE = specs()
ADAPTIVE = specs(backend="uniform_collapse", max_collapses=3)
MOMENT = specs(backend="moment", n_moments=8)


def configs(slices=(5.0, 20.0), lengths=(3, 3), levels=None):
    return (jw.WindowConfig(slices, lengths, levels), tw.WindowConfig(slices, lengths, levels))


CFG = configs()


def reset_all() -> None:
    reset_both()
    for telemetry in (jt, tt):
        telemetry.disable()
        telemetry.reset()


def mid_bucket(v):
    """Each nonzero value moved to the middle of its bucket in log space."""
    v = np.asarray(v, np.float64)
    a = np.abs(v)
    nz = a > 0
    k = np.ceil(np.log(np.where(nz, a, 1.0)) / np.log(GAMMA))
    return np.where(nz, np.sign(v) * GAMMA ** (k - 0.5), 0.0).astype(np.float32)


def batch(rng, n, width, sigma=0.7):
    return mid_bucket(rng.lognormal(0.0, sigma, (n, width)))


class Pair:
    """One ring in each package on one shared virtual-clock op log."""

    def __init__(self, spec=DENSE, config=CFG, n=8, t0=0.0, **kw):
        self.cj = jw.VirtualClock(t0)
        self.ct = tw.VirtualClock(t0)
        self.j = jw.WindowedSketch(n, spec=spec[0], config=config[0], clock=self.cj, **kw)
        self.t = tw.WindowedSketch(n, spec=spec[1], config=config[1], clock=self.ct,
                                   device="cpu", **kw)
        self.n = n

    def advance(self, dt):
        self.cj.advance(dt)
        self.ct.advance(dt)

    def add(self, values, weights=None):
        self.j.add(values, weights)
        jax.block_until_ready([b.state for r in self.j._rungs for b in r.values()]
                              + [self.j._live.state])
        self.t.add(values, weights)

    def drive(self, rng, steps, dt=(1.0, 5.0), width=16, sigma=0.7):
        for _ in range(steps):
            self.advance(float(rng.uniform(*dt)))
            self.add(batch(rng, self.n, width, sigma))

    def ledgers_equal(self) -> bool:
        return self.j.buckets() == self.t.buckets() and self.j.ledger() == self.t.ledger()

    def plans_equal(self, window) -> bool:
        pj, pt = self.j.window_plan(window), self.t.window_plan(window)
        return (pj.keys == pt.keys and pj.digest == pt.digest
                and np.array_equal(pj.fingerprint, pt.fingerprint)
                and pj.recipes == pt.recipes)


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(jax.block_until_ready(x))


def keys_of(v: np.ndarray) -> np.ndarray:
    a = np.abs(np.asarray(v, np.float64))
    ok = np.isfinite(a) & (a > 0)
    return np.where(ok, np.sign(v) * np.ceil(np.log(np.where(ok, a, 1.0)) / np.log(GAMMA)), 0)


def same_answers(a, b, rtol=1e-6, backend="dense") -> bool:
    """Port vs JAX decoded answers: NaN positions equal, bucket keys
    equal, values within ``rtol``.  Moment answers come from the same
    numpy solve on equal f32 states: equal outright."""
    a, b = host(a).astype(np.float64), host(b).astype(np.float64)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    if backend == "moment":
        return np.array_equal(a, b, equal_nan=True)
    ok = ~np.isnan(a)
    return (np.array_equal(keys_of(a[ok]), keys_of(b[ok]))
            and np.allclose(a[ok], b[ok], rtol=rtol, atol=0))

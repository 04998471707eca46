"""Shared helpers of the robustness-layer parity tests (``test_torch_resilience``,
``test_torch_faults``, ``test_torch_integrity``, ``test_torch_elastic``).

The fault plan, the integrity mode and the health ledger are per process
in both packages, and the tests run several files per worker: every test
starts and ends with both packages disarmed and both ledgers empty
(:func:`reset_both`, called from each file's autouse fixture).
"""

import numpy as np

from sketches_tpu import faults as jf
from sketches_tpu import integrity as ji
from sketches_tpu import resilience as jr
from sketches_tpu_torch import faults as tf
from sketches_tpu_torch import integrity as ti
from sketches_tpu_torch import resilience as tr

ALPHA = 0.01
GAMMA = (1 + ALPHA) / (1 - ALPHA)
QS = [0.5, 0.9, 0.99, 0.999]

#: The port's ingest tier labels stand for the JAX package's engine names.
INGEST_LABELS = {"kernel": "pallas", "plain": "xla"}


def reset_both() -> None:
    for faults, integrity, resilience in ((jf, ji, jr), (tf, ti, tr)):
        faults.disarm()
        integrity.arm("raise")  # the mode outlives disarm(): back to the default
        integrity.disarm()
        integrity.reset()
        resilience.reset()


def mid_bucket(v):
    """Each value moved to the middle of its bucket in log space, so both
    packages key it alike (XLA:CPU's f32 ``log`` is not correctly rounded;
    half a bucket from an edge, keys agree)."""
    a = np.abs(v).astype(np.float64)
    k = np.ceil(np.log(a) / np.log(GAMMA))
    return (np.sign(v) * GAMMA ** (k - 0.5)).astype(np.float32)


def mixed_batches(n, width, seed, n_batches=2):
    """Mid-bucket lognormal(0, 2) batches with 40% of the values negated:
    the traffic whose ladder runs overlap -> tiles -> windowed."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        v = r.lognormal(0, 2, (n, width)) * np.where(r.rand(n, width) < 0.4, -1, 1)
        out.append(mid_bucket(v))
    return out


def steps(health, labels=None):
    """The ledger's ``(component, from, to)`` sequence; ``labels`` maps the
    tier names (the ingest labels, for a comparison with the JAX package)."""
    m = labels or {}
    return [
        (e["component"], m.get(e["from_tier"], e["from_tier"]), m.get(e["to_tier"], e["to_tier"]))
        for e in health["downgrades"]
    ]

"""The port's time-window chaos campaign (``sketches_tpu_torch.chaos.
run_windowed_campaign``) against the JAX package's, on the CPU.  Its own
file because the JAX package's campaign is the slowest of the six (about
a minute here, run once); the port's mesh-backed ring draws on
``["cpu"] * 8``, as the JAX package's on its 8-device virtual mesh.  Also
the port's copies of ``test_windows.TestChaos``.
"""

import numpy as np
import pytest

from sketches_tpu import chaos as jc
from sketches_tpu_torch import chaos as tc
from sketches_tpu_torch.resilience import SketchValueError
from torch_chaos_common import CALLS, POOL, assert_parity, reset_layers, run_jax


@pytest.fixture(autouse=True)
def _clean():
    reset_layers()
    yield
    reset_layers()


def test_windowed_verdict_equals_jax():
    jv = run_jax(jc.run_windowed_campaign, *CALLS["windowed"])
    tv = tc.run_windowed_campaign(*CALLS["windowed"], device="cpu", devices=POOL)
    assert_parity(jv, tv, mass_keys=("ledgers", "expected", "virtual_clock_s", "serve_stats"))
    assert set(tv["ledgers"]) == {"dense", "adaptive", "mesh"}
    # The adaptive ring's per-rung effective alpha is f32 arithmetic on
    # the collapse level: the packages agree to one f32 rounding.
    np.testing.assert_allclose(tv["rung_effective_alpha"], jv["rung_effective_alpha"],
                               rtol=1e-6, atol=0)


def test_windowed_campaign_clean_and_deterministic():
    verdict = tc.run_windowed_campaign(40, seed=13, device="cpu", devices=POOL)
    assert verdict["ok"], verdict["errors"]
    assert verdict["outcomes"].get("undetected", 0) == 0
    again = tc.run_windowed_campaign(40, seed=13, device="cpu", devices=POOL)
    assert again["events"] == verdict["events"]


def test_one_entry_pool_has_no_mesh_ring():
    verdict = tc.run_windowed_campaign(20, seed=13, device="cpu", devices=["cpu"])
    assert verdict["ok"], verdict["errors"]
    assert set(verdict["ledgers"]) == {"dense", "adaptive"}


def test_campaign_rejects_bad_steps():
    with pytest.raises(SketchValueError):
        tc.run_windowed_campaign(0, seed=1, device="cpu", devices=POOL)

"""The port's time-window chaos campaign (``sketches_tpu_torch.chaos.
run_windowed_campaign``) against the JAX package's, on the CPU, at the JAX
test's step count and seed.  The slowest test of the port's suite (the
JAX campaign alone takes about a minute here): a file of its own, so
``--dist loadfile`` can run it beside the other long files instead of
behind them.  The port's mesh-backed ring draws on ``["cpu"] * 8``, as the
JAX package's on its 8-device virtual mesh.
"""

import numpy as np
import pytest

from sketches_tpu import chaos as jc
from sketches_tpu_torch import chaos as tc
from torch_chaos_common import CALLS, POOL, assert_parity, reset_layers, run_jax
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")


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

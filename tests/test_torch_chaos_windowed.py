"""The port's time-window chaos campaign (``sketches_tpu_torch.chaos.
run_windowed_campaign``) on the CPU: the port's copies of
``test_windows.TestChaos``.  The port's mesh-backed ring draws on
``["cpu"] * 8``, as the JAX package's on its 8-device virtual mesh.  The
verdict's parity with the JAX package's campaign is in
``test_torch_chaos_windowed_parity.py``.
"""

import pytest

from sketches_tpu_torch import chaos as tc
from sketches_tpu_torch.resilience import SketchValueError
from torch_chaos_common import POOL, reset_layers
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")


@pytest.fixture(autouse=True)
def _clean():
    reset_layers()
    yield
    reset_layers()


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

"""The port's elastic chaos campaign (``sketches_tpu_torch.chaos.
run_elastic_campaign``) against the JAX package's, on the CPU: the port's
meshes draw on ``["cpu"] * 8``, the JAX package's on its 8-device virtual
CPU mesh, so both regrow over 1/2/4/8 value shards.  Kept apart from
``test_torch_chaos`` by cost.  Also the port's copies of
``test_elastic.TestElasticCampaign``.
"""

import json

import pytest

from sketches_tpu import chaos as jc
from sketches_tpu_torch import chaos as tc
from sketches_tpu_torch.resilience import SketchValueError
from torch_chaos_common import CALLS, POOL, assert_parity, reset_layers, run_jax
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")


@pytest.fixture(autouse=True)
def _clean():
    reset_layers()
    yield
    reset_layers()


def test_elastic_verdict_equals_jax():
    jv = run_jax(jc.run_elastic_campaign, *CALLS["elastic"])
    tv = tc.run_elastic_campaign(*CALLS["elastic"], device="cpu", devices=POOL)
    assert_parity(jv, tv, mass_keys=("expected_count", "final_count", "dropped_count",
                                     "reshards", "mesh_sizes_visited"))
    assert tv["mesh_sizes_visited"] == [1, 2, 4, 8]


def test_campaign_verdict_and_determinism():
    verdict = tc.run_elastic_campaign(60, seed=3, device="cpu", devices=POOL)
    assert verdict["ok"], verdict["errors"]
    assert verdict["n_faults"] > 0
    assert verdict["outcomes"].get("undetected", 0) == 0
    assert verdict["reshards"] > 0
    assert len(verdict["mesh_sizes_visited"]) >= 2
    again = tc.run_elastic_campaign(60, seed=3, device="cpu", devices=POOL)
    assert again["events"] == verdict["events"]


def test_campaign_cli_exit_code(tmp_path):
    out = str(tmp_path / "verdict.json")
    rc = tc.main(["--campaign", "elastic", "--steps", "30", "--seed", "5",
                  "--out", out, "--device", "cpu"])
    assert rc == 0
    with open(out, encoding="utf-8") as f:
        verdict = json.load(f)
    assert verdict["campaign"] == "elastic" and verdict["ok"]
    assert verdict["mesh_sizes_visited"][-1] == 8  # the CLI's 8-entry pool


def test_one_entry_pool_soaks_without_growth():
    verdict = tc.run_elastic_campaign(30, seed=5, device="cpu", devices=["cpu"])
    assert verdict["ok"], verdict["errors"]
    assert verdict["mesh_sizes_visited"] == [1]


def test_campaign_rejects_bad_steps():
    with pytest.raises(SketchValueError):
        tc.run_elastic_campaign(0, seed=1, device="cpu", devices=POOL)

"""The port's chaos harness (``sketches_tpu_torch.chaos``) against the JAX
package's, on the CPU: the core, serve, adaptive and fabric campaigns (the
elastic and windowed ones have files of their own, by cost).

Verdict parity runs both packages' campaign at the JAX tests' step counts
and seeds (:mod:`torch_chaos_common`).  The rest are the port's copies of
the JAX tests that drive the harness (``test_integrity``'s closure verdict
and CLI, ``test_serve``'s campaign and CLI, ``test_backends``'
``TestAdaptiveCampaign``, ``test_fabric``'s armed and disarmed campaigns,
``test_tracing``'s chaos drill, ``test_fleet_obs``' embedded snapshot),
against the port alone.

The serve campaign's hedges and deadline misses ride the serving tier's
wall clock: the JAX package's first compiles make stragglers that the
port's CPU ops do not, so those counters (and the breaker they trip) are
left out of the serve comparison; every fault event and the mass still
compare equal.
"""

import json

import numpy as np
import pytest

from sketches_tpu import chaos as jc
from sketches_tpu_torch import chaos as tc
from sketches_tpu_torch import integrity as ti
from sketches_tpu_torch import telemetry as tt
from sketches_tpu_torch import tracing as ttr
from sketches_tpu_torch.analysis import registry
from sketches_tpu_torch.resilience import SketchValueError, SpecError
from torch_chaos_common import CALLS, assert_parity, events, reset_layers, run_jax


@pytest.fixture(autouse=True)
def _clean():
    reset_layers()
    yield
    reset_layers()


# ---------------------------------------------------------------------------
# Verdict parity with the JAX package
# ---------------------------------------------------------------------------


def test_core_verdict_equals_jax():
    jv = run_jax(jc.run_campaign, *CALLS["core"])
    tv = tc.run_campaign(*CALLS["core"], device="cpu")
    assert_parity(jv, tv, mass_keys=("expected_count", "final_count", "steps", "seed", "mode"))
    # The ingest-variant seam fired and demoted the kernel facade's rung.
    assert any(e[1] == "pallas.ingest_variant" for e in events(tv))
    assert tv["health"]["tiers"]["batched.ingest_variant"] == "stock"


#: Health entries the serving tier's wall clock drives (see the module doc).
SERVE_WALL_CLOCK = ("serve.hedges", "serve.deadline_misses", "downgrades", "serve.breaker")


def test_serve_verdict_equals_jax():
    jv = run_jax(jc.run_serve_campaign, *CALLS["serve"])
    tv = tc.run_serve_campaign(*CALLS["serve"], device="cpu")
    assert_parity(jv, tv, mass_keys=("expected_count", "campaign", "steps", "seed"),
                  wall_clock_health=SERVE_WALL_CLOCK)
    for k in ("requests", "shed", "cache_hits", "cache_misses", "cache_poisoned",
              "dispatches", "fused_dispatches", "tenants", "cache_entries"):
        assert tv["serve_stats"][k] == jv["serve_stats"][k], k


def test_adaptive_verdict_equals_jax():
    jv = run_jax(jc.run_adaptive_campaign, *CALLS["adaptive"])
    tv = tc.run_adaptive_campaign(*CALLS["adaptive"], device="cpu")
    assert_parity(jv, tv, mass_keys=("expected_count", "final_count", "final_levels"))
    np.testing.assert_allclose(tv["final_effective_alpha"], jv["final_effective_alpha"],
                               rtol=0, atol=1e-5)


def test_fabric_verdict_equals_jax():
    jv = run_jax(jc.run_fabric_campaign, *CALLS["fabric"])
    tv = tc.run_fabric_campaign(*CALLS["fabric"], device="cpu")
    assert_parity(jv, tv, mass_keys=("virtual_clock_s", "fabric_stats", "disarmed"))
    for nm, led in jv["ledgers"].items():
        got = tv["ledgers"][nm]
        for k in ("expected_total", "dropped_total", "ingested_total", "hosts"):
            assert got[k] == led[k], (nm, k)


def test_fabric_disarmed_verdict_equals_jax(monkeypatch):
    monkeypatch.setenv(registry.FABRIC.name, "0")
    jv = run_jax(jc.run_fabric_campaign, 10, 5)
    tv = tc.run_fabric_campaign(10, 5, device="cpu")
    assert tv["disarmed"] and jv["disarmed"]
    # The disarmed lane's single-process serving probe rides the wall clock.
    assert_parity(jv, tv, wall_clock_health=SERVE_WALL_CLOCK)


# ---------------------------------------------------------------------------
# The port's copies of the JAX tests that drive the harness
# ---------------------------------------------------------------------------


def test_core_campaign_verdict_and_determinism():
    verdict = tc.run_campaign(80, seed=3, device="cpu")
    assert verdict["ok"], verdict["errors"]
    assert verdict["n_faults"] > 0
    assert verdict["outcomes"].get("undetected", 0) == 0
    again = tc.run_campaign(80, seed=3, device="cpu")
    assert again["events"] == verdict["events"]


@pytest.mark.parametrize("campaign,steps,seed", [
    ("core", "40", "5"), ("serve", "40", "3"), ("elastic", "30", "5"),
    ("adaptive", "20", "5"), ("windowed", "20", "5"), ("fabric", "20", "5"),
])
def test_cli_exit_code_and_verdict(campaign, steps, seed, tmp_path, capsys):
    out = str(tmp_path / "verdict.json")
    rc = tc.main(["--campaign", campaign, "--steps", steps, "--seed", seed,
                  "--out", out, "--device", "cpu"])
    assert rc == 0
    with open(out, encoding="utf-8") as f:
        verdict = json.load(f)
    assert verdict["ok"] and verdict["steps"] == int(steps)
    if campaign != "core":
        assert verdict["campaign"] == campaign
    assert f"chaos: {steps} steps, seed {seed}," in capsys.readouterr().out


def test_cli_runs_as_a_module():
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "sketches_tpu_torch.chaos", "--steps", "12", "--seed", "4",
         "--device", "cpu"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ok=True" in out.stdout


@pytest.mark.parametrize("fn", [tc.run_campaign, tc.run_serve_campaign, tc.run_elastic_campaign,
                                tc.run_adaptive_campaign, tc.run_windowed_campaign,
                                tc.run_fabric_campaign])
def test_campaign_rejects_bad_steps(fn):
    with pytest.raises(SketchValueError):
        fn(0, seed=1)


def test_mesh_campaign_without_a_pool_needs_a_card():
    # No silent CPU run: without a card a mesh campaign names its pool.
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; the default pool is every CUDA device")
    with pytest.raises(SpecError):
        tc.run_elastic_campaign(4, seed=1)


def test_campaign_restores_integrity_arming():
    ti.arm("quarantine")
    tc.run_campaign(6, seed=4, device="cpu", mode="raise")
    assert ti.enabled() and ti.mode() == "quarantine"
    ti.disarm()
    tc.run_adaptive_campaign(6, seed=4, device="cpu")
    assert not ti.enabled()


def test_serve_campaign_clean_and_deterministic():
    verdict = tc.run_serve_campaign(60, seed=5, device="cpu")
    assert verdict["ok"], verdict["errors"]
    assert verdict["n_faults"] > 0
    assert verdict["outcomes"].get("undetected", 0) == 0
    again = tc.run_serve_campaign(60, seed=5, device="cpu")
    assert again["events"] == verdict["events"]


def test_adaptive_campaign_is_deterministic_and_clean():
    v1 = tc.run_adaptive_campaign(40, seed=13, device="cpu")
    v2 = tc.run_adaptive_campaign(40, seed=13, device="cpu")
    assert v1["ok"], (v1["errors"], v1["outcomes"])
    assert v1["outcomes"].get("undetected", 0) == 0
    assert v1["final_count"] == v1["expected_count"]
    assert v1["events"] == v2["events"]


def test_short_fabric_campaign_green():
    verdict = tc.run_fabric_campaign(40, seed=5, device="cpu")
    assert verdict["ok"], verdict["errors"]
    assert verdict["outcomes"].get("undetected", 0) == 0


def test_disarmed_fabric_campaign_green(monkeypatch):
    monkeypatch.setenv(registry.FABRIC.name, "0")
    verdict = tc.run_fabric_campaign(10, seed=5, device="cpu")
    assert verdict["ok"], verdict["errors"]
    assert verdict["disarmed"]


@pytest.mark.slow
def test_serve_campaign_produces_explainable_bundles():
    tt.enable()
    ttr.seed_ids(0)
    verdict = tc.run_serve_campaign(steps=40, seed=3, device="cpu")
    assert verdict["n_faults"] >= 1
    assert verdict["forensics"]["events"] > 0
    bundle = ttr.last_bundle()
    assert bundle is not None
    assert bundle["reason"].startswith("chaos.")
    lines, n = ttr.explain(bundle, "trigger")
    assert n >= 1
    assert any("serve.submit" in ln for ln in lines)


def test_chaos_verdict_embeds_snapshot_when_armed():
    tt.enable()
    tt.reset()
    verdict = tc.run_campaign(steps=12, seed=3, device="cpu")
    assert verdict["ok"], verdict["errors"]
    emb = verdict["telemetry"]
    assert isinstance(emb, dict)
    assert emb["counters"].get("integrity.checks", 0) > 0
    merged = tt.merge_snapshots(emb, emb)
    assert merged["merged_from"] == 2


def test_chaos_verdict_none_when_disarmed():
    verdict = tc.run_campaign(steps=6, seed=4, device="cpu")
    assert verdict["telemetry"] is None


def test_cli_writes_the_forensic_bundle(tmp_path, capsys):
    tt.enable()
    path = str(tmp_path / "b.json")
    rc = tc.main(["--campaign", "serve", "--steps", "40", "--seed", "3",
                  "--forensics", path, "--device", "cpu"])
    assert rc == 0
    with open(path, encoding="utf-8") as f:
        bundle = json.load(f)
    assert bundle["reason"].startswith("chaos.")
    assert ttr.main(["--explain", path, "trigger"]) == 0
    assert f"forensic bundle -> {path}" in capsys.readouterr().out

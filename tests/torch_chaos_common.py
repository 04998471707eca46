"""Shared helpers of the chaos-harness parity tests (``test_torch_chaos``,
``test_torch_chaos_elastic``, ``test_torch_chaos_windowed_parity``).

Each test runs one campaign of the JAX package and the same call of the
port (``device="cpu"``; the mesh campaigns on ``["cpu"] * 8``, the
counterpart of the JAX tests' 8-device virtual mesh) at the JAX tests' own
step counts and seeds, and holds the two verdicts together: ``ok``,
``n_faults``, ``outcomes`` and the events' ``(step, site, outcome)``
equal; the mass fields, ``integrity_reports`` and the health counters,
tiers and downgrade steps equal with ``==``.  The campaigns arm the
integrity layer and the fault plan, so every test starts and ends with
both packages' robustness and observability layers reset
(:func:`torch_obs_common.reset_layers`).
"""

import jax

from torch_obs_common import reset_layers

#: The JAX tests' step counts and seeds, campaign by campaign.
CALLS = {
    "core": (80, 3),
    "serve": (60, 5),
    "elastic": (60, 3),
    "adaptive": (40, 13),
    "windowed": (40, 13),
    "fabric": (40, 5),
}

#: The port's mesh campaigns take this pool (8 value shards on the CPU).
POOL = ["cpu"] * 8

__all__ = ["CALLS", "POOL", "events", "health_steps", "run_jax", "assert_parity", "reset_layers"]


def events(verdict):
    return [(e["step"], e["site"], e["outcome"]) for e in verdict["events"]]


def health_steps(health):
    return [(e["component"], e["from_tier"], e["to_tier"]) for e in health["downgrades"]]


def run_jax(fn, *args, **kwargs):
    """One JAX campaign, with its asynchronous work finished before the
    port's side runs (its CPU dispatch once disturbed the port's ops)."""
    verdict = fn(*args, **kwargs)
    jax.effects_barrier()
    return verdict


def assert_parity(jv, tv, mass_keys=(), wall_clock_health=()):
    """The verdict contract of the parity tests; ``wall_clock_health`` names
    health counters and tiers a wall clock drives (left out of ``==``)."""
    assert tv["ok"] and jv["ok"], (jv["errors"], tv["errors"])
    assert tv["n_faults"] == jv["n_faults"]
    assert tv["outcomes"] == jv["outcomes"]
    assert events(tv) == events(jv)
    assert tv["errors"] == jv["errors"] == []
    for key in mass_keys:
        assert tv[key] == jv[key], key
    if "integrity_reports" in jv:
        assert tv["integrity_reports"] == jv["integrity_reports"]
    jh, th = jv["health"], tv["health"]
    drop = set(wall_clock_health)
    assert {k: v for k, v in th["counters"].items() if k not in drop} == {
        k: v for k, v in jh["counters"].items() if k not in drop}
    assert {k: v for k, v in th["tiers"].items() if k not in drop} == {
        k: v for k, v in jh["tiers"].items() if k not in drop}
    assert [h for h in health_steps(th) if h[0] not in drop] == [
        h for h in health_steps(jh) if h[0] not in drop]

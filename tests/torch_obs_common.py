"""Shared helpers of the observability-layer parity tests
(``test_torch_telemetry``, ``test_torch_tracing``, ``test_torch_fleet_obs``).

Telemetry, the flight recorder, profiling and the accuracy audit are per
process in both packages: every test starts and ends with all four layers
disarmed and empty in both (:func:`reset_layers`, on top of the robustness
layer's :func:`torch_robust_common.reset_both`), the recorder back on its
default clock and capacity, and the id counter on its default seed.
"""

from sketches_tpu import accuracy as ja
from sketches_tpu import profiling as jpf
from sketches_tpu import telemetry as jt
from sketches_tpu import tracing as jtr
from sketches_tpu_torch import accuracy as ta
from sketches_tpu_torch import profiling as tpf
from sketches_tpu_torch import telemetry as tt
from sketches_tpu_torch import tracing as ttr
from torch_robust_common import reset_both

#: Telemetry names the JAX package exports and the port does not: the bench
#: regression gate over the JAX package's ``bench.py`` captures (the port's
#: benchmark is ``sketchbench/``).
TELEMETRY_JAX_ONLY = frozenset(
    ("check_bench", "capture_class", "capture_mismatch", "find_comparable_pair",
     "snapshot_from_bench"))
#: Telemetry names only the port exports: the hot path's span seam.
TELEMETRY_PORT_ONLY = frozenset(("call_spans", "CALL_SPANS", "PROFILER_PREFIX"))

#: The port's engine labels stand for the JAX package's: ingest
#: ``kernel``/``plain`` for ``pallas``/``xla``, the distributed ingest
#: ``shards`` for ``shard_map``.
ENGINE_LABELS = {"kernel": "pallas", "plain": "xla", "shards": "shard_map"}


def reset_layers() -> None:
    reset_both()
    for telemetry, tracing, profiling, accuracy in ((jt, jtr, jpf, ja), (tt, ttr, tpf, ta)):
        telemetry.disable()
        telemetry.reset()
        tracing.disable()
        tracing.reset()
        tracing.configure(capacity=tracing.RECORDER_CAPACITY)
        tracing._clock = None  # back on telemetry.clock
        profiling.disable()
        profiling.reset()
        accuracy.disable()
        accuracy.reset()


def arm_telemetry() -> None:
    """Telemetry (and with it the flight recorder) armed in both packages."""
    jt.enable()
    tt.enable()


def map_labels(key: str) -> str:
    """A rendered series key with the port's engine labels mapped to JAX's."""
    for port, jax_name in ENGINE_LABELS.items():
        for label in ("engine", "tier"):
            key = key.replace(f'{label}="{port}"', f'{label}="{jax_name}"')
    return key


def jax_series(keys) -> list:
    """Rendered series keys with the port's engine labels mapped, less the
    port's own spans (``telemetry.CALL_SPANS``), which the JAX package
    does not record."""
    from sketches_tpu_torch.telemetry import CALL_SPANS

    return sorted({map_labels(k) for k in keys if k.split("{", 1)[0] not in CALL_SPANS})


def map_row(key: str) -> str:
    """A profiling ``phase/tier`` row key with the port's engine label mapped."""
    phase, tier = key.split("/", 1)
    return f"{phase}/{ENGINE_LABELS.get(tier, tier)}"

"""End-to-end example: a chaos drill with kill-and-restore recovery.

Scenario: a long-lived aggregation process maintains a fleet of
sketches, checkpointing periodically, when disaster strikes twice --
first silent state corruption (a bit flip in a bin vector), then a hard
crash mid-campaign.  With the integrity layer armed the corruption is
*detected* (invariant check + fingerprint lane) instead of quietly
biasing the p99, and the crash recovers **exactly** from the last good
checkpoint: restored counts and quantiles are bit-identical to what was
saved, proven here against a parallel bookkeeping oracle.

The drill prints the integrity verdict (violations caught, repairs
applied, reports recorded) and the telemetry snapshot of its own run
(`integrity.checks` / `integrity.violations` counters, checkpoint and
merge spans) -- the same artifacts a production operator would export.

Runs on the card (``--device cpu`` for the CPU):
    python -m sketches_tpu_torch.examples.chaos_drill
"""

import os
import sys
import tempfile

import numpy as np

from sketches_tpu_torch import checkpoint, faults, integrity, telemetry
from sketches_tpu_torch.batched import BatchedDDSketch, SketchSpec, resolve_device
from sketches_tpu_torch.examples import host, parser
from sketches_tpu_torch.resilience import IntegrityError

N_STREAMS = 256
N_BINS = 256
BATCH = 512
ROUNDS = 12
CKPT_EVERY = 5  # leaves un-checkpointed tail rounds for the crash to lose
QS = [0.5, 0.9, 0.99]


def main(argv=None) -> int:
    device = resolve_device(parser(__doc__).parse_args(argv).device)
    with tempfile.TemporaryDirectory(prefix="chaos_drill_") as tmp:
        return _drill(device, os.path.join(tmp, "fleet.ckpt"))


def _drill(device, ckpt: str) -> int:
    telemetry.enable()
    integrity.arm("raise")
    rng = np.random.default_rng(42)
    spec = SketchSpec(relative_accuracy=0.01, n_bins=N_BINS)
    sk = BatchedDDSketch(N_STREAMS, spec=spec, device=device)

    print(f"chaos drill: {N_STREAMS} streams x {ROUNDS} rounds of {BATCH}")
    saved_round = -1
    saved_count = 0.0
    for r in range(ROUNDS):
        sk.add(rng.lognormal(0.0, 0.6, (N_STREAMS, BATCH)).astype(np.float32))
        if (r + 1) % CKPT_EVERY == 0:
            checkpoint.save_state(ckpt, spec, sk.state)
            saved_round = r
            saved_count = float(host(sk.state.count, np.float64).sum())
            print(f"  round {r}: checkpointed ({saved_count:.0f} values)")

    # --- disaster 1: silent corruption -------------------------------
    with faults.active({faults.STATE_BITFLIP: dict(seed=11, times=1)}):
        flips = faults.state_bitflips(N_STREAMS, N_BINS)
    corrupted = faults.apply_state_bitflips(sk.state, flips)
    print(f"\nbit flip injected at (store, stream, bin, bit) = {flips[0]}")
    try:
        integrity.verify_state(spec, corrupted, seam="drill.bitflip")
        print("  corruption passed the invariant checker (below the")
        print("  rounding floor) -- the fingerprint lane is the backstop:")
        fp_ok = np.allclose(
            integrity.fingerprint(spec, corrupted),
            integrity.fingerprint(spec, sk.state),
        )
        print(f"  fingerprint unchanged: {fp_ok}")
    except IntegrityError as e:
        print(f"  DETECTED: {e}")
        repaired, repairs = integrity.repair(spec, corrupted)
        print(
            f"  repair(): {repairs.n_violations} field(s) rewritten"
            f" ({[v.invariant for v in repairs.violations]});"
            f" repaired state verifies clean:"
            f" {not integrity.check_state(spec, repaired)}"
        )

    # --- disaster 2: hard crash + restore ----------------------------
    pre_crash_q = host(sk.get_quantile_values(QS))
    del sk  # the process "dies"; only the checkpoint survives
    spec2, state2 = checkpoint.restore_state(ckpt, device)  # armed: verified + fp
    restored = BatchedDDSketch(N_STREAMS, spec=spec2, state=state2, device=device)
    got = float(host(restored.state.count, np.float64).sum())
    expected = N_STREAMS * BATCH * (saved_round + 1)
    print(f"\ncrash after round {ROUNDS - 1}; restored checkpoint from"
          f" round {saved_round}")
    print(f"  restored count: {got:.0f} (saved {saved_count:.0f},"
          f" expected {expected:.0f}) exact={got == saved_count}")
    assert got == saved_count == expected

    # Replay the lost rounds from the same seeded stream positions the
    # originals used -- recovery is exact, so the replayed fleet answers
    # like the one that died.
    rng2 = np.random.default_rng(42)
    for r in range(ROUNDS):
        vals = rng2.lognormal(0.0, 0.6, (N_STREAMS, BATCH)).astype(np.float32)
        if r > saved_round:
            restored.add(vals)
    post_q = host(restored.get_quantile_values(QS))
    drift = float(np.nanmax(np.abs(post_q - pre_crash_q) /
                            np.maximum(np.abs(pre_crash_q), 1e-9)))
    print(f"  replayed rounds {saved_round + 1}..{ROUNDS - 1};"
          f" max quantile drift vs pre-crash fleet: {drift:.2e}")
    assert drift == 0.0, "exact recovery must reproduce the answers"

    # --- verdicts ----------------------------------------------------
    snap = telemetry.snapshot()
    checks = {k: v for k, v in snap["counters"].items()
              if k.startswith("integrity.")}
    print("\nintegrity/telemetry verdict:")
    print(f"  counters: {checks}")
    print(f"  reports recorded: {len(integrity.reports())}")
    print(f"  health counters: {snap['resilience']['counters']}")
    print("drill complete: corruption detected, crash recovered exactly")
    integrity.disarm()
    telemetry.disable()
    return 0


if __name__ == "__main__":
    sys.exit(main())

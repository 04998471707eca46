"""Readings for the limits of ``correct``, several seeds in one process:

    python3 sketchbench/control.py --workload NAME --seeds 1,2,3 --seconds S [--control]

Each seed runs the cell as ``run.py`` runs it (set-up, a window of ``S``
seconds, the check) and prints its result line.  ``--control`` puts the
bfloat16 reference (``reference/bf16_system.py``) in the program's place:
the check has to find it wrong.  ``--cpu-rehearsal`` and ``--streams``
pass through to each run.
"""

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import argparse  # noqa: E402

from sketchbench import cell  # noqa: E402
from sketchbench.reference.bf16_system import Bf16System  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sketchbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--cpu-rehearsal", action="store_true")
    p.add_argument("--streams", default="0")
    args = p.parse_args(argv)
    rc = 0
    for seed in args.seeds.split(","):
        run = ["--workload", args.workload, "--seed", seed, "--seconds", args.seconds,
               "--streams", args.streams]
        if args.cpu_rehearsal:
            run.append("--cpu-rehearsal")
        rc |= cell.main(run, system_factory=Bf16System if args.control else None)
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark (``BENCHMARK.json`` at the checkout's root):

    python3 sketchbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The last line printed is the run's result, one JSON object.  Without a
CUDA device the run fails; ``--cpu-rehearsal`` (with ``--streams`` to
shrink the cell) runs it on the CPU instead and reports no metric.
"""

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The checkout's root, not this directory, heads the import path.
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from sketchbench import cell  # noqa: E402

if __name__ == "__main__":
    sys.exit(cell.main(sys.argv[1:], started=STARTED))

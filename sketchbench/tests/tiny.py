"""A tiny cell made of data files and a manifest entry alone, for the CPU
tests: a new configuration and a new traffic mix in a directory of their
own, run by the harness's own code."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
RUN = REPO / "sketchbench" / "run.py"

CONFIG = {
    "name": "tiny_cubic", "n_streams": 256, "relative_accuracy": 0.02,
    "mapping": "cubic_interpolated", "store": "collapsing_lowest_dense",
    "bin_limit": 512, "bin_dtype": "float32",
}
TRAFFIC = {
    "loop": "dashboard",
    "values": {"kind": "latency", "mu_low": -2.0, "mu_high": 3.0, "sigma": 1.5},
    "flush": {"kind": "ragged_zipf", "width": 128, "exponent": 1.2, "live_share": 0.3},
    "quantiles": [0.25, 0.5, 0.999],
    "pool": 3,
    "trace_steps": 2,
    "check": {"rows": 64, "heaviest": 4,
              "limits": {"rows_off": 0, "sum_gap": 1e-3, "answers_off": 0}},
}


def write_cell(root: Path, **config) -> Path:
    """The tiny cell's files under ``root``, its configuration updated by
    ``config``; returns its manifest."""
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "sketchbench" / "configs").mkdir(parents=True)
    (root / "sketchbench" / "traffic").mkdir(parents=True)
    body = json.dumps(dict(CONFIG, **config))
    (root / "sketchbench" / "configs" / "tiny_cubic.json").write_text(body)
    (root / "sketchbench" / "traffic" / "tiny_mix.json").write_text(json.dumps(TRAFFIC))
    cell = {"name": "tiny.dash", "config": "tiny_cubic", "traffic": "tiny_mix", "chips": 1,
            "why": "a tiny test cell"}
    manifest = dict(real, configs=[{"name": "tiny_cubic", "source": "https://example.org",
                                    "file": "sketchbench/configs/tiny_cubic.json",
                                    "reduced": [], "why": "test"}],
                    workloads=[cell])
    for group in ("end_to_end", "per_layer"):
        manifest[group] = [dict(m, workloads=["tiny.dash"]) if "workloads" in m else m
                           for m in real[group]]
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    return path


def run(args, timeout=300):
    return subprocess.run([sys.executable, str(RUN), *args], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


def result(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])

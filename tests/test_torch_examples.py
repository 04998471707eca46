"""The port's examples (``sketches_tpu_torch.examples``) stay runnable: each
runs as ``python -m sketches_tpu_torch.examples.<name> --device cpu`` and
exits 0 with its closing line, as ``test_examples`` holds the JAX
package's scripts.  protobuf is installed here, so ``wire_interop`` takes
the object bridge."""

import os
import sys

import pytest
from torch_proc_common import run
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Lines each example must print; the last one is on its closing line.
EXPECT = {
    "latency_monitoring": ["worst p99: endpoint", "proto round-trip:"],
    "distributed_mesh": ["devices: 8 x cpu", "kill-and-regrow: 4 -> 8 devices",
                         "elastic drill passed"],
    "heterogeneous_fleet": ["mesh: {'streams': 2, 'values': 4}", "OK"],
    "wire_interop": ["stream 7 via the object bridge:", "re-export: 4096/4096 blobs byte-identical"],
    "chaos_drill": ["DETECTED:", "drill complete: corruption detected, crash recovered exactly"],
    "fleet_dashboard": ["check-slo:", "SLO(s) within budget"],
    "serve_load": ["verdict           ok"],
    "windowed_dashboard": ["windowed dashboard passed: ledger exact, oracle bit-identical"],
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_example_runs_clean(name, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    env["TMPDIR"] = str(tmp_path)
    # The suite runs six workers on a few cores: a torch thread pool as
    # wide as the machine in every example process (and fleet_dashboard's
    # shards) oversubscribes the cores, and its spin-waits then stretch a
    # 4 ms CPU ingest past the examples' latency SLOs.  One thread each.
    env.setdefault("OMP_NUM_THREADS", "1")
    out = run(
        [sys.executable, "-m", f"sketches_tpu_torch.examples.{name}", "--device", "cpu"],
        timeout=300, env=env, cwd=str(tmp_path),
    )
    assert out.returncode == 0, out.stdout + "\n" + out.stderr
    for line in EXPECT[name]:
        assert line in out.stdout, out.stdout
    assert EXPECT[name][-1] in out.stdout.splitlines()[-1], out.stdout


def test_examples_need_a_card_by_default():
    # No silent CPU run: without --device an example asks for the card.
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run([sys.executable, "-m", "sketches_tpu_torch.examples.wire_interop"],
              timeout=120, cwd=_ROOT)
    assert out.returncode != 0 and "device='cpu'" in out.stderr

"""Card-only: a short run of each cell on the card is correct and names
the card and its power limit.  Run on the card with
``python -m pytest -p no:cacheprovider sketchbench/tests/test_sketchbench_card.py``."""

import json

import pytest

from sketchbench.tests import tiny

pytestmark = pytest.mark.cuda

CELLS = ("ddlog.ingest_ragged", "ddlog.dash_wide", "ddcubic.dash_narrow",
         "ddcubic.ingest_dense")


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("workload", CELLS)
def test_short_run_on_the_card(card, workload):
    out = tiny.run(["--workload", workload, "--seed", str(2 ** 32 + 11), "--seconds", "3"],
                   timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = tiny.result(out.stdout)
    assert res["correct"] is True
    assert res["device"] == dict(res["device"], platform="gpu", kind=card, count=1)
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    line = [json.loads(l) for l in out.stdout.splitlines() if '"info": "card"' in l][0]
    assert line["name"] == card and " W" in line["nvidia_smi"]

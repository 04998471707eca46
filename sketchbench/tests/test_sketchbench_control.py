"""The control, the reference computed in bfloat16 in the program's
place, comes out not correct in every cell, on every number it reads
(``control.py`` runs the same on the card at the cells' own size)."""

import json

import pytest

from sketchbench import cell
from sketchbench.reference.bf16_system import Bf16System

CELLS = ("ddlog.ingest_ragged", "ddlog.dash_wide", "ddcubic.dash_narrow",
         "ddcubic.ingest_dense")


@pytest.mark.parametrize("workload", CELLS)
def test_bf16_control_is_not_correct(capsys, workload):
    rc = cell.main(["--workload", workload, "--seed", str(2 ** 35 + 1), "--seconds", "0.5",
                    "--cpu-rehearsal", "--streams", "512"], system_factory=Bf16System)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False
    for name, number in res["check"].items():
        assert number["value"] > number["limit"], name

"""The system a configuration names: ``batched`` by default or by name,
and an unknown one fails with no result."""

import json

from sketchbench import cell
from sketchbench.tests import tiny


def run(manifest, seed=2 ** 33 + 5):
    return cell.main(["--manifest", str(manifest), "--workload", "tiny.dash", "--seed",
                      str(seed), "--seconds", "0.5", "--cpu-rehearsal"])


def lines(stdout):
    return [json.loads(l) for l in stdout.strip().splitlines()]


def test_batched_by_name_runs_as_the_default(tmp_path, capsys):
    outs = []
    for sub, config in (("default", {}), ("named", {"system": "batched"})):
        assert run(tiny.write_cell(tmp_path / sub, **config)) == 0
        outs.append(lines(capsys.readouterr().out))
    for out in outs:
        res = out[-1]
        assert res["correct"] is True and res["attempted"] > 0
        assert set(res["check"]) == {"rows_off", "sum_gap", "answers_off"}
    described = [next(l for l in out if l.get("info") == "cell")["system"] for out in outs]
    assert described[0] == described[1]
    assert described[0]["n_bins"] == tiny.CONFIG["bin_limit"]


def test_unknown_system_fails_with_no_result(tmp_path, capsys):
    rc = run(tiny.write_cell(tmp_path, system="nosuch"))
    out, err = capsys.readouterr()
    assert rc != 0
    assert "sketchbench.systems.nosuch" in err
    assert '"correct"' not in out

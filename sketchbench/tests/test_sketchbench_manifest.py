"""``BENCHMARK.json`` against the benchmark's contract, and a new cell
from data files alone."""

import json
import re

import pytest

from sketchbench.tests import tiny

REPO = tiny.REPO
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_shape():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "sketchbench/run.py"]
    assert MANIFEST["paths"] == ["sketchbench"]
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_the_full_check():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    names = [e["name"] for g in groups for e in MANIFEST[g]]
    assert all(NAME.match(n) for n in names)
    for g in ("configs", "workloads"):
        assert len({e["name"] for e in MANIFEST[g]}) == len(MANIFEST[g])
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for e in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert LINE.match(e["why"])


def check_config(entry: dict, body: dict) -> None:
    """A configuration entry and its file against the contract: sizes, the
    system it names, and every key it cut stated with its published value
    and the deployment it stands for (model-configs guide, section 4)."""
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["source"].startswith("https://") and LINE.match(entry["source"])
    assert entry["file"].startswith("sketchbench/configs/")
    for key in ("n_streams", "bin_limit"):
        assert type(body[key]) is int and body[key] > 0, key
    system = body.get("system", "batched")
    assert NAME.match(system) and (REPO / "sketchbench" / "systems" / f"{system}.py").is_file()
    reduced = entry["reduced"]
    assert isinstance(reduced, list) and len(reduced) <= 16
    for key in reduced:
        assert NAME.match(key) and key in body, key
    if reduced:
        published = body.get("published")
        assert isinstance(published, dict) and set(reduced) <= set(published)
        assert isinstance(body.get("deployment"), str) and LINE.match(body["deployment"])


def check_workloads(workloads: list, configs: set) -> None:
    """Cells against the contract: known configurations, one cell a pair of
    configuration and traffic, 1 or 4 chips, and at most a quarter of the
    cells (one always) on 4."""
    pairs = set()
    for w in workloads:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in workloads) <= max(1, len(workloads) // 4)


def test_configs():
    for c in MANIFEST["configs"]:
        assert (REPO / c["file"]).is_file()
        check_config(c, json.loads((REPO / c["file"]).read_text()))
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])
    assert len({c["file"] for c in MANIFEST["configs"]}) == len(MANIFEST["configs"])


def test_workloads():
    check_workloads(MANIFEST["workloads"], {c["name"] for c in MANIFEST["configs"]})
    for w in MANIFEST["workloads"]:
        t = json.loads((REPO / "sketchbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (REPO / "sketchbench" / "loops" / f"{t['loop']}.py").is_file()
        for part in ("values", "flush"):
            assert (REPO / "sketchbench" / "gen" / f"{t[part]['kind']}.py").is_file()


REDUCED_ENTRY = {"name": "tiny_cut", "source": "https://example.org/deployment",
                 "file": "sketchbench/configs/tiny_cut.json", "reduced": ["n_streams"],
                 "why": "a synthetic cut configuration"}
REDUCED_BODY = dict(tiny.CONFIG, n_streams=65_536, system="batched",
                    published={"n_streams": 1 << 22},
                    deployment="one card of four that share the published streams")


def test_config_contract_accepts_a_reduced_deployment():
    check_config(REDUCED_ENTRY, REDUCED_BODY)
    check_config(dict(REDUCED_ENTRY, reduced=[]), tiny.CONFIG)


@pytest.mark.parametrize("entry, body", [
    (REDUCED_ENTRY, {k: v for k, v in REDUCED_BODY.items() if k != "published"}),
    (REDUCED_ENTRY, {k: v for k, v in REDUCED_BODY.items() if k != "deployment"}),
    (REDUCED_ENTRY, dict(REDUCED_BODY, published={"bin_limit": 2048})),
    (dict(REDUCED_ENTRY, reduced=["n_streams", "window_s"]),
     dict(REDUCED_BODY, published={"n_streams": 1 << 22, "window_s": 300})),
    (dict(REDUCED_ENTRY, reduced="n_streams"), REDUCED_BODY),
    (REDUCED_ENTRY, dict(REDUCED_BODY, system="nosuch")),
    (REDUCED_ENTRY, dict(REDUCED_BODY, n_streams=0)),
    (REDUCED_ENTRY, dict(REDUCED_BODY, bin_limit=512.0)),
], ids=["no-published", "no-deployment", "published-lacks-key", "key-not-in-file",
        "reduced-not-a-list", "unknown-system", "no-streams", "float-bins"])
def test_config_contract_rejects(entry, body):
    with pytest.raises(AssertionError):
        check_config(entry, body)


def cells(n_cells, n_four):
    return [{"name": f"c{i}", "config": "tiny_cubic", "traffic": f"t{i}",
             "chips": 4 if i < n_four else 1, "why": "a synthetic cell"}
            for i in range(n_cells)]


@pytest.mark.parametrize("n_cells, n_four, ok", [
    (1, 1, True), (3, 1, True), (3, 2, False), (8, 2, True), (8, 3, False), (24, 6, True),
    (24, 7, False),
])
def test_four_chip_cells_are_capped(n_cells, n_four, ok):
    workloads = cells(n_cells, n_four)
    if ok:
        check_workloads(workloads, {"tiny_cubic"})
    else:
        with pytest.raises(AssertionError):
            check_workloads(workloads, {"tiny_cubic"})


def test_chips_are_one_or_four():
    with pytest.raises(AssertionError):
        check_workloads([dict(cells(1, 0)[0], chips=2)], {"tiny_cubic"})


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = [w["name"] for w in MANIFEST["workloads"]]
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        assert (REPO / "sketchbench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell)
    for cell in cells:
        others = [n for n, m in e2e.items() if n != "setup_s" and reports(m, cell)]
        assert others, cell
        assert any(reports(m, cell) for m in MANIFEST["per_layer"]), cell


def test_a_new_cell_from_data_files_alone(tmp_path):
    """A configuration, a traffic mix and a manifest entry that no code
    names run through the harness unchanged."""
    manifest = tiny.write_cell(tmp_path)
    out = tiny.run(["--manifest", str(manifest), "--workload", "tiny.dash", "--seed",
                    str(2 ** 40 + 3), "--seconds", "0.5", "--cpu-rehearsal"])
    assert out.returncode == 0, out.stderr[-2000:]
    res = tiny.result(out.stdout)
    assert res["correct"] is True and res["attempted"] > 0
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "check"
    assert set(res["check"]) == {"rows_off", "sum_gap", "answers_off"}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    cell = [json.loads(l) for l in out.stdout.splitlines() if '"info": "cell"' in l][0]
    assert cell["config"] == "tiny_cubic" and cell["n_streams"] == 256


def test_no_card_no_result():
    """Without a CUDA device a run fails and prints no result."""
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("this test needs a machine without a CUDA device")
    out = tiny.run(["--workload", "ddlog.dash_wide", "--seed", "1", "--seconds", "1"])
    assert out.returncode != 0
    assert '"correct"' not in out.stdout

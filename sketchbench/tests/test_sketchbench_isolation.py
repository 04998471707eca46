"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (``sketches_tpu_torch`` begins with
``sketches_tpu``), and the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

from sketchbench.tests import tiny

REPO = tiny.REPO
BENCH = REPO / "sketchbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "sketches_tpu"}

PROBE = """
import json, runpy, sys
sys.argv = [{run!r}, *{args!r}]
try:
    runpy.run_path({run!r}, run_name="__main__")
except SystemExit as e:
    code = e.code
print("MODULES " + json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def modules_after(args):
    code = PROBE.format(run=str(BENCH / "run.py"), args=list(args))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("MODULES ")][-1]
    return set(json.loads(line[len("MODULES "):])), out.stdout


def test_rehearsal_loads_no_jax(tmp_path):
    manifest = tiny.write_cell(tmp_path)
    mods, stdout = modules_after(["--manifest", str(manifest), "--workload", "tiny.dash",
                                  "--seed", "9", "--seconds", "0.3", "--cpu-rehearsal"])
    assert '"correct": true' in stdout
    assert "sketches_tpu_torch" in mods and "torch" in mods
    assert not (mods & FORBIDDEN), sorted(mods & FORBIDDEN)


def test_real_cell_rehearsal_loads_no_jax():
    mods, stdout = modules_after(["--workload", "ddlog.ingest_ragged", "--seed", "4",
                                  "--seconds", "0.3", "--cpu-rehearsal", "--streams", "256"])
    assert '"correct": true' in stdout
    assert not (mods & FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "import sketchbench.reference.ddsketch_ref, sketchbench.reference.bf16_system\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "sketches_tpu_torch" not in mods and not (mods & FORBIDDEN)


def imported(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax_and_the_reference_no_port():
    for path in BENCH.rglob("*.py"):
        assert not (imported(path) & FORBIDDEN), path
    for path in (BENCH / "reference").glob("*.py"):
        assert "sketches_tpu_torch" not in imported(path), path
    # Outside the tests, only the system modules import the program.
    users = {p.relative_to(BENCH).parts[0] for p in BENCH.rglob("*.py")
             if p.parent.name != "tests" and "sketches_tpu_torch" in imported(p)}
    assert users == {"systems"}

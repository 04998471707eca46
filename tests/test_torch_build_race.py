"""Two processes building one kernel library at once (``_build.build``).

The ``multiprocess`` phase of ``chip_smoke.py`` starts workers that load the
kernel libraries; the parent builds them first, but a concurrent first
build must be safe too.  Each build compiles into a file of its own
(``<library>.<pid>.tmp``) and moves it into place with ``os.replace``, so a
reader sees no library or a whole one, never a part.  Here ``nvcc`` is a
stand-in that writes its output slowly, so the two builds overlap.
"""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from sketches_tpu_torch import _build
from torch_proc_common import run
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

_CHUNKS, _CHUNK = 64, 1 << 16
#: Seconds a builder waits at the gate for its peer, and the test for both.
_GATE_S, _TIMEOUT_S = 30, 90

_FAKE_NVCC = textwrap.dedent(f"""\
    import sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(out, "wb") as f:
        for i in range({_CHUNKS}):
            f.write(bytes([i % 251]) * {_CHUNK})
            f.flush()
            time.sleep(0.005)
    print("ptxas info: fake build")
    """)

_BUILDER = textwrap.dedent("""\
    import os, sys, time
    from pathlib import Path
    sys.path.insert(0, sys.argv[1])
    from sketches_tpu_torch import _build
    _build.BUILD_DIR = Path(sys.argv[2])
    _build.nvcc_path = lambda: sys.argv[3]
    # Start together: wait until every builder has imported, or give up
    # when a peer never arrives.
    gate, n = Path(sys.argv[5]), int(sys.argv[6])
    (gate / str(os.getpid())).touch()
    deadline = time.monotonic() + float(sys.argv[7])
    while len(list(gate.iterdir())) < n:
        if time.monotonic() > deadline:
            sys.exit(f"gate: {len(list(gate.iterdir()))} of {n} builders arrived")
        time.sleep(0.001)
    print(sorted(_build.build(["race.cu"], csrc=Path(sys.argv[4]))))
    """)


def _whole(path: Path) -> bool:
    data = path.read_bytes()
    return len(data) == _CHUNKS * _CHUNK and all(
        data[i * _CHUNK] == i % 251 and data[(i + 1) * _CHUNK - 1] == i % 251
        for i in range(_CHUNKS))


def test_concurrent_first_builds_leave_one_whole_library(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "race.cu").write_text("// a kernel\n")
    (csrc / "shared.cuh").write_text("// a header\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + _FAKE_NVCC)
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    lib = _build.library_path("race.cu", csrc)
    root = str(Path(__file__).resolve().parent.parent)

    def builder(gate, n):
        gate.mkdir(exist_ok=True)
        return [sys.executable, "-c", _BUILDER, root, str(build_dir), str(nvcc), str(csrc),
                str(gate), str(n), str(_GATE_S)]

    # Each builder writes to a file of its own, so no pipe fills while the
    # test polls.
    logs = [tmp_path / f"builder{i}.log" for i in range(2)]
    procs = []
    for log in logs:
        with open(log, "w") as f:
            procs.append(subprocess.Popen(builder(tmp_path / "gate", 2), stdout=f,
                                          stderr=subprocess.STDOUT))

    def outputs():
        return [log.read_text() for log in logs]

    try:
        # While both builds run, the library is absent or whole.
        deadline = time.monotonic() + _TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                pytest.fail(f"the builders passed the {_TIMEOUT_S}-s limit: {outputs()}")
            if lib.is_file():
                assert _whole(lib)
            time.sleep(0.01)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = outputs()
    assert all(p.returncode == 0 for p in procs), outs
    # Both compiled (neither saw the other's library at its start) ...
    assert all("['race.cu']" in o for o in outs), outs
    # ... and one whole library is left, with its log and no temp file.
    assert _whole(lib)
    assert sorted(p.name for p in build_dir.iterdir()) == sorted([lib.name, lib.stem + ".log"])
    assert "fake build" in lib.with_suffix(".log").read_text()
    # A third build finds it and compiles nothing.
    out = run(builder(tmp_path / "gate1", 1), timeout=_TIMEOUT_S)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out
    assert os.path.getsize(lib) == _CHUNKS * _CHUNK

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

from sketches_tpu_torch import _build

_CHUNKS, _CHUNK = 64, 1 << 16

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
    # Start together: wait until every builder has imported.
    gate, n = Path(sys.argv[5]), int(sys.argv[6])
    (gate / str(os.getpid())).touch()
    while len(list(gate.iterdir())) < n:
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
                str(gate), str(n)]

    procs = [
        subprocess.Popen(builder(tmp_path / "gate", 2), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for _ in range(2)
    ]
    # While both builds run, the library is absent or whole.
    while any(p.poll() is None for p in procs):
        if lib.is_file():
            assert _whole(lib)
        time.sleep(0.01)
    outs = [p.communicate(timeout=60)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    # Both compiled (neither saw the other's library at its start) ...
    assert all("['race.cu']" in o for o in outs), outs
    # ... and one whole library is left, with its log and no temp file.
    assert _whole(lib)
    assert sorted(p.name for p in build_dir.iterdir()) == sorted([lib.name, lib.stem + ".log"])
    assert "fake build" in lib.with_suffix(".log").read_text()
    # A third build finds it and compiles nothing.
    out = subprocess.run(builder(tmp_path / "gate1", 1), capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out
    assert os.path.getsize(lib) == _CHUNKS * _CHUNK

"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on its own with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` -- no PyTorch headers, so a build
takes seconds.  Libraries go to ``build/sketches_tpu_torch/`` beside the
package, named by a hash of the sources and flags, so an edit rebuilds and
an unchanged tree reuses what is there.  Several sources build in
parallel, one ``nvcc`` process each.  Nothing is built at import time.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` with neither
``--use_fast_math`` nor ``-ftz=true``: contracted multiply-adds and flushed
subnormals would round the mapping arithmetic differently from the plain
PyTorch versions and the JAX reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

from sketches_tpu_torch.resilience import EngineUnavailable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sketches_tpu_torch"
SOURCES = ("ingest.cu", "quantile.cu", "windowed.cu", "tiles.cu", "overlap.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``'s,
    else the first ``nvcc`` on ``PATH``."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise EngineUnavailable("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(source: str) -> Path:
    """Where ``source``'s library lives: named by a hash of every csrc file
    it may include, the source itself and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{source: seconds}`` for the sources compiled now (an empty
    dict when everything was built already).  Raises ``EngineUnavailable``
    with the compiler's output when a build fails.  The compiler's resource
    report (registers, shared memory, spills) is kept beside each library
    as ``<name>.log``.
    """
    todo = [s for s in sources if not library_path(s).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for src in todo:
        out = library_path(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    seconds = {}
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise EngineUnavailable("nvcc failed for " + "\n".join(failed))
    return seconds


def build_log(source: str) -> str:
    """The compiler's output from ``source``'s last build ('' if none)."""
    p = library_path(source).with_suffix(".log")
    return p.read_text() if p.is_file() else ""


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is missing."""
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = _LIBS[source] = ctypes.CDLL(str(library_path(source)))
    return lib

"""The port's sketchlint (``sketches_tpu_torch.analysis``) on the CPU.

* Layer 1: every rule flags its fixture tree and passes a clean twin, as
  ``tests/test_analysis.py`` proves for the JAX package; the retargeted
  rules (``torch-f64`` for ``jnp-f64``, ``host-sync`` for
  ``host-callback``) and the closure rules over the port's own
  inventories (``DETECTORS`` / ``NO_SEAM``, ``chip_smoke.py``'s
  ``CHAOS_CALLS``) have fixtures of their own.
* A differential: both packages' ``run_lint`` over the same fixture trees,
  for every rule whose meaning and inputs are unchanged, give equal
  ``(rule, path, line)`` sets and equal messages once the package names
  are swapped.
* Layer 2 without a card: the budgets gate on synthetic documents, the
  shared-memory report at the real constants, the census parsers on a
  trimmed ``cuobjdump`` / ptxas / ``cu++filt`` excerpt recorded on the
  H100 machine (CUDA 12.9), and a kernel layer that reports
  ``kernel-build`` and exits 1 where there is no toolchain.
* The live tree: no finding over ``sketches_tpu_torch/`` with the empty
  checked-in baseline; the checked-in budgets pin all five libraries.

The CLI runs in-process (``main(argv)``); one test starts it as a
process, the way a user runs it.  The card half is in
``tests/test_torch_cuda.py``.
"""

import json
import os
import sys

import pytest

from sketches_tpu.analysis import lint as jlint
from sketches_tpu_torch import _build
from sketches_tpu_torch.analysis import kernel_audit
from sketches_tpu_torch.analysis import lint as plint
from sketches_tpu_torch.analysis.__main__ import main
from sketches_tpu_torch.analysis.lint import (
    apply_baseline,
    load_baseline,
    run_lint,
    write_baseline,
)
from sketches_tpu_torch.resilience import EngineUnavailable
from torch_proc_common import run
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_ROOT = os.path.join(REPO_ROOT, "sketches_tpu_torch")
ANALYSIS = os.path.join(PKG_ROOT, "analysis")


def make_pkg(tmp_path, files, readme=None, name="fixturepkg", aux=None):
    """Write a synthetic package tree (and repo files beside it) and return
    its root path."""
    pkg = tmp_path / name
    for rel, content in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(content)
    if readme is not None:
        (tmp_path / "README.md").write_text(readme)
    for rel, content in (aux or {}).items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(content)
    return str(pkg)


def rules_of(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# Fixture trees: (files, readme).  The rule classes use them one by one;
# the differential runs each through both packages' engines.
# ---------------------------------------------------------------------------

_REGISTRY = (
    "class EnvVar:\n"
    "    def __init__(self, name, default=None, owner='', doc=''):\n"
    "        self.name = name\n"
    "X = EnvVar(name='SKETCHES_TPU_X')\n"
)
_LADDER_OK = (
    "QUERY_LADDER = ('tiles', 'xla')\n"
    "def demote_query_tier(disabled, tier):\n"
    "    if tier == 'tiles':\n"
    "        return 'xla'\n"
    "    return None\n"
)
_INVENTORY = (
    "class Metric:\n"
    "    def __init__(self, name, kind, owner, doc):\n"
    "        self.name = name\n"
    "METRICS = {m.name: m for m in (\n"
    "    Metric('query_s', 'histogram', 'pkg', 'doc'),\n"
    "    Metric(name='hits', kind='counter', owner='pkg', doc='doc'),\n"
    ")}\n"
)
_LOCK_HEADER = (
    "import threading\n"
    "\n"
    "class Server:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.RLock()\n"
    "        self._table = {}\n"
    "        self._count = 0\n"
    "\n"
    "    def put(self, k, v):\n"
    "        with self._lock:\n"
    "            self._table[k] = v\n"
    "            self._count += 1\n"
)
_FAULTS = (
    'CHECKPOINT_WRITE = "checkpoint.write"\n'
    'WINDOW_ROTATE_TORN = "window.rotate_torn"\n'
    "SITES = (CHECKPOINT_WRITE, WINDOW_ROTATE_TORN)\n"
    "ATOMIC_SITES = (CHECKPOINT_WRITE, WINDOW_ROTATE_TORN)\n"
    "def inject(site, payload=None):\n"
    "    return payload\n"
)
_TELEMETRY = (
    "class Metric:\n"
    "    def __init__(self, name, doc=''):\n"
    "        self.name = name\n"
    'METRICS = (Metric("req_s"), Metric("cache.hits"),'
    ' Metric("cache.misses"))\n'
)
_CHAOS = (
    "import argparse\n"
    "def main():\n"
    "    p = argparse.ArgumentParser()\n"
    "    p.add_argument(\n"
    '        "--campaign",\n'
    '        choices=("core", "serve", "windowed"),\n'
    '        default="core",\n'
    "    )\n"
)


def _box(body):
    return (
        "from . import faults\n"
        "\n"
        "class Box:\n"
        "    def __init__(self):\n"
        "        self._state = []\n"
        "        self._n = 0\n"
        "\n" + body
    )


FIXTURES = {
    "raise_bare": ({"mod.py": (
        "def f():\n"
        "    raise ValueError('nope')\n"
        "def g():\n"
        "    raise RuntimeError('nope')\n"
    )}, None),
    "raise_clean": ({
        "mod.py": (
            "from pkg.resilience import SpecError\n"
            "def f():\n"
            "    raise SpecError('structured')\n"
            "def g():\n"
            "    raise TypeError('caller bug, allowed')\n"
        ),
        "resilience.py": "def f():\n    raise ValueError('home')\n",
    }, None),
    "raise_suppressed": ({"mod.py": (
        "def f():\n"
        "    # justified here.  sketchlint: ignore[taxonomy-raise]\n"
        "    raise ValueError('grandfathered')\n"
    )}, None),
    "env_read": ({"mod.py": "import os\nX = os.environ.get('HOME')\n"}, None),
    "env_registry_reads": ({
        "analysis/registry.py": "import os\nX = os.environ.get('HOME')\n",
    }, None),
    "env_literals": ({
        "analysis/registry.py": _REGISTRY,
        "mod.py": (
            "DECLARED_DUP = 'SKETCHES_TPU_X'\n"
            "UNDECLARED = 'SKETCHES_TPU_BOGUS'\n"
        ),
    }, None),
    "registry_undocumented": ({"analysis/registry.py": _REGISTRY}, "no switches here"),
    "registry_ghost": ({"analysis/registry.py": _REGISTRY},
                       "`SKETCHES_TPU_X` and `SKETCHES_TPU_GHOST`"),
    "registry_agrees": ({"analysis/registry.py": _REGISTRY},
                        "table: `SKETCHES_TPU_X` default 1"),
    "ladder_outside": ({
        "kernels.py": "def choose_query_engine(a, b):\n    return 'warp'\n",
        "resilience.py": _LADDER_OK,
    }, None),
    "ladder_no_dispatch": ({
        "kernels.py": "def choose_query_engine(a, b):\n    return 'tiles'\n",
        "resilience.py": _LADDER_OK,
        "batched.py": "def query():\n    return 1\n",
    }, None),
    "ladder_clean": ({
        "kernels.py": (
            "def choose_query_engine(a, b):\n"
            "    if a:\n"
            "        return 'tiles'\n"
            "    return 'xla'\n"
        ),
        "resilience.py": _LADDER_OK,
        "batched.py": (
            "import faults\n"
            "def query(tier):\n"
            "    faults.inject(faults.PALLAS_LOWERING, tier=tier)\n"
        ),
    }, None),
    "clock_and_rng": ({"mod.py": (
        "import time\n"
        "import numpy as np\n"
        "def f():\n"
        "    t = time.time()\n"
        "    x = np.random.rand(3)\n"
        "    return t, x\n"
    )}, None),
    "sleep_and_seeded": ({"mod.py": (
        "import time\n"
        "import numpy as np\n"
        "def f():\n"
        "    time.sleep(0.01)\n"
        "    rng = np.random.default_rng(7)\n"
        "    return rng.normal(size=3)\n"
    )}, None),
    "clock_carveout": ({
        "telemetry.py": "import time\ndef f():\n    return time.perf_counter()\n",
        "mod.py": "import time\ndef f():\n    return time.perf_counter()\n",
    }, None),
    "telemetry_rng": ({"telemetry.py": (
        "import numpy as np\n"
        "def f():\n"
        "    return np.random.rand(3)\n"
    )}, None),
    "telemetry_drift": ({
        "telemetry.py": _INVENTORY,
        "mod.py": (
            "from pkg import telemetry\n"
            "def f(name):\n"
            "    telemetry.counter_inc('rogue.metric')\n"
            "    telemetry.observe(name, 1.0)\n"
            "    telemetry.declare('my.metric', 'counter', 'd')\n"
        ),
    }, None),
    "telemetry_clean": ({
        "telemetry.py": _INVENTORY,
        "mod.py": (
            "from pkg import telemetry\n"
            "def f():\n"
            "    telemetry.counter_inc('hits', 2.0)\n"
            "    with telemetry.span('query_s', tier='xla'):\n"
            "        pass\n"
            "    telemetry.finish_span('query_s', 0.0)\n"
        ),
    }, None),
    "telemetry_home": ({"telemetry.py": _INVENTORY + "def observe(name, v):\n    pass\n"},
                       None),
    "docstrings_missing": ({
        "__init__.py": "from fixturepkg.mod import f, g\n__all__ = ['f', 'g']\n",
        "mod.py": "def f():\n    pass\ndef g():\n    '''Does a thing, quickly.'''\n",
    }, None),
    "docstrings_clean": ({
        "__init__.py": (
            "from fixturepkg.mod import f\n"
            "__all__ = ['f', '__version__']\n"
            "__version__ = '1.0'\n"
        ),
        "mod.py": "def f():\n    '''Computes x.  Raises SpecError on bad input.'''\n",
    }, None),
    "syntax_error": ({"mod.py": "def f(:\n"}, None),
    "lock_racy_get": ({"mod.py": _LOCK_HEADER + (
        "\n"
        "    def racy_get(self, k):\n"
        "        return self._table.get(k)\n"
    )}, None),
    "lock_racy_reset": ({"mod.py": _LOCK_HEADER + (
        "\n"
        "    def racy_reset(self):\n"
        "        self._count = 0\n"
    )}, None),
    "lock_safe_get": ({"mod.py": _LOCK_HEADER + (
        "\n"
        "    def safe_get(self, k):\n"
        "        with self._lock:\n"
        "            return self._table.get(k)\n"
    )}, None),
    "lock_helper": ({"mod.py": _LOCK_HEADER + (
        "\n"
        "    def flush(self):\n"
        "        with self._lock:\n"
        "            self._drain()\n"
        "\n"
        "    def _drain(self):\n"
        "        self._count = 0\n"
    )}, None),
    "lock_suffix": ({"mod.py": _LOCK_HEADER + (
        "\n"
        "    def kick(self):\n"
        "        self._drain_locked()\n"
        "\n"
        "    def _drain_locked(self):\n"
        "        self._count = 0\n"
    )}, None),
    "lock_free": ({"mod.py": (
        "class Plain:\n"
        "    def __init__(self):\n"
        "        self._table = {}\n"
        "    def get(self, k):\n"
        "        return self._table.get(k)\n"
    )}, None),
    "lock_escape_return": ({"mod.py": _LOCK_HEADER + (
        "\n"
        "    def peek(self):\n"
        "        with self._lock:\n"
        "            return self._table\n"
    )}, None),
    "lock_escape_store": ({"mod.py": _LOCK_HEADER + (
        "\n"
        "    def leak(self, sink):\n"
        "        with self._lock:\n"
        "            sink.ref = self._table\n"
    )}, None),
    "lock_copy": ({"mod.py": _LOCK_HEADER + (
        "\n"
        "    def snapshot(self):\n"
        "        with self._lock:\n"
        "            return dict(self._table)\n"
    )}, None),
    "seam_premutation": ({"faults.py": _FAULTS, "mod.py": _box(
        "    def rotate(self):\n"
        "        self._n += 1\n"
        "        plan = [1, 2]\n"
        "        plan = faults.inject(\n"
        "            faults.WINDOW_ROTATE_TORN, payload=plan)\n"
        "        self._state = plan\n"
    )}, None),
    "seam_alias": ({"faults.py": _FAULTS, "mod.py": _box(
        "    def heal(self):\n"
        "        h = self._state\n"
        "        h.append(1)\n"
        "        out = faults.inject(\n"
        "            faults.CHECKPOINT_WRITE, payload=0)\n"
        "        self._state = [out]\n"
    )}, None),
    "seam_inplace": ({"faults.py": _FAULTS, "mod.py": _box(
        "    def rotate(self):\n"
        "        plan = [1, 2]\n"
        "        plan = faults.inject(\n"
        "            faults.WINDOW_ROTATE_TORN, payload=plan)\n"
        "        self._state.clear()\n"
        "        self._state.extend(plan)\n"
    )}, None),
    "seam_clean": ({"faults.py": _FAULTS, "mod.py": _box(
        "    def rotate(self):\n"
        "        plan = [x for x in self._state] + [1]\n"
        "        plan = faults.inject(\n"
        "            faults.WINDOW_ROTATE_TORN, payload=plan)\n"
        "        self._state = plan\n"
        "        self._n += 1\n"
    )}, None),
    "seam_undeclared_torn": ({
        "faults.py": (
            'CHECKPOINT_WRITE = "checkpoint.write"\n'
            'OTHER_TORN = "other.torn"\n'
            "SITES = (CHECKPOINT_WRITE, OTHER_TORN)\n"
            "ATOMIC_SITES = (CHECKPOINT_WRITE,)\n"
            "def inject(site, payload=None):\n"
            "    return payload\n"
        ),
        "mod.py": (
            "from . import faults\n"
            "def f():\n"
            "    return faults.inject(faults.OTHER_TORN, payload=1)\n"
        ),
    }, None),
    "seam_ghost_atomic": ({"faults.py": (
        'CHECKPOINT_WRITE = "checkpoint.write"\n'
        'GHOST = "ghost.site"\n'
        "SITES = (CHECKPOINT_WRITE,)\n"
        "ATOMIC_SITES = (CHECKPOINT_WRITE, GHOST)\n"
    )}, None),
    "seam_inert": ({"mod.py": "def f():\n    return 1\n"}, None),
    "metric_undocumented": ({"telemetry.py": _TELEMETRY},
                            "# pkg\n\n| `req_s{tenant}` | request latency |\n"),
    "metric_expansions": ({"telemetry.py": _TELEMETRY}, (
        "# pkg\n\n"
        "| `req_s{tenant,engine}` | request latency |\n"
        "| `cache.{hits,misses}` | cache outcomes |\n"
    )),
    "metric_no_readme": ({"telemetry.py": _TELEMETRY}, None),
}

#: Rules whose meaning and inputs are the JAX package's: the differential
#: holds both engines equal on them.  ``site-detector`` and ``campaign-ci``
#: read the port's own inventories, ``torch-f64`` and ``host-sync`` are
#: retargeted; each has its fixtures below.
SHARED_RULES = (
    "taxonomy-raise", "env-read", "env-literal", "registry-doc", "engine-ladder",
    "determinism", "failure-docstring", "telemetry-names", "lock-discipline",
    "lock-escape", "seam-premutation", "seam-commit", "seam-sites", "metric-doc",
)


def fixture(tmp_path, name, **kw):
    files, readme = FIXTURES[name]
    return make_pkg(tmp_path, files, readme=readme, **kw)


# ---------------------------------------------------------------------------
# Layer 1: each rule flags its fixture and passes a clean twin
# ---------------------------------------------------------------------------


class TestTaxonomyRaise:
    def test_flags_bare_valueerror_and_runtimeerror(self, tmp_path):
        found = run_lint(fixture(tmp_path, "raise_bare"), only=["taxonomy-raise"])
        assert {f.line for f in found} == {2, 4} and len(found) == 2

    def test_passes_taxonomy_and_exempt_files(self, tmp_path):
        assert run_lint(fixture(tmp_path, "raise_clean"), only=["taxonomy-raise"]) == []

    def test_inline_suppression(self, tmp_path):
        assert run_lint(fixture(tmp_path, "raise_suppressed"), only=["taxonomy-raise"]) == []


class TestEnvRegistry:
    def test_flags_environ_read_outside_registry(self, tmp_path):
        assert rules_of(run_lint(fixture(tmp_path, "env_read"), only=["env-read"])) == {
            "env-read"
        }

    def test_registry_module_may_read_environ(self, tmp_path):
        assert run_lint(fixture(tmp_path, "env_registry_reads"), only=["env-read"]) == []

    def test_flags_undeclared_and_duplicate_literals(self, tmp_path):
        found = run_lint(fixture(tmp_path, "env_literals"), only=["env-literal"])
        msgs = "\n".join(f.message for f in found)
        assert len(found) == 2
        assert "duplicates the registry" in msgs and "not declared" in msgs

    def test_readme_cross_check_both_directions(self, tmp_path):
        found = run_lint(fixture(tmp_path / "a", "registry_undocumented"),
                         only=["registry-doc"])
        assert any("missing from the README" in f.message for f in found)
        found = run_lint(fixture(tmp_path / "b", "registry_ghost"), only=["registry-doc"])
        assert any("does not declare" in f.message for f in found)
        assert run_lint(fixture(tmp_path / "c", "registry_agrees"), only=["registry-doc"]) == []

    def test_examples_are_not_scanned(self, tmp_path):
        # The port keeps its examples inside the package; they are user
        # code, which the JAX package keeps outside its scanned tree.
        root = make_pkg(tmp_path, {
            "examples/demo.py": "import os\nX = os.environ.get('HOME')\n",
            "sub/examples/lib.py": "import os\nY = os.environ.get('HOME')\n",
        })
        found = run_lint(root, only=["env-read"])
        assert [f.path for f in found] == ["fixturepkg/sub/examples/lib.py"]


class TestEngineLadder:
    def test_flags_engine_outside_ladder(self, tmp_path):
        found = run_lint(fixture(tmp_path, "ladder_outside"), only=["engine-ladder"])
        assert any("not a rung" in f.message for f in found)

    def test_flags_facade_without_fault_dispatch(self, tmp_path):
        found = run_lint(fixture(tmp_path, "ladder_no_dispatch"), only=["engine-ladder"])
        assert any("PALLAS_LOWERING" in f.message for f in found)

    def test_consistent_tree_is_clean(self, tmp_path):
        assert run_lint(fixture(tmp_path, "ladder_clean"), only=["engine-ladder"]) == []


class TestTorchF64:
    def test_flags_device_f64_construction(self, tmp_path):
        root = make_pkg(tmp_path, {"mod.py": (
            "import torch\n"
            "def f(y, dev):\n"
            "    a = y.double()\n"
            "    b = y.to(torch.float64)\n"
            "    c = torch.zeros(4, dtype=torch.float64, device=dev)\n"
            "    d = y.to(dev, dtype=torch.double)\n"
            "    e = (y.double() * 2).sum(0)\n"
            "    return a, b, c, d, e\n"
        )})
        found = run_lint(root, only=["torch-f64"])
        assert sorted(f.line for f in found) == [3, 4, 5, 6, 7]

    def test_host_fetch_reads_and_numpy_allowed(self, tmp_path):
        root = make_pkg(tmp_path, {"mod.py": (
            "import numpy as np\n"
            "import torch\n"
            "def f(st, v, y):\n"
            "    a = st.count.double().cpu().numpy()\n"
            "    b = (st.count.double() - st.zero_count.double()).cpu().numpy()\n"
            "    c = st.count.double().sum(0).cpu().numpy()\n"
            "    d = [x.to(torch.float64).cpu().numpy() for x in (v, y)]\n"
            "    e = y.cpu().double().numpy()\n"
            "    is64 = v.dtype == torch.float64\n"
            "    h = np.asarray(y, dtype=np.float64)\n"
            "    return a, b, c, d, e, is64, h\n"
        )})
        assert run_lint(root, only=["torch-f64"]) == []

    def test_module_without_torch_is_out_of_scope(self, tmp_path):
        root = make_pkg(tmp_path, {"mod.py": "def f(y):\n    return y.double()\n"})
        assert run_lint(root, only=["torch-f64"]) == []

    def test_justified_device_f64_takes_an_inline_suppression(self, tmp_path):
        root = make_pkg(tmp_path, {"mod.py": (
            "import torch\n"
            "def f(rem):\n"
            "    # correctly rounded root.  sketchlint: ignore[torch-f64]\n"
            "    return torch.sqrt(rem.double()).to(rem.dtype)\n"
        )})
        assert run_lint(root, only=["torch-f64"]) == []


class TestDeterminism:
    def test_flags_wallclock_and_global_rng(self, tmp_path):
        found = run_lint(fixture(tmp_path, "clock_and_rng"), only=["determinism"])
        assert len(found) == 2
        assert any("sketches_tpu_torch.telemetry" in f.message for f in found)

    def test_sleep_and_seeded_rng_allowed(self, tmp_path):
        assert run_lint(fixture(tmp_path, "sleep_and_seeded"), only=["determinism"]) == []

    def test_telemetry_clock_carveout(self, tmp_path):
        found = run_lint(fixture(tmp_path, "clock_carveout"), only=["determinism"])
        assert len(found) == 1 and found[0].path.endswith("mod.py")
        assert len(run_lint(fixture(tmp_path / "rng", "telemetry_rng"),
                            only=["determinism"])) == 1


class TestTelemetryNames:
    def test_flags_undeclared_computed_and_declare(self, tmp_path):
        found = run_lint(fixture(tmp_path, "telemetry_drift"), only=["telemetry-names"])
        msgs = "\n".join(f.message for f in found)
        assert len(found) == 3
        assert "not declared" in msgs and "string literal" in msgs
        assert "declare() in library code" in msgs

    def test_declared_literals_are_clean(self, tmp_path):
        assert run_lint(fixture(tmp_path, "telemetry_clean"), only=["telemetry-names"]) == []

    def test_telemetry_module_itself_exempt(self, tmp_path):
        assert run_lint(fixture(tmp_path, "telemetry_home"), only=["telemetry-names"]) == []


class TestFailureDocstring:
    def test_flags_missing_and_vocabulary_free_docstrings(self, tmp_path):
        found = run_lint(fixture(tmp_path, "docstrings_missing"), only=["failure-docstring"])
        msgs = "\n".join(f.message for f in found)
        assert len(found) == 2 and "no docstring" in msgs and "never mentions" in msgs

    def test_failure_mode_docstrings_pass(self, tmp_path):
        assert run_lint(fixture(tmp_path, "docstrings_clean"), only=["failure-docstring"]) == []


_HOT = (
    "import torch\n"
    "def fused_quantile(spec, state, qs):\n"
    "    n = state.count.sum().item()\n"
    "    torch.cuda.synchronize()\n"
    "    def inner(x):\n"
    "        return x.tolist()\n"
    "    return inner(qs)\n"
    "def plan_state_window(spec, state):\n"
    "    return state.pos_lo.min().cpu().numpy()\n"
)


class TestHostSync:
    def test_flags_syncs_in_hot_functions(self, tmp_path):
        root = make_pkg(tmp_path, {
            "kernels.py": _HOT,
            "batched.py": "def add(spec, state, v):\n    return v.cpu()\n",
        })
        found = run_lint(root, only=["host-sync"])
        assert [(f.path.split("/")[-1], f.line) for f in found] == [
            ("batched.py", 2), ("kernels.py", 3), ("kernels.py", 4), ("kernels.py", 6)
        ]
        assert "kernels.fused_quantile" in found[1].message

    def test_planners_and_other_modules_are_out_of_scope(self, tmp_path):
        root = make_pkg(tmp_path, {
            "kernels.py": _HOT.replace("def fused_quantile(", "def plan_tile_query("),
            "windows.py": "def add(x):\n    return x.item()\n",
            "batched.py": "def quantile(spec, state, qs):\n    return qs\n",
        })
        assert run_lint(root, only=["host-sync"]) == []


class TestBaseline:
    def test_baseline_suppresses_then_goes_stale(self, tmp_path):
        root = make_pkg(tmp_path, {"mod.py": "def f():\n    raise ValueError('x')\n"})
        found = run_lint(root, only=["taxonomy-raise"])
        bl_path = str(tmp_path / "baseline.json")
        write_baseline(bl_path, found)
        baseline = load_baseline(bl_path)
        assert found and apply_baseline(found, baseline) == []
        root2 = make_pkg(tmp_path / "v2", {"mod.py": "def f():\n    raise RuntimeError('new')\n"})
        found2 = run_lint(root2, only=["taxonomy-raise"])
        assert apply_baseline(found2, baseline) == found2

    def test_missing_baseline_is_empty(self, tmp_path):
        assert load_baseline(str(tmp_path / "nope.json")) == {}

    def test_fingerprints_survive_line_drift(self, tmp_path):
        src = "def f():\n    raise ValueError('x')\n"
        root = make_pkg(tmp_path / "a", {"mod.py": src})
        drifted = make_pkg(tmp_path / "b", {"mod.py": "\n\n\n" + src})
        fp = lambda r: [f.fingerprint for f in run_lint(r, only=["taxonomy-raise"])]
        assert fp(root) == fp(drifted)

    def test_syntax_error_is_a_finding_not_a_crash(self, tmp_path):
        assert rules_of(run_lint(fixture(tmp_path, "syntax_error"))) == {"syntax"}


class TestLockDiscipline:
    def test_flags_unlocked_read_of_guarded_attr(self, tmp_path):
        found = run_lint(fixture(tmp_path, "lock_racy_get"), only=["lock-discipline"])
        assert len(found) == 1
        assert "racy_get" in found[0].message and "_table" in found[0].message

    def test_flags_unlocked_write(self, tmp_path):
        found = run_lint(fixture(tmp_path, "lock_racy_reset"), only=["lock-discipline"])
        assert len(found) == 1 and "written" in found[0].message

    def test_clean_twin_passes(self, tmp_path):
        assert run_lint(fixture(tmp_path, "lock_safe_get"), only=["lock-discipline"]) == []

    def test_helper_reached_only_under_lock_is_clean(self, tmp_path):
        assert run_lint(fixture(tmp_path, "lock_helper"), only=["lock-discipline"]) == []

    def test_locked_suffix_called_unlocked_flags(self, tmp_path):
        found = run_lint(fixture(tmp_path, "lock_suffix"), only=["lock-discipline"])
        assert len(found) == 1 and "_drain_locked" in found[0].message

    def test_lock_free_class_is_out_of_scope(self, tmp_path):
        assert run_lint(fixture(tmp_path, "lock_free"),
                        only=["lock-discipline", "lock-escape"]) == []

    def test_escape_via_return_flags(self, tmp_path):
        found = run_lint(fixture(tmp_path, "lock_escape_return"), only=["lock-escape"])
        assert len(found) == 1 and "returned" in found[0].message

    def test_escape_via_foreign_store_flags(self, tmp_path):
        found = run_lint(fixture(tmp_path, "lock_escape_store"), only=["lock-escape"])
        assert len(found) == 1 and "stored" in found[0].message

    def test_escape_clean_twin_copy_passes(self, tmp_path):
        assert run_lint(fixture(tmp_path, "lock_copy"), only=["lock-escape"]) == []


class TestSeamContracts:
    def test_premutation_flags(self, tmp_path):
        found = run_lint(fixture(tmp_path, "seam_premutation"), only=["seam-premutation"])
        assert len(found) == 1 and "self._n" in found[0].message

    def test_premutation_through_alias_flags(self, tmp_path):
        found = run_lint(fixture(tmp_path, "seam_alias"), only=["seam-premutation"])
        assert len(found) == 1 and "h.append" in found[0].message

    def test_inplace_commit_flags(self, tmp_path):
        found = run_lint(fixture(tmp_path, "seam_inplace"), only=["seam-commit"])
        assert len(found) == 1 and "clear" in found[0].message

    def test_clean_twin_plan_inject_swap_passes(self, tmp_path):
        assert run_lint(fixture(tmp_path, "seam_clean"),
                        only=["seam-premutation", "seam-commit"]) == []

    def test_undeclared_torn_inject_flags(self, tmp_path):
        found = run_lint(fixture(tmp_path, "seam_undeclared_torn"), only=["seam-sites"])
        assert len(found) == 1 and "OTHER_TORN" in found[0].message

    def test_atomic_site_outside_sites_flags(self, tmp_path):
        found = run_lint(fixture(tmp_path, "seam_ghost_atomic"), only=["seam-sites"])
        assert len(found) == 1 and "GHOST" in found[0].message

    def test_no_faults_module_is_inert(self, tmp_path):
        assert run_lint(fixture(tmp_path, "seam_inert"),
                        only=["seam-premutation", "seam-commit", "seam-sites"]) == []


# ---------------------------------------------------------------------------
# Closure rules over the port's inventories
# ---------------------------------------------------------------------------

_INTEGRITY = "tests/test_torch_integrity.py"


def _detectors(keys, no_seam="set()"):
    return (
        "from fixturepkg import faults as tf\n"
        "def _d():\n    return True\n"
        "DETECTORS = {\n"
        + "".join(f"    tf.{k}: _d,\n" for k in keys)
        + "}\n"
        f"NO_SEAM = {no_seam}\n"
    )


class TestSiteDetectorClosure:
    def test_missing_detector_flags(self, tmp_path):
        root = make_pkg(tmp_path, {"faults.py": _FAULTS},
                        aux={_INTEGRITY: _detectors(["CHECKPOINT_WRITE"])})
        found = run_lint(root, only=["site-detector"])
        assert len(found) == 1 and "WINDOW_ROTATE_TORN" in found[0].message

    def test_stale_detector_key_flags(self, tmp_path):
        root = make_pkg(tmp_path, {"faults.py": _FAULTS}, aux={_INTEGRITY: _detectors(
            ["CHECKPOINT_WRITE", "WINDOW_ROTATE_TORN", "REMOVED_SITE"])})
        found = run_lint(root, only=["site-detector"])
        assert len(found) == 1 and "REMOVED_SITE" in found[0].message
        assert found[0].path == _INTEGRITY

    def test_closed_inventory_passes(self, tmp_path):
        root = make_pkg(tmp_path, {"faults.py": _FAULTS}, aux={_INTEGRITY: _detectors(
            ["CHECKPOINT_WRITE", "WINDOW_ROTATE_TORN"])})
        assert run_lint(root, only=["site-detector"]) == []

    def test_no_seam_member_closes_a_site_and_goes_stale(self, tmp_path):
        root = make_pkg(tmp_path, {"faults.py": _FAULTS}, aux={_INTEGRITY: _detectors(
            ["CHECKPOINT_WRITE"], no_seam="{tf.WINDOW_ROTATE_TORN}")})
        assert run_lint(root, only=["site-detector"]) == []
        root = make_pkg(tmp_path / "stale", {"faults.py": _FAULTS}, aux={_INTEGRITY: _detectors(
            ["CHECKPOINT_WRITE", "WINDOW_ROTATE_TORN"], no_seam="{tf.GONE}")})
        found = run_lint(root, only=["site-detector"])
        assert len(found) == 1 and "GONE" in found[0].message

    def test_missing_inventory_file_flags(self, tmp_path):
        root = make_pkg(tmp_path, {"faults.py": _FAULTS})
        found = run_lint(root, only=["site-detector"])
        assert len(found) == 1 and f"no {_INTEGRITY}" in found[0].message


class TestMetricDocClosure:
    def test_undocumented_metric_flags(self, tmp_path):
        found = run_lint(fixture(tmp_path, "metric_undocumented"), only=["metric-doc"])
        assert len(found) == 2
        assert all("cache.hits" in f.message or "cache.misses" in f.message for f in found)

    def test_label_suffix_and_brace_expansion_both_document(self, tmp_path):
        assert run_lint(fixture(tmp_path, "metric_expansions"), only=["metric-doc"]) == []

    def test_no_readme_flags(self, tmp_path):
        found = run_lint(fixture(tmp_path, "metric_no_readme"), only=["metric-doc"])
        assert len(found) == 1 and "no README.md" in found[0].message


def _smoke(names):
    calls = ", ".join(f'("{n}", 40, 3)' for n in names)
    return f"CHAOS_CALLS = ({calls},)\nOTHER = (('windowed', 1, 2),)\n"


class TestCampaignCiClosure:
    def test_unexercised_campaign_flags(self, tmp_path):
        root = make_pkg(tmp_path, {"chaos.py": _CHAOS},
                        aux={"chip_smoke.py": _smoke(["core", "serve"])})
        found = run_lint(root, only=["campaign-ci"])
        assert len(found) == 1 and "'windowed'" in found[0].message

    def test_full_matrix_passes(self, tmp_path):
        root = make_pkg(tmp_path, {"chaos.py": _CHAOS},
                        aux={"chip_smoke.py": _smoke(["core", "serve", "windowed"])})
        assert run_lint(root, only=["campaign-ci"]) == []

    def test_default_campaign_must_be_named_too(self, tmp_path):
        root = make_pkg(tmp_path, {"chaos.py": _CHAOS},
                        aux={"chip_smoke.py": _smoke(["serve", "windowed"])})
        found = run_lint(root, only=["campaign-ci"])
        assert len(found) == 1 and "'core'" in found[0].message

    def test_missing_smoke_flags(self, tmp_path):
        root = make_pkg(tmp_path, {"chaos.py": _CHAOS})
        found = run_lint(root, only=["campaign-ci"])
        assert len(found) == 1 and "no chip_smoke.py" in found[0].message


# ---------------------------------------------------------------------------
# The differential: both engines on the same trees
# ---------------------------------------------------------------------------


def _swapped(findings):
    return sorted(
        (f.rule, f.path, f.line, f.message.replace("sketches_tpu", "sketches_tpu_torch"))
        for f in findings
    )


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_both_engines_agree_on_shared_rules(tmp_path, name):
    root = fixture(tmp_path, name)
    want = _swapped(jlint.run_lint(root, only=SHARED_RULES))
    got = sorted((f.rule, f.path, f.line, f.message) for f in run_lint(root, only=SHARED_RULES))
    assert got == want


def test_rule_inventories_differ_only_by_the_retargets():
    port, jax = set(plint.all_rules()), set(jlint.all_rules())
    assert port - jax == {"torch-f64", "host-sync"}
    assert jax - port == {"jnp-f64", "host-callback"}
    assert set(SHARED_RULES) | {"site-detector", "campaign-ci"} == port & jax


# ---------------------------------------------------------------------------
# Layer 2 without a card
# ---------------------------------------------------------------------------

# Recorded on the H100 machine (CUDA 12.9): quantile.cu's ring and wide
# kernels for the logarithmic mapping, trimmed to a few lines each; the
# encodings are cut after the first instruction.
RES_USAGE = """\
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _ZN44_GLOBAL__N__4c0a7af6_11_quantile_cu_e460f97711wide_kernelILi0EEEvNS_4ArgsE:
  REG:80 STACK:0 SHARED:5120 LOCAL:0 CONSTANT[0]:624 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN44_GLOBAL__N__4c0a7af6_11_quantile_cu_e460f97711ring_kernelILi0EEEvNS_4ArgsE:
  REG:72 STACK:24 SHARED:1024 LOCAL:0 CONSTANT[0]:624 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__4c0a7af6_11_quantile_cu_e460f97711ring_kernelILi0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__4c0a7af6_11_quantile_cu_e460f97711ring_kernelILi0EEEvNS_4ArgsE
    24 bytes stack frame, 28 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Compile time = 321.385 ms
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__4c0a7af6_11_quantile_cu_e460f97711wide_kernelILi0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__4c0a7af6_11_quantile_cu_e460f97711wide_kernelILi0EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers
"""
SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN44_GLOBAL__N__4c0a7af6_11_quantile_cu_e460f97711ring_kernelILi0EEEvNS_4ArgsE
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_ACCELERATORS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                                  /* 0x00000a00ff017b82 */
                                                                                           /* 0x000e220000000800 */
        /*1ab0*/                   STL [R1+0x4], R0 ;
        /*1ca0*/                   LDL R8, [R1+0x10] ;
        /*a590*/                   FFMA R21, -R3, R0, 1 ;
        /*a5a0*/                   FFMA R21, R0, R21, R0 ;
        /*a5b0*/                   FFMA R0, R18, R21, RZ ;
        /*0400*/                   NOP ;
        /*0480*/               @P0 EXIT ;
        /*1750*/               @P0 BRA.U.ANY 0x1710 ;
        /*18d0*/                   EXIT ;
\t\tFunction : _ZN44_GLOBAL__N__4c0a7af6_11_quantile_cu_e460f97711wide_kernelILi0EEEvNS_4ArgsE
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_ACCELERATORS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDC.64 R4, c[0x0][0x238] ;
        /*0020*/                   ULDC UR4, c[0x0][0x258] ;
        /*1170*/                   NOP;
"""
DEMANGLED = {
    "_ZN44_GLOBAL__N__4c0a7af6_11_quantile_cu_e460f97711ring_kernelILi0EEEvNS_4ArgsE":
        "void <unnamed>::ring_kernel<(int)0>(<unnamed>::Args)",
    "_ZN44_GLOBAL__N__4c0a7af6_11_quantile_cu_e460f97711wide_kernelILi0EEEvNS_4ArgsE":
        "void <unnamed>::wide_kernel<(int)0>(<unnamed>::Args)",
}


def _demangle(names):
    return [DEMANGLED[n] for n in names]


class TestCensusParser:
    def test_recorded_excerpt(self):
        entries, findings = kernel_audit._merge_census(
            "quantile.cu", RES_USAGE, PTXAS, SASS, _demangle)
        assert findings == []
        assert entries == {
            "quantile.cu:ring_kernel<0>": {
                "registers": 72, "stack": 24, "shared": 1024, "local": 0,
                "spill_stores": 28, "spill_loads": 28, "sass": 9, "f64": 0, "ffma": 3,
            },
            "quantile.cu:wide_kernel<0>": {
                "registers": 80, "stack": 0, "shared": 5120, "local": 0,
                "spill_stores": 0, "spill_loads": 0, "sass": 3, "f64": 0, "ffma": 0,
            },
        }

    def test_f64_instructions_are_found(self):
        # The excerpt doctored: one FFMA made a DFMA, one LDC an f32-to-f64
        # conversion; DEPBAR (a barrier, not f64) is added and ignored.
        sass = (SASS.replace("FFMA R0, R18, R21, RZ", "DFMA R0, R18, R21, RZ")
                .replace("LDC.64 R4, c[0x0][0x238]", "F2F.F64.F32 R4, R3")
                .replace("NOP;", "DEPBAR.LE SB0, 0x0 ;"))
        entries, findings = kernel_audit._merge_census(
            "quantile.cu", RES_USAGE, PTXAS, sass, _demangle)
        assert entries["quantile.cu:ring_kernel<0>"]["f64"] == 1
        assert entries["quantile.cu:ring_kernel<0>"]["ffma"] == 2
        assert entries["quantile.cu:wide_kernel<0>"]["f64"] == 1
        assert entries["quantile.cu:wide_kernel<0>"]["sass"] == 4
        assert sorted(f.rule for f in findings) == ["kernel-f64", "kernel-f64"]
        assert any("DFMA" in f.message for f in findings)

    def test_entry_missing_from_a_report_is_kernel_build(self):
        ptxas = PTXAS.split("ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__4c0a7af6"
                            "_11_quantile_cu_e460f97711wide")[0]
        entries, findings = kernel_audit._merge_census(
            "quantile.cu", RES_USAGE, ptxas, SASS, _demangle)
        assert list(entries) == ["quantile.cu:ring_kernel<0>"]
        assert [f.rule for f in findings] == ["kernel-build"]
        assert "wide_kernel<0>" in findings[0].message

    @pytest.mark.parametrize("demangled,key", [
        ("void <unnamed>::ingest_kernel<(int)0, (bool)0>(<unnamed>::Args)",
         "ingest_kernel<0, false>"),
        ("void <unnamed>::tiles_kernel<(int)3, (bool)1>(const float *, const float *, int)",
         "tiles_kernel<3, true>"),
        ("void (anonymous namespace)::ring_kernel<(int)2>((anonymous namespace)::Args)",
         "ring_kernel<2>"),
    ])
    def test_entry_names(self, demangled, key):
        assert kernel_audit._entry_name(demangled) == key


class TestSmemReport:
    def test_real_constants_fit_an_h100_block(self):
        r = kernel_audit.smem_report()
        assert r["budget_bytes"] == kernel_audit.SMEM_BUDGET_BYTES == 232448
        assert r["csrc_limits"] == {s: 232448 for s in ("ingest.cu", "quantile.cu", "overlap.cu")}
        # K5: 4 slots x 16 rows x 128 bins, two staging buffers of 40-wide
        # rows, 12 mbarriers, the slot headers and the [16, 8] counts.
        assert r["overlap"]["ring_slots"] == 4 and r["overlap"]["packed_width"] == 40
        assert r["overlap"]["bytes"] == 4 * 16 * 128 * 4 + 2 * 16 * 40 * 4 + 12 * 8 + 16 + 16 * 8 * 4
        # K1: one stream's two histograms a warp, eight warps at most.
        assert r["ingest"]["widest_n_bins"] == 29056
        assert (r["ingest"]["bytes_512"], r["ingest"]["bytes_2048"]) == (32768, 131072)
        assert r["pins"]["ingest_widest"] == 232448
        assert r["ok"]

    def test_k2_ring_needs_the_built_library(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        r = kernel_audit.smem_report()
        assert r["quantile"] == {"measured": False, "reason": "quantile.cu is not built"}
        assert "quantile_512" not in r["pins"]

    def test_a_breach_is_an_smem_budget_finding(self):
        r = kernel_audit.smem_report()
        r["pins"]["overlap_worst"] = r["budget_bytes"] + 1
        r["csrc_limits"]["ingest.cu"] = 1 << 16
        found = kernel_audit._smem_findings(r)
        assert sorted(f.rule for f in found) == ["smem-budget", "smem-budget"]
        assert all(f.layer == "kernel" for f in found)


class TestBudgets:
    def _measured(self):
        return {
            "version": 1,
            "tolerance_pct": 2.0,
            "nvcc": "release 12.9, V12.9.86",
            "entries": {
                "fix.cu:k<0>": {
                    "registers": 40, "shared": 1024, "stack": 0, "local": 0,
                    "spill_stores": 0, "spill_loads": 0, "sass": 1000, "f64": 0, "ffma": 5,
                },
            },
            "smem_bytes": {"overlap_worst": 38512},
        }

    def _pinned(self, **entry):
        b = self._measured()
        b["entries"]["fix.cu:k<0>"].update(entry)
        return b

    def test_missing_budgets_file_is_a_finding(self):
        found = kernel_audit.check_budgets(None, self._measured())
        assert len(found) == 1 and "no budgets file" in found[0].message

    def test_identical_budgets_pass(self):
        m = self._measured()
        assert kernel_audit.check_budgets(m, m) == []

    def test_sass_regression_flags(self):
        found = kernel_audit.check_budgets(self._pinned(sass=500), self._measured())
        assert [f.rule for f in found] == ["kernel-budget"] and "SASS" in found[0].message

    def test_within_tolerance_passes(self):
        assert kernel_audit.check_budgets(self._pinned(sass=990), self._measured()) == []

    def test_cheaper_passes(self):
        assert kernel_audit.check_budgets(self._pinned(sass=2000, registers=64),
                                          self._measured()) == []

    @pytest.mark.parametrize("field,rule", [
        ("registers", "kernel-budget"), ("shared", "kernel-budget"),
        ("stack", "kernel-spill"), ("local", "kernel-spill"),
        ("spill_stores", "kernel-spill"), ("spill_loads", "kernel-spill"),
    ])
    def test_ceilings(self, field, rule):
        m = self._measured()
        m["entries"]["fix.cu:k<0>"][field] += 4
        found = kernel_audit.check_budgets(self._measured(), m)
        assert [f.rule for f in found] == [rule]

    @pytest.mark.parametrize("ffma", [4, 6, 0])
    def test_ffma_is_pinned_exactly(self, ffma):
        found = kernel_audit.check_budgets(self._pinned(ffma=ffma), self._measured())
        assert [f.rule for f in found] == ["kernel-budget"]
        assert "-fmad=false" in found[0].message

    def test_unpinned_and_stale_entries_flag(self):
        m = self._measured()
        b = json.loads(json.dumps(m))
        b["entries"]["gone.cu:k<0>"] = dict(m["entries"]["fix.cu:k<0>"])
        m["entries"]["new.cu:k<1>"] = dict(m["entries"]["fix.cu:k<0>"])
        msgs = sorted(f.message for f in kernel_audit.check_budgets(b, m))
        assert len(msgs) == 2
        assert any("new.cu:k<1>" in s and "no pin" in s for s in msgs)
        assert any("gone.cu:k<0>" in s and "stale" in s for s in msgs)

    def test_shared_memory_growth_and_new_size_flag(self):
        m = self._measured()
        m["smem_bytes"]["overlap_worst"] += 8
        m["smem_bytes"]["quantile_512"] = 55488
        found = kernel_audit.check_budgets(self._measured(), m)
        assert sorted(f.rule for f in found) == ["kernel-budget", "kernel-budget"]

    def test_write_then_load_round_trip(self, tmp_path):
        path = str(tmp_path / "budgets.json")
        kernel_audit.write_budgets(path, self._measured())
        loaded = kernel_audit.load_budgets(path)
        assert loaded == self._measured()
        assert kernel_audit.check_budgets(loaded, self._measured()) == []
        assert kernel_audit.load_budgets(str(tmp_path / "nope.json")) is None


class TestKernelLayerWithoutToolchain:
    @pytest.fixture
    def no_toolkit(self, monkeypatch, tmp_path):
        def missing(name):
            raise EngineUnavailable(f"{name} not found: the CUDA toolkit is not installed")

        monkeypatch.setattr(_build, "cuda_tool", missing)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        # The lint layer over the live tree is TestLiveTree's; here only the
        # kernel layer decides the exit.
        monkeypatch.setattr(plint, "run_lint", lambda root, only=None: [])

    def test_audit_reports_kernel_build_and_checks_no_pins(self, no_toolkit):
        budgets = os.path.join(ANALYSIS, "budgets.json")
        findings, report = kernel_audit.audit(budgets_path=budgets)
        assert findings and rules_of(findings) == {"kernel-build"}
        # the build, each of the five libraries, and K2's ring
        assert len(findings) == 7
        assert report["budgets"]["checked"] is False and report["budgets"]["ok"] is False

    def test_measure_budgets_refuses_a_partial_census(self, no_toolkit):
        with pytest.raises(EngineUnavailable, match="incomplete"):
            kernel_audit.measure_budgets()

    def test_cli_without_toolchain_exits_one(self, no_toolkit, tmp_path, capsys):
        report = tmp_path / "report.json"
        assert main(["--json", str(report)]) == 1
        data = json.loads(report.read_text())
        assert data["layers"] == {"lint": True, "kernel": True}
        assert {f["rule"] for f in data["findings"]} == {"kernel-build"}
        assert "first offender: [kernel-build]" in capsys.readouterr().err

    def test_update_budgets_without_toolchain_writes_nothing(self, no_toolkit, tmp_path):
        path = tmp_path / "budgets.json"
        assert main(["--update-budgets", "--budgets", str(path)]) == 1
        assert not path.exists()

    def test_update_budgets_needs_the_kernel_layer(self, no_toolkit, tmp_path):
        assert main(["--update-budgets", "--no-kernels"]) == 2
        assert main(["--update-budgets", "--root", str(tmp_path)]) == 2


# ---------------------------------------------------------------------------
# The CLI in-process, the live tree and the checked-in files
# ---------------------------------------------------------------------------


class TestCli:
    def test_injected_violation_exits_nonzero(self, tmp_path, capsys):
        root = fixture(tmp_path, "raise_bare")
        assert main(["--root", root]) == 1
        assert "taxonomy-raise" in capsys.readouterr().out

    def test_root_other_than_the_package_skips_the_census(self, tmp_path):
        report = tmp_path / "r.json"
        assert main(["--root", fixture(tmp_path, "seam_inert"), "--json", str(report)]) == 0
        assert json.loads(report.read_text())["layers"] == {"lint": True, "kernel": False}

    def test_update_baseline_then_clean(self, tmp_path):
        root = fixture(tmp_path, "raise_bare")
        bl = tmp_path / "bl.json"
        assert main(["--root", root, "--baseline", str(bl), "--update-baseline"]) == 0
        assert main(["--root", root, "--baseline", str(bl)]) == 0
        data = json.loads(bl.read_text())
        assert len(data["suppressions"]) == 2

    def test_stats_flag_reports_counts_and_first_offender(self, tmp_path, capsys):
        assert main(["--stats", "--root", fixture(tmp_path, "raise_bare")]) == 1
        out, err = capsys.readouterr()
        assert "file(s) scanned" in out and "stats: taxonomy-raise: 2" in out
        assert "first offender: [taxonomy-raise]" in err

    def test_stale_baseline_entry_warns(self, tmp_path, capsys):
        root = fixture(tmp_path, "seam_inert")
        bl = tmp_path / "bl.json"
        bl.write_text(json.dumps({"version": 1, "suppressions": [
            {"fingerprint": "0123456789abcdef", "reason": "fixed long ago"}]}))
        assert main(["--root", root, "--baseline", str(bl)]) == 0
        assert "1 stale baseline entry" in capsys.readouterr().err


class TestLiveTree:
    def test_zero_findings_with_the_empty_baseline(self, tmp_path, capsys):
        baseline = os.path.join(ANALYSIS, "baseline.json")
        assert load_baseline(baseline) == {}
        report = tmp_path / "report.json"
        assert main(["--no-kernels", "--stats", "--json", str(report)]) == 0
        out = capsys.readouterr().out
        assert "stats: no findings" in out and "sketchlint: clean" in out
        data = json.loads(report.read_text())
        assert data["findings"] == [] and data["root"] == PKG_ROOT
        # the examples are out of scope; everything else is scanned
        files = plint.LintContext(PKG_ROOT).files
        assert not any(p.startswith("sketches_tpu_torch/examples/") for p in files)
        assert "sketches_tpu_torch/analysis/kernel_audit.py" in files

    def test_budgets_pin_every_library_without_f64(self):
        doc = kernel_audit.load_budgets(os.path.join(ANALYSIS, "budgets.json"))
        assert doc["tolerance_pct"] == kernel_audit.BUDGET_TOLERANCE_PCT
        sources = {k.split(":", 1)[0] for k in doc["entries"]}
        assert sources == set(_build.SOURCES)
        assert all(e["f64"] == 0 for e in doc["entries"].values())
        fields = {"registers", "shared", "stack", "local", "spill_stores", "spill_loads",
                  "sass", "f64", "ffma"}
        assert all(set(e) == fields for e in doc["entries"].values())
        smem = kernel_audit.smem_report()
        for name, value in smem["pins"].items():
            assert doc["smem_bytes"][name] == value
        assert set(doc["smem_bytes"]) == set(smem["pins"]) | {"quantile_512", "quantile_2048"}

    def test_retargeted_rules_hold_on_the_live_tree(self):
        # The deliberate device f64 is suppressed inline, not absent.
        mapping = open(os.path.join(PKG_ROOT, "mapping.py")).read()
        assert "sketchlint: ignore[torch-f64]" in mapping
        assert run_lint(PKG_ROOT, only=["torch-f64", "host-sync"]) == []


def test_cli_as_a_process_exits_zero_on_the_port():
    """The acceptance command, as a user runs it from the repo root."""
    proc = run([sys.executable, "-m", "sketches_tpu_torch.analysis", "--no-kernels", "--stats"],
               cwd=REPO_ROOT, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "stats: no findings" in proc.stdout

"""The root ``conftest.py``'s scheduler for ``--dist loadfile``: the files
of ``LONG_FILES`` go out first, each alone on its worker, and every other
file keeps xdist's order (most tests first).  Driven here with stand-in
workers; the tier-1 run itself uses it."""

import pathlib
from types import SimpleNamespace

import pytest

pytest.importorskip("xdist.scheduler", reason="the hook schedules for pytest-xdist")

ROOT = pathlib.Path(__file__).resolve().parent.parent


class _Worker:
    def __init__(self, name):
        self.gateway = SimpleNamespace(id=name)
        self.shutting_down = False
        self.sent = []

    def send_runtest_some(self, indexes):
        self.sent.extend(indexes)

    def shutdown(self):
        self.shutting_down = True


def _hooks(pytestconfig):
    return pytestconfig.pluginmanager.get_plugin(str(ROOT / "conftest.py"))


def _config(dist):
    return SimpleNamespace(option=SimpleNamespace(loadscopereorder=True),
                           getvalue={"dist": dist, "tx": ["2*popen"]}.get)


def test_long_file_goes_first_and_alone(pytestconfig):
    hooks = _hooks(pytestconfig)
    long_file = hooks.LONG_FILES[0]
    collection = ([f"tests/test_many.py::t{i}" for i in range(5)]
                  + [f"tests/test_some.py::t{i}" for i in range(4)]
                  + [f"{long_file}::t{i}" for i in range(3)])

    def files(worker):
        return [collection[i].split("::")[0] for i in worker.sent]

    sched = hooks.pytest_xdist_make_scheduler(config=_config("loadfile"), log=None)
    a, b = _Worker("gw0"), _Worker("gw1")
    for w in (a, b):
        sched.add_node(w)
    for w in (a, b):
        sched.add_node_collection(w, collection)
    sched.schedule()
    assert files(a) == [long_file] * 3
    assert files(b) == ["tests/test_many.py"] * 5

    # Two of the long file's tests left would hand xdist's worker more; not here.
    sched.mark_test_complete(a, a.sent[0])
    assert len(a.sent) == 3
    sched.mark_test_complete(a, a.sent[1])
    sched.mark_test_complete(a, a.sent[2])
    assert files(a)[3:] == ["tests/test_some.py"] * 4
    assert not b.shutting_down


def test_other_dist_modes_keep_xdist_scheduler(pytestconfig):
    hooks = _hooks(pytestconfig)
    for dist in ("load", "loadscope", "each", "worksteal"):
        assert hooks.pytest_xdist_make_scheduler(config=_config(dist), log=None) is None

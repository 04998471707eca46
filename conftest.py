"""Repository-wide pytest hooks.  Nothing here imports the packages, so
every test directory (``tests/``, ``sketchbench/tests``) loads this file
as it is.

``--dist loadfile`` (the tier-1 command) queues test files by their count
of tests, most first, so a long file with few tests goes out last and its
length is added to the run's end.  Under ``loadfile`` the scheduler below
hands out the files of :data:`LONG_FILES` first and gives their worker
nothing else until it is through with them; every other file keeps
xdist's order.  No test is left out or changed.
"""

import pytest

#: Files handed out first: few tests, most of a worker's run.
LONG_FILES = (
    "tests/test_property_stateful.py",  # 3 hypothesis tests, 650-745 s in tier-1
)


@pytest.hookimpl(optionalhook=True, tryfirst=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class LongFilesFirst(LoadFileScheduling):
        def _assign_work_unit(self, node):
            for scope in reversed(LONG_FILES):
                if scope in self.workqueue:
                    self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

        def _reschedule(self, node):
            work = self.assigned_work.get(node, {})
            if any(not all(work[s].values()) for s in LONG_FILES if s in work):
                return
            super()._reschedule(node)

    return LongFilesFirst(config, log)

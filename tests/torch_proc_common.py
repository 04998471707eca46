"""Child processes of the port's tests, each with a deadline.

``run`` starts a command in a process group of its own and waits at most
``timeout`` seconds for it.  On a miss it kills the whole group (the
child's own children too: an example's shards, a CLI's workers) and fails
the test with what the child printed, so a hung child costs the run its
limit once and says why.
"""

import os
import signal
import subprocess

import pytest

#: Seconds to read a killed child's output.
_DRAIN_S = 30


def run(cmd, *, timeout: float, **kwargs) -> subprocess.CompletedProcess:
    """``subprocess.run(cmd, capture_output=True, text=True)`` with a
    deadline that kills the child's whole process group."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True, **kwargs)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        try:  # the child leads a process group of its own
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        try:
            out, err = proc.communicate(timeout=_DRAIN_S)
        except subprocess.TimeoutExpired:  # a process outside the group holds the pipes
            out, err = "", f"(not drained in {_DRAIN_S} s)"
        pytest.fail(f"{cmd!r} passed its {timeout}-s limit and was killed\n"
                    f"--- stdout ---\n{out}\n--- stderr ---\n{err}")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)

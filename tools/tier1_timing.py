"""Time the tier-1 test run the way it is run for a pull request, and say
where its seconds go.

Tier-1 is ``pytest tests/ -m 'not slow'`` under ``pytest-xdist`` with six
workers and ``--dist loadfile`` (each file goes whole to one worker) and a
1470-s limit.  ``loadfile`` hands out files by their count of tests, most
first, so the files of one to three tests go last: the run's end is the
latest of its workers' ends, and a long file with few tests sets it.  The
root ``conftest.py`` therefore hands its ``LONG_FILES`` out first, each
alone on its worker.

    python3 tools/tier1_timing.py run OUT [--busy N] [-- PYTEST_ARGS]
    python3 tools/tier1_timing.py report OUT [OUT ...]
    python3 tools/tier1_timing.py simulate OUT [--port-scale F]

``run`` runs that command (plus ``--durations=0 -rf``) from the repo root
with this module loaded as a plugin, which writes each test's start time
and worker to ``OUT/events.log``; the output goes to ``OUT/log.txt``, each
line stamped with the seconds since the start, and the junit report to
``OUT/junit.xml``.  ``--busy N`` adds N CPU-bound processes beside the run
(a loaded machine; a plain ``--busy 3`` run ends inside the limit);
PYTEST_ARGS go at the end of the command.  ``report`` prints the result,
each file's seconds, the worker and start of each, each worker's last file
and end, and the seconds from the last progress line to the exit.
``simulate`` replays that scheduler on that run's test times
(``--port-scale`` scales the port's tests, ``tests/test_torch_*.py``) and
prints the end it predicts.
"""

import argparse
import collections
import heapq
import json
import os
import re
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 1470
WORKERS = 6
_EVENTS = "TIER1_TIMING_EVENTS"


# -- the plugin half: loaded into pytest with ``-p tier1_timing`` -----------

def _event(msg):
    path = os.environ.get(_EVENTS)
    if path:
        with open(path, "a", encoding="utf-8") as f:
            f.write(f"{time.time():.3f} {os.environ.get('PYTEST_XDIST_WORKER', 'main')} {msg}\n")


def pytest_runtest_logstart(nodeid, location):
    _event("start " + nodeid)


def pytest_sessionfinish(session, exitstatus):
    _event(f"finish {exitstatus}")


# -- the command half --------------------------------------------------------

def command(out, extra):
    return ["timeout", "-k", "10", str(LIMIT_S), sys.executable, "-m", "pytest", "tests/", "-q",
            "-m", "not slow", "--continue-on-collection-errors", "-p", "no:cacheprovider",
            "-p", "xdist", "-n", str(WORKERS), "--dist", "loadfile",
            f"--junitxml={out}/junit.xml", "-p", "no:randomly", "-p", "tier1_timing",
            "--durations=0", "-rf", *extra]


def run(out, busy, extra):
    os.makedirs(out, exist_ok=True)
    for name in ("events.log", "log.txt", "junit.xml"):
        if os.path.exists(os.path.join(out, name)):
            os.remove(os.path.join(out, name))
    env = dict(os.environ, JAX_PLATFORMS="cpu", ALLOW_MULTIPLE_LIBTPU_LOAD="1",
               PYTHONPATH=os.pathsep.join(p for p in (os.path.dirname(os.path.abspath(__file__)),
                                                      os.environ.get("PYTHONPATH")) if p))
    env[_EVENTS] = os.path.abspath(os.path.join(out, "events.log"))
    loops = [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(busy)]
    t0 = time.monotonic()
    try:
        proc = subprocess.Popen(command(out, extra), cwd=ROOT, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        with open(os.path.join(out, "log.txt"), "w", encoding="utf-8", buffering=1) as log:
            for line in proc.stdout:
                log.write(f"{time.monotonic() - t0:9.2f} {line}")
            rc = proc.wait()
            log.write(f"{time.monotonic() - t0:9.2f} EXIT {rc}\n")
    finally:
        for p in loops:
            p.kill()
            p.wait()
    result = {"rc": rc, "seconds": round(time.monotonic() - t0, 1), "busy": busy, "extra": extra}
    with open(os.path.join(out, "result.json"), "w", encoding="utf-8") as f:
        json.dump(result, f)
    print(json.dumps(result))
    return rc


def junit_times(out):
    """``{nodeid: seconds}`` and ``{outcome: count}`` from a junit report."""
    times, outcomes = {}, collections.Counter()
    for tc in ET.parse(os.path.join(out, "junit.xml")).iter("testcase"):
        parts = tc.get("classname").split(".")
        nodeid = f"{parts[0]}/{parts[1]}.py::" + "::".join(parts[2:] + [tc.get("name")])
        times[nodeid] = float(tc.get("time"))
        kinds = {child.tag for child in tc}
        outcomes["failed" if kinds & {"failure", "error"} else
                 "skipped" if "skipped" in kinds else "passed"] += 1
    return times, outcomes


def _file(nodeid):
    return nodeid.split("::")[0]


def event_times(events, end):
    """``{nodeid: seconds}`` from the plugin's events, for a run cut
    before it wrote its junit report: each test lasts until the next event
    of its worker, the last one until ``end`` (seconds after the first event)."""
    by_worker = collections.defaultdict(list)
    for t, worker, msg in events:
        if worker != "main":
            by_worker[worker].append((t, msg))
    times = {}
    for evs in by_worker.values():
        for (t, msg), nxt in zip(evs, evs[1:] + [(end, "")]):
            if msg.startswith("start "):
                times[msg[6:]] = nxt[0] - t
    return times


def log_outcomes(lines):
    """``{outcome: count}`` from the progress characters of the log."""
    chars = "".join(ln.split()[1] for ln in lines
                    if len(ln.split()) > 1 and re.fullmatch(r"[.FEsx]+", ln.split()[1]))
    return {"passed": chars.count("."), "failed": chars.count("F") + chars.count("E"),
            "skipped": chars.count("s")}


def report(out):
    result = json.load(open(os.path.join(out, "result.json"), encoding="utf-8"))
    lines = open(os.path.join(out, "log.txt"), encoding="utf-8").read().splitlines()
    progress = [float(ln.split()[0]) for ln in lines if re.search(r"\[ *\d+%\]", ln)]
    events = [ln.rstrip("\n").split(" ", 2) for ln in
              open(os.path.join(out, "events.log"), encoding="utf-8")]
    t0 = min(float(e[0]) for e in events)
    events = [(float(t) - t0, worker, msg) for t, worker, msg in events]
    if os.path.exists(os.path.join(out, "junit.xml")):
        times, outcomes = junit_times(out)
    else:  # cut at the limit: no junit report
        times = event_times(events, max(t for t, _, _ in events))
        outcomes = log_outcomes(lines)
    print(f"== {out}: rc {result['rc']}, {result['seconds']} s, {dict(outcomes)}; "
          f"last progress line at {progress[-1] if progress else None} s, "
          f"exit {float(lines[-1].split()[0]) - (progress[-1] if progress else 0):.1f} s after it")
    failed = [ln.split(None, 2)[2] for ln in lines if ln.split(None, 2)[1:2] == ["FAILED"]]
    for f in failed:
        print("   ", f)
    starts, finish = {}, {}
    for t, worker, msg in events:
        if worker == "main":
            continue
        if msg.startswith("start "):
            starts.setdefault(_file(msg[6:]), (worker, t))
        elif msg.startswith("finish"):
            finish[worker] = t
    per_file = collections.Counter()
    for nodeid, s in times.items():
        per_file[_file(nodeid)] += s
    print(f"{'seconds':>8} {'worker':>6} {'start':>7}  file")
    for f, s in per_file.most_common():
        worker, start = starts.get(f, ("-", float("nan")))
        print(f"{s:8.1f} {worker:>6} {start:7.1f}  {f}")
    port = sum(s for f, s in per_file.items() if "test_torch_" in f)
    print(f"all tests {sum(per_file.values()):.1f} s, the port's {port:.1f} s")
    for worker in sorted({w for w, _ in starts.values()}):
        last = max((s, f) for f, (w, s) in starts.items() if w == worker)
        end = f"finished at {finish[worker]:.1f} s" if worker in finish else "not finished"
        print(f"{worker}: last file {last[1]} at {last[0]:.1f} s, {end}")


def collection():
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-q", "-m", "not slow", "--collect-only",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return [ln.strip() for ln in out.stdout.splitlines() if "::" in ln]


def simulate(order, times):
    """The end tier-1's scheduler reaches with these test times: files
    queued by their count of tests, most first, behind the root
    ``conftest.py``'s ``LONG_FILES``; a worker takes the next file whenever
    two or fewer of its tests are left to finish, and none while a long
    file's are."""
    sys.path.insert(0, ROOT)
    from conftest import LONG_FILES

    files = collections.defaultdict(list)
    for nodeid in order:
        files[_file(nodeid)].append(nodeid)
    rank = {f: i for i, f in enumerate(LONG_FILES)}
    queue = collections.deque(sorted(files.values(), key=lambda tests: (
        rank.get(_file(tests[0]), len(rank)), -len(tests))))
    pending = [collections.deque() for _ in range(WORKERS)]

    def wants(i):
        return (queue and len(pending[i]) <= 2
                and not any(_file(n) in rank for n in pending[i]))

    for i in range(WORKERS):
        if queue:
            pending[i].extend(queue.popleft())
    for i in range(WORKERS):
        if wants(i):
            pending[i].extend(queue.popleft())
    ends, clock = [0.0] * WORKERS, [(0.0, i) for i in range(WORKERS)]
    while clock:
        now, i = heapq.heappop(clock)
        if wants(i):
            pending[i].extend(queue.popleft())
        if not pending[i]:
            ends[i] = now
            continue
        heapq.heappush(clock, (now + times.get(pending[i].popleft(), 0.0), i))
    return max(ends)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("out")
    r.add_argument("--busy", type=int, default=0)
    r.add_argument("extra", nargs="*")
    sub.add_parser("report").add_argument("outs", nargs="+")
    s = sub.add_parser("simulate")
    s.add_argument("out")
    s.add_argument("--port-scale", type=float, default=1.0)
    a = ap.parse_args(argv)
    if a.cmd == "run":
        return run(a.out, a.busy, a.extra)
    if a.cmd == "report":
        for out in a.outs:
            report(out)
        return 0
    times, _ = junit_times(a.out)
    times = {k: v * (a.port_scale if "test_torch_" in k else 1.0) for k, v in times.items()}
    print(f"predicted end: {simulate(collection(), times):.1f} s after the workers start")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Noise study of ``chip_smoke.py``'s observability gate on the card.

Times the gate's two facade calls (1M x 512 ``add`` and the default-route
query) in runs of 21 calls, each call with CUDA events and the host's
clocks, first with 0, 4, 8 and 16 busy-looping processes on the host, then
again after telemetry, profiling, the accuracy audit and the flight
recorder were armed and disarmed.  Prints one JSON line a run and, per
call, state and load, the least run median and least single call; writes
every run to OUT (default ``build/obs_noise.json``).  Needs one CUDA card:

    python3 tools/obs_gate_noise.py [OUT]

``cpu_*`` is the calling thread's CPU time, which Linux counts in 10 ms
ticks: too coarse for these calls.
"""
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def window(fn, warmup=2, reps=21):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev, cpu, wall = [], [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        c0 = time.thread_time()
        w0 = time.perf_counter()
        fn()
        w1 = time.perf_counter()
        c1 = time.thread_time()
        b.record()
        b.synchronize()
        ev.append(a.elapsed_time(b))
        cpu.append((c1 - c0) * 1e3)
        wall.append((w1 - w0) * 1e3)
    return {"ev_med": statistics.median(ev), "ev_min": min(ev), "cpu_med": statistics.median(cpu),
            "cpu_min": min(cpu), "wall_med": statistics.median(wall), "load1": os.getloadavg()[0]}


def busy(k):
    return [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(k)]


def main():
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.phase_card()
    cs.phase_build()
    from sketches_tpu_torch import BatchedDDSketch, accuracy, profiling, telemetry, tracing
    import gc

    gen = torch.Generator(device=device).manual_seed(7)
    timing = BatchedDDSketch(n_streams=cs.N_STREAMS, relative_accuracy=cs.ALPHA,
                             n_bins=cs.N_BINS, key_offset=cs.OBS_KEY_OFFSET)
    for _ in range(2):
        timing.add(cs._mixed_batch(gen, cs.N_STREAMS, device))
    v = cs._mixed_batch(gen, cs.N_STREAMS, device)
    fns = {"add": lambda: timing.add(v), "query": lambda: timing.get_quantile_values(cs.QS)}
    out = []

    def series(tag, k, n=5):
        procs = busy(k)
        try:
            time.sleep(1.0)
            for i in range(n):
                for name, fn in fns.items():
                    gc.collect()
                    torch.cuda.synchronize()
                    r = window(fn)
                    r.update(tag=tag, busy=k, i=i, fn=name)
                    out.append(r)
                    print(json.dumps(r), flush=True)
        finally:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()

    series("before", 0)
    series("before", 4)
    series("before", 8)
    series("before", 16)
    series("before", 0)
    sk = BatchedDDSketch(n_streams=cs.N_STREAMS, relative_accuracy=cs.ALPHA,
                         n_bins=cs.N_BINS, key_offset=cs.OBS_KEY_OFFSET)
    telemetry.enable()
    profiling.enable()
    accuracy.enable()
    tracing.seed_ids(1)
    accuracy.watch(sk, "q", streams=tuple(range(8)), interval=1)
    for _ in range(2):
        sk.add(cs._mixed_batch(gen, cs.N_STREAMS, device))
    sk.get_quantile_values(cs.QS)
    telemetry.disable()
    telemetry.reset()
    tracing.reset()
    profiling.disable()
    profiling.reset()
    accuracy.disable()
    accuracy.reset()
    series("after", 0)
    series("after", 8)
    series("after", 16)
    series("after", 0)
    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join("build", "obs_noise.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f)
    for fn in fns:
        for tag in ("before", "after"):
            for k in (0, 4, 8, 16):
                rows = [r for r in out if r["fn"] == fn and r["tag"] == tag and r["busy"] == k]
                if not rows:
                    continue
                print(fn, tag, k, {s: round(min(r[s] for r in rows), 4)
                                   for s in ("ev_med", "ev_min", "cpu_med", "cpu_min", "wall_med")})


if __name__ == "__main__":
    main()

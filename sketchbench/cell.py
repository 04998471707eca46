"""One run of one cell: set-up, the measured window, the check, the result.

The cell's entry in ``BENCHMARK.json`` names its configuration (the file
under ``configs/``, whose ``system`` names a module of ``systems/``:
``batched`` when it names none) and its traffic (``traffic/<name>.json``,
whose ``loop``, ``values`` and ``flush`` name modules of ``loops/`` and
``gen/``); each per-layer metric is read by ``metrics/<name>.py``.  So a
new cell needs new files and a manifest entry, and no edit of a file the
harness has.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional

import torch

from sketchbench import gen, loops, systems
from sketchbench.loops import clock
from sketchbench.yardstick import peaks, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules no run may hold when it ends: JAX and its package.
FORBIDDEN = ("jax", "jaxlib", "flax", "sketches_tpu")


def parse(argv):
    p = argparse.ArgumentParser(prog="sketchbench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--manifest", type=Path, default=ROOT / "BENCHMARK.json",
                   help="the benchmark manifest (its directory is the data root)")
    p.add_argument("--cpu-rehearsal", action="store_true",
                   help="run on the CPU and report no metric")
    p.add_argument("--streams", type=int, default=0,
                   help="with --cpu-rehearsal: the streams to run instead")
    return p.parse_args(argv)


def load_cell(manifest_path: Path, workload: str):
    manifest = json.loads(manifest_path.read_text())
    root = manifest_path.resolve().parent
    cell = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in {manifest_path}")
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic_path = root / manifest["paths"][0] / "traffic" / f"{cell['traffic']}.json"
    traffic = json.loads(traffic_path.read_text())
    return manifest, cell, config, traffic


def applies(metric: dict, cell: dict, reported: set) -> bool:
    """Whether a cell reports ``metric``: the cells it lists, else every
    cell that reports what it moves (an end-to-end metric: every cell)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    module = "sketchbench_metric_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line(device) -> dict:
    if device.type != "cuda":
        return {"info": "card", "name": "cpu", "torch": torch.__version__}
    out = {"info": "card", "name": torch.cuda.get_device_name(device),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader",
             "-i", str(device.index or 0)], capture_output=True, text=True, timeout=30)
        out["nvidia_smi"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
    return out


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None, started: Optional[float] = None, system_factory=None) -> int:
    started = clock() if started is None else started
    args = parse(argv)
    manifest, cell, config, traffic = load_cell(args.manifest, args.workload)
    try:
        mod = systems.system(config.get("system", "batched"))
    except ModuleNotFoundError as e:
        print(f"sketchbench: {cell['config']} names system {config.get('system')!r}:"
              f" no module {e.name}", file=sys.stderr)
        return 2
    if args.cpu_rehearsal:
        device = torch.device("cpu")
    else:
        chips = int(cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"sketchbench: {args.workload} needs {chips} CUDA device(s); found"
                  f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    n = args.streams if (args.cpu_rehearsal and args.streams) else int(config["n_streams"])
    n_bins = int(config["bin_limit"])
    qs = tuple(traffic.get("quantiles", ()))
    ck = traffic["check"]

    # -- set-up: inputs, the system, the first add and two more steps --
    inputs = gen.build(traffic, args.seed, n, device)
    sut = (system_factory or mod.Program)(config, n, device)
    loop = loops.loop(traffic["loop"])
    start = loop.warm(sut, inputs, traffic)
    setup_s = clock() - started
    rows = gen.sample_rows(inputs, int(ck["rows"]), int(ck.get("heaviest", 0)))

    tracer = trace.Tracer(int(traffic["trace_steps"]) if args.trace else 0, device,
                          lambda: mod.facts(sut, inputs, config, qs))
    before = sut.counters()

    # -- the measured window --
    res = loop.window(sut, inputs, traffic, args.seconds, tracer, rows, start)

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    prog = sut.leaves(rows)
    counters = sut.counters()
    window_launches = {k: v - before.get(k, 0) for k, v in counters.items()}
    described = sut.describe()
    sut.close()
    del sut
    inputs.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check, against the plain reference --
    t_check = clock()
    verdict = mod.judge(config, inputs, rows, prog, res["adds"], ck["limits"], qs,
                        res["kept"])
    check_s = clock() - t_check

    # An end-to-end metric ``<base>.<kind>`` reports the loop's ``<base>``
    # in the cells it lists.
    values = {"setup_s": setup_s, **res["metrics"]}
    e2e = {}
    for m in manifest["end_to_end"]:
        base = values.get(m["name"], values.get(m["name"].split(".")[0]))
        if base is not None and applies(m, cell, set()):
            e2e[m["name"]] = {"value": base, "unit": m["unit"]}
    out_device = {"platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  "count": 1 if device.type == "cuda" else 0,
                  "memory_peak_bytes": peak}
    extra = {}
    metrics = e2e
    if args.trace:
        path = tracer.export()
        facts_now = dict(tracer.facts, window_adds=res["ops"], window_launches=window_launches)
        try:
            ctx = trace.reduce(path, cell["name"], traffic["loop"], out_device["kind"],
                               peaks.mem_rate(out_device["kind"]), res["host"], facts_now)
        finally:
            Path(path).unlink(missing_ok=True)
        metrics = {}
        for m in manifest["per_layer"]:
            if applies(m, cell, set(e2e)):
                v = reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out_device["busy_s"] = ctx.busy_s
        out_device["window_s"] = ctx.window_s
        extra["breakdown"] = trace.breakdown(ctx)
    if device.type != "cuda":
        metrics = {}  # a CPU run reports no device metric

    emit(card_line(device))
    emit({"info": "cell", "workload": cell["name"], "config": cell["config"],
          "traffic": cell["traffic"], "n_streams": n, "n_bins": n_bins, "seed": args.seed,
          "seconds": args.seconds, "trace": args.trace, "system": described})
    emit({"info": "setup", "setup_s": setup_s, "adds": start, "pool": inputs.pool_size,
          "live_values_per_add": inputs.live_values})
    emit({"info": "window", **res["info"]})
    emit({"info": "launches", **counters})
    emit({"info": "check", "check_s": check_s, **verdict["diag"]})

    held = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if held:
        print(f"sketchbench: the run loaded {held}; no result", file=sys.stderr)
        return 3
    for name, (value, limit) in verdict["numbers"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    emit({
        "correct": verdict["correct"],
        "attempted": res["ops"],
        "failed": 0,
        "metrics": metrics,
        "device": out_device,
        **extra,
        "check": {k: {"value": v, "limit": lim} for k, (v, lim) in verdict["numbers"].items()},
    })
    return 0

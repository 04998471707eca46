"""K1 (``csrc/ingest.cu``) of this tree beside other trees' builds, on one card.

    python3 tools/k1_turns.py [--compare DIR ...] [--out FILE]

Each DIR holds ``sketches_tpu_torch/csrc`` (a ``git archive`` of the parent
commit, or a patched copy, unpacked under the gitignored ``build/``).
Builds ``ingest.cu`` of this tree and of every DIR with this tree's flags,
then prints one JSON object (also written to FILE, default
``build/k1_turns.json``):

* ``card``: ``nvidia-smi``'s name and power limit;
* ``sass``: for each build's ingest entries, registers and stack bytes
  (``cuobjdump -res-usage``, via the analyzer's census) and the local-memory
  loads and stores in its SASS (``LDL`` / ``STL`` instructions);
* ``ingest``: ``chip_smoke.time_ingest`` -- the lognormal, constant,
  weighted and padded weighted batches at the main path's launch shape,
  every DIR's kernel timed beside this tree's in turns, and whether each
  DIR's outputs equal this tree's bit for bit.

Needs one CUDA card; exits 2 without one.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

_LOCAL = re.compile(r"^(LDL|STL)(\.|$)")


def local_memory_ops(lib: Path) -> dict:
    """{mangled entry: {"LDL": n, "STL": n}} from ``cuobjdump -sass``."""
    from sketches_tpu_torch import _build
    from sketches_tpu_torch.analysis import kernel_audit

    text = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = kernel_audit._SASS_FUNC.match(line)
        if m:
            cur = out[m.group(1)] = {"LDL": 0, "STL": 0}
            continue
        m = kernel_audit._SASS_INSN.match(line)
        if m and cur is not None:
            hit = _LOCAL.match(m.group(1))
            if hit:
                cur[hit.group(1)] += 1
    return out


def sass_report(csrc: Path) -> dict:
    """Registers, stack and LDL/STL counts of one build's ingest entries."""
    from sketches_tpu_torch import _build
    from sketches_tpu_torch.analysis import kernel_audit

    lib = _build.library_path("ingest.cu", csrc)
    entries, findings = kernel_audit.census("ingest.cu", lib)
    cs.require(not findings, f"census of {lib}: {findings}")
    local = local_memory_ops(lib)
    cufilt = _build.cuda_tool("cu++filt")
    mangled = sorted(local)
    names = subprocess.run([cufilt, *mangled], capture_output=True, text=True, check=True,
                           timeout=60).stdout.splitlines()
    out = {}
    for m, dem in zip(mangled, names):
        key = f"ingest.cu:{kernel_audit._entry_name(dem)}"
        e = entries[key]
        out[key] = {"registers": e["registers"], "stack": e["stack"], "sass": e["sass"],
                    **local[m]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", type=Path, action="append", default=[], metavar="DIR")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k1_turns.json")
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_turns: no CUDA device", file=sys.stderr)
        return 2
    from sketches_tpu_torch import _build

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = cs.phase_card()
    _build.build(["ingest.cu"])
    trees = cs.build_compare(opts.compare) if opts.compare else {}
    sass = {"this": sass_report(_build.CSRC)}
    for t in opts.compare:
        sass[t.name] = sass_report(t.resolve() / "sketches_tpu_torch" / "csrc")
    ingest = cs.time_ingest(device, card["mem_rate_Bps"],
                            {k: e["sk_ingest"] for k, e in trees.items()})
    out = {"card": card["smi"], "sass": sass, "ingest": ingest}
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(out, indent=1, sort_keys=True))
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""sketchlint layer 2 of the PyTorch port: a census of the built CUDA
kernels (counterpart of ``sketches_tpu/analysis/jaxpr_audit.py``).

The AST layer checks what the source *says*; this layer checks what
``nvcc`` *built* for ``sm_90a``.  Nothing here is a jaxpr: the JAX audit
traces its entry points and walks the lowering, the port reads the five
shared libraries ``_build`` compiles from ``csrc/`` (one per kernel
source, :func:`default_entry_points`).  For every kernel entry and
template specialization in them (``ingest_kernel<0, false>``, ...):

* from ``cuobjdump -res-usage``: registers, static shared memory, stack
  frame and local memory;
* from the ptxas report ``_build`` keeps beside each library
  (``-Xptxas -v``): spill store and load bytes;
* from ``cuobjdump -sass``: the SASS instruction count (the counterpart
  of the JAX census's element ops), the f64 instructions
  (:data:`F64_OPCODES`, any ``.F64`` conversion, the ``64H`` MUFU
  forms) and the ``FFMA`` count (:data:`FFMA_OPCODES`).

Entries are keyed ``<source>:<demangled name>`` (``cu++filt``).  The
build passes ``-fmad=false``, which forbids contracting a multiply and
an add, not the explicit fused multiply-adds inside libdevice's
``logf``/``expf``, so ``FFMA`` is not 0; it is pinned exactly, so a
dropped ``-fmad=false`` shows.

Findings (``layer="kernel"``):

* ``kernel-f64`` -- any f64 instruction: the device tier is f32, and the
  kernels' bit-for-bit parity with their plain versions and the f32 JAX
  reference rests on it.
* ``kernel-spill`` -- spill bytes, stack frame or local memory above the
  pin.
* ``kernel-budget`` -- registers or static shared memory above the pin,
  a SASS count more than :data:`BUDGET_TOLERANCE_PCT` percent above it,
  an ``FFMA`` count different from it, a worst-case dynamic shared
  memory above its pin, or an unpinned or stale entry
  (``analysis/budgets.json``; re-pin on the card with
  ``--update-budgets``, never silently).
* ``smem-budget`` -- :func:`smem_report`'s worst case breaks
  :data:`SMEM_BUDGET_BYTES`, or a ``kSmemLimit`` of ``csrc/`` differs
  from ``kernels.py``'s.
* ``kernel-build`` -- a library, a tool (``nvcc``, ``cuobjdump``,
  ``cu++filt``) or a ptxas report is missing, or a tool failed.  The
  layer never passes silently: without a toolchain it reports this.

The census needs the CUDA toolkit (the card machine); :func:`smem_report`
runs anywhere from ``kernels.py``'s constants, apart from the full-window
kernel's ring, which C sizes (``csrc/quantile.cu`` ``plan_of``) and
which is read through the library's ``sk_quantile_shape`` on a card.
The text parsers are pure, so tests run them on recorded tool output.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from sketches_tpu_torch import _build, kernels
from sketches_tpu_torch.analysis.lint import Finding
from sketches_tpu_torch.resilience import EngineUnavailable

__all__ = [
    "SMEM_BUDGET_BYTES",
    "FFMA_OPCODES",
    "F64_OPCODES",
    "audit",
    "census",
    "check_budgets",
    "default_entry_points",
    "parse_sass",
    "load_budgets",
    "measure_budgets",
    "smem_report",
    "write_budgets",
]

#: Dynamic shared memory one H100 block may opt into (227 KiB); the
#: kernels' own limit, ``kernels._SMEM_BYTES``.
SMEM_BUDGET_BYTES = kernels._SMEM_BYTES

#: f64 arithmetic opcodes (``DEPBAR``, a dependency barrier, is not one).
#: Conversions to or from f64 (``F2F.F64.F32``, ``I2F.F64``, ...) and the
#: ``MUFU.RCP64H``/``RSQ64H`` forms are matched by their suffixes.
F64_OPCODES = frozenset({"DADD", "DMUL", "DFMA", "DMNMX", "DSETP", "DSET", "DMMA"})

#: Fused multiply-add opcodes, pinned exactly (contraction shows here).
FFMA_OPCODES = frozenset({"FFMA", "FFMA32I"})

#: Upward drift allowed on a SASS instruction count before the gate
#: fails.  The count is deterministic for a fixed toolkit; the slack
#: absorbs scheduling churn, while a real change of a kernel's code moves
#: it by more.
BUDGET_TOLERANCE_PCT = 2.0

#: Most quantiles the tile family takes (``kernels.tile_query_eligible``).
_Q_MAX = 8

_BUDGET_PATH = "<budgets:analysis/budgets.json>"
_TIMEOUT_S = 300


def _finding(rule: str, path: str, message: str) -> Finding:
    return Finding(rule, path, 0, message, layer="kernel")


# ---------------------------------------------------------------------------
# Parsers of the tools' output (pure; tests feed them recorded text)
# ---------------------------------------------------------------------------

_RES_FUNC = re.compile(r"^\s*Function (\S+):\s*$")
_RES_FIELD = re.compile(r"([A-Z]+(?:\[\d+\])?):(\d+)")
_RES_NAMES = {"REG": "registers", "STACK": "stack", "SHARED": "shared", "LOCAL": "local"}
_PTXAS_PROPS = re.compile(
    r"Function properties for (\S+)\s*\n\s*(\d+) bytes stack frame,"
    r" (\d+) bytes spill stores, (\d+) bytes spill loads"
)
_SASS_FUNC = re.compile(r"^\s*Function : (\S+)\s*$")
_SASS_INSN = re.compile(
    r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P(?:T|\d+)\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)"
)


def _parse_res_usage(text: str) -> Dict[str, Dict[str, int]]:
    """``cuobjdump -res-usage`` -> ``{mangled: {registers, stack, shared,
    local}}``."""
    out: Dict[str, Dict[str, int]] = {}
    name: Optional[str] = None
    for line in text.splitlines():
        m = _RES_FUNC.match(line)
        if m:
            name = m.group(1)
            continue
        if name is not None:
            fields = dict(_RES_FIELD.findall(line))
            out[name] = {v: int(fields.get(k, 0)) for k, v in _RES_NAMES.items()}
            name = None
    return out


def _parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """The ``-Xptxas -v`` report -> ``{mangled: {spill_stores,
    spill_loads}}``."""
    return {
        m.group(1): {"spill_stores": int(m.group(3)), "spill_loads": int(m.group(4))}
        for m in _PTXAS_PROPS.finditer(text)
    }


def _is_f64(opcode: str) -> bool:
    parts = opcode.split(".")
    return (
        parts[0] in F64_OPCODES
        or "F64" in parts[1:]
        or any(p.endswith("64H") for p in parts[1:])
    )


def parse_sass(text: str) -> Dict[str, Dict]:
    """``cuobjdump -sass`` -> ``{mangled: {sass, f64, ffma, f64_opcodes}}``:
    instructions (``NOP`` padding excluded), f64 instructions, fused
    multiply-adds, and the distinct f64 opcodes met."""
    out: Dict[str, Dict] = {}
    cur: Optional[Dict] = None
    for line in text.splitlines():
        m = _SASS_FUNC.match(line)
        if m:
            cur = out[m.group(1)] = {"sass": 0, "f64": 0, "ffma": 0, "f64_opcodes": []}
            continue
        m = _SASS_INSN.match(line)
        if m is None or cur is None:
            continue
        op = m.group(1)
        if op == "NOP":
            continue
        cur["sass"] += 1
        if op.split(".")[0] in FFMA_OPCODES:
            cur["ffma"] += 1
        if _is_f64(op):
            cur["f64"] += 1
            if op not in cur["f64_opcodes"]:
                cur["f64_opcodes"].append(op)
    return out


def _entry_name(demangled: str) -> str:
    """``void <unnamed>::ingest_kernel<(int)0, (bool)0>(<unnamed>::Args)``
    -> ``ingest_kernel<0, false>``: no return type, namespaces or
    parameter list, plain template arguments."""
    s = demangled.strip().replace("<unnamed>::", "").replace("(anonymous namespace)::", "")
    if s.endswith(")"):
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i]
                break
    head = s.split("<", 1)[0]
    if " " in head:
        s = s[head.rindex(" ") + 1 :]
        head = s.split("<", 1)[0]
    if "::" in head:
        s = s[head.rindex("::") + 2 :]
    s = re.sub(r"\(bool\)0\b", "false", s)
    s = re.sub(r"\(bool\)1\b", "true", s)
    return re.sub(r"\((?:unsigned )?(?:int|long|char|short)\)(-?\d+)", r"\1", s)


def _merge_census(
    source: str,
    res_text: str,
    ptxas_text: str,
    sass_text: str,
    demangle: Callable[[Sequence[str]], List[str]],
) -> Tuple[Dict[str, Dict], List[Finding]]:
    """One library's entries from its three tool outputs -> ``(entries,
    findings)``; ``demangle`` maps mangled names to ``cu++filt`` lines."""
    where = f"<kernel:{source}>"
    res = _parse_res_usage(res_text)
    ptx = _parse_ptxas(ptxas_text)
    sass = parse_sass(sass_text)
    findings: List[Finding] = []
    if not res:
        return {}, [_finding("kernel-build", where, f"{source}: cuobjdump -res-usage lists no"
                             " kernel entry")]
    mangled = sorted(res)
    names = demangle(mangled)
    if len(names) != len(mangled):
        return {}, [_finding("kernel-build", where, f"{source}: cu++filt returned"
                             f" {len(names)} names for {len(mangled)} entries")]
    entries: Dict[str, Dict] = {}
    for m, dem in zip(mangled, names):
        key = f"{source}:{_entry_name(dem)}"
        if m not in ptx or m not in sass:
            missing = "the ptxas report" if m not in ptx else "cuobjdump -sass"
            findings.append(_finding("kernel-build", where, f"{key}: no entry in {missing}"))
            continue
        s = sass[m]
        entries[key] = {**res[m], **ptx[m], "sass": s["sass"], "f64": s["f64"], "ffma": s["ffma"]}
        if s["f64"]:
            findings.append(_finding(
                "kernel-f64", where,
                f"{key}: {s['f64']} f64 instruction(s) ({', '.join(s['f64_opcodes'])});"
                " the device tier is f32",
            ))
    return entries, findings


# ---------------------------------------------------------------------------
# The census on a built library
# ---------------------------------------------------------------------------


def default_entry_points() -> List[Tuple[str, Path]]:
    """The audited surface: each kernel source and its built library."""
    return [(src, _build.library_path(src)) for src in _build.SOURCES]


def _run(cmd: Sequence[str]) -> str:
    out = subprocess.run(list(cmd), capture_output=True, text=True, timeout=_TIMEOUT_S)
    if out.returncode != 0:
        raise EngineUnavailable(
            f"{Path(cmd[0]).name} exited {out.returncode}: {out.stderr.strip()[:300]}"
        )
    return out.stdout


def census(source: str, library: Optional[Path] = None) -> Tuple[Dict[str, Dict], List[Finding]]:
    """Registers, shared memory, stack, local memory, spills, SASS, f64
    and FFMA counts of every kernel entry in ``source``'s built library
    -> ``(entries, findings)``.  A missing library, tool or ptxas report,
    or a tool that fails, is a ``kernel-build`` finding, never a raise."""
    where = f"<kernel:{source}>"
    lib = Path(library) if library is not None else _build.library_path(source)
    if not lib.is_file():
        return {}, [_finding("kernel-build", where,
                             f"{source}: no built library {lib.name} (build it with nvcc)")]
    log = lib.with_suffix(".log")  # _build keeps the ptxas report here
    ptxas = log.read_text() if log.is_file() else ""
    if "Function properties for" not in ptxas:
        return {}, [_finding("kernel-build", where, f"{source}: no ptxas report beside {lib.name}")]
    try:
        cuobjdump = _build.cuda_tool("cuobjdump")
        cufilt = _build.cuda_tool("cu++filt")
        res_text = _run([cuobjdump, "-res-usage", str(lib)])
        sass_text = _run([cuobjdump, "-sass", str(lib)])

        def demangle(names: Sequence[str]) -> List[str]:
            return _run([cufilt, *names]).splitlines()

        return _merge_census(source, res_text, ptxas, sass_text, demangle)
    except (EngineUnavailable, OSError, subprocess.TimeoutExpired) as e:
        return {}, [_finding("kernel-build", where, f"{source}: {e}")]


def nvcc_release() -> str:
    """``nvcc --version``'s release (``release 12.9, V12.9.86``), '' when
    there is no compiler."""
    try:
        text = _run([_build.cuda_tool("nvcc"), "--version"])
    except (EngineUnavailable, OSError, subprocess.TimeoutExpired):
        return ""
    m = re.search(r"release [^\n]*", text)
    return m.group(0).strip() if m else ""


# ---------------------------------------------------------------------------
# Shared memory, from first principles and the constants in kernels.py
# ---------------------------------------------------------------------------

_CSRC_CONST = r"constexpr\s+(?:int|long)\s+{name}\s*=\s*(\d+)\s*;"


def _csrc_constant(source: str, name: str) -> Optional[int]:
    text = (_build.CSRC / source).read_text()
    m = re.search(_CSRC_CONST.format(name=re.escape(name)), text)
    return int(m.group(1)) if m else None


def _quantile_smem(n_bins: int) -> int:
    """K2's dynamic shared memory at ``n_bins`` (``sk_quantile_shape``;
    needs the built library and a CUDA device).  Raises
    ``EngineUnavailable`` when the query fails."""
    fn = ctypes.CDLL(str(_build.library_path("quantile.cu"))).sk_quantile_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 7)()
    err = fn(0, n_bins, vals)
    if err != 0:
        raise EngineUnavailable(f"sk_quantile_shape failed with CUDA error {err}")
    return int(vals[3])


def smem_report() -> Dict:
    """The kernels' worst-case dynamic shared memory a block, each against
    :data:`SMEM_BUDGET_BYTES`.

    * K5 (``overlap.cu``): ``kernels._overlap_smem_bytes`` at the deepest
      ring ``_overlap_depth`` allows (its slots capped at
      ``_OVERLAP_MAX_SLOTS``), Q = 8 and the widest packed operand.
    * K1 (``ingest.cu``): ``2 * n_bins * 4`` bytes a warp (one stream's
      two histograms), ``kMaxWarps`` warps a block at most; the wrapper
      refuses widths whose one warp would not fit, so the report gives
      the widest ``n_bins`` it admits and the block at 512 and 2048 bins.
    * K2 (``quantile.cu``): its ring is sized in C; read at 512 and 2048
      bins through ``sk_quantile_shape`` where the library is built and a
      card answers, else reported as not measured.

    ``csrc_limits`` holds each source's ``kSmemLimit``; they must equal
    ``kernels.py``'s.  ``ok`` is False on any breach or mismatch.
    """
    budget = SMEM_BUDGET_BYTES
    lo = kernels.LO
    depth = kernels._overlap_depth(8, 8)
    pk_width = ((4 * _Q_MAX + 5 + 7) // 8) * 8  # thr, tile, zero, nan per q; 5 scalars
    overlap_bytes = kernels._overlap_smem_bytes(depth, _Q_MAX, pk_width)
    max_warps = _csrc_constant("ingest.cu", "kMaxWarps") or 0

    def ingest_block(n_bins: int) -> int:
        row = 2 * n_bins * 4
        return min(max_warps, budget // row) * row

    widest = (budget // 8) // lo * lo
    limits = {
        src: _csrc_constant(src, "kSmemLimit")
        for src in ("ingest.cu", "quantile.cu", "overlap.cu")
    }
    quantile: Dict = {"measured": False}
    if _build.library_path("quantile.cu").is_file():
        try:
            quantile = {"measured": True, **{
                f"bytes_{nb}": _quantile_smem(nb) for nb in (512, 2048)
            }}
        except (EngineUnavailable, OSError) as e:
            quantile["reason"] = str(e)
    else:
        quantile["reason"] = "quantile.cu is not built"
    pins = {
        "overlap_worst": overlap_bytes,
        "ingest_512": ingest_block(512),
        "ingest_2048": ingest_block(2048),
        "ingest_widest": ingest_block(widest),
    }
    if quantile["measured"]:
        pins.update(quantile_512=quantile["bytes_512"], quantile_2048=quantile["bytes_2048"])
    ok = (
        max_warps > 0
        and all(v <= budget for v in pins.values())
        and all(v == budget for v in limits.values())
    )
    return {
        "budget_bytes": budget,
        "csrc_limits": limits,
        "overlap": {
            "ring_depth": depth,
            "ring_slots": min(depth, kernels._OVERLAP_MAX_SLOTS),
            "rows": kernels._OVERLAP_ROWS,
            "q_max": _Q_MAX,
            "packed_width": pk_width,
            "bytes": overlap_bytes,
        },
        "ingest": {
            "bytes_per_warp": "2 * n_bins * 4",
            "max_warps": max_warps,
            "widest_n_bins": widest,
            "bytes_512": pins["ingest_512"],
            "bytes_2048": pins["ingest_2048"],
        },
        "quantile": quantile,
        "pins": pins,
        "ok": ok,
    }


def _smem_findings(report: Dict) -> List[Finding]:
    out: List[Finding] = []
    budget = report["budget_bytes"]
    for name, value in sorted(report["pins"].items()):
        if value > budget:
            out.append(_finding(
                "smem-budget", f"<smem:{name}>",
                f"{name}: {value} bytes of shared memory a block against the"
                f" {budget} bytes one H100 block may use",
            ))
    for src, value in sorted(report["csrc_limits"].items()):
        if value != budget:
            out.append(_finding(
                "smem-budget", f"<smem:{src}>",
                f"csrc/{src} kSmemLimit is {value}, kernels.py's limit {budget}",
            ))
    if report["ingest"]["max_warps"] <= 0:
        out.append(_finding("smem-budget", "<smem:ingest.cu>",
                            "csrc/ingest.cu declares no kMaxWarps"))
    return out


# ---------------------------------------------------------------------------
# Pinned budgets (analysis/budgets.json)
# ---------------------------------------------------------------------------


def measure_budgets(entries: Optional[List[Tuple[str, Path]]] = None) -> Dict:
    """Build what is missing, take the census of every library and the
    shared-memory report -> a budgets document.  Raises
    ``EngineUnavailable`` naming the findings when the census is
    incomplete (no toolchain, no card for K2's ring, a tool failure):
    a partial document is never pinned."""
    doc, findings, _ = _measure(entries)
    broken = [f for f in findings if f.rule == "kernel-build"]
    if broken:
        raise EngineUnavailable(
            "the kernel census is incomplete: " + "; ".join(f.message for f in broken)
        )
    return doc


def _measure(
    entries: Optional[List[Tuple[str, Path]]],
) -> Tuple[Dict, List[Finding], Dict]:
    findings: List[Finding] = []
    if entries is None:
        entries = default_entry_points()
        try:
            _build.build()
        except EngineUnavailable as e:
            findings.append(_finding("kernel-build", "<kernel:build>", str(e)[:500]))
    measured: Dict[str, Dict] = {}
    for source, lib in entries:
        got, found = census(source, lib)
        measured.update(got)
        findings.extend(found)
    smem = smem_report()
    if not smem["quantile"]["measured"]:
        findings.append(_finding(
            "kernel-build", "<smem:quantile.cu>",
            f"K2's ring was not measured: {smem['quantile']['reason']}",
        ))
    doc = {
        "version": 1,
        "tolerance_pct": BUDGET_TOLERANCE_PCT,
        "nvcc": nvcc_release(),
        "entries": measured,
        "smem_bytes": smem["pins"],
    }
    return doc, findings + _smem_findings(smem), smem


def load_budgets(path: str) -> Optional[Dict]:
    """The checked-in budgets document (None when absent)."""
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def write_budgets(path: str, doc: Dict) -> None:
    """Write a budgets document (``--update-budgets``)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


_CEILINGS = (
    ("registers", "kernel-budget", "registers"),
    ("shared", "kernel-budget", "bytes of static shared memory"),
    ("stack", "kernel-spill", "bytes of stack frame"),
    ("local", "kernel-spill", "bytes of local memory"),
    ("spill_stores", "kernel-spill", "bytes of spill stores"),
    ("spill_loads", "kernel-spill", "bytes of spill loads"),
)


def _unmatched(kind: str, b: Dict, m: Dict) -> List[Finding]:
    out = [
        _finding("kernel-budget", _BUDGET_PATH,
                 f"{kind} {name} has no pin; every one is pinned (--update-budgets on the card)")
        for name in sorted(set(m) - set(b))
    ]
    out += [
        _finding("kernel-budget", _BUDGET_PATH,
                 f"pinned {kind} {name} matches nothing measured -- stale pin (--update-budgets)")
        for name in sorted(set(b) - set(m))
    ]
    return out


def check_budgets(budgets: Optional[Dict], measured: Dict) -> List[Finding]:
    """Gate the measured census against the checked-in budgets.

    Pins are *ceilings* (an entry may get cheaper silently), apart from
    ``ffma``, which must match exactly: costing more than a pin (beyond
    ``tolerance_pct`` for SASS counts), an unpinned entry, a stale pin or
    a changed ``FFMA`` count each fail, naming ``--update-budgets`` as the
    reviewed way out.
    """
    if budgets is None:
        return [_finding(
            "kernel-budget", _BUDGET_PATH,
            "no budgets file is checked in; run `python -m sketches_tpu_torch.analysis"
            " --update-budgets` on the card and commit analysis/budgets.json",
        )]
    tol = 1.0 + float(budgets.get("tolerance_pct", BUDGET_TOLERANCE_PCT)) / 100.0
    b_entries, m_entries = budgets.get("entries", {}), measured.get("entries", {})
    findings = _unmatched("kernel entry", b_entries, m_entries)
    for name in sorted(set(b_entries) & set(m_entries)):
        b, m = b_entries[name], m_entries[name]
        for field, rule_id, what in _CEILINGS:
            if m.get(field, 0) > b.get(field, 0):
                findings.append(_finding(
                    rule_id, _BUDGET_PATH,
                    f"{name}: {m[field]} {what} against the pinned {b.get(field, 0)}",
                ))
        if m["sass"] > b.get("sass", 0) * tol:
            findings.append(_finding(
                "kernel-budget", _BUDGET_PATH,
                f"{name}: {m['sass']} SASS instructions exceeds the pinned"
                f" {b.get('sass', 0)} by more than {tol * 100 - 100:g}% -- fix the"
                " kernel or justify it via --update-budgets in review",
            ))
        if m["ffma"] != b.get("ffma"):
            findings.append(_finding(
                "kernel-budget", _BUDGET_PATH,
                f"{name}: {m['ffma']} FFMA instructions against the pinned"
                f" {b.get('ffma')} -- contraction changed (is -fmad=false still set?)",
            ))
    b_smem, m_smem = budgets.get("smem_bytes", {}), measured.get("smem_bytes", {})
    findings += _unmatched("shared-memory size", b_smem, m_smem)
    for name in sorted(set(b_smem) & set(m_smem)):
        if m_smem[name] > b_smem[name]:
            findings.append(_finding(
                "kernel-budget", _BUDGET_PATH,
                f"shared memory {name} grew to {m_smem[name]} bytes against the"
                f" pinned {b_smem[name]}",
            ))
    return findings


def audit(
    entries: Optional[List[Tuple[str, Path]]] = None,
    budgets_path: Optional[str] = None,
) -> Tuple[List[Finding], Dict]:
    """Run the full layer-2 audit -> (findings, machine-readable report).

    ``entries`` defaults to :func:`default_entry_points`, built first
    where missing.  With ``budgets_path`` the census is gated against the
    checked-in budgets (``kernel-budget`` / ``kernel-spill``), once the
    census is complete; an incomplete one is ``kernel-build``, and its
    pins are not compared (each would read as stale).
    """
    measured, findings, smem = _measure(entries)
    report: Dict = {
        "nvcc": measured["nvcc"],
        "entries": measured["entries"],
        "smem": smem,
        "budgets": None,
    }
    complete = not any(f.rule == "kernel-build" for f in findings)
    if budgets_path is not None:
        budgets = load_budgets(budgets_path)
        budget_findings = check_budgets(budgets, measured) if complete else []
        findings.extend(budget_findings)
        report["budgets"] = {
            "path": budgets_path,
            "checked": budgets is not None and complete,
            "pinned_nvcc": (budgets or {}).get("nvcc"),
            "findings": [f.to_dict() for f in budget_findings],
            "ok": complete and not budget_findings,
        }
    report["findings"] = [f.to_dict() for f in findings]
    return findings, report

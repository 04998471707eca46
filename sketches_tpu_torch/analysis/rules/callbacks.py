"""Rule ``host-sync``: no device-to-host sync in the kernels' wrappers and
the batched core (counterpart of the JAX package's ``host-callback``,
``sketches_tpu/analysis/rules/callbacks.py``).

The JAX rule forbids ``pure_callback`` / ``io_callback`` /
``host_callback``, names that match nothing in torch.  The hazard it
guards is the same in the port: a hot path that waits for the device
and copies to the host on every call, which serialises the launch queue
and caps throughput at the host round trip.  In torch that is
``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` or
``torch.cuda.synchronize``.  They are flagged inside the functions the
JAX package's lowering audit traces
(``sketches_tpu/analysis/jaxpr_audit.py:default_entry_points``):
``batched.add``, ``merge`` and ``quantile``, and ``kernels``'
``ingest_histogram``, ``add``, ``fused_quantile``, ``floor_quantile``,
``fused_quantile_windowed``, ``quantile_windowed_xla``,
``fused_quantile_tiles`` and ``fused_quantile_tiles_overlap``.

Out of scope by design: the planners (``plan_state_window``,
``plan_tile_query``), which fetch from the host once per state change and
are cached; the facades; and host-tier modules, whose values live on the
host.  A scalar test such as ``bool(t.any())`` also syncs, but is not a
fetch by name and is not flagged.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from sketches_tpu_torch.analysis.lint import Finding, LintContext, rule

#: Package-relative file -> the hot functions in it.
HOT_FUNCTIONS = {
    "batched.py": ("add", "merge", "quantile"),
    "kernels.py": (
        "ingest_histogram",
        "add",
        "fused_quantile",
        "floor_quantile",
        "fused_quantile_windowed",
        "quantile_windowed_xla",
        "fused_quantile_tiles",
        "fused_quantile_tiles_overlap",
    ),
}

_FETCHES = ("item", "tolist", "cpu", "numpy")


def _sync_name(node: ast.Call) -> str:
    """The flagged call's name ('' if it is not a host sync)."""
    fn = node.func
    if not isinstance(fn, ast.Attribute):
        return ""
    if fn.attr in _FETCHES:
        return f".{fn.attr}()"
    base = fn.value
    if (
        fn.attr == "synchronize"
        and isinstance(base, ast.Attribute)
        and base.attr == "cuda"
        and isinstance(base.value, ast.Name)
        and base.value.id == "torch"
    ):
        return "torch.cuda.synchronize()"
    return ""


@rule("host-sync")
def check(ctx: LintContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for in_pkg, names in HOT_FUNCTIONS.items():
        sf = ctx.file_in_package(in_pkg)
        if sf is None or sf.tree is None:
            continue
        module = in_pkg[: -len(".py")]
        for fn in sf.tree.body:
            if not (isinstance(fn, ast.FunctionDef) and fn.name in names):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = _sync_name(node)
                if name:
                    out.append(
                        Finding(
                            "host-sync",
                            sf.path,
                            node.lineno,
                            f"{name} in {module}.{fn.name}: a device-to-host"
                            " sync on a hot path waits for the card on every"
                            " call; keep the value on the device",
                        )
                    )
    return out

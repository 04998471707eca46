"""The port's public surface against the JAX package's, module for module.

Every module of ``sketches_tpu`` has a port file (under the same name, or
under the one ``MODULE_RENAMES`` gives), and the port module's ``__all__``
must equal the JAX module's, apart from two explicit lists: the deliberate
renames and the port-only additions.  The package roots are compared the
same way; any other difference fails.  ``pyproject.toml`` lists every
package of the port, so an installed port imports whole.
"""

import importlib
import os
import pkgutil
import tomllib

import pytest

import sketches_tpu
import sketches_tpu_torch
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

#: Deliberate renames, JAX name -> port name, by module ("" is the root).
#: The JAX package's device-tier scalar sketch is named for its backend;
#: the port's is too.
RENAMES = {
    "": {"JaxDDSketch": "TorchDDSketch"},
    "ddsketch": {"JaxDDSketch": "TorchDDSketch"},
    # Layer 2 of the analyzer is a census of the built CUDA kernels, not a
    # jaxpr audit: shared memory for VMEM, the census of one library for a
    # traced callable, SASS counts for element ops, and the f64 and FFMA
    # opcode classes for the primitive classes the JAX census counts.
    "analysis": {"jaxpr_audit": "kernel_audit"},
    "analysis.kernel_audit": {
        "VMEM_BUDGET_BYTES": "SMEM_BUDGET_BYTES",
        "vmem_report": "smem_report",
        "audit_callable": "census",
        "elem_ops_per_value": "parse_sass",
        "ELEMENTWISE_PRIMS": "FFMA_OPCODES",
        "COLLECTIVE_PRIMS": "F64_OPCODES",
    },
}

#: Deliberate module renames, JAX module -> port module.  The port's
#: analyzer audits what nvcc built, not a jaxpr.
MODULE_RENAMES = {"analysis.jaxpr_audit": "analysis.kernel_audit"}

#: Names the port exports where the JAX module does not, by module.
PORT_ADDITIONS = {
    # The root also re-exports the accuracy backends' facades, the mesh,
    # the mapping factory, and the modules a port user reaches for first.
    "": {"AdaptiveDDSketch", "MomentDDSketch", "SketchMesh", "mapping_from_name", "analysis",
         "checkpoint", "convert", "kernels", "native", "parallel", "pb"},
    # The moment state's leaf names (the JAX package reads its NamedTuple).
    "backends.moment": {"FIELDS"},
    # The kill switch's name and reader, and the merge and premap helpers
    # the JAX package keeps private.
    "backends.uniform": {"ADAPTIVE_ENV", "adaptive_enabled", "align_for_merge", "clamp_fraction",
                         "level_auto_offset"},
    # The leaf list (a pytree in JAX), the exact f32 prefix sum every plain
    # rank walk takes, host helpers and the host-sketch bridge.
    "batched": {"LEAVES", "arrays_to_state", "cumsum_f32", "data_center_offsets",
                "from_host_sketches", "occupied_bounds_np", "tile_sums_np", "tile_sums_of",
                "to_host_sketches"},
    # The fault sites whose injection is atomic.
    "faults": {"ATOMIC_SITES"},
    # The moment backend's merge check.
    "integrity": {"verify_moment_merge"},
    # Each CUDA kernel's plain PyTorch version, the launch counters, the
    # `xla` floor's router, the switches' names and the window planners.
    "kernels": {"OVERLAP_ENV", "INGEST_PACKED_ENV", "floor_quantile", "fused_quantile_plain",
                "fused_quantile_windowed_plain", "fused_quantile_tiles_plain",
                "fused_quantile_tiles_overlap_plain", "ingest_histogram_plain", "launch_counts",
                "reset_launch_counts", "overlap_enabled", "plan_window", "plan_state_window",
                "window_stats"},
    # The zero-bucket threshold both packages apply before keying.
    "mapping": {"zero_threshold"},
    # Where the native library is built and why it is or is not loaded.
    "native": {"library_path", "status"},
    # The protobuf classes, imported on first use.
    "pb.proto": {"messages"},
    # The ladder step and the "may this error step down" test.
    "resilience": {"demote_query", "survivable"},
}

#: Port modules the JAX package lacks: the numpy/torch state conversion,
#: the CUDA build, and the examples kept inside the package (the JAX
#: package keeps them at the repo root).
PORT_ONLY_MODULES = {"_build", "convert", "examples"}

def _modules(pkg) -> dict:
    return {
        m.name[len(pkg.__name__) + 1 :]: m.name
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
    }


JAX_MODULES = _modules(sketches_tpu)
PORT_MODULES = _modules(sketches_tpu_torch)


def test_every_module_has_a_port_or_is_listed():
    missing = {m for m in JAX_MODULES if MODULE_RENAMES.get(m, m) not in PORT_MODULES}
    assert not missing, sorted(missing)
    renamed = set(MODULE_RENAMES.values())
    extra = {m for m in PORT_MODULES if m not in JAX_MODULES and m not in renamed}
    assert extra == {m for m in extra if m.split(".")[0] in PORT_ONLY_MODULES}
    # Every listed rename is still in use.
    assert set(MODULE_RENAMES) <= set(JAX_MODULES) and renamed <= set(PORT_MODULES)


@pytest.mark.parametrize(
    "name", [""] + sorted(JAX_MODULES), ids=lambda n: n or "root"
)
def test_module_all_matches_jax(name):
    jmod = importlib.import_module("sketches_tpu" + ("." + name if name else ""))
    name = MODULE_RENAMES.get(name, name)
    tmod = importlib.import_module("sketches_tpu_torch" + ("." + name if name else ""))
    jall, tall = getattr(jmod, "__all__", None), getattr(tmod, "__all__", None)
    if jall is None:
        assert tall is None, f"{name}: the JAX module has no __all__"
        return
    renames = RENAMES.get(name, {})
    want = {renames.get(n, n) for n in jall}
    got = set(tall) - PORT_ADDITIONS.get(name, set())
    assert got == want, (
        f"{name or 'root'}: the port lacks {sorted(want - got)}, adds {sorted(got - want)}"
    )
    assert len(tall) == len(set(tall)), f"{name}: repeated names"
    for n in tall:
        assert hasattr(tmod, n), f"{name}: __all__ names {n!r}, which the module lacks"
    # Every listed addition and rename is still in use.
    assert PORT_ADDITIONS.get(name, set()) <= set(tall)
    assert set(renames.values()) <= set(tall)


def test_root_exports_the_stores_shard_loss_report_and_version():
    from sketches_tpu_torch import resilience, store

    for n in ("Store", "DenseStore", "CollapsingLowestDenseStore", "CollapsingHighestDenseStore"):
        assert getattr(sketches_tpu_torch, n) is getattr(store, n)
        assert n in sketches_tpu_torch.__all__
    assert sketches_tpu_torch.ShardLossReport is resilience.ShardLossReport
    assert sketches_tpu_torch.__version__ == sketches_tpu.__version__
    assert issubclass(sketches_tpu_torch.CollapsingLowestDenseStore, sketches_tpu_torch.Store)


def test_kernels_name_the_packed_ingest_switch():
    from sketches_tpu import kernels as jk
    from sketches_tpu_torch import kernels as tk
    from sketches_tpu_torch.analysis import registry

    assert tk.INGEST_PACKED_ENV == jk.INGEST_PACKED_ENV == "SKETCHES_TPU_INGEST_PACKED"
    assert tk.INGEST_PACKED_ENV == registry.INGEST_PACKED.name


def test_parallel_exports_make_global_mesh():
    from sketches_tpu_torch import parallel

    assert "make_global_mesh" in parallel.__all__ and callable(parallel.make_global_mesh)


def test_pyproject_lists_every_package_of_the_port():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        tool = tomllib.load(f)["tool"]["setuptools"]
    listed = set(tool["packages"])
    pkg_dir = os.path.join(root, "sketches_tpu_torch")
    packages = {
        os.path.relpath(dirpath, root).replace(os.sep, ".")
        for dirpath, _, files in os.walk(pkg_dir)
        if "__init__.py" in files
    }
    assert packages <= listed, sorted(packages - listed)
    assert {p for p in listed if p.startswith("sketches_tpu_torch")} == packages
    # The analyzer's pinned budgets and empty baseline ship with it.
    assert "analysis/*.json" in tool["package-data"]["sketches_tpu_torch"]

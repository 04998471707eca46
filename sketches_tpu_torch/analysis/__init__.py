"""sketchlint for the PyTorch port (counterpart of ``sketches_tpu.analysis``).

Two layers, one CLI (``python -m sketches_tpu_torch.analysis``, non-zero
exit on violations):

* **Layer 1 -- AST lint** (:mod:`~sketches_tpu_torch.analysis.lint` +
  ``analysis/rules/``): the JAX package's rule engine and rules over the
  port's tree -- the ``SketchError`` taxonomy, the kill-switch registry,
  the engine fallback ladder, deterministic hot paths, failure-mode
  docstrings, lock discipline and torn-write seams -- with two rules
  retargeted to torch: ``torch-f64`` (the f32 device tier) and
  ``host-sync`` (no device-to-host sync in the kernels' wrappers).
* **Layer 2 -- kernel census**
  (:mod:`~sketches_tpu_torch.analysis.kernel_audit`, the counterpart of
  the JAX ``jaxpr_audit``): what ``nvcc`` built for ``sm_90a`` --
  registers, shared memory, spills, SASS, f64 and FFMA counts of every
  kernel entry, pinned in ``analysis/budgets.json`` -- and the kernels'
  worst-case shared memory against what one H100 block may use.

This package also hosts the **kill-switch registry**
(:mod:`~sketches_tpu_torch.analysis.registry`): the single declared
inventory of ``SKETCHES_TPU_*`` environment variables, which the
production modules read.  ``registry`` is therefore imported eagerly (it
is stdlib-only and cycle-free); the analyzer layers load lazily so
importing ``sketches_tpu_torch`` never pays for them.

Module-level failure story: the registry refuses undeclared variable
names with ``KeyError``; the analyzer layers never raise on findings --
violations are *returned* (and exit-coded by the CLI), and even a syntax
error in a scanned file or a missing CUDA toolchain becomes a finding
rather than an exception.
"""

from sketches_tpu_torch.analysis import registry

__all__ = ["registry", "lint", "kernel_audit"]


def __getattr__(name):
    # Lazy layer loading: `analysis.lint` / `analysis.kernel_audit` import
    # on first attribute access, so `import sketches_tpu_torch` (which
    # pulls this package for the registry) stays free of analyzer weight.
    if name in ("lint", "kernel_audit"):
        import importlib

        return importlib.import_module(f"sketches_tpu_torch.analysis.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""sketchlint rules of the PyTorch port: each module encodes one repo
invariant (counterpart of ``sketches_tpu/analysis/rules/``; the same
nine files and rule ids, two of them retargeted to torch).

Importing this package registers every rule with the engine
(``lint.rule`` decorator); ``lint.all_rules()`` triggers the import.

Rule inventory (ids double as the inline-ignore tags):

==================  ======================================================
id                  invariant
==================  ======================================================
taxonomy-raise      no bare ``ValueError``/``RuntimeError`` raises outside
                    ``resilience.py`` -- everything derives from
                    ``SketchError``
env-read            ``os.environ``/``os.getenv`` reads only inside
                    ``analysis/registry.py``
env-literal         every ``SKETCHES_TPU_*`` string literal outside the
                    registry must be a *declared* variable's name
registry-doc        registry entries and the README kill-switch table
                    agree in both directions
engine-ladder       every engine ``choose_query_engine`` can return is a
                    rung of ``resilience.QUERY_LADDER``, demotable by
                    ``demote_query_tier``, and fault-dispatched in both
                    facades
torch-f64           no ``float64`` construction on a tensor that stays on
                    the device (f32 device tier; the JAX ``jnp-f64``)
determinism         no ``time.time``-family wall-clock reads or unseeded
                    ``np.random`` in library code (``telemetry.py`` is the
                    one carved-out clock boundary)
failure-docstring   every public ``__all__`` symbol documents its failure
                    modes
host-sync           no ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/
                    ``torch.cuda.synchronize`` in the batched core and the
                    kernels' wrappers (the JAX ``host-callback``)
telemetry-names     every telemetry metric/span name in the package is a
                    string literal declared in ``telemetry.py``'s
                    ``Metric`` inventory (no stringly-typed drift)
lock-discipline     attributes accessed under a class's instance lock are
                    accessed under it *everywhere* (whole-class inference,
                    ``analysis/concurrency.py``)
lock-escape         lock-guarded objects never leak raw out of the lock
                    region (returned or stored onto a foreign object)
seam-premutation    methods passing a torn ``faults.ATOMIC_SITES`` site
                    mutate no ``self`` state before the seam
                    (``analysis/seams.py``)
seam-commit         the first post-seam ``self`` mutation is a single
                    reference swap, not an in-place edit
seam-sites          ``ATOMIC_SITES`` is a subset of ``SITES`` and every
                    ``*_TORN`` inject site is declared atomic
site-detector       every ``faults.SITES`` member has a ``DETECTORS``
                    (or ``NO_SEAM``) entry in
                    ``tests/test_torch_integrity.py`` (and no stale keys)
metric-doc          every declared ``Metric`` has a backticked README row
campaign-ci         every chaos ``--campaign`` choice is run by
                    ``chip_smoke.py``'s ``CHAOS_CALLS``
==================  ======================================================
"""

from sketches_tpu_torch.analysis import (  # noqa: F401  (import = register)
    concurrency,
    seams,
)
from sketches_tpu_torch.analysis.rules import (  # noqa: F401  (import = register)
    callbacks,
    closure,
    determinism,
    docstrings,
    dtypes,
    engines,
    env_registry,
    raises,
    telemetry_names,
)

__all__ = [
    "callbacks",
    "closure",
    "concurrency",
    "determinism",
    "docstrings",
    "dtypes",
    "engines",
    "env_registry",
    "raises",
    "seams",
    "telemetry_names",
]

"""Accuracy backends behind the ``SketchSpec.backend`` seam (PyTorch port).

Counterpart of ``sketches_tpu/backends/__init__.py``.  ``spec.backend``
picks one of three contracts per facade:

* ``"dense"``: the classic bin store (``sketches_tpu_torch.batched``);
* ``"uniform_collapse"``: UDDSketch-style graceful degradation
  (:mod:`sketches_tpu_torch.backends.uniform`, ``AdaptiveDDSketch``): a
  stream whose edge-clamped mass crosses ``spec.collapse_threshold`` merges
  adjacent bin pairs (gamma -> gamma**2) instead of corrupting its tails;
* ``"moment"``: a compact moment summary
  (:mod:`sketches_tpu_torch.backends.moment`, ``MomentDDSketch``):
  ``(6 + 2 * n_moments)`` f32 scalars per stream, quantiles from a
  maximum-entropy solve on the host.

``backends.wirefmt`` carries both non-dense states in the JAX package's
``SketchPayload`` envelope, byte for byte.

Failure modes: :func:`facade_for` raises ``SpecError`` for an unknown
backend or a ``backend=`` that contradicts ``spec.backend``; a uniform
collapse with ``SKETCHES_TPU_ADAPTIVE=0`` raises ``SpecError``.
"""

from __future__ import annotations

from sketches_tpu_torch.resilience import SpecError

__all__ = [
    "BACKEND_DENSE",
    "BACKEND_UNIFORM_COLLAPSE",
    "BACKEND_MOMENT",
    "BACKEND_WINDOWED",
    "BACKEND_ENUM",
    "BACKEND_NAMES",
    "facade_for",
]

#: Wire-enum values of ``SketchPayload.backend`` (the JAX package's table,
#: kept here as a copy: the port imports nothing of that package).
#: Append-only; ``BACKEND_WINDOWED`` is an envelope-only kind (a whole ring
#: of bucket sketches), not a ``SketchSpec.backend`` value.
BACKEND_DENSE = 0
BACKEND_UNIFORM_COLLAPSE = 1
BACKEND_MOMENT = 2
BACKEND_WINDOWED = 3

#: backend name -> wire enum value.
BACKEND_ENUM = {
    "dense": BACKEND_DENSE,
    "uniform_collapse": BACKEND_UNIFORM_COLLAPSE,
    "moment": BACKEND_MOMENT,
    "windowed": BACKEND_WINDOWED,
}

#: wire enum value -> backend name.
BACKEND_NAMES = {v: k for k, v in BACKEND_ENUM.items()}


def facade_for(n_streams: int, **kwargs):
    """The facade matching ``kwargs``' spec or ``backend=`` keyword:
    ``BatchedDDSketch`` (dense), ``AdaptiveDDSketch`` (uniform_collapse) or
    ``MomentDDSketch`` (moment); every other keyword (``device`` included)
    passes through.  Raises ``SpecError`` for an unknown backend name or a
    ``backend=`` that contradicts ``spec.backend``."""
    spec = kwargs.get("spec")
    backend = kwargs.pop("backend", None)
    if backend is None:
        backend = getattr(spec, "backend", "dense")
    elif spec is not None and spec.backend != backend:
        raise SpecError(
            f"backend={backend!r} contradicts spec.backend={spec.backend!r}"
        )
    if backend == "uniform_collapse":
        from sketches_tpu_torch.backends.uniform import AdaptiveDDSketch

        return AdaptiveDDSketch(n_streams, **kwargs)
    if backend == "moment":
        from sketches_tpu_torch.backends.moment import MomentDDSketch

        return MomentDDSketch(n_streams, **kwargs)
    if backend != "dense":
        raise SpecError(f"Unknown backend {backend!r}")
    from sketches_tpu_torch.batched import BatchedDDSketch

    return BatchedDDSketch(n_streams, **kwargs)

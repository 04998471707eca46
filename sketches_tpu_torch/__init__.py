"""sketches_tpu_torch: the batched DDSketch device tier on PyTorch and CUDA.

A port of ``sketches_tpu``'s ``BatchedDDSketch`` and ``DistributedDDSketch``
to NVIDIA Hopper cards: the same ``SketchSpec``/``SketchState`` contract,
the same mappings, and the same query routing, with the TPU's Pallas
kernels replaced by hand-written CUDA kernels (``csrc/``) that are built
with ``nvcc`` at first use.  Entry points run on the card unless the caller
passes ``device="cpu"``, where every kernel runs its plain PyTorch version.

This package imports torch and numpy only; it never imports JAX or the
``sketches_tpu`` package.
"""

from sketches_tpu_torch import convert, kernels, parallel
from sketches_tpu_torch.batched import BatchedDDSketch, SketchSpec, SketchState
from sketches_tpu_torch.mapping import (
    CubicallyInterpolatedMapping,
    KeyMapping,
    LinearlyInterpolatedMapping,
    LogarithmicMapping,
    QuadraticallyInterpolatedMapping,
    mapping_from_name,
)
from sketches_tpu_torch.parallel import DistributedDDSketch, SketchMesh
from sketches_tpu_torch.resilience import (
    EngineUnavailable,
    ShardLossError,
    SketchError,
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
)

__all__ = [
    "BatchedDDSketch",
    "DistributedDDSketch",
    "SketchMesh",
    "SketchSpec",
    "SketchState",
    "KeyMapping",
    "LogarithmicMapping",
    "LinearlyInterpolatedMapping",
    "QuadraticallyInterpolatedMapping",
    "CubicallyInterpolatedMapping",
    "mapping_from_name",
    "SketchError",
    "SketchValueError",
    "SpecError",
    "UnequalSketchParametersError",
    "EngineUnavailable",
    "ShardLossError",
    "convert",
    "kernels",
    "parallel",
]

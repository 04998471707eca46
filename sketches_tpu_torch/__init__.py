"""sketches_tpu_torch: the batched DDSketch device tier on PyTorch and CUDA.

A port of ``sketches_tpu``'s ``BatchedDDSketch`` and ``DistributedDDSketch``
to NVIDIA Hopper cards: the same ``SketchSpec``/``SketchState`` contract,
the same mappings, and the same query routing, with the TPU's Pallas
kernels replaced by hand-written CUDA kernels (``csrc/``) that are built
with ``nvcc`` at first use.  Entry points run on the card unless the caller
passes ``device="cpu"``, where every kernel runs its plain PyTorch version.

The host tier comes with it: the reference-shaped ``DDSketch`` presets
(``backend="torch"`` puts one on the device tier), the native C++ engine
(``native``, built with ``g++`` at first use), the protobuf wire format
(``pb``) and checkpoints (``checkpoint``), each byte- and bit-compatible
with the JAX package's.  The accuracy backends (``backends``) put the
uniform-collapse ``AdaptiveDDSketch`` and the moment-summary
``MomentDDSketch`` on the same seams, with the JAX package's
``SketchPayload`` wire envelope.

The robustness layer is the JAX package's too: the kill-switch registry
(``analysis.registry``), the health ledger and demotion ladder
(``resilience``), deterministic fault injection (``faults``) and
self-verifying state with fingerprints bit-equal to the JAX package's
(``integrity``), all off by default and armed by the same environment
switches.  So is the observability layer: self-sketching telemetry
(``telemetry``), request tracing and the flight recorder (``tracing``),
device-clocked profiling (``profiling``) and the accuracy shadow audit
(``accuracy``), wired into the same seams.

This package imports torch and numpy only; it never imports JAX or the
``sketches_tpu`` package, and protobuf only on the wire paths that need
message objects.
"""

from sketches_tpu_torch import (
    accuracy,
    analysis,
    backends,
    checkpoint,
    convert,
    faults,
    integrity,
    kernels,
    native,
    parallel,
    pb,
    profiling,
    resilience,
    telemetry,
    tracing,
)
from sketches_tpu_torch.backends.moment import MomentDDSketch
from sketches_tpu_torch.backends.uniform import AdaptiveDDSketch
from sketches_tpu_torch.batched import BatchedDDSketch, SketchSpec, SketchState
from sketches_tpu_torch.ddsketch import (
    BaseDDSketch,
    DDSketch,
    LogCollapsingHighestDenseDDSketch,
    LogCollapsingLowestDenseDDSketch,
    TorchDDSketch,
)
from sketches_tpu_torch.integrity import IntegrityReport
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
    BlobTooLarge,
    CheckpointCorrupt,
    DeadlineExceeded,
    EngineUnavailable,
    FabricUnavailable,
    InjectedFault,
    IntegrityError,
    QuarantineReport,
    ReplicaStale,
    ServeOverload,
    ShardLossError,
    SketchError,
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
    WireDecodeError,
)

__all__ = [
    "BaseDDSketch",
    "DDSketch",
    "TorchDDSketch",
    "LogCollapsingLowestDenseDDSketch",
    "LogCollapsingHighestDenseDDSketch",
    "BatchedDDSketch",
    "AdaptiveDDSketch",
    "MomentDDSketch",
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
    "WireDecodeError",
    "BlobTooLarge",
    "CheckpointCorrupt",
    "IntegrityError",
    "InjectedFault",
    "ServeOverload",
    "DeadlineExceeded",
    "ReplicaStale",
    "FabricUnavailable",
    "QuarantineReport",
    "IntegrityReport",
    "accuracy",
    "analysis",
    "backends",
    "checkpoint",
    "convert",
    "faults",
    "integrity",
    "kernels",
    "native",
    "parallel",
    "pb",
    "profiling",
    "resilience",
    "telemetry",
    "tracing",
]

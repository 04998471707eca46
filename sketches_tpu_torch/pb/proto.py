"""Bridge between sketch objects and the DDSketch protobuf wire format.

Counterpart of ``sketches_tpu/pb/proto.py`` (parity target: reference
``ddsketch/pb/proto.py``): the interpolation enum maps to the mapping
subclass, dense store runs map to ``contiguousBinCounts`` + offset.
``batched_to_bytes`` / ``batched_from_bytes`` (and their message
counterparts) carry every stream of a ``[n_streams, n_bins]`` batch through
``pb.wire``'s vectorized codec.

The message classes come from ``ddsketch_pb2``, imported on first use
(:func:`messages`): without protobuf, this module still imports and the
bytes functions still work, while the message paths raise
``EngineUnavailable``.
"""

from __future__ import annotations

from typing import List

from sketches_tpu_torch.ddsketch import BaseDDSketch, DDSketch
from sketches_tpu_torch.mapping import (
    CubicallyInterpolatedMapping,
    KeyMapping,
    LinearlyInterpolatedMapping,
    LogarithmicMapping,
    QuadraticallyInterpolatedMapping,
)
from sketches_tpu_torch.resilience import (
    EngineUnavailable,
    SketchValueError,
    SpecError,
    WireDecodeError,
)
from sketches_tpu_torch.store import DenseStore, Store

__all__ = [
    "KeyMappingProto",
    "StoreProto",
    "DDSketchProto",
    "messages",
    "batched_to_proto",
    "batched_from_proto",
    "batched_to_bytes",
    "batched_from_bytes",
]

# ``IndexMapping.Interpolation`` values (ddsketch.proto): NONE, LINEAR,
# QUADRATIC, CUBIC.  Plain ints, so the wire encoder needs no protobuf.
_INTERPOLATION_TO_MAPPING = {
    0: LogarithmicMapping,
    1: LinearlyInterpolatedMapping,
    2: QuadraticallyInterpolatedMapping,
    3: CubicallyInterpolatedMapping,
}
_MAPPING_TO_INTERPOLATION = {m: i for i, m in _INTERPOLATION_TO_MAPPING.items()}


def messages():
    """The generated ``ddsketch_pb2`` module; raises ``EngineUnavailable``
    when protobuf is not installed."""
    try:
        from sketches_tpu_torch.pb import ddsketch_pb2
    except ImportError as e:
        raise EngineUnavailable("protobuf is not installed") from e
    return ddsketch_pb2


def _non_dense(spec) -> bool:
    return getattr(spec, "backend", "dense") != "dense"


def _dense_messages_only(spec) -> None:
    if _non_dense(spec):
        raise SpecError(
            f"backend {spec.backend!r} ships as SketchPayload envelope bytes"
            " (batched_to_bytes / batched_from_bytes); DDSketch messages carry"
            " dense sketches only"
        )


class KeyMappingProto:
    """mapping <-> IndexMapping{gamma, indexOffset, interpolation}."""

    @classmethod
    def to_proto(cls, mapping: KeyMapping):
        try:
            interpolation = _MAPPING_TO_INTERPOLATION[type(mapping)]
        except KeyError:
            raise SketchValueError(
                f"No proto interpolation for mapping {type(mapping).__name__}"
            ) from None
        return messages().IndexMapping(
            gamma=mapping.gamma,
            indexOffset=mapping._offset,
            interpolation=interpolation,
        )

    @classmethod
    def from_proto(cls, proto, *, assume_native_linear: bool = False) -> KeyMapping:
        """Decode an IndexMapping.

        NONE (exact logarithmic), QUADRATIC and CUBIC decode
        unconditionally: their key functions are forced by the (gamma,
        interpolation) pair, so same-enum emitters agree on bucket
        boundaries.

        LINEAR raises by default: this implementation's linear mapping keeps
        the base 1/ln(gamma) multiplier unscaled, and whether other emitters
        share that convention is unverified; decoding foreign LINEAR bins
        with a mismatched key function would silently return wrong
        quantiles.  Pass ``assume_native_linear=True`` for bytes known to
        come from this library (or the JAX package) itself.
        """
        try:
            mapping_cls = _INTERPOLATION_TO_MAPPING[proto.interpolation]
        except KeyError:
            # proto3 open enums parse unknown values through: refuse,
            # naming the value, rather than decode under a guessed key
            # function.
            known = sorted(_INTERPOLATION_TO_MAPPING)
            raise WireDecodeError(
                "unknown IndexMapping.Interpolation enum value"
                f" {int(proto.interpolation)}: refusing to decode"
                f" (emitter is newer than this reader; known values"
                f" {known})"
            ) from None
        if mapping_cls is LinearlyInterpolatedMapping and not assume_native_linear:
            raise WireDecodeError(
                "Refusing to decode a LINEAR IndexMapping from foreign"
                " bytes: the linear-interpolation key-multiplier convention"
                " is implementation-defined and a mismatch silently"
                " misdecodes every bin.  If these bytes were produced by"
                " sketches_tpu itself, pass assume_native_linear=True."
                " (LOG and CUBIC interop are convention-free and decode"
                " unconditionally.)"
            )
        # Invert gamma = (1 + alpha) / (1 - alpha).
        relative_accuracy = (proto.gamma - 1.0) / (proto.gamma + 1.0)
        return mapping_cls(relative_accuracy, offset=proto.indexOffset)


class StoreProto:
    """store <-> Store{contiguousBinCounts, contiguousBinIndexOffset}.

    Encodes the dense run; decodes both the dense run and the sparse
    ``binCounts`` map (other languages may emit either).
    """

    @classmethod
    def to_proto(cls, store: Store):
        if not isinstance(store, DenseStore):
            raise TypeError(f"Cannot serialize {type(store).__name__}")
        return messages().Store(
            contiguousBinCounts=store.bins,
            contiguousBinIndexOffset=store.offset,
        )

    @classmethod
    def merge_into(cls, proto, store: Store) -> None:
        """Decode ``proto``'s mass into an existing store (additive)."""
        for key, weight in proto.binCounts.items():
            store.add(key, weight)
        for i, weight in enumerate(proto.contiguousBinCounts):
            if weight > 0:
                store.add(i + proto.contiguousBinIndexOffset, weight)


class DDSketchProto:
    """sketch <-> DDSketch{mapping, positiveValues, negativeValues, zeroCount}.

    As in the reference, count/min/max/sum bookkeeping is not part of the
    wire format: ``from_proto`` rebuilds ``count`` from the bin masses,
    while min/max/sum/avg are undefined on a decoded sketch.
    """

    @classmethod
    def to_proto(cls, sketch: BaseDDSketch):
        return messages().DDSketch(
            mapping=KeyMappingProto.to_proto(sketch.mapping),
            positiveValues=StoreProto.to_proto(sketch.store),
            negativeValues=StoreProto.to_proto(sketch.negative_store),
            zeroCount=sketch.zero_count,
        )

    @classmethod
    def from_proto(cls, proto, *, assume_native_linear: bool = False) -> DDSketch:
        mapping = KeyMappingProto.from_proto(
            proto.mapping, assume_native_linear=assume_native_linear
        )
        sketch = DDSketch(mapping.relative_accuracy)
        sketch._mapping = mapping
        sketch._relative_accuracy = mapping.relative_accuracy
        StoreProto.merge_into(proto.positiveValues, sketch.store)
        StoreProto.merge_into(proto.negativeValues, sketch.negative_store)
        sketch._zero_count = proto.zeroCount
        sketch._count = sketch.store.count + sketch.negative_store.count + proto.zeroCount
        return sketch


def batched_to_bytes(spec, state) -> List[bytes]:
    """Every stream of a batch as wire bytes, byte-identical to
    ``to_proto(...).SerializeToString()`` (``pb.wire.state_to_bytes``).
    Non-dense backends (``uniform_collapse``, ``moment``) emit
    ``SketchPayload`` envelopes (``backends.wirefmt.payload_to_bytes``); a
    state type that disagrees with the spec's backend raises ``SpecError``."""
    if _non_dense(spec):
        from sketches_tpu_torch.backends.wirefmt import payload_to_bytes

        return payload_to_bytes(spec, state)
    from sketches_tpu_torch.pb.wire import state_to_bytes

    return state_to_bytes(spec, state)


def batched_to_proto(spec, state) -> list:
    """Every stream of a batch as a wire-format message (parsed from the
    vectorized encoder's bytes; needs protobuf).  Dense specs only
    (``SpecError`` otherwise)."""
    _dense_messages_only(spec)
    pb = messages()
    return [pb.DDSketch.FromString(b) for b in batched_to_bytes(spec, state)]


def batched_from_proto(spec, protos, *, assume_native_linear: bool = False, device=None):
    """Decode wire-format messages into one batch on ``device`` (keys clamp
    into the spec window, mass conserved)."""
    from sketches_tpu_torch.pb.wire import protos_to_state

    _dense_messages_only(spec)
    return protos_to_state(
        spec, protos, assume_native_linear=assume_native_linear, device=device
    )


def batched_from_bytes(spec, blobs, *, assume_native_linear: bool = False, device=None):
    """Decode raw wire blobs into one batch on ``device``
    (``pb.wire.bytes_to_state``).  Non-dense specs decode ``SketchPayload``
    envelopes into their backend state (``AdaptiveState`` /
    ``MomentState``, ``backends.wirefmt.payload_from_bytes``); an unknown
    backend enum value, a backend/spec mismatch or structural damage raises
    ``WireDecodeError``."""
    if _non_dense(spec):
        from sketches_tpu_torch.backends.wirefmt import payload_from_bytes

        return payload_from_bytes(
            spec, blobs, assume_native_linear=assume_native_linear, device=device
        )
    from sketches_tpu_torch.pb.wire import bytes_to_state

    return bytes_to_state(
        spec, blobs, assume_native_linear=assume_native_linear, device=device
    )

"""Protobuf serialization: the cross-language wire format (PyTorch port).

Counterpart of ``sketches_tpu.pb`` (reference seams
``ddsketch/pb/ddsketch.proto`` and ``ddsketch/pb/proto.py``).  Device
state is copied to the host first, then encoded.

protobuf is optional: importing this package, and ``pb.wire``'s canonical
encode and decode, need no ``google.protobuf``.  The generated module
``ddsketch_pb2`` (a byte-for-byte copy of the JAX package's, so both share
one descriptor pool entry) is imported only on the paths that need message
objects: the object bridge in ``proto``, ``wire.protos_to_state`` and the
per-message fallback of the bulk decode.  Without protobuf those paths
raise ``EngineUnavailable``.
"""

from sketches_tpu_torch.pb.proto import (
    DDSketchProto,
    KeyMappingProto,
    StoreProto,
    batched_from_bytes,
    batched_from_proto,
    batched_to_bytes,
    batched_to_proto,
)

__all__ = [
    "DDSketchProto",
    "KeyMappingProto",
    "StoreProto",
    "batched_to_proto",
    "batched_from_proto",
    "batched_to_bytes",
    "batched_from_bytes",
]

"""Encoding and decoding of values on the owned-object plane (port of
ray_tpu/core/payloads.py): a value serialized above
``max_direct_call_object_size`` goes to shared memory, where any process
of this host maps it without a copy; a smaller one stays inline."""

from __future__ import annotations

from ray_tpu_torch._config import get_config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import read_from_shm, write_to_shm
from ray_tpu_torch.core.serialization import Serialized, deserialize, serialize
from ray_tpu_torch.core.task_spec import Payload


def encode_value(value, obj_id: ObjectID | None = None, threshold: int | None = None) -> Payload:
    """Serialize a value into a payload (shm above the threshold)."""
    return encode_serialized(serialize(value), obj_id=obj_id, threshold=threshold)


def encode_serialized(s: Serialized, obj_id: ObjectID | None = None, threshold: int | None = None) -> Payload:
    if threshold is None:
        threshold = get_config().max_direct_call_object_size
    contained = [r.id for r in s.contained_refs]
    if s.total_size() > threshold:
        if obj_id is None:
            obj_id = ObjectID.from_put()
        return Payload(shm=write_to_shm(obj_id, s), contained=contained)
    # frames are pickled: the buffers become plain bytes
    return Payload(inline=Serialized(header=s.header, buffers=[bytes(b) for b in s.buffers]), contained=contained)


def decode_payload(p: Payload, zero_copy: bool = True):
    """(value, mapping or None). With ``zero_copy`` an shm payload's
    tensors are views into a private, copy-on-write mapping of the
    segment (``object_store._mmap_private``): writable, and a write never
    reaches the owner's bytes. An inline payload's tensors are copies."""
    if p.shm is not None:
        s, seg = read_from_shm(p.shm, zero_copy=zero_copy)
        return deserialize(s.header, s.buffers), seg
    return deserialize(p.inline.header, p.inline.buffers), None

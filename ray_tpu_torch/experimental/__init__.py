"""Compiled graphs over shared-memory channels, and device objects
(port of ray_tpu/experimental/)."""

from ray_tpu_torch.experimental.device_objects import (
    DeviceRef,
    device_get,
    device_get_tree,
    device_put_object,
    device_put_tree,
    export_for_transfer,
    free_device_object,
)

__all__ = ["DeviceRef", "device_get", "device_get_tree", "device_put_object", "device_put_tree", "export_for_transfer",
           "free_device_object"]

"""Workflows are removed (port of ray_tpu/workflow/__init__.py, which
raises on import, as the reference's deprecation of Ray Workflows does)."""

raise ImportError(
    "ray_tpu_torch.workflow has been removed, matching the reference's deprecation "
    "of Ray Workflows. Use ray_tpu_torch tasks/actors instead."
)

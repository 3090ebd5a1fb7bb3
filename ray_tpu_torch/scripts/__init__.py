"""Command-line entry points (port of ray_tpu/scripts/)."""

"""Utilities of the port: metrics and tracing (ports of
ray_tpu/util/metrics.py and ray_tpu/util/tracing.py, this process only),
placement groups and scheduling strategies (ports of
ray_tpu/util/placement_group.py and scheduling_strategies.py)."""

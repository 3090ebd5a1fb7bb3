"""Observability substrate for the port: metrics and tracing (ports of
ray_tpu/util/metrics.py and ray_tpu/util/tracing.py, this process only)."""

"""Cluster KV plane (port of ray_tpu/llm/kvplane/): the content-stable
prefix keys that the local prefix cache uses. The index actor and its
client are not ported yet (ROADMAP.md, queue 1, disagg/kvplane)."""

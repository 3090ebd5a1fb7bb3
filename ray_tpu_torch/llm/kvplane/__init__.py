"""Cluster KV plane (port of ray_tpu/llm/kvplane/): the content-stable
prefix keys that the local prefix cache uses. The index actor and its
client are not ported yet: they wait for the object plane (ROADMAP.md,
queue 1, the object plane)."""

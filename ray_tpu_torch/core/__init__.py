"""The owned-object plane (port of the part of ray_tpu/core/ that the
owned path reaches): ids, ObjectRef and its reference counts,
serialization with out-of-band host tensors, shared-memory segments,
payloads, and ``direct.py``'s owned store with its borrow and free
protocol between processes. The head, scheduler, tasks, actors, leases
and lineage wait for the runtime (ROADMAP.md, queue 1, the runtime)."""

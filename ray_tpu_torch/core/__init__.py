"""The runtime's core (port of ray_tpu/core/): ids, ObjectRef and its
reference counts, serialization (host tensors out of band, code by
reference), shared-memory segments and the head's store, payloads, the
direct call plane (owned objects, borrows, direct actor and task calls,
leases, lineage), the GCS, the scheduler, the task manager, the node and
its worker zygote, the worker process and the head ``Runtime``."""

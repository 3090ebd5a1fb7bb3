"""ray_tpu_torch.collective: collectives between actors (port of
ray_tpu/collective), over a rendezvous actor and the shared-memory object
store (backend ``"object_store"``, alias ``"gloo"``)."""

from ray_tpu_torch.util.usage import record_library_usage as _rlu

_rlu("collective")

from ray_tpu_torch.collective.collective import (  # noqa: E402, F401
    CollectiveActorMixin,
    allgather,
    allreduce,
    barrier,
    broadcast,
    cleanup_group_actor,
    create_collective_group,
    declare_collective_group,
    destroy_collective_group,
    get_rank,
    get_world_size,
    init_collective_group,
    recv,
    reduce,
    reducescatter,
    send,
)
from ray_tpu_torch.collective.types import Backend, ReduceOp  # noqa: E402, F401

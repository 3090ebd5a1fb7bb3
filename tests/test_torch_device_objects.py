"""Device objects on the port (``ray_tpu_torch.experimental``) on the CPU.

Twins of ``tests/test_device_objects.py``'s first four cases (the
registered object itself in process, a tree round trip, a transfer across
processes through the owner actor's export, the collective's shm plane
with a 1 MB tensor over 4 ranks). The fifth,
``test_ici_backend_allreduce_allgather``, waits for ROADMAP queue 1's
multi-device axes; the port's raise naming that item is
``tests/test_torch_collective.py::test_xla_backend_raises_naming_its_item``.
Then the port's rules: a tree of bf16, int32 and fp16 leaves crosses the
process boundary with its dtypes and shapes, a second fetch returns the
cached objects, a freed id's export raises KeyError naming it, and the
tree helpers keep containers. The consumers pass ``device="cpu"``; on the
card (``cuda``-marked) the registered tensor is the CUDA tensor itself.
No jax here: the actors live in ``tests/torch_dag_defs.py``."""

import numpy as np
import pytest
import torch
import torch_dag_defs as defs

import ray_tpu_torch
from ray_tpu_torch.exceptions import TaskError
from ray_tpu_torch.experimental import (
    DeviceRef,
    device_get,
    device_get_tree,
    device_put_object,
    device_put_tree,
    export_for_transfer,
    free_device_object,
)
from ray_tpu_torch.experimental.device_objects import tree_map

T = 60


@pytest.fixture
def rt_start():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_device_ref_same_process_zero_copy():
    arr = torch.arange(1024.0)
    ref = device_put_object(arr)
    assert device_get(ref) is arr  # the registered object itself
    assert (ref.shape, ref.dtype) == ((1024,), "float32")
    free_device_object(ref)
    with pytest.raises(KeyError):
        device_get(ref)


def test_device_ref_tree_roundtrip():
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    refs = device_put_tree(params)
    assert all(isinstance(r, DeviceRef) for r in refs.values())
    out = device_get_tree(refs)
    assert out["w"] is params["w"] and out["b"] is params["b"]


def test_device_ref_cross_process_transfer(rt_start):
    """An actor registers a tensor once; a task in another process fetches
    it through the owner's export (one transfer, then cached)."""
    owner = ray_tpu_torch.remote(defs.WeightOwner).remote()
    ref = ray_tpu_torch.get(owner.publish.remote(owner), timeout=T)
    consume = ray_tpu_torch.remote(defs.consume)
    assert ray_tpu_torch.get(consume.remote(ref), timeout=T) == float(np.arange(8.0).sum() * 3)


def test_collective_shm_plane_large_tensor(rt_start):
    """Tensors above the shm threshold ride the object store: allreduce of
    1 MB across 4 ranks returns the sum (the rendezvous actor only relays
    ObjectRefs)."""
    from ray_tpu_torch import collective
    from ray_tpu_torch.collective.collective import _SHM_PLANE_THRESHOLD

    n = 4
    size = max(_SHM_PLANE_THRESHOLD // 4 + 1, 1 << 18)
    rank_cls = ray_tpu_torch.remote(defs.Rank).options(num_cpus=0)
    ranks = [rank_cls.remote(n, i, "shmplane") for i in range(n)]
    outs = ray_tpu_torch.get([r.go.remote(size) for r in ranks], timeout=T)
    for allred, n_gath, rs0 in outs:
        assert allred == sum(range(1, n + 1))
        assert n_gath == n
        assert rs0 == sum(range(1, n + 1))
    collective.cleanup_group_actor("shmplane")


def test_tree_crosses_processes_with_dtypes_and_cache(rt_start):
    """bf16, int32 and fp16 leaves cross as themselves (a host tensor of
    the same dtype on the plane, not a numpy array); the owner still
    resolves its own objects; a second fetch returns the cached ones."""
    owner = ray_tpu_torch.remote(defs.WeightOwner).remote()
    refs = ray_tpu_torch.get(owner.publish_tree.remote(owner), timeout=T)
    assert refs["w"].dtype == "bfloat16" and refs["w"].shape == (64, 32)
    fetch = ray_tpu_torch.remote(defs.fetch_tree)
    desc, cached = ray_tpu_torch.get(fetch.remote(refs), timeout=T)
    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 32, generator=g).to(torch.bfloat16)
    assert desc["w"] == ("torch.bfloat16", (64, 32), float(w.float().sum()))
    assert desc["layers"][0]["b"] == ("torch.int32", (5,), 10.0)
    assert desc["layers"][1][0] == ("torch.float16", (3, 2), 6.0)
    assert cached
    assert ray_tpu_torch.get(owner.same_objects.remote(refs), timeout=T)


def test_freed_export_raises_naming_the_id(rt_start):
    owner = ray_tpu_torch.remote(defs.WeightOwner).remote()
    ref = ray_tpu_torch.get(owner.publish.remote(owner), timeout=T)
    assert ray_tpu_torch.get(owner.free.remote(ref), timeout=T)
    with pytest.raises(TaskError) as ei:
        ray_tpu_torch.get(owner.__rt_device_get__.remote(ref.object_id), timeout=T)
    assert isinstance(ei.value.cause, KeyError) and ref.object_id in str(ei.value.cause)
    local = device_put_object(torch.ones(2))
    free_device_object(local)
    with pytest.raises(KeyError, match=local.object_id):
        export_for_transfer(local.object_id)


def test_tree_map_keeps_containers():
    from collections import namedtuple

    Pair = namedtuple("Pair", "a b")
    tree = {"x": [1, (2, 3)], "p": Pair(4, {"y": 5})}
    out = tree_map(lambda v: v * 10, tree)
    assert out == {"x": [10, (20, 30)], "p": Pair(40, {"y": 50})}
    assert type(out["p"]) is Pair and isinstance(out["x"][1], tuple)


def test_resolve_elsewhere_needs_owner_actor():
    ref = DeviceRef(object_id="0" * 32, owner_pid=-1, shape=(1,), dtype="float32")
    with pytest.raises(ValueError, match="owner_actor"):
        device_get(ref, device="cpu")


@pytest.mark.cuda
def test_card_tensor_registered_as_itself():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = torch.ones(16, device="cuda", dtype=torch.bfloat16)
    ref = device_put_object(t)
    assert device_get(ref) is t
    host = export_for_transfer(ref.object_id)
    assert host.device.type == "cpu" and host.dtype == torch.bfloat16
    free_device_object(ref)

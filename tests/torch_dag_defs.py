"""Module-level actors and functions for the port's compiled-graph and
device-object tests (``tests/test_torch_compiled_dag.py``,
``tests/test_torch_device_objects.py``). ray_tpu_torch sends code to its
workers by reference, so what a worker runs lives at the top level of an
importable module; this one imports no jax."""

import numpy as np


class Adder:
    def __init__(self, k=0):
        self.k = k

    def add(self, x):
        return x + self.k

    def add2(self, x, y):
        return x + y

    def boom(self, x):
        raise ValueError(f"boom on {x}")

    def big(self, x):
        return b"z" * (1 << 20)

    def pid(self, x):
        import os

        return os.getpid()


def nop():
    return 0


def ident(x):
    return x


class WeightOwner:
    """Registers tensors in its own process's device-object registry."""

    def publish(self, me):
        import torch

        from ray_tpu_torch.experimental import device_put_object

        self.w = torch.arange(8.0) * 3
        return device_put_object(self.w, owner_actor=me)

    def publish_tree(self, me):
        import torch

        from ray_tpu_torch.experimental import device_put_tree

        g = torch.Generator().manual_seed(0)
        self.tree = {"w": torch.randn(64, 32, generator=g).to(torch.bfloat16),
                     "layers": [{"b": torch.arange(5, dtype=torch.int32)}, (torch.ones(3, 2, dtype=torch.float16),)]}
        return device_put_tree(self.tree, owner_actor=me)

    def same_objects(self, refs):
        from ray_tpu_torch.experimental import device_get_tree
        from ray_tpu_torch.experimental.device_objects import tree_map

        got = device_get_tree(refs)
        flags = []
        tree_map(lambda p: flags.append(p.a is p.b), _zip_leaves(got, self.tree))
        return len(flags) == 3 and all(flags)

    def free(self, ref):
        from ray_tpu_torch.experimental import free_device_object

        free_device_object(ref)
        return True


class _Pair:
    """Two matching leaves (a leaf to ``tree_map``, unlike a tuple)."""

    def __init__(self, a, b):
        self.a, self.b = a, b


def _zip_leaves(a, b):
    if isinstance(a, dict):
        return {k: _zip_leaves(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_zip_leaves(x, y) for x, y in zip(a, b)]
    return _Pair(a, b)


def consume(ref):
    from ray_tpu_torch.experimental import device_get

    a = device_get(ref, device="cpu")
    b = device_get(ref, device="cpu")  # the second resolve hits the transfer cache
    assert a is b
    return float(a.sum())


def fetch_tree(refs):
    """The fetched tree's leaves as (dtype, shape, bytes), and whether a
    second fetch returned the cached objects."""
    from ray_tpu_torch.experimental import device_get_tree
    from ray_tpu_torch.experimental.device_objects import tree_map

    first = device_get_tree(refs, device="cpu")
    second = device_get_tree(refs, device="cpu")
    cached = []
    tree_map(lambda p: cached.append(p.a is p.b), _zip_leaves(first, second))
    desc = tree_map(lambda t: (str(t.dtype), tuple(t.shape), float(t.float().sum())), first)
    return desc, len(cached) == 3 and all(cached)


class Rank:
    """A collective group member over the port's object-store backend."""

    def __init__(self, world, rank, group):
        from ray_tpu_torch import collective

        self.rank = rank
        self.group = group
        collective.init_collective_group(world, rank, group_name=group)

    def go(self, size):
        from ray_tpu_torch import collective

        t = np.full((size,), self.rank + 1, np.float32)
        out = collective.allreduce(t, group_name=self.group)
        gathered = collective.allgather(t, group_name=self.group)
        rs = collective.reducescatter(t, group_name=self.group)
        return float(out[0]), len(gathered), float(rs[0])

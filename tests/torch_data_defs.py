"""UDFs, callable classes and engine factories for the Data and batch
inference tests (``tests/test_torch_data.py``, ``tests/test_torch_batch.py``).

The port sends a UDF to its workers by reference (module and qualified
name), so the tests' UDFs live here at module level, where both packages'
workers import them; ray_tpu's tests define them inline. No jax here: a
port worker imports this module."""

from __future__ import annotations

import numpy as np


def double_id(b):
    return {"id": b["id"] * 2}


def inc_x(r):
    return {"x": r["x"] + 1}


def x_even(r):
    return r["x"] % 2 == 0


def plus_minus(r):
    return [{"y": r["x"]}, {"y": -r["x"]}]


def never(r):
    return False


def id_is_3(r):
    return r["id"] == 3


def first_id(b):
    return {"y": [b["id"][0]]}


def double_data(x):
    return {"data": x["data"] * 2}


def boom_batch(b):
    raise ValueError("kaboom in a UDF")


def skewed(batch):
    """Every 4th block balloons to ~8MB (far above a 1MB target), others tiny."""
    i = int(batch["id"][0])
    n = 1_000_000 if i % 4 == 0 else 1_000
    return {"x": np.full(n, i, dtype=np.float64)}


def fill_block(b, elems: int):
    return {"x": np.full(elems, int(b["id"][0]), dtype=np.float64)}


def node_of(batch):
    """The node this map task ran on, as an int of its id's first 8 hex digits."""
    import ray_tpu_torch

    nid = ray_tpu_torch.get_runtime_context().node_id.hex()
    return {"nid": np.array([int(nid[:8], 16)])}


def block_on_node(i: int, tag: float):
    """A shm-sized block (16384 float64s from ``tag + i``), made on the node
    the task runs on, so its primary copy's namespace names that node."""
    return {"x": np.full(16_384, tag + i, np.float64)}


def scale_sum(b, factor: float):
    return {"s": b["data"].sum(axis=1, keepdims=False) * factor}


class AddConst:
    def __init__(self, c=100):
        self.c = c

    def __call__(self, batch):
        return {"id": batch["id"] + self.c}


class ShardSum:
    """An actor that drains one streaming_split iterator (the data half of a
    trainer's get_dataset_shard loop)."""

    def total(self, it, batch_size: int):
        total, rows = 0, 0
        for batch in it.iter_batches(batch_size=batch_size):
            total += int(batch["id"].sum())
            rows += len(batch["id"])
        return total, rows

    def slow_total(self, it, batch_size: int, pause_s: float):
        """As ``total`` over a "tokens" column, pausing after each batch (a
        training step): the refs in the iterator's prefetch window wait
        that long before their get."""
        import time

        total, rows = 0, 0
        for batch in it.iter_batches(batch_size=batch_size, drop_last=True):
            total += int(batch["tokens"].astype(np.int64).sum())
            rows += len(batch["tokens"])
            time.sleep(pause_s)
        return total, rows


# ---------------------------------------------------------------- batch inference
TINY = dict(dtype="float32", remat=False, max_seq_len=64)


def tiny_engine(params: dict, max_num_seqs: int = 4):
    """The port's engine on the tiny f32 config, on the CPU, over ``params``
    (ray_tpu's seed-0 weights converted by the test; they reach the actor
    inside the factory's ``functools.partial``)."""
    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.models.llama import LlamaConfig

    return LLMEngine(LlamaConfig.tiny(**TINY), params, max_num_seqs=max_num_seqs, max_seq_len=64, device="cpu")


def prompt_of(row):
    """preprocess: the prompt from a row's index."""
    i = int(row["i"])
    return {"i": i, "prompt": [i % 11 + 1, i % 7 + 1, 5]}


def first_token(row):
    """postprocess: the row's first generated token beside its stream."""
    return {"i": row["i"], "first": row["generated"][0], "generated": row["generated"],
            "reason": row["generated_finish_reason"]}


def failing_engine():
    raise RuntimeError("engine factory failed")


def boom_row(row):
    raise ValueError("kaboom in postprocess")


def slow_big(delay_s: float, n: int):
    """A result far above the inline threshold, returned after ``delay_s``:
    the worker seals it in the head's store (the owned entry's REDIRECT)."""
    import time

    time.sleep(delay_s)
    return np.zeros(n, np.float64)

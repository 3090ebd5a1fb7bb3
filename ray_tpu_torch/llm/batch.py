"""Data-integrated batch LLM inference (port of ray_tpu/llm/batch.py).

Reference parity: python/ray/llm/_internal/batch/processor/ (ray.data.llm
build_llm_processor): a dataset of prompts flows through a pool of
engine-holding actors and comes back as a dataset of completions, with
the Data executor handling partitioning, actor reuse and backpressure.

The UDF actor owns a continuous-batching ``LLMEngine`` (llm/engine.py),
built in the actor by ``engine_factory``, and each Data batch is
generated with full slot utilization. The engine runs on the card unless
the factory asks for the CPU; the pool's actors ask only for
``num_cpus``, as ray_tpu's do, so their engines run from workers that
are not bound to a card (ROADMAP, "Replicas that ask for no card").

``engine_factory``, ``preprocess`` and ``postprocess`` travel to the
workers by reference: each must be a module-level function or a
``functools.partial`` of one; a lambda or a closure raises TypeError at
``build_llm_processor`` (``data/dataset.py::check_udf``).
"""

from __future__ import annotations

import time

import numpy as np

from ray_tpu_torch.data.dataset import check_udf
from ray_tpu_torch.llm.sampling import SamplingParams


class _EngineUDF:
    """Class-based map_batches UDF: one engine per Data actor."""

    def __init__(self, engine_factory, sampling: SamplingParams, input_column: str, output_column: str):
        self.engine = engine_factory()
        self.sampling = sampling
        self.input_column = input_column
        self.output_column = output_column
        self.tokens_out = 0
        self.wall = 0.0

    def __call__(self, batch: dict) -> dict:
        prompts = [[int(t) for t in p] for p in batch[self.input_column]]
        t0 = time.perf_counter()
        outs = self.engine.generate(prompts, self.sampling)
        self.wall += time.perf_counter() - t0
        self.tokens_out += sum(len(o.token_ids) for o in outs)
        gen = np.empty(len(outs), dtype=object)
        for i, o in enumerate(outs):
            gen[i] = list(o.token_ids)
        out = dict(batch)
        out[self.output_column] = gen
        out[self.output_column + "_finish_reason"] = np.array([o.finish_reason for o in outs])
        return out


def build_llm_processor(
    engine_factory,
    *,
    sampling: SamplingParams | None = None,
    batch_size: int = 16,
    concurrency: int = 1,
    input_column: str = "prompt",
    output_column: str = "generated",
    preprocess=None,
    postprocess=None,
):
    """Return ``processor(Dataset) -> Dataset`` running batch inference.

    ``engine_factory``: zero-arg callable building the LLMEngine inside
    each Data actor (weights load in-actor, never through the driver).
    ``concurrency``: number of engine actors (maps to map_batches
    concurrency; each actor admits ``batch_size`` prompts through its
    cache with continuous batching).
    """
    sampling = sampling or SamplingParams()
    check_udf(engine_factory, "engine_factory")
    for fn, what in ((preprocess, "preprocess"), (postprocess, "postprocess")):
        if fn is not None:
            check_udf(fn, what)

    def processor(ds):
        if preprocess is not None:
            ds = ds.map(preprocess)
        ds = ds.map_batches(
            _EngineUDF,
            fn_constructor_kwargs={
                "engine_factory": engine_factory,
                "sampling": sampling,
                "input_column": input_column,
                "output_column": output_column,
            },
            batch_size=batch_size,
            concurrency=concurrency,
        )
        if postprocess is not None:
            ds = ds.map(postprocess)
        return ds

    return processor

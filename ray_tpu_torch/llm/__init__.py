"""Serving on the card: the continuous-batching engine over the slot or
paged KV layout, with speculative decoding and serving telemetry."""

from ray_tpu_torch.llm.engine import LLMEngine, RequestOutput
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.llm.spec import SpecConfig

__all__ = ["LLMEngine", "RequestOutput", "SamplingParams", "SpecConfig"]

"""Serving on the card: the paged continuous-batching engine."""

from ray_tpu_torch.llm.engine import LLMEngine, RequestOutput
from ray_tpu_torch.llm.sampling import SamplingParams

__all__ = ["LLMEngine", "RequestOutput", "SamplingParams"]

"""ray_tpu_torch.llm.spec — speculative decoding for the device-resident
loop (port of ray_tpu/llm/spec/).

A cheap drafter proposes up to k continuation tokens per lane; ONE verify
step runs the target model over all k+1 positions at once (padded to a
fixed k so shapes never vary), accepts the longest prefix the target
agrees with (greedy exact-match, or one-hot rejection sampling for
temperature > 0), and rolls back rejected KV by length. On the card the
whole round (draft, verify, append, write-back) is one CUDA graph per
engine (``llm/cuda/graph.py``). Greedy output is token-identical to the
non-speculative path.

Modules:
- controller.py: ``SpecConfig`` (user-facing) + per-request adaptive-k EMA.
- drafter.py: ``NGramDrafter`` (prompt-lookup, zero extra weights) and
  ``ModelDrafter`` (a small llama with its own slot KV cache).
- verify.py: the verify step per KV layout and the lane deltas.

Only the config layer imports here; the engine imports the drafter and
verify modules when it builds a spec engine.
"""

from ray_tpu_torch.llm.spec.controller import AdaptiveKController, SpecConfig

__all__ = ["AdaptiveKController", "SpecConfig"]

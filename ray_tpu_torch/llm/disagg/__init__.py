"""Disaggregated prefill/decode serving (port of ray_tpu/llm/disagg/),
the engine-level half: a prefill engine extracts each request's KV block
(``scatter.py``) into a handoff payload, the codec (``handoff.py``)
validates it on the wire, and a decode engine scatters it into its slot
cache or page pool in place and decodes from it (``LLMEngine``'s
``add_prefill_request``/``pop_handoff``/``add_prefilled``). The router
(``router.py``) is the split's control plane over injected prefill,
decode and resume callables.

Not ported yet (ROADMAP.md, queue 1, the object plane): the object-plane
legs ``publish``/``fetch`` (they raise).
"""

from ray_tpu_torch.llm.disagg.handoff import (
    HandoffError,
    HandoffLostError,
    decode as decode_handoff,
    encode as encode_handoff,
    fetch as fetch_handoff,
    meta_of as handoff_meta,
    publish as publish_handoff,
)
from ray_tpu_torch.llm.disagg.router import DisaggRequestError, DisaggRouter
from ray_tpu_torch.llm.disagg.scatter import (
    kv_extract_paged,
    kv_extract_slots,
    kv_scatter_in_paged,
    kv_scatter_in_slots,
    make_handoff_fns,
)

__all__ = [
    "DisaggRequestError",
    "DisaggRouter",
    "HandoffError",
    "HandoffLostError",
    "decode_handoff",
    "encode_handoff",
    "fetch_handoff",
    "handoff_meta",
    "kv_extract_paged",
    "kv_extract_slots",
    "kv_scatter_in_paged",
    "kv_scatter_in_slots",
    "make_handoff_fns",
    "publish_handoff",
]

"""Continuous-batching LLM engine (port of ray_tpu/llm/engine.py) over
either KV layout, in bf16/f32 or int8 (``cache_dtype="int8"``: quantized
on append, dequantized in attention, ``kv_quant.py``):

- ``kv_layout="slots"`` (the default, as in ray_tpu): one static row of
  ``max_seq_len`` positions per slot (``kv_cache.py``); decode attends
  over the whole row with a length mask (plain PyTorch: the slot layout
  has no page gather and no TPU kernel);
- ``kv_layout="paged"``: a block-table page pool (``paged_kv.py``); the
  scheduler grows pages before each decode step and preempts the youngest
  sequence when the pool runs dry (recompute-style, as vLLM does); decode
  and the extend attend through K4;
- prompt prefill bucketed to the prefill buckets and BATCHED: same-bucket
  admissions run as one forward (K1) with the batch padded to a power of
  two;
- every step() is three stages: admission, prefill, decode. Decode is
  device-resident by default, as in ray_tpu: the lanes (next tokens,
  threefry keys, sampling parameters; the paged layout's tables and
  lengths, the slot cache's length lane) live on the device and change
  only by in-place deltas; each step dispatches the fused step
  (attention, sampling, append; on the card one replay of a CUDA graph
  captured when the engine is built, ``cuda/graph.py``) and then reads
  back the PREVIOUS step's tokens, so emission trails the device by one
  step and each sequence runs one discarded trailing step.
  ``device_resident=False`` keeps the synchronous loop, ray_tpu's oracle:
  upload the lanes, attention, append, sample, read the tokens back, all
  in one step;
- prefix caching (on by default, as in ray_tpu): a fresh prompt's K/V is
  kept at every block boundary of it (``PrefixCache``, the local tier, in
  the prefill's dtype); admission looks up the longest cached
  block-aligned prefix of a new prompt, inserts it into the request's
  slot or pages (quantized there for an int8 cache) and re-attends only
  the suffix (``model_runner.extend`` or ``extend_paged``);
- speculative decoding (``speculative=SpecConfig(...)``, ``llm/spec/``,
  device-resident only, as in ray_tpu): a drafter (prompt-lookup n-grams
  or a small draft model with its own slot cache) proposes up to k tokens
  per lane, one verify forward over all k+1 positions accepts the longest
  agreeing prefix (exact match for greedy lanes, one-hot rejection
  sampling for stochastic ones) and emits up to k+1 tokens a lane a
  round; on the card the whole round is one CUDA graph (the paged
  verify's prefix attention is K4 at R = rep * (k + 1)). Greedy output is
  token-identical to the plain loop;
- serving telemetry (``telemetry=True``, the default, as in ray_tpu;
  ``llm/telemetry.py``): a flight recorder of per-step and per-request
  records, the SLO metrics, request tracing and a JSONL dump on an engine
  error, all from host shadow state (``LLMEngine.telemetry()``);
- KV moving between engines (``llm/disagg/``, ``llm/migrate.py``): a
  prefill-only request finishes with its KV block extracted into a
  handoff payload (``add_prefill_request``, ``pop_handoff``); a decode
  engine admits such a block (``add_prefilled``), a mid-decode
  checkpoint (``checkpoint_request``, ``restore_request``: live
  migration) or a suspended conversation spilled to host memory
  (``suspend_request``, ``resume_suspended``) by scattering it into its
  cache or pages in place, so a captured decode graph keeps its
  addresses, and decodes on from it. Over the object plane
  (``core/direct.py``) a checkpoint or a suspended conversation is
  published as an owned object and restored from its reference in
  another engine or process;
- the cluster KV plane (``kv_plane=KVPlaneClient(...)``,
  ``llm/kvplane/``): a local prefix-cache miss consults the cluster
  index; the lookup and the fetch of the longest live remote block run on
  the engine's fetch worker, off the lock and off the card, while the
  request waits; at a later admission the block is uploaded, inserted into
  the request's slot or pages (requantized across cache dtypes), stored in
  the local cache and republished. Freshly cached prefixes are published
  at the step tail, outside the lock.

- tensor parallelism (``mesh=create_mesh(tp=n, devices=[...])``,
  ``parallel/mesh.py``): the engine is rank 0 and starts n-1 rank
  processes (``parallel/ranks.py``), each holding its shard of the weights
  (heads, kv heads, MLP columns and vocab split, ``weights.shard_params``)
  and its kv heads of the cache or pool (the int8 scale lanes split the
  same way). Rank 0 keeps the scheduler; every device operation (prefill,
  insert, extend, the lane and table deltas, the decode step or spec
  round, the sync loop's step) is an ``_op_*`` method that rank 0 first
  sends to the other ranks, with its small host arguments, and then runs
  itself, so the per-layer sums (``tp_collective``: "fp", the exact sum,
  or "int8", the quantized all-reduce; ``model_runner``) run in lockstep.
  Every rank samples the gathered logits from the same keys; only rank 0
  reads the tokens. No CUDA graph at tp > 1: gloo collectives cannot be
  captured, so the device-resident step runs the same functions eagerly
  on each rank (``FusedDecode(capture=False)``; the recompile sentinel's
  capture count stays 0). K1 and K4 run on each rank's heads. The ranks
  die with the engine (``shutdown``, its collection, or the process's
  death). Handoff, migration, suspend and the KV plane are not ported on
  a tensor-parallel engine, nor is a mesh with axes besides tp.

Features of ray_tpu's engine that this port does not have yet raise
NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

import numbers
import queue
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ray_tpu_torch import chaos
from ray_tpu_torch.llm import kv_cache as kvc
from ray_tpu_torch.llm import migrate as mig
from ray_tpu_torch.llm import model_runner as mr
from ray_tpu_torch.llm import paged_kv as pkv
from ray_tpu_torch.llm import prng
from ray_tpu_torch.llm.cuda.graph import FusedDecode, PagedStep, SlotStep, SpecPagedStep, SpecSlotStep
from ray_tpu_torch.llm.disagg.handoff import host_tensor
from ray_tpu_torch.llm.disagg.scatter import make_handoff_fns
from ray_tpu_torch.llm.kv_quant import bytes_per_token, is_int8, normalize_cache_dtype
from ray_tpu_torch.llm.kvplane.index import boundary_keys, prefix_key, token_bytes
from ray_tpu_torch.llm.sampling import SamplingParams, sample
from ray_tpu_torch.models.llama import init_params
from ray_tpu_torch.parallel.mesh import _indexed, axis_size, is_tp_only
from ray_tpu_torch.parallel.ranks import Ranks, _recv, close_ranks
from ray_tpu_torch.weights import init_params_shard, shard_params


@dataclass
class RequestState:
    request_id: str
    prompt_token_ids: list
    params: SamplingParams
    token_ids: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)
    slot: int = -1
    finished: bool = False
    finish_reason: str | None = None
    out_queue: "queue.SimpleQueue | None" = None
    # KV computed by another engine: a handoff payload, or a checkpoint's
    # block (disaggregation, migration, suspend)
    prefilled: dict | None = None
    # prefill-only: run the admission and prefill stages, extract the KV
    # block into a handoff (pop_handoff) and finish; never decodes
    prefill_only: bool = False
    # admission order (preemption picks the youngest) and preemption count
    admit_seq: int = -1
    preemptions: int = 0
    # prefix resolution cached while the request waits: None = not resolved,
    # (k, v, n, k_scale, v_scale) = a hit, (_PREF_MISS, gen, expiry) = a miss
    # at the cache's generation gen, good until the wall clock passes expiry
    cached_pref: tuple | None = None
    # telemetry lifecycle stamps (llm/telemetry.py; host wall clocks only)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_last: float = 0.0
    itls: list = field(default_factory=list)
    queue_wait: float | None = None
    kv_transferred: bool = False
    # (trace_id, root_span_id, parent_span_id) when RT_TRACING=1
    trace: tuple | None = None
    # live migration (llm/migrate.py): a restored request's splice state
    # (its lane key, the spec controller's state), consumed by _bind_resume
    # together with ``prefilled``
    resume: dict | None = None
    # restore ingress wall clock (0.0 = never migrated): the splice
    # latency observed at the first post-splice token
    t_restore: float = 0.0


@dataclass
class RequestOutput:
    request_id: str
    prompt_token_ids: list
    token_ids: list
    new_token_ids: list
    finished: bool
    finish_reason: str | None = None
    logprobs: list | None = None
    streamed: bool = False


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest prefill bucket {buckets[-1]}")


# RequestState.cached_pref miss marker. A blocked request keeps its miss
# (no lookup every step) until the cache's store generation moves: a leader
# admitted in the same wave stores the prefix after the follower's lookup
# missed, and the follower then re-resolves and hits. A local-only cache
# never expires a miss otherwise (nothing else mints its keys); with a KV
# plane the miss lapses after a short lease, since a PEER's publish cannot
# move the local generation.
_PREF_MISS = object()
# _resolve_prefix's answer while the request's remote prefix fetch is in flight
_DEFER = object()


class PrefixCache:
    """Hash-prefix KV reuse across requests, the local tier (port of
    ray_tpu/llm/engine.py::PrefixCache).

    One GROUP per stored prompt: its K/V ``[L, pad, kv, hd]`` on the
    device, padded to the prefill bucket of its block-aligned length, and
    keyed at every block boundary (``prefix_key``: content-stable blake2b,
    ray_tpu's key space) with that boundary's valid length. LRU over groups
    under a byte budget. A hit is verified token for token against the
    group's one stored token tuple. ``evict_hook`` (set by the KV plane
    client) hears each evicted group's keys, so a published copy
    unregisters and frees before the bytes die.

    On a tensor-parallel engine each rank holds its kv heads of a group:
    ``shards`` (the tp size) scales the byte accounting to the whole
    group's bytes, as ray_tpu counts a sharded array's, and ``last_gid`` is
    the group a ``store`` just made (rank 0 tells the other ranks to keep
    their shard of it; every stored K tensor carries its group id as
    ``prefix_gid``)."""

    def __init__(self, block: int = 64, max_bytes: int = 256 << 20, shards: int = 1):
        self.block = block
        self.max_bytes = max_bytes
        self.shards = int(shards)
        self.last_gid = None
        # called with an evicted group's key list; None = a local-only cache
        self.evict_hook = None
        # store generation: bumped whenever new boundary keys mint, so a
        # cached miss knows when the cache gained entries
        self.gen = 0
        self._groups: dict = {}  # gid -> (k, v, nbytes, [keys], token tuple)
        self._keys: dict = {}  # prefix key -> (gid, n)
        self._order: deque = deque()  # LRU over gids: left = coldest
        self._next_gid = 0
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.evictions = 0

    def lookup(self, prompt_token_ids, admissible=None):
        """Longest block-aligned cached prefix STRICTLY shorter than the
        prompt (one token must remain to produce logits): ``(k, v, n)`` or
        None. ``admissible(n) -> bool`` rejects a boundary before it can
        match, and the lookup falls through to the next shorter one."""
        ids = tuple(int(t) for t in prompt_token_ids)
        buf = token_bytes(ids)
        n = ((len(ids) - 1) // self.block) * self.block
        while n >= self.block:
            if admissible is not None and not admissible(n):
                n -= self.block
                continue
            hit = self._keys.get(prefix_key(buf, n))
            if hit is not None:
                gid, n_valid = hit
                k, v, _, _, group_ids = self._groups[gid]
                if group_ids[:n_valid] == ids[:n_valid]:  # a hash collision never serves foreign KV
                    self._order.remove(gid)
                    self._order.append(gid)
                    self.hits += 1
                    self.tokens_saved += n_valid
                    return k, v, n_valid
            n -= self.block
        self.misses += 1
        return None

    def store(self, prompt_token_ids, ks, vs, buckets):
        """Cache a freshly prefilled prompt's K/V once, keyed at every
        block boundary not cached yet. ks/vs: [L, T_pad, kv, hd] views of
        the batched prefill output; the group keeps a contiguous copy of
        the first ``pad`` positions (the bucket of the block-aligned
        length), so the budget counts exactly what it holds and the whole
        batch's K/V is not kept alive by a view. Returns ``(new_keys, pad)``,
        the freshly minted (key, n) boundary pairs and the stored width (a
        KV plane client publishes exactly what was stored), or None when
        nothing new was cached."""
        n_max = (len(prompt_token_ids) // self.block) * self.block
        if n_max < self.block:
            return None
        ids = tuple(int(t) for t in prompt_token_ids[:n_max])
        buf = token_bytes(ids)
        new_keys = [(key, n) for n in range(self.block, n_max + 1, self.block)
                    if (key := prefix_key(buf, n)) not in self._keys]
        if not new_keys:
            return None
        pad = _bucket(n_max, buckets)
        nbytes = 2 * ks[:, :pad].numel() * ks.element_size() * self.shards
        if nbytes > self.max_bytes:
            return None
        while self._bytes + nbytes > self.max_bytes and self._order:
            self._evict_one()
        k = ks[:, :pad].clone(memory_format=torch.contiguous_format)
        v = vs[:, :pad].clone(memory_format=torch.contiguous_format)
        gid = self._next_gid
        self._next_gid += 1
        k.prefix_gid = gid
        self.last_gid = gid
        self._groups[gid] = (k, v, nbytes, [key for key, _ in new_keys], ids)
        for key, n in new_keys:
            self._keys[key] = (gid, n)
        self._order.append(gid)
        self._bytes += nbytes
        self.gen += 1
        return new_keys, pad

    def _evict_one(self):
        gid = self._order.popleft()
        _, _, nbytes, keys, _ = self._groups.pop(gid)
        for key in keys:
            self._keys.pop(key, None)
        self._bytes -= nbytes
        self.evictions += 1
        if self.evict_hook is not None:
            # the route dies before the bytes: the hook unregisters the
            # published copy's keys and frees the owned block
            try:
                self.evict_hook(keys)
            except Exception:  # noqa: BLE001 — plane trouble never breaks eviction
                pass

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "tokens_saved": self.tokens_saved,
            "evictions": self.evictions,
            "entries": len(self._groups),
            "bytes": self._bytes,
        }


def _not_ported(feature: str, item: str):
    raise NotImplementedError(f"{feature} is not ported to ray_tpu_torch yet (ROADMAP.md, {item})")


def _parent_trace(payload: dict) -> tuple | None:
    """(trace_id, parent span) of the trace context a handoff payload or a
    checkpoint carries, for the receiving engine's telemetry."""
    tr = payload.get("trace")
    return (tr["trace_id"], tr.get("parent_id")) if isinstance(tr, dict) else None


def _prefix_fetch_worker(engine_ref, jobs: queue.SimpleQueue):
    """An engine's fetch worker: drains its prefix-fetch jobs OFF the
    engine lock and off the card (the index call, the object-plane borrow,
    the token check) while step() keeps prefilling and decoding. It holds
    the engine only while a job runs, and ends once the engine is gone, so
    an engine its caller dropped is freed with its pool and weights."""
    while True:
        try:
            job = jobs.get(timeout=1.0)
        except queue.Empty:
            if engine_ref() is None:
                return
            continue
        eng = engine_ref()
        if job is None or eng is None:
            return
        rec, prompt = job
        try:
            eng._run_prefix_fetch(rec, prompt)
        except BaseException:  # noqa: BLE001 — a dying worker would wedge every deferral
            rec["error"] = True
            rec["done"] = True
        del eng


def resolve_device(device) -> torch.device:
    """``None`` means the card; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the host")
        return torch.device("cuda")
    return torch.device(device)


class LLMEngine:
    """Continuous-batching engine over a slot KV cache or a paged pool.

    config: ``models.llama.LlamaConfig``; params: the matching tree (None:
    random weights from ``seed``). ``device=None`` runs on the card and
    raises without one; ``device="cpu"`` runs the kernels' plain versions.
    ``kv_layout``: "slots" (the default) or "paged" (``num_pages`` pages of
    ``page_size`` positions; by default the slots' memory). ``cache_dtype``:
    None (the model's dtype), "bfloat16", "float32" or "int8".
    ``attn_kernel``: None resolves it, "cuda" (K4) for a paged engine on
    the card, "torch" otherwise; naming another raises.
    ``device_resident=True`` (the default) decodes from device-held lanes
    with a one-step-delayed readback, on the card as one CUDA graph
    captured here (``graph_capture_s``); ``False`` is the synchronous loop.
    ``speculative``: a ``spec.SpecConfig`` (device-resident only; the
    round is the captured graph then). ``telemetry`` (on by default) keeps
    the flight recorder and the SLO metrics, tagged with
    ``telemetry_tags`` (model / replica / stage). ``kv_plane``: a
    ``kvplane.KVPlaneClient``, the prefix cache's cluster tier (needs
    ``enable_prefix_caching``); ``prefix_fetch_deadline_s`` bounds how long
    an admission waits for a remote fetch before a local prefill.
    ``mesh``: a pure tp mesh (``parallel.mesh.create_mesh(tp=n, devices=...)``)
    makes this engine rank 0 of n rank processes (module docstring; its
    devices place the ranks, so ``device`` stays None), ``tp_collective``
    the per-layer sum: "fp" or "int8" (device-resident only). ``shutdown``
    stops the ranks.
    """

    def __init__(
        self,
        config,
        params=None,
        *,
        max_num_seqs: int = 8,
        max_seq_len: int | None = None,
        prefill_buckets: tuple | None = None,
        seed: int = 0,
        cache_dtype: str | None = None,
        mesh=None,
        tp_collective: str = "fp",
        enable_prefix_caching: bool = True,
        prefix_cache_bytes: int = 256 << 20,
        prefix_block: int = 64,
        kv_plane=None,
        prefix_fetch_deadline_s: float = 2.0,
        kv_layout: str = "slots",
        num_pages: int | None = None,
        page_size: int = 64,
        attn_kernel: str | None = None,
        device_resident: bool = True,
        batch_prefill: bool = True,
        speculative=None,
        telemetry: bool = True,
        telemetry_tags: dict | None = None,
        device=None,
        _tp_group=None,
    ):
        if kv_layout not in ("slots", "paged"):
            raise ValueError(f"kv_layout must be 'slots' or 'paged', got {kv_layout!r}")
        if speculative is not None and not device_resident:
            raise ValueError(
                "speculative decoding runs on the device-resident loop only "
                "(the plain loop is kept untouched as its equivalence oracle)"
            )
        self._ranks = None
        self._check_mesh(config, mesh, tp_collective, device_resident, speculative, kv_plane, device)
        if kv_plane is not None and not enable_prefix_caching:
            raise ValueError("kv_plane is the prefix cache's cluster tier and needs enable_prefix_caching=True "
                             "(remote hits re-store locally)")
        self.kv_dtype = normalize_cache_dtype(cache_dtype) if cache_dtype is not None else config.dtype
        self.kv_quant = is_int8(self.kv_dtype)

        rank = 0 if _tp_group is None else _tp_group.rank
        self.device = mesh.device_of(rank) if mesh is not None else resolve_device(device)
        paged = kv_layout == "paged"
        # the slot layout has no page gather: plain PyTorch on both devices (ray_tpu's "xla")
        self.attn_kernel = "cuda" if paged and self.device.type == "cuda" else "torch"
        if attn_kernel is not None and attn_kernel != self.attn_kernel:
            raise ValueError(
                f"attn_kernel={attn_kernel!r}: a {kv_layout} engine on {self.device.type} runs its attention "
                f"as {self.attn_kernel!r} (K4 is the paged layout's kernel); pass None"
            )
        self.config = config
        self.kv_layout = kv_layout
        self.max_num_seqs = int(max_num_seqs)
        self.max_seq_len = int(max_seq_len or config.max_seq_len)
        if prefill_buckets is None:
            b, buckets = 64, []
            while b < self.max_seq_len:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_seq_len)
            prefill_buckets = tuple(buckets)
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self._batch_prefill = bool(batch_prefill)
        # tensor parallelism: this rank's model view and its collectives;
        # rank 0 starts the other ranks here (the twins' kwargs: no
        # scheduler-side features, weights from the seed or streamed)
        self._group = _tp_group
        self._mcfg, self._tpc = config, None
        if self.tp > 1:
            if _tp_group is None:
                twin = dict(max_num_seqs=max_num_seqs, max_seq_len=max_seq_len, prefill_buckets=prefill_buckets,
                            seed=seed, cache_dtype=cache_dtype, mesh=mesh, tp_collective=tp_collective,
                            enable_prefix_caching=False, kv_layout=kv_layout, num_pages=num_pages,
                            page_size=page_size, device_resident=device_resident, batch_prefill=batch_prefill,
                            speculative=speculative, telemetry=False,
                            params=None if params is None else "stream")
                self._ranks = Ranks([mesh.device_of(r) for r in range(mesh.size)], (__name__, "_rank_engine"),
                                    args=(config,), kwargs=twin)
                self._finalizer = weakref.finalize(self, close_ranks, self._ranks)
                self._group = self._ranks.group
                if params is not None:
                    _send_shards(self._ranks, params, config, mesh)
            # prefill, extend and the sync loop sum exactly, as ray_tpu's GSPMD
            # programs do; tp_collective is the fused step's and the verify's
            self._mcfg, self._tpc = mr._tp_of(config, mesh, "fp", self._group)
            if params is None:
                params = init_params_shard(config, torch.Generator(device=self.device).manual_seed(seed), mesh, rank)
            elif _tp_group is None:
                params = _tree_to(shard_params(params, config, mesh, 0), self.device)
        elif params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(config, gen)
        self.params = params
        self._prefix_cache = (
            PrefixCache(block=prefix_block, max_bytes=prefix_cache_bytes, shards=self.tp)
            if enable_prefix_caching else None
        )
        # prefix groups rank 0's cache no longer holds (nor any waiting
        # request): the other ranks drop their shards at the next operation
        self._tp_dead_gids: list = []
        # the cluster KV plane (llm/kvplane/): publish stored prefixes, fetch
        # remote hits, unregister on eviction. The remote tier's counters
        # live here (the PrefixCache keeps the local tier's), the full set
        # from the start so prefix_cache_stats() never changes shape.
        self._kv_plane = kv_plane
        self._plane_stats = {
            "hits": 0, "tokens_saved": 0, "fetched_bytes": 0,
            "lost": 0, "published_blocks": 0, "published_bytes": 0,
            "errors": 0, "abandoned": 0,
            "prefetched_blocks": 0, "prefetched_bytes": 0, "prefetch_hits": 0,
        }
        # the asynchronous remote fetch: admission LAUNCHES the lookup and
        # fetch on the fetch worker and keeps planning; the landed result
        # splices in at a later admission. request_id -> in-flight record
        # (filled by the worker, "done" set last); guarded-by: _lock
        self.prefix_fetch_deadline_s = float(prefix_fetch_deadline_s)
        self._fetch_state: dict[str, dict] = {}
        self._fetch_q = None  # SimpleQueue + daemon worker, made on the first launch
        self._fetch_thread = None
        # records abandoned at their deadline, awaiting the worker's terminal
        # resolution: reaped (stats only) at admission and on a stats read
        self._fetch_zombies: list[dict] = []  # guarded-by: _lock
        # boundary keys the prefetcher minted: local hits on them count as
        # prefetch hits
        self._prefetched_keys: set[bytes] = set()  # guarded-by: _lock
        # prefetched blocks (host tensors) waiting for the next admission,
        # which uploads and stores them on the stepping thread
        self._adoptions: list[tuple] = []  # guarded-by: _lock
        # publishes minted under the lock (admission self-heal, the remote
        # fetch's republish, the prefill store), made at the step tail with
        # the lock released: serialization, put_owned and an index call
        self._plane_offers: list[tuple] = []  # guarded-by: _lock
        if kv_plane is not None:
            kv_plane.attach(self)
            self._prefix_cache.evict_hook = kv_plane.on_evict
        B = self.max_num_seqs
        self._admit_counter = 0
        if paged:
            if any(b % page_size for b in self.prefill_buckets):
                raise ValueError(f"page_size {page_size} must divide every prefill bucket {self.prefill_buckets}")
            if prefix_block % page_size:
                raise ValueError(f"page_size {page_size} must divide prefix_block {prefix_block}")
            max_pg = -(-self.max_seq_len // page_size)
            if num_pages is None:
                num_pages = self.max_num_seqs * max_pg + 1  # slot-equivalent memory (+1 trash)
            self._pcfg = pkv.PagedCacheConfig(
                num_layers=config.num_layers,
                num_pages=int(num_pages),
                page_size=int(page_size),
                max_pages_per_seq=max_pg,
                num_slots=self.max_num_seqs,
                num_kv_heads=self._mcfg.num_kv_heads,
                head_dim=config.hd,
                dtype=self.kv_dtype,
            )
            self.pool = pkv.alloc(self._pcfg, self.device)
            self._page_alloc = pkv.PageAllocator(self._pcfg.num_pages)
            self._tables = np.zeros((B, max_pg), np.int32)
            self._lengths = np.zeros((B,), np.int32)
            self._slot_pages: list[list[int]] = [[] for _ in range(B)]
        else:
            # the lengths live in the cache (``cache["length"]``), on the device
            self.cache = kvc.alloc(kvc.CacheConfig(
                num_layers=config.num_layers,
                num_slots=B,
                max_seq_len=self.max_seq_len,
                num_kv_heads=self._mcfg.num_kv_heads,
                head_dim=config.hd,
                dtype=self.kv_dtype,
            ), self.device)

        # per-lane sampling state (host shadows of the device lanes); a
        # seedless lane's key starts as PRNGKey(slot), as in ray_tpu
        self._temps = np.zeros((B,), np.float32)
        self._top_k = np.zeros((B,), np.int64)
        self._top_p = np.ones((B,), np.float32)
        self._keys = torch.stack([prng.prng_key(s) for s in range(B)]).numpy()  # [B, 2] uint32 words in int64
        self._next_tokens = np.zeros((B,), np.int64)

        self._slots: list[RequestState | None] = [None] * B
        self._waiting: deque[RequestState] = deque()
        self._requests: dict[str, RequestState] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._auto_id = 0
        self.preemption_count = 0
        # disaggregation and migration (llm/disagg/, llm/migrate.py): the
        # extract and scatter-in functions of both layouts, the finished
        # prefill-only requests' payloads awaiting pop_handoff, and the
        # suspended conversations (request_id -> {"state", "nbytes", "t"})
        (self._extract_slots, self._extract_paged,
         self._scatter_slots, self._scatter_paged) = make_handoff_fns()
        self._handoffs: dict[str, dict] = {}  # guarded-by: _lock
        self._suspended: dict[str, dict] = {}  # guarded-by: _lock
        self._suspend_stats = {"suspended": 0, "resumed": 0, "spilled_bytes": 0, "dropped": 0}
        # suspends whose object-plane publish failed (the host copy kept)
        self.suspend_publish_errors = 0
        # forwards run (callers match kernel launch counts against them)
        # and host seconds spent in each stage; both stages end in a host
        # read of sampled tokens, so on the card these include device time
        self.prefill_forwards = 0
        self.extend_forwards = 0  # prefix-cache hits' suffix forwards (K4 over the prefix)
        self.decode_steps = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0

        self._device_resident = bool(device_resident)
        # the dispatched step awaiting its readback: (handle, [(RequestState, slot[, k_eff]), ...])
        self._pending = None
        self.graph_capture_s = 0.0
        self._spec_cfg = None
        if self._device_resident:
            self._set_lane, self._set_table, self._set_table_cell = mr.make_delta_fns()
            lanes = dict(tokens=self._next_tokens, keys=self._keys, temps=self._temps, top_k=self._top_k,
                         top_p=self._top_p)
            if paged:
                lanes.update(tables=self._tables, lengths=self._lengths)
            lanes = {name: torch.from_numpy(a.copy()).to(self.device) for name, a in lanes.items()}
            # the device-resident decode state; the host arrays above stay as
            # the scheduler's shadows (never re-uploaded wholesale)
            if paged:
                self._dtables, self._dlengths = lanes["tables"], lanes["lengths"]
            self._dtokens, self._dkeys = lanes["tokens"], lanes["keys"]
            self._dtemps, self._dtopk, self._dtopp = lanes["temps"], lanes["top_k"], lanes["top_p"]
            tp_kw = dict(mesh=mesh, tp_collective=tp_collective, kv_quant=self.kv_quant, group=self._group)
            if speculative is not None:
                step = self._init_spec(speculative, lanes)
            elif paged:
                self._fused_attn, self._fused_append = mr.make_fused_paged_fns(config, self.attn_kernel, **tp_kw)
                step = PagedStep(self._fused_attn, self._fused_append)
            else:
                # the engine is fresh: the capture's warm-up writes position 0 of
                # every slot, which each admission's insert_sequence overwrites
                self._fused_step = mr.make_fused_fns(config, **tp_kw)
                step = SlotStep(self._fused_step)
            # no capture at tp > 1: the step's gloo collectives cannot be captured
            self._decode = FusedDecode(step, self.params, self.kv, lanes, capture=self.tp == 1)
            self.graph_capture_s = self._decode.capture_s
        # serving telemetry (llm/telemetry.py): flight recorder, live SLO
        # metrics, request-lifecycle tracing, from host state only;
        # telemetry=False opts the whole plane out
        self._last_spec_drain = None
        self._step_emitted = 0
        self._tel = None
        # the wire bytes of the last decode step's collectives (rank 0's count)
        self.tp_wire_step_bytes = 0.0
        if telemetry:
            from ray_tpu_torch.llm.telemetry import EngineTelemetry

            self._tel = EngineTelemetry(self, telemetry_tags)
            self._tel.register_fused_entries()
        if self._ranks is not None:
            self._ranks.wait_ready()

    # ------------------------------------------------- tensor parallelism
    def _check_mesh(self, config, mesh, tp_collective, device_resident, speculative, kv_plane, device):
        """ray_tpu's mesh checks and messages, before any rank starts:
        ``self.mesh``, ``self.tp``, ``self.tp_collective`` and ``_tp_fused``
        (a pure tp>=2 mesh on the device-resident loop)."""
        if tp_collective not in ("fp", "int8"):
            raise ValueError(f"tp_collective must be 'fp' or 'int8', got {tp_collective!r}")
        self.mesh = mesh
        self.tp_collective = tp_collective
        self.tp = axis_size(mesh, "tp") if mesh is not None else 1
        if mesh is not None:
            for dim, name, what in (
                (config.num_kv_heads, "num_kv_heads", "the KV cache; pick tp from the divisors of num_kv_heads"),
                (config.num_heads, "num_heads", "the attention projections (wq/wo split by head)"),
                (config.intermediate_size, "intermediate_size",
                 "the MLP (w_gate/w_up/w_down split on the hidden dim); pad it to a multiple of tp"),
                (config.vocab_size, "vocab_size",
                 "the embed/unembed tables and the logits gather; pad the vocab to a multiple of tp"),
            ):
                if dim % self.tp:
                    raise ValueError(f"{name} ({dim}) must divide by tp ({self.tp}) to shard {what}")
        self._tp_fused = mesh is not None and is_tp_only(mesh) and self.tp > 1 and bool(device_resident)
        if tp_collective == "int8" and not self._tp_fused:
            raise ValueError(
                "tp_collective='int8' quantizes the explicit per-layer all-reduce, which only exists on the "
                "device-resident fused path over a pure tp>=2 mesh (got mesh=%s, device_resident=%s)"
                % (getattr(mesh, "axis_names", None), device_resident))
        if self._tp_fused and tp_collective == "int8" and config.hidden_size % self.tp:
            raise ValueError(f"hidden_size ({config.hidden_size}) must divide by tp ({self.tp}) to chunk the int8 "
                             "quantized all-reduce payload; use tp_collective='fp'")
        if mesh is None:
            return
        if not is_tp_only(mesh):
            _not_ported(f"a serving mesh with axes {tuple(mesh.axis_names)} (any axis besides tp; ray_tpu runs it "
                        "through GSPMD)", "queue 1, multi-device axes")
        if speculative is not None and not self._tp_fused:
            raise ValueError("speculative decoding over a mesh needs the fused path (a pure tp>=2 mesh); got axes "
                             f"{tuple(mesh.axis_names)}")
        if speculative is not None and getattr(speculative, "drafter", None) == "model":
            raise NotImplementedError(
                "drafter 'model' does not support tensor-parallel meshes: the draft model's params/KV cache and "
                "its fused draft_steps chain are not sharded over tp; use the zero-weight drafter='ngram' (its "
                "proposal lanes are whole on every rank)")
        if kv_plane is not None:
            _not_ported("the KV plane on a tensor-parallel engine", "queue 1, multi-device axes")
        if device is not None and _indexed(torch.device(device)) != mesh.device_of(0):
            raise ValueError(f"device={device!r} and mesh={mesh!r}: the mesh places the ranks; pass device=None")

    def _no_tp(self, what: str):
        if self.tp > 1:
            _not_ported(f"{what} on a tensor-parallel engine", "queue 1, multi-device axes")

    def _do(self, op: str, *args):
        """One device operation: sent to the other ranks (tp > 1) with its
        host arguments, then run here; returns this rank's result."""
        if self._ranks is None:
            return getattr(self, "_op_" + op)(*args)
        self._tp_send("_op_" + op, *args)
        try:
            return getattr(self, "_op_" + op)(*args)
        except Exception as exc:
            self._ranks.failed(exc)  # a dead peer's collective: name the rank
            raise

    def _tp_send(self, op: str, *args):
        if self._tp_dead_gids:
            dead = []
            while self._tp_dead_gids:  # a finalizer may append meanwhile (any thread)
                dead.append(self._tp_dead_gids.pop())
            self._ranks.send("_rop_prefix_drop", dead)
        self._ranks.send(op, *args)

    def tp_call(self, module: str, name: str, *args) -> list:
        """``module.name(engine, *args)`` in every rank at once, ``engine``
        the rank's own (this one in rank 0), and the results in rank order
        (one at tp = 1). For probes that must run in each rank's process:
        its launch counts, its memory, its kernels at its shapes, or a
        forward that holds the group's collectives."""
        if self._ranks is not None:
            self._tp_send("_rop_call", module, name, args)
        mine = self._rop_call(module, name, args)
        return [mine] + ([] if self._ranks is None else self._ranks.call("_rop_called"))

    def _rop_call(self, module: str, name: str, args):
        import importlib

        self._called = getattr(importlib.import_module(module), name)(self, *args)
        return self._called

    def _rop_called(self):
        out, self._called = self._called, None
        return out

    @property
    def tp_pids(self) -> list:
        """The other ranks' process ids ([] at tp = 1)."""
        return [] if self._ranks is None else self._ranks.pids

    def shutdown(self) -> None:
        """Stop the rank processes (tp > 1; nothing else to release). The
        engine cannot step after it. Idempotent."""
        if self._ranks is not None:
            self._finalizer()

    def _op_prefill(self, toks, lens):
        """A bucket's batched prefill forward; this rank keeps its K/V for
        the inserts and prefix stores that follow (``_op_end_prefill``)."""
        dev = self.device
        logits, ks, vs = mr.prefill(self.params, torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
                                    self._mcfg, self._tpc)
        self._last_prefill = (ks, vs)
        return logits, ks, vs

    def _op_end_prefill(self):
        self._last_prefill = None

    def _op_insert_pages(self, row, i: int):
        ks, vs = self._last_prefill
        pkv.insert_pages(self.pool, torch.from_numpy(row).to(self.device), ks[:, i], vs[:, i])

    def _op_insert_sequence(self, slot: int, i: int, n: int):
        ks, vs = self._last_prefill
        # device writes only (a copy and a length fill), stream-ordered after the step in flight
        kvc.insert_sequence(self.cache, slot, ks[:, i], vs[:, i], n)

    def _op_hit_paged(self, kv, row, n_p: int, toks, m: int):
        """A paged prefix hit: insert the prefix's first n_p positions into
        the row's first pages, then extend the suffix over them."""
        k_p, v_p, k_sc, v_sc = kv
        dev = self.device
        row = torch.from_numpy(row).to(dev)
        scales = () if k_sc is None else (k_sc[:, :, :n_p], v_sc[:, :, :n_p])
        pkv.insert_pages(self.pool, row[: n_p // self._pcfg.page_size], k_p[:, :n_p], v_p[:, :n_p], *scales)
        logits, self.pool = mr.extend_paged(self.params, self.pool, row, n_p, torch.from_numpy(toks).to(dev), m,
                                            self._mcfg, self._tpc)
        return logits

    def _op_hit_slots(self, kv, slot: int, n_p: int, toks, m: int):
        """A slot prefix hit: insert the cached group, then extend the suffix."""
        k_p, v_p, k_sc, v_sc = kv
        kvc.insert_sequence(self.cache, slot, k_p, v_p, n_p, k_sc, v_sc)
        logits, self.cache = mr.extend(self.params, self.cache, slot, torch.from_numpy(toks).to(self.device), m,
                                       self._mcfg, self._tpc)
        return logits

    def _op_set_lane(self, slot: int, token: int, key, temp: float, tk: int, tp: float):
        self._set_lane(self._dtokens, self._dkeys, self._dtemps, self._dtopk, self._dtopp, slot, token, key, temp,
                       tk, tp)

    def _op_set_table(self, slot: int, row, length: int):
        row = torch.from_numpy(row)
        if self.device.type == "cuda":
            row = row.pin_memory()  # copied without blocking the host
        self._set_table(self._dtables, self._dlengths, slot, row, length)

    def _op_set_table_cell(self, slot: int, pg_ix: int, page: int):
        self._set_table_cell(self._dtables, slot, pg_ix, page)

    def _op_set_slot_scalar(self, slot: int, val: int):
        self._set_slot_scalar(self._dspec_k, slot, val)

    def _op_spec_admit(self, slot: int, row, n: int, k0: int, hist: list):
        row = torch.from_numpy(row)
        if self.device.type == "cuda":
            row = row.pin_memory()  # copied without blocking the host
        self._set_hist(self._dhist, self._dhist_len, self._dspec_k, slot, row, n, k0)
        # the drafter caches everything the target has cached: the full
        # admitted prompt, NOT the fresh token (the first chain input)
        self._drafter.admit(slot, hist)

    def _op_step(self):
        """The decode step or spec round (a graph replay at tp = 1 on the card)."""
        return self._decode.step(self.params, self.kv)

    def _op_sync_decode(self, tokens, tables, lengths, keys, temps, top_k, top_p):
        """The synchronous loop's step from uploaded lanes: attention then
        append, and the sample on every rank. Returns (tokens, logprobs,
        keys) on the device."""
        dev = self.device
        tokens = torch.from_numpy(tokens).to(dev)
        if self.kv_layout == "paged":
            logits, self.pool, _ = mr.decode_step_paged(self.params, self.pool, torch.from_numpy(tables).to(dev),
                                                        torch.from_numpy(lengths).to(dev), tokens, self._mcfg,
                                                        self._tpc)
        else:
            logits, self.cache = mr.decode_step(self.params, self.cache, tokens, self._mcfg, self._tpc)
        return sample(logits, *(torch.from_numpy(a).to(dev) for a in (keys, temps, top_k, top_p)))

    # the other ranks' halves of rank 0's prefix cache: the group's shards by id
    def _rop_prefix_store(self, gid: int, i: int, pad: int):
        ks, vs = self._last_prefill
        self._tp_prefix = getattr(self, "_tp_prefix", {})
        self._tp_prefix[gid] = tuple(t[:, i, :pad].clone(memory_format=torch.contiguous_format) for t in (ks, vs))

    def _rop_prefix_drop(self, gids: list):
        for gid in gids:
            self._tp_prefix.pop(gid, None)

    def _rop_hit_paged(self, gid: int, row, n_p: int, toks, m: int):
        self._op_hit_paged(self._tp_prefix[gid] + (None, None), row, n_p, toks, m)

    def _rop_hit_slots(self, gid: int, slot: int, n_p: int, toks, m: int):
        self._op_hit_slots(self._tp_prefix[gid] + (None, None), slot, n_p, toks, m)

    def _init_spec(self, spec_cfg, lanes: dict):
        """Speculative decoding state: drafter, adaptive-k controller,
        the device history and effective-k lanes (added to ``lanes``), and
        the spec round's step for this KV layout (``llm/spec/``)."""
        from ray_tpu_torch.llm.spec import verify as specv
        from ray_tpu_torch.llm.spec.controller import AdaptiveKController, SpecConfig
        from ray_tpu_torch.llm.spec.drafter import ModelDrafter, NGramDrafter

        if not isinstance(spec_cfg, SpecConfig):
            raise TypeError(f"speculative must be a llm.spec.SpecConfig, got {type(spec_cfg).__name__}")
        self._spec_cfg = spec_cfg
        B, k = self.max_num_seqs, spec_cfg.k
        if spec_cfg.drafter == "model":
            dcfg = spec_cfg.draft_config
            if dcfg is None:
                raise ValueError("drafter='model' needs SpecConfig.draft_config (a smaller LlamaConfig)")
            if dcfg.vocab_size != self.config.vocab_size:
                raise ValueError(
                    f"draft vocab ({dcfg.vocab_size}) must match the target's ({self.config.vocab_size})"
                )
            self._drafter = ModelDrafter(dcfg, params=spec_cfg.draft_params, k=k, seed=spec_cfg.draft_seed,
                                         device=self.device)
        else:
            self._drafter = NGramDrafter(k=k, n=spec_cfg.ngram)
        if self.mesh is not None and not self._drafter.supports_mesh:
            raise NotImplementedError(f"drafter '{self._drafter.kind}' does not support tensor-parallel meshes")
        self._drafter.init_slots(B, self.max_seq_len, self.prefill_buckets, self.device)
        self._controller = AdaptiveKController(spec_cfg)
        # token-history lanes: prompt + everything emitted on the device, one
        # round AHEAD of host emission (the drafter's matching corpus); +k+1
        # headroom so trailing-round writes never wrap
        self._spec_hist_width = self.max_seq_len + k + 1
        self._dhist = specv.spec_hist_buffer(B, self._spec_hist_width, self.device)
        self._dhist_len = torch.zeros((B,), dtype=torch.int64, device=self.device)
        self._dspec_k = torch.full((B,), k, dtype=torch.int64, device=self.device)
        self._lane_k = np.full((B,), k, np.int32)  # host mirror, updated with the device lane
        lanes.update(hist=self._dhist, hist_len=self._dhist_len, spec_k=self._dspec_k)
        self._set_hist, self._set_slot_scalar = specv.set_hist_row, specv.set_slot_scalar
        self._spec_rounds = self._spec_lane_rounds = 0
        self._spec_proposed = self._spec_accepted = self._spec_emitted = 0
        tp_kw = dict(mesh=self.mesh, tp_collective=self.tp_collective, kv_quant=self.kv_quant, group=self._group)
        if self.kv_layout == "paged":
            self._verify_attn, self._verify_append = specv.make_spec_verify_paged(self.config, self.attn_kernel,
                                                                                  **tp_kw)
            return SpecPagedStep(self._drafter, self._verify_attn, self._verify_append)
        self._verify_step = specv.make_spec_verify_slots(self.config, **tp_kw)
        # as the slot decode step's: the warm-up's block writes land at and
        # past each fresh slot's length 0, where admissions insert first
        return SpecSlotStep(self._drafter, self._verify_step)

    def spec_stats(self) -> dict:
        """Speculation counters (empty when speculative decoding is off):
        verify rounds, proposed/accepted totals, acceptance-rate and
        tokens-per-round means, and each live request's effective k."""
        with self._lock:
            if self._spec_cfg is None:
                return {}
            return {
                "drafter": self._drafter.kind,
                "k": self._spec_cfg.k,
                "rounds": self._spec_rounds,
                "lane_rounds": self._spec_lane_rounds,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "emitted": self._spec_emitted,
                "acceptance_rate": self._spec_accepted / max(self._spec_proposed, 1),
                # per LANE per round: the per-sequence tokens/step multiplier
                "mean_tokens_per_round": self._spec_emitted / max(self._spec_lane_rounds, 1),
                "k_per_request": {
                    rid: kk for rid, kk in self._controller.current().items() if rid in self._requests
                },
            }

    def telemetry(self) -> dict:
        """Flight-recorder snapshot (``llm/telemetry.py``): the per-step
        ring (phase, wall ms, occupancy, queue depth, spec accounting,
        recompile sentinel), finished-request lifecycle records (TTFT /
        queue-wait / per-token ITL samples), recompile counts, tags. Empty
        dict when the engine was built with telemetry=False."""
        if self._tel is None:
            return {}
        return self._tel.snapshot()

    @property
    def kv(self) -> dict:
        """The KV state the decode step reads: the pool or the slot cache."""
        return self.pool if self.kv_layout == "paged" else self.cache

    # ------------------------------------------------------------- admission
    def add_request(self, prompt_token_ids, params: SamplingParams | None = None,
                    request_id: str | None = None, stream: bool = False, out_queue=None,
                    submitted_at: float | None = None) -> str:
        """``submitted_at`` (time.time()) backdates the telemetry clock to
        the true ingress arrival when a front-end queued the request before
        admitting it here."""
        params = params or SamplingParams()
        with self._lock:
            if request_id is None:
                request_id = f"req-{self._auto_id}"
                self._auto_id += 1
            if not prompt_token_ids:
                raise ValueError("prompt_token_ids is empty: a request needs at least one prompt token")
            if len(prompt_token_ids) + params.max_tokens > self.max_seq_len:
                raise ValueError(
                    f"prompt ({len(prompt_token_ids)}) + max_tokens ({params.max_tokens}) "
                    f"exceeds max_seq_len ({self.max_seq_len})"
                )
            T = _bucket(len(prompt_token_ids), self.prefill_buckets)
            if self.kv_layout == "paged":
                need = min(T // self._pcfg.page_size + 1, self._pcfg.max_pages_per_seq)
                if need > self._pcfg.num_pages - 1:
                    raise ValueError(
                        f"prompt needs {need} pages but the pool has {self._pcfg.num_pages - 1}; raise num_pages")
            st = RequestState(request_id, list(prompt_token_ids), params)
            if stream or out_queue is not None:
                st.out_queue = out_queue if out_queue is not None else queue.SimpleQueue()
            if self._tel is not None:
                self._tel.on_submit(st, submitted_at)
            self._requests[request_id] = st
            self._waiting.append(st)
            return request_id

    def abort_request(self, request_id: str) -> bool:
        with self._lock:
            st = self._requests.get(request_id)
            if st is None or st.finished:
                return False
            self._finish(st, "aborted")
            return True

    def has_unfinished(self) -> bool:
        with self._lock:
            return bool(self._waiting) or any(s is not None for s in self._slots) or self._pending is not None

    @property
    def num_waiting(self) -> int:
        return len(self._waiting)

    @property
    def num_running(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def host_load(self) -> dict:
        """Load snapshot for admission control (``serve/overload.py``):
        queue depth, slot occupancy, occupied/queued/capacity tokens, all
        host scheduler shadow state read under the lock. No device tensor
        is read: the paged layout's occupancy comes from the host shadow
        lengths (the graph engine keeps its own on the card). Queued
        demand counts each waiting request's prompt + max_tokens, so the
        caps bound BACKLOG, not just live occupancy; a preempted request
        requeued keeps prompt + max_tokens (its generated tokens are part
        of that budget)."""
        with self._lock:
            waiting = len(self._waiting)
            queued_tokens = 0
            queued_gen_tokens = 0
            for st in self._waiting:
                queued_tokens += len(st.prompt_token_ids) + st.params.max_tokens
                queued_gen_tokens += st.params.max_tokens
            slots_in_use = sum(1 for s in self._slots if s is not None)
            if self.kv_layout == "paged":
                occupied = int(self._lengths.sum())
                capacity = (self._pcfg.num_pages - 1) * self._pcfg.page_size
            else:
                occupied = sum(len(s.prompt_token_ids) + len(s.token_ids) for s in self._slots if s is not None)
                capacity = self.max_num_seqs * self.max_seq_len
        return {
            "queue_depth": waiting,
            "queued_tokens": queued_tokens,
            "queued_gen_tokens": queued_gen_tokens,
            "slots_in_use": slots_in_use,
            "slots_total": self.max_num_seqs,
            "occupied_tokens": occupied,
            "capacity_tokens": capacity,
        }

    def prefix_cache_stats(self) -> dict:
        """Prefix-reuse accounting: the local cache's counters (hits,
        misses, tokens_saved, evictions, entries, bytes) and the same hits
        as the ``local`` tier; with a KV plane also the ``remote`` tier
        (blocks fetched over the object plane: hits, tokens_saved,
        fetched_bytes, lost, published_*, ...) and the plane client's own
        counters under ``plane``. ``{}`` when prefix caching is off."""
        with self._lock:
            if self._prefix_cache is None:
                return {}
            self._reap_fetch_zombies_locked()
            out = self._prefix_cache.stats()
            out["local"] = {"hits": out["hits"], "tokens_saved": out["tokens_saved"]}
            if self._kv_plane is not None:
                out["remote"] = dict(self._plane_stats, inflight_fetches=len(self._fetch_state))
                out["plane"] = self._kv_plane.stats()
            return out

    def kv_cache_stats(self) -> dict:
        """KV-cache accounting: dtype and layout, bytes/token (int8 scales
        included), allocated vs occupied bytes, slot (and page) occupancy,
        and which attention implementation runs ("cuda" = K4 on the card,
        "torch" = plain PyTorch: K4's plain version on the host, the slot
        layout's attention on either device)."""
        cfg = self.config
        per_tok = bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd, self.kv_dtype)
        with self._lock:
            # the whole cache's bytes over every rank's kv heads (ray_tpu's sharded nbytes)
            allocated = self.tp * int(sum(t.numel() * t.element_size() for name, t in self.kv.items()
                                          if name != "length"))
            out = {
                "layout": self.kv_layout,
                "dtype": self.kv_dtype,
                "quantized": self.kv_quant,
                "attn_kernel": self.attn_kernel,
                "bytes_per_token": int(per_tok),
                "allocated_bytes": allocated,
                "slots_total": self.max_num_seqs,
                "slots_in_use": sum(1 for s in self._slots if s is not None),
            }
            if self.kv_layout == "paged":
                occupied = int(self._lengths.sum())  # host shadow lengths, no device read
                out["page_size"] = self._pcfg.page_size
                out["pages_total"] = self._pcfg.num_pages - 1  # page 0 = trash
                out["pages_free"] = self._page_alloc.free_pages
            else:
                occupied = sum(len(s.prompt_token_ids) + len(s.token_ids) for s in self._slots if s is not None)
            out["occupied_tokens"] = occupied
            out["occupied_bytes"] = occupied * int(per_tok)
            return out

    # ------------------------------------------- prefill/decode disaggregation
    def add_prefill_request(self, prompt_token_ids, request_id: str | None = None,
                            submitted_at: float | None = None) -> str:
        """PREFILL-ONLY admission (disaggregated serving, ``llm/disagg/``).

        The request rides the normal admission and prefill stages, batched
        into the same bucketed forwards as everything else admitted that
        step, prefix-cache reuse included, then finishes with reason
        "handoff": its KV block is extracted into contiguous host tensors
        and stashed for ``pop_handoff``, and the slot and pages recycle at
        once. It never decodes."""
        self._no_tp("prefill-only requests (handoff)")
        with self._lock:
            if request_id is None:
                request_id = f"req-{self._auto_id}"
                self._auto_id += 1
            n = len(prompt_token_ids)
            if not 0 < n <= self.prefill_buckets[-1]:
                raise ValueError(f"prompt length {n} outside prefill buckets (max {self.prefill_buckets[-1]})")
            if self.kv_layout == "paged":
                T = _bucket(n, self.prefill_buckets)
                need = min(T // self._pcfg.page_size + 1, self._pcfg.max_pages_per_seq)
                if need > self._pcfg.num_pages - 1:
                    raise ValueError(
                        f"prompt needs {need} pages but the pool has {self._pcfg.num_pages - 1}; raise num_pages")
            st = RequestState(request_id, list(prompt_token_ids), SamplingParams(max_tokens=1), prefill_only=True)
            if self._tel is not None:
                self._tel.on_submit(st, submitted_at)
            self._requests[request_id] = st
            self._waiting.append(st)
            return request_id

    def pop_handoff(self, request_id: str) -> dict | None:
        """Claim a finished prefill-only request's handoff payload (None
        until the prefill stage has run it): ``add_prefilled``'s input, k/v
        [L, T_pad, kv, hd] host tensors at the prompt's bucket width (with
        k_scale/v_scale [L, kv, T_pad] from an int8 cache), n, the
        first-token logits, prompt_token_ids."""
        with self._lock:
            return self._handoffs.pop(request_id, None)

    def prefill_handoff(self, prompt_token_ids, submitted_at: float | None = None) -> dict:
        """Blocking convenience for single-threaded drivers: admit a
        prefill-only request and step until its handoff is ready.
        ``submitted_at`` backdates the telemetry clock to the true ingress
        arrival (it rides the handoff, so the decode side's TTFT spans the
        whole pipeline)."""
        rid = self.add_prefill_request(prompt_token_ids, submitted_at=submitted_at)
        while True:
            outs = self.step()
            kv = self.pop_handoff(rid)
            if kv is not None:
                return kv
            for o in outs:
                if o.request_id == rid and o.finished:
                    raise RuntimeError(f"prefill-only request failed: {o.finish_reason}")

    def prefill_remote(self, prompt_token_ids) -> dict:
        """Prefill-only, outside the scheduler: one B = 1 forward of the
        prompt, returned as a handoff payload of host tensors (k/v at the
        prompt's bucket width, n, logits, prompt_token_ids)."""
        self._no_tp("prefill_remote (handoff)")
        n = len(prompt_token_ids)
        T = _bucket(n, self.prefill_buckets)
        toks = np.zeros((1, T), np.int64)
        toks[0, :n] = prompt_token_ids
        logits, ks, vs = mr.prefill(self.params, torch.from_numpy(toks).to(self.device),
                                    torch.tensor([n], device=self.device), self.config)
        self.prefill_forwards += 1
        return {
            "k": ks[:, 0].cpu(),
            "v": vs[:, 0].cpu(),
            "n": n,
            "logits": logits[0].float().cpu(),
            "prompt_token_ids": list(prompt_token_ids),
        }

    def add_prefilled(self, kv: dict, params: SamplingParams | None = None, request_id: str | None = None,
                      stream: bool = False, out_queue=None) -> str:
        """Admit a sequence whose prefill ran on another engine (a handoff
        payload): its block is scattered into this engine's cache or pages
        in place, its first token sampled from the shipped logits, and
        decoding starts without touching the prompt again. A block of
        another cache dtype is requantized on the way in."""
        self._no_tp("add_prefilled (handoff)")
        params = params or SamplingParams()
        with self._lock:
            if request_id is None:
                request_id = f"req-{self._auto_id}"
                self._auto_id += 1
            prompt = list(kv["prompt_token_ids"])
            if len(prompt) + params.max_tokens > self.max_seq_len:
                raise ValueError(
                    f"prompt ({len(prompt)}) + max_tokens ({params.max_tokens}) "
                    f"exceeds max_seq_len ({self.max_seq_len})"
                )
            st = RequestState(request_id, prompt, params, prefilled=kv)
            if stream or out_queue is not None:
                st.out_queue = out_queue if out_queue is not None else queue.SimpleQueue()
            if self._tel is not None:
                # the payload carries the ORIGINAL submit stamp and trace
                # context: TTFT spans the pipeline, one trace both engines
                self._tel.on_submit(st, kv.get("submitted_at"), parent_trace=_parent_trace(kv))
            self._requests[request_id] = st
            self._waiting.append(st)
            return request_id

    def release_handoffs(self) -> int:
        """Drop every stashed (never popped) handoff payload; returns how
        many were dropped. A draining replica calls this once admission
        stops, so the host tensors do not outlive their consumers."""
        with self._lock:
            n = len(self._handoffs)
            self._handoffs.clear()
            return n

    # ------------------------------------------------------- live migration
    def checkpoint_request(self, request_id: str) -> dict:
        """One in-flight request's COMPLETE resumable state
        (``llm/migrate.py``): the KV block over every attended position
        (an int8 cache ships int8 values and wire scales), the emitted
        tokens and logprobs, the lane's live PRNG key, the sampling
        parameters and the spec controller's (ema, k). A peer's
        ``restore_request`` continues the stream token for token.

        The step in flight drains FIRST, so the checkpoint holds every
        token the device has minted and the lane's advanced key. It is a
        snapshot: the request runs on here until ``finish_migrated``.
        Raises MigrationError for state that cannot move: an unknown or
        finished request, a prefill-only one, a streaming one, or a
        WAITING sampled request with generated tokens (its live key
        existed only on a bound lane)."""
        self._no_tp("checkpoint_request (migration)")
        with self._lock:
            return self._checkpoint_locked(request_id)

    def _checkpoint_locked(self, request_id: str) -> dict:  # holds-lock: _lock
        """checkpoint_request's body, shared with suspend_request, which
        checkpoints and retires under one acquisition of the lock."""
        st = self._requests.get(request_id)
        if st is None or st.finished:
            raise mig.MigrationError(f"request {request_id!r} is not in flight")
        if st.prefill_only:
            raise mig.MigrationError("prefill-only requests hand off, they do not migrate")
        if st.out_queue is not None:
            raise mig.MigrationError("streaming requests cannot migrate (the consumer holds a live token queue)")
        if self._device_resident and self._pending is not None:
            prev, self._pending = self._pending, None
            (self._drain_spec if self._spec_cfg is not None else self._drain)(prev)
            if st.finished:
                raise mig.MigrationError(f"request {request_id!r} finished while settling the in-flight step")
        p = st.params
        state: dict = {
            "kind": mig.LIVE_KIND,
            "prompt_token_ids": list(st.prompt_token_ids),
            "emitted_token_ids": list(st.token_ids),
            "emitted_logprobs": [float(x) for x in st.logprobs],
            "sampling": mig._sampling_to_wire(p),
            "spec": None,
        }
        if st.t_submit:
            state["submitted_at"] = float(st.t_submit)
        if st.trace is not None:
            state["trace"] = {"trace_id": st.trace[0], "parent_id": st.trace[1]}
        if self._spec_cfg is not None:
            exp = self._controller.export(request_id)
            if exp is not None:
                state["spec"] = {"ema": exp[0], "k": int(exp[1])}
        if st.slot < 0:
            # COLD checkpoint: the request waits (queued or recompute-
            # preempted), with no bound lane and no live KV or key; the
            # peer re-admits prompt + generated as a recompute preemption
            if st.token_ids and p.temperature > 0.0:
                raise mig.MigrationError(
                    "cannot cold-checkpoint a sampled request with generated tokens "
                    "(its live PRNG key exists only on a bound lane); a re-prefill is "
                    "the token-identical fallback"
                )
            if self._tel is not None:
                self._tel.on_migration("checkpointed", 0)
            return state
        slot = st.slot
        n = len(st.prompt_token_ids) + len(st.token_ids) - 1
        # the authoritative length must agree with the host's view before
        # the block can claim to cover n positions
        l_auth = int(self._lengths[slot]) if self.kv_layout == "paged" else int(self.cache["length"][slot])
        if l_auth != n:
            raise mig.MigrationError(f"inconsistent decode state for {request_id!r}: cache length {l_auth} != "
                                     f"prompt + emitted - 1 = {n}")
        out = self._extract_block(slot, _bucket(n, self.prefill_buckets))
        state.update(k=out[0], v=out[1], n=n)
        if len(out) == 4:
            state.update(k_scale=out[2], v_scale=out[3])
        # the LIVE key: the device-resident loop advances it on the device
        # (seeded lanes included), the sync loop on the host
        lane_key = self._dkeys[slot].cpu().numpy() if self._device_resident else self._keys[slot]
        state["rng_key"] = mig.key_to_wire(lane_key)
        if self._tel is not None:
            self._tel.on_migration("checkpointed", mig.state_nbytes(state))
        return state

    def _extract_block(self, slot: int, T: int) -> tuple:
        """A bound slot's first T positions as host tensors: (k, v) or, from
        an int8 cache, (k, v, k_scale, v_scale). The paged table cells past
        the allocated pages are 0 (trash): that tail is garbage the
        consumer masks by length."""
        if self.kv_layout == "paged":
            row = torch.from_numpy(self._tables[slot, : T // self._pcfg.page_size].copy()).to(self.device)
            out = self._extract_paged(self.pool, row)
        else:
            out = self._extract_slots(self.cache, slot, T)
        return tuple(t.cpu() for t in out)

    def finish_migrated(self, request_id: str) -> bool:
        """Finish a checkpointed request here with reason "migrated" (its
        continuation lives on a peer now): the slot and pages recycle, the
        spec state drops, a stream consumer gets its sentinel."""
        with self._lock:
            st = self._requests.get(request_id)
            if st is None or st.finished:
                return False
            self._finish(st, "migrated")
            return True

    def restore_request(self, state, request_id: str | None = None, stream: bool = False, out_queue=None) -> str:
        """Splice a checkpointed request into THIS engine and continue its
        stream token for token (``llm/migrate.py``). ``state`` is a
        live_state dict (``migrate.decode``'s product, or a checkpoint
        handed over in the process), or an ObjectRef off the object plane
        (``migrate.publish``), fetched and decoded here under the bounded
        retry (MigrationLostError when it is gone).

        A HOT checkpoint's block scatters in through the transferred-KV
        admission (requantized across cache dtypes), then ``_bind_resume``
        rebinds the lane from the checkpoint and emits NOTHING. A COLD one
        re-admits prompt + generated like a recompute preemption. Raises
        MigrationError when the state does not fit this engine's geometry."""
        self._no_tp("restore_request (migration)")
        if not isinstance(state, dict):
            state = mig.fetch(state)
        mig.check_state(state)
        params = mig.params_of(state)
        prompt = [int(t) for t in state["prompt_token_ids"]]
        emitted = [int(t) for t in state["emitted_token_ids"]]
        hot = state.get("k") is not None
        with self._lock:
            if request_id is None:
                request_id = f"req-{self._auto_id}"
                self._auto_id += 1
            if len(prompt) + params.max_tokens > self.max_seq_len:
                raise mig.MigrationError(f"prompt ({len(prompt)}) + max_tokens ({params.max_tokens}) exceeds this "
                                         f"engine's max_seq_len ({self.max_seq_len})")
            st = RequestState(request_id, prompt, params)
            st.token_ids = list(emitted)
            st.logprobs = [float(x) for x in state.get("emitted_logprobs", [])]
            st.t_restore = time.time()
            if stream or out_queue is not None:
                st.out_queue = out_queue if out_queue is not None else queue.SimpleQueue()
            nbytes = 0
            if hot:
                T_pad = int(state["k"].shape[1])
                if T_pad > self.max_seq_len:
                    raise mig.MigrationError(f"checkpoint block width {T_pad} exceeds this engine's cache row "
                                             f"({self.max_seq_len}); the producer's bucket ladder is wider")
                if self.kv_layout == "paged":
                    page = self._pcfg.page_size
                    need = min(-(-T_pad // page) + 1, self._pcfg.max_pages_per_seq)
                    if need > self._pcfg.num_pages - 1:
                        raise mig.MigrationError(f"checkpoint needs {need} pages but the pool has "
                                                 f"{self._pcfg.num_pages - 1}")
                pref = {"k": state["k"], "v": state["v"], "n": int(state["n"]), "prompt_token_ids": prompt}
                if state.get("k_scale") is not None:
                    pref.update(k_scale=state["k_scale"], v_scale=state["v_scale"])
                st.prefilled = pref
                st.resume = {"rng_key": mig.key_from_wire(state["rng_key"]), "spec": state.get("spec")}
                nbytes = mig.state_nbytes(state)
            elif self._spec_cfg is not None and state.get("spec"):
                # cold restore: the sticky spec state survives (the eventual
                # bind's _spec_admit reads it back under the NEW request id)
                sp = state["spec"]
                self._controller.restore(request_id, sp.get("ema"), sp.get("k"))
            if self._tel is not None:
                self._tel.on_submit(st, state.get("submitted_at"), parent_trace=_parent_trace(state))
                self._tel.on_migration("restored", nbytes)
            self._requests[request_id] = st
            self._waiting.append(st)
            return request_id

    # ------------------------------------------------ tiered conversation KV
    def suspend_request(self, request_id: str, *, publish: bool = True) -> dict:
        """Spill an IDLE conversation's KV out of the card: checkpoint the
        request (the block, the live PRNG key) and retire its slot and
        pages under ONE acquisition of the lock, keeping the state in host
        memory; ``resume_suspended`` scatters the block back in instead of
        re-prefilling. Raises MigrationError when the request cannot
        suspend (unknown or finished, streaming, prefill-only, a waiting
        sampled request with tokens), or when a chaos rule at
        ``llm.suspend`` drops or faults the spill decision; in every
        refusal the conversation is untouched and still RUNNING.

        With ``publish`` (the default) the state also goes onto the object
        plane (``migrate.publish``), so any process can resume it from the
        reference (``restore_request``). The publish runs OUTSIDE the lock;
        when it fails (no plane attached, a full ``/dev/shm``, an injected
        fault) the host copy stays, resume still works, and
        ``suspend_publish_errors`` counts it."""
        self._no_tp("suspend_request")
        # the chaos gate sits OUTSIDE the lock and BEFORE the snapshot: an
        # injected drop or fault models "the spill path is down" and must
        # degrade to the typed refusal with no request state mutated
        try:
            ok = chaos.apply("llm.suspend")
        except mig.MigrationError:
            raise
        except Exception as e:  # noqa: BLE001 — injected fault, typed on the way out
            raise mig.MigrationError(f"suspend of {request_id!r} faulted: {e}") from e
        if not ok:
            raise mig.MigrationError(f"suspend of {request_id!r} dropped (chaos)")
        with self._lock:
            state = self._checkpoint_locked(request_id)
            self._finish(self._requests[request_id], "suspended")
            nbytes = mig.state_nbytes(state)
            self._suspend_stats["suspended"] += 1
            self._suspend_stats["spilled_bytes"] += nbytes
            rec = {"state": state, "meta": None, "ref": None, "nbytes": nbytes, "t": time.time()}
            self._suspended[request_id] = rec
        if self._tel is not None:
            self._tel.on_kv_spill(nbytes)
        if publish:
            try:
                meta, ref = mig.publish(state)
                with self._lock:
                    rec["ref"], rec["meta"] = ref, meta
            except Exception:  # noqa: BLE001 — the plane is opportunism here: the host copy stays valid
                with self._lock:
                    self.suspend_publish_errors += 1
        return {"request_id": request_id, "nbytes": nbytes, "published": rec["ref"] is not None}

    def resume_suspended(self, request_id: str, stream: bool = False, out_queue=None) -> str:
        """Re-admit a suspended conversation under its ORIGINAL request id:
        the spilled block scatters back in through ``restore_request``
        (the exact PRNG key, no re-prefill, no token emitted again). It
        races a concurrent admission safely: the restore only appends to
        the waiting queue under the lock. Prefers the host copy and falls
        back to fetching the plane reference. Raises MigrationError for an
        unknown suspension, MigrationLostError when both tiers are gone; a
        refused restore keeps the record."""
        self._no_tp("resume_suspended")
        with self._lock:
            rec = self._suspended.pop(request_id, None)
        if rec is None:
            raise mig.MigrationError(f"no suspended conversation {request_id!r}")
        state = rec["state"]
        if state is None:
            try:
                state = mig.fetch(rec["ref"], rec["meta"])
            except Exception:
                with self._lock:
                    self._suspend_stats["dropped"] += 1
                raise
        try:
            rid = self.restore_request(state, request_id=request_id, stream=stream, out_queue=out_queue)
        except Exception:
            with self._lock:  # refused restore: the record stays claimable
                self._suspended.setdefault(request_id, rec)
            raise
        with self._lock:
            self._suspend_stats["resumed"] += 1
        return rid

    def suspended_requests(self) -> list:
        """Request ids currently spilled to the conversation tier."""
        with self._lock:
            return sorted(self._suspended)

    def drop_suspended(self, request_id: str) -> bool:
        """Discard a suspended conversation (client gone, TTL expired): its
        host copy goes; a plane copy ages out with its owner's refs."""
        with self._lock:
            rec = self._suspended.pop(request_id, None)
            if rec is not None:
                self._suspend_stats["dropped"] += 1
            return rec is not None

    def suspend_stats(self) -> dict:
        """Counters of the conversation tier: suspended, resumed,
        spilled_bytes, dropped, and how many are held now."""
        with self._lock:
            return dict(self._suspend_stats, held=len(self._suspended))

    # ---------------------------------------------------------------- engine
    def _finish(self, st: RequestState, reason: str):
        st.finished = True
        st.finish_reason = reason
        if self._tel is not None:
            self._tel.on_finish(st, reason)
        if st.prefill_only and reason != "handoff":
            # an aborted or failed prefill-only request: nobody will pop its block
            self._handoffs.pop(st.request_id, None)
        if self._spec_cfg is not None:
            self._controller.forget(st.request_id)
        if st.slot >= 0:
            if self.kv_layout == "paged":
                self._release_slot_pages(st.slot)
            self._slots[st.slot] = None
            st.slot = -1
        if st.out_queue is not None:
            st.out_queue.put(None)  # sentinel

    def _push_table(self, slot: int):
        """Write one slot's table row and length into the device lanes (the
        delta that replaces whole-array uploads)."""
        self._do("set_table", slot, self._tables[slot].copy(), int(self._lengths[slot]))

    def _release_slot_pages(self, slot: int):
        self._page_alloc.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._tables[slot, :] = 0
        self._lengths[slot] = 0
        if self._device_resident:
            # point the lane at the trash page, so the step in flight and
            # idle steps write harmlessly instead of into recycled pages
            self._push_table(slot)

    def _requeue(self, st: RequestState):
        """Recompute-preemption of one running sequence: free its pages and
        put it first in line, its generated tokens folded into the prompt
        at re-admission."""
        st.preemptions += 1
        self.preemption_count += 1
        slot = st.slot
        self._release_slot_pages(slot)
        self._slots[slot] = None
        st.slot = -1
        self._waiting.appendleft(st)

    def _preempt_for(self, need: int, exclude: RequestState | None = None) -> bool:
        """Preempt the YOUNGEST running sequences until >= need pages are
        free. Returns False when nothing is left to preempt."""
        while self._page_alloc.free_pages < need:
            victims = [s for s in self._slots if s is not None and s is not exclude]
            if not victims:
                return False
            self._requeue(max(victims, key=lambda s: s.admit_seq))
        return True

    def _paged_grow(self):
        """Before a decode step: a sequence whose upcoming appends cross
        into unallocated pages gets them (preempting the youngest OTHER
        sequence when the pool is dry; a sequence that cannot grow at all
        re-queues itself). Plain decode looks ahead one token; a
        speculative lane needs up to k_eff+1 appends for the round about to
        dispatch plus k+1 for the still-pending round, capped at the
        request's own prompt + max_tokens (KV past it is never attended, so
        those writes may land in the trash page). Device-resident: a
        sequence that the step in flight finishes at max_tokens is not
        grown (its next step is the discarded trailing one, whose write
        lands in the trash page), as the sync loop would already have
        freed it."""
        page = self._pcfg.page_size
        spec = self._spec_cfg is not None
        pending_k: dict = {}
        if self._pending is not None:
            for entry in self._pending[-1]:  # lanes: (st, slot[, k_eff])
                pending_k[id(entry[0])] = entry[2] if len(entry) > 2 else 0
        for st in [s for s in self._slots if s is not None]:
            if st.slot < 0 or self._slots[st.slot] is not st:
                continue  # preempted by an earlier iteration
            if id(st) in pending_k and len(st.token_ids) + 1 >= st.params.max_tokens:
                continue
            slot = st.slot
            l = int(self._lengths[slot])
            if spec:
                look = int(self._lane_k[slot]) + 1
                if id(st) in pending_k:
                    look += pending_k[id(st)] + 1
                budget = len(st.prompt_token_ids) + st.params.max_tokens
                horizon = min(l + look, max(budget, l))
            else:
                horizon = l + 1
            if horizon <= l:
                continue
            target_pg = (horizon - 1) // page + 1
            if not spec and target_pg > self._pcfg.max_pages_per_seq:
                self._finish(st, "length")  # table row exhausted
                continue
            target_pg = min(target_pg, self._pcfg.max_pages_per_seq)
            while len(self._slot_pages[slot]) < target_pg:
                got = self._page_alloc.alloc(1)
                if got is None and self._preempt_for(1, exclude=st):
                    got = self._page_alloc.alloc(1)
                if got is None:
                    self._requeue(st)
                    break
                pg_ix = len(self._slot_pages[slot])
                self._tables[slot, pg_ix] = got[0]
                self._slot_pages[slot].extend(got)
                if self._device_resident:
                    self._do("set_table_cell", slot, pg_ix, got[0])

    def _pages_needed(self, st: RequestState, pref, prompt) -> int | None:
        """Pages to admit: the prompt bucket (a prefix hit: the prefix and
        the suffix's bucket; transferred KV: its block width rounded up to
        a page, the padding included) + one decode headroom page, capped at
        the table row. None = can never fit; the request is finished with
        an error instead of waiting forever."""
        page = self._pcfg.page_size
        if st.prefilled is not None:
            need = -(-int(st.prefilled["k"].shape[1]) // page) + 1
        elif pref is not None:
            n_p = pref[2]
            need = (n_p + _bucket(len(prompt) - n_p, self.prefill_buckets)) // page + 1
        else:
            need = _bucket(len(prompt), self.prefill_buckets) // page + 1
        need = min(need, self._pcfg.max_pages_per_seq)
        if need > self._pcfg.num_pages - 1:
            self._finish(st, f"error: needs {need} pages, pool holds {self._pcfg.num_pages - 1}")
            return None
        return need

    def _resolve_prefix(self, st: RequestState, prompt):  # holds-lock: _lock
        """The request's prefix hit ``(k, v, n, k_scale, v_scale)`` (scales
        None except for an int8 wire block off the KV plane), None, or
        ``_DEFER`` while its remote fetch is in flight. Resolved once and
        cached on the request while it waits; a cached miss is looked up
        again once the cache's generation moved (or, with a plane, its
        lease lapsed).

        A local miss with a KV plane LAUNCHES the remote lookup and fetch
        on the fetch worker (never under this lock) and defers the request;
        the landed result splices in here; a fetch outliving its deadline
        is abandoned to a plain local prefill, so admission never hangs."""
        cached = st.cached_pref
        if cached is not None and cached[0] is _PREF_MISS and (
                cached[1] != self._prefix_cache.gen or time.time() >= cached[2]):
            cached = None  # keys minted, or the miss's lease lapsed: re-resolve
        if cached is not None:
            return None if cached[0] is _PREF_MISS else cached
        # the suffix-overrun guard applies INSIDE the lookup, so a rejected
        # longest boundary falls through to the next shorter LOCAL one
        local = self._prefix_cache.lookup(prompt, admissible=lambda n_p: self._prefix_fits(n_p, len(prompt)))
        pref = None
        if local is not None:
            pref = local + (None, None)
            if self._tel is not None:
                self._tel.on_prefix_hit("local", local[2])
            if self._prefetched_keys:
                # a hit served by a block the prefetcher pulled in ahead of demand
                if prefix_key(token_bytes(tuple(int(t) for t in prompt)), local[2]) in self._prefetched_keys:
                    self._plane_stats["prefetch_hits"] += 1
                    if self._tel is not None:
                        self._tel.on_prefetch_hit()
            if self._kv_plane is not None:
                # publish self-heal: a boundary whose publish failed once
                # would stay invisible to the cluster (a store never re-mints
                # cached keys); the client skips published bounds
                self._plane_publish(prompt[: local[2]], local[0], local[1])
        elif self._kv_plane is not None:
            rec = self._fetch_state.get(st.request_id)
            if rec is None and not self._kv_plane.index_down():
                rec = self._launch_prefix_fetch(st.request_id, prompt)
            if rec is not None:
                if rec["done"]:
                    pref = self._splice_prefix_fetch(st, rec, prompt)
                elif time.time() < rec["deadline"]:
                    return _DEFER
                else:
                    # a wedged plane: abandon the fetch; the record waits in
                    # the zombie list so its terminal resolution still counts
                    self._fetch_state.pop(st.request_id, None)
                    self._plane_stats["abandoned"] += 1
                    self._fetch_zombies.append(rec)
        if pref is None:
            exp = time.time() + 1.0 if self._kv_plane is not None else float("inf")
            st.cached_pref = (_PREF_MISS, self._prefix_cache.gen, exp)
        else:
            st.cached_pref = pref
        return pref

    def _prefix_fits(self, n_p: int, prompt_len: int) -> bool:
        """A prefix boundary is admissible when the bucket-padded suffix
        still fits the sequence's slot row or table row after it (a slot
        extend past the row would clamp its start onto the prefix). The one
        predicate the local lookup and the remote candidates share."""
        return n_p + _bucket(prompt_len - n_p, self.prefill_buckets) <= self.max_seq_len

    def _stage_admission(self) -> list:  # holds-lock: _lock
        """ADMISSION: admit waiting requests FIFO while a slot (and, paged,
        pages) is free (a head-of-line request that cannot get pages blocks
        the wave; admission never preempts), resolving prefix hits of fresh
        prompts before the wave's prefills run. A request whose remote
        prefix fetch is in flight steps aside for this wave and keeps its
        place in line. Returns (st, slot, pref, pages, prompt); pages is
        None on the slot layout."""
        if self._adoptions:
            self._adopt_pending_locked()
        if self._fetch_zombies:
            self._reap_fetch_zombies_locked()
        wave = []
        deferred: list[RequestState] = []
        while self._waiting and None in self._slots:
            st = self._waiting[0]
            if st.finished:  # aborted while waiting
                self._waiting.popleft()
                self._fetch_state.pop(st.request_id, None)
                continue
            slot = self._slots.index(None)
            prompt = st.prompt_token_ids + st.token_ids  # preempted: generated tail joins the prompt
            pref = None
            if st.prefilled is None and self._prefix_cache is not None and not st.token_ids:
                pref = self._resolve_prefix(st, prompt)
                if pref is _DEFER:
                    deferred.append(self._waiting.popleft())
                    continue
            pages = None
            if self.kv_layout == "paged":
                need = self._pages_needed(st, pref, prompt)
                if need is None:
                    self._waiting.popleft()
                    continue
                pages = self._page_alloc.alloc(need)
                if pages is None:
                    break  # pool full: head-of-line waits
            self._waiting.popleft()
            st.cached_pref = None  # admission consumes the cached resolution
            self._slots[slot] = st  # reserve; _bind_slot fills the rest
            wave.append((st, slot, pref, pages, prompt))
        for st in reversed(deferred):
            self._waiting.appendleft(st)  # original FIFO order
        return wave

    # ------------------------------------------------ the remote prefix tier
    def _ensure_fetch_worker(self):  # holds-lock: _lock
        if self._fetch_thread is not None and self._fetch_thread.is_alive():
            return
        self._fetch_q = queue.SimpleQueue()
        self._fetch_thread = threading.Thread(target=_prefix_fetch_worker, args=(weakref.ref(self), self._fetch_q),
                                              daemon=True, name="llm-prefix-fetch")
        self._fetch_thread.start()

    def _launch_prefix_fetch(self, request_id: str, prompt) -> dict:  # holds-lock: _lock
        """Mint the in-flight record and queue the job (nothing blocks). The
        record is the ONLY shared state: the worker fills it and sets
        ``done`` last; admission reads it once ``done`` is seen, or abandons
        it at ``deadline``."""
        rec = {
            "request_id": request_id, "done": False, "error": False, "lost": False,
            "pref": None, "restore": False, "nbytes": 0, "n_p": 0,
            "t0": time.time(), "t1": 0.0,
            "deadline": time.time() + self.prefix_fetch_deadline_s,
        }
        self._fetch_state[request_id] = rec
        self._ensure_fetch_worker()
        self._fetch_q.put((rec, [int(t) for t in prompt]))
        return rec

    def _run_prefix_fetch(self, rec: dict, prompt: list) -> None:
        """One remote resolution, lock-free (the fetch worker): candidates,
        index lookup, object-plane fetch, token check fill ``rec``; every
        engine-state change (counters, upload, re-store, republish) waits
        for ``_splice_prefix_fetch`` under the lock. EVERY failure (index
        down, block evicted, owner dead, token mismatch) degrades to a
        plain local prefill."""
        try:
            self._resolve_remote_prefix(rec, prompt)
        except Exception:  # noqa: BLE001 — the plane is an accelerator, never a dependency
            rec["error"] = True
        rec["t1"] = time.time()
        if self._tel is not None:
            self._tel.on_prefix_fetch(rec["t0"], rec["t1"], rec["n_p"], rec["pref"] is not None)
        rec["done"] = True

    def _resolve_remote_prefix(self, rec: dict, prompt: list) -> None:
        block = self._prefix_cache.block
        # candidate boundaries whose bucket-padded suffix fits (the local
        # lookup's guard)
        cands = [(n, key) for n, key in boundary_keys(prompt, block) if self._prefix_fits(n, len(prompt))]
        if not cands:
            return
        hit = self._kv_plane.lookup(cands)
        if hit is None:
            return
        # the producer's bucket width, checked BEFORE the transfer from the
        # routed meta: a producer whose ladder is narrower than our pad for
        # this boundary costs nothing
        shape = tuple(hit.get("meta", {}).get("shape") or ())
        if len(shape) > 1 and shape[1] < _bucket(int(hit["n"]), self.prefill_buckets):
            return
        payload = self._kv_plane.fetch(hit)
        if payload is None:
            # lost after the bounded retries: the client reported the route
            rec["lost"] = True
            return
        n_p = int(hit["n"])
        # token-for-token check, as the local cache's: a hash collision or a
        # stale publish never serves a foreign prompt's KV
        if payload["n"] < n_p or payload["prompt_token_ids"][:n_p] != [int(t) for t in prompt[:n_p]]:
            return
        pad = _bucket(n_p, self.prefill_buckets)
        if payload["k"].shape[1] < pad:
            return  # the producer's bucket ladder is narrower than ours
        k_w, v_w = payload["k"][:, :pad], payload["v"][:, :pad]
        k_sc, v_sc = payload.get("k_scale"), payload.get("v_scale")
        if k_sc is not None:
            k_sc, v_sc = k_sc[:, :, :pad], v_sc[:, :, :pad]
        rec["n_p"] = n_p
        rec["nbytes"] = int(hit.get("meta", {}).get("nbytes") or (k_w.nbytes + v_w.nbytes))
        # re-store locally only where a later local hit reproduces the same
        # cache bytes: an fp wire into an fp cache, or an int8 wire into an
        # int8 cache (dequantized for the fp PrefixCache, requantized byte
        # for byte on insert); an fp cache re-storing a dequantized int8
        # block would drift from its own prefill
        rec["restore"] = (k_w.dtype == torch.int8) == self.kv_quant
        rec["pref"] = (k_w, v_w, n_p, k_sc, v_sc)

    def _reap_fetch_zombies_locked(self) -> None:  # holds-lock: _lock
        """Credit the terminal resolution of deadline-abandoned fetches once
        the worker finished them: lost and error keep their meaning; a
        landed hit counts nothing (the request prefilled locally)."""
        if not self._fetch_zombies:
            return
        live = []
        for rec in self._fetch_zombies:
            if not rec["done"]:
                live.append(rec)
            elif rec["error"]:
                self._plane_stats["errors"] += 1
            elif rec["lost"]:
                self._plane_stats["lost"] += 1
        self._fetch_zombies = live

    def _splice_prefix_fetch(self, st: RequestState, rec: dict, prompt):  # holds-lock: _lock
        """Apply a landed fetch at admission: counters and telemetry, the
        upload of the block (and its scales) to the card, the local
        re-store and the republish offer. Returns the pref tuple, or None
        (miss, lost, error: a plain local prefill)."""
        self._fetch_state.pop(st.request_id, None)
        if rec["error"]:
            self._plane_stats["errors"] += 1
            return None
        if rec["lost"]:
            self._plane_stats["lost"] += 1
            return None
        if rec["pref"] is None:
            return None
        k_w, v_w, n_p, k_sc, v_sc = rec["pref"]
        rec["pref"] = None  # the record no longer pins the owner's mapping
        dev = self.device
        # the one copy the borrow path pays: host mapping -> card
        k_d, v_d = k_w.to(dev), v_w.to(dev)
        sc = (None, None) if k_sc is None else (k_sc.to(dev), v_sc.to(dev))
        self._plane_stats["hits"] += 1
        self._plane_stats["tokens_saved"] += n_p
        self._plane_stats["fetched_bytes"] += rec["nbytes"]
        if self._tel is not None:
            self._tel.on_prefix_hit("remote", n_p, rec["nbytes"])
        if rec["restore"]:
            k_fp, v_fp = (self._kv_plane.dequantize_wire(k_d, v_d, *sc) if k_d.dtype == torch.int8
                          else (k_d, v_d))
            stored = self._prefix_cache.store(prompt[:n_p], k_fp, v_fp, self.prefill_buckets)
            if stored is not None:
                # proven_reuse: this replica just fetched the block, which is
                # itself reuse evidence, so the republish skips the policy
                self._plane_publish(prompt[:n_p], k_fp, v_fp, *stored, proven_reuse=True)
        return (k_d, v_d, n_p, *sc)

    def adopt_prefetched(self, prompt_token_ids, k_fp, v_fp) -> int:
        """Install a PREDICTIVELY fetched hot block (the plane client's
        prefetch worker) in the local prefix cache, so the fleet's most
        demanded prefixes become local hits before any request here asks.
        ``k_fp``/``v_fp``: fp host tensors [L, T, kv, hd]. The block waits
        for the next admission, which uploads it on the stepping thread
        under the lock (the prefetch worker never touches the card), stores
        it (quantized on insert for an int8 cache, as a remote re-store),
        remembers its key for the prefetch-hit count and republishes it.
        Returns the queued bytes (0 with prefix caching off)."""
        self._no_tp("adopt_prefetched (the KV plane)")
        ids = [int(t) for t in prompt_token_ids]
        with self._lock:
            if self._prefix_cache is None or not ids:
                return 0
            self._adoptions.append((ids, k_fp, v_fp))
        return int(k_fp.nbytes + v_fp.nbytes)

    def _adopt_pending_locked(self):  # holds-lock: _lock
        adoptions, self._adoptions = self._adoptions, []
        for ids, k, v in adoptions:
            k_d, v_d = k.to(self.device), v.to(self.device)
            stored = self._prefix_cache.store(ids, k_d, v_d, self.prefill_buckets)
            if stored is None:
                continue  # a duplicate, or wider than the cache
            self._plane_stats["prefetched_blocks"] += 1
            self._plane_stats["prefetched_bytes"] += int(k_d.nbytes + v_d.nbytes)
            self._prefetched_keys.add(prefix_key(token_bytes(ids), len(ids)))
            self._plane_publish(ids, k_d, v_d, *stored, proven_reuse=True)

    def _plane_publish(self, prompt, ks, vs, new_keys=None, pad=None, proven_reuse=False):  # holds-lock: _lock
        """Queue a prefix-block publish for the step tail (every caller
        holds the lock). The offer holds the tensors the prefix cache just
        stored or served: nothing is copied here."""
        block = self._prefix_cache.block
        if (len(prompt) // block) * block < block:
            return
        self._plane_offers.append((list(prompt), ks, vs, new_keys, pad, proven_reuse))

    def _flush_plane_offers(self):
        """Publish the queued prefix blocks (owned object + index
        registration) with the engine lock RELEASED (the step tail).
        ``new_keys`` scopes registration to the boundaries the local cache
        just minted; None lets the client cover every unpublished boundary
        (the local-hit self-heal). Failures degrade quietly: the client
        counts them."""
        if not self._plane_offers:
            return
        with self._lock:
            offers, self._plane_offers = self._plane_offers, []
        block = self._prefix_cache.block
        for prompt, ks, vs, new_keys, pad, proven_reuse in offers:
            n_max = (len(prompt) // block) * block
            pad = int(ks.shape[1]) if pad is None else pad
            nbytes = self._kv_plane.publish(
                [int(t) for t in prompt[:n_max]], ks[:, :pad], vs[:, :pad],
                bounds=None if new_keys is None else [(n, key) for key, n in new_keys],
                proven_reuse=proven_reuse,
            )
            if nbytes:
                with self._lock:
                    self._plane_stats["published_blocks"] += 1
                    self._plane_stats["published_bytes"] += nbytes

    def _stage_prefill(self, wave: list) -> list:
        """PREFILL: transferred KV scatters in and prefix hits extend their
        suffix one by one, in wave order; then one batched forward per
        prefill bucket for the rest. Prefill-only requests complete into
        handoff payloads as they bind. Returns the admitted requests."""
        plains = []
        paged = self.kv_layout == "paged"
        if wave:
            self._t_prefill_start = time.time()  # telemetry: the wave's prefill span start
        for st, slot, pref, pages, prompt in wave:
            if paged:
                self._slot_pages[slot] = pages
                self._tables[slot, :] = 0
                self._tables[slot, : len(pages)] = pages
            if st.prefilled is not None:
                self._admit_prefilled(st, slot)
            elif pref is not None:
                (self._admit_prefix_hit if paged else self._admit_prefix_hit_slots)(st, slot, pref, prompt)
            else:
                plains.append((st, slot, prompt))
        for group in self._bucket_groups(plains):
            self._admit_prefill_batch(group)
        return [st for st, *_ in wave]

    def _bucket_groups(self, plains):
        if not self._batch_prefill:
            return [[p] for p in plains]
        groups: dict[int, list] = {}
        for item in plains:
            groups.setdefault(_bucket(len(item[2]), self.prefill_buckets), []).append(item)
        return list(groups.values())

    def _admit_prefill_batch(self, group):
        """One forward prefills the group (one bucket), batch padded to a
        power of two; padding rows carry length 1 and are never inserted."""
        T = _bucket(max(len(p) for _, _, p in group), self.prefill_buckets)
        Bp = 1 << (len(group) - 1).bit_length()
        toks = np.zeros((Bp, T), np.int64)
        lens = np.ones((Bp,), np.int64)
        for i, (_, _, prompt) in enumerate(group):
            toks[i, : len(prompt)] = prompt
            lens[i] = len(prompt)
        logits, ks, vs = self._do("prefill", toks, lens)
        self.prefill_forwards += 1
        for i, (st, slot, prompt) in enumerate(group):
            if self._prefix_cache is not None and not st.token_ids:  # fresh prompts only
                stored = self._prefix_cache.store(prompt, ks[:, i], vs[:, i], self.prefill_buckets)
                if stored is not None and self._ranks is not None:
                    # the other ranks keep their shard of the group until rank 0's copy dies
                    gid = self._prefix_cache.last_gid
                    self._tp_send("_rop_prefix_store", gid, i, stored[1])
                    weakref.finalize(self._prefix_cache._groups[gid][0], self._tp_dead_gids.append, gid)
                if stored is not None and self._kv_plane is not None:
                    # the block every other replica would prefill again
                    self._plane_publish(prompt, ks[:, i], vs[:, i], *stored)
            if self.kv_layout == "paged":
                self._do("insert_pages", self._tables[slot, : T // self._pcfg.page_size].copy(), i)
                self._lengths[slot] = len(prompt)
                if self._device_resident:
                    self._push_table(slot)
            else:
                self._do("insert_sequence", slot, i, len(prompt))
            self._bind_slot(st, slot, logits[i : i + 1])
        self._do("end_prefill")

    def _admit_prefix_hit(self, st: RequestState, slot: int, pref, prompt):
        """Admit a prefix hit into its pages (already in the host table):
        insert the cached prefix's first n_p positions into the first
        n_p / page pages (a remote int8 wire block with its scales, bytes
        copied or requantized by the insert), then extend the suffix over
        them (K4 over the prefix, the suffix causally from registers) and
        sample from the extend's logits."""
        k_p, v_p, n_p, k_sc, v_sc = pref
        n = len(prompt)
        m = n - n_p
        toks = np.zeros((_bucket(m, self.prefill_buckets),), np.int64)
        toks[:m] = prompt[n_p:]
        row = self._tables[slot].copy()
        if self._ranks is not None:
            self._tp_send("_rop_hit_paged", k_p.prefix_gid, row, n_p, toks, m)
        logits = self._op_hit_paged((k_p, v_p, k_sc, v_sc), row, n_p, toks, m)
        self.extend_forwards += 1
        self._lengths[slot] = n
        if self._device_resident:
            self._push_table(slot)
        self._bind_slot(st, slot, logits[None])

    def _admit_prefix_hit_slots(self, st: RequestState, slot: int, pref, prompt):
        """Admit a prefix hit into its slot: insert the cached group (its
        whole bucket width, with its scales for a remote int8 wire block;
        the slot's length is the prefix's n_p), then extend the suffix from
        position n_p and sample from its logits."""
        k_p, v_p, n_p, k_sc, v_sc = pref
        m = len(prompt) - n_p
        toks = np.zeros((_bucket(m, self.prefill_buckets),), np.int64)
        toks[:m] = prompt[n_p:]
        if self._ranks is not None:
            self._tp_send("_rop_hit_slots", k_p.prefix_gid, slot, n_p, toks, m)
        logits = self._op_hit_slots((k_p, v_p, k_sc, v_sc), slot, n_p, toks, m)
        self.extend_forwards += 1
        self._bind_slot(st, slot, logits[None])

    def _admit_prefilled(self, st: RequestState, slot: int):
        """Admit transferred KV (a handoff payload, or a restored
        checkpoint's block) into its slot or its pages (already in the host
        table), in place. The paged block is padded to a page multiple,
        its scales with zeros, so no tail position carries a scale read as
        real. On the paged graph engine one ``kv_scatter_in_paged`` writes
        the pages, the device table row and the length lane; the sync loop
        inserts the pages (its lanes are uploaded each step). A block of
        another cache dtype is requantized on the way in. Then a handoff
        binds by sampling its first token from the shipped logits, a
        restore by splicing its lane (``_bind_resume``)."""
        kv, st.prefilled = st.prefilled, None
        t_scatter = time.time()
        dev = self.device
        k, v = host_tensor(kv["k"]), host_tensor(kv["v"])
        scales = () if kv.get("k_scale") is None else (host_tensor(kv["k_scale"]), host_tensor(kv["v_scale"]))
        n = int(kv["n"])
        if self.kv_layout == "paged":
            page = self._pcfg.page_size
            T = k.shape[1]
            T_pad = -(-T // page) * page
            if T_pad != T:
                pad = (0, 0, 0, 0, 0, T_pad - T)  # [L, T, kv, hd]: zeros after position T
                k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
                scales = tuple(torch.nn.functional.pad(sc, (0, T_pad - T)) for sc in scales)  # [L, kv, T]
            k, v = k.to(dev), v.to(dev)
            scales = tuple(sc.to(dev) for sc in scales)
            row = torch.from_numpy(self._tables[slot].copy()).to(dev)
            if self._device_resident:
                self._scatter_paged(self.pool, self._dtables, self._dlengths, slot, row, k, v, n, *scales)
            else:
                pkv.insert_pages(self.pool, row[: T_pad // page], k, v, *scales)
            self._lengths[slot] = n
        else:
            self._scatter_slots(self.cache, slot, k.to(dev), v.to(dev), n, *(sc.to(dev) for sc in scales))
        if self._tel is not None:
            self._tel.on_scatter_in(st, t_scatter)
        if st.resume is not None:
            self._bind_resume(st, slot)
        else:
            self._bind_slot(st, slot, host_tensor(kv["logits"]).to(dev)[None])

    def _bind_slot(self, st: RequestState, slot: int, logits):
        """Bind the lane and sample the first token from the prefill logits
        with the lane's key: a seeded request's is PRNGKey(seed); a
        seedless lane keeps the key its slot has advanced to, which
        device-resident mode reads from the device (this waits for the
        step in flight, as in ray_tpu). Then the lane delta."""
        st.slot = slot
        self._admit_counter += 1
        st.admit_seq = self._admit_counter
        self._slots[slot] = st
        if self._tel is not None:
            self._tel.on_bind(st, getattr(self, "_t_prefill_start", st.t_submit))
        if st.prefill_only:
            # the prefill engine's path: the block leaves, the slot recycles
            self._complete_handoff(st, slot, logits)
            return
        p = st.params
        self._temps[slot] = p.temperature
        self._top_k[slot] = p.top_k
        self._top_p[slot] = p.top_p
        if p.seed is not None:
            self._keys[slot] = prng.prng_key(p.seed).numpy()
        elif self._device_resident:
            self._keys[slot] = self._dkeys[slot].cpu().numpy()
        lane = (torch.from_numpy(a[slot : slot + 1].copy()).to(logits.device)
                for a in (self._keys, self._temps, self._top_k, self._top_p))
        tok, logp, key = sample(logits, *lane)
        self._keys[slot] = key[0].cpu().numpy()
        token = int(tok[0])
        if self._device_resident:
            self._do("set_lane", slot, token, self._keys[slot], p.temperature, p.top_k, p.top_p)
        spec_hist = (st.prompt_token_ids + st.token_ids + [token]) if self._spec_cfg is not None else None
        self._emit(st, token, float(logp[0]))
        if spec_hist is not None:
            self._spec_admit(st, slot, spec_hist)

    def _bind_resume(self, st: RequestState, slot: int):
        """Splice a restored request into the decode loop
        (``llm/migrate.py``): bind the slot and every lane from the
        CHECKPOINTED state (its advanced PRNG key, never re-derived from
        the seed; the last emitted token as the next decode input; on a
        spec engine the controller's sticky state and the drafter over
        prompt + emitted) and emit NOTHING: the next token comes from this
        engine's first decode step, so the stream neither repeats nor
        drops a token at the splice."""
        st.slot = slot
        self._admit_counter += 1
        st.admit_seq = self._admit_counter
        self._slots[slot] = st
        if self._tel is not None:
            self._tel.on_bind(st, getattr(self, "_t_prefill_start", st.t_submit))
        rs, st.resume = st.resume, None
        p = st.params
        self._temps[slot] = p.temperature
        self._top_k[slot] = p.top_k
        self._top_p[slot] = p.top_p
        self._keys[slot] = rs["rng_key"]
        token = int(st.token_ids[-1])
        self._next_tokens[slot] = token
        if self._device_resident:
            self._do("set_lane", slot, token, self._keys[slot], p.temperature, p.top_k, p.top_p)
        if self._spec_cfg is not None:
            spec = rs.get("spec") or {}
            self._controller.restore(st.request_id, spec.get("ema"), spec.get("k"))
            # history = prompt + everything emitted; the drafter caches
            # hist[:-1], the positions the restored block covers
            self._spec_admit(st, slot, st.prompt_token_ids + st.token_ids)

    def _complete_handoff(self, st: RequestState, slot: int, logits):
        """Finish a prefill-only request: extract its KV block at the
        prompt's bucket width (the tail past the real length is garbage
        the decode side masks by length; an int8 cache ships int8 values
        and wire scales), stash the payload for ``pop_handoff``, and free
        the slot and its pages."""
        t_extract = time.time()
        prompt = st.prompt_token_ids
        out = self._extract_block(slot, _bucket(len(prompt), self.prefill_buckets))
        payload = {"k": out[0], "v": out[1], "n": len(prompt), "logits": logits[0].float().cpu(),
                   "prompt_token_ids": list(prompt)}
        if len(out) == 4:
            payload.update(k_scale=out[2], v_scale=out[3])
        if self._tel is not None:
            # plants the trace context and the submit stamp in the payload
            self._tel.on_handoff_extract(st, payload, t_extract)
        self._handoffs[st.request_id] = payload
        self._finish(st, "handoff")

    def _spec_admit(self, st: RequestState, slot: int, hist_tokens: list):
        """Spec lane state for a freshly (re)admitted sequence: the token
        history row (prompt + recompute-folded generation + the first
        sampled token), the controller's sticky effective k, and the
        drafter's own prefill. A request that finished at admission
        (stop/max_tokens on the first token) never drafts."""
        if st.finished or st.slot != slot:
            return
        n = len(hist_tokens)
        row = np.zeros((self._spec_hist_width,), np.int64)
        row[:n] = hist_tokens
        k0 = self._controller.admit(st.request_id)
        self._lane_k[slot] = k0
        self._do("spec_admit", slot, row, n, k0, list(hist_tokens[:-1]))

    def _emit(self, st: RequestState, token: int, logp: float):
        st.token_ids.append(token)
        st.logprobs.append(logp)
        if self._tel is not None:
            self._tel.on_emit(st)
        if st.out_queue is not None:
            st.out_queue.put(token)
        if st.slot >= 0:
            self._next_tokens[st.slot] = token
        if token in st.params.stop_token_ids:
            self._finish(st, "stop")
        elif len(st.token_ids) >= st.params.max_tokens:
            self._finish(st, "length")

    def step(self) -> list[RequestOutput]:
        """Admit what fits, advance decode one step, return per-request
        deltas. Device-resident (the default): the decode step is
        dispatched before the previous step's tokens are read back, so
        emission (streaming, finish detection, slot recycling) trails the
        device by exactly one step. Under speculation that trailing step
        would cost a whole drafter round, so wasted work is capped: a round
        whose every lane is sure to finish from the still-pending round is
        skipped, and a finished lane never enters another round. An error
        dumps the flight ring (telemetry) before it surfaces."""
        tel = self._tel
        t_step = time.perf_counter()
        try:
            with self._lock:
                self._last_spec_drain = None
                self._step_emitted = 0
                wave = self._stage_admission()
                t0 = time.perf_counter()
                admitted = self._stage_prefill(wave)
                t1 = time.perf_counter()
                if self.kv_layout == "paged":
                    self._paged_grow()
                reported = self._stage_decode(admitted)
                self.prefill_s += t1 - t0
                self.decode_s += time.perf_counter() - t1
                outs = self._build_outputs(reported)
                if tel is not None:
                    tel.on_step(t_step, len(admitted), self._step_emitted, self._last_spec_drain)
            if self._kv_plane is not None:
                # publish the step's minted prefix blocks and refresh the
                # index lease (throttled), both with the lock released
                self._flush_plane_offers()
                self._kv_plane.maybe_heartbeat()
            return outs
        except BaseException as exc:
            # postmortem: the flight ring as JSONL in the session dir
            if tel is not None:
                tel.dump_on_error(exc)
            raise

    def _stage_decode(self, admitted: list) -> list:
        """DECODE: device-resident mode dispatches the fused step (or the
        speculative round) and drains the PREVIOUS one (the reported set is
        the admitted requests and the drained lanes); sync mode is the
        blocking oracle loop, where every active lane emits now."""
        if self._device_resident:
            prev, self._pending = self._pending, None
            if self._spec_cfg is not None:
                self._dispatch_spec(prev)
                emitted = self._drain_spec(prev)
            else:
                self._dispatch_fused()
                emitted = self._drain(prev)
            self._step_emitted = len(emitted)
            return admitted + emitted
        reported = self._sync_decode()
        self._step_emitted = len(reported)
        return reported

    def _dispatch_fused(self):
        """Launch the fused step for the current occupancy (on the card one
        graph replay); never waits for its result, which is left pending
        for the next step's drain."""
        active = [s for s in self._slots if s is not None]
        if not active:
            return
        handle = self._decode_step()
        self.decode_steps += 1
        if self.kv_layout == "paged":
            for st in active:
                self._lengths[st.slot] += 1  # host shadow, no upload
        self._pending = (handle, [(st, st.slot) for st in active])

    def _decode_step(self):
        """Dispatch the decode step (or spec round) on every rank; rank 0
        counts its collectives' wire bytes (``tp_wire_step_bytes``)."""
        if self._group is None:
            return self._do("step")
        before = self._group.wire.total
        handle = self._do("step")
        self.tp_wire_step_bytes = self._group.wire.total - before
        return handle

    def _drain(self, pending) -> list:
        """Read back and emit a dispatched step's tokens (a lane aborted or
        finished since its dispatch emits nothing)."""
        if pending is None:
            return []
        handle, lanes = pending
        toks, logps = self._decode.read(handle)
        emitted = []
        for st, slot in lanes:
            if st.finished:
                continue
            self._emit(st, int(toks[slot]), float(logps[slot]))
            emitted.append(st)
        return emitted

    def _dispatch_spec(self, prev):
        """Launch one speculative round (draft -> verify -> append ->
        write-back; on the card one graph replay) for the current
        occupancy; never waits for its result. The drafter reads the device
        history and length lanes the PREVIOUS round wrote, so the draft
        chains on the verify with no host round trip."""
        active = [s for s in self._slots if s is not None]
        if not active:
            return
        if prev is not None:
            # wasted-work cap: the pending round emits >= 1 token per lane,
            # so a lane within one token of max_tokens is finished whatever
            # drains; if EVERY active lane is, this round could only produce
            # discarded tokens: skip it
            pend = {id(entry[0]) for entry in prev[1]}
            if all(id(s) in pend and len(s.token_ids) + 1 >= s.params.max_tokens for s in active):
                return
        handle = self._decode_step()
        self._spec_rounds += 1
        self._pending = (handle, [(st, st.slot, int(self._lane_k[st.slot])) for st in active])

    def _drain_spec(self, pending) -> list:
        """Read back and emit the PREVIOUS speculative round: up to
        accepted+1 tokens per lane, stopping at finish (stop ids /
        max_tokens mid-round) and, for the paged layout, at the table row's
        capacity (the point where the plain path's page growth finishes a
        row-exhausted sequence with reason "length")."""
        if pending is None:
            return []
        handle, lanes = pending
        emit, logps, acc = self._decode.read(handle)
        row_cap = self._pcfg.max_pages_per_seq * self._pcfg.page_size if self.kv_layout == "paged" else None
        emitted = []
        for st, slot, k_eff in lanes:
            if st.finished:
                continue  # aborted (or finished) between dispatch and drain
            a = int(acc[slot])
            n_new = a + 1
            cap = n_new
            if row_cap is not None and self._slots[slot] is st:
                # a recompute-preempted lane's shadow was already reset; only
                # a live occupant mirrors the device's length advance
                cap = max(row_cap - int(self._lengths[slot]), 0)
                self._lengths[slot] += n_new
            self._spec_proposed += k_eff
            self._spec_accepted += a
            self._spec_lane_rounds += 1
            for i in range(min(n_new, cap)):
                self._emit(st, int(emit[slot, i]), float(logps[slot, i]))
                self._spec_emitted += 1
                if st.finished:
                    break
            if not st.finished and cap < n_new:
                # accepted tokens past the row edge had their KV dropped to
                # the trash page; the plain path would have finished here
                self._finish(st, "length")
            if not st.finished:
                new_k = self._controller.observe(st.request_id, k_eff, a)
                if st.slot == slot and new_k != self._lane_k[slot]:
                    self._lane_k[slot] = new_k
                    self._do("set_slot_scalar", slot, new_k)
            emitted.append(st)
        if emitted and self._tel is not None:
            # per-round accounting for the flight record (host ints only)
            self._last_spec_drain = (int(sum(entry[2] for entry in lanes)),
                                     int(sum(int(acc[entry[1]]) for entry in lanes)))
        return emitted

    def _sync_decode(self) -> list:
        """The synchronous loop (ray_tpu's ``_sync_decode``): upload the
        lanes, run attention then append, sample, read the tokens and keys
        back. Every active lane (just-admitted ones included) emits one
        token; the returned list is the emit set."""
        active = [s for s in self._slots if s is not None]
        if not active:
            return []
        paged = self.kv_layout == "paged"
        toks, logps, keys = self._do("sync_decode", self._next_tokens, self._tables if paged else None,
                                     self._lengths if paged else None, self._keys, self._temps, self._top_k,
                                     self._top_p)
        if paged:
            for st in active:
                self._lengths[st.slot] += 1
        self.decode_steps += 1
        toks = toks.cpu().numpy()
        logps = logps.cpu().numpy()
        self._keys = keys.cpu().numpy()
        for st in active:
            self._emit(st, int(toks[st.slot]), float(logps[st.slot]))
        return active

    def _build_outputs(self, reported: list) -> list[RequestOutput]:  # holds-lock: _lock
        outputs: list[RequestOutput] = []
        seen: set = set()

        def out(st, new):
            return RequestOutput(
                request_id=st.request_id,
                prompt_token_ids=st.prompt_token_ids,
                token_ids=list(st.token_ids),
                new_token_ids=new,
                finished=st.finished,
                finish_reason=st.finish_reason,
                logprobs=list(st.logprobs) if st.params.logprobs else None,
                streamed=st.out_queue is not None,
            )

        for st in reported:
            if st.request_id not in seen:
                seen.add(st.request_id)
                outputs.append(out(st, st.token_ids[-1:]))
        # requests finished outside decode (aborts, admission errors,
        # a first token that already ended the request)
        for st in list(self._requests.values()):
            if st.finished and st.request_id not in seen:
                outputs.append(out(st, []))
        for o in outputs:
            if o.finished:
                self._requests.pop(o.request_id, None)
        return outputs

    def generate(self, prompts, params: SamplingParams | list | None = None) -> list[RequestOutput]:
        """Blocking batch generation with continuous batching underneath."""
        if len(prompts) == 0:
            return []
        single = isinstance(prompts[0], numbers.Integral)
        if single:
            prompts = [prompts]
        if params is None or isinstance(params, SamplingParams):
            params = [params or SamplingParams()] * len(prompts)
        ids = [self.add_request(p, sp) for p, sp in zip(prompts, params)]
        finals: dict[str, RequestOutput] = {}
        while self.has_unfinished():
            for o in self.step():
                if o.finished:
                    finals[o.request_id] = o
        results = [finals[i] for i in ids]
        return results[0] if single else results


# --------------------------------------------------------- the rank twins
def _tree_to(tree: dict, device) -> dict:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def _send_shards(ranks, params: dict, config, mesh) -> None:
    """Give ranks 1..n-1 their shards of ``params`` (a tree on any device):
    leaf by leaf and rank by rank, the leaf's path, shape and dtype to
    every rank, then the shard over the group (a broadcast from rank 0 on
    rank 0's device), so one shard at a time is in flight; then None."""
    from ray_tpu_torch.models.llama import param_logical_axes
    from ray_tpu_torch.parallel.mesh import DEFAULT_RULES, shard_slices

    group = ranks.group

    def walk(node, axes, path):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, axes[name], path + (name,))
                continue
            for r in range(1, ranks.size):
                shard = leaf[shard_slices(leaf.shape, DEFAULT_RULES.spec(axes[name], mesh), mesh, r)]
                shard = shard.to(group.device).contiguous()
                ranks.send_all((path + (name,), r, tuple(shard.shape), shard.dtype))
                group.broadcast(shard, 0)

    walk(params, param_logical_axes(config), ())
    ranks.send_all(None)


def _recv_shards(group, conn) -> dict:
    """A rank's side of ``_send_shards``: its own leaves, the others' dropped."""
    tree: dict = {}
    while (item := _recv(conn)) is not None:
        path, r, shape, dtype = item
        t = group.broadcast(torch.empty(shape, dtype=dtype, device=group.device), 0)
        if r != group.rank:
            continue
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = t
    return tree


def _rank_engine(group, conn, config, params=None, **kw):
    """A rank process's twin of rank 0's engine (``parallel/ranks.py``'s
    factory): the same geometry on this rank's device, its weight shard
    from the seed or streamed by rank 0."""
    if params == "stream":
        params = _recv_shards(group, conn)
    return LLMEngine(config, params, _tp_group=group, **kw)

"""Serving telemetry plane: flight recorder, live SLO metrics, tracing
(port of ray_tpu/llm/telemetry.py).

The engine (``llm/engine.py``) reports through this module into the
port's observability substrate: ``util/metrics.py`` (this process's
registry and its Prometheus exposition) and ``util/tracing.py`` (JSONL
spans under the session directory).

Rule: no device synchronization. Every sample here is host-side scheduler
state (shadow lengths, queue depths, wall clocks at the one-step-delayed
drain); nothing reads a device tensor or adds work to a captured graph.
The cost of being observed is a few dict updates per step.

Three pieces, as in ray_tpu:

- **Flight recorder**: a fixed-size ring of per-step records (phase, host
  wall ms, occupancy, queue depth, spec round accounting, recompile
  sentinel) and a ring of finished-request lifecycle records (submit /
  admit / first-token / finish stamps, per-token ITL samples).
  ``LLMEngine.telemetry()`` returns the snapshot; on an engine error the
  ring is dumped as JSONL into the session directory. The recompile
  sentinel watches each registered fixed-shape entry. In ray_tpu an entry
  is a jit function and the sentinel reads its cache size; in the port an
  entry is a CUDA graph (``llm/cuda/graph.py::FusedDecode``) and the
  sentinel reads its ``captures`` count: 1 after the capture in its
  constructor, and any growth after that is a re-capture, counted as a
  recompile. Entry names are ray_tpu's; one graph holds what ray_tpu
  compiles as one or two programs, so it is registered once:

  ============================  ==========================================
  ray_tpu entry                  port graph
  ============================  ==========================================
  ``fused_step`` (slots)         the slot decode graph (``SlotStep``)
  ``fused_attn`` + ``fused_append`` (paged)  the paged decode graph
                                 (``PagedStep``), as ``fused_attn``
  ``verify_step`` (slots)        the slot spec graph (``SpecSlotStep``)
  ``verify_attn`` + ``verify_append`` (paged)  the paged spec graph
                                 (``SpecPagedStep``), as ``verify_attn``
  ============================  ==========================================

  The lane deltas (``set_lane``, ``set_table``, ``set_table_cell``) are
  in-place writes with nothing compiled, so nothing is registered for them.
- **Live SLO metrics**: the catalog ``METRICS`` (TTFT / ITL / queue-wait
  histograms, token / preemption / recompile counters, KV occupancy /
  bytes / spec acceptance gauges), identical to ray_tpu's, tagged by
  model / replica / stage.
- **Request-lifecycle tracing**: admission, prefill, first-token, decode
  and request spans when RT_TRACING=1.

The disagg handoff, migration and KV-spill hooks are called by the
engine's ``llm/disagg/`` and ``llm/migrate.py`` paths, and
``RouterTelemetry`` by the routers (``llm/disagg/router.py``,
``llm/kvplane/routing.py``) and ``serve/overload.py``. The cluster KV
plane's hooks (``on_prefix_fetch``, ``on_prefetch_hit``) are called by
the engine's remote-prefix tier.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
import weakref
from collections import deque

from ray_tpu_torch.util import tracing

# SLO histogram boundaries (seconds): decode steps are single-digit ms on
# chip, prefill stalls are tens-to-hundreds of ms, a cold compile is
# seconds — the buckets must resolve all three regimes.
_LATENCY_BOUNDARIES = [0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0]

_SERVE_TAGS = ("model", "replica", "stage")

# The serving metric catalog: name -> {kind, desc, tags[, boundaries]},
# entry for entry ray_tpu's, so dashboards and alerts built on ray_tpu's
# series read the port's unchanged. Catalog entries for paths the port
# does not have yet stay, at zero.
METRICS: dict[str, dict] = {
    "rt_llm_ttft_s": {
        "kind": "histogram", "tags": _SERVE_TAGS, "boundaries": _LATENCY_BOUNDARIES,
        "desc": "time to first token: request submit -> first emitted token",
    },
    "rt_llm_itl_s": {
        "kind": "histogram", "tags": _SERVE_TAGS, "boundaries": _LATENCY_BOUNDARIES,
        "desc": "inter-token latency between consecutive emitted tokens",
    },
    "rt_llm_queue_wait_s": {
        "kind": "histogram", "tags": _SERVE_TAGS, "boundaries": _LATENCY_BOUNDARIES,
        "desc": "admission queue wait: request submit -> prefill-wave start",
    },
    "rt_llm_tokens_total": {
        "kind": "counter", "tags": _SERVE_TAGS,
        "desc": "generated tokens emitted to consumers",
    },
    "rt_llm_prefill_tokens_total": {
        "kind": "counter", "tags": _SERVE_TAGS,
        "desc": "prompt tokens prefilled (transferred-KV admissions count 0)",
    },
    "rt_llm_requests_finished_total": {
        "kind": "counter", "tags": _SERVE_TAGS + ("reason",),
        "desc": "finished requests by finish reason",
    },
    "rt_llm_preemptions_total": {
        "kind": "counter", "tags": _SERVE_TAGS,
        "desc": "recompute preemptions (paged pool pressure)",
    },
    "rt_llm_recompiles_total": {
        "kind": "counter", "tags": _SERVE_TAGS,
        "desc": "fused-entry recompiles after warmup (serving-path bug sentinel)",
    },
    "rt_llm_kv_occupancy": {
        "kind": "gauge", "tags": _SERVE_TAGS,
        "desc": "occupied fraction of KV-cache token capacity",
    },
    "rt_llm_kv_hbm_bytes": {
        "kind": "gauge", "tags": _SERVE_TAGS,
        "desc": "occupied KV bytes (scale-inclusive for int8 caches)",
    },
    "rt_llm_queue_depth": {
        "kind": "gauge", "tags": _SERVE_TAGS,
        "desc": "requests waiting for a slot",
    },
    "rt_llm_slots_in_use": {
        "kind": "gauge", "tags": _SERVE_TAGS,
        "desc": "KV slots bound to live sequences",
    },
    "rt_llm_spec_acceptance": {
        "kind": "gauge", "tags": _SERVE_TAGS,
        "desc": "speculative acceptance rate over drained rounds (lifetime mean)",
    },
    "rt_llm_collective_wire_bytes_total": {
        "kind": "counter", "tags": _SERVE_TAGS,
        "desc": "estimated ICI bytes shipped by the fused step's collectives (jaxpr-accounted per step)",
    },
    "rt_llm_handoff_bytes_total": {
        "kind": "counter", "tags": _SERVE_TAGS,
        "desc": "disagg KV handoff bytes leaving prefill replicas",
    },
    "rt_llm_handoffs_total": {
        "kind": "counter", "tags": _SERVE_TAGS + ("event",),
        "desc": "disagg handoff events (published/scattered/lost/reused)",
    },
    # cluster KV plane (llm/kvplane/): prefix reuse by tier. "local" =
    # this replica's own PrefixCache; "remote" = a block fetched from
    # another replica over the object plane. Cluster hit-rate =
    # sum(rate(hits)) / rate(requests); the Grafana "cluster prefix
    # reuse" panel plots both tiers.
    "rt_llm_prefix_hits_total": {
        "kind": "counter", "tags": _SERVE_TAGS + ("tier",),
        "desc": "prefix-cache hits by tier (local replica cache vs remote cluster KV plane)",
    },
    "rt_llm_prefix_tokens_saved_total": {
        "kind": "counter", "tags": _SERVE_TAGS + ("tier",),
        "desc": "prompt tokens served from cached prefixes instead of prefill compute, by tier",
    },
    "rt_llm_prefix_fetch_bytes_total": {
        "kind": "counter", "tags": _SERVE_TAGS,
        "desc": "bytes fetched from remote replicas' published prefix blocks (cluster KV plane)",
    },
    # overload plane (serve/overload.py): admission control sheds by
    # request class BEFORE queue wait grows, queue wait grows before
    # decode ITL ever does — these series are how a dashboard sees that
    # degradation order actually holding.
    "rt_llm_requests_shed_total": {
        "kind": "counter", "tags": _SERVE_TAGS + ("class",),
        "desc": (
            "admission sheds (OverloadedError) by request class; each replica ingress counts "
            "its own shed and a router counts once per client request, so separate by stage "
            "when summing request-level shed rates"
        ),
    },
    "rt_llm_admission_queue_wait_est_ms": {
        "kind": "gauge", "tags": _SERVE_TAGS,
        "desc": "admission controller's live queue-wait estimate (queue depth x service-time EMA / slots)",
    },
    "rt_llm_retry_budget_exhausted_total": {
        "kind": "counter", "tags": _SERVE_TAGS,
        "desc": "requests whose router failover budget ran out (terminal typed error surfaced)",
    },
    "rt_llm_drain_state": {
        "kind": "gauge", "tags": _SERVE_TAGS,
        "desc": "replica drain lifecycle: 0 serving, 1 draining (shedding new work), 2 drained",
    },
    # live request migration (llm/migrate.py): preemption-tolerant
    # serving's evacuation path. Outcomes: "checkpointed" (source
    # extracted + published), "restored" (peer spliced), "aborted"
    # (could not checkpoint before the deadline — the abort fallback),
    # "resumed"/"lost" (router-stage resume leg succeeded / checkpoint
    # gone before fetch). Source and destination replicas count their
    # own halves, routers count once per client request — separate by
    # stage when summing.
    "rt_llm_migrations_total": {
        "kind": "counter", "tags": _SERVE_TAGS + ("outcome",),
        "desc": "live request migrations by outcome (checkpointed/restored/aborted/resumed/lost)",
    },
    "rt_llm_migration_bytes_total": {
        "kind": "counter", "tags": _SERVE_TAGS,
        "desc": "live_state checkpoint bytes (KV block + scales) moved over the object plane",
    },
    "rt_llm_migration_splice_s": {
        "kind": "histogram", "tags": _SERVE_TAGS, "boundaries": _LATENCY_BOUNDARIES,
        "desc": "splice latency: restore ingress -> first post-splice token on the peer",
    },
    # latency-hiding KV plane v2 (ROADMAP item 3): the async fetch span
    # (runs on the engine's fetch worker, overlapping prefill/decode
    # steps — the histogram is what the A/B bench reads), predictive
    # prefetch attribution (a local-tier hit served by a block pulled in
    # ahead of demand), and the tiered-conversation-KV spill volume.
    "rt_llm_prefix_fetch_overlap_s": {
        "kind": "histogram", "tags": _SERVE_TAGS, "boundaries": _LATENCY_BOUNDARIES,
        "desc": "async remote prefix fetch span (launch -> result landed), overlapped with serving steps",
    },
    "rt_llm_prefix_prefetch_hits_total": {
        "kind": "counter", "tags": _SERVE_TAGS,
        "desc": "local prefix hits served by predictively prefetched blocks (remote->local conversion)",
    },
    "rt_llm_kv_spilled_bytes_total": {
        "kind": "counter", "tags": _SERVE_TAGS,
        "desc": "conversation KV bytes spilled out of HBM by suspend_request (tiered conversation KV)",
    },
}

_instruments: dict = {}
_instr_lock = threading.Lock()


def instruments() -> dict:
    """Instantiate (once per process) and return the catalog's
    ``util.metrics`` instruments, name -> Counter/Gauge/Histogram.
    Registration is shared across engines in the process; per-engine
    separation rides the tags."""
    from ray_tpu_torch.util import metrics as m

    with _instr_lock:
        if _instruments:
            return _instruments
        ctor = {"counter": m.Counter, "gauge": m.Gauge, "histogram": m.Histogram}
        for name, spec in METRICS.items():
            kw = {"description": spec["desc"], "tag_keys": tuple(spec["tags"])}
            if spec["kind"] == "histogram":
                kw["boundaries"] = list(spec["boundaries"])
            _instruments[name] = ctor[spec["kind"]](name, **kw)
        return _instruments


def default_tags(stage: str, model: str | None = None, replica: str | None = None) -> dict:
    """The model/replica/stage tag triple every serving series carries.
    The replica defaults to RT_WORKER_ID, else the process id."""
    return {
        "model": model or "default",
        "replica": replica or os.environ.get("RT_WORKER_ID", str(os.getpid())),
        "stage": stage,
    }


# ----------------------------------------------------------------------
# flight recorder
# ----------------------------------------------------------------------
class FlightRecorder:
    """Fixed-size ring of per-step records + finished-request lifecycle
    records, all host-side. Thread-safe against concurrent readers.

    The step ring stores flat TUPLES (schema ``STEP_FIELDS``) and expands
    them to dicts only in ``snapshot()``: ``record_step`` runs on every
    serving step, so it allocates one small tuple."""

    STEP_FIELDS = (
        "step", "t", "phase", "wall_ms", "admitted", "emitted", "batch", "waiting",
        "occupied_tokens", "capacity_tokens", "pages_free", "pages_total",
        "recompiled", "spec_k", "spec_accepted",
    )

    def __init__(self, max_steps: int = 512, max_requests: int = 256):
        self.steps: deque = deque(maxlen=max_steps)
        self.requests: deque = deque(maxlen=max_requests)
        # async prefix-fetch spans (the cluster KV plane's fetch worker; not ported)
        self.fetches: deque = deque(maxlen=max_requests)
        self._lock = threading.Lock()
        self._entries: dict[str, tuple] = {}  # name -> (graph, warm capture count or None)
        self.recompiles: dict[str, int] = {}
        self.step_count = 0

    # -- recompile sentinel --
    def register_entry(self, name: str, graph) -> None:
        """Register a FIXED-SHAPE entry: an object with a ``captures``
        count (``FusedDecode``). Captured once per engine; growth after
        the first observed capture is counted as a recompile."""
        if graph is not None and hasattr(graph, "captures"):
            self._entries[name] = (graph, None)

    def check_recompiles(self) -> list[str]:
        """Poll every registered entry's capture count (a host attribute
        read, no device work). Returns the entries that re-captured since
        the last check."""
        hits: list[str] = []
        for name, (graph, warm) in list(self._entries.items()):
            size = int(graph.captures)
            if warm is None:
                if size > 0:  # first capture = warm baseline
                    self._entries[name] = (graph, size)
                continue
            if size > warm:
                self.recompiles[name] = self.recompiles.get(name, 0) + (size - warm)
                self._entries[name] = (graph, size)
                hits.append(name)
        return hits

    def record_step(self, row: tuple) -> None:
        """``row`` = STEP_FIELDS[1:] values (the step counter is
        prepended here)."""
        with self._lock:
            self.step_count += 1
            self.steps.append((self.step_count,) + row)

    def record_request(self, rec: dict) -> None:
        with self._lock:
            self.requests.append(rec)

    def record_fetch(self, rec: dict) -> None:
        with self._lock:
            self.fetches.append(rec)

    def snapshot(self) -> dict:
        with self._lock:
            rows = list(self.steps)
            reqs = [dict(r) for r in self.requests]
            fetches = [dict(r) for r in self.fetches]
            count = self.step_count
            recs = dict(self.recompiles)
        steps = []
        for row in rows:
            d = dict(zip(self.STEP_FIELDS, row))
            # drop layout-/mode-inapplicable fields (None) for readability
            steps.append({k: v for k, v in d.items() if v is not None})
        return {"step_count": count, "steps": steps, "requests": reqs,
                "fetches": fetches, "recompiles": recs}

    def dump_jsonl(self, path: str, header: dict | None = None) -> str:
        """Write the ring as JSONL (one header line, then one line per
        step record, then one per request record) for postmortems."""
        snap = self.snapshot()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps({"kind": "flight_header", "ts": time.time(),
                                "recompiles": snap["recompiles"], **(header or {})}) + "\n")
            for rec in snap["steps"]:
                f.write(json.dumps({"kind": "step", **rec}) + "\n")
            for rec in snap["requests"]:
                f.write(json.dumps({"kind": "request", **rec}) + "\n")
        return path


# ----------------------------------------------------------------------
# engine-facing facade
# ----------------------------------------------------------------------
# the engine's graph attribute and spec state -> ray_tpu's entry name (module docstring)
_GRAPH_ENTRY = {("slots", False): "fused_step", ("paged", False): "fused_attn",
                ("slots", True): "verify_step", ("paged", True): "verify_attn"}


class EngineTelemetry:
    """Everything LLMEngine calls, one object. All entry points are
    host-only and cheap; the engine holds its own lock while calling in,
    so internal state needs no second lock beyond the recorder's."""

    def __init__(self, engine, tags: dict | None = None):
        # a weak reference: the engine owns this object, and a strong one
        # back would keep a dropped engine's cache and graph on the card
        # until the cycle collector runs
        self.engine = weakref.proxy(engine)
        base = default_tags("engine")
        base.update(tags or {})
        self.tags = {k: str(v) for k, v in base.items() if k in _SERVE_TAGS}
        self.m = instruments()
        self.recorder = FlightRecorder(
            max_steps=int(os.environ.get("RT_LLM_FLIGHT_STEPS", "512")),
            max_requests=int(os.environ.get("RT_LLM_FLIGHT_REQUESTS", "256")),
        )
        # hot-path handles: tags resolved once (``Metric.bind``)
        self._b_ttft = self.m["rt_llm_ttft_s"].bind(self.tags)
        self._b_itl = self.m["rt_llm_itl_s"].bind(self.tags)
        self._b_qwait = self.m["rt_llm_queue_wait_s"].bind(self.tags)
        self._b_tokens = self.m["rt_llm_tokens_total"].bind(self.tags)
        self._b_pf_tokens = self.m["rt_llm_prefill_tokens_total"].bind(self.tags)
        self._b_preempt = self.m["rt_llm_preemptions_total"].bind(self.tags)
        self._b_recompiles = self.m["rt_llm_recompiles_total"].bind(self.tags)
        self._b_qdepth = self.m["rt_llm_queue_depth"].bind(self.tags)
        self._b_slots = self.m["rt_llm_slots_in_use"].bind(self.tags)
        self._b_occ = self.m["rt_llm_kv_occupancy"].bind(self.tags)
        self._b_hbm = self.m["rt_llm_kv_hbm_bytes"].bind(self.tags)
        self._b_spec = self.m["rt_llm_spec_acceptance"].bind(self.tags)
        self._b_wire = self.m["rt_llm_collective_wire_bytes_total"].bind(self.tags)
        self._wire_accum = 0.0
        # prefix-reuse tiers: per-ADMISSION events, off the per-step budget
        self._b_pfx_hits = {
            tier: self.m["rt_llm_prefix_hits_total"].bind({**self.tags, "tier": tier})
            for tier in ("local", "remote")
        }
        self._b_pfx_tokens = {
            tier: self.m["rt_llm_prefix_tokens_saved_total"].bind({**self.tags, "tier": tier})
            for tier in ("local", "remote")
        }
        self._b_pfx_bytes = self.m["rt_llm_prefix_fetch_bytes_total"].bind(self.tags)
        self._b_pfx_prefetch = self.m["rt_llm_prefix_prefetch_hits_total"].bind(self.tags)
        self._b_fetch_overlap = self.m["rt_llm_prefix_fetch_overlap_s"].bind(self.tags)
        self._b_spill = self.m["rt_llm_kv_spilled_bytes_total"].bind(self.tags)
        # the sentinel series exist at 0, so an alert fires on ANY increase
        self._b_recompiles.inc(0.0)
        self._b_preempt.inc(0.0)
        from ray_tpu_torch.llm.kv_quant import bytes_per_token

        cfg = engine.config
        self._bytes_per_token = int(bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd, engine.kv_dtype))
        if engine.kv_layout == "paged":
            self._capacity_tokens = (engine._pcfg.num_pages - 1) * engine._pcfg.page_size
        else:
            self._capacity_tokens = engine.max_num_seqs * engine.max_seq_len
        # gauges and the recompile poll refresh every SAMPLE_EVERY steps
        # (the flight RECORD still lands every step)
        self.SAMPLE_EVERY = 16
        self._nstep = 0
        self._tok_accum = 0.0
        self._last_preemptions = 0
        self._dumped = False
        # live EMAs an admission controller reads (inter-token latency,
        # per-request service time admit -> finish)
        self.itl_ema_s = 0.0
        self.service_ema_s = 0.0
        self.sample_hook = None

    # -- registration -----------------------------------------------------
    def register_fused_entries(self) -> None:
        """Register the engine's decode graph for the recompile sentinel
        under ray_tpu's entry name (``_GRAPH_ENTRY``); a host engine
        captures nothing, and its count stays 0."""
        eng = self.engine
        graph = getattr(eng, "_decode", None)
        if graph is not None:
            self.recorder.register_entry(_GRAPH_ENTRY[(eng.kv_layout, eng._spec_cfg is not None)], graph)

    # -- wire-bytes accounting -------------------------------------------
    def _wire_bytes(self) -> float:
        """Per-step collective wire bytes of a tensor-parallel engine, the
        ``rt_llm_collective_wire_bytes_total`` series' source: what rank 0's
        group counted over the last decode step (``collective/ici.py``'s
        factors; ray_tpu reads the same from the fused step's jaxpr); 0 at
        tp = 1."""
        return float(getattr(self.engine, "tp_wire_step_bytes", 0.0))

    # -- request lifecycle ------------------------------------------------
    def on_submit(self, st, submitted_at: float | None = None, parent_trace: tuple | None = None) -> None:
        """Stamp admission-queue entry. ``parent_trace`` (trace_id,
        span_id) joins an existing trace."""
        st.t_submit = float(submitted_at) if submitted_at is not None else time.time()
        st.kv_transferred = getattr(st, "prefilled", None) is not None
        if tracing.enabled():
            if parent_trace is not None:
                trace_id, parent_id = parent_trace[0], parent_trace[1]
            else:
                trace_id, parent_id = tracing.child_context()
            st.trace = (trace_id, uuid.uuid4().hex[:16], parent_id)  # (trace, root span, parent)

    def on_bind(self, st, t_prefill_start: float) -> None:
        """Slot bound + prefill executed: close the admission and prefill
        spans, observe queue wait. FIRST bind only (a recompute-preempted
        request re-binds through here; its queue wait was observed)."""
        now = time.time()
        if st.t_admit != 0.0:
            return
        st.t_admit = now
        # queue wait: submit -> prefill-wave start; the finish record reuses it
        st.queue_wait = max(t_prefill_start - st.t_submit, 0.0)
        self._b_qwait.observe(st.queue_wait)
        if not getattr(st, "kv_transferred", False) and not st.token_ids:
            self._b_pf_tokens.inc(float(len(st.prompt_token_ids)))
        if st.trace is not None:
            self._span(st, "llm.admission", st.t_submit, t_prefill_start)
            self._span(st, "llm.prefill", t_prefill_start, now)

    def on_emit(self, st, now: float | None = None) -> None:
        """One token reached the host (the one-step-delayed drain, or the
        sync loop's readback). The first observes TTFT, later ones ITL."""
        now = time.time() if now is None else now
        if st.t_first == 0.0:
            st.t_first = now
            self._b_ttft.observe(max(now - st.t_submit, 0.0))
            if st.t_restore:
                # a restored request's first token is the splice landing
                self.m["rt_llm_migration_splice_s"].observe(max(now - st.t_restore, 0.0), tags=self.tags)
            if st.trace is not None:
                self._span(st, "llm.first_token", st.t_admit or st.t_submit, now)
        else:
            gap = now - st.t_last
            st.itls.append(gap)
            self._b_itl.observe(max(gap, 0.0))
            g = max(gap, 0.0)
            self.itl_ema_s = g if self.itl_ema_s == 0.0 else 0.9 * self.itl_ema_s + 0.1 * g
        st.t_last = now
        self._tok_accum += 1.0  # flushed into the counter on sample ticks

    def on_finish(self, st, reason: str) -> None:
        now = time.time()
        if st.t_admit:
            dur = max(now - st.t_admit, 0.0)
            self.service_ema_s = dur if self.service_ema_s == 0.0 else 0.9 * self.service_ema_s + 0.1 * dur
        self.m["rt_llm_requests_finished_total"].inc(1.0, tags={**self.tags, "reason": reason.split(":")[0]})
        self.recorder.record_request({
            "request_id": st.request_id,
            "reason": reason,
            "submit_t": st.t_submit,
            "admit_t": st.t_admit,
            "first_token_t": st.t_first,
            "finish_t": now,
            "ttft_s": (st.t_first - st.t_submit) if st.t_first else None,
            "queue_wait_s": getattr(st, "queue_wait", None),
            "itl_s": list(st.itls),
            "tokens": len(st.token_ids),
            "prompt_tokens": len(st.prompt_token_ids),
            "preemptions": st.preemptions,
            "trace_id": st.trace[0] if st.trace else None,
        })
        if st.trace is not None:
            if st.t_first:
                self._span(st, "llm.decode", st.t_first, now)
            # the root span, recorded last so child spans exist when a viewer walks the tree
            trace_id, span_id, parent_id = st.trace
            tracing.record_span(
                "llm.request", "server", trace_id, span_id, parent_id,
                int(st.t_submit * 1e9), int(now * 1e9),
                {"request_id": st.request_id, "reason": reason,
                 "tokens": len(st.token_ids), "stage": self.tags["stage"]},
            )

    def on_prefix_hit(self, tier: str, tokens: int, nbytes: int = 0) -> None:
        """A prompt admission reused a cached prefix: ``tier`` "local"
        (this engine's PrefixCache) or "remote" (the cluster KV plane,
        ``nbytes`` transferred)."""
        self._b_pfx_hits[tier].inc(1.0)
        self._b_pfx_tokens[tier].inc(float(tokens))
        if nbytes:
            self._b_pfx_bytes.inc(float(nbytes))

    def on_prefetch_hit(self) -> None:
        """A local hit served by a predictively prefetched block (the
        cluster KV plane's prefetcher)."""
        self._b_pfx_prefetch.inc(1.0)

    def on_kv_spill(self, nbytes: int) -> None:
        """``suspend_request`` spilled a conversation's KV to host memory."""
        self._b_spill.inc(float(nbytes))

    def on_prefix_fetch(self, t0: float, t1: float, tokens: int, hit: bool) -> None:
        """An async remote prefix fetch span closed (the engine's fetch
        worker)."""
        self._b_fetch_overlap.observe(max(t1 - t0, 0.0))
        self.recorder.record_fetch({"t0": float(t0), "t1": float(t1), "tokens": int(tokens), "hit": bool(hit)})

    def on_handoff_extract(self, st, payload: dict, t_start: float) -> None:
        """Prefill side of the disagg handoff (``_complete_handoff``): the
        KV block left the cache into a handoff payload; plants the trace
        context and the submit stamp in it."""
        nbytes = int(payload["k"].nbytes + payload["v"].nbytes + payload["logits"].nbytes)
        if payload.get("k_scale") is not None:
            nbytes += int(payload["k_scale"].nbytes + payload["v_scale"].nbytes)
        self.m["rt_llm_handoff_bytes_total"].inc(float(nbytes), tags=self.tags)
        self.m["rt_llm_handoffs_total"].inc(1.0, tags={**self.tags, "event": "extracted"})
        payload["submitted_at"] = st.t_submit
        if st.trace is not None:
            payload["trace"] = {"trace_id": st.trace[0], "parent_id": st.trace[1]}
            self._span(st, "llm.handoff", t_start, time.time(), nbytes=nbytes)

    def on_scatter_in(self, st, t_start: float) -> None:
        """Decode side of the disagg handoff (``_admit_prefilled``): a
        transferred KV block (a handoff, or a restored checkpoint's)
        scattered into the cache."""
        self.m["rt_llm_handoffs_total"].inc(1.0, tags={**self.tags, "event": "scattered"})
        if st.trace is not None:
            self._span(st, "llm.handoff.scatter_in", t_start, time.time())

    def on_migration(self, outcome: str, nbytes: int = 0) -> None:
        """Live-migration event: "checkpointed" (``checkpoint_request``,
        also under ``suspend_request``) or "restored" (``restore_request``),
        with the block's bytes."""
        self.m["rt_llm_migrations_total"].inc(1.0, tags={**self.tags, "outcome": str(outcome)})
        if nbytes:
            self.m["rt_llm_migration_bytes_total"].inc(float(nbytes), tags=self.tags)

    def _span(self, st, name: str, t0: float, t1: float, **attrs) -> None:
        trace_id, root_id, _ = st.trace
        tracing.record_span(
            name, "internal", trace_id, uuid.uuid4().hex[:16], root_id,
            int(t0 * 1e9), int(t1 * 1e9),
            {"request_id": st.request_id, "stage": self.tags["stage"], **attrs},
        )

    # -- per-step ----------------------------------------------------------
    def on_step(self, t0: float, n_admitted: int, n_emitted: int, spec_drained: tuple | None) -> None:
        """Called at the tail of engine.step() under the engine lock.
        Everything read here is host shadow state."""
        eng = self.engine
        now = time.time()
        wall_ms = (time.perf_counter() - t0) * 1e3
        slots_in_use = sum(1 for s in eng._slots if s is not None)
        waiting = len(eng._waiting)
        phase = (
            "idle" if not n_admitted and not slots_in_use and not n_emitted
            else "mixed" if n_admitted and (slots_in_use or n_emitted)
            else "prefill" if n_admitted
            else "decode"
        )
        if eng.kv_layout == "paged":
            occupied = int(eng._lengths.sum())
        else:
            occupied = sum(len(s.prompt_token_ids) + len(s.token_ids) for s in eng._slots if s is not None)
        capacity = self._capacity_tokens
        per_tok = self._bytes_per_token
        self._nstep += 1
        # the first step samples; so does a drained engine, so the
        # accumulators flush when traffic stops
        sample = self._nstep % self.SAMPLE_EVERY == 1 or slots_in_use == 0
        recompiled = self.recorder.check_recompiles() if sample else []
        if recompiled:
            self._b_recompiles.inc(float(len(recompiled)))
        preempt_delta = eng.preemption_count - self._last_preemptions
        if preempt_delta > 0:
            self._b_preempt.inc(float(preempt_delta))
        self._last_preemptions = eng.preemption_count

        paged = eng.kv_layout == "paged"
        sd = spec_drained or (None, None)
        self.recorder.record_step((
            now, phase, round(wall_ms, 4), n_admitted, n_emitted, slots_in_use, waiting,
            occupied, capacity,
            eng._page_alloc.free_pages if paged else None,
            eng._pcfg.num_pages - 1 if paged else None,
            recompiled or None, sd[0], sd[1],
        ))

        wire = self._wire_bytes()
        if slots_in_use and eng._device_resident and wire:
            # accumulate locally (one float add), flush on sample ticks
            self._wire_accum += wire
        if not sample:
            return
        if self._tok_accum:
            self._b_tokens.inc(self._tok_accum)
            self._tok_accum = 0.0
        if self._wire_accum:
            self._b_wire.inc(self._wire_accum)
            self._wire_accum = 0.0
        self._b_qdepth.set(float(waiting))
        self._b_slots.set(float(slots_in_use))
        self._b_occ.set(occupied / max(capacity, 1))
        self._b_hbm.set(float(occupied * per_tok))
        if eng._spec_cfg is not None:
            prop = eng._spec_proposed
            if prop:
                self._b_spec.set(eng._spec_accepted / prop)
        if self.sample_hook is not None:
            try:
                self.sample_hook(waiting)
            except Exception:  # noqa: BLE001 — observers never break the step
                pass

    # -- postmortem --------------------------------------------------------
    def dump_on_error(self, exc: BaseException) -> str | None:
        """Engine died mid-step: persist the flight ring as JSONL under
        the session directory (once per engine). Returns the path, or None
        if dumping itself failed (a dying engine must still raise its real
        error)."""
        if self._dumped:
            return None
        self._dumped = True
        try:
            d = os.path.join(tracing.session_dir(), "llm_flight")
            path = os.path.join(d, f"flight-{os.getpid()}-{int(time.time() * 1e3)}.jsonl")
            eng = self.engine
            return self.recorder.dump_jsonl(path, header={
                "error": f"{type(exc).__name__}: {exc}",
                "tags": self.tags,
                "kv_layout": eng.kv_layout,
                "kv_dtype": str(eng.kv_dtype),
                "max_num_seqs": eng.max_num_seqs,
                "device_resident": eng._device_resident,
            })
        except Exception:
            return None

    def snapshot(self) -> dict:
        snap = self.recorder.snapshot()
        snap["tags"] = dict(self.tags)
        snap["wire_bytes_per_step"] = self._wire_bytes()
        return snap


# ----------------------------------------------------------------------
# router-facing metrics (control plane: no engine, no recorder)
# ----------------------------------------------------------------------
class RouterTelemetry:
    """Counters for the routers' control-plane events, sharing the
    serving catalog so one scrape covers the whole split."""

    def __init__(self, tags: dict | None = None):
        base = default_tags("router")
        base.update(tags or {})
        self.tags = {k: str(v) for k, v in base.items() if k in _SERVE_TAGS}
        self.m = instruments()

    def on_published(self, nbytes: int) -> None:
        self.m["rt_llm_handoff_bytes_total"].inc(float(nbytes), tags=self.tags)
        self.m["rt_llm_handoffs_total"].inc(1.0, tags={**self.tags, "event": "published"})

    def on_lost(self) -> None:
        self.m["rt_llm_handoffs_total"].inc(1.0, tags={**self.tags, "event": "lost"})

    def on_reused(self) -> None:
        self.m["rt_llm_handoffs_total"].inc(1.0, tags={**self.tags, "event": "reused"})

    def on_failed(self) -> None:
        self.m["rt_llm_requests_finished_total"].inc(1.0, tags={**self.tags, "reason": "error"})

    def on_budget_exhausted(self) -> None:
        """A request's shared failover budget (serve/overload.RetryBudget)
        ran dry: the typed terminal error is about to surface."""
        self.m["rt_llm_retry_budget_exhausted_total"].inc(1.0, tags=self.tags)

    def on_migration(self, outcome: str) -> None:
        """Router-stage migration event: "resumed" (a dying replica's
        checkpoint spliced on a peer, zero recomputed tokens) or "lost"
        (checkpoint gone before the fetch: degraded to re-prefill)."""
        self.m["rt_llm_migrations_total"].inc(1.0, tags={**self.tags, "outcome": str(outcome)})

    def on_shed(self, shed_class: int) -> None:
        """The router itself shed a request (every ranked replica was
        overloaded or draining). Same series as the replica-level sheds
        but under this router's ``stage`` tag: a client request that shed
        at several replicas during failover counts once per replica plus
        once here, so separate by stage when summing request-level rates.
        Label clamped like the replicas'."""
        self.m["rt_llm_requests_shed_total"].inc(
            1.0, tags={**self.tags, "class": str(max(0, min(int(shed_class), 9)))}
        )

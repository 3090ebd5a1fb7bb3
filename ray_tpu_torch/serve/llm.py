"""Serve x LLM (port of ray_tpu/serve/llm.py): batched inference
deployments over the port's engine. One engine per replica; a background
stepping thread drives continuous batching across ALL concurrent requests
hitting the replica (each request blocks on its own completion event
while the engine interleaves every active sequence per decode step), and
autoscaling rides Serve's request-metric autoscaler.

    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import LLMConfig, build_llm_deployment

    app = build_llm_deployment(LLMConfig(model_config=LlamaConfig.llama3_8b(max_seq_len=2048),
                                         engine_kwargs={"kv_layout": "paged"}, num_tpus_per_replica=1))
    handle = serve.run(app, name="llm")
    out = handle.generate.remote([1, 2, 3], {"max_tokens": 16}).result()

**The card.** ``num_tpus_per_replica`` keeps ray_tpu's name and rule: -1
(auto) asks for no card at tensor_parallel_size 1; an explicit n asks for
n whole cards (the ``"GPU"`` resource, ``config.py``).

- A replica that asks for a card gets a fresh worker bound to it through
  ``CUDA_VISIBLE_DEVICES``: it sees only that card, holds it while it
  lives, and the card returns to the pool after its process has exited.
- A replica that asks for none runs its engine on the card all the same
  (the engine's default device): its worker is not bound and sees every
  card. ray_tpu's disaggregated and kvplane builders ask for no
  accelerator, so their replicas share the host's cards this way.

No replica falls back to the host when it finds no card: the engine
raises. ``engine_kwargs={"device": "cpu"}`` puts a replica's engine on
the host on purpose.

**Weights.** ``LLMConfig.params`` takes the port's parameter dict of host
tensors, which travel to the replicas out of band on the object plane and
move to the engine's device there. ``params=None`` builds the weights
inside each replica from ``engine_kwargs["seed"]`` (0 by default), so no
weights cross the host's shared memory.

**Tensor parallelism.** ``tensor_parallel_size > 1`` builds the
replica's engine over a tp mesh, as ray_tpu does: by default the
replica's visible cards (ValueError when it sees fewer than tp), or
``engine_kwargs["mesh"]`` when given, which is how one card serves tp=2
(``create_mesh(tp=2, devices=["cuda:0"] * 2)``; ``["cpu"] * 2`` on the
host). The engine is rank 0 in the replica's process and starts the
other ranks as processes of their own (``parallel/ranks.py``); they stop
with the engine, at the replica's shutdown or with its process.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import torch

from ray_tpu_torch import chaos
from ray_tpu_torch.exceptions import GetTimeoutError
from ray_tpu_torch.llm.engine import resolve_device
from ray_tpu_torch.serve.overload import (
    AdmissionController,
    OverloadedError,  # noqa: F401 (re-export: the ingress's typed 429)
    ReplicaDrainingError,  # noqa: F401 (re-export)
    StepperDiedError,
)


def _params_to(params, device):
    """The parameter dict (nested dicts of tensors) on ``device``."""
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    return params.to(device)


@dataclass
class LLMConfig:
    model_config: object = None  # ray_tpu_torch.models.llama.LlamaConfig
    params: object = None  # optional parameter dict of host tensors (models/llama.py)
    engine_kwargs: dict = field(default_factory=dict)  # max_num_seqs, ...
    # OpenAI-style API: model name echoed in responses, and an optional
    # tokenizer with encode(str)->list[int] / decode(list[int])->str
    # (e.g. transformers AutoTokenizer); without one, string prompts are
    # rejected and token-id prompts/completions pass through.
    model_id: str = "ray_tpu_torch-llama"
    tokenizer: object = None
    num_replicas: int = 1
    # -1 = auto: tensor_parallel_size cards when tp > 1, else none.
    # Explicit 0 opts out; n asks for n whole cards ("GPU").
    num_tpus_per_replica: float = -1
    autoscaling_config: object = None  # serve.AutoscalingConfig
    max_ongoing_requests: int = 32
    # a TP-sharded engine: > 1 raises NotImplementedError until the
    # multi-device axes are ported (ROADMAP.md, queue 1)
    tensor_parallel_size: int = 1
    # speculative decoding (llm.spec.SpecConfig): forwarded to the engine
    # unless engine_kwargs already carries its own "speculative"
    speculative: object = None
    # pre-warm at replica construction: run the serving hot path once
    # (smallest prefill bucket + decode; prefill+extract on prefill
    # replicas) BEFORE the replica reports healthy, so deployment
    # spin-up — not the first request — pays the first-call costs
    # (kernel loads, cuBLAS plans), in parallel across replicas
    prewarm: bool = True
    # admission control / load shedding at the replica ingress
    # (serve/overload.AdmissionConfig). None = the default caps; pass
    # AdmissionConfig(enabled=False) to admit unconditionally. Past the caps, generate() raises
    # OverloadedError (HTTP 429 + retry-after) with the lowest request
    # class (SamplingParams.priority / body "priority") shed first.
    admission: object = None
    # default evacuation deadline for a chaos-/signal-delivered
    # preemption notice (LLMServer.preempt -> drain(mode="migrate")):
    # checkpoints of in-flight decode state must publish inside it;
    # stragglers abort typed (the SIGTERM-with-deadline contract)
    preempt_deadline_s: float = 5.0


class LLMServer:
    """Deployment class: continuous batching across concurrent callers."""

    # stamped into every telemetry series/span this replica emits (the
    # model/replica/stage tag triple; llm/telemetry.py)
    telemetry_stage = "serve"

    def __init__(self, llm_config: LLMConfig):
        from ray_tpu_torch.llm import LLMEngine
        from ray_tpu_torch.llm.telemetry import default_tags

        cfg = llm_config.model_config
        if cfg is None:
            from ray_tpu_torch.models.llama import LlamaConfig

            cfg = LlamaConfig.tiny(dtype="float32")
        engine_kwargs = dict(llm_config.engine_kwargs)
        engine_kwargs.setdefault(
            "telemetry_tags", default_tags(self.telemetry_stage, model=llm_config.model_id)
        )
        if llm_config.speculative is not None:
            engine_kwargs.setdefault("speculative", llm_config.speculative)
        tp = int(llm_config.tensor_parallel_size or 1)
        if tp > 1 and "mesh" not in engine_kwargs:
            from ray_tpu_torch.parallel.mesh import create_mesh

            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n < tp:
                raise ValueError(f"tensor_parallel_size={tp} but replica sees {n} devices")
            engine_kwargs["mesh"] = create_mesh(tp=tp, devices=[torch.device("cuda", i) for i in range(tp)])
        params = llm_config.params
        if params is not None:
            # host tensors from the object plane -> the engine's device (rank 0's on a mesh)
            mesh = engine_kwargs.get("mesh")
            device = mesh.device_of(0) if mesh is not None else resolve_device(engine_kwargs.get("device"))
            params = _params_to(params, device)
        self.engine = LLMEngine(cfg, params=params, **engine_kwargs)
        self._done: dict[str, object] = {}  # request_id -> RequestOutput
        self._events: dict[str, threading.Event] = {}
        # per-request typed failures delivered OUT of band of the step
        # loop (live migration hands each evacuated waiter its own
        # RequestMigratedError; the abort fallback its 429)
        self._errors: dict[str, BaseException] = {}
        self._lock = threading.Lock()
        self._stopped = False
        # drain idempotency: a controller retrying its shutdown hook (or
        # a preemption racing a manual drain) re-observes the first
        # drain's outcome instead of double-releasing owned state
        self._drain_lock = threading.Lock()
        self._drain_result: dict | None = None
        self._preempt_deadline_s = float(llm_config.preempt_deadline_s)
        self._stepper_error: str | None = None
        self._work = threading.Event()
        # bounded admission at this replica's ingress (serve/overload.py):
        # past the caps generate() sheds with a typed OverloadedError
        # instead of joining an unbounded queue — overload degrades shed
        # rate and queue wait, never in-flight decode ITL
        self._admission = AdmissionController(self.engine, llm_config.admission)
        if llm_config.prewarm:
            # BEFORE the stepping thread exists: engine.generate drives
            # its own loop and would race a concurrent stepper
            self._prewarm()
        self._stepper = threading.Thread(target=self._step_loop, daemon=True, name="llm-stepper")
        self._stepper.start()

    def _prewarm(self):
        """Run the replica's hot path once at construction (smallest
        prefill bucket, decode step, sampling; the speculative round when
        enabled): the controller marks the replica RUNNING only after
        __init__, so a warmed fleet serves its first real request at
        steady-state latency instead of burying it under first-call
        costs."""
        self._prewarm_compile()
        self._seed_admission_emas()

    def _prewarm_compile(self):
        from ray_tpu_torch.llm import SamplingParams

        self.engine.generate([1, 2, 3], SamplingParams(max_tokens=2, temperature=0.0))

    def _prewarm_probe(self):
        """One WARM tiny request (every first-call cost already paid) — the
        admission plane's steady-state yardstick."""
        from ray_tpu_torch.llm import SamplingParams

        self.engine.generate([1, 2, 3], SamplingParams(max_tokens=2, temperature=0.0))

    def _seed_admission_emas(self):
        """Admission cold-start fix: the first-call-heavy prewarm request
        reads as a multi-second service time (the est-queue-wait cap
        would shed everything until the EMA decays), and with no samples
        at all the EMAs sit at 0 (the cap is vacuous until the first
        finish). Reset both EMAs and re-measure ONE warm probe request,
        so the first real admission decision sees steady-state numbers —
        the probe's on_finish/on_emit stamps seed service and ITL
        directly (an EMA at 0 adopts its first sample)."""
        tel = getattr(self.engine, "_tel", None)
        if tel is None:
            return
        tel.itl_ema_s = 0.0
        tel.service_ema_s = 0.0
        self._prewarm_probe()

    def check_health(self):
        """Serve health hook: a dead stepper means a dead engine."""
        if self._stepper_error is not None:
            raise StepperDiedError(f"llm stepper died:\n{self._stepper_error}")
        return True

    # -- engine pump: one thread advances every active sequence together --
    def _step_loop(self):
        while not self._stopped:
            if not self.engine.has_unfinished():
                # an IDLE replica must keep its cluster-index lease alive
                # (engine.step never runs here, so its heartbeat hook
                # never fires): a silent replica's published prefixes
                # would stop matching after ttl_s and, once pruned, could
                # never re-register
                plane = getattr(self.engine, "_kv_plane", None)
                if plane is not None:
                    plane.maybe_heartbeat()
                # block until a request arrives (no idle busy-poll)
                self._work.wait(timeout=1.0)
                self._work.clear()
                continue
            try:
                # preemption notice (SIGTERM-with-deadline, chaos-shaped):
                # a DROP rule delivers the notice and the replica starts
                # evacuating via live migration from a side thread — the
                # stepper keeps ticking until drain() stops it, exactly
                # like a real signal handler; a raises rule escalates to
                # SIGKILL semantics (stepper dies, no grace). Inert
                # one-flag check unarmed.
                if not chaos.apply("serve.preempt"):
                    if not self._admission.draining:
                        threading.Thread(
                            target=self.preempt, daemon=True, name="llm-preempt"
                        ).start()
                # chaos plane: a delay rule stalls this replica's decode
                # ticks, a drop rule skips them (a stall without sleeping
                # inside the rule), a raises rule kills the stepper
                # exactly like a replica crash (waiters fail, health check
                # trips, routers fail over). Inert one-flag check unarmed.
                if not chaos.apply("serve.step"):
                    time.sleep(0.005)  # dropped tick: yield, don't spin
                    continue
                outs = self.engine.step()
            except Exception:  # noqa: BLE001
                # a dying stepper must not wedge the replica silently:
                # fail every waiter now and mark the replica unhealthy so
                # the controller replaces it
                import traceback

                self._fail_all_waiters(traceback.format_exc())
                return
            self._deliver_outputs(outs)

    def _fail_all_waiters(self, reason: str) -> None:
        """The ONE failure sweep for a stepper that will never step again
        (death, drain's broken-engine path, shutdown with work in
        flight): record the reason, wake every blocked _await_finished
        waiter, and push sentinels into streaming consumers' queues —
        they block on their queues, not events, and re-check
        _stepper_error on waking."""
        if self._stepper_error is None:
            self._stepper_error = reason
        with self._lock:
            events = list(self._events.values())
            self._events.clear()
        for ev in events:
            ev.set()
        with self.engine._lock:
            streams = [st.out_queue for st in self.engine._requests.values() if st.out_queue is not None]
        for q in streams:
            q.put(None)

    def _deliver_outputs(self, outs):
        """Publish finished outputs to their blocked waiters (the stepper's
        delivery half; drain() reuses it for the post-abort cleanup step)."""
        for out in outs:
            # streamed requests deliver through their out_queue; putting
            # them in _done would leak (no collector ever pops them)
            if out.finished and not out.streamed:
                with self._lock:
                    self._done[out.request_id] = out
                    ev = self._events.get(out.request_id)
                if ev is not None:
                    ev.set()

    def _check_alive(self):
        """Ingress guard: a dead stepper surfaces its error; a cleanly
        STOPPED stepper (shutdown() is public API — drain,
        teardown) must fail fast with a typed failover signal instead of
        admitting work nothing will ever step (the waiter would ride out
        its whole timeout)."""
        if self._stopped:
            # a STOPPED replica is a deliberate lifecycle state, checked
            # BEFORE the stepper error (shutdown's waiter sweep records
            # one — it must not reclassify the typed failover signal as
            # a server fault). Drained replicas defer to the admission
            # controller so the shed is counted with its real class; a
            # bare shutdown has no drain state and fails fast here.
            if not self._admission.draining:
                raise ReplicaDrainingError(
                    "replica is shut down (stepper stopped)", retry_after_s=1.0
                )
            return
        if self._stepper_error is not None:
            raise StepperDiedError(f"llm stepper died:\n{self._stepper_error}")

    # -- request paths --
    def generate(self, prompt_token_ids, sampling_params: dict | None = None, timeout_s: float = 300.0) -> dict:
        """Blocking generation; many concurrent calls batch in the engine."""
        from ray_tpu_torch.llm import SamplingParams

        self._check_alive()
        params = SamplingParams(**(sampling_params or {}))
        # admission control: raises OverloadedError (429 + retry-after)
        # past the caps, lowest request class first; ReplicaDrainingError
        # while drain() is finishing in-flight work
        self._admission.check(params.priority)
        rid = self._admit(list(prompt_token_ids), params)
        out = self._await_finished(rid, timeout_s)
        return {
            "request_id": out.request_id,
            "prompt_token_ids": out.prompt_token_ids,
            "token_ids": out.token_ids,
            "finish_reason": out.finish_reason,
        }

    def _await_finished(self, rid: str, timeout_s: float):
        """Block until the stepping thread finishes request ``rid`` and
        return its RequestOutput (shared by generate, the disaggregated
        handoff path, and the prefill replica's handoff wait)."""
        ev = threading.Event()
        with self._lock:
            # finished (tiny prompts) or failed/migrated before we
            # registered: don't wait for an event nobody will set
            if rid in self._done or rid in self._errors:
                ev.set()
            self._events[rid] = ev
        self._work.set()
        if self._stopped and not ev.is_set():
            # raced a shutdown between the ingress check and admission:
            # nothing will ever step this request — fail fast with the
            # failover signal instead of riding out timeout_s
            self.engine.abort_request(rid)
            with self._lock:
                self._events.pop(rid, None)
                out = self._done.pop(rid, None)
            if out is not None:
                return out
            raise ReplicaDrainingError(
                "replica shut down while admitting", retry_after_s=1.0
            )
        if not ev.wait(timeout_s):
            self.engine.abort_request(rid)
            with self._lock:  # reap bookkeeping (completion may have raced)
                self._events.pop(rid, None)
                self._done.pop(rid, None)
                self._errors.pop(rid, None)
            raise TimeoutError(f"generation {rid} timed out after {timeout_s}s")
        with self._lock:
            self._events.pop(rid, None)
            err = self._errors.pop(rid, None)
            out = self._done.pop(rid, None)
        if err is not None:
            # per-request typed failure (live migration's resume signal,
            # the preemption abort fallback) — not a server fault
            raise err
        if out is None:
            raise StepperDiedError(f"llm stepper died:\n{self._stepper_error or 'unknown'}")
        return out

    def _fail_waiter(self, rid: str, exc: BaseException) -> None:
        """Deliver ONE request's typed failure to its blocked waiter
        (the per-request flavor of _fail_all_waiters: live migration
        hands each evacuated request its own RequestMigratedError)."""
        with self._lock:
            self._errors[rid] = exc
            ev = self._events.get(rid)
        if ev is not None:
            ev.set()

    def _admit(self, prompt_token_ids, params) -> str:
        """Admission seam: monolithic replicas prefill locally; the
        disaggregated DecodeServer overrides this to source KV from a
        prefill replica."""
        return self.engine.add_request(prompt_token_ids, params)

    def batch_stats(self) -> dict:
        return {"running": self.engine.num_running, "waiting": self.engine.num_waiting}

    def prefix_cache_stats(self) -> dict:
        return self.engine.prefix_cache_stats()

    def spec_stats(self) -> dict:
        """Speculative decoding counters (empty when speculation is off):
        acceptance rate, proposed/accepted totals, mean tokens per verify
        round, per-request effective k."""
        return self.engine.spec_stats()

    def kv_cache_stats(self) -> dict:
        """KV-cache accounting: dtype/layout, bytes per token (int8
        scales included), allocated vs occupied HBM, slot/page occupancy."""
        return self.engine.kv_cache_stats()

    def telemetry(self) -> dict:
        """Flight-recorder snapshot (llm/telemetry.py): per-step ring,
        finished-request TTFT/ITL/queue-wait lifecycle records, re-capture
        sentinel counts, and this replica's model/replica/stage tags."""
        return self.engine.telemetry()

    def overload_stats(self) -> dict:
        """Admission-control counters: admitted, shed by cause and by
        request class, live queue-wait estimate, drain state."""
        return self._admission.stats()

    def __call__(self, request):
        """HTTP entry: POST {"prompt_token_ids": [...], "sampling_params": {...}}."""
        body = request.json() if hasattr(request, "json") else dict(request)
        return self.generate(body["prompt_token_ids"], body.get("sampling_params"))

    # -- replica lifecycle -------------------------------------------------
    def _stop_stepper(self) -> None:
        """Set the stop flag AND wake the idle wait, then join: exit is
        immediate instead of riding out the 1 s idle tick. No waiter
        sweep — drain()'s timeout path stops the stepper first and then
        delivers the aborted finals itself."""
        self._stopped = True
        self._work.set()
        st = getattr(self, "_stepper", None)
        if st is not None and st.is_alive() and st is not threading.current_thread():
            st.join(timeout=5.0)

    def shutdown(self) -> None:
        """Stop the stepper thread promptly. Used by tests,
        drain(), and __del__. Waiters still blocked on in-flight work
        fail fast (nothing will ever step them) instead of riding out
        their timeouts; drain() settles in-flight work FIRST, so its
        final shutdown finds none. A tensor-parallel engine's rank
        processes stop here too."""
        self._stop_stepper()
        with self._lock:
            pending = bool(self._events)
        if pending or self.engine.has_unfinished():
            self._fail_all_waiters("replica shut down (stepper stopped) with requests in flight")
        self.engine.shutdown()

    def drain(self, timeout_s: float = 30.0, mode: str = "abort") -> dict:
        """Graceful drain, the replica's half of fleet failover:

        1. stop admitting — new requests shed with ReplicaDrainingError
           (a 429 subclass: routers fail over, clients back off);
        2. settle in-flight work. ``mode="abort"`` (default) finishes it
           bounded by ``timeout_s`` and aborts whatever is left past the
           deadline; ``mode="migrate"`` EVACUATES instead: the stepper
           stops, every in-flight request's live decode state is
           checkpointed and published over the object plane
           (llm/migrate.py), and each waiter gets a typed
           RequestMigratedError carrying (meta, ref) — the routers'
           resume-on-peer leg splices it with ZERO recomputed tokens.
           Whatever cannot checkpoint (streams, prefill stubs, sampled
           cold requests, post-deadline stragglers) aborts with a typed
           429 so the router re-prefills — the degradation order is
           migrate -> re-prefill -> typed error;
        3. release owned resources while the process is still healthy:
           stashed handoff blocks drop, and a cluster-KV-plane replica
           unregisters every published prefix from the index and frees
           the owned blocks (route dies before the bytes). Published
           live_state checkpoints are deliberately NOT freed — a peer
           must still fetch them; they die with this process (a fetch
           losing that race sees MigrationLostError, and the leak
           backstop reclaims never-fetched ones);
        4. stop the stepper (shutdown()).

        Idempotent: a second drain (controller retrying its shutdown
        hook, a preemption racing a manual drain) returns the first
        drain's record with ``repeated=True`` — never a double-free.
        Serve's graceful teardown calls this through the replica's
        shutdown hook; it is also directly callable for planned
        rebalancing. Returns what was drained/migrated."""
        if mode not in ("abort", "migrate"):
            raise ValueError(f"drain mode must be 'abort' or 'migrate', got {mode!r}")
        with self._drain_lock:
            if self._drain_result is not None:
                return dict(self._drain_result, repeated=True)
            res = self._drain_once(timeout_s, mode)
            self._drain_result = res
            return dict(res)

    def _drain_once(self, timeout_s: float, mode: str) -> dict:
        from ray_tpu_torch.serve.overload import wait_for_drain

        deadline = time.time() + timeout_s
        self._admission.drain()
        migrated: list = []
        aborted = 0
        if mode == "migrate":
            # evacuation: stop the stepper FIRST (quiescent engine under
            # us), then checkpoint + publish every in-flight request and
            # hand its waiter the typed resume signal
            self._stop_stepper()
            migrated, aborted = self._migrate_inflight(deadline)
            finished = aborted == 0
        else:
            finished = wait_for_drain(self, timeout_s=timeout_s)
            if not finished:
                # deadline passed with work still in flight: stop the stepper
                # FIRST (joins any in-progress step — no concurrent stepping),
                # abort what's left, then run ONE cleanup step ourselves so
                # the aborted finals publish through the normal path and
                # blocked waiters wake NOW instead of riding out their own
                # timeouts (abort outputs only surface via the next step)
                self._stop_stepper()
                try:
                    with self.engine._lock:
                        rids = [rid for rid, st in self.engine._requests.items() if not st.finished]
                    for rid in rids:
                        aborted += bool(self.engine.abort_request(rid))
                    self._deliver_outputs(self.engine.step())
                except Exception:  # noqa: BLE001 — drain is BEST-EFFORT: the
                    # likeliest reason the deadline passed is a broken engine,
                    # and the resource release below must still run; fail any
                    # still-blocked waiters exactly like the stepper-death path
                    import traceback

                    self._fail_all_waiters(traceback.format_exc())
        released = self.engine.release_handoffs()
        plane = getattr(self.engine, "_kv_plane", None)
        unregistered = plane.shutdown() if plane is not None else 0
        self._admission.drained()
        self.shutdown()
        return {
            "drained": True,
            "mode": mode,
            "inflight_finished": finished,
            "aborted": aborted,
            "migrated": migrated,
            "handoffs_released": released,
            "kvplane_keys_unregistered": unregistered,
        }

    def _migrate_inflight(self, deadline: float) -> tuple:
        """Checkpoint + publish every in-flight request (waiters get the
        typed resume signal); abort with a typed 429 is the per-request
        fallback. The stepper is already stopped — the engine is
        quiescent under us. Returns ([{request_id, meta, ref}], n_aborted)."""
        from ray_tpu_torch.llm import migrate as _mig

        eng = self.engine
        with eng._lock:
            rids = [rid for rid, st in eng._requests.items() if not st.finished]
        migrated: list = []
        aborted = 0
        for rid in rids:
            err = None
            if time.time() < deadline:
                try:
                    state = eng.checkpoint_request(rid)
                    meta, ref = _mig.publish(state)
                    err = _mig.RequestMigratedError(rid, meta, ref)
                except Exception:  # noqa: BLE001 — degrades to the abort leg below
                    err = None
            if err is not None:
                migrated.append({"request_id": rid, "meta": err.migration_meta,
                                 "ref": err.migration_ref})
                eng.finish_migrated(rid)
                self._fail_waiter(rid, err)
            else:
                aborted += 1
                tel = getattr(eng, "_tel", None)
                if tel is not None:
                    tel.on_migration("aborted")
                eng.abort_request(rid)
                # a typed 429 (not a partial result): the router's
                # re-prefill leg replays the whole request on a peer
                self._fail_waiter(rid, ReplicaDrainingError(
                    "replica preempted before this request could checkpoint; "
                    "re-prefill on a peer", retry_after_s=1.0,
                ))
        # one cleanup step publishes the evacuated finals through the
        # normal path (streams get their sentinels); waiters already woke
        # with their typed errors
        try:
            self._deliver_outputs(self.engine.step())
        except Exception:  # noqa: BLE001 — best-effort, like the abort drain
            import traceback

            self._fail_all_waiters(traceback.format_exc())
        return migrated, aborted

    def preempt(self, deadline_s: float | None = None) -> dict:
        """Preemption notice: the SIGTERM-with-deadline a fleet's
        preemptible capacity actually delivers. Evacuates via
        drain(mode="migrate") bounded by the deadline
        (LLMConfig.preempt_deadline_s by default); driven by the
        ``serve.preempt`` chaos site in tests and callable directly by a
        real signal handler."""
        d = self._preempt_deadline_s if deadline_s is None else float(deadline_s)
        return self.drain(timeout_s=d, mode="migrate")

    def resume_from_migration(self, meta: dict, ref, sampling_params: dict | None = None,
                              timeout_s: float = 300.0) -> dict:
        """Peer-side splice of a migrated request (llm/migrate.py): fetch
        the published checkpoint (bounded retry — a dead owner raises
        MigrationLostError, the router's signal to re-prefill), restore
        it into this replica's engine, and decode to completion. The
        returned token_ids are the FULL stream (pre-splice + new): the
        client sees one uninterrupted result."""
        from ray_tpu_torch.llm import migrate as _mig

        self._check_alive()
        # shed BEFORE borrowing the checkpoint: an overloaded peer must
        # bounce the router onward without touching the block ("no peer
        # admits them" spends the router's RetryBudget into the abort leg)
        self._admission.check(int((sampling_params or {}).get("priority", 0)))
        state = _mig.fetch(ref, meta)
        rid = self.engine.restore_request(state)
        self._work.set()
        out = self._await_finished(rid, timeout_s)
        return {
            "request_id": out.request_id,
            "prompt_token_ids": out.prompt_token_ids,
            "token_ids": out.token_ids,
            "finish_reason": out.finish_reason,
        }

    def suspend_request(self, request_id: str, publish: bool = True) -> dict:
        """Tiered conversation KV (llm/engine.suspend_request): spill one
        in-flight conversation's KV out of HBM to host DRAM + the object
        plane, freeing its slot/pages for active traffic. The request
        finishes locally with reason "suspended" (a blocked ``generate``
        waiter sees that reason, mirroring the migration signal);
        ``resume_suspended`` continues it later with zero recomputed
        tokens. Raises MigrationError when the request cannot suspend —
        the conversation is then untouched and still running."""
        self._check_alive()
        res = self.engine.suspend_request(request_id, publish=publish)
        self._work.set()  # let the stepper reap the retirement promptly
        return res

    def resume_suspended(self, request_id: str, timeout_s: float = 300.0) -> dict:
        """Re-admit a suspended conversation (scatter-in, no re-prefill)
        and block until it finishes — the resume twin of ``generate``."""
        self._check_alive()
        rid = self.engine.resume_suspended(request_id)
        self._work.set()
        out = self._await_finished(rid, timeout_s)
        return {
            "request_id": out.request_id,
            "prompt_token_ids": out.prompt_token_ids,
            "token_ids": out.token_ids,
            "finish_reason": out.finish_reason,
        }

    def suspended_requests(self) -> list:
        return self.engine.suspended_requests()

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class OpenAIServer(LLMServer):
    """OpenAI-compatible request surface over the engine: POST /v1/completions and /v1/chat/completions bodies map
    onto engine requests; GET /v1/models lists the deployment. Streaming
    responses use SSE `data:` lines when "stream": true."""

    def __init__(self, llm_config: LLMConfig):
        super().__init__(llm_config)
        self.model_id = llm_config.model_id
        self.tokenizer = llm_config.tokenizer

    # -- token plumbing --
    def _encode(self, prompt):
        if isinstance(prompt, list):
            return [int(t) for t in prompt]
        if self.tokenizer is None:
            raise ValueError("string prompts need LLMConfig.tokenizer (encode/decode); token-id lists work without one")
        return list(self.tokenizer.encode(prompt))

    def _decode(self, token_ids):
        if self.tokenizer is None:
            return token_ids
        return self.tokenizer.decode(token_ids)

    def _chat_to_prompt(self, messages):
        if self.tokenizer is not None and hasattr(self.tokenizer, "apply_chat_template"):
            return list(self.tokenizer.apply_chat_template(messages))
        text = "\n".join(f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages) + "\nassistant:"
        return self._encode(text)

    def _sampling(self, body: dict) -> dict:
        sp = {
            "max_tokens": int(body.get("max_tokens", 64)),
            "temperature": float(body.get("temperature", 0.0)),
            "top_p": float(body.get("top_p", 1.0)),
        }
        if body.get("seed") is not None:
            sp["seed"] = int(body["seed"])
        if body.get("stop_token_ids"):
            sp["stop_token_ids"] = tuple(body["stop_token_ids"])
        if body.get("priority") is not None:
            # request class for admission control (serve/overload.py):
            # 0 = shed first; higher classes shed only at the full caps
            sp["priority"] = int(body["priority"])
        return sp

    # -- HTTP entry --
    def __call__(self, request):
        path = getattr(request, "path", "/")
        if path.endswith("/models"):
            return {"object": "list", "data": [{"id": self.model_id, "object": "model", "owned_by": "ray_tpu_torch"}]}
        body = request.json() if hasattr(request, "json") else dict(request)
        chat = path.endswith("/chat/completions")
        if chat:
            prompt_ids = self._chat_to_prompt(body.get("messages", []))
        else:
            prompt_ids = self._encode(body.get("prompt", []))
        if body.get("stream"):
            return self._stream_completion(prompt_ids, body, chat)
        out = self.generate(prompt_ids, self._sampling(body))
        text = self._decode(out["token_ids"])
        if chat:
            choice = {"index": 0, "message": {"role": "assistant", "content": text}, "finish_reason": out["finish_reason"]}
            obj = "chat.completion"
        else:
            choice = {"index": 0, "text": text, "finish_reason": out["finish_reason"]}
            obj = "text_completion"
        return {
            "id": out["request_id"],
            "object": obj,
            "model": self.model_id,
            "choices": [choice],
            "usage": {
                "prompt_tokens": len(out["prompt_token_ids"]),
                "completion_tokens": len(out["token_ids"]),
                "total_tokens": len(out["prompt_token_ids"]) + len(out["token_ids"]),
            },
        }

    def _stream_completion(self, prompt_ids, body: dict, chat: bool):
        """SSE chunks, one per generated token (the OpenAI streaming
        format). Serve streams these through the chunked proxy.

        NOT itself a generator: the admission check and the engine
        admission run EAGERLY here, so a shed streaming request raises
        its typed OverloadedError at call time — before any stream
        machinery engages — and the proxies (which fetch the first item
        before committing the 200 header) can surface the 429."""
        import queue as _queue

        from ray_tpu_torch.llm import SamplingParams

        params = SamplingParams(**self._sampling(body))
        # streaming ingress guards exactly like the unary one
        self._check_alive()
        self._admission.check(params.priority)
        # we own the queue: a tiny request can finish (and leave the
        # engine registry) before add_request even returns, so the state
        # must never be looked up there afterwards
        out_q = _queue.SimpleQueue()
        rid = self.engine.add_request(list(prompt_ids), params, out_queue=out_q)
        self._work.set()
        if self._stopped:
            # raced a shutdown between the ingress check and admission
            # (the unary path's _await_finished guard, streaming flavor).
            # A request that COMPLETED in the race already has its tokens
            # and sentinel in out_q — serve them (mirroring the unary
            # path's pop-from-_done); otherwise nothing will ever step
            # it and the shutdown sweep may have already run, so fail
            # fast with the typed signal.
            with self.engine._lock:
                st = self.engine._requests.get(rid)
                unfinished = st is not None and not st.finished
            if unfinished:
                self.engine.abort_request(rid)
                raise ReplicaDrainingError(
                    "replica shut down while admitting", retry_after_s=1.0
                )
        return self._stream_tokens(rid, out_q, chat)

    def _stream_tokens(self, rid: str, out_q, chat: bool):
        """The generator half of _stream_completion (admission already
        done): drain the request's token queue into SSE chunks."""
        import json as _json
        import time as _time

        key = "delta" if chat else "text"
        obj = "chat.completion.chunk" if chat else "text_completion"
        deadline = _time.monotonic() + 300.0
        while True:
            if self._stepper_error is not None:
                raise StepperDiedError(f"llm stepper died:\n{self._stepper_error}")
            try:
                tok = out_q.get(timeout=min(5.0, max(0.1, deadline - _time.monotonic())))
            except _queue.Empty as e:
                if _time.monotonic() > deadline:
                    self.engine.abort_request(rid)
                    # typed (504, retryable) and chained: GetTimeoutError
                    # IS-A TimeoutError, so pre-taxonomy callers still match
                    raise GetTimeoutError(f"stream {rid} produced no token for 300s") from e
                continue
            if tok is None:
                if self._stepper_error is not None:
                    raise StepperDiedError(f"llm stepper died:\n{self._stepper_error}")
                break
            piece = self._decode([tok])
            content = {"role": "assistant", "content": piece} if chat else piece
            yield "data: " + _json.dumps(
                {"id": rid, "object": obj, "model": self.model_id, "choices": [{"index": 0, key: content}]}
            ) + "\n\n"
        yield "data: [DONE]\n\n"


class PrefillServer(LLMServer):
    """Prefill-only replica for disaggregated serving (llm/disagg/).

    Engine-backed: concurrent prefill calls enqueue prefill-only requests
    and the stepping thread BATCHES same-bucket prompts into one forward
    (the engine's admission + prefill stages; the decode stage never sees
    them). Each finished block is published as an OWNED object in this
    replica's process — the replica is the block's owner for its whole
    life — and only the tiny (meta, ref) pair travels back."""

    telemetry_stage = "prefill"

    def __init__(self, llm_config: LLMConfig):
        from dataclasses import replace as _replace

        kwargs = dict(llm_config.engine_kwargs)
        kwargs.setdefault("enable_prefix_caching", False)  # stateless by default
        super().__init__(_replace(llm_config, engine_kwargs=kwargs))

    def _prewarm_compile(self):
        # a prefill replica's hot path is prefill + extract, not decode
        self.engine.prefill_handoff([1, 2, 3])

    def _prewarm_probe(self):
        self.engine.prefill_handoff([1, 2, 3])

    def prefill(self, prompt_token_ids, timeout_s: float = 180.0) -> dict:
        """-> {"meta": {...}, "ref": ObjectRef}: the handoff publish half
        (llm/disagg/handoff.py)."""
        from ray_tpu_torch.llm.disagg import publish_handoff
        from ray_tpu_torch.llm.disagg.handoff import HandoffError

        self._check_alive()
        # class-blind capacity guard (the prefill ingress doesn't know the
        # request class; the class-aware shed ran at the decode ingress)
        self._admission.check_capacity()
        rid = self.engine.add_prefill_request(list(prompt_token_ids))
        try:
            out = self._await_finished(rid, timeout_s)
        except BaseException:
            # waiter gave up (timeout/stepper death) possibly AFTER the
            # prefill stage stashed the block: drop it or it leaks on the
            # replica forever
            self.engine.pop_handoff(rid)
            raise
        kv = self.engine.pop_handoff(rid)
        if out.finish_reason != "handoff" or kv is None:
            raise HandoffError(f"prefill-only request {rid} failed: {out.finish_reason}")
        meta, ref = publish_handoff(kv)
        return {"meta": meta, "ref": ref}

    def prefill_local(self, prompt_token_ids) -> dict:
        """Legacy by-value path (payload rides the reply instead of the
        owned-object plane); kept for callers without a direct plane."""
        return self.engine.prefill_remote(list(prompt_token_ids))


class DecodeServer(LLMServer):
    """Decode replica: admits handoff KV blocks (borrow -> fused
    scatter-in) and runs continuous batching decode-only from there —
    prompt compute and token generation scale independently. Speculative
    decoding composes: pass LLMConfig.speculative and the admitted lanes
    draft/verify exactly as local admissions do. Recompute-preemption
    re-prefills LOCALLY (vLLM semantics: the preempted sequence's
    prompt+generated re-admits on this replica, not through the router)."""

    telemetry_stage = "decode"

    def __init__(self, llm_config: LLMConfig, prefill_handle=None):
        super().__init__(llm_config)
        self.prefill_handle = prefill_handle

    def _prewarm_compile(self):
        super()._prewarm_compile()
        # warm the handoff admission path too: extract a local block and
        # scatter it back in, compiling the fused scatter-in and the
        # first-token sample for the smallest bucket before the replica
        # reports RUNNING (the EMA probe then re-measures warm)
        from ray_tpu_torch.llm import SamplingParams

        kv = self.engine.prefill_handoff([1, 2, 3])
        self.engine.add_prefilled(kv, SamplingParams(max_tokens=2, temperature=0.0))
        while self.engine.has_unfinished():
            self.engine.step()

    def _admit(self, prompt_token_ids, params) -> str:
        """Legacy decode-as-ingress path (prefill_handle given): fetch the
        handoff ourselves, then admit."""
        from ray_tpu_torch.llm.disagg import fetch_handoff

        if self.prefill_handle is None:
            return super()._admit(prompt_token_ids, params)
        out = self.prefill_handle.prefill.remote(list(prompt_token_ids)).result(timeout_s=180.0)
        kv = fetch_handoff(out["ref"], out["meta"])
        return self.engine.add_prefilled(kv, params)

    def generate_from_handoff(self, meta: dict, ref, sampling_params: dict | None = None, timeout_s: float = 300.0) -> dict:
        """Router path: borrow the published KV block (bounded-retry,
        zero-copy fetch), scatter it into this replica's cache/pool, and
        decode to completion. A lost handoff raises HandoffLostError to
        the router — the signal to re-prefill — instead of hanging."""
        from ray_tpu_torch.llm import SamplingParams
        from ray_tpu_torch.llm.disagg import fetch_handoff

        self._check_alive()
        params = SamplingParams(**(sampling_params or {}))
        # shed BEFORE borrowing the handoff: an overloaded decode replica
        # must bounce the router to a peer without touching the block
        self._admission.check(params.priority)
        kv = fetch_handoff(ref, meta)
        rid = self.engine.add_prefilled(kv, params)
        self._work.set()
        out = self._await_finished(rid, timeout_s)
        return {
            "request_id": out.request_id,
            "prompt_token_ids": out.prompt_token_ids,
            "token_ids": out.token_ids,
            "finish_reason": out.finish_reason,
        }


class DisaggRouterServer:
    """Ingress of the disaggregated graph: llm/disagg/router.py policy
    over the prefill and decode deployment handles. The router never
    touches KV bytes — it moves (meta, ref) pairs and owns the bounded
    retry budget for dead decode lanes and lost handoffs."""

    def __init__(self, llm_config: LLMConfig, prefill_handle, decode_handle, max_attempts: int = 3):
        from ray_tpu_torch.llm.disagg import DisaggRouter

        self._prefill_handle = prefill_handle
        self._decode_handle = decode_handle

        def _prefill(prompt):
            out = prefill_handle.prefill.remote(prompt).result(timeout_s=180.0)
            return out["meta"], out["ref"]

        def _decode(meta, ref, prompt, sp):
            return decode_handle.generate_from_handoff.remote(meta, ref, sp).result(timeout_s=600.0)

        def _resume(meta, ref, sp):
            # resume-on-peer (llm/migrate.py): the pow-2 pick may land on
            # the draining replica again — it sheds typed and the
            # router's budgeted loop retries
            return decode_handle.resume_from_migration.remote(meta, ref, sp).result(timeout_s=600.0)

        self.router = DisaggRouter(
            _prefill, _decode, resume=_resume, max_attempts=max_attempts,
            telemetry_tags={"model": llm_config.model_id},
        )

    def generate(self, prompt_token_ids, sampling_params: dict | None = None) -> dict:
        return self.router.generate(list(prompt_token_ids), sampling_params)

    def disagg_stats(self) -> dict:
        return self.router.stats()

    def check_health(self):
        return True

    def __call__(self, request):
        body = request.json() if hasattr(request, "json") else dict(request)
        return self.generate(body["prompt_token_ids"], body.get("sampling_params"))


def build_pd_disagg_deployment(
    llm_config: LLMConfig,
    *,
    num_prefill_replicas: int = 1,
    num_decode_replicas: int = 1,
    name: str = "LLM",
    max_attempts: int = 3,
    _cls: dict | None = None,
):
    """-> Application: router ingress over a prefill pool and a decode
    pool with the KV block shipped as an owned handoff object between
    them (llm/disagg/). N_prefill and N_decode scale independently; call
    .generate on the returned handle exactly like the monolithic
    deployment. Replicas pre-warm at creation (LLMConfig.prewarm) so
    fleet spin-up, not the first request, pays the first-call costs.
    Neither pool asks for a card: both run their engines on the host's
    cards from unbound workers (the module docstring). ``_cls``: see
    ``_subclass``."""
    from ray_tpu_torch import serve

    health = {"health_check_timeout_s": 180.0, "health_check_period_s": 2.0}
    prefill_app = serve.deployment(
        name=f"{name}-prefill",
        num_replicas=num_prefill_replicas,
        max_ongoing_requests=llm_config.max_ongoing_requests,
        **health,
    )(_subclass(PrefillServer, _cls)).bind(llm_config)
    decode_app = serve.deployment(
        name=f"{name}-decode",
        num_replicas=num_decode_replicas,
        max_ongoing_requests=llm_config.max_ongoing_requests,
        **health,
    )(_subclass(DecodeServer, _cls)).bind(llm_config)
    router_dep = serve.deployment(
        name=f"{name}-router",
        num_replicas=1,
        max_ongoing_requests=llm_config.max_ongoing_requests * max(num_decode_replicas, 1),
        **health,
    )(DisaggRouterServer)
    return router_dep.bind(llm_config, prefill_app, decode_app, max_attempts)


class KVIndexServer:
    """Cluster prefix-index deployment (llm/kvplane/index.py): the ONE
    map every replica registers its published prefix blocks in and every
    router scores against. Control plane only — refs and small meta
    dicts, never KV bytes."""

    def __init__(self, ttl_s: float = 30.0):
        from ray_tpu_torch.llm.kvplane import PrefixIndex

        self.index = PrefixIndex(ttl_s=ttl_s)

    def register(self, replica, entries):
        return self.index.register(replica, entries)

    def unregister(self, replica, keys):
        return self.index.unregister(replica, keys)

    def heartbeat(self, replica):
        return self.index.heartbeat(replica)

    def drop_replica(self, replica):
        return self.index.drop_replica(replica)

    def report_lost(self, replica, key):
        return self.index.report_lost(replica, key)

    def lookup(self, keys, exclude=None, requester=None):
        return self.index.lookup(keys, exclude, requester)

    def match_replicas(self, keys):
        return self.index.match_replicas(keys)

    def top_hot(self, k=4, exclude=None):
        return self.index.top_hot(k, exclude)

    def expire(self):
        return self.index.expire()

    def stats(self):
        return self.index.stats()

    def check_health(self):
        return True


class KVPlaneServer(LLMServer):
    """LLM replica joined to the cluster KV plane: its engine publishes
    freshly cached prefixes, serves remote hits over the object plane,
    and re-publishes what it fetches (llm/kvplane/client.py). Each
    replica registers under its deployment name so the router's
    cache-aware scores and the index's entries name the same thing."""

    def __init__(self, llm_config: LLMConfig, index_handle, replica_name: str,
                 publish_min_hits: int = 2, prefetch_k: int = 0):
        from dataclasses import replace as _replace

        from ray_tpu_torch.llm.kvplane import KVPlaneClient
        from ray_tpu_torch.llm.telemetry import default_tags

        self.replica_name = str(replica_name)
        kwargs = dict(llm_config.engine_kwargs)
        kwargs.setdefault(
            "telemetry_tags",
            default_tags(self.telemetry_stage, model=llm_config.model_id, replica=self.replica_name),
        )
        # publish_min_hits: the client's capacity-aware publication policy
        # (publish a prefix only once it shows reuse; 1 = publish-on-store).
        # prefetch_k > 0 turns on predictive prefetch: each heartbeat tick
        # pulls the fleet's top-k demanded prefix blocks into the local
        # cache ahead of demand (remote-tier hits become local-tier).
        kwargs.setdefault(
            "kv_plane",
            KVPlaneClient(index_handle, self.replica_name,
                          publish_min_hits=publish_min_hits, prefetch_k=prefetch_k),
        )
        super().__init__(_replace(llm_config, engine_kwargs=kwargs))

    def kvplane_stats(self) -> dict:
        """Tiered prefix-reuse counters (prefix_cache_stats with the
        local/remote split and the plane client's own accounting)."""
        return self.engine.prefix_cache_stats()


class KVRouterServer:
    """Cache-aware ingress over a pool of KVPlaneServer replicas
    (llm/kvplane/routing.py): scores every replica by longest cached
    prefix (index.match_replicas) blended with live load, so
    shared-prefix traffic lands where its KV already lives — local tier
    beats remote tier beats cold."""

    def __init__(
        self,
        llm_config: LLMConfig,
        index_handle,
        replica_names: tuple,
        *replica_handles,
        cache_weight: float = 1.0,
        load_weight: float = 0.1,
        max_attempts: int = 2,
    ):
        from ray_tpu_torch.llm.kvplane import CacheAwareRouter

        names = [str(n) for n in replica_names]
        handles = dict(zip(names, replica_handles))
        block = int(llm_config.engine_kwargs.get("prefix_block", 64))

        def _submit(replica_id, prompt, sp):
            return handles[replica_id].generate.remote(prompt, sp).result(timeout_s=600.0)

        def _resume_submit(replica_id, meta, ref, sp):
            # resume-on-peer (llm/migrate.py): splice a preempted
            # replica's checkpoint on the next-ranked replica
            return handles[replica_id].resume_from_migration.remote(meta, ref, sp).result(timeout_s=600.0)

        self.router = CacheAwareRouter(
            index_handle, _submit, names, block=block,
            cache_weight=cache_weight, load_weight=load_weight, max_attempts=max_attempts,
            resume_submit=_resume_submit,
            telemetry_tags={"model": llm_config.model_id},
        )

    def generate(self, prompt_token_ids, sampling_params: dict | None = None) -> dict:
        return self.router.generate(list(prompt_token_ids), sampling_params)

    def kvplane_stats(self) -> dict:
        return self.router.stats()

    def check_health(self):
        return True

    def __call__(self, request):
        body = request.json() if hasattr(request, "json") else dict(request)
        return self.generate(body["prompt_token_ids"], body.get("sampling_params"))


def build_kvplane_deployment(
    llm_config: LLMConfig,
    *,
    num_replicas: int = 2,
    name: str = "LLM",
    index_ttl_s: float = 30.0,
    cache_weight: float = 1.0,
    load_weight: float = 0.1,
    max_attempts: int = 2,
    prefetch_k: int = 0,
    _cls: dict | None = None,
):
    """-> Application: cache-aware router over ``num_replicas`` engine
    replicas sharing one cluster prefix index (llm/kvplane/). Replicas
    are SINGLE-replica deployments (``{name}-r<i>``) so the router can
    target the specific replica its score picked — the whole point of
    cache-aware routing; a pow-2 pick inside one deployment would throw
    the affinity away. ``prefetch_k`` > 0 arms predictive prefetch on
    every replica (each heartbeat pulls the fleet's top-k demanded
    prefixes into the local cache). Call ``.generate`` on the returned
    handle exactly like the monolithic deployment. No replica asks for a
    card (the module docstring). ``_cls``: see ``_subclass``."""
    from ray_tpu_torch import serve

    health = {"health_check_timeout_s": 180.0, "health_check_period_s": 2.0}
    index_app = serve.deployment(name=f"{name}-kvindex", num_replicas=1, **health)(
        KVIndexServer
    ).bind(index_ttl_s)
    names, apps = [], []
    for i in range(num_replicas):
        rn = f"{name}-r{i}"
        names.append(rn)
        apps.append(
            serve.deployment(
                name=rn, num_replicas=1,
                max_ongoing_requests=llm_config.max_ongoing_requests, **health,
            )(_subclass(KVPlaneServer, _cls)).bind(llm_config, index_app, rn, prefetch_k=prefetch_k)
        )
    router_dep = serve.deployment(
        name=f"{name}-router",
        num_replicas=1,
        max_ongoing_requests=llm_config.max_ongoing_requests * max(num_replicas, 1),
        **health,
    )(KVRouterServer)
    return router_dep.bind(
        llm_config, index_app, tuple(names), *apps,
        cache_weight=cache_weight, load_weight=load_weight, max_attempts=max_attempts,
    )


def _subclass(cls, _cls: dict | None):
    """``cls``, or the subclass that ``_cls`` maps it to. ``_cls`` is the
    builders' private keyword ({server class: its subclass}) for a caller
    that deploys its own subclasses of the servers (extra methods in the
    replica); ray_tpu's builders have no such option."""
    return (_cls or {}).get(cls, cls)


def _build_app(llm_config: LLMConfig, cls, name: str):
    """Shared deployment construction for both server surfaces."""
    from ray_tpu_torch import serve

    opts = {
        "name": name,
        "max_ongoing_requests": llm_config.max_ongoing_requests,
        # engine construction + first prefill/decode compiles take tens of
        # seconds; don't let the controller shoot the replica meanwhile
        "health_check_timeout_s": 180.0,
        "health_check_period_s": 2.0,
    }
    if llm_config.autoscaling_config is not None:
        opts["autoscaling_config"] = llm_config.autoscaling_config
    else:
        opts["num_replicas"] = llm_config.num_replicas
    num_tpus = llm_config.num_tpus_per_replica
    if num_tpus < 0:
        # auto: a TP replica gang-reserves its cards
        num_tpus = float(llm_config.tensor_parallel_size) if llm_config.tensor_parallel_size > 1 else 0.0
    if num_tpus:
        opts["num_tpus"] = num_tpus  # ReplicaConfig field: whole cards, "GPU"
    deployment = serve.deployment(**opts)(cls)
    return deployment.bind(llm_config)


def build_openai_app(llm_config: LLMConfig, *, name: str = "OpenAIServer", _cls: dict | None = None):
    """-> a Serve Application exposing the OpenAI surface. Mount it at
    /v1 via serve.run(app, route_prefix="/v1") + serve.start(proxy=True).
    ``_cls``: see ``_subclass``."""
    return _build_app(llm_config, _subclass(OpenAIServer, _cls), name)


def build_llm_deployment(llm_config: LLMConfig, *, name: str = "LLMServer", _cls: dict | None = None):
    """-> a Serve Application running LLMServer replicas. ``_cls``: see
    ``_subclass``."""
    return _build_app(llm_config, _subclass(LLMServer, _cls), name)

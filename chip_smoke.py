#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch's serving and training paths on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero before the last line:

1. Build the CUDA kernels (K1 flash-attention forward, K2/K3 its backward,
   K4 paged-attention partials, K5 fused RMSNorm) from ray_tpu_torch/csrc
   with nvcc for sm_90a, in parallel, and phase 4m's C++ programs with g++
   beside them (a failed build fails the run). Prints ptxas's registers and spills
   for each K1, K2 and K3 instance and the count of HGMMA (wgmma)
   instructions in each from the built libraries' SASS (cuobjdump -sass);
   the bf16 instances must have HGMMAs and no spills, and ptxas must not
   report that it serialises a kernel's wgmma instructions.
2. K1 against its plain PyTorch version on the card, at the prefill shapes
   of Llama-3-8B (32 query heads, 8 kv heads, head_dim 128, bf16) and the
   training shape of bench.py's sft model (8 x 2048, 16/8 heads), timed
   beside the plain version, PyTorch's scaled_dot_product_attention and
   the card's bound, with the kernel's TFLOP/s; then bf16 at head_dim 64
   and 128 without the causal mask at ragged T (129, 1000) and GQA rep 1,
   2, 4, and the f32 instances.
3. K4 against its plain version on the card (8 lanes, 8 kv heads, rep 4,
   page 64, T in {1, 5}, bf16 and int8 pools, bounds 0 .. ~2000; then one
   lane at bound 2047, T = 1; then the prefix-cache extend's shapes: one
   lane at bound 1024, T in {17, 64, 512, 2048}, R = 4 T rows per kv
   head), plus the combined page attention against the host path; timed
   the same way, with the device time per call from torch.profiler (its
   partials and merge kernels) and the wrapper's host cost per call
   (perf_counter over 300 calls, no synchronise).
4. The engine: full-width Llama-3-8B (random weights from a seed, bf16)
   on the paged layout (kv_layout="paged", page 64, 257 pages) serves 8
   seeded prompts of 50-1500 tokens, 32 greedy tokens each, first with the
   graph engine (device-resident, the default: the decode step is one CUDA
   graph captured when the engine is built and replayed every step, the
   tokens read back one step behind), then with device_resident=False
   (the synchronous loop). The kernels' launch counters are zeroed just
   before each run and read just after: K1 must have run 32 times per
   prefill forward, K4 32 times per decode step (a replay adds the K4
   launches its capture recorded). The two modes' greedy tokens must be
   identical. Each engine then generates 4 seeded prompts at temperature
   0.8, top_p 0.9 (threefry lane keys from the seeds), which must also be
   identical across the modes, then admits the 8 prompts again, steps
   until none waits, and times 4 decode-only steps, then runs 4 more under
   torch.profiler: per step the wall time (unprofiled), device-busy time,
   idle share, K4's device time, cuBLAS's and the rest's (the tables in
   build/decode_step_profile_paged_bf16_{graph,sync}.txt); K4's partials
   kernel must appear 32 x 4 times in each. Prints each mode's prefill ms,
   decode ms/step, generated tok/s, the cache's layout, dtype, bytes per
   token and allocation, peak memory, and the graph's capture time. Every
   engine runs with serving telemetry on (the default); on the graph
   engine the flight recorder must count one step record per step() call,
   8 request records, 248 tokens emitted by the decode steps (256 less the
   8 first tokens sampled at admission), no recompile (re-capture) and a
   TTFT histogram count of 8. Then the telemetry overhead on that engine:
   interleaved rounds (8 prompts of 64 tokens, 24 new tokens each) with
   the telemetry on and off, ray_tpu's gate: the best instrumented
   decode-only step at most 1.05x the best plain one.
4b. Prefix caching on the same weights: a fresh paged engine (caching on,
   64-token blocks) generates a leader (a seeded 1024-token prefix + 256 tokens),
   then 8 requests of the prefix + seeded suffixes of 32-900 tokens with
   pairwise distinct first suffix tokens, 32 greedy tokens each. It must
   count 8 hits, 1 miss, 8192 tokens saved, K1 32 times per prefill
   forward and K4 32 times per decode step and extend forward, and finish
   every request with 32 tokens. Then the same 8 prompts hit again and the
   step that admits them runs under torch.profiler (wall, device busy,
   idle share, K4, cuBLAS, the rest; table in build/hit_wave_profile.txt).
   Prints the hit wave's prefill ms beside a caching-off engine's on the
   same 8 prompts, the count of first tokens the two agree on, and both
   waves' peak memory.
4c. The slot layout (kv_layout="slots", the default) and the int8 cache,
   on phase 4's weights and prompts, each engine run as phase 4 runs its
   own (K1 32 times per prefill forward, every first token equal to phase
   4's paged engine's, the allocation and bytes per token as computed):
   the slot engine in bf16, graph then sync (streams identical, K4 never
   launched, 2 GiB allocated; both modes profiled as in phase 4 into
   build/decode_step_profile_slots_bf16_{graph,sync}.txt); the paged int8
   engine, graph then sync (streams identical, K4's int8 branch 32 times
   per decode step, 67584 bytes per token, the graph profiled); the slot
   int8 engine, graph only; and phase 4b's leader and 8 followers on a
   paged int8 engine (8 hits, 1 miss, 8192 tokens saved, K4 32 times per
   decode step and extend forward). Prints the greedy tokens each engine
   shares with phase 4's streams.
4d. Speculative decoding on phase 4's weights, prompts and streams, three
   engines: paged + SpecConfig(drafter="ngram", k=4), slots + ngram k=4,
   and paged + drafter="model" with Llama-3.2-1B's published widths
   (hidden 2048, intermediate 8192, 16 layers, 32/8 heads, head_dim 64,
   vocab 128256, rope_theta 5e5, tied embeddings, bf16; random weights from
   seed 1). Each serves the 8 prompts (32 greedy tokens) and the 4 seeded
   ones: every first token must equal phase 4's, K4 must have run 32 times
   per dispatched round on the paged engines (the verify's prefix
   attention, R = 4 x 5 = 20 rows per kv head, inside the round's graph),
   K1 32 times per target prefill forward and 16 per draft prefill, and
   the pool must drain. Prints the greedy tokens equal to phase 4's, ms
   per round, tokens per lane-round, acceptance rate, generated tok/s, the
   capture time and the decode-only rounds' profile (tables in
   build/decode_step_profile_spec_*.txt).
4e. KV between engines, on phase 4's weights and prompts. Handoff: a paged
   prefill-only engine (8 slots, page 64, 257 pages) takes the 8 prompts
   with add_prefill_request, one step() runs phase 4's batched forwards
   and extracts each block into host tensors: K1 32 times per forward, K4
   never, every page back, each payload's n its prompt's length, its width
   the prompt's bucket, its k + v bytes width x 131072 (9280 tokens in
   all); the same with an int8 cache (width x 67584 bytes, scales
   included). Then a paged graph engine, a slot graph engine and a paged
   int8 graph engine (the bf16 blocks quantized on the way in) each
   add_prefilled the 8 bf16 payloads and generate 32 greedy tokens: first
   tokens 8 of 8 equal phase 4's, K1 never, K4 32 times per decode step on
   the paged ones, captures 1, rt_llm_handoffs_total 8 "scattered" (8
   "extracted" on the prefill engine). Migration: a paged graph engine
   serves the 8 prompts (4 greedy, 4 seeded at temperature 0.8, top_p 0.9)
   uninterrupted, then again; after 11 steps 4 lanes (2 greedy, 2 seeded)
   are checkpointed (12 tokens each: the first checkpoint drains the step
   in flight), finished as migrated (their pages back), sent through the
   wire codec and restored on a second paged graph engine: each restored
   lane's device key, read right after the bind, equals the checkpoint's
   bit for bit; each spliced stream has 32 tokens, its first 12 the
   checkpoint's; captures 1 on both engines. Suspend: one of the source's
   running requests is suspended (its pages back, spilled bytes = the
   checkpoint's) and resumed (32 tokens). Prints extract ms a handoff
   (mean, at the 2048 bucket), scatter-in admission ms (upload, scatter,
   first-token sample) and the device scatter's, bytes a handoff bf16 and
   int8, checkpoint ms, restore to first post-splice token ms
   (rt_llm_migration_splice_s), and the post-splice tokens equal to the
   uninterrupted run's (not gated).
4f. The serving control plane over graph engines, on phase 4's weights and
   prompts (32 greedy tokens each), engines driven through closures as
   ray_tpu's tests drive its routers: a paged prefill-only engine (B = 1
   prefill_handoff forwards under one lock, the encoded payload passed as
   the "ref") and two paged graph decode engines D0 and D1 (each shared by
   caller threads: a caller admits under the engine's lock, then steps it
   until its own request has finished). DisaggRouter, 8 concurrent
   requests: (a) decode on D0: first tokens 8 of 8 equal phase 4's,
   prefills 8, decode_retries 0, rt_llm_handoffs_total 8 "published", K1
   32 times per prefill forward, K4 32 times per decode step (the counters
   zeroed just before and read just after); (b) D0's AdmissionController
   draining: each first decode attempt sheds with ReplicaDrainingError and
   the retry lands on D1 with the same handoff (prefills 8, decode_retries
   8, tokens equal (a)'s); then, one request at a time, (c) a decode that
   raises HandoffLostError once (prefills 2, handoffs_lost 1, tokens equal
   (a)'s), (d) the resume leg: after 11 steps on D0 the lane is
   checkpointed and raised as RequestMigratedError, restored on D1 (the
   spliced stream equals (a)'s; migrations 1, resumed 1, prefills 1), and
   (e) both decode engines draining: OverloadedError, http_error_of's 429,
   shed 1. CacheAwareRouter over D0 and D1 with an in-process PrefixIndex
   that nothing registers into, 8 requests admitted in order and then
   stepped together: by load order (as rank_replicas gives it), with D0
   draining (all 8 on D1, retries 8), and under a kvplane.index chaos drop
   (index_errors one per prompt with a 64-token boundary, the streams equal
   the load-order leg's); first tokens 8 of 8 equal phase 4's in each.
   Admission on D0, its EMAs seeded: a burst of 16 alternating classes
   past max_queue_depth 8 (class_fracs 0.5, 1.0) sheds class 0 from depth
   4 and class 1 only from depth 8 (429); check()'s host cost; the decode
   ms/step with the controller attached (its gauge refresh as the
   telemetry's sample hook) over detached, interleaved rounds as phase 4's
   telemetry gate, best ratio at most 1.05; captures 1 on all three
   engines. Prints the router overhead a request (router wall less the
   closures' wall) of each router, the reuse leg's wall against the
   re-prefill leg's, and the resume call's wall against re-prefilling the
   prompt and the tokens emitted by then (not gated).
4g. The object plane (ray_tpu_torch/core/), on phase 4's weights. This
   process attaches a plane. (a) A paged prefill-only engine's 8 handoffs
   (phase 4's prompts) are published with handoff.publish (in waves that
   fit /dev/shm) and fetched owner-locally; a borrower process, started
   with the spawn method and bounded in time, attaches its own plane with
   this process's authkey, rebuilds the weights from seed 0 (its checksum
   of three weight tensors must equal this process's), receives each
   (meta, ref) pair over a pipe, fetches it across processes
   (handoff.fetch: the owner's segment mapped, no copy), admits it into its
   own paged graph engine and decodes 32 greedy tokens: first tokens 8 of
   8 equal phase 4's, all 256 tokens equal phase 4e's in-process handoff
   streams, K1 never and K4 32 times per decode step in the borrower,
   captures 1; once it releases its refs this process's owned store must
   empty within the grace window and five housekeeping passes (2 s).
   (b) 4 of 8 live lanes of a paged graph engine are checkpointed and
   migrate.published, restored on a second engine with
   restore_request(ref): 4 of 4 streams equal the uninterrupted runs; a
   fifth lane's suspend_request(publish=True) returns published True and
   restore_request of its plane reference on the second engine continues
   its stream token for token. (c) The cluster KV plane over one
   in-process PrefixIndex: engine A serves phase 4b's leader and publishes
   its prefix (KVPlaneClient, publish_min_hits=1); engine B, its local
   prefix cache smaller than one 1024-token group, takes the 8 followers
   as remote hits (fetch, upload, extend with K4): first tokens 8 of 8
   equal phase 4b's hits, 8 remote hits, 8192 tokens saved, no local hit,
   no prefill forward, K1 never, K4 32 times per decode step and extend;
   CacheAwareRouter over A and B sends a ninth follower to the holder A; a
   chaos drop at direct.get_owned_view makes B's fetch run out its retry
   budget (2 attempts) and prefill locally (lost 1, fetch_lost 1, the
   first token of a B = 1 prefill); the same pair on int8 caches ships an
   int8 wire and B's first tokens equal phase 4c's int8 hits. Prints
   /dev/shm's size and free bytes first, then per handoff the publish,
   owner-local and cross-process fetch, fetch-to-device upload and
   scatter-in ms, the bytes on the plane, checkpoint-publish and
   restore-from-ref ms, the remote hits' fetch and splice ms and B's
   prefill stage, and the launches of K1 and K4; no /dev/shm/rt* segment
   may be left at the end.
4h. The runtime on the card (ray_tpu_torch.init, the card as its "GPU"
   resource), after 4g, on phase 4's weights, prompts and streams. A GPU
   actor (CardServer, num_gpus=1, in a worker of its own that sees only
   its card) rebuilds phase 4's weights from seed 0 (checksum equal to
   this process's) and its paged graph engine, and generates the 8
   prompts: 256 of 256 tokens equal phase 4's graph streams, K1 and K4
   counted in the worker equal phase 4's (32 x 4 prefill forwards, 32 x 32
   decode steps), this process's counts unmoved; its streaming method
   yields the same streams. A second num_gpus=1 actor stays pending 2 s
   with GPU available 0, and is ready after kill() of the first. A
   max_restarts=1 actor's worker is SIGKILLed: it restarts, rebuilds and
   generates the same 256 tokens. A num_gpus=1 task runs K1 at phase 2's
   shape against its plain version in its worker. Prints the actor's time
   to ready, its generate wall beside phase 4's, an empty method's round
   trip direct and through the head, the card's free memory around the
   kill, the restart-to-ready time, 1000 empty tasks' rate, a task's round
   trip, a 256 MiB host tensor's put and get, and the workers' boot
   times. After shutdown() no worker process, no /dev/shm/rt segment, and
   the card's memory in use within 64 MiB of its value before 4h.
4i. Serve over the runtime on the card (ray_tpu_torch.serve), after 4h, on
   phase 4's config, engine settings (paged, 8 slots, page 64, caching off
   but in (d)) and prompts; every replica builds phase 4's weights from
   seed 0 itself (checksum-gated). The deployment classes are module-level
   subclasses here (CardLLMServer and the rest), so each replica's worker
   imports this file as __mp_main__; they add weights_checksum,
   kernel_counts and check_kernels. (a) serve.run(build_llm_deployment(
   LLMConfig(..., num_tpus_per_replica=1))): the replica's worker sees one
   card, GPU available 0 while it lives; phase 4's 8 prompts sent at once
   through handle.generate (32 greedy tokens): 8 of 8 finish (length),
   first tokens 8 of 8 equal phase 4's, in the worker K1 32 per prefill
   forward and K4 32 per decode step, the driver's counts 0,
   overload_stats 8 admitted and 0 shed, K1 and K4 held against their
   plain versions in the worker (phases 2's and 3's tolerances); prints
   the tokens equal to phase 4's (not gated). (b) build_openai_app behind
   the asyncio HTTP proxy (HTTPOptions(port=0)): /v1/models, a unary
   /v1/completions of phase 4's first prompt (token ids, 32 tokens,
   temperature 0) and the same request streamed: 32 SSE chunks whose
   tokens equal the unary's, then [DONE]; the first token equals phase
   4's; after serve.delete the GPU comes back only once the worker has
   exited. (c) build_pd_disagg_deployment, one prefill and one decode
   replica sharing the card (neither asks for it); the 8 prompts at once
   through the router: first tokens 8 of 8 equal phase 4's, disagg_stats 8
   prefills and 0 decode retries, K1 in the prefill worker, K4 32 per
   decode step in the decode worker and no K1 there; the card's free
   memory before and after. (d) build_kvplane_deployment, 2 replicas,
   caching on, 64-token blocks: phase 4b's leader, then its 8 followers
   one at a time through the cache-aware router: first tokens 8 of 8
   equal phase 4b's hits, 8 hits (local or remote) and 8192 tokens saved.
   Then serve.shutdown() and ray_tpu_torch.shutdown(): no worker, no
   /dev/shm/rt segment, the card's memory in use within 64 MiB of before
   4i. Prints each app's time to RUNNING (and each replica's __init__),
   the 8 requests' wall beside phase 4's in-process wall, /v1/models's
   round trip, the stream's first chunk and mean gap, the disagg and
   kvplane walls, and the shutdown's time.
4j. Data and offline batch inference over the runtime on the card
   (ray_tpu_torch.data, ray_tpu_torch.llm.batch), after 4i, on phase 4's
   config, engine settings (paged, 8 slots, page 64, caching off) and
   prompts. The engine factory (data_engine, a functools.partial of it),
   its engine (DataCardEngine, an LLMEngine subclass that writes its
   worker's launch counts and kernel holds to a JSON file per worker) and
   the UDFs (data_prompt, data_result, feed_half) are module-level here;
   every engine actor rebuilds phase 4's weights from seed 0
   (checksum-gated). 32 rows from data.from_items(..., parallelism=4):
   phase 4's 8 prompts at rows 0, 4, ..., 28 among 24 seeded prompts of
   64-1024 tokens. (a) build_llm_processor(factory, 32 greedy tokens,
   batch_size=8, concurrency=1, preprocess, postprocess).take_all(): 32
   rows in input order, each with 32 tokens (length), phase 4's prompts'
   first tokens 8 of 8 equal phase 4's, in the actor's worker K1 32 per
   prefill forward and K4 32 per decode step, the driver's counts 0, K1
   and K4 held against their plain versions in that worker (phases 2's
   and 3's tolerances); the streams' tokens equal to phase 4's printed.
   (b) The same with concurrency=2: two engine actors share the card,
   neither asking for it; the same gates; the first tokens and streams
   equal to (a)'s printed, and the card's free memory before, at its least
   with both up, and after. (c) A seeded 1 GiB .npy (2^20 x 256 f32) in a
   temporary directory through data.read_numpy -> map_batches(feed_half)
   -> iter_torch_batches(batch_size=8192) -> each batch to the card: the
   per-column sums on the card equal numpy's on the host within 1e-6 of
   each column's sum of |x|, and _split_oversized splits the 1 GiB read
   block at target_max_block_size (the count printed). The runtime runs
   with an 8 GiB store. After shutdown() no worker, no /dev/shm/rt
   segment, the card's memory in use within 64 MiB of before 4j. Prints
   each leg's wall, rows/s and generated tok/s beside phase 4's
   in-process wall, the actors' time to ready, the feed's rows/s and GB/s
   and whether the native hashing (g++) was built.
4k. The runtime across processes (core/node.py's agents, node_agent.py,
   transport.py, driver_client.py, the persistent GCS, job/), after 4j,
   on phase 4's engine. (a) A head with num_gpus=0 and a node added with
   add_node(remote=True, resources={"CPU": 2, "GPU": 1}):
   cluster_resources GPU 1; a num_gpus=1 detached named actor
   (CardServer) lands there, its worker forked by the agent's zygote with
   CUDA_VISIBLE_DEVICES set, serves phase 4's 8 prompts: 256 of 256
   tokens and its K1/K4 counts equal phase 4's, the driver's counts do
   not move; K1 and K4 held against their plain versions in that worker;
   the card's memory in use after add_node is as before it (the agent
   holds no CUDA context).
   (b) A second process (this script, --phase4k-driver) attaches with
   init(address="auto"), gets the actor by name and generates: its
   tokens equal phase 4's; a job (this script, --phase4k-job) submitted
   through JobSubmissionClient attaches through RT_HEAD_ADDRESS, does the
   same and ends SUCCEEDED with the equal tokens in its log; each one's
   K1/K4 counts equal phase 4's. (c) A task on an shm_isolation=True node
   returns a 256 MiB host tensor; the driver pulls it over the transfer
   server and uploads it to the card, the bytes equal; GB/s for each.
   Then that node's agent is stopped (SIGSTOP: its socket stays open) and
   the health loop alone marks the node dead, between period x
   (threshold - 2) and period x threshold + PHASE4K_DETECT_SLACK_S.
   (d) A head subprocess (--phase4k-head1) on a gcs_persist_path log
   creates a detached named num_gpus=1 engine actor, checks its tokens,
   puts a KV key, runs a job and kills itself with SIGKILL: the card's
   memory in use returns to its level before that head within
   PHASE4K_MEM_S; a second head (--phase4k-head2) on the same log shows
   the key and the job, re-creates the actor under its name, its tokens
   and K1/K4 counts equal phase 4's; the killed head's /dev/shm segments
   are printed and removed. (e) SIGKILL of the agent that holds (a)'s
   actor: the node is marked dead from its socket's end of file within
   period x threshold + PHASE4K_DETECT_SLACK_S, calls to the actor fail
   with ActorDiedError within PHASE4K_DIED_S, the card's memory comes
   back. (f) shutdown()
   leaves no agent, no worker, no rt segment, and the card's memory as
   before the phase. Prints the agent's boot, the attach, the job's
   start to SUCCEEDED, the re-created actor's time to its first tokens,
   the dead nodes' detection (health loop and end of file), and the
   phase's total, in seconds.
4l. runtime_env and the monitors (runtime_env/, core/log_monitor.py,
   core/memory_monitor.py, util/timeline.py, util/metrics.py's fold,
   dump_worker_stacks), after 4k. A module written to a temporary
   directory holds a module-level actor class (EnvServer, phase 4's
   engine: CardServer's methods) and ships with py_modules; a data file
   and 8 MiB of seeded bytes ship with working_dir; the driver imports the
   module from its file without putting its directory on sys.path, so the
   worker resolves the class only from the archive. The actor is created
   with num_gpus=1 and runtime_env={"working_dir", "py_modules",
   "env_vars"}. (a) It reads the data file from its cwd (under the port's
   runtime_env root) and sees its env var, its worker carries both the
   card's and the env's bindings, it serves phase 4's prompts with 256 of
   256 tokens and K1/K4 counts equal to phase 4's (the driver's 0), K1 and
   K4 are held against their plain versions in its worker; a plain task
   runs on another worker, and after the actor's kill a plain GPU task
   runs on a worker of its own outside the env. (d) dump_worker_stacks
   shows its _generate frame while it generates. (b) ray_tpu_torch.timeline
   lists every generate call on its worker. (c) The line its generate
   prints reaches this process's stderr as "(worker=<id>) ...", through
   the runtime's log monitor, before the last line. (e) Its
   phase4l_generate_total counter shows in get_metrics_snapshot. (f) On a
   MemoryMonitor whose threshold is forced to 0, a retriable GPU task
   holding 4 GiB of the card is killed (one kill), its retry returns the
   same seeded sum, the killed process is gone and the card's memory back
   within 120 s. No memory monitor kills anything else in the run (checked
   at each phase's end). Prints the archives' bytes, the pack and unpack
   seconds, and the actor's time to ready beside phase 4h's.
4m. Cross-language drivers and workers and the cluster tooling
   (core/xlang.py, core/lock_sanitizer.py, autoscaler/, dashboard/,
   util/profiling.py), after 4l, all on one head: a fresh head with no
   card and RT_LOCK_SANITIZER=1, an Autoscaler over a CommandNodeProvider
   whose shell line starts `python -m ray_tpu_torch.scripts.cli agent ...
   --num-gpus {num_gpus}`, one node type {"CPU": 2, "GPU": 1} (min 0, max
   1, idle timeout PHASE4M_IDLE_S). (c) A named num_gpus=1 actor with
   phase 4's engine (ToolingServer, CardServer's methods) waits: the
   scheduler's pending_demand() shows {"GPU": 1}; the autoscaler launches
   the agent, the actor is placed on the joined node and serves phase 4's
   prompts, 256 of 256 tokens and K1/K4 counts equal to phase 4's; K1 and
   K4 are held against their plain versions in its worker. (a) xlang.serve()
   and xlang.export("generate") of the module-level xlang_generate, which
   hands a CALL's JSON prompts to that actor; ray_tpu_torch/cpp/
   generate_driver.cpp (over the repository's cpp/ray_tpu_client.hpp,
   unchanged), built with g++, PUTs and GETs a small string
   PHASE4M_ROUNDS times and a PHASE4M_BULK-byte payload, CALLs generate
   with the 8 prompts and GETs the tokens, which must equal phase 4's.
   (b) The repository's cpp/example_worker.cpp, built unchanged, registers
   with the head; xlang.cpp_function and cpp_actor are driven with
   test_xlang_cpp.py's payloads and their results gated. (d) While the
   actor lives: start_dashboard(port=0)'s /api/nodes lists the launched
   node with "GPU": 1, /api/stacks/<the actor's worker> returns its
   stack, /metrics carries the engine's telemetry series that
   grafana_dashboard_json()'s serving row queries; a generate of phase
   4's first prompt (PHASE4M_PROFILED_TOKENS tokens, a prefix of its
   stream) under util/profiling.profile_trace writes a Chrome trace in the
   worker that names K1's and K4's __global__ symbols. Then the actor is killed, the
   node goes idle and the autoscaler terminates it after the timeout, the
   card's memory comes back, and the lock sanitizer reports no cycle.
   Prints the round trip µs, the payload's GB/s each way, the CALL's wall
   beside the actor's generate.remote() from Python, demand to join,
   demand to tokens, idle to removed and memory back in seconds, and the
   sanitizer's slow holds.
4n. Tensor-parallel serving (parallel/mesh.py, parallel/ranks.py,
   collective/ici.py), after 4m: Llama-3-8B at tp=2 with both ranks on
   the one card (create_mesh(tp=2, devices=[cuda] * 2): rank 0 in this
   process, rank 1 a process of its own, gloo on CUDA tensors, no CUDA
   graph). First phase 4's weights (seed 0) give the tp=1 reference: one
   decode step's logits after the 8 prompts' first TP_LOGIT_PREFIX
   tokens. (a) A paged and a slot engine from seed 0 (each rank draws the
   tree and keeps its shard) serve phase 4's 8 prompts, 32 greedy tokens
   each, with every rank's K1/K4 counts zeroed just before and read just
   after: K1 32 per prefill forward and (paged) K4 32 per decode step on
   EACH rank; then (paged) TP_DECODE_STEPS decode-only steps (one short
   prompt admitted: the step computes all 8 lanes) are timed with rank
   0's host seconds in its group's ops (the collectives' share). On the
   paged engine the first decode step's logits (in every rank at once,
   tp_call) are gated within TP_LOGIT_TOL of tp=1's and equal on both
   ranks, and the int8 collective's logprob drift at the argmax must lie
   in (0, TP_DRIFT_TOL). (c) K1 and K4 are held against their plain
   versions in rank 1's process at its shapes (K1 B=3, T=2048, 16/4
   heads; K4 (8, 4, 4, 1, 128)) and timed beside their bounds. (b) The
   decisive workload (successor_params, ray_tpu's copy model at full
   width, its depth cut to TP_SUCC_LAYERS: the layers are zeros; 8
   prompts of 3-10 tokens, 32 greedy tokens): tp=1, tp=2 fp and
   tp=2 int8 give identical greedy streams that follow the successor map;
   the int8 step's wire bytes under fp's. (d) An n-gram spec engine (k =
   SPEC_K) at tp=2, paged, on the same workload: greedy streams equal the
   plain tp=2 engine's with real acceptances, K4 32 per round on each
   rank (on random bf16 weights a k+1-token verify rounds unlike a
   1-token step, so streams part at near-ties; phase 4d gates first
   tokens there). (e)
   serve.run(build_llm_deployment(LLMConfig(tensor_parallel_size=2,
   num_tpus_per_replica=1, engine_kwargs={"mesh": the one-card mesh, ...})))
   serves phase 4's shortest prompt (TP_SERVE_TOKENS tokens) with the
   tokens (a)'s paged engine gives it alone; after serve.shutdown() its rank process is gone and the
   card's memory back. Every engine's ranks are gone after its shutdown.
   Prints prefill ms, decode ms a step, tok/s, each rank's peak memory,
   the collectives' ms and wire bytes a step, the tokens shared with phase
   4's tp=1 streams.
5. The whole path, card against host: the same widths at 2 layers in f32,
   a 64-token prompt and 8 teacher-forced decode steps on a paged pool,
   f32 and int8; prefill and decode logits must agree. Then the extend: a
   64-token prefix in the pool and a 40-token suffix in a 64 bucket over
   it; its logits must agree. Then the slot layout: the prompt into two
   slots, 8 decode steps, and the suffix extended over the prompt in one
   slot; logits and that slot's K/V must agree. Then the spec verify's
   5-token block forward over the prompt on each layout, card vs host
   (logits within the same tolerance), and on the card speculative engines
   on each layout (the n-gram drafter, and a model drafter with the
   target's own weights) whose greedy streams must equal the plain
   engine's, the self-drafting one with an acceptance rate above 0.8.
   Then the handoff path: extract -> scatter-in -> extract on both
   layouts, in the four dtype directions (bf16 into bf16 and into int8,
   int8 with its scales into int8 and into bf16), bit-identical card vs
   host; and migration on the card: a request checkpointed at 6 of 16
   tokens and restored on a second engine equals the uninterrupted stream,
   greedy and seeded, on the slot and paged graph engines, the paged
   n-gram spec engine (greedy) and the paged sync engine.
6. K2/K3 against their plain version on the card at bench.py's two
   training shapes (B, H, Hkv, T, D) = (8, 16, 8, 2048, 128) and
   (2, 16, 8, 8192, 128) in bf16, a ragged T = 1000, f32 at D 64 and 128,
   and bf16 at D 64 (rep 4, T = 1000) and without the causal mask (T =
   1111); the bf16 shapes timed beside the plain version, the backward of
   PyTorch's scaled_dot_product_attention and the card's bound, with the
   kernels' TFLOP/s and share of the bf16 peak. K5 against its
   plain version at [16384, 2048] (the training rows) and [8, 4096] (a
   decode step), bf16 and f32, timed beside F.rms_norm, with the device
   time per call (torch.profiler) and the wrapper's host cost per call.
7. Training at full width: bench.py's sft model (hidden 2048, 18 layers,
   16/8 heads, vocab 32000, bf16, remat) on 8 x 2048 seeded tokens with
   AdamW(3e-4, weight decay 0.01): one warm-up step whose loss must equal
   loss_fn on the initial parameters within 0.05, then 5 timed steps whose
   last loss must be finite and below the first. K1 must run 36 times per
   step (forward and remat recompute), K2 and K3 18 times each. One more
   step runs under torch.profiler: device time by kernel group and the
   device's idle share, with the full table in
   build/train_step_profile.txt; the wgmma K1 kernel must appear in it
   36 times, the wgmma K2 and K3 kernels 18 times each.
7b. A user's training job on the port's runtime (ray_tpu_torch.train),
   after 7: ray_tpu_torch.init(num_cpus=4), then two fits of JaxTrainer
   with ScalingConfig(num_workers=1, resources_per_worker={"CPU": 1,
   "GPU": 1}): one train worker bound to the card runs phase 7's model,
   batch, optimizer and seed-0 initialisation (the module-level
   train_worker_loop, sent by reference) on 12 batches of 8 x 2048 from a
   dataset (from_items; batch 1 is phase 7's, the rest seeded draws)
   through get_dataset_shard("train").iter_torch_batches(batch_size=8,
   drop_last=True). Fit A (JaxConfig(distributed="always"): a one-rank
   nccl group) gates the card binding (one card, CUDA_VISIBLE_DEVICES,
   get_device() cuda:0, backend nccl), K1/K2/K3 at 36/18/18 every step in
   the worker, step 1's loss equal to phase 7's within 0.05, finite falling
   losses, and the worker's median ms/step (CUDA events around step_fn)
   at most 1.10 x phase 7's in-process ms/step; K1 and K2/K3 are held
   against their plain versions in the worker at the sft shape and timed
   there. Fit B (FailureConfig(max_failures=1)) saves parameters, AdamW
   state and step with jax_checkpoint.save_pytree at step 4 and reports
   it, raises after step 6 once (a marker file), and the restarted worker
   restores the checkpoint onto the card, skips 4 batches and trains
   steps 5-12: one restart, each attempt's steps committed once and in
   order, the resumed losses equal fit A's within 2e-3. After each fit no
   train worker and the card's memory as before; after the phase's
   shutdown no rt segment and every checkpoint byte removed. Prints the worker's time to ready,
   ms/step, tok/s and MFU against phase 7's, the feed's wait and share,
   restart to first resumed step, checkpoint bytes, save and commit
   seconds, and the worker's peak memory.
7c. Tune over the trainers and the actor utilities (ray_tpu_torch.tune,
   ray_tpu_torch.util.actor_pool), each leg on a fresh
   ray_tpu_torch.init(num_cpus=4). (a) A Tuner over phase 7b's JaxTrainer
   (one GPU train worker, JaxConfig(distributed="always"), 7b's batches
   1-6, 6 steps) with param_space {"lr": grid_search([3e-4, 1e-2])} under
   ASHAScheduler(metric="loss", mode="min", time_attr="step", max_t=6,
   grace_period=2, reduction_factor=2): two trials, none in ERROR; one train worker on the card at a time (each
   trial gang-reserves [{"CPU": 0.5}, {"CPU": 1, "GPU": 1}]; the workers'
   windows do not overlap); each worker bound to the card (one card,
   CUDA_VISIBLE_DEVICES '0', nccl, cuda:0) with K1/K2/K3 36/18/18 in every
   step it ran (each worker logs its steps to a file: a trainer's reports
   are committed only after its fit, so a trial ASHA stopped committed 2
   or 4 steps of the 6 its worker ran, and the windows run from the first
   step's start to the last step's report); the committed reports the
   worker's first steps; each trial's reported lr its config's; every trial's
   step 1 loss equal to phase 7's exactly and the 3e-4 trial's losses
   equal to 7b fit A's exactly; a trial ASHA stopped ends at a rung (2 or
   4); get_best_result("loss", "min") the least last loss; each worker's
   median ms/step at most 1.10 x phase 7's. (b) A module-level function
   trainable (card_trial) with tune.with_resources(fn, {"CPU": 1, "GPU":
   1}) runs phase 7's step in its trial actor bound to the card,
   checkpoints with jax_checkpoint after step 3, raises after step 4; the
   first fit ends in ERROR, then Tuner.restore(path, fn,
   resume_errored=True) resumes at step 4 from the step-3 checkpoint
   restored onto the card and ends TERMINATED after step 6, its losses at
   steps 1-6 equal (a)'s 3e-4 trial's and 7b fit A's exactly. (c) An
   ActorPool of two engine actors (PoolEngine: phase 4's engine from seed
   0, num_cpus=1) serves phase 4's 8 prompts through map (results in
   submission order) and map_unordered: greedy tokens 256 of 256 equal
   phase 4's in each; in each actor K1 = 32 per prefill forward and K4 =
   32 per decode step, both non-zero (phase 4's counts per forward); K1
   and K4 held against their plain versions in the first actor at the
   shapes a call runs (each prompt alone: a B=1 prefill at its bucket, one
   decode lane bounded by its length). After
   each leg no actor alive, the workers gone and the card's memory back;
   after each leg's shutdown no worker, no rt segment, no trial staging
   root; at the end every checkpoint byte removed. Prints each leg's wall,
   per trial ms/step, tok/s, MFU, the time from fit() to its first step
   and its peak memory, ASHA's early stops, the wall outside the
   workers' init and steps per report (split into the trials' starts, the
   last steps to the last commits, and the rest), the checkpoint's save,
   staging and commit seconds, the restore
   and the restart to the first resumed step.
7d. Compiled graphs and device objects (ray_tpu_torch.dag,
   ray_tpu_torch.experimental) on phase 4's engine. (a) A num_gpus=1 actor
   E (PoolEngine: phase 4's engine from seed 0) and a CPU actor P in
   `P.summarise.bind(E.generate.bind(inp))`, compiled with
   experimental_compile(channels=True): phase 4's 8 prompts, one per
   execute(), all 8 in flight, then one at a time beside the same calls
   through .remote(): 256 of 256 greedy tokens equal phase 4's; in E's
   worker K1 = 32 per prefill forward and K4 = 32 per decode step, both
   held against their plain versions there at each prompt's shapes; none
   launch in the driver. (b) A three-actor chain of add over 300
   executes: a hop under a quarter of the direct task round trip
   (ray_tpu's gate); each execute is timed, and the line (or the failed
   gate's message) gives the mean, median, p90 and max, every channel
   reader's wait mode (poll or block, experimental/channels.py) in the
   three stages and the driver, and the busiest processes by CPU seconds
   during the executes. (c) teardown(kill_actors=True): no ring of either
   graph left in /dev/shm, every actor DEAD, E's worker gone, the card's
   memory back. (d) A num_gpus=1 owner actor draws phase 4's weights on
   the card and registers the tree (device_put_tree(owner_actor=itself);
   in process each ref resolves to the tensor itself); a second actor
   asking for no card fetches the tree through the owner's export (host
   tensors of the same dtype over the object plane, the store sized to
   twice the largest leaf) onto the card, every leaf's dtype and shape
   kept, a second device_get_tree the cached objects; its engine's 256
   greedy tokens equal the owner's engine's and phase 4's, K1/K4 counted
   and held there; after free_device_object the owner's export raises
   KeyError naming the id. Prints the per-execute walls, the hop and the
   round trip in µs, /dev/shm's free bytes, each leaf's bytes and GB/s,
   the fetch's seconds and the card's free memory with both engines.
7e. The remat policies, after 7d: phase 7's step (model, batch, AdamW,
   seed 0) under each of the four distinct policies of models/llama.py
   (nothing_saveable, dots_with_no_batch_dims_saveable, dots_saveable,
   everything_saveable; checkpoint_dots and
   checkpoint_dots_with_no_batch_dims are aliases), 2 warm-up then 5 timed
   steps each: step 1's loss equal to nothing_saveable's within 1e-3; the
   peak memory (max_memory_allocated after a reset) ordered as the list,
   ties within 16 MiB; K1 twice a layer a step (the forward and the
   recompute: no policy keeps attention, which is a kernel and no product)
   but once under everything_saveable, K2 and K3 once. K1-K3 held against
   their plain versions at the step's shape. Prints each policy's median
   ms/step, tok/s, MFU, peak memory and launches; the times are not gated.
8. RLlib on the card (ray_tpu_torch.rllib). Prints whether gymnasium is
   installed. Always: one PPO update (ray_tpu's _ppo_config: 2048 rows,
   minibatch 256, one epoch), one IMPALA and one APPO update (40 x 100
   fragments) of CartPole-v1's shapes from seeded batches, each learner
   on the card gated against the same update on the host in process
   (metrics within rtol 1e-4 + atol 1e-5, parameters within 1e-4), timed
   beside it; then IMPALA's LearnerGroup with two learner actors on the
   card (asking for no card): 5 updates, one gradient allreduce each
   through the collective API, both learners' weights equal, the
   allreduce's ms printed. With gymnasium: (a) PPO on CartPole-v1 with
   ray_tpu's _ppo_config and the learner on the card, best
   episode_return_mean >= 120 within 15 iterations, each iteration's
   sampling and learning split and env steps/s; (b) IMPALA with 2 env
   runners and 2 learner actors (last return > 21); (c) APPO (best >= 40
   within 22 iterations). The off-policy and offline half, always, at
   ray_tpu's default widths (256, 256), f32, each algorithm's default
   batch, from seeded synthetic episodes of CartPole-v1's and
   Pendulum-v1's shapes: (d) DQN (double Q, a prioritized buffer, batch
   64): one update card vs host (metrics, |td| and parameters), the
   priorities updated from each side's |td| equal, the target synced on
   the card; (e) SAC (batch 256): one update card vs host on the same
   noise (losses, alpha, parameters, log_alpha and the polyak targets),
   alpha moved off 0.1; (f) a JSONL dataset written with the port's
   JsonWriter, read back through JsonReader into a replay buffer and into
   MARWIL's returns-to-go; CQL's, BC's and MARWIL's updates card vs host;
   DQN's capacity refusal on a buffer one row too small. Each prints the
   card's and the host's ms per update (the least of 5), DQN and SAC also
   the card's with an .item() a metric in place of the one copy. With
   gymnasium: (g) DQN learns CartPole-v1 (best >= 100 within 80
   iterations) recording its episodes, SAC learns Pendulum-v1 (best >
   -900 within 130 iterations), then an offline DQN and a BC train from
   the recorded dataset and evaluate greedily.
9. The training path, card against host: the same widths at 2 layers in
   f32, batch 1 x 128, 2 steps; losses, grad norms and the first step's
   gradients must agree.

``python3 chip_smoke.py --gates`` runs phases 7b, 7c and 7d alone (after
the kernels' build, 8 prompts on phase 4's engine in process for the
reference tokens and phase 7's step for its loss and ms/step) and prints
one GATES line with their release seconds and 7d (b)'s hop against its
round trip; copied into another checkout, it runs that checkout's package.

Prints the card's name and power limit (nvidia-smi), one JSON line with
the kernels' launches, errors and times, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Times are CUDA-event means after warm-up (L2 warm; the K4 pages exceed it),
K4's and K5's the least of 5 rounds of 20 calls, K5 in turns with F.rms_norm;
for a launch-bound call the CUDA-event time is the host's enqueue, which
the device time and the host cost per call tell apart.
"""

from __future__ import annotations

import gc
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

from ray_tpu_torch import remote
from ray_tpu_torch.llm import LLMEngine
from ray_tpu_torch.serve.llm import DecodeServer, KVPlaneServer, LLMServer, OpenAIServer, PrefillServer
from ray_tpu_torch.tune.callbacks import Callback

# the card's published peaks (H100 SXM data sheet) for the bound column
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # dense tensor-core rate: the bound for K1's products
F32_FLOPS = 67e12  # CUDA-core f32 rate: K4 computes in f32 on pre-scaled f32 queries

# (B, H, Hkv, T): Llama-3-8B prefill buckets (one ragged), then bench.py's sft training shape
K1_SHAPES = [(1, 32, 8, 64), (4, 32, 8, 512), (2, 32, 8, 2048), (1, 32, 8, 1000), (8, 16, 8, 2048)]
K1_WGMMA = "flash_fwd_kernel_wgmma"  # the bf16 instances' kernel name (SASS, profiler)
K1_TOL_O, K1_TOL_LSE = 2e-2, 1e-3  # o: bf16 output rounding; lse: f32 sums in another order
K4_BOUNDS = [0, 1, 64, 65, 2000, 2047, 700, 1500]
K4_EXTEND_START, K4_EXTEND_T = 1024, (17, 64, 512, 2048)  # one lane's cached prefix; suffix buckets (rep 4: R = 4 T)
PREFIX_LEN, LEADER_SUFFIX, SUFFIX_LENS = 1024, 256, (32, 900)  # phase 4b: shared prefix, leader's tail, follower tails
K4_KERNELS = ("paged_partials_kernel", "paged_merge_kernel")  # the kernels one K4 call launches
K5_KERNELS = ("rms_norm_warp_kernel", "rms_norm_block_kernel")
K4_TOL = 1e-4  # relative, f32 partials summed in another order
COMBINED_TOL = 1e-4  # absolute, normalised f32 attention output vs the host path
WHOLE_PATH_TOL = 2e-3  # absolute, f32 logits after 2 full-width layers, card vs host
# (B, H, Hkv, T, D, dtype, causal): bench.py's training shapes (sft, longctx), a ragged T, f32 at both head
# dims, then bf16 at head_dim 64 (rep 4) and without the mask, at T that straddle the 64- and 128-row tiles
K23_SHAPES = [(8, 16, 8, 2048, 128, "bf16", True), (2, 16, 8, 8192, 128, "bf16", True),
              (1, 16, 8, 1000, 128, "bf16", True), (2, 8, 2, 300, 64, "f32", True), (2, 8, 2, 300, 128, "f32", True),
              (2, 8, 2, 1000, 64, "bf16", True), (2, 16, 8, 1111, 128, "bf16", False)]
K2_WGMMA, K3_WGMMA = "flash_bwd_dq_kernel_wgmma", "flash_bwd_dkv_kernel_wgmma"  # the bf16 instances' kernel names
K23_TOL = {"bf16": 2e-2, "f32": 1e-4}  # relative to max |grad|: bf16 output rounding; f32 sums in another order
K5_SHAPES = [(16384, 2048), (8, 4096)]  # training rows (8 x 2048 tokens at hidden 2048); a decode step
K5_TOL = {"bf16": 2**-7, "f32": 1e-5}  # relative to max |out|: one bf16 ulp; f32 sums in another order
TRAIN_STEPS = 5  # timed, after one warm-up step
DECODE_PROFILE_STEPS = 4  # decode-only engine steps under torch.profiler (phase 4)
SEEDED_TOKENS = 16  # phase 4's seeded streams, held equal across the two decode modes
TEL_GATE = 1.05  # telemetry-on over telemetry-off decode step, best of interleaved rounds (ray_tpu's gate)
ADMIT_GATE = 1.05  # the admission controller attached over detached, decode step, as TEL_GATE (phase 4f)
MIGRATE_STEPS = 11  # decode steps before phases 4e and 4f checkpoint a lane
SPEC_K = 4  # phase 4d's proposals a round: the verify block is SPEC_K + 1 tokens, K4 at R = 4 (SPEC_K + 1)
TRAIN_LOSS_TOL = 0.05  # first step's loss vs loss_fn on the initial params (bench.py's check)
TRAIN_WHOLE_TOL = 1e-3  # card vs host, f32: loss and grad norm relative; gradients relative to each leaf's max
TRAIN_WORKER_STEPS = 12  # phase 7b: batches in the dataset, steps of each fit
TRAIN_WORKER_GATE = 1.10  # phase 7b: the worker's median ms/step over phase 7's in-process ms/step
TRAIN_CKPT_STEP, TRAIN_FAIL_STEP = 4, 6  # phase 7b fit B: checkpoint after step 4, injected failure after step 6
TRAIN_RESUME_TOL = 2e-3  # phase 7b: |resumed loss - fit A's| at steps 5-12 (bf16 loss ~10.4; the same kernels)
TUNE_STEPS = 6  # phase 7c: steps of each trial (phase 7b's batches 1-6)
TUNE_LRS = (3e-4, 1e-2)  # phase 7c (a): the grid; 3e-4 is phase 7's learning rate (two rates: the script's time limit;
# 1e-2 trails 3e-4 at rung 2, so ASHA stops it there: gated)
TUNE_RUNGS = (2, 4)  # phase 7c (a): ASHA's rungs (grace period 2, reduction factor 2, max_t 6)
TUNE_SAVE_STEP, TUNE_FAIL_STEP = 3, 4  # phase 7c (b): checkpoint after step 3, injected failure after step 4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_turns(torch, fns, rounds: int = 5, iters: int = 20) -> list[float]:
    """CUDA-event ms per call of each of ``fns``, measured in turns (f0, f1,
    f0, f1, ...) over ``rounds`` rounds of ``iters`` calls; the least round
    of each. Where a call is launch-bound its CUDA-event time is the host's
    enqueue, which the shared host's load moves between moments: turns put
    every function under the same moments."""
    best = [float("inf")] * len(fns)
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], cuda_ms(torch, fn, iters=iters))
    return best


def device_ms(torch, fn, names, iters: int = 20) -> float:
    """Device time per call of ``fn`` from torch.profiler: the self device
    time of the kernels whose names hold one of ``names``, over ``iters``
    calls after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(self_device_us(e) for e in prof.key_averages()
                if "CUDA" in str(e.device_type) and any(n in e.key for n in names))
    return total / 1e3 / iters


def host_us(torch, fn, calls: int = 300) -> float:
    """The host's cost per call of ``fn``: perf_counter over ``calls`` calls
    with no synchronise between them (the launches queue on the stream)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def k1_bound(B, H, HKV, T, D) -> tuple[float, str]:
    """K1's least time in ms for causal bf16 q [B, H, T, D] over k/v
    [B, HKV, T, D], and what bounds it."""
    flops = 4.0 * B * H * D * T * (T + 1) / 2  # QK^T and PV over the causal pairs
    nbytes = 2.0 * (2 * B * H * T * D + 2 * B * HKV * T * D) + 4.0 * B * H * T  # q, o, k, v bf16; lse f32
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k23_bound(B, H, HKV, T, D, causal: bool = True, es: int = 2) -> dict:
    """K2's and K3's least times in ms for dO over q [B, H, T, D] and k/v
    [B, HKV, T, D] of ``es``-byte elements (f32 lse and delta), what
    bounds each, and its operations: {"dq": (ms, by, flops), "dkv": ...}."""
    pairs = (T * (T + 1) / 2 if causal else T * T) * B * H
    rows_bytes = 2 * 4.0 * B * H * T  # lse and delta, f32
    out = {}
    for kern, flops, nbytes in (
        ("dq", 6.0 * D * pairs, es * (3.0 * B * H * T * D + 2.0 * B * HKV * T * D) + rows_bytes),
        ("dkv", 8.0 * D * pairs, es * (2.0 * B * H * T * D + 4.0 * B * HKV * T * D) + rows_bytes),
    ):
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[kern] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops)
    return out


def k4_bound(qf, pk, sk, tables, bound, m, acc, bounds) -> tuple[float, str]:
    """K4's least time in ms for its call on these tensors, the positions
    it reads being each lane's bound, and what bounds it."""
    nkv, hd, R = qf.shape[1], qf.shape[4], qf.shape[2] * qf.shape[3]
    tok = sum(bounds)  # positions read: each lane's bound
    nbytes = tok * nkv * hd * 2 * pk.element_size() + (tok * nkv * 2 * 4 if sk is not None else 0)
    nbytes += qf.numel() * 4 + (m.numel() * 2 + acc.numel()) * 4 + (tables.numel() + bound.numel()) * 4
    t_ops = 4.0 * tok * nkv * R * hd / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def self_device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if len(sys.argv) > 1 and sys.argv[1] in PHASE4K_MODES:
        return PHASE4K_MODES[sys.argv[1]](*sys.argv[2:])
    if sys.argv[1:] == ["--gates"]:
        return gates_main(torch)
    import dataclasses
    from functools import partial

    import numpy as np
    import torch.nn.functional as F

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.core import memory_monitor
    from ray_tpu_torch.llm import LLMEngine, SamplingParams, SpecConfig
    from ray_tpu_torch.llm import kv_cache as kvc
    from ray_tpu_torch.llm import model_runner as mr
    from ray_tpu_torch.llm import paged_kv as pkv
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials, paged_attn_partials_ref
    from ray_tpu_torch.llm.kv_quant import quantize_heads
    from ray_tpu_torch.llm.spec import verify as sver
    from ray_tpu_torch.models.llama import LlamaConfig, flops_per_token, init_params, loss_fn
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.flash_attention import (attention_bwd_ref, attention_with_lse_ref, flash_attention_bwd_dkv,
                                                   flash_attention_bwd_dq, flash_attention_fwd)
    from ray_tpu_torch.ops.layers import rms_norm, rms_norm_fused
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step, to_device, tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    marks = {}  # phase -> seconds since t_start at its end
    kills = [0]  # the memory monitors' kills this process expects: phase 4l (f)'s only

    def mark(phase):
        marks[phase] = round(time.perf_counter() - t_start, 1)
        check(memory_monitor.kills_total == kills[0], f"phase {phase}: a memory monitor killed "
                                                      f"{memory_monitor.kills_total - kills[0]} workers")

    # ---------------------------------------------------------------- 1
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch import cpp

    with ThreadPoolExecutor(len(PHASE4M_CPP)) as pool:  # phase 4m's C++ programs, g++ beside nvcc
        cpp_builds = [pool.submit(cpp.build, cpp.REPO / src) for src in PHASE4M_CPP]
        build_s = _kernels.build_all()
        cpp_bins = [f.result() for f in cpp_builds]
    for name in _kernels.SOURCES:
        _kernels.library(name)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    print(f"phase 1 build: {build_s:.2f} s for {list(_kernels.SOURCES)} (nvcc sm_90a, parallel); g++ beside it: "
          f"{[os.path.basename(b) for b in cpp_bins]} {card}")
    for name, log in _kernels.build_log.items():
        for line in log.splitlines():
            if "warning" in line.lower() or "Potential Performance Loss" in line:
                print(f"  nvcc {name}: {line.strip()}")
        for fn, rep in _kernels.ptxas_report(log).items():
            print(f"  ptxas {name} {fn}: {rep['registers']} registers, spill stores {rep['spill_stores']} bytes, "
                  f"spill loads {rep['spill_loads']} bytes")
    hgmma = _kernels.count_sass(_kernels.sass("flash_attention"), "HGMMA")
    k1_ptxas = _kernels.ptxas_report(_kernels.build_log.get("flash_attention", ""))
    for fn, n in hgmma.items():
        print(f"phase 1 K1 SASS {fn}: {n} HGMMA")
    wgmma_fns = [fn for fn in hgmma if K1_WGMMA in fn]
    check(len(wgmma_fns) == 2 and all(hgmma[fn] > 0 for fn in wgmma_fns),
          f"K1: the bf16 instances have no HGMMA instructions: {hgmma}")
    # (no report when an earlier run in this checkout built the library: that run checked it)
    check(all(rep["spill_stores"] == rep["spill_loads"] == 0 for fn, rep in k1_ptxas.items() if K1_WGMMA in fn),
          f"K1: ptxas spills in a bf16 instance: {k1_ptxas}")
    hgmma = _kernels.count_sass(_kernels.sass("flash_attention_bwd"), "HGMMA")
    bwd_ptxas = _kernels.ptxas_report(_kernels.build_log.get("flash_attention_bwd", ""))
    for kern, tag in (("K2", K2_WGMMA), ("K3", K3_WGMMA)):
        for fn, n in hgmma.items():
            if tag in fn:
                regs = bwd_ptxas.get(fn)
                print(f"phase 1 {kern} SASS {fn}: {n} HGMMA"
                      + (f", {regs['registers']} registers, spill stores {regs['spill_stores']} bytes, spill loads "
                         f"{regs['spill_loads']} bytes" if regs else ""))
        wgmma_fns = [fn for fn in hgmma if tag in fn]
        check(len(wgmma_fns) == 2 and all(hgmma[fn] > 0 for fn in wgmma_fns),
              f"{kern}: the bf16 instances have no HGMMA instructions: {hgmma}")
        check(all(rep["spill_stores"] == rep["spill_loads"] == 0 for fn, rep in bwd_ptxas.items() if tag in fn),
              f"{kern}: ptxas spills in a bf16 instance: {bwd_ptxas}")
    serialized = [line.strip() for log in _kernels.build_log.values() for line in log.splitlines()
                  if "serialized" in line and "wgmma" in line]
    check(not serialized, f"ptxas runs a kernel's wgmma instructions one at a time: {serialized}")

    mark("1")
    # ---------------------------------------------------------------- 2
    D = 128
    g = torch.Generator(device=dev).manual_seed(0)
    k1_rows = []
    for B, H, HKV, T in K1_SHAPES:
        q = torch.randn((B, H, T, D), generator=g, device=dev).bfloat16()
        k = torch.randn((B, HKV, T, D), generator=g, device=dev).bfloat16()
        v = torch.randn((B, HKV, T, D), generator=g, device=dev).bfloat16()
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention_with_lse_ref(q, k, v, causal=True)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        check(err_o <= K1_TOL_O and err_lse <= K1_TOL_LSE,
              f"K1 (B={B}, H={H}/{HKV}, T={T}): |do| {err_o:.3g} (tol {K1_TOL_O}), |dlse| {err_lse:.3g} "
              f"(tol {K1_TOL_LSE})")
        ms = cuda_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True))
        plain_ms = cuda_ms(torch, lambda: attention_with_lse_ref(q, k, v, causal=True), iters=3, warmup=1)
        sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True))
        flops = 4.0 * B * H * D * T * (T + 1) / 2  # QK^T and PV over the causal pairs
        bound_ms, bound_by = k1_bound(B, H, HKV, T, D)
        row = dict(B=B, H=H, HKV=HKV, T=T, err_o=err_o, err_lse=err_lse, ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                   tflops=flops / ms * 1e-9, bound_ms=bound_ms, bound_by=bound_by)
        k1_rows.append(row)
        print(f"phase 2 K1 B={B} H={H}/{HKV} T={T}: |do| {err_o:.3g} |dlse| {err_lse:.3g} kernel {ms:.4f} ms "
              f"({row['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms "
              f"({flops / sdpa_ms * 1e-9:.1f} TFLOP/s), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"kernel / sdpa {ms / sdpa_ms:.2f} {card}")
        del q, k, v, o, lse
    # the bf16 instances without the causal mask at ragged T and every GQA rep, then the f32
    # instances (phase 5 runs them), each at head_dim 64 and 128
    k1_checks = [(torch.bfloat16, d, T, rep, False, K1_TOL_O) for d in (64, 128) for T in (129, 1000)
                 for rep in (1, 2, 4)]
    k1_checks += [(torch.float32, d, 200, 4, True, 1e-4) for d in (128, 64)]
    k1_err = max(r["err_o"] for r in k1_rows)  # bf16 |do| over every check
    for dt, d, T, rep, causal, tol in k1_checks:
        q, k, v = (torch.randn(s, generator=g, device=dev).to(dt) for s in ((2, 2 * rep, T, d), (2, 2, T, d),
                                                                            (2, 2, T, d)))
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = attention_with_lse_ref(q, k, v, causal=causal)
        err = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        check(err <= tol and err_lse <= K1_TOL_LSE,
              f"K1 {dt} D={d} T={T} rep={rep} causal={causal}: |do| {err:.3g} (tol {tol}), |dlse| {err_lse:.3g}")
        if dt == torch.bfloat16:
            k1_err = max(k1_err, err)
        print(f"phase 2 K1 {dt} D={d} T={T} rep={rep} causal={causal}: |do| {err:.3g} |dlse| {err_lse:.3g}")

    mark("2")
    # ---------------------------------------------------------------- 3
    Bl, NKV, REP, HD, PAGE, MAX_PG = 8, 8, 4, 128, 64, 32
    P = Bl * MAX_PG + 1
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(rng.permutation(np.arange(1, P)).reshape(Bl, MAX_PG).astype(np.int32)).to(dev)
    bound = torch.tensor(K4_BOUNDS, dtype=torch.int32, device=dev)
    live = bound > 0  # l/acc differ at bound 0 by design (csrc/paged_attn.cu)
    kf = torch.randn((P, PAGE, NKV, HD), generator=g, device=dev)
    vf = torch.randn((P, PAGE, NKV, HD), generator=g, device=dev)
    kq, ks = quantize_heads(kf)
    vq, vs = quantize_heads(vf)
    pools = {
        "bf16": (kf.bfloat16(), vf.bfloat16(), None, None),
        "int8": (kq, vq, ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()),
    }
    k4_rows = []

    def k4_times(qf, pk, pv, tables, bound, sk, sv, m, acc, bounds):
        call = partial(paged_attn_partials, qf, pk, pv, tables, bound, sk, sv)
        bound_ms, bound_by = k4_bound(qf, pk, sk, tables, bound, m, acc, bounds)
        return dict(ms=cuda_ms_turns(torch, [call])[0], device_ms=device_ms(torch, call, K4_KERNELS),
                    host_us=host_us(torch, call),
                    plain_ms=cuda_ms(torch, partial(paged_attn_partials_ref, qf, pk, pv, tables, bound, sk, sv),
                                     iters=5, warmup=1),
                    bound_ms=bound_ms, bound_by=bound_by)

    def k4_line(row):
        return (f"kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f} ms, host {row['host_us']:.2f} us a call), "
                f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), device / bound "
                f"{row['device_ms'] / row['bound_ms']:.2f} {card}")

    for pname, (pk, pv, sk, sv) in pools.items():
        for T in (1, 5):
            qf = torch.randn((Bl, NKV, REP, T, HD), generator=g, device=dev) * HD**-0.5
            m, l, acc = paged_attn_partials(qf, pk, pv, tables, bound, sk, sv)
            torch.cuda.synchronize()
            m_r, l_r, acc_r = paged_attn_partials_ref(qf, pk, pv, tables, bound, sk, sv)
            err = max((m - m_r).abs().max().item(), (l - l_r)[live].abs().max().item(),
                      (acc - acc_r)[live].abs().max().item())
            rel = max(((l - l_r)[live].abs() / l_r[live].abs().clamp(min=1)).max().item(),
                      ((acc - acc_r)[live].abs() / acc_r[live].abs().clamp(min=1)).max().item())
            check((m - m_r).abs().max().item() <= 1e-4 and rel <= K4_TOL,
                  f"K4 {pname} T={T}: max |d| {err:.3g}, relative {rel:.3g} (tol {K4_TOL})")
            row = dict(pool=pname, T=T, B=Bl, err=err, rel=rel,
                       **k4_times(qf, pk, pv, tables, bound, sk, sv, m, acc, K4_BOUNDS))
            k4_rows.append(row)
            print(f"phase 3 K4 {pname} T={T} B={Bl}: max |d| {err:.3g} (rel {rel:.3g}) " + k4_line(row))
        # one lane at bound 2047: the case splitting exists for (8 blocks without it)
        qf = torch.randn((1, NKV, REP, 1, HD), generator=g, device=dev) * HD**-0.5
        t1, b1 = tables[5:6].contiguous(), bound[5:6].contiguous()
        m, l, acc = paged_attn_partials(qf, pk, pv, t1, b1, sk, sv)
        m_r, l_r, acc_r = paged_attn_partials_ref(qf, pk, pv, t1, b1, sk, sv)
        err = max((m - m_r).abs().max().item(), (l - l_r).abs().max().item(), (acc - acc_r).abs().max().item())
        rel = max(((l - l_r).abs() / l_r.abs().clamp(min=1)).max().item(),
                  ((acc - acc_r).abs() / acc_r.abs().clamp(min=1)).max().item())
        check((m - m_r).abs().max().item() <= 1e-4 and rel <= K4_TOL,
              f"K4 {pname} one lane: max |d| {err:.3g}, relative {rel:.3g} (tol {K4_TOL})")
        row = dict(pool=pname, T=1, B=1, err=err, rel=rel, **k4_times(qf, pk, pv, t1, b1, sk, sv, m, acc, [2047]))
        k4_rows.append(row)
        print(f"phase 3 K4 {pname} T=1 B=1 bound 2047: max |d| {err:.3g} (rel {rel:.3g}) " + k4_line(row))
        # the prefix-cache extend: one lane, a 1024-token prefix, the suffix's bucket of query rows
        b1 = torch.tensor([K4_EXTEND_START], dtype=torch.int32, device=dev)
        for T in K4_EXTEND_T:
            qf = torch.randn((1, NKV, REP, T, HD), generator=g, device=dev) * HD**-0.5
            m, l, acc = paged_attn_partials(qf, pk, pv, t1, b1, sk, sv)
            m_r, l_r, acc_r = paged_attn_partials_ref(qf, pk, pv, t1, b1, sk, sv)
            dm = (m - m_r).abs().max().item()
            err = max(dm, (l - l_r).abs().max().item(), (acc - acc_r).abs().max().item())
            rel = max(((l - l_r).abs() / l_r.abs().clamp(min=1)).max().item(),
                      ((acc - acc_r).abs() / acc_r.abs().clamp(min=1)).max().item())
            del m_r, l_r, acc_r
            check(dm <= 1e-4 and rel <= K4_TOL,
                  f"K4 {pname} extend T={T}: max |d| {err:.3g}, relative {rel:.3g} (tol {K4_TOL})")
            row = dict(pool=pname, T=T, B=1, extend=True, err=err, rel=rel,
                       **k4_times(qf, pk, pv, t1, b1, sk, sv, m, acc, [K4_EXTEND_START]))
            k4_rows.append(row)
            print(f"phase 3 K4 {pname} extend T={T} (R={REP * T}) B=1 bound {K4_EXTEND_START}: max |d| {err:.3g} "
                  f"(rel {rel:.3g}) " + k4_line(row))
            del qf, m, l, acc
        # the combined attention (partials + self fold + normalise) at every
        # bound, 0 included: card (K4) against the host path (plain version)
        qg = torch.randn((Bl, NKV, REP, HD), generator=g, device=dev)
        k_self = torch.randn((Bl, NKV, HD), generator=g, device=dev)
        v_self = torch.randn((Bl, NKV, HD), generator=g, device=dev)
        scale = HD**-0.5
        out = pkv._paged_attn_batch(qg, pk, pv, tables, bound, scale, k_self, v_self, sk, sv)
        cpu = [None if t is None else t.cpu() for t in (qg, pk, pv, tables, bound, k_self, v_self, sk, sv)]
        ref = pkv._paged_attn_batch(*cpu[:5], scale, *cpu[5:])
        err = (out.cpu() - ref).abs().max().item()
        check(err <= COMBINED_TOL, f"combined page attention {pname}: |d| {err:.3g} (tol {COMBINED_TOL})")
        print(f"phase 3 combined page attention {pname} at bounds {K4_BOUNDS}: |d| {err:.3g}")

    mark("3")
    # ---------------------------------------------------------------- 4
    cfg = LlamaConfig.llama3_8b(max_seq_len=2048, remat=False)
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    drv_checksum = weights_checksum(params)  # phase 4h's card actors rebuild these weights
    lens = rng.integers(50, 1501, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    seeded = [SamplingParams(max_tokens=SEEDED_TOKENS, temperature=0.8, top_p=0.9, seed=s) for s in range(4)]
    print(f"phase 4 engine llama3_8b (32 layers, bf16, random weights from seed 0, init {init_s:.2f} s): 8 prompts of "
          f"{sorted(int(n) for n in lens)} tokens, 32 greedy tokens each, then 4 seeded (temperature 0.8, top_p 0.9, "
          f"{SEEDED_TOKENS} tokens)")

    def serve_modes(phase, label, modes, profile_modes=(), overhead=False, **engine_kw):
        """Serve the 8 prompts (32 greedy tokens each) and the 4 seeded ones on
        one engine per decode mode ("graph": the default, device-resident;
        "sync": device_resident=False); then, for ``profile_modes``, the 8
        prompts again and 4 + 4 decode-only steps profiled. Phase 4's graph
        engine gates its telemetry and, with ``overhead``, measures the
        telemetry's cost. Returns each mode's run; the graph and sync runs'
        streams must be identical."""
        runs = {}
        for mode in modes:
            torch.cuda.reset_peak_memory_stats()
            eng = LLMEngine(cfg, params, max_num_seqs=8, device_resident=mode == "graph",
                            telemetry_tags={"model": f"phase {phase} {label} {mode}"}, **engine_kw)
            paged = eng.kv_layout == "paged"
            check(eng.kv_cache_stats()["attn_kernel"] == ("cuda" if paged else "torch"),
                  f"engine {label} {mode}: attention {eng.kv_cache_stats()['attn_kernel']}")
            check((eng.graph_capture_s > 0) == (mode == "graph"), f"engine {label} {mode}: graph capture "
                  f"{eng.graph_capture_s} s")
            run = serve_engine(torch, eng, prompts, f"phase {phase} engine {label} {mode}", card,
                               k4_per_step=L if paged else 0)
            if phase == "4" and mode == "graph":
                run["telemetry"] = telemetry_gates(eng, run, f"phase 4 engine {label} {mode}", card)
            run["seeded"] = [o.token_ids for o in eng.generate(prompts[:4], seeded)]
            check(all(len(t) == SEEDED_TOKENS for t in run["seeded"]), f"engine {label} {mode}: seeded requests cut short")
            if mode in profile_modes:
                # the 8 prompts again; once none waits, every step is decode only
                for prompt in prompts:
                    eng.add_request(prompt, SamplingParams(max_tokens=32))
                while eng.num_waiting:
                    eng.step()
                check(eng.num_running == 8, f"engine {label} {mode}: {eng.num_running} of 8 requests running")
                name = label.replace(" ", "_")
                run["profile"] = profile_decode(torch, eng, DECODE_PROFILE_STEPS, f"phase {phase} {label} {mode}", card,
                                                _kernels.BUILD_DIR / f"decode_step_profile_{name}_{mode}.txt")
                n_prof = (L if paged else 0) * DECODE_PROFILE_STEPS
                calls = run["profile"]["calls"]
                check(calls["paged_partials_kernel"] == n_prof and calls["paged_merge_kernel"] in (0, n_prof),
                      f"decode profile {label} {mode}: K4's kernels ran {calls} times in {DECODE_PROFILE_STEPS} steps, "
                      f"not {n_prof}")
            if overhead and mode == "graph":
                while eng.has_unfinished():
                    eng.step()
                run["tel_ratio"] = telemetry_overhead(torch, eng, prompts, f"phase {phase} {label} {mode}", card)
            runs[mode] = run
            del eng
            torch.cuda.empty_cache()
        if len(runs) == 2:
            gr, sy = runs["graph"], runs["sync"]
            check(gr["tokens"] == sy["tokens"], f"engine {label}: the graph and sync engines' greedy tokens differ: "
                  f"{sum(a == b for a, b in zip(gr['tokens'], sy['tokens']))} of 8 streams equal")
            check(gr["seeded"] == sy["seeded"], f"engine {label}: the graph and sync engines' seeded streams differ: "
                  f"{[sum(x == z for x, z in zip(a, b)) for a, b in zip(gr['seeded'], sy['seeded'])]} tokens equal")
            idle = (f", idle share {gr['profile']['idle']:.4f} vs {sy['profile']['idle']:.4f}"
                    if "profile" in gr and "profile" in sy else "")
            print(f"phase {phase} {label} graph vs sync: greedy tokens identical in 8 of 8 streams, seeded streams (4 lanes, "
                  f"temperature 0.8, top_p 0.9, {SEEDED_TOKENS} tokens) identical in 4 of 4; decode "
                  f"{gr['decode_ms']:.3f} vs {sy['decode_ms']:.3f} ms/step (sync / graph "
                  f"{sy['decode_ms'] / gr['decode_ms']:.3f}), {gr['tok_s']:.2f} vs {sy['tok_s']:.2f} generated "
                  f"tok/s{idle}, peak memory {gr['peak']} vs {sy['peak']} bytes {card}")
        return runs

    serve = serve_modes("4", "paged bf16", ("graph", "sync"), ("graph", "sync"), overhead=True, kv_layout="paged",
                        page_size=64)
    gr = serve["graph"]
    k1_launches, k4_launches = gr["k1"], gr["k4"]
    ref_tokens = gr["tokens"]  # phases 4c and 4d hold their engines' first tokens against these
    tel_ratio = gr["tel_ratio"]

    mark("4")
    # ---------------------------------------------------------------- 4b
    prefix = rng.integers(1, cfg.vocab_size, size=PREFIX_LEN).tolist()
    leader = prefix + rng.integers(1, cfg.vocab_size, size=LEADER_SUFFIX).tolist()
    firsts = rng.choice(np.setdiff1d(np.arange(1, cfg.vocab_size), [leader[PREFIX_LEN]]), size=8, replace=False)
    suffix_lens = rng.integers(SUFFIX_LENS[0], SUFFIX_LENS[1] + 1, size=8)
    followers = [prefix + [int(f)] + rng.integers(1, cfg.vocab_size, size=int(n) - 1).tolist()
                 for f, n in zip(firsts, suffix_lens)]

    def prefix_hits(label, **engine_kw):
        """The leader, then the 8 followers, on a fresh engine with prefix
        caching on (64-token blocks): 8 hits, 1 miss, 8192 tokens saved, K1
        32 times per prefill forward, K4 32 times per decode step and extend
        forward, every request 32 tokens. Returns the engine and its hit wave."""
        eng = LLMEngine(cfg, params, max_num_seqs=8, kv_layout="paged", page_size=64, prefix_block=64, **engine_kw)
        flash_attention_fwd.launches = 0
        paged_attn_partials.launches = 0
        lead_out = eng.generate(leader, SamplingParams(max_tokens=32))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prefill_before = eng.prefill_s
        t0 = time.perf_counter()
        outs = eng.generate(followers, SamplingParams(max_tokens=32))
        wave = dict(outs=outs, wall_s=time.perf_counter() - t0, prefill_s=eng.prefill_s - prefill_before,
                    peak=torch.cuda.max_memory_allocated(), k1=flash_attention_fwd.launches,
                    k4=paged_attn_partials.launches, stats=eng.prefix_cache_stats())
        stats = wave["stats"]
        check(len(lead_out.token_ids) == 32 and all(len(o.token_ids) == 32 and o.finish_reason == "length" for o in outs),
              f"prefix caching {label}: not every request finished with 32 tokens: {[len(o.token_ids) for o in outs]}")
        check((stats["hits"], stats["misses"], stats["tokens_saved"]) == (8, 1, 8 * PREFIX_LEN),
              f"prefix caching {label}: stats {stats}, expected 8 hits, 1 miss, {8 * PREFIX_LEN} tokens saved")
        check(wave["k1"] == L * eng.prefill_forwards > 0,
              f"prefix caching {label}: K1 launches {wave['k1']} != {L} x {eng.prefill_forwards} prefill forwards")
        check(wave["k4"] == L * (eng.decode_steps + eng.extend_forwards) and eng.extend_forwards == 8,
              f"prefix caching {label}: K4 launches {wave['k4']} != {L} x ({eng.decode_steps} decode steps + "
              f"{eng.extend_forwards} extend forwards)")
        return eng, wave

    eng, wave = prefix_hits("bf16")
    hit_outs, stats, k1_4b, k4_4b = wave["outs"], wave["stats"], wave["k1"], wave["k4"]
    hit_firsts = [o.token_ids[0] for o in hit_outs]  # phase 4g's remote hits are held against these
    hit_prefill_ms = wave["prefill_s"] * 1e3
    # the same 8 prompts again on this engine (they hit the leader's prefix again): timed warm, then the
    # admitting step profiled
    prefill_before = eng.prefill_s
    eng.generate(followers, SamplingParams(max_tokens=32))
    hit_prefill_warm_s = eng.prefill_s - prefill_before
    wave_prof = profile_hit_wave(torch, eng, followers, SamplingParams(max_tokens=32), card,
                                 _kernels.BUILD_DIR / "hit_wave_profile.txt")
    check(wave_prof["calls"]["paged_partials_kernel"] == L * 9,
          f"hit wave profile: K4 ran {wave_prof['calls']} times, not {L} x (8 extends + 1 decode step)")
    del eng
    torch.cuda.empty_cache()
    eng = LLMEngine(cfg, params, max_num_seqs=8, kv_layout="paged", page_size=64, enable_prefix_caching=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    off_outs = eng.generate(followers, SamplingParams(max_tokens=32))
    off_wall_s = time.perf_counter() - t0
    off_peak = torch.cuda.max_memory_allocated()
    off_prefill_s, off_forwards = eng.prefill_s, eng.prefill_forwards
    eng.generate(followers, SamplingParams(max_tokens=32))
    off_prefill_warm_s = eng.prefill_s - off_prefill_s
    same_first = sum(a.token_ids[0] == b.token_ids[0] for a, b in zip(hit_outs, off_outs))
    print(f"phase 4b prefix caching llama3_8b: leader {len(leader)} tokens, then 8 prompts of {PREFIX_LEN} + "
          f"{sorted(int(n) for n in suffix_lens)} tokens, 32 greedy tokens each: stats {stats}, hit wave prefill "
          f"{wave['prefill_s'] * 1e3:.2f} ms over {8} extend forwards ({wave['wall_s']:.3f} s wall, peak memory "
          f"{wave['peak']} bytes; {hit_prefill_warm_s * 1e3:.2f} ms the second time) against caching off "
          f"{off_prefill_s * 1e3:.2f} ms over {off_forwards} prefill forwards ({off_wall_s:.3f} s wall, peak memory "
          f"{off_peak} bytes; {off_prefill_warm_s * 1e3:.2f} ms the second time); K1 launches {k1_4b}, K4 launches "
          f"{k4_4b}; first tokens equal in {same_first} of 8 (bf16 K1 vs f32 K4, not gated) {card}")
    del eng, off_outs
    torch.cuda.empty_cache()

    mark("4b")
    # ---------------------------------------------------------------- 4c
    # the slot layout (ray_tpu's default) and the int8 cache on both layouts, on phase 4's weights and prompts
    bytes_tok_bf16, bytes_tok_int8 = 2 * L * cfg.num_kv_heads * cfg.hd * 2, 2 * L * cfg.num_kv_heads * (cfg.hd + 4)
    check(bytes_tok_int8 == 67584, f"int8 bytes per token {bytes_tok_int8}")

    def agree(runs, label, want_bytes, want_per_tok):
        """Gates shared by phase 4c's engines: first tokens equal phase 4's
        bf16 paged engine's (the same prefill forward), the cache's
        allocation and bytes per token as computed; prints the greedy tokens
        that agree with phase 4's streams (other attention arithmetic: not
        gated)."""
        for mode, run in runs.items():
            firsts_eq = sum(a[0] == b[0] for a, b in zip(run["tokens"], ref_tokens))
            check(firsts_eq == 8, f"engine {label} {mode}: first tokens equal phase 4's in {firsts_eq} of 8")
            kv = run["stats"]
            check(kv["allocated_bytes"] == want_bytes and kv["bytes_per_token"] == want_per_tok,
                  f"engine {label} {mode}: allocated {kv['allocated_bytes']} bytes (want {want_bytes}), "
                  f"{kv['bytes_per_token']} bytes per token (want {want_per_tok})")
            same = sum(x == z for a, b in zip(run["tokens"], ref_tokens) for x, z in zip(a, b))
            print(f"phase 4c {label} {mode}: first tokens equal phase 4's in 8 of 8; {same} of 256 greedy tokens equal "
                  f"phase 4's bf16 paged streams (not gated)")

    slots = serve_modes("4c", "slots bf16", ("graph", "sync"), ("graph", "sync"), kv_layout="slots")
    agree(slots, "slots bf16", 2 * L * 8 * 2048 * cfg.num_kv_heads * cfg.hd * 2, bytes_tok_bf16)
    int8_paged = serve_modes("4c", "paged int8", ("graph", "sync"), ("graph",), kv_layout="paged", page_size=64,
                             cache_dtype="int8")
    agree(int8_paged, "paged int8", 257 * 64 * bytes_tok_int8, bytes_tok_int8)
    int8_slots = serve_modes("4c", "slots int8", ("graph",), kv_layout="slots", cache_dtype="int8")
    agree(int8_slots, "slots int8", 8 * 2048 * bytes_tok_int8, bytes_tok_int8)
    k4_int8_launches = int8_paged["graph"]["k4"]
    eng, wave8 = prefix_hits("int8", cache_dtype="int8")
    hit_firsts_int8 = [o.token_ids[0] for o in wave8["outs"]]
    same_first = sum(a.token_ids[0] == b.token_ids[0] for a, b in zip(wave8["outs"], hit_outs))
    print(f"phase 4c prefix caching int8 (phase 4b's leader and 8 followers, paged int8 cache): stats "
          f"{wave8['stats']}, hit wave prefill {wave8['prefill_s'] * 1e3:.2f} ms over 8 extend forwards "
          f"({wave8['wall_s']:.3f} s wall, peak memory {wave8['peak']} bytes), K1 launches {wave8['k1']}, K4 launches "
          f"{wave8['k4']} (= {L} x ({eng.decode_steps} decode steps + {eng.extend_forwards} extend forwards)); first "
          f"tokens equal phase 4b's bf16 hits in {same_first} of 8 (not gated) {card}")
    del eng, hit_outs, wave, wave8
    torch.cuda.empty_cache()

    mark("4c")
    # ---------------------------------------------------------------- 4d
    # Llama-3.2-1B's published widths: the public draft model sharing Llama-3-8B's tokenizer
    dcfg = LlamaConfig(vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_layers=16, num_heads=32,
                       num_kv_heads=8, head_dim=64, max_seq_len=2048, rope_theta=500000.0, tie_embeddings=True,
                       remat=False)
    spec_runs = {}
    for label, engine_kw in (
        ("paged ngram", dict(kv_layout="paged", page_size=64, speculative=SpecConfig(drafter="ngram", k=SPEC_K))),
        ("slots ngram", dict(kv_layout="slots", speculative=SpecConfig(drafter="ngram", k=SPEC_K))),
        ("paged model", dict(kv_layout="paged", page_size=64,
                             speculative=SpecConfig(drafter="model", k=SPEC_K, draft_config=dcfg, draft_seed=1))),
    ):
        spec_runs[label] = serve_spec(torch, cfg, params, prompts, seeded, ref_tokens, label, card, **engine_kw)
        torch.cuda.empty_cache()
    k4_spec_launches = spec_runs["paged ngram"]["k4"]
    torch.cuda.empty_cache()

    mark("4d")
    # ---------------------------------------------------------------- 4e
    # KV between engines on phase 4's weights and prompts: handoffs, live migration, suspend
    handoffs = serve_handoffs(torch, cfg, params, prompts, ref_tokens, card)
    moves = migrate_and_suspend(torch, cfg, params, prompts, card)
    k1_4e, k4_4e = handoffs["bf16"]["k1"], handoffs["paged bf16"]["k4"]
    print(f"phase 4e summary: extract {handoffs['bf16']['extract_ms']:.3f} ms a bf16 handoff "
          f"({handoffs['bf16']['extract_2048_ms']:.3f} at the 2048 bucket; int8 {handoffs['int8']['extract_ms']:.3f} / "
          f"{handoffs['int8']['extract_2048_ms']:.3f}), scatter-in admission {handoffs['paged bf16']['admit_ms']:.3f} ms "
          f"(device scatter {handoffs['paged bf16']['scatter_ms']:.3f}; int8 pool {handoffs['paged int8']['admit_ms']:.3f} "
          f"/ {handoffs['paged int8']['scatter_ms']:.3f}; slots {handoffs['slots bf16']['admit_ms']:.3f}), bytes a "
          f"handoff {handoffs['bf16']['bytes'] / 8:.0f} bf16 and {handoffs['int8']['bytes'] / 8:.0f} int8 "
          f"({handoffs['bf16']['tokens']} tokens over 8); checkpoint {moves['checkpoint_ms']:.3f} ms, restore to first "
          f"token {moves['splice_ms']:.3f} ms {card}")
    mark("4e")
    # ---------------------------------------------------------------- 4f
    # the serving control plane over graph engines on phase 4's weights and prompts
    plane = control_plane(torch, cfg, params, prompts, ref_tokens, card)
    dis, ca, adm = plane["disagg"], plane["kvplane"], plane["admission"]
    k1_4f, k4_4f = plane["disagg_a"]["k1"], plane["disagg_a"]["k4"]
    print(f"phase 4f summary: router overhead a request, DisaggRouter {plane['disagg_a']['overhead_us']} us (8 "
          f"concurrent) and {dis['overhead_seq_us']} us (alone), CacheAwareRouter {ca['load']['overhead_us']} us (8 "
          f"concurrent) and {ca['alone_us']} us (alone); the reuse leg {dis['reuse_s'] * 1e3:.1f} ms vs the re-prefill leg {dis['lost_s'] * 1e3:.1f} "
          f"ms; the resume call {dis['resume_s'] * 1e3:.1f} ms vs re-prefilling prompt + {dis['emitted']} tokens "
          f"{dis['reprefill_s'] * 1e3:.1f} ms; check() {adm['check_us']:.2f} us; decode ratio with the admission "
          f"controller {adm['ratio']:.4f} (gate {ADMIT_GATE}) {card}")
    torch.cuda.empty_cache()

    mark("4f")
    # ---------------------------------------------------------------- 4g
    # the object plane: handoffs across processes, migration and suspend through references, the cluster KV plane
    objp = object_plane(torch, cfg, params, prompts, ref_tokens, handoffs["paged bf16"]["tokens"], leader, followers,
                        hit_firsts, hit_firsts_int8, hit_prefill_ms, off_prefill_s * 1e3, card, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4g end: {torch.cuda.memory_allocated()} bytes still allocated on the card (the weights and every "
          f"engine freed) {card}")

    mark("4g")
    # ---------------------------------------------------------------- 4h
    # the runtime on the card: a GPU actor serving phase 4's engine, the card as a resource, a restart, a GPU task
    rtc = runtime_on_card(torch, cfg, prompts, gr, drv_checksum, card, dev)
    torch.cuda.empty_cache()

    mark("4h")
    # ---------------------------------------------------------------- 4i
    # Serve over the runtime: a GPU replica, the OpenAI app behind the asyncio proxy, the disagg and kvplane apps
    svc = serve_on_card(torch, cfg, prompts, gr, drv_checksum, leader, followers, hit_firsts, card)
    torch.cuda.empty_cache()

    mark("4i")
    # ---------------------------------------------------------------- 4j
    # Data and offline batch inference: engine actors serving 32 dataset rows, then a 1 GiB feed to the card
    dat = data_on_card(torch, cfg, prompts, gr, drv_checksum, card, dev)
    torch.cuda.empty_cache()

    mark("4j")
    # ---------------------------------------------------------------- 4k
    # the runtime across processes: a GPU actor on an agent's node, an attached driver and a job, a cross-namespace
    # pull, a head killed and its detached actor re-created from the persistent GCS, an agent's death
    agt = agents_on_card(torch, cfg, prompts, gr, drv_checksum, card, dev)
    torch.cuda.empty_cache()

    mark("4k")
    # ---------------------------------------------------------------- 4l
    # runtime_env and the monitors: a GPU actor from a packed working_dir and py_modules, its timeline, its log
    # line, its stack, its counter, and the memory monitor's kill of a retriable GPU task
    envc = env_on_card(torch, cfg, prompts, gr, drv_checksum, rtc["ready_s"], card, dev)
    kills[0] += 1
    torch.cuda.empty_cache()

    mark("4l")
    # ---------------------------------------------------------------- 4m
    # cross-language and the cluster tooling: a pending GPU actor makes the autoscaler launch a GPU node; a C++
    # driver's CALL served by the actor there, a C++ worker, the dashboard and a profiled generate, the lock sanitizer
    tool = tooling_on_card(torch, cfg, prompts, gr, drv_checksum, card, dev)
    torch.cuda.empty_cache()

    mark("4m")
    # ---------------------------------------------------------------- 4n
    # tensor-parallel serving: Llama-3-8B at tp=2, both ranks on the one card over gloo
    tpn = tp_on_card(torch, cfg, prompts, gr, spec_runs["paged ngram"]["tokens"], card, dev)
    torch.cuda.empty_cache()

    mark("4n")
    # ---------------------------------------------------------------- 5
    cfg2 = LlamaConfig.llama3_8b(max_seq_len=2048, remat=False, num_layers=2, dtype="float32")
    p_gpu = init_params(cfg2, torch.Generator(device=dev).manual_seed(1))
    p_cpu = {k: ({n: w.cpu() for n, w in v.items()} if isinstance(v, dict) else v.cpu()) for k, v in p_gpu.items()}
    prompt = rng.integers(1, cfg2.vocab_size, size=64)
    forced = rng.integers(1, cfg2.vocab_size, size=8)
    flash_attention_fwd.launches = 0
    paged_attn_partials.launches = 0

    def run(params, device, dtype="float32"):
        pcfg = pkv.PagedCacheConfig(num_layers=2, num_pages=3, page_size=64, max_pages_per_seq=2, num_slots=1,
                                    num_kv_heads=cfg2.num_kv_heads, head_dim=cfg2.hd, dtype=dtype)
        pool = pkv.alloc(pcfg, device)
        table = torch.tensor([[1, 2]], dtype=torch.int32, device=device)
        toks = torch.from_numpy(prompt[None]).to(device)
        logits, ks, vs = mr.prefill(params, toks, torch.tensor([64], device=device), cfg2)
        pkv.insert_pages(pool, table[0, :1], ks[:, 0], vs[:, 0])
        steps = [logits.cpu()]
        lengths = torch.tensor([64], dtype=torch.int32, device=device)
        for t in forced:
            logits, pool, lengths = mr.decode_step_paged(
                params, pool, table, lengths, torch.tensor([int(t)], device=device), cfg2)
            steps.append(logits.cpu())
        return steps

    def whole_path(name, fn, k1, k4):
        """``fn`` on the card (K1 and K4 launched as stated) and on the host:
        every logits tensor within WHOLE_PATH_TOL. Returns the errors."""
        flash_attention_fwd.launches = 0
        paged_attn_partials.launches = 0
        on_card = fn(p_gpu, dev)
        check((flash_attention_fwd.launches, paged_attn_partials.launches) == (k1, k4),
              f"whole path {name}: the card run launched K1/K4 {flash_attention_fwd.launches}/"
              f"{paged_attn_partials.launches} times, not {k1}/{k4}")
        on_host = fn(p_cpu, torch.device("cpu"))
        errs = [(a - b).abs().max().item() for a, b in zip(on_card, on_host)]
        check(all(np.isfinite(errs)) and max(errs) <= WHOLE_PATH_TOL,
              f"whole path {name}: logits differ by {max(errs):.3g} (tol {WHOLE_PATH_TOL})")
        return errs, max(b.abs().max().item() for b in on_host)

    errs, scale = whole_path("paged", run, 2, 2 * len(forced))
    print(f"phase 5 whole path (2 layers, f32, card vs host): prefill |dlogits| {errs[0]:.3g}, decode max "
          f"{max(errs[1:]):.3g} over {len(forced)} steps (max |logit| {scale:.3g}, tol {WHOLE_PATH_TOL})")
    errs, scale = whole_path("paged int8", partial(run, dtype="int8"), 2, 2 * len(forced))
    print(f"phase 5 whole path int8 pool (K4's int8 branch, card vs host): prefill |dlogits| {errs[0]:.3g}, decode "
          f"max {max(errs[1:]):.3g} over {len(forced)} steps (max |logit| {scale:.3g}, tol {WHOLE_PATH_TOL})")
    suffix = np.zeros(64, np.int64)
    suffix[:40] = rng.integers(1, cfg2.vocab_size, size=40)

    def run_extend(params, device):
        """The 64-token prompt's K/V in page 1, then a 40-token suffix in a 64 bucket extended over it."""
        pcfg = pkv.PagedCacheConfig(num_layers=2, num_pages=3, page_size=64, max_pages_per_seq=2, num_slots=1,
                                    num_kv_heads=cfg2.num_kv_heads, head_dim=cfg2.hd, dtype="float32")
        pool = pkv.alloc(pcfg, device)
        row = torch.tensor([1, 2], dtype=torch.int32, device=device)
        _, ks, vs = mr.prefill(params, torch.from_numpy(prompt[None]).to(device), torch.tensor([64], device=device),
                               cfg2)
        pkv.insert_pages(pool, row[:1], ks[:, 0], vs[:, 0])
        logits, pool = mr.extend_paged(params, pool, row, 64, torch.from_numpy(suffix).to(device), 40, cfg2)
        return logits.cpu(), pool["k"].cpu(), pool["v"].cpu()

    ext_errs, _ = whole_path("extend", run_extend, 2, 2)
    print(f"phase 5 extend (2 layers, f32, 64-token prefix + 40-token suffix in a 64 bucket, card vs host): "
          f"|dlogits| {ext_errs[0]:.3g}, pool |dk| {ext_errs[1]:.3g} |dv| {ext_errs[2]:.3g} (tol {WHOLE_PATH_TOL})")

    def run_slots(params, device):
        """The slot layout: the 64-token prompt into slot 0 of a 128-position
        cache, 8 teacher-forced decode steps, then the 40-token suffix
        extended over the prompt in slot 1."""
        cache = kvc.alloc(kvc.CacheConfig(num_layers=2, num_slots=2, max_seq_len=128, num_kv_heads=cfg2.num_kv_heads,
                                          head_dim=cfg2.hd, dtype="float32"), device)
        logits, ks, vs = mr.prefill(params, torch.from_numpy(prompt[None]).to(device),
                                    torch.tensor([64], device=device), cfg2)
        kvc.insert_sequence(cache, 0, ks[:, 0], vs[:, 0], 64)
        kvc.insert_sequence(cache, 1, ks[:, 0], vs[:, 0], 64)
        out = [logits.cpu()]
        for t in forced:
            logits, cache = mr.decode_step(params, cache, torch.tensor([int(t), 0], device=device), cfg2)
            out.append(logits[0].cpu())
        cache["length"][1] = 64  # slot 1 back to the prompt: its 8 decoded positions are overwritten or masked
        logits, cache = mr.extend(params, cache, 1, torch.from_numpy(suffix).to(device), 40, cfg2)
        return out + [logits.cpu(), cache["k"][:, 1].cpu(), cache["v"][:, 1].cpu()]

    slot_errs, scale = whole_path("slots", run_slots, 2, 0)
    print(f"phase 5 slot layout (2 layers, f32, card vs host): prefill |dlogits| {slot_errs[0]:.3g}, decode max "
          f"{max(slot_errs[1:9]):.3g} over {len(forced)} steps, extend |dlogits| {slot_errs[9]:.3g}, slot 1 |dk| "
          f"{slot_errs[10]:.3g} |dv| {slot_errs[11]:.3g} (max |value| {scale:.3g}, tol {WHOLE_PATH_TOL})")
    spec_blk = torch.from_numpy(forced[: SPEC_K + 1][None].astype(np.int64))

    def run_verify(params, device, layout):
        """The spec verify's block forward: the 64-token prompt cached, then
        a (k + 1)-token block at positions 64..68 over it."""
        toks = torch.from_numpy(prompt[None]).to(device)
        _, ks, vs = mr.prefill(params, toks, torch.tensor([64], device=device), cfg2)
        blk = spec_blk.to(device)
        if layout == "paged":
            pcfg = pkv.PagedCacheConfig(num_layers=2, num_pages=3, page_size=64, max_pages_per_seq=2, num_slots=1,
                                        num_kv_heads=cfg2.num_kv_heads, head_dim=cfg2.hd, dtype="float32")
            pool = pkv.alloc(pcfg, device)
            table = torch.tensor([[1, 2]], dtype=torch.int32, device=device)
            pkv.insert_pages(pool, table[0, :1], ks[:, 0], vs[:, 0])
            logits, k_blk, v_blk = sver._forward_block_paged(params, pool, table,
                                                             torch.tensor([64], dtype=torch.int32, device=device),
                                                             blk, cfg2)
            return [logits.cpu(), k_blk.cpu(), v_blk.cpu()]
        cache = kvc.alloc(kvc.CacheConfig(num_layers=2, num_slots=1, max_seq_len=128, num_kv_heads=cfg2.num_kv_heads,
                                          head_dim=cfg2.hd, dtype="float32"), device)
        kvc.insert_sequence(cache, 0, ks[:, 0], vs[:, 0], 64)
        logits = sver._forward_block_slots(params, cache, blk, cfg2)
        return [logits.cpu(), cache["k"].cpu(), cache["v"].cpu()]

    verify_errs = {}
    for layout in ("paged", "slots"):
        verify_errs[layout], scale = whole_path(f"spec verify {layout}", partial(run_verify, layout=layout), 2,
                                                2 if layout == "paged" else 0)
        print(f"phase 5 spec verify {layout} (2 layers, f32, a {SPEC_K + 1}-token block over the 64-token prompt, "
              f"card vs host): |dlogits| {verify_errs[layout][0]:.3g}, block K/V max |d| "
              f"{max(verify_errs[layout][1:]):.3g} (max |value| {scale:.3g}, tol {WHOLE_PATH_TOL})")
    spec_prompts = [rng.integers(1, cfg2.vocab_size, size=n).tolist() for n in (40, 64, 100)]
    for layout in ("paged", "slots"):
        kw5 = dict(max_num_seqs=4, max_seq_len=256, kv_layout=layout, page_size=64)
        plain = [o.token_ids for o in LLMEngine(cfg2, p_gpu, **kw5).generate(spec_prompts, SamplingParams(max_tokens=16))]
        for drafter, spec in (("ngram", SpecConfig(drafter="ngram", k=SPEC_K)),
                              ("self-drafting model", SpecConfig(drafter="model", k=SPEC_K, draft_config=cfg2,
                                                                 draft_params=p_gpu))):
            eng = LLMEngine(cfg2, p_gpu, speculative=spec, **kw5)
            got = [o.token_ids for o in eng.generate(spec_prompts, SamplingParams(max_tokens=16))]
            st = eng.spec_stats()
            equal = sum(a == b for a, b in zip(got, plain))
            check(equal == len(plain), f"phase 5 spec {layout} {drafter}: greedy streams equal the plain engine's in "
                  f"{equal} of {len(plain)}")
            if drafter != "ngram":
                check(st["acceptance_rate"] > 0.8, f"phase 5 spec {layout} {drafter}: acceptance {st['acceptance_rate']}")
            print(f"phase 5 spec engine {layout} {drafter} (2 layers, f32, on the card): greedy streams equal the plain "
                  f"engine's in {equal} of {len(plain)}; acceptance {st['acceptance_rate']:.4f}, "
                  f"{st['mean_tokens_per_round']:.3f} tokens per lane-round over {st['rounds']} rounds")
            del eng
    cases = exact_handoffs(torch, cfg2, dev)
    print(f"phase 5 handoff extract -> scatter-in -> extract (2 layers, 8 kv heads, head_dim 128, a 128 bucket, card vs "
          f"host): bit-identical in {len(cases)} of {len(cases)} cases {cases}; same-dtype round trips return the block")
    cases = migrated_streams_on_card(torch, cfg2, p_gpu, np.random.default_rng(10))
    print(f"phase 5 migration on the card (2 layers, f32, checkpoint at 6 of 16 tokens, wire codec, restore on a "
          f"second engine): spliced streams equal the uninterrupted ones in {len(cases)} of {len(cases)} cases {cases}")
    del p_gpu, p_cpu

    mark("5")
    # ---------------------------------------------------------------- 6
    k23_rows = []
    for B, H_, HKV_, T, D_, dname, causal in K23_SHAPES:
        dt = torch.bfloat16 if dname == "bf16" else torch.float32
        q, dout = (torch.randn((B, H_, T, D_), generator=g, device=dev).to(dt) for _ in range(2))
        k, v = (torch.randn((B, HKV_, T, D_), generator=g, device=dev).to(dt) for _ in range(2))
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        delta = (dout.float() * o.float()).sum(-1)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=causal)
        torch.cuda.synchronize()

        def plain():
            dq_r, dk_r, dv_r = attention_bwd_ref(q, k, v, o, lse, dout, causal=causal)
            return dq_r.to(dt), fa._sum_rep(dk_r, HKV_).to(dt), fa._sum_rep(dv_r, HKV_).to(dt)

        errs = {}
        for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), plain()):
            diff = (out.float() - ref.float()).abs().max().item()
            errs[name] = (diff, diff / ref.float().abs().max().item())
        del ref
        bad = {n: e for n, e in errs.items() if not e[1] <= K23_TOL[dname]}
        shape = (B, H_, HKV_, T, D_, dname, "causal" if causal else "full")
        check(not bad, f"K2/K3 {shape}: relative errors {bad} (tol {K23_TOL[dname]})")
        row = dict(shape=shape, errs=errs)
        if dname == "bf16":
            row["dq_ms"] = cuda_ms(torch, lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=causal))
            row["dkv_ms"] = cuda_ms(torch, lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=causal))
            row["plain_ms"] = cuda_ms(torch, plain, iters=2, warmup=1)
            qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))

            def sdpa_fwd():
                return F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=True)

            fwd_ms = cuda_ms(torch, sdpa_fwd, iters=10)
            fb_ms = cuda_ms(torch, lambda: sdpa_fwd().backward(dout), iters=10)
            row["sdpa_bwd_ms"] = fb_ms - fwd_ms
            for kern, (bound_ms, bound_by, flops) in k23_bound(B, H_, HKV_, T, D_, causal, q.element_size()).items():
                row[f"{kern}_bound_ms"], row[f"{kern}_bound_by"] = bound_ms, bound_by
                row[f"{kern}_tflops"] = flops / (row[f"{kern}_ms"] * 1e-3) / 1e12
            print(f"phase 6 K2/K3 {row['shape']}: rel err dq {errs['dq'][1]:.3g} dk {errs['dk'][1]:.3g} dv "
                  f"{errs['dv'][1]:.3g}; K2 {row['dq_ms']:.4f} ms ({row['dq_tflops']:.2f} TFLOP/s, "
                  f"{row['dq_tflops'] * 1e12 / BF16_FLOPS:.4f} of the bf16 peak, bound {row['dq_bound_ms']:.4f} ms "
                  f"{row['dq_bound_by']}), K3 {row['dkv_ms']:.4f} ms ({row['dkv_tflops']:.2f} TFLOP/s, "
                  f"{row['dkv_tflops'] * 1e12 / BF16_FLOPS:.4f} of the bf16 peak, bound {row['dkv_bound_ms']:.4f} ms "
                  f"{row['dkv_bound_by']}), plain {row['plain_ms']:.4f} ms, sdpa backward {row['sdpa_bwd_ms']:.4f} ms, "
                  f"(K2 + K3) / sdpa backward {(row['dq_ms'] + row['dkv_ms']) / row['sdpa_bwd_ms']:.2f} {card}")
            del qs, ks, vs
        else:
            print(f"phase 6 K2/K3 {row['shape']}: rel err dq {errs['dq'][1]:.3g} dk {errs['dk'][1]:.3g} "
                  f"dv {errs['dv'][1]:.3g}")
        k23_rows.append(row)
        del q, k, v, dout, o, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()

    rms_norm_fused.launches = 0
    k5_inputs = []
    for rows, d in K5_SHAPES:
        for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            x = (torch.randn((rows, d), generator=g, device=dev) * 3).to(dt)
            w = torch.randn((d,), generator=g, device=dev).to(dt)
            k5_inputs.append((rows, d, dname, x, w, rms_norm_fused(x, w, 1e-5)))
    torch.cuda.synchronize()
    k5_launches = rms_norm_fused.launches
    check(k5_launches == len(k5_inputs), f"K5 launches {k5_launches} != {len(k5_inputs)}")
    k5_rows = []
    for rows, d, dname, x, w, out in k5_inputs:
        ref = rms_norm(x, w, 1e-5)
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        check(rel <= K5_TOL[dname], f"K5 [{rows}, {d}] {dname}: relative error {rel:.3g} (tol {K5_TOL[dname]})")
        call = partial(rms_norm_fused, x, w, 1e-5)
        lib = partial(F.rms_norm, x, (d,), w, 1e-5)
        ms, lib_ms = cuda_ms_turns(torch, [call, lib])
        plain_ms = cuda_ms(torch, lambda: rms_norm(x, w, 1e-5))
        nbytes = 2.0 * x.numel() * x.element_size() + w.numel() * w.element_size()
        row = dict(rows=rows, d=d, dtype=dname, err=err, rel=rel, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                   device_ms=device_ms(torch, call, K5_KERNELS), host_us=host_us(torch, call),
                   lib_host_us=host_us(torch, lib), bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        k5_rows.append(row)
        print(f"phase 6 K5 [{rows}, {d}] {dname}: |d| {err:.3g} (rel {rel:.3g}) kernel {ms:.4f} ms (device "
              f"{row['device_ms']:.4f} ms, host {row['host_us']:.2f} us a call), plain {plain_ms:.4f} ms, F.rms_norm "
              f"{lib_ms:.4f} ms (host {row['lib_host_us']:.2f} us a call), bound {row['bound_ms']:.4f} ms (bytes), "
              f"bound / kernel {row['bound_ms'] / ms:.3f}, kernel / F.rms_norm {ms / lib_ms:.3f} {card}")
    del k5_inputs
    torch.cuda.empty_cache()

    mark("6")
    # ---------------------------------------------------------------- 7
    cfg7 = LlamaConfig(vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_layers=18, num_heads=16,
                       num_kv_heads=8, max_seq_len=2048)
    Bt, Tt = 8, 2048
    init_fn, step_fn = make_train_step(partial(loss_fn, config=cfg7), adamw(3e-4, weight_decay=0.01))
    t0 = time.perf_counter()
    state = init_fn(0, partial(init_params, cfg7))
    trng = np.random.default_rng(0)
    data = {"tokens": trng.integers(0, cfg7.vocab_size, (Bt, Tt)).astype(np.int32),
            "targets": trng.integers(0, cfg7.vocab_size, (Bt, Tt)).astype(np.int32)}
    batch = to_device(data)
    with torch.no_grad():
        ref_loss = loss_fn(state.params, batch, cfg7).item()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = flash_attention_bwd_dq.launches = flash_attention_bwd_dkv.launches = 0
    state, metrics = step_fn(state, batch)
    first_loss = metrics["loss"].item()
    check(abs(first_loss - ref_loss) < TRAIN_LOSS_TOL,
          f"training: first step loss {first_loss} != loss_fn on the initial params {ref_loss}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = step_fn(state, batch)
    last_loss = metrics["loss"].item()  # depends on every timed step: waits for all of them
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    n_steps = TRAIN_STEPS + 1
    train_launches = (flash_attention_fwd.launches, flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    L = cfg7.num_layers
    check(train_launches == (2 * L * n_steps, L * n_steps, L * n_steps),
          f"training: launches K1/K2/K3 {train_launches} != {(2 * L * n_steps, L * n_steps, L * n_steps)}")
    check(np.isfinite(last_loss) and last_loss < first_loss,
          f"training: loss {first_loss} -> {last_loss} is not finite and falling")
    peak = torch.cuda.max_memory_allocated()
    tok_s = Bt * Tt / step_s
    mfu = flops_per_token(cfg7, Tt) * tok_s / BF16_FLOPS
    print(f"phase 7 training sft (18 layers, hidden 2048, 16/8 heads, bf16, remat, AdamW) batch {Bt} x {Tt}: "
          f"init {init_s:.2f} s, loss {ref_loss:.4f} (loss_fn) / {first_loss:.4f} (step 1) -> {last_loss:.4f} "
          f"(step {n_steps}), {step_s * 1e3:.2f} ms/step over {TRAIN_STEPS} steps, {tok_s:.1f} tok/s, MFU "
          f"{mfu:.4f} (flops_per_token x tok/s / 989 TFLOP/s), peak memory {peak} bytes, launches per step K1 "
          f"{train_launches[0] // n_steps} K2 {train_launches[1] // n_steps} K3 {train_launches[2] // n_steps} {card}")
    profiled = profile_step(torch, step_fn, state, batch, card, _kernels.BUILD_DIR / "train_step_profile.txt")
    check(profiled == {K1_WGMMA: 2 * L, K2_WGMMA: L, K3_WGMMA: L},
          f"profile: the wgmma kernels ran {profiled} times in the step, not {2 * L}, {L} and {L}")
    del state, batch, metrics
    torch.cuda.empty_cache()

    mark("7")
    # ---------------------------------------------------------------- 7b
    # a user's training job: JaxTrainer -> a GPU train worker running phase 7's step from a dataset
    trn = train_on_card(torch, cfg7, data, first_loss, step_s, card)
    torch.cuda.empty_cache()

    mark("7b")
    # ---------------------------------------------------------------- 7c
    # Tune over the trainers (a Tuner over JaxTrainer under ASHA, a GPU trial actor and Tuner.restore), an ActorPool
    tun = tune_on_card(torch, cfg7, data, first_loss, step_s, trn["A"]["losses"], cfg, prompts, gr, drv_checksum, card)
    torch.cuda.empty_cache()

    mark("7c")
    # ---------------------------------------------------------------- 7d
    # compiled graphs over a GPU engine actor, hop latency, teardown; device objects across processes
    dag = dag_on_card(torch, cfg, prompts, gr, drv_checksum, card)
    torch.cuda.empty_cache()

    mark("7d")
    # ---------------------------------------------------------------- 7e
    # phase 7's step under each remat policy: ms/step, MFU, peak memory, launches
    rem = remat_on_card(torch, cfg7, data, card)
    torch.cuda.empty_cache()

    mark("7e")
    # ---------------------------------------------------------------- 8
    # RLlib: the learners' updates card vs host, two learner actors' allreduce (and the env legs with gymnasium)
    rllib_on_card(torch, card)
    torch.cuda.empty_cache()

    mark("8")
    # ---------------------------------------------------------------- 9
    cfg8 = dataclasses.replace(cfg7, num_layers=2, dtype="float32")
    p0 = init_params(cfg8, torch.Generator(device=dev).manual_seed(2))
    data8 = {"tokens": trng.integers(0, cfg8.vocab_size, (1, 128)).astype(np.int32),
             "targets": trng.integers(0, cfg8.vocab_size, (1, 128)).astype(np.int32)}

    def train(device):
        init8, step8 = make_train_step(partial(loss_fn, config=cfg8), adamw(3e-4, weight_decay=0.01), device=device)
        st = init8(0, lambda _: {k: ({n: w.clone() for n, w in v.items()} if isinstance(v, dict) else v.clone())
                                 for k, v in p0.items()})
        b8 = to_device(data8, device)
        out = []
        for i in range(2):
            st, m = step8(st, b8)
            grads = [p.grad.cpu() for p in tree_leaves(st.params)] if i == 0 else None
            out.append((m["loss"].item(), m["grad_norm"].item(), grads))
        return out

    flash_attention_fwd.launches = flash_attention_bwd_dq.launches = flash_attention_bwd_dkv.launches = 0
    on_card = train(dev)
    check((flash_attention_fwd.launches, flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == (8, 4, 4),
          "training whole path: the card run did not go through K1, K2 and K3")
    on_host = train(torch.device("cpu"))
    step_errs = [max(abs(c[0] - h[0]) / abs(h[0]), abs(c[1] - h[1]) / abs(h[1])) for c, h in zip(on_card, on_host)]
    grad_err = max((c - h).abs().max().item() / max(h.abs().max().item(), 1e-30)
                   for c, h in zip(on_card[0][2], on_host[0][2]))
    check(max(step_errs) <= TRAIN_WHOLE_TOL and grad_err <= TRAIN_WHOLE_TOL,
          f"training whole path: loss/grad-norm relative errors {step_errs}, gradients {grad_err:.3g} "
          f"(tol {TRAIN_WHOLE_TOL})")
    print(f"phase 9 training whole path (2 layers, f32, 1 x 128, card vs host): losses {[c[0] for c in on_card]} vs "
          f"{[h[0] for h in on_host]}, loss/grad-norm relative error {max(step_errs):.3g}, first-step gradients "
          f"{grad_err:.3g} of each leaf's max (tol {TRAIN_WHOLE_TOL})")

    rep1 = next(r for r in k1_rows if (r["B"], r["T"]) == (2, 2048))
    rep4 = next(r for r in k4_rows if (r["pool"], r["T"], r["B"]) == ("bf16", 1, Bl))
    rep4q = next(r for r in k4_rows if (r["pool"], r["T"], r["B"]) == ("int8", 1, Bl))
    rep4v = next(r for r in k4_rows if (r["pool"], r["T"], r["B"]) == ("bf16", SPEC_K + 1, Bl))  # the verify's shape
    rep4x = next(r for r in k4_rows if r.get("extend") and (r["pool"], r["T"]) == ("bf16", 512))  # a remote hit's extend
    rep23 = k23_rows[0]  # the sft training shape
    rep5 = k5_rows[0]  # the training rows, bf16
    kernels = [
        dict(name="K1 flash_attention_fwd", route="cuda", source="ray_tpu_torch/csrc/flash_attention.cu",
             replaces="ray_tpu/ops/flash_attention.py:104", launches=k1_launches,
             max_abs_err=k1_err, ms=rep1["ms"], plain_ms=rep1["plain_ms"],
             bound_ms=rep1["bound_ms"], bound_by=rep1["bound_by"], library_ms=rep1["sdpa_ms"]),
        dict(name="K2 flash_attention_bwd_dq", route="cuda", source="ray_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:154", launches=train_launches[1],
             max_abs_err=max(r["errs"]["dq"][0] for r in k23_rows), ms=rep23["dq_ms"], plain_ms=rep23["plain_ms"],
             bound_ms=rep23["dq_bound_ms"], bound_by=rep23["dq_bound_by"], library_ms=rep23["sdpa_bwd_ms"]),
        dict(name="K3 flash_attention_bwd_dkv", route="cuda", source="ray_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:192", launches=train_launches[2],
             max_abs_err=max(max(r["errs"]["dk"][0], r["errs"]["dv"][0]) for r in k23_rows), ms=rep23["dkv_ms"],
             plain_ms=rep23["plain_ms"], bound_ms=rep23["dkv_bound_ms"], bound_by=rep23["dkv_bound_by"],
             library_ms=rep23["sdpa_bwd_ms"]),
        dict(name="K4 paged_attn_partials", route="cuda", source="ray_tpu_torch/csrc/paged_attn.cu",
             replaces="ray_tpu/llm/pallas/paged_attn.py:134", launches=k4_launches,
             max_abs_err=max(r["err"] for r in k4_rows), ms=rep4["ms"], plain_ms=rep4["plain_ms"],
             bound_ms=rep4["bound_ms"], bound_by=rep4["bound_by"], library_ms=None,
             device_ms=rep4["device_ms"], host_us=rep4["host_us"]),
        dict(name="K4 paged_attn_partials int8 pool", route="cuda", source="ray_tpu_torch/csrc/paged_attn.cu",
             replaces="ray_tpu/llm/pallas/paged_attn.py:134", launches=k4_int8_launches,
             max_abs_err=max(r["err"] for r in k4_rows if r["pool"] == "int8"), ms=rep4q["ms"],
             plain_ms=rep4q["plain_ms"], bound_ms=rep4q["bound_ms"], bound_by=rep4q["bound_by"], library_ms=None,
             device_ms=rep4q["device_ms"], host_us=rep4q["host_us"]),
        *(dict(name=f"K4 paged_attn_partials extend T={r['T']} R={REP * r['T']} {r['pool']}", route="cuda",
               source="ray_tpu_torch/csrc/paged_attn.cu", replaces="ray_tpu/llm/pallas/paged_attn.py:134",
               launches=k4_4b, max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
               bound_by=r["bound_by"], library_ms=None, device_ms=r["device_ms"], host_us=r["host_us"])
          for r in k4_rows if r.get("extend")),
        dict(name=f"K4 paged_attn_partials spec verify T={SPEC_K + 1} R={REP * (SPEC_K + 1)} bf16", route="cuda",
             source="ray_tpu_torch/csrc/paged_attn.cu", replaces="ray_tpu/llm/pallas/paged_attn.py:134",
             launches=k4_spec_launches, max_abs_err=rep4v["err"], ms=rep4v["ms"], plain_ms=rep4v["plain_ms"],
             bound_ms=rep4v["bound_ms"], bound_by=rep4v["bound_by"], library_ms=None, device_ms=rep4v["device_ms"],
             host_us=rep4v["host_us"]),
        dict(name="K1 flash_attention_fwd prefill-only handoff engine", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention.cu", replaces="ray_tpu/ops/flash_attention.py:104",
             launches=k1_4e, max_abs_err=k1_err, ms=rep1["ms"], plain_ms=rep1["plain_ms"], bound_ms=rep1["bound_ms"],
             bound_by=rep1["bound_by"], library_ms=rep1["sdpa_ms"]),
        dict(name="K4 paged_attn_partials handoff-fed decode", route="cuda", source="ray_tpu_torch/csrc/paged_attn.cu",
             replaces="ray_tpu/llm/pallas/paged_attn.py:134", launches=k4_4e,
             max_abs_err=max(r["err"] for r in k4_rows), ms=rep4["ms"], plain_ms=rep4["plain_ms"],
             bound_ms=rep4["bound_ms"], bound_by=rep4["bound_by"], library_ms=None, device_ms=rep4["device_ms"],
             host_us=rep4["host_us"]),
        dict(name="K1 flash_attention_fwd router prefill", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention.cu", replaces="ray_tpu/ops/flash_attention.py:104",
             launches=k1_4f, max_abs_err=k1_err, ms=rep1["ms"], plain_ms=rep1["plain_ms"], bound_ms=rep1["bound_ms"],
             bound_by=rep1["bound_by"], library_ms=rep1["sdpa_ms"]),
        dict(name="K4 paged_attn_partials router decode", route="cuda", source="ray_tpu_torch/csrc/paged_attn.cu",
             replaces="ray_tpu/llm/pallas/paged_attn.py:134", launches=k4_4f,
             max_abs_err=max(r["err"] for r in k4_rows), ms=rep4["ms"], plain_ms=rep4["plain_ms"],
             bound_ms=rep4["bound_ms"], bound_by=rep4["bound_by"], library_ms=None, device_ms=rep4["device_ms"],
             host_us=rep4["host_us"]),
        dict(name="K1 flash_attention_fwd object plane (phase 4g: the handoff prefills, the source and the KV-plane "
                  "leaders, the chaos leg's local prefill)", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention.cu", replaces="ray_tpu/ops/flash_attention.py:104",
             launches=objp["k1"], max_abs_err=k1_err, ms=rep1["ms"], plain_ms=rep1["plain_ms"],
             bound_ms=rep1["bound_ms"], bound_by=rep1["bound_by"], library_ms=rep1["sdpa_ms"]),
        dict(name="K4 paged_attn_partials borrower decode (phase 4g, the spawned process)", route="cuda",
             source="ray_tpu_torch/csrc/paged_attn.cu", replaces="ray_tpu/llm/pallas/paged_attn.py:134",
             launches=objp["k4_borrower"], max_abs_err=max(r["err"] for r in k4_rows), ms=rep4["ms"],
             plain_ms=rep4["plain_ms"], bound_ms=rep4["bound_ms"], bound_by=rep4["bound_by"], library_ms=None,
             device_ms=rep4["device_ms"], host_us=rep4["host_us"]),
        dict(name="K4 paged_attn_partials remote-hit extends and decode (phase 4g, bf16 and int8 pairs)",
             route="cuda", source="ray_tpu_torch/csrc/paged_attn.cu", replaces="ray_tpu/llm/pallas/paged_attn.py:134",
             launches=objp["k4_remote"], max_abs_err=rep4x["err"], ms=rep4x["ms"], plain_ms=rep4x["plain_ms"],
             bound_ms=rep4x["bound_ms"], bound_by=rep4x["bound_by"], library_ms=None, device_ms=rep4x["device_ms"],
             host_us=rep4x["host_us"]),
        dict(name=f"K1 flash_attention_fwd GPU actor prefill (phase 4h, the actor's worker process; held and timed "
                  f"there at its largest prefill {rtc['k1_check']['shape']})", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention.cu", replaces="ray_tpu/ops/flash_attention.py:104",
             launches=rtc["k1_actor"], max_abs_err=rtc["k1_check"]["err_o"], ms=rtc["k1_check"]["ms"],
             plain_ms=rtc["k1_check"]["plain_ms"], bound_ms=rtc["k1_check"]["bound_ms"],
             bound_by=rtc["k1_check"]["bound_by"], library_ms=rtc["k1_check"]["sdpa_ms"]),
        dict(name=f"K4 paged_attn_partials GPU actor decode (phase 4h, the actor's worker process; held and timed "
                  f"there at its first decode step {rtc['k4_check']['shape']})", route="cuda",
             source="ray_tpu_torch/csrc/paged_attn.cu", replaces="ray_tpu/llm/pallas/paged_attn.py:134",
             launches=rtc["k4_actor"], max_abs_err=rtc["k4_check"]["err"], ms=rtc["k4_check"]["ms"],
             plain_ms=rtc["k4_check"]["plain_ms"], bound_ms=rtc["k4_check"]["bound_ms"],
             bound_by=rtc["k4_check"]["bound_by"], library_ms=None),
        dict(name="K1 flash_attention_fwd GPU task (phase 4h, B=2 T=2048 32/8 heads in the task's worker)",
             route="cuda", source="ray_tpu_torch/csrc/flash_attention.cu", replaces="ray_tpu/ops/flash_attention.py:104",
             launches=rtc["task"]["launches"], max_abs_err=max(rtc["task"]["err_o"], rtc["task"]["err_lse"]),
             ms=rtc["task"]["ms"], plain_ms=rtc["task"]["plain_ms"], bound_ms=k1_bound(2, 32, 8, 2048, 128)[0],
             bound_by=k1_bound(2, 32, 8, 2048, 128)[1], library_ms=rtc["task"]["sdpa_ms"]),
        dict(name=f"K1 flash_attention_fwd serve GPU replica prefill (phase 4i (a), the replica's worker; held and "
                  f"timed there at its largest prefill {svc['a']['check']['k1']['shape']})", route="cuda",
             source="ray_tpu_torch/csrc/flash_attention.cu", replaces="ray_tpu/ops/flash_attention.py:104",
             launches=svc["a"]["counts"]["k1"], max_abs_err=svc["a"]["check"]["k1"]["err_o"],
             ms=svc["a"]["check"]["k1"]["ms"], plain_ms=svc["a"]["check"]["k1"]["plain_ms"],
             bound_ms=svc["a"]["check"]["k1"]["bound_ms"], bound_by=svc["a"]["check"]["k1"]["bound_by"],
             library_ms=svc["a"]["check"]["k1"]["sdpa_ms"]),
        dict(name=f"K4 paged_attn_partials serve GPU replica decode (phase 4i (a), the replica's worker; held and "
                  f"timed there at its first decode step {svc['a']['check']['k4']['shape']})", route="cuda",
             source="ray_tpu_torch/csrc/paged_attn.cu", replaces="ray_tpu/llm/pallas/paged_attn.py:134",
             launches=svc["a"]["counts"]["k4"], max_abs_err=svc["a"]["check"]["k4"]["err"],
             ms=svc["a"]["check"]["k4"]["ms"], plain_ms=svc["a"]["check"]["k4"]["plain_ms"],
             bound_ms=svc["a"]["check"]["k4"]["bound_ms"], bound_by=svc["a"]["check"]["k4"]["bound_by"],
             library_ms=None),
        *(dict(name=f"K{k} {fn} serve {what} (phase 4i {leg}; held and timed in (a)'s replica)", route="cuda",
               source=f"ray_tpu_torch/csrc/{src}", replaces=rep, launches=launches,
               max_abs_err=svc["a"]["check"][f"k{k}"]["err_o" if k == 1 else "err"],
               ms=svc["a"]["check"][f"k{k}"]["ms"], plain_ms=svc["a"]["check"][f"k{k}"]["plain_ms"],
               bound_ms=svc["a"]["check"][f"k{k}"]["bound_ms"], bound_by=svc["a"]["check"][f"k{k}"]["bound_by"],
               library_ms=svc["a"]["check"]["k1"]["sdpa_ms"] if k == 1 else None)
          for k, fn, src, rep, what, leg, launches in (
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104",
               "OpenAI replica prefill", "(b), the unary and the streamed request", svc["b"]["counts"]["k1"]),
              (4, "paged_attn_partials", "paged_attn.cu", "ray_tpu/llm/pallas/paged_attn.py:134",
               "OpenAI replica decode", "(b), the unary and the streamed request", svc["b"]["counts"]["k4"]),
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104",
               "disagg prefill replica", "(c), the prefill replica's worker", svc["c"]["prefill"]["k1"]),
              (4, "paged_attn_partials", "paged_attn.cu", "ray_tpu/llm/pallas/paged_attn.py:134",
               "disagg decode replica", "(c), the decode replica's worker", svc["c"]["decode"]["k4"]),
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104",
               "kvplane replicas prefill", "(d), both replicas' workers", sum(c["k1"] for c in svc["d"]["counts"])),
              (4, "paged_attn_partials", "paged_attn.cu", "ray_tpu/llm/pallas/paged_attn.py:134",
               "kvplane replicas decode", "(d), both replicas' workers",
               cfg.num_layers * sum(c["decode_steps"] for c in svc["d"]["counts"])))),
        dict(name=f"K4 paged_attn_partials serve kvplane replicas extends (phase 4i (d), both replicas' workers; held "
                  f"and timed in the extending replica's worker at its extend {svc['d']['extend_check']['shape']})",
             route="cuda", source="ray_tpu_torch/csrc/paged_attn.cu", replaces="ray_tpu/llm/pallas/paged_attn.py:134",
             launches=cfg.num_layers * sum(c["extend_forwards"] for c in svc["d"]["counts"]),
             max_abs_err=svc["d"]["extend_check"]["err"], ms=svc["d"]["extend_check"]["ms"],
             plain_ms=svc["d"]["extend_check"]["plain_ms"], bound_ms=svc["d"]["extend_check"]["bound_ms"],
             bound_by=svc["d"]["extend_check"]["bound_by"], library_ms=None),
        *(dict(name=f"K{k} {fn} data actor {what} (phase 4j {leg}; held and timed in (a)'s worker at "
                    f"{dat['a']['reports'][0]['check'][f'k{k}']['shape']})", route="cuda",
               source=f"ray_tpu_torch/csrc/{src}", replaces=rep, launches=dat[leg][f"k{k}"],
               max_abs_err=dat["a"]["reports"][0]["check"][f"k{k}"]["err_o" if k == 1 else "err"],
               ms=dat["a"]["reports"][0]["check"][f"k{k}"]["ms"],
               plain_ms=dat["a"]["reports"][0]["check"][f"k{k}"]["plain_ms"],
               bound_ms=dat["a"]["reports"][0]["check"][f"k{k}"]["bound_ms"],
               bound_by=dat["a"]["reports"][0]["check"][f"k{k}"]["bound_by"],
               library_ms=dat["a"]["reports"][0]["check"]["k1"]["sdpa_ms"] if k == 1 else None)
          for k, fn, src, rep, what, leg in (
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104", "prefill",
               "a"),
              (4, "paged_attn_partials", "paged_attn.cu", "ray_tpu/llm/pallas/paged_attn.py:134", "decode", "a"),
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104",
               "prefill, two actors", "b"),
              (4, "paged_attn_partials", "paged_attn.cu", "ray_tpu/llm/pallas/paged_attn.py:134",
               "decode, two actors", "b"))),
        *(dict(name=f"K{k} {fn} {who} (phase 4k {leg}; held and timed in (a)'s worker on the agent's node at "
                    f"{agt['a']['check'][f'k{k}']['shape']})", route="cuda", source=f"ray_tpu_torch/csrc/{src}",
               replaces=rep, launches=launches, max_abs_err=agt["a"]["check"][f"k{k}"]["err_o" if k == 1 else "err"],
               ms=agt["a"]["check"][f"k{k}"]["ms"], plain_ms=agt["a"]["check"][f"k{k}"]["plain_ms"],
               bound_ms=agt["a"]["check"][f"k{k}"]["bound_ms"], bound_by=agt["a"]["check"][f"k{k}"]["bound_by"],
               library_ms=agt["a"]["check"]["k1"]["sdpa_ms"] if k == 1 else None)
          for k, fn, src, rep in (
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104"),
              (4, "paged_attn_partials", "paged_attn.cu", "ray_tpu/llm/pallas/paged_attn.py:134"))
          for who, leg, launches in (
              ("GPU actor on an agent's node, the driver's, the attached driver's and the job's generate", "(a), (b)",
               sum(agt[x][f"k{k}"] for x in ("a", "driver", "job"))),
              ("detached actor re-created by a restarted head", "(d)", agt["d"][f"k{k}"]))),
        *(dict(name=f"K{k} {fn} train worker (phase 7b, fits A and B in the GPU train worker; held and timed there "
                    f"at {trn['A']['hold'][hk]['shape']} bf16 causal)", route="cuda",
               source=f"ray_tpu_torch/csrc/{src}", replaces=rep, launches=trn["launches"][k - 1], max_abs_err=err,
               ms=trn["A"]["hold"][hk][ms], plain_ms=trn["A"]["hold"][hk]["plain_ms"],
               bound_ms=trn["A"]["hold"][hk][f"{b}bound_ms"], bound_by=trn["A"]["hold"][hk][f"{b}bound_by"],
               library_ms=trn["A"]["hold"][hk][lib])
          for k, fn, src, rep, hk, ms, b, lib, err in (
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104", "k1", "ms", "",
               "sdpa_ms", trn["A"]["hold"]["k1"]["err_o"]),
              (2, "flash_attention_bwd_dq", "flash_attention_bwd.cu", "ray_tpu/ops/flash_attention.py:154", "k23",
               "dq_ms", "dq_", "sdpa_bwd_ms", trn["A"]["hold"]["k23"]["errs"]["dq"][0]),
              (3, "flash_attention_bwd_dkv", "flash_attention_bwd.cu", "ray_tpu/ops/flash_attention.py:192", "k23",
               "dkv_ms", "dkv_", "sdpa_bwd_ms", max(trn["A"]["hold"]["k23"]["errs"]["dk"][0],
                                                  trn["A"]["hold"]["k23"]["errs"]["dv"][0])))),
        *(dict(name=f"K{k} {fn} tune trials (phase 7c (a)'s GPU train workers and (b)'s GPU trial actor, every "
                    f"step they ran; held and timed in phase 7b's train worker at {trn['A']['hold'][hk]['shape']} bf16 causal)",
               route="cuda", source=f"ray_tpu_torch/csrc/{src}", replaces=rep, launches=tun["launches"][k - 1],
               max_abs_err=err, ms=trn["A"]["hold"][hk][ms], plain_ms=trn["A"]["hold"][hk]["plain_ms"],
               bound_ms=trn["A"]["hold"][hk][f"{b}bound_ms"], bound_by=trn["A"]["hold"][hk][f"{b}bound_by"],
               library_ms=trn["A"]["hold"][hk][lib])
          for k, fn, src, rep, hk, ms, b, lib, err in (
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104", "k1", "ms", "",
               "sdpa_ms", trn["A"]["hold"]["k1"]["err_o"]),
              (2, "flash_attention_bwd_dq", "flash_attention_bwd.cu", "ray_tpu/ops/flash_attention.py:154", "k23",
               "dq_ms", "dq_", "sdpa_bwd_ms", trn["A"]["hold"]["k23"]["errs"]["dq"][0]),
              (3, "flash_attention_bwd_dkv", "flash_attention_bwd.cu", "ray_tpu/ops/flash_attention.py:192", "k23",
               "dkv_ms", "dkv_", "sdpa_bwd_ms", max(trn["A"]["hold"]["k23"]["errs"]["dk"][0],
                                                  trn["A"]["hold"]["k23"]["errs"]["dv"][0])))),
        *(dict(name=f"K{k} {fn} ActorPool engine actors {what} (phase 7c (c), both actors' workers, one prompt a "
                    f"call; held in the first at each prompt's shape {tun['c']['held'][f'k{k}']['shapes']}, timed at "
                    f"the longest prompt's {tun['c']['held'][f'k{k}']['shape']})", route="cuda",
               source=f"ray_tpu_torch/csrc/{src}", replaces=rep, launches=tun["c"][f"k{k}"],
               max_abs_err=tun["c"]["held"][f"k{k}"]["err_o" if k == 1 else "err"],
               ms=tun["c"]["held"][f"k{k}"]["ms"], plain_ms=tun["c"]["held"][f"k{k}"]["plain_ms"],
               bound_ms=tun["c"]["held"][f"k{k}"]["bound_ms"], bound_by=tun["c"]["held"][f"k{k}"]["bound_by"],
               library_ms=tun["c"]["held"]["k1"]["sdpa_ms"] if k == 1 else None)
          for k, fn, src, rep, what in (
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104", "prefill"),
              (4, "paged_attn_partials", "paged_attn.cu", "ray_tpu/llm/pallas/paged_attn.py:134", "decode"))),
        *(dict(name=f"K{k} {fn} runtime_env GPU actor {what} (phase 4l, the actor's worker, {envc['generates']} "
                    f"generates; held and timed there at {envc['check'][f'k{k}']['shape']})", route="cuda",
               source=f"ray_tpu_torch/csrc/{src}", replaces=rep, launches=envc[f"k{k}"],
               max_abs_err=envc["check"][f"k{k}"]["err_o" if k == 1 else "err"], ms=envc["check"][f"k{k}"]["ms"],
               plain_ms=envc["check"][f"k{k}"]["plain_ms"], bound_ms=envc["check"][f"k{k}"]["bound_ms"],
               bound_by=envc["check"][f"k{k}"]["bound_by"],
               library_ms=envc["check"]["k1"]["sdpa_ms"] if k == 1 else None)
          for k, fn, src, rep, what in (
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104", "prefill"),
              (4, "paged_attn_partials", "paged_attn.cu", "ray_tpu/llm/pallas/paged_attn.py:134", "decode"))),
        *(dict(name=f"K{k} {fn} {who} (phase 4m {leg}, the actor's worker on the autoscaled GPU node; held and "
                    f"timed there at {tool['check'][f'k{k}']['shape']})", route="cuda", source=f"ray_tpu_torch/csrc/{src}",
               replaces=rep, launches=launches, max_abs_err=tool["check"][f"k{k}"]["err_o" if k == 1 else "err"],
               ms=tool["check"][f"k{k}"]["ms"], plain_ms=tool["check"][f"k{k}"]["plain_ms"],
               bound_ms=tool["check"][f"k{k}"]["bound_ms"], bound_by=tool["check"][f"k{k}"]["bound_by"],
               library_ms=tool["check"]["k1"]["sdpa_ms"] if k == 1 else None)
          for k, fn, src, rep in (
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104"),
              (4, "paged_attn_partials", "paged_attn.cu", "ray_tpu/llm/pallas/paged_attn.py:134"))
          for who, leg, launches in (
              ("C++ driver's CALL of generate", "(a)", tool["a"][f"k{k}"]),
              (f"GPU actor's {tool['c']['generates']} generates from Python", "(c), (d)", tool["c"][f"k{k}"]))),
        *(dict(name=f"K{k} {fn} tensor-parallel ranks {what} (phase 4n (a), (b), (d): both ranks of every tp=2 "
                    f"engine, {tpn['held'][f'k{k}']['launch_note']}; held and timed in rank 1's process at its shape "
                    f"{tpn['held'][f'k{k}']['shape']})", route="cuda", source=f"ray_tpu_torch/csrc/{src}",
               replaces=rep, launches=tpn["launches"][f"k{k}"],
               max_abs_err=tpn["held"][f"k{k}"]["err_o" if k == 1 else "err"], ms=tpn["held"][f"k{k}"]["ms"],
               plain_ms=tpn["held"][f"k{k}"]["plain_ms"], bound_ms=tpn["held"][f"k{k}"]["bound_ms"],
               bound_by=tpn["held"][f"k{k}"]["bound_by"],
               library_ms=tpn["held"]["k1"]["sdpa_ms"] if k == 1 else None)
          for k, fn, src, rep, what in (
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104", "prefill"),
              (4, "paged_attn_partials", "paged_attn.cu", "ray_tpu/llm/pallas/paged_attn.py:134", "decode"))),
        *(dict(name=f"K{k} {fn} remat policies (phase 7e, {REMAT_WARMUP + REMAT_TIMED} steps under each of "
                    f"{list(REMAT_K1_FORWARDS)}; held and timed at {rem['held'][hk]['shape']} bf16 causal)", route="cuda",
               source=f"ray_tpu_torch/csrc/{src}", replaces=rep, launches=rem["launches"][k - 1], max_abs_err=err,
               ms=rem["held"][hk][ms], plain_ms=rem["held"][hk]["plain_ms"],
               bound_ms=rem["held"][hk][f"{b}bound_ms"], bound_by=rem["held"][hk][f"{b}bound_by"],
               library_ms=rem["held"][hk][lib])
          for k, fn, src, rep, hk, ms, b, lib, err in (
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104", "k1", "ms", "",
               "sdpa_ms", rem["held"]["k1"]["err_o"]),
              (2, "flash_attention_bwd_dq", "flash_attention_bwd.cu", "ray_tpu/ops/flash_attention.py:154", "k23",
               "dq_ms", "dq_", "sdpa_bwd_ms", rem["held"]["k23"]["errs"]["dq"][0]),
              (3, "flash_attention_bwd_dkv", "flash_attention_bwd.cu", "ray_tpu/ops/flash_attention.py:192", "k23",
               "dkv_ms", "dkv_", "sdpa_bwd_ms", max(rem["held"]["k23"]["errs"]["dk"][0],
                                                  rem["held"]["k23"]["errs"]["dv"][0])))),
        dict(name="K5 rms_norm_fused", route="cuda", source="ray_tpu_torch/csrc/rms_norm.cu",
             replaces="ray_tpu/ops/layers.py:22", launches=k5_launches,
             max_abs_err=max(r["err"] for r in k5_rows), ms=rep5["ms"], plain_ms=rep5["plain_ms"],
             bound_ms=rep5["bound_ms"], bound_by=rep5["bound_by"], library_ms=rep5["lib_ms"],
             device_ms=rep5["device_ms"], host_us=rep5["host_us"]),
        *(dict(name=f"K{k} {fn} {who} {what} (phase 7d {leg}; held in its worker at "
                    f"{held[f'k{k}'].get('shapes', [held[f'k{k}']['shape']])}, timed at {held[f'k{k}']['shape']})",
               route="cuda",
               source=f"ray_tpu_torch/csrc/{src}", replaces=rep, launches=launches,
               max_abs_err=held[f"k{k}"]["err_o" if k == 1 else "err"], ms=held[f"k{k}"]["ms"],
               plain_ms=held[f"k{k}"]["plain_ms"], bound_ms=held[f"k{k}"]["bound_ms"],
               bound_by=held[f"k{k}"]["bound_by"], library_ms=held["k1"]["sdpa_ms"] if k == 1 else None)
          for k, fn, src, rep, what in (
              (1, "flash_attention_fwd", "flash_attention.cu", "ray_tpu/ops/flash_attention.py:104", "prefill"),
              (4, "paged_attn_partials", "paged_attn.cu", "ray_tpu/llm/pallas/paged_attn.py:134", "decode"))
          for who, leg, held, launches in (
              ("compiled graph's engine actor", "(a)", dag["a"]["held"], dag["a"]["counts"][f"k{k}"]),
              ("device-object consumer's engine", "(d)", dag["d"]["held"], dag["d"]["c_run"][f"k{k}"]))),
    ]
    mark("9")
    print(f"telemetry overhead (phase 4, paged graph engine): {tel_ratio:.4f}x (gate {TEL_GATE}) {card}")
    print(f"total {time.perf_counter() - t_start:.1f} s (each phase's end: {marks})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def profile_step(torch, step_fn, state, batch, card, table_path) -> dict[str, int]:
    """One training step under torch.profiler, after a warm-up step traced
    and discarded: the device time by kernel into ``table_path``, and one summary line (K1, K2, K3, matrix products,
    the rest, and the device's idle share of the step). Returns how many
    times each wgmma kernel (K1, K2, K3) ran in the step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    # a warm-up step traced and discarded first: one call's trace missed a K1
    # kernel of its step (35 of 36) when the window opened with the step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        step_fn(state, batch)[1]["loss"].item()
        prof.step()
        t0 = time.perf_counter()
        step_fn(state, batch)[1]["loss"].item()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    groups = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "gemm": 0.0, "other": 0.0}
    calls = {K1_WGMMA: 0, K2_WGMMA: 0, K3_WGMMA: 0}
    averages = prof.key_averages()
    for e in averages:
        # kernels only: a CPU op's device time repeats its kernels', and the
        # schedule's ProfilerStep annotation spans the whole step on the device
        if "CUDA" not in str(e.device_type) or e.key.startswith("ProfilerStep"):
            continue
        us = self_device_us(e)
        name = e.key
        key = ("K1" if "flash_fwd_kernel" in name else "K2" if "flash_bwd_dq" in name else
               "K3" if "flash_bwd_dkv" in name else
               "gemm" if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "sm90", "nvjet")) else "other")
        groups[key] += us / 1e3
        for tag in calls:
            calls[tag] += e.count if tag in name else 0
    busy = sum(groups.values())
    sort_by = "self_device_time_total" if hasattr(averages[0], "self_device_time_total") else "self_cuda_time_total"
    with open(table_path, "w") as f:
        f.write(averages.table(sort_by=sort_by, row_limit=40))
    print(f"profile: one training step {wall_ms:.2f} ms wall, kernels {busy:.2f} ms (idle share "
          f"{1 - busy / wall_ms:.4f}): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items()) + "; wgmma kernel calls "
          + ", ".join(f"{k} {v}" for k, v in calls.items()) + f" {card}")
    return calls


def serve_engine(torch, eng, prompts, label, card, k4_per_step) -> dict:
    """``eng.generate`` of ``prompts``, 32 greedy tokens each, with the
    kernels' launch counters zeroed just before and read just after: every
    request must finish with 32 tokens in the vocabulary, K1 must have run
    num_layers times per prefill forward and K4 ``k4_per_step`` times per
    decode step (a replay adds the K4 launches its capture recorded).
    Returns the streams, the launches, the engine's times and
    ``kv_cache_stats()``, and the peak memory since the caller's reset."""
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    L = eng.config.num_layers
    flash_attention_fwd.launches = 0
    paged_attn_partials.launches = 0
    t0 = time.perf_counter()
    ids = [eng.add_request(p, SamplingParams(max_tokens=32)) for p in prompts]
    finals, calls = {}, 0
    while eng.has_unfinished():  # generate(), with its step() calls counted
        finals.update((o.request_id, o) for o in eng.step() if o.finished)
        calls += 1
    outs = [finals[i] for i in ids]
    wall_s = time.perf_counter() - t0
    k1_n, k4_n = flash_attention_fwd.launches, paged_attn_partials.launches
    check(all(len(o.token_ids) == 32 and o.finish_reason == "length" for o in outs),
          f"{label}: not every request finished with 32 tokens: {[(len(o.token_ids), o.finish_reason) for o in outs]}")
    check(all(0 <= t < eng.config.vocab_size for o in outs for t in o.token_ids), f"{label}: token outside the vocabulary")
    check(k1_n == L * eng.prefill_forwards > 0,
          f"{label}: K1 launches {k1_n} != {L} x {eng.prefill_forwards} prefill forwards")
    check(k4_n == k4_per_step * eng.decode_steps and eng.decode_steps > 0,
          f"{label}: K4 launches {k4_n} != {k4_per_step} x {eng.decode_steps} decode steps")
    peak = torch.cuda.max_memory_allocated()
    stats = eng.kv_cache_stats()
    run = dict(tokens=[o.token_ids for o in outs], k1=k1_n, k4=k4_n, peak=peak, wall_s=wall_s,
               prefill_ms=eng.prefill_s * 1e3, prefill_forwards=eng.prefill_forwards, decode_ms=eng.decode_s * 1e3 / eng.decode_steps, steps=eng.decode_steps,
               tok_s=sum(len(o.token_ids) for o in outs) / wall_s, capture_s=eng.graph_capture_s, stats=stats,
               calls=calls)
    kv = {k: stats[k] for k in ("layout", "dtype", "bytes_per_token", "allocated_bytes")}
    print(f"{label}: graph capture {run['capture_s']:.3f} s, prefill {run['prefill_ms']:.2f} ms over "
          f"{eng.prefill_forwards} forwards, decode {run['decode_ms']:.3f} ms/step over {run['steps']} steps, "
          f"{run['tok_s']:.2f} generated tok/s ({wall_s:.3f} s wall), K1 launches {k1_n}, K4 launches {k4_n} (= "
          f"{k4_per_step} x {eng.decode_steps} decode steps), cache {kv}, peak memory {peak} bytes {card}")
    return run


def telemetry_gates(eng, run, label, card) -> dict:
    """Phase 4's flight-recorder gates on a fresh engine after its one
    ``serve_engine`` run: a step record per step() call, 8 request records,
    248 tokens emitted by the decode steps (the step record's ``emitted``
    counts a lane's drained token; the 8 first tokens are sampled at
    admission), no re-capture, 8 TTFT observations."""
    snap = eng.telemetry()
    n_tokens = sum(len(t) for t in run["tokens"])
    emitted = sum(r["emitted"] for r in snap["steps"])
    ttft = eng._tel._b_ttft
    ttft_n = ttft._metric._series[ttft._key][0]
    check(snap["step_count"] == run["calls"], f"{label}: {snap['step_count']} step records for {run['calls']} steps")
    check(len(snap["requests"]) == 8, f"{label}: {len(snap['requests'])} request records")
    check(emitted + 8 == n_tokens == 256, f"{label}: step records emitted {emitted} (+ 8 at admission) of {n_tokens}")
    check(snap["recompiles"] == {}, f"{label}: recompiles {snap['recompiles']}")
    check(ttft_n == 8, f"{label}: TTFT histogram count {ttft_n}")
    ttfts = sorted(r["ttft_s"] for r in snap["requests"])
    itl = [x for r in snap["requests"] for x in r["itl_s"]]
    print(f"{label} telemetry: {snap['step_count']} step records, 8 request records, {emitted} + 8 tokens emitted, "
          f"no recompile; TTFT {ttfts[0] * 1e3:.2f}-{ttfts[-1] * 1e3:.2f} ms, mean ITL {sum(itl) / len(itl) * 1e3:.3f} ms over "
          f"{len(itl)} gaps {card}")
    return snap


def telemetry_overhead(torch, eng, prompts, label, card, tokens=24, max_rounds=18) -> float:
    """ray_tpu's zero-overhead gate on one engine with its telemetry
    toggled between rounds (tests/test_perf_smoke.py): each round admits the
    8 prompts cut to 64 tokens, steps until none waits, then times the
    decode-only steps to the end; rounds interleave the two modes and run
    until the best instrumented round is within TEL_GATE of the best plain
    one (at least 3 pairs, at most ``max_rounds``). Returns the ratio of
    the bests, which must be within TEL_GATE."""
    from ray_tpu_torch.llm import SamplingParams

    tel = eng._tel
    rounds = {True: [], False: []}
    short = [p[:64] for p in prompts]
    for r in range(max_rounds):
        for instrumented in ([True, False] if r % 2 == 0 else [False, True]):
            eng._tel = tel if instrumented else None
            for p in short:
                eng.add_request(p, SamplingParams(max_tokens=tokens))
            while eng.num_waiting:
                eng.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps = 0
            while eng.has_unfinished():
                eng.step()
                steps += 1
            rounds[instrumented].append((time.perf_counter() - t0) / max(steps, 1))
        if r >= 2 and min(rounds[True]) <= TEL_GATE * min(rounds[False]):
            break
    eng._tel = tel
    best = {m: min(v) for m, v in rounds.items()}
    ratio = best[True] / best[False]
    print(f"{label} telemetry overhead: best decode-only step {best[True] * 1e3:.3f} ms with telemetry, "
          f"{best[False] * 1e3:.3f} ms without, ratio {ratio:.4f} (gate {TEL_GATE}) over {len(rounds[True])} + "
          f"{len(rounds[False])} interleaved rounds (with: {[round(x * 1e3, 3) for x in rounds[True]]}, without: "
          f"{[round(x * 1e3, 3) for x in rounds[False]]} ms) {card}")
    check(ratio <= TEL_GATE, f"{label}: telemetry overhead {ratio:.4f}x > {TEL_GATE}")
    return ratio


def serve_spec(torch, cfg, params, prompts, seeded, ref_tokens, label, card, **engine_kw) -> dict:
    """Phase 4d: one speculative engine (8 slots, ``engine_kw``) serves the
    8 prompts, 32 greedy tokens each, with the launch counters zeroed just
    before and read just after (K4: num_layers per dispatched round on the
    paged layout, 0 on slots; K1: num_layers per target prefill forward and
    the draft's num_layers per draft prefill), then the 4 seeded prompts,
    then profiles 4 decode-only rounds, drains and checks the pool. Every
    first token must equal phase 4's."""
    from ray_tpu_torch import _kernels
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    torch.cuda.reset_peak_memory_stats()
    eng = LLMEngine(cfg, params, max_num_seqs=8, telemetry_tags={"model": f"phase 4d {label}"}, **engine_kw)
    paged = eng.kv_layout == "paged"
    L = cfg.num_layers
    drafter = eng._drafter
    flash_attention_fwd.launches = 0
    paged_attn_partials.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate(prompts, SamplingParams(max_tokens=32))
    wall_s = time.perf_counter() - t0
    k1_n, k4_n = flash_attention_fwd.launches, paged_attn_partials.launches
    st = eng.spec_stats()
    rounds = st["rounds"]
    tokens = [o.token_ids for o in outs]
    check(all(len(t) == 32 and o.finish_reason == "length" for t, o in zip(tokens, outs)),
          f"phase 4d {label}: not every request finished with 32 tokens: {[len(t) for t in tokens]}")
    firsts = sum(a[0] == b[0] for a, b in zip(tokens, ref_tokens))
    check(firsts == 8, f"phase 4d {label}: first tokens equal phase 4's in {firsts} of 8")
    check(rounds > 0 and k4_n == (L if paged else 0) * rounds,
          f"phase 4d {label}: K4 launches {k4_n} != {L if paged else 0} x {rounds} rounds")
    draft_pf = getattr(drafter, "prefill_forwards", 0)
    draft_l = drafter.cfg.num_layers if draft_pf else 0
    check(k1_n == L * eng.prefill_forwards + draft_l * draft_pf > 0,
          f"phase 4d {label}: K1 launches {k1_n} != {L} x {eng.prefill_forwards} target + {draft_l} x {draft_pf} "
          f"draft prefill forwards")
    same = sum(x == z for a, b in zip(tokens, ref_tokens) for x, z in zip(a, b))
    run = dict(tokens=tokens, k1=k1_n, k4=k4_n, rounds=rounds, wall_s=wall_s, round_ms=eng.decode_s * 1e3 / rounds,
               prefill_ms=eng.prefill_s * 1e3, prefill_forwards=eng.prefill_forwards,
               tok_s=256 / wall_s, capture_s=eng.graph_capture_s, stats=st, same=same,
               peak=torch.cuda.max_memory_allocated())
    run["seeded"] = [o.token_ids for o in eng.generate(prompts[:4], seeded)]
    check(all(len(t) == SEEDED_TOKENS for t in run["seeded"]), f"phase 4d {label}: seeded requests cut short")
    for prompt in prompts:
        eng.add_request(prompt, SamplingParams(max_tokens=32))
    while eng.num_waiting:
        eng.step()
    name = label.replace(" ", "_")
    run["profile"] = profile_decode(torch, eng, DECODE_PROFILE_STEPS, f"phase 4d spec {label}", card,
                                    _kernels.BUILD_DIR / f"decode_step_profile_spec_{name}.txt")
    n_prof = (L if paged else 0) * DECODE_PROFILE_STEPS
    calls = run["profile"]["calls"]
    check(calls["paged_partials_kernel"] == n_prof and calls["paged_merge_kernel"] in (0, n_prof),
          f"phase 4d {label}: K4's kernels ran {calls} times in {DECODE_PROFILE_STEPS} rounds, not {n_prof}")
    while eng.has_unfinished():
        eng.step()
    kv = eng.kv_cache_stats()
    check(eng.num_running == 0 and kv.get("pages_free") == kv.get("pages_total") and kv["occupied_tokens"] == 0,
          f"phase 4d {label}: the cache did not drain: {kv}")
    print(f"phase 4d spec {label}: graph capture {run['capture_s']:.3f} s, prefill {run['prefill_ms']:.2f} ms over "
          f"{run['prefill_forwards']} forwards and {draft_pf} draft prefills, {rounds} rounds for 256 greedy tokens, "
          f"{run['round_ms']:.3f} ms per round, {st['mean_tokens_per_round']:.4f} tokens per lane-round, acceptance "
          f"{st['acceptance_rate']:.4f} ({st['accepted']} of {st['proposed']} proposed), {run['tok_s']:.2f} generated "
          f"tok/s ({wall_s:.3f} s wall), K1 launches {k1_n}, K4 launches {k4_n} (= {k4_n // max(rounds, 1)} a round), "
          f"peak memory {run['peak']} bytes; first tokens equal phase 4's in 8 of 8, {same} of 256 greedy tokens equal "
          f"phase 4's (not gated); the pool drained {card}")
    return run


def tel_count(eng, name, **tags) -> float:
    """One engine's value of a telemetry counter's series (the series are
    per process, keyed by tags: each engine here has a model tag of its own)."""
    m = eng._tel.m[name]
    return m._series.get(m._key({**eng._tel.tags, **tags}), 0.0)


def timed_calls(torch, fn, log, dev=None):
    """``fn`` wrapped to append (its arguments, the call's milliseconds on
    the host clock, the card synchronised before and after) to ``log``."""

    def run(*args):
        if dev is None or dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        if dev is None or dev.type == "cuda":
            torch.cuda.synchronize()
        log.append((args, (time.perf_counter() - t0) * 1e3))
        return out

    return run


def serve_handoffs(torch, cfg, params, prompts, ref_tokens, card) -> dict:
    """Phase 4e, disaggregation: a paged prefill-only engine takes the 8
    prompts (one step: phase 4's batched forwards, then each block
    extracted into host tensors), in bf16 and then with an int8 cache (for
    the int8 handoff's bytes); then a paged graph engine, a slot graph
    engine and a paged int8 graph engine each admit the 8 bf16 handoffs
    and generate 32 greedy tokens. Returns the times, bytes and launches."""
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.models.llama import torch_dtype
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    L = cfg.num_layers
    bucket = lambda n: max(64, 1 << (n - 1).bit_length())  # the default prefill buckets: 64 .. 2048
    per_tok = {"bf16": 2 * L * cfg.num_kv_heads * cfg.hd * torch_dtype(cfg.dtype).itemsize,
               "int8": 2 * L * cfg.num_kv_heads * (cfg.hd + 4)}
    out = {}
    for dtype in ("bf16", "int8"):
        pre = LLMEngine(cfg, params, max_num_seqs=8, kv_layout="paged", page_size=64,
                        cache_dtype=None if dtype == "bf16" else "int8",
                        telemetry_tags={"model": f"phase 4e prefill {dtype}"})
        ext = []
        pre._extract_block = timed_calls(torch, pre._extract_block, ext)
        flash_attention_fwd.launches = 0
        paged_attn_partials.launches = 0
        ids = [pre.add_prefill_request(p) for p in prompts]
        outs = pre.step()
        k1_n, k4_n = flash_attention_fwd.launches, paged_attn_partials.launches
        pays = [pre.pop_handoff(i) for i in ids]
        check(all(o.finish_reason == "handoff" for o in outs) and len(outs) == 8 and all(p is not None for p in pays),
              f"phase 4e prefill {dtype}: {[(o.request_id, o.finish_reason) for o in outs]}")
        check(k1_n == L * pre.prefill_forwards > 0 and k4_n == 0 and pre.decode_steps == 0,
              f"phase 4e prefill {dtype}: K1 {k1_n} != {L} x {pre.prefill_forwards} forwards, or K4 {k4_n} != 0")
        kv = pre.kv_cache_stats()
        check(kv["pages_free"] == kv["pages_total"] == 256, f"phase 4e prefill {dtype}: pages not returned: {kv}")
        for p, pay in zip(prompts, pays):
            T = bucket(len(p))
            nbytes = pay["k"].nbytes + pay["v"].nbytes + (
                pay["k_scale"].nbytes + pay["v_scale"].nbytes if "k_scale" in pay else 0)
            check(pay["n"] == len(p) and pay["k"].shape[1] == T and nbytes == T * per_tok[dtype],
                  f"phase 4e prefill {dtype}: payload n {pay['n']} (prompt {len(p)}), width {pay['k'].shape[1]} "
                  f"(bucket {T}), {nbytes} bytes (want {T * per_tok[dtype]})")
        check(tel_count(pre, "rt_llm_handoffs_total", event="extracted") == 8,
              f"phase 4e prefill {dtype}: rt_llm_handoffs_total extracted "
              f"{tel_count(pre, 'rt_llm_handoffs_total', event='extracted')}")
        tokens = sum(pay["k"].shape[1] for pay in pays)
        nbytes = sum(int(pay["k"].nbytes + pay["v"].nbytes) + (int(pay["k_scale"].nbytes + pay["v_scale"].nbytes)
                     if "k_scale" in pay else 0) for pay in pays)
        ext_2048 = [ms for (slot, T), ms in ext if T == 2048]
        out[dtype] = dict(pays=pays, k1=k1_n, tokens=tokens, bytes=nbytes, prefill_ms=pre.prefill_s * 1e3,
                          extract_ms=sum(ms for _, ms in ext) / len(ext), extract_2048_ms=sum(ext_2048) / len(ext_2048),
                          forwards=pre.prefill_forwards)
        print(f"phase 4e prefill-only {dtype} (paged, 8 slots, page 64): one step, {pre.prefill_forwards} prefill "
              f"forwards, K1 launches {k1_n}, K4 {k4_n}; 8 handoffs of {tokens} tokens at their buckets, {nbytes} "
              f"bytes ({nbytes // tokens} a token, k + v{' + scales' if dtype == 'int8' else ''}); extract "
              f"{out[dtype]['extract_ms']:.3f} ms a handoff (device gather and copy to the host), "
              f"{out[dtype]['extract_2048_ms']:.3f} ms at the 2048 bucket; prefill stage {pre.prefill_s * 1e3:.2f} ms; "
              f"all 256 pages back {card}")
        del pre
        torch.cuda.empty_cache()
    pays = out["bf16"]["pays"]
    for label, kw in (("paged bf16", dict(kv_layout="paged", page_size=64)), ("slots bf16", dict(kv_layout="slots")),
                      ("paged int8", dict(kv_layout="paged", page_size=64, cache_dtype="int8"))):
        torch.cuda.reset_peak_memory_stats()
        dec = LLMEngine(cfg, params, max_num_seqs=8, telemetry_tags={"model": f"phase 4e decode {label}"}, **kw)
        paged = dec.kv_layout == "paged"
        adm, scat = [], []
        dec._admit_prefilled = timed_calls(torch, dec._admit_prefilled, adm)
        if paged:
            dec._scatter_paged = timed_calls(torch, dec._scatter_paged, scat)
        flash_attention_fwd.launches = 0
        paged_attn_partials.launches = 0
        t0 = time.perf_counter()
        ids = [dec.add_prefilled(pay, SamplingParams(max_tokens=32)) for pay in pays]
        finals = {}
        while dec.has_unfinished():
            finals.update((o.request_id, o) for o in dec.step() if o.finished)
        wall_s = time.perf_counter() - t0
        k1_n, k4_n = flash_attention_fwd.launches, paged_attn_partials.launches
        toks = [finals[i].token_ids for i in ids]
        check(all(len(t) == 32 and finals[i].finish_reason == "length" for t, i in zip(toks, ids)),
              f"phase 4e decode {label}: not every request finished with 32 tokens")
        firsts = sum(a[0] == b[0] for a, b in zip(toks, ref_tokens))
        check(firsts == 8, f"phase 4e decode {label}: first tokens equal phase 4's in {firsts} of 8")
        check(k1_n == 0 and k4_n == (L if paged else 0) * dec.decode_steps and dec.decode_steps > 0,
              f"phase 4e decode {label}: K1 {k1_n} (want 0), K4 {k4_n} != {L if paged else 0} x {dec.decode_steps}")
        check(dec._decode.captures == 1, f"phase 4e decode {label}: {dec._decode.captures} captures")
        scattered = tel_count(dec, "rt_llm_handoffs_total", event="scattered")
        check(scattered == 8, f"phase 4e decode {label}: rt_llm_handoffs_total scattered {scattered}")
        kv = dec.kv_cache_stats()
        check(kv["occupied_tokens"] == 0 and kv.get("pages_free") == kv.get("pages_total"),
              f"phase 4e decode {label}: the cache did not drain: {kv}")
        same = sum(x == z for a, b in zip(toks, ref_tokens) for x, z in zip(a, b))
        run = dict(tokens=toks, k4=k4_n, steps=dec.decode_steps, same=same, admit_ms=sum(ms for _, ms in adm) / 8,
                   scatter_ms=sum(ms for _, ms in scat) / 8 if scat else None, wall_s=wall_s,
                   decode_ms=dec.decode_s * 1e3 / dec.decode_steps, peak=torch.cuda.max_memory_allocated())
        out[label] = run
        scat_txt = f", device scatter (pool pages, table row, length lane) {run['scatter_ms']:.3f} ms" if scat else ""
        print(f"phase 4e decode {label} (graph, add_prefilled x 8): admission {run['admit_ms']:.3f} ms a handoff "
              f"(upload, scatter-in, first-token sample){scat_txt}; decode {run['decode_ms']:.3f} ms/step over "
              f"{dec.decode_steps} steps, {256 / wall_s:.2f} generated tok/s ({wall_s:.3f} s wall); K1 launches {k1_n}, "
              f"K4 launches {k4_n}; captures 1; handoffs scattered 8; first tokens equal phase 4's in 8 of 8, {same} of "
              f"256 greedy tokens equal phase 4's paged graph streams (not gated); peak memory {run['peak']} bytes "
              f"{card}")
        del dec
        torch.cuda.empty_cache()
    out["bf16"].pop("pays")
    out["int8"].pop("pays")
    return out


def migrate_and_suspend(torch, cfg, params, prompts, card) -> dict:
    """Phase 4e, live migration and suspend: a paged graph engine serves
    the 8 prompts (4 greedy, 4 seeded at temperature 0.8, top_p 0.9), 32
    tokens each, uninterrupted; then again, and after 11 steps 4 lanes (2
    greedy, 2 seeded) are checkpointed (the first checkpoint drains the
    step in flight: 12 tokens each), finished as migrated, sent through
    the wire codec and restored on a second paged graph engine; then one
    of the source's running requests is suspended and resumed. Returns
    the times."""
    import numpy as np

    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.llm import migrate

    sps = [SamplingParams(max_tokens=32)] * 4 + [
        SamplingParams(max_tokens=32, temperature=0.8, top_p=0.9, seed=s) for s in range(4)]
    kw = dict(max_num_seqs=8, kv_layout="paged", page_size=64, enable_prefix_caching=False)
    src = LLMEngine(cfg, params, telemetry_tags={"model": "phase 4e migrate source"}, **kw)
    ref = [o.token_ids for o in src.generate(prompts, sps)]
    check(all(len(t) == 32 for t in ref), "phase 4e migrate: the uninterrupted run cut a stream short")
    ids = [src.add_request(p, sp) for p, sp in zip(prompts, sps)]
    for _ in range(MIGRATE_STEPS):
        src.step()
    moved = [ids[0], ids[1], ids[4], ids[5]]
    pages = {rid: len(src._slot_pages[src._requests[rid].slot]) for rid in moved}
    free0 = src.kv_cache_stats()["pages_free"]
    states, ckpt_ms = [], []
    for rid in moved:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states.append(src.checkpoint_request(rid))
        ckpt_ms.append((time.perf_counter() - t0) * 1e3)
        check(src.finish_migrated(rid), f"phase 4e migrate: finish_migrated({rid}) refused")
    free1 = src.kv_cache_stats()["pages_free"]
    check(free1 - free0 == sum(pages.values()),
          f"phase 4e migrate: {free1 - free0} pages returned, the migrated lanes held {sum(pages.values())}")
    check(all(len(s["emitted_token_ids"]) == 12 for s in states),
          f"phase 4e migrate: checkpoints hold {[len(s['emitted_token_ids']) for s in states]} tokens, not 12")
    wires = [migrate.encode(s) for s in states]
    dst = LLMEngine(cfg, params, telemetry_tags={"model": "phase 4e migrate peer"}, **kw)
    seen = {}
    bind = dst._bind_resume

    def spy(st, slot):
        bind(st, slot)
        seen[st.request_id] = migrate.key_to_wire(dst._dkeys[slot].cpu().numpy())

    dst._bind_resume = spy
    new_ids = [dst.restore_request(migrate.decode(w)) for w in wires]
    # the source goes on with its other 4; one of them suspends and resumes
    sus = ids[2]
    sus_pages = len(src._slot_pages[src._requests[sus].slot])
    free2 = src.kv_cache_stats()["pages_free"]
    t0 = time.perf_counter()
    info = src.suspend_request(sus)
    suspend_ms = (time.perf_counter() - t0) * 1e3
    sus_state = src._suspended[sus]["state"]
    check(src.kv_cache_stats()["pages_free"] - free2 == sus_pages,
          f"phase 4e suspend: {src.kv_cache_stats()['pages_free'] - free2} pages returned, it held {sus_pages}")
    t0 = time.perf_counter()
    src.resume_suspended(sus)
    resume_ms = (time.perf_counter() - t0) * 1e3
    finals = {}
    while src.has_unfinished() or dst.has_unfinished():
        for eng in (src, dst):
            finals.update((o.request_id, o.token_ids) for o in eng.step()
                          if o.finished and o.finish_reason not in ("migrated", "suspended"))
    stats = src.suspend_stats()
    check((stats["suspended"], stats["resumed"]) == (1, 1) and info["nbytes"] == stats["spilled_bytes"]
          == migrate.state_nbytes(sus_state) > 0 and info["published"] is False,
          f"phase 4e suspend: stats {stats}, info {info}, state {migrate.state_nbytes(sus_state)} bytes")
    check(len(finals[sus]) == 32, f"phase 4e suspend: the resumed stream has {len(finals[sus])} tokens")
    spliced = [finals[i] for i in new_ids]
    for s, toks, rid in zip(states, spliced, new_ids):
        check(len(toks) == 32 and toks[:12] == s["emitted_token_ids"],
              f"phase 4e migrate: a spliced stream has {len(toks)} tokens or its first 12 differ")
        check(np.array_equal(seen[rid], s["rng_key"]),
              f"phase 4e migrate: the restored lane's device key {seen[rid]} != the checkpoint's {s['rng_key']}")
    for label, eng in (("source", src), ("peer", dst)):
        check(eng._decode.captures == 1, f"phase 4e migrate {label}: {eng._decode.captures} captures")
        kv = eng.kv_cache_stats()
        check(kv["pages_free"] == kv["pages_total"], f"phase 4e migrate {label}: the pool did not drain: {kv}")
    splice = dst._tel.m["rt_llm_migration_splice_s"]
    count, total = splice._series[splice._key(dst._tel.tags)][:2]
    same_post = sum(x == z for rid, toks in zip(moved, spliced) for x, z in zip(toks[12:], ref[ids.index(rid)][12:]))
    same_sus = sum(x == z for x, z in zip(finals[sus], ref[2]))
    nb = [migrate.state_nbytes(s) for s in states]
    res = dict(checkpoint_ms=sum(ckpt_ms) / 4, checkpoint_first_ms=ckpt_ms[0], splice_ms=total / count * 1e3,
               suspend_ms=suspend_ms, resume_ms=resume_ms, state_bytes=nb, same_post=same_post)
    print(f"phase 4e migrate (paged graph engines, 4 of 8 lanes at 12 tokens: 2 greedy, 2 seeded): checkpoint "
          f"{res['checkpoint_ms']:.3f} ms a lane ({ckpt_ms[0]:.3f} ms the first, which drains the step in flight; "
          f"{[round(x, 3) for x in ckpt_ms]}), {nb} bytes; restore to first post-splice token "
          f"{res['splice_ms']:.3f} ms (rt_llm_migration_splice_s, mean of {int(count)}); every device key equal to its "
          f"checkpoint's; spliced streams 32 tokens, their first 12 the checkpoint's; {same_post} of 80 post-splice "
          f"tokens equal the uninterrupted run's (not gated); captures 1 on both engines {card}")
    print(f"phase 4e suspend (one running lane of the source): suspend {suspend_ms:.3f} ms ({info['nbytes']} bytes "
          f"spilled, published False), resume call {resume_ms:.3f} ms, stats {stats}; the resumed stream 32 tokens, "
          f"{same_sus} of 32 equal the uninterrupted run's (not gated) {card}")
    del src, dst
    torch.cuda.empty_cache()
    return res


class Replica:
    """One engine shared by caller threads (a stand-in for a serving
    replica's stepper): a caller runs ``fn(engine)`` under the replica's
    lock, and ``wait`` steps the engine (every lane advances) whenever the
    caller holds the lock, until the caller's own request has finished."""

    def __init__(self, eng):
        import threading

        self.eng = eng
        self.lock = threading.Lock()
        self.done = {}

    def call(self, fn):
        with self.lock:
            return fn(self.eng)

    def wait(self, rid, max_steps: int = 5000) -> dict:
        for _ in range(max_steps):
            with self.lock:
                o = self.done.pop(rid, None)
                if o is None:
                    self.done.update((x.request_id, x) for x in self.eng.step() if x.finished)
                    o = self.done.pop(rid, None)
            if o is not None:
                return {"request_id": rid, "token_ids": list(o.token_ids), "finish_reason": o.finish_reason}
        raise SmokeFailure(f"request {rid} never finished")


def in_threads(calls, admitted=None, go=None, timeout: float = 300.0) -> list:
    """Run each of ``calls`` in a daemon thread of its own and return their
    results in order. With ``admitted`` (one event a call), thread i + 1
    starts only once call i has set its event, and ``go`` is set once all
    have: the callers admit in order, then step together."""
    import threading

    results, errors = [None] * len(calls), [None] * len(calls)

    def body(i):
        try:
            results[i] = calls[i]()
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller's thread below
            errors[i] = e

    threads = [threading.Thread(target=body, args=(i,), daemon=True) for i in range(len(calls))]
    for i, t in enumerate(threads):
        t.start()
        if admitted is not None:
            while not admitted[i].wait(0.05):
                check(t.is_alive() or errors[i] is None, f"call {i} failed before it admitted: {errors[i]!r}")
                check(t.is_alive() or admitted[i].is_set(), f"call {i} ended without admitting")
    if go is not None:
        go.set()
    for t in threads:
        t.join(timeout)
        check(not t.is_alive(), f"a caller thread outlived {timeout} s")
    for e in errors:
        if e is not None:
            raise e
    return results


def admission_overhead(torch, eng, ac, prompts, label, card, tokens=24, max_rounds=18) -> float:
    """The admission controller's cost to a decode step, as phase 4's
    telemetry gate measures the telemetry's: interleaved rounds on one
    graph engine with the controller attached (its gauge refresh installed
    as the telemetry's sample hook, a check() before each admission) and
    detached; each round admits the 8 prompts cut to 64 tokens, steps until
    none waits, then times the decode-only steps to the end. Returns the
    ratio of the best rounds, which must be within ADMIT_GATE."""
    from ray_tpu_torch.llm import SamplingParams

    hook = ac._refresh_wait_gauge
    rounds = {True: [], False: []}
    short = [p[:64] for p in prompts]
    for r in range(max_rounds):
        for attached in ([True, False] if r % 2 == 0 else [False, True]):
            eng._tel.sample_hook = hook if attached else None
            for p in short:
                if attached:
                    ac.check(1)
                eng.add_request(p, SamplingParams(max_tokens=tokens))
            while eng.num_waiting:
                eng.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps = 0
            while eng.has_unfinished():
                eng.step()
                steps += 1
            rounds[attached].append((time.perf_counter() - t0) / max(steps, 1))
        if r >= 2 and min(rounds[True]) <= ADMIT_GATE * min(rounds[False]):
            break
    eng._tel.sample_hook = hook
    best = {m: min(v) for m, v in rounds.items()}
    ratio = best[True] / best[False]
    print(f"{label} admission overhead: best decode-only step {best[True] * 1e3:.3f} ms with the controller, "
          f"{best[False] * 1e3:.3f} ms without, ratio {ratio:.4f} (gate {ADMIT_GATE}) over {len(rounds[True])} + "
          f"{len(rounds[False])} interleaved rounds {card}")
    check(ratio <= ADMIT_GATE, f"{label}: admission overhead {ratio:.4f}x > {ADMIT_GATE}")
    return ratio


def control_plane(torch, cfg, params, prompts, ref_tokens, card) -> dict:
    """Phase 4f, the serving control plane over graph engines: DisaggRouter
    over a paged prefill-only engine and two paged graph decode engines D0
    and D1 (legs a-e), CacheAwareRouter over D0 and D1 with an in-process
    PrefixIndex (load order, a draining replica, a kvplane.index chaos
    drop), then admission on D0. Returns the launches and times."""
    import threading

    from ray_tpu_torch import chaos
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.llm import migrate
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.llm.disagg import DisaggRouter, handoff
    from ray_tpu_torch.llm.kvplane import CacheAwareRouter, PrefixIndex, rank_replicas
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.serve import overload as ov

    L = cfg.num_layers
    kw = dict(max_num_seqs=8, kv_layout="paged", page_size=64, enable_prefix_caching=False)
    t0 = time.perf_counter()
    pre = LLMEngine(cfg, params, telemetry_tags={"model": "phase 4f prefill"}, **kw)
    decs = [LLMEngine(cfg, params, telemetry_tags={"model": f"phase 4f D{i}"}, **kw) for i in range(2)]
    build_s = time.perf_counter() - t0
    reps = [Replica(d) for d in decs]
    acs = [ov.AdmissionController(d) for d in decs]
    sp = SamplingParams(max_tokens=32)
    local = threading.local()  # per request (one thread each): closure seconds, decode attempts, its index
    p_lock = threading.Lock()
    leg = {"lose": 0, "cut": None}
    res = {}

    def counts():
        return (flash_attention_fwd.launches, paged_attn_partials.launches, pre.prefill_forwards,
                sum(d.prefill_forwards for d in decs), sum(d.decode_steps for d in decs))

    def check_launches(before, label):
        """K1 num_layers times per prefill forward, K4 num_layers times per
        decode step, over the engines' counts since ``before``."""
        k1, k4, pf, df, ds = (a - b for a, b in zip(counts(), before))
        check(k1 == L * (pf + df) and k4 == L * ds and ds > 0,
              f"phase 4f {label}: K1 {k1} != {L} x {pf + df} prefill forwards, or K4 {k4} != {L} x {ds} decode steps")
        return dict(k1=k1, k4=k4, prefill_forwards=pf + df, decode_steps=ds)

    def timed(fn):
        def run(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                local.closure_s += time.perf_counter() - t

        return run

    def prefill(prompt):
        with p_lock:  # one prefill engine: a B = 1 forward per request
            wire = handoff.encode(pre.prefill_handoff(prompt))
        return handoff.meta_of(wire), wire

    def decode(meta, ref, prompt, sp_dict):
        i = local.tries % 2  # a handoff's first attempt on D0, its retry on D1
        local.tries += 1
        if leg["lose"]:
            leg["lose"] -= 1
            raise handoff.HandoffLostError("handoff evicted before scatter-in")
        acs[i].check(int(sp_dict.get("priority", 0)))
        kv = handoff.decode(ref)
        rid = reps[i].call(lambda e: e.add_prefilled(kv, sp))
        if leg["cut"] is None:
            return reps[i].wait(rid)
        for _ in range(leg["cut"]):
            reps[i].call(lambda e: e.step())
        state = reps[i].call(lambda e: e.checkpoint_request(rid))
        check(reps[i].call(lambda e: e.finish_migrated(rid)), f"phase 4f resume: finish_migrated({rid}) refused")
        res["checkpoint"] = state
        raise migrate.RequestMigratedError(rid, migrate.meta_of(state), migrate.encode(state))

    def resume(meta, ref, sp_dict):
        t = time.perf_counter()
        state = migrate.decode(ref)
        out = reps[1].wait(reps[1].call(lambda e: e.restore_request(state)))
        res["resume_s"] = time.perf_counter() - t
        return out

    def request(router, prompt, i=0, shed=False):
        """One request through ``router`` in this thread: its output (the
        OverloadedError, where ``shed``), the router's wall, the closures'."""
        local.closure_s, local.tries, local.i = 0.0, 0, i
        t = time.perf_counter()
        try:
            out = router.generate(prompt, {})
        except ov.OverloadedError as e:
            if not shed:
                raise
            out = e
        return out, time.perf_counter() - t, local.closure_s

    def disagg(label):
        return DisaggRouter(timed(prefill), timed(decode), resume=timed(resume),
                            telemetry_tags={"model": f"phase 4f disagg {label}"})

    def router_count(router, name, **tags):
        m = router._tel.m[name]
        return m._series.get(m._key({**router._tel.tags, **tags}), 0.0)

    def overhead_us(runs):
        return [round((wall - closure) * 1e6, 1) for _, wall, closure in runs]

    # (a) the 8 requests, concurrently, through the router
    flash_attention_fwd.launches = 0
    paged_attn_partials.launches = 0
    before = counts()
    router = disagg("a")
    t0 = time.perf_counter()
    runs = in_threads([lambda p=p, i=i: request(router, p, i=i) for i, p in enumerate(prompts)])
    wall_a = time.perf_counter() - t0
    launches = check_launches(before, "disagg (a)")
    toks_a = [o["token_ids"] for o, _, _ in runs]
    st = router.stats()
    firsts = sum(a[0] == b[0] for a, b in zip(toks_a, ref_tokens))
    check(all(len(t) == 32 for t in toks_a), "phase 4f disagg (a): not every request has 32 tokens")
    check(firsts == 8, f"phase 4f disagg (a): first tokens equal phase 4's in {firsts} of 8")
    check((st["requests"], st["prefills"], st["decode_retries"], st["failed"]) == (8, 8, 0, 0),
          f"phase 4f disagg (a): stats {st}")
    published = router_count(router, "rt_llm_handoffs_total", event="published")
    check(published == 8 and launches["prefill_forwards"] == 8, f"phase 4f disagg (a): {published} handoffs "
          f"published, {launches['prefill_forwards']} prefill forwards")
    same = sum(x == z for a, b in zip(toks_a, ref_tokens) for x, z in zip(a, b))
    res["disagg_a"] = dict(launches, wall_s=wall_a, overhead_us=overhead_us(runs), same=same)
    print(f"phase 4f disagg (a) (DisaggRouter: a paged prefill-only engine, B = 1 prefills under one lock; decode on "
          f"D0; 8 concurrent requests): {wall_a:.3f} s wall, stats {st}; rt_llm_handoffs_total published 8; K1 "
          f"launches {launches['k1']} ({launches['prefill_forwards']} forwards), K4 {launches['k4']} "
          f"({launches['decode_steps']} decode steps); first tokens equal phase 4's in 8 of 8, {same} of 256 greedy "
          f"tokens (not gated); router overhead a request {res['disagg_a']['overhead_us']} us {card}")

    # (b) D0 draining: every first decode attempt sheds, the retry lands on D1 with the same handoff
    acs[0].drain()
    before = counts()
    router = disagg("b")
    runs = in_threads([lambda p=p, i=i: request(router, p, i=i) for i, p in enumerate(prompts)])
    check_launches(before, "disagg (b)")
    st = router.stats()
    check((st["prefills"], st["decode_retries"], st["failed"]) == (8, 8, 0), f"phase 4f disagg (b): stats {st}")
    check([o["token_ids"] for o, _, _ in runs] == toks_a, "phase 4f disagg (b): tokens differ from (a)'s")
    check(acs[0].stats()["shed_draining"] == 8, f"phase 4f disagg (b): D0 admission {acs[0].stats()}")
    reused = router_count(router, "rt_llm_handoffs_total", event="reused")
    # the reuse leg's wall, one request alone, against the re-prefill leg's (c)
    reuse = request(disagg("b1"), prompts[0])
    acs[0] = ov.AdmissionController(decs[0])
    print(f"phase 4f disagg (b) (D0 draining): stats {st}, handoffs reused {reused:.0f}, D0 shed 8 "
          f"(ReplicaDrainingError, 429); tokens equal (a)'s in 8 of 8 streams {card}")

    # (c) the handoff lost once: re-prefill
    leg["lose"] = 1
    router = disagg("c")
    lost = request(router, prompts[0])
    st = router.stats()
    check((st["prefills"], st["handoffs_lost"], st["decode_retries"]) == (2, 1, 0), f"phase 4f disagg (c): {st}")
    check(lost[0]["token_ids"] == toks_a[0], "phase 4f disagg (c): tokens differ from (a)'s")

    # (d) the resume leg: a lane checkpointed after MIGRATE_STEPS steps on D0, resumed on D1
    leg["cut"] = MIGRATE_STEPS
    router = disagg("d")
    resumed = request(router, prompts[0])
    leg["cut"] = None
    st = router.stats()
    emitted = res["checkpoint"]["emitted_token_ids"]
    check((st["prefills"], st["migrations"], st["resumed"]) == (1, 1, 1), f"phase 4f disagg (d): stats {st}")
    check(resumed[0]["token_ids"] == toks_a[0] and emitted == toks_a[0][:len(emitted)],
          f"phase 4f disagg (d): the spliced stream differs from (a)'s")
    # the alternative to resuming: re-prefill the prompt and the tokens emitted by then on D1
    t = time.perf_counter()
    rid = reps[1].call(lambda e: e.add_request(prompts[0] + emitted, SamplingParams(max_tokens=32 - len(emitted))))
    reps[1].wait(rid)
    reprefill_s = time.perf_counter() - t

    # (e) both decode engines draining: the router sheds with a 429
    for ac in acs:
        ac.drain()
    router = disagg("e")
    shed = request(router, prompts[0], shed=True)
    st = router.stats()
    http = ov.http_error_of(shed[0])
    check(isinstance(shed[0], ov.OverloadedError) and http is not None and http[0] == 429 and st["shed"] == 1
          and st["budget_exhausted"] == 1, f"phase 4f disagg (e): {shed[0]!r}, http {http}, stats {st}")
    acs[:] = [ov.AdmissionController(d) for d in decs]
    seq = dict(reuse=overhead_us([reuse])[0], lost=overhead_us([lost])[0], resume=overhead_us([resumed])[0])
    res["disagg"] = dict(reuse_s=reuse[1], lost_s=lost[1], resume_s=res["resume_s"], reprefill_s=reprefill_s,
                         emitted=len(emitted), overhead_seq_us=seq)
    print(f"phase 4f disagg (c) handoff lost once: stats prefills 2, handoffs_lost 1; (d) resume after "
          f"{MIGRATE_STEPS} steps ({len(emitted)} tokens): migrations 1, resumed 1, prefills 1, the spliced stream "
          f"equals (a)'s; (e) both draining: {type(shed[0]).__name__} {http}, shed 1, budget exhausted 1. Walls: the "
          f"reuse leg {reuse[1] * 1e3:.1f} ms vs the re-prefill leg {lost[1] * 1e3:.1f} ms (prompt 0, {len(prompts[0])} "
          f"tokens); the resume call {res['resume_s'] * 1e3:.1f} ms vs re-prefilling the prompt + {len(emitted)} "
          f"tokens {reprefill_s * 1e3:.1f} ms (the same {32 - len(emitted)} tokens to go); router overhead a request "
          f"(sequential) {seq} us {card}")

    # the cache-aware router over D0 (r0) and D1 (r1), an in-process index that nothing registers into
    admitted = go = None

    def submit(rid, prompt, sp_dict):
        i = int(rid[1])
        acs[i].check(int(sp_dict.get("priority", 0)))
        req = reps[i].call(lambda e: e.add_request(prompt, sp))
        local.landed = rid
        admitted[local.i].set()
        go.wait(120)
        return reps[i].wait(req)

    def cache_aware(label, expect_landed):
        nonlocal admitted, go
        admitted, go = [threading.Event() for _ in prompts], threading.Event()
        router = CacheAwareRouter(PrefixIndex(), timed(submit), ["r0", "r1"],
                                  telemetry_tags={"model": f"phase 4f kvplane {label}"})

        def call(i):
            out = request(router, prompts[i], i=i)
            return out + (local.landed,)

        before = counts()
        t = time.perf_counter()
        runs = in_threads([lambda i=i: call(i) for i in range(len(prompts))], admitted, go)
        wall = time.perf_counter() - t
        got = check_launches(before, f"kvplane {label}")
        toks = [o["token_ids"] for o, *_ in runs]
        landed = [r[3] for r in runs]
        firsts = sum(a[0] == b[0] for a, b in zip(toks, ref_tokens))
        check(landed == expect_landed, f"phase 4f kvplane {label}: landed {landed}, want {expect_landed}")
        check(firsts == 8 and all(len(t) == 32 for t in toks), f"phase 4f kvplane {label}: first tokens equal "
              f"phase 4's in {firsts} of 8")
        return dict(got, toks=toks, stats=router.stats(), wall_s=wall, overhead_us=overhead_us([r[:3] for r in runs]))

    loads, order = {"r0": 0, "r1": 0}, []
    for p in prompts:  # what rank_replicas gives with every request still in flight
        order.append(rank_replicas(["r0", "r1"], {}, loads, len(p))[0])
        loads[order[-1]] += 1
    ca = {"load": cache_aware("load order", order)}
    st = ca["load"]["stats"]
    check(st["cold"] == 8 and st["retries"] == 0 and st["index_errors"] == 0, f"phase 4f kvplane load order: {st}")
    acs[0].drain()
    ca["drain"] = cache_aware("r0 draining", ["r1"] * 8)
    check(ca["drain"]["stats"]["retries"] == 8, f"phase 4f kvplane r0 draining: {ca['drain']['stats']}")
    acs[0] = ov.AdmissionController(decs[0])
    chaos.inject("kvplane.index", drop_prob=1.0)
    try:
        ca["down"] = cache_aware("index down", order)
    finally:
        chaos.clear()
    # one request alone through the cache-aware router, for its overhead without concurrent callers
    admitted, go = [threading.Event()], threading.Event()
    go.set()
    alone = request(CacheAwareRouter(PrefixIndex(), timed(submit), ["r0", "r1"],
                                     telemetry_tags={"model": "phase 4f kvplane alone"}), prompts[0])
    ca["alone_us"] = overhead_us([alone])[0]
    keyed = sum(len(p) > 64 for p in prompts)  # prompts with a 64-token boundary key to look up
    check(ca["down"]["stats"]["index_errors"] == keyed and ca["down"]["toks"] == ca["load"]["toks"],
          f"phase 4f kvplane index down: {ca['down']['stats']}, tokens equal the load-order leg's: "
          f"{ca['down']['toks'] == ca['load']['toks']}")
    res["kvplane"] = ca
    print(f"phase 4f kvplane (CacheAwareRouter over D0 and D1, empty PrefixIndex, 8 requests admitted in order, then "
          f"stepped together): load order {order} ({ca['load']['wall_s']:.3f} s, K1 {ca['load']['k1']}, K4 "
          f"{ca['load']['k4']}); r0 draining: all 8 on r1, retries 8; kvplane.index chaos drop: index_errors "
          f"{keyed} of {keyed} keyed prompts, tokens equal the load-order leg's in 8 of 8 streams; first tokens equal "
          f"phase 4's in 8 of 8 in each leg; router overhead a request {ca['load']['overhead_us']} us (load order), "
          f"{ca['down']['overhead_us']} us (index down), {ca['alone_us']} us (one request alone) {card}")

    # admission on D0, its EMAs seeded by the legs above
    eng = decs[0]
    ac = ov.AdmissionController(eng, ov.AdmissionConfig(max_queue_depth=8, class_fracs=(0.5, 1.0)))
    burst, first_shed, errs = [], {}, []
    for j in range(16):
        cls = j % 2
        try:
            ac.check(cls)
        except ov.OverloadedError as e:
            first_shed.setdefault(cls, eng.num_waiting)
            errs.append(e)
            continue
        burst.append(eng.add_request(prompts[j % 8], sp))
    ast = ac.stats()
    http = ov.http_error_of(errs[0])
    check(ast["shed_by_class"] == {0: 6, 1: 2} and first_shed == {0: 4, 1: 8} and http[0] == 429
          and errs[0].shed_class == 0, f"phase 4f admission burst: stats {ast}, first shed at depth {first_shed}, "
          f"http {http}")
    for rid in burst:
        eng.abort_request(rid)
    while eng.has_unfinished():
        eng.step()
    check_us = host_us(torch, lambda: ac.check(1), calls=2000)
    ratio = admission_overhead(torch, eng, ac, prompts, "phase 4f D0", card)
    for label, e in (("prefill", pre), ("D0", decs[0]), ("D1", decs[1])):
        check(e._decode.captures == 1, f"phase 4f {label}: {e._decode.captures} captures")
    res["admission"] = dict(check_us=check_us, ratio=ratio, stats=ast)
    print(f"phase 4f admission (D0, max_queue_depth 8, class_fracs (0.5, 1.0), EMAs: service "
          f"{eng._tel.service_ema_s * 1e3:.1f} ms, ITL {eng._tel.itl_ema_s * 1e3:.3f} ms): a burst of 16 alternating "
          f"classes sheds class 0 from depth {first_shed[0]} and class 1 from depth {first_shed[1]}, shed_by_class "
          f"{ast['shed_by_class']}, {http[0]} with retry_after_s {http[1]['retry_after_s']}; check() {check_us:.2f} us "
          f"host; decode ratio with the controller {ratio:.4f}; captures 1 on all three engines; engines built in "
          f"{build_s:.2f} s {card}")
    del pre, decs, reps, eng
    torch.cuda.empty_cache()
    return res


def exact_handoffs(torch, cfg2, dev) -> list:
    """Phase 5: extract -> scatter-in -> extract on the card, against the
    same on the host, on both layouts and in the four dtype directions
    (bf16 into bf16, bf16 into int8, int8 with its scales into int8, int8
    into bf16), at 2 layers of Llama-3-8B's kv widths (8 heads, head_dim
    128) and a 128-token bucket: every tensor bit-identical card vs host,
    and a same-dtype round trip returns the block's own bytes. Returns the
    (layout, direction) cases checked."""
    from ray_tpu_torch.llm import kv_cache as kvc
    from ray_tpu_torch.llm import paged_kv as pkv
    from ray_tpu_torch.llm.disagg import scatter

    L, KVH, HD, T, PAGE = 2, cfg2.num_kv_heads, cfg2.hd, 128, 64
    cases = []

    def block(dtype, g):
        k = torch.randn((L, T, KVH, HD), generator=g) * 2
        v = torch.randn((L, T, KVH, HD), generator=g) * 2
        if dtype == "int8":
            sc = lambda: torch.rand((L, KVH, T), generator=g) * 0.05 + 0.01
            return (k.clamp(-127, 127).round().to(torch.int8), v.clamp(-127, 127).round().to(torch.int8), sc(), sc())
        return k.to(torch.bfloat16), v.to(torch.bfloat16)

    def run(layout, src_dtype, dst_dtype, device, seed):
        g = torch.Generator().manual_seed(seed)
        blk = [t.to(device) for t in block(src_dtype, g)]
        if layout == "slots":
            cache = kvc.alloc(kvc.CacheConfig(num_layers=L, num_slots=2, max_seq_len=256, num_kv_heads=KVH,
                                              head_dim=HD, dtype=dst_dtype), device)
            scatter.kv_scatter_in_slots(cache, 1, blk[0], blk[1], 100, *blk[2:])
            got = scatter.kv_extract_slots(cache, 1, T)
            return blk, got, [cache["length"]]
        pool = pkv.alloc(pkv.PagedCacheConfig(num_layers=L, num_pages=6, page_size=PAGE, max_pages_per_seq=4,
                                               num_slots=2, num_kv_heads=KVH, head_dim=HD, dtype=dst_dtype), device)
        tables = torch.zeros((2, 4), dtype=torch.int32, device=device)
        lengths = torch.zeros((2,), dtype=torch.int32, device=device)
        row = torch.tensor([4, 2, 0, 0], dtype=torch.int32, device=device)
        scatter.kv_scatter_in_paged(pool, tables, lengths, 1, row, blk[0], blk[1], 100, *blk[2:])
        got = scatter.kv_extract_paged(pool, row[: T // PAGE])
        return blk, got, [tables, lengths]

    for layout in ("slots", "paged"):
        for i, (src, dst) in enumerate((("bfloat16", "bfloat16"), ("bfloat16", "int8"), ("int8", "int8"),
                                        ("int8", "bfloat16"))):
            blk_c, got_c, lanes_c = run(layout, src, dst, dev, 100 + i)
            blk_h, got_h, lanes_h = run(layout, src, dst, torch.device("cpu"), 100 + i)
            for a, b in zip(list(got_c) + lanes_c, list(got_h) + lanes_h):
                check(a.dtype == b.dtype and torch.equal(a.cpu(), b),
                      f"phase 5 handoff {layout} {src} into {dst}: the card's extract differs from the host's")
            if src == dst:
                check(all(torch.equal(a, b) for a, b in zip(got_c, blk_c)),
                      f"phase 5 handoff {layout} {src}: the round trip changed the block")
            cases.append(f"{layout} {src}->{dst}")
    return cases


def migrated_streams_on_card(torch, cfg2, params, rng) -> list:
    """Phase 5: a request migrated mid-decode on the card (checkpoint at 6
    tokens, the wire codec, restore on a second engine) continues the
    uninterrupted stream on the card token for token, greedy and seeded,
    on the slot and paged graph engines, the paged n-gram spec engine
    (greedy) and the paged sync engine. Returns the cases checked."""
    from ray_tpu_torch.llm import LLMEngine, SamplingParams, SpecConfig
    from ray_tpu_torch.llm import migrate

    prompt = rng.integers(1, cfg2.vocab_size, size=40).tolist()
    greedy = SamplingParams(max_tokens=16)
    seeded = SamplingParams(max_tokens=16, temperature=0.8, top_p=0.9, seed=3)
    cases = []
    for label, kw, sps in (
        ("slots graph", dict(kv_layout="slots"), (greedy, seeded)),
        ("paged graph", dict(kv_layout="paged"), (greedy, seeded)),
        ("paged spec n-gram", dict(kv_layout="paged", speculative=SpecConfig(drafter="ngram", k=SPEC_K)), (greedy,)),
        ("paged sync", dict(kv_layout="paged", device_resident=False), (greedy, seeded)),
    ):
        kw = dict(max_num_seqs=2, max_seq_len=256, page_size=64, **kw)
        for sp in sps:
            want = LLMEngine(cfg2, params, **kw).generate(prompt, sp).token_ids
            src = LLMEngine(cfg2, params, **kw)
            rid = src.add_request(prompt, sp)
            while len(src._requests[rid].token_ids) < 6:
                src.step()
            state = migrate.decode(migrate.encode(src.checkpoint_request(rid)))
            src.finish_migrated(rid)
            dst = LLMEngine(cfg2, params, **kw)
            new = dst.restore_request(state)
            got = None
            while dst.has_unfinished():
                got = next((o.token_ids for o in dst.step() if o.request_id == new and o.finished), got)
            check(got == want and got[: len(state["emitted_token_ids"])] == state["emitted_token_ids"],
                  f"phase 5 migration {label} temperature {sp.temperature}: the spliced stream differs from the "
                  f"uninterrupted one ({sum(a == b for a, b in zip(got or [], want))} of {len(want)} equal)")
            cases.append(f"{label} {'seeded' if sp.temperature else 'greedy'}")
    return cases


def profile_decode(torch, eng, steps, mode, card, table_path) -> dict:
    """Decode-only engine steps, after one unprofiled step and a
    synchronise: ``steps`` steps timed without the profiler (host clock
    from the first step's start to a synchronise after the last, so a
    device-resident engine's last dispatched step is inside it), then
    ``steps`` more under torch.profiler for the device-busy time and the
    device time of K4 (partials and merge kernels), of cuBLAS and of the
    rest (the full table into ``table_path``). The idle share is 1 -
    busy / the unprofiled wall: the profiler's tracing slows the host's
    launches (a graph replay most), so the profiled wall, also printed,
    overstates it. Returns the K4 kernels' call counts and the per-step
    numbers."""
    from torch.profiler import ProfilerActivity, profile

    def timed_steps():
        calls_ms = []
        t_start = time.perf_counter()
        for _ in range(steps):
            t0 = time.perf_counter()
            eng.step()
            calls_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return (time.perf_counter() - t_start) * 1e3 / steps, calls_ms

    eng.step()
    torch.cuda.synchronize()
    wall, calls_ms = timed_steps()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall, _ = timed_steps()
    groups, calls = serving_groups(prof, table_path, steps)
    busy = sum(groups.values())
    k4 = groups["K4 partials"] + groups["K4 merge"]
    print(f"{mode} decode profile ({steps} decode-only steps, 8 lanes): wall {wall:.3f} ms/step (step() "
          f"calls {', '.join(f'{w:.3f}' for w in calls_ms)} ms; {prof_wall:.3f} ms/step under the profiler), device "
          f"busy {busy:.3f} ms/step, idle share {1 - busy / wall:.4f} ({1 - busy / prof_wall:.4f} of the profiled "
          f"wall), K4 {k4:.4f} ms/step (partials {groups['K4 partials']:.4f}, merge {groups['K4 merge']:.4f}), cuBLAS "
          f"{groups['gemm']:.3f} ms/step, rest {groups['other']:.3f} ms/step; K4 kernel calls {calls} {card}")
    return dict(calls=calls, wall_ms=wall, busy_ms=busy, k4_ms=k4, groups=groups, idle=1 - busy / wall)


def serving_groups(prof, table_path, steps=1):
    """Device ms per step of a serving profile by group (K4's partials and
    merge kernels, cuBLAS, the rest) and the K4 kernels' call counts; the
    full table into ``table_path``."""
    groups = {"K4 partials": 0.0, "K4 merge": 0.0, "gemm": 0.0, "other": 0.0}
    calls = {name: 0 for name in K4_KERNELS}
    averages = prof.key_averages()
    for e in averages:
        if "CUDA" not in str(e.device_type):
            continue
        name = e.key
        key = ("K4 partials" if K4_KERNELS[0] in name else "K4 merge" if K4_KERNELS[1] in name else
               "gemm" if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "sm90", "nvjet")) else "other")
        groups[key] += self_device_us(e) / 1e3 / steps
        for tag in calls:
            calls[tag] += e.count if tag in name else 0
    sort_by = "self_device_time_total" if hasattr(averages[0], "self_device_time_total") else "self_cuda_time_total"
    with open(table_path, "w") as f:
        f.write(averages.table(sort_by=sort_by, row_limit=40))
    return groups, calls


def profile_hit_wave(torch, eng, prompts, sampling, card, table_path) -> dict:
    """The engine step that admits ``prompts`` (prefix hits: one extend
    forward each, then the wave's first decode step) under torch.profiler:
    its wall time, device-busy time, idle share and the device time of K4,
    of cuBLAS and of the rest; the full table into ``table_path``."""
    from torch.profiler import ProfilerActivity, profile

    for prompt in prompts:
        eng.add_request(prompt, sampling)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()  # the decode step it dispatched runs inside the window
        wall = (time.perf_counter() - t0) * 1e3
    groups, calls = serving_groups(prof, table_path)
    busy = sum(groups.values())
    k4 = groups["K4 partials"] + groups["K4 merge"]
    print(f"phase 4b hit wave profile (one step: {len(prompts)} extend forwards, then a decode step): wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms, idle share {1 - busy / wall:.4f}, K4 {k4:.4f} ms (partials "
          f"{groups['K4 partials']:.4f}, merge {groups['K4 merge']:.4f}), cuBLAS {groups['gemm']:.3f} ms, rest "
          f"{groups['other']:.3f} ms; K4 kernel calls {calls} {card}")
    return dict(calls=calls, wall_ms=wall, busy_ms=busy, k4_ms=k4, groups=groups)


# ---------------------------------------------------------------- phase 4g: the object plane
BORROWER_S = 420  # the borrower process's bound: spawn, CUDA init, weights, its engine, 32 decode steps
SHM_USE = 0.8  # the share of /dev/shm's free bytes one wave of handoffs may take


def shm_bytes() -> tuple[int, int]:
    """/dev/shm's size and free bytes (os.statvfs)."""
    s = os.statvfs("/dev/shm")
    return s.f_frsize * s.f_blocks, s.f_frsize * s.f_bavail


def rt_segments() -> list:
    return sorted(n for n in os.listdir("/dev/shm") if n.startswith("rt"))


def weights_checksum(params) -> list:
    """Exact sums of three weight tensors' bits (16- or 32-bit words as int64)."""
    import torch

    out = []
    for w in (params["embed"], params["layers"]["wq"], params["final_norm"]):
        bits = w.view(torch.int16 if w.element_size() == 2 else torch.int32)
        out.append(int(bits.sum(dtype=torch.int64).item()))
    return out


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def free_wait_s() -> float:
    """How soon the owner's store must empty after the last release: the
    grace window plus five housekeeping passes (the borrower's flush, the
    owner's gc pass, and slack for a loaded host)."""
    from ray_tpu_torch._config import get_config

    cfg = get_config()
    return cfg.owned_object_grace_s + 5 * cfg.ref_counting_interval_s


def wait_for(cond, timeout: float) -> float | None:
    """Seconds until ``cond()`` held, polled every 10 ms; None past ``timeout``."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if cond():
            return time.perf_counter() - t0
        time.sleep(0.01)
    return None


def recv(conn, proc, timeout: float):
    """The next message from a child, within ``timeout``; fails if the child dies or says nothing."""
    t0 = time.perf_counter()
    while not conn.poll(0.5):
        if not proc.is_alive():
            raise SmokeFailure(f"phase 4g: the borrower exited with code {proc.exitcode} before replying")
        if time.perf_counter() - t0 > timeout:
            raise SmokeFailure(f"phase 4g: the borrower sent nothing for {timeout} s")
    return conn.recv()


def borrower_main(conn, authkey: bytes, spec: dict):
    """Phase 4g(a)'s borrower, a spawned process: attach a plane of its own
    with the owner's authkey, rebuild the weights from seed 0, then fetch
    each (meta, ref) handoff the owner sends over the plane, admit it into
    a paged graph engine and decode 32 greedy tokens. Reports its weights'
    checksum, the times, the launches and the streams."""
    import torch

    from ray_tpu_torch.core import direct
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.llm.disagg import handoff
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    st = direct.attach(authkey)
    dev = torch.device(spec["device"])
    cfg = LlamaConfig(**spec["config"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    conn.send(("ready", weights_checksum(params)))
    eng = LLMEngine(cfg, params, max_num_seqs=8, kv_layout="paged", page_size=64, device=dev,
                    telemetry_tags={"model": "phase 4g borrower"})
    adm = []
    eng._admit_prefilled = timed_calls(torch, eng._admit_prefilled, adm, dev)
    flash_attention_fwd.launches = 0
    paged_attn_partials.launches = 0
    rids, fetch_ms, upload_ms, finals = [], [], [], {}
    t_start = time.perf_counter()
    while True:
        msg = conn.recv()
        if msg[0] == "end":
            break
        for meta, ref in msg[1]:
            t0 = time.perf_counter()
            pay = handoff.fetch(ref, meta)  # a cross-process borrow: the owner's segment mapped, no copy
            fetch_ms.append((time.perf_counter() - t0) * 1e3)
            sync(torch, dev)
            t0 = time.perf_counter()
            k, v = pay["k"].to(dev), pay["v"].to(dev)  # the block's upload from the mapping, timed alone
            sync(torch, dev)
            upload_ms.append((time.perf_counter() - t0) * 1e3)
            del k, v
            rids.append(eng.add_prefilled(pay, SamplingParams(max_tokens=32)))
            del pay, ref, meta
        del msg
        while eng.num_waiting:  # admission scatters the wave's blocks in: their borrows can go
            finals.update((o.request_id, o) for o in eng.step() if o.finished)
        st.pump()  # the releases reach the owner now
        conn.send(("released", len(rids)))
    while eng.has_unfinished():
        finals.update((o.request_id, o) for o in eng.step() if o.finished)
    sync(torch, dev)
    conn.send(("result", dict(
        tokens=[list(finals[r].token_ids) for r in rids], reasons=[finals[r].finish_reason for r in rids],
        k1=flash_attention_fwd.launches, k4=paged_attn_partials.launches, decode_steps=eng.decode_steps,
        prefill_forwards=eng.prefill_forwards, captures=eng._decode.captures if eng._decode is not None else 0,
        fetch_ms=fetch_ms, upload_ms=upload_ms, admit_ms=[ms for _, ms in adm],
        wall_s=time.perf_counter() - t_start)))
    direct.detach()


def plane_handoffs(torch, cfg, params, prompts, ref_tokens, handoff_tokens, authkey, card, dev) -> dict:
    """Phase 4g(a): a paged prefill-only engine's 8 handoffs published on
    the object plane (in waves that fit /dev/shm), fetched owner-locally,
    then borrowed by a spawned process that decodes them on its own engine."""
    import dataclasses
    import multiprocessing as mp

    from ray_tpu_torch.core import direct
    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.llm.disagg import handoff
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    st = direct.state()
    L = cfg.num_layers
    pre = LLMEngine(cfg, params, max_num_seqs=8, kv_layout="paged", page_size=64, device=dev,
                    telemetry_tags={"model": "phase 4g prefill"})
    k1_0, k4_0 = flash_attention_fwd.launches, paged_attn_partials.launches
    ids = [pre.add_prefill_request(p) for p in prompts]
    pre.step()
    k1_n, k4_n = flash_attention_fwd.launches - k1_0, paged_attn_partials.launches - k4_0
    pays = [pre.pop_handoff(i) for i in ids]
    check(all(p is not None for p in pays) and k1_n == L * pre.prefill_forwards > 0 and k4_n == 0,
          f"phase 4g prefill: payloads {[p is not None for p in pays]}, K1 {k1_n}, K4 {k4_n}")
    del pre
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sizes = [int(p["k"].nbytes + p["v"].nbytes + p["logits"].nbytes) for p in pays]
    _, free = shm_bytes()
    check(max(sizes) <= SHM_USE * free, f"phase 4g: a {max(sizes)}-byte handoff does not fit /dev/shm's {free} free "
          "bytes; shorten the plane legs' prompts (never the model's widths)")
    waves, cur = [], []
    for i, n in enumerate(sizes):
        if cur and sum(sizes[j] for j in cur) + n > SHM_USE * free:
            waves.append(cur)
            cur = []
        cur.append(i)
    waves.append(cur)
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    spec = {"device": dev.type, "config": dataclasses.asdict(cfg)}
    proc = ctx.Process(target=borrower_main, args=(child, authkey, spec), daemon=True, name="phase-4g-borrower")
    t_spawn = time.perf_counter()
    proc.start()
    try:
        kind, checksum = recv(parent, proc, BORROWER_S)
        ready_s = time.perf_counter() - t_spawn
        mine = weights_checksum(params)
        check(kind == "ready" and checksum == mine, f"phase 4g: the borrower's weights {checksum} != the owner's {mine}")
        publish_ms, local_ms, plane_bytes, released_s = [], [], 0, []
        for wave in waves:
            pairs = []
            for i in wave:
                t0 = time.perf_counter()
                meta, ref = handoff.publish(pays[i])  # encode + writev into a fresh segment
                publish_ms.append((time.perf_counter() - t0) * 1e3)
                plane_bytes += st.owned.entry(ref.id.binary()).payload.shm.total_size
                t0 = time.perf_counter()
                got = handoff.fetch(ref, meta)  # owner-local: this process maps its own segment
                local_ms.append((time.perf_counter() - t0) * 1e3)
                check(torch.equal(got["k"], pays[i]["k"]) and got["n"] == pays[i]["n"],
                      f"phase 4g: the owner-local fetch of handoff {i} differs")
                del got
                pays[i] = None  # the plane holds the bytes now
                pairs.append((meta, ref))
            parent.send(("wave", pairs))  # pickled out: each entry waits for its borrow-release
            del pairs, meta, ref
            kind, n = recv(parent, proc, BORROWER_S)
            check(kind == "released", f"phase 4g: the borrower said {kind!r}")
            freed = wait_for(lambda: st.owned.size() == 0, free_wait_s())
            check(freed is not None, f"phase 4g: {st.owned.size()} handoffs still owned {free_wait_s()} s after the "
                  "borrower released them")
            released_s.append(freed)
        parent.send(("end",))
        kind, res = recv(parent, proc, BORROWER_S)
        proc.join(60)
        check(kind == "result" and not proc.is_alive() and proc.exitcode == 0,
              f"phase 4g: the borrower ended with {kind!r}, alive {proc.is_alive()}, exit code {proc.exitcode}")
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    toks = res["tokens"]
    firsts = sum(a[0] == b[0] for a, b in zip(toks, ref_tokens))
    same = sum(x == z for a, b in zip(toks, handoff_tokens) for x, z in zip(a, b))
    check(all(len(t) == 32 for t in toks) and firsts == 8,
          f"phase 4g borrower: first tokens equal phase 4's in {firsts} of 8, lengths {[len(t) for t in toks]}")
    check(same == 256, f"phase 4g borrower: {same} of 256 tokens equal phase 4e's in-process handoff streams")
    check(res["k1"] == 0 and res["prefill_forwards"] == 0 and res["k4"] == L * res["decode_steps"] > 0,
          f"phase 4g borrower: K1 {res['k1']} (want 0), K4 {res['k4']} != {L} x {res['decode_steps']} decode steps")
    check(res["captures"] == 1 or dev.type != "cuda", f"phase 4g borrower: {res['captures']} captures")
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    out = dict(k1=k1_n, borrower=res, publish_ms=mean(publish_ms), local_fetch_ms=mean(local_ms),
               fetch_ms=mean(res["fetch_ms"]), upload_ms=mean(res["upload_ms"]), admit_ms=mean(res["admit_ms"]),
               plane_bytes=plane_bytes, waves=len(waves), ready_s=ready_s, freed_s=max(released_s))
    print(f"phase 4g handoff across processes: {len(waves)} wave(s), {plane_bytes} bytes on the plane; publish "
          f"{out['publish_ms']:.3f} ms a handoff (encode + writev; {[round(x, 3) for x in publish_ms]}), owner-local "
          f"fetch {out['local_fetch_ms']:.3f} ms, cross-process fetch {out['fetch_ms']:.3f} ms "
          f"({[round(x, 3) for x in res['fetch_ms']]}), fetch-to-device upload {out['upload_ms']:.3f} ms "
          f"({[round(x, 3) for x in res['upload_ms']]}), scatter-in admission {out['admit_ms']:.3f} ms; borrower "
          f"ready (spawn, CUDA, weights) {ready_s:.2f} s, weights checksum equal {checksum}; decode "
          f"{res['decode_steps']} steps, K1 0, K4 {res['k4']}, captures {res['captures']}; first tokens equal phase "
          f"4's in 8 of 8, 256 of 256 tokens equal phase 4e's; the owner's store empty {out['freed_s']:.3f} s after "
          f"the release {card}")
    return out


def plane_migrate(torch, cfg, params, prompts, card, dev) -> dict:
    """Phase 4g(b): 4 of 8 live lanes checkpointed and published, restored
    on a second engine from their references; a fifth suspended with its
    publish and restored from the plane copy on the second engine."""
    from ray_tpu_torch.core import direct
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.llm import migrate

    st = direct.state()
    sps = [SamplingParams(max_tokens=32)] * 4 + [
        SamplingParams(max_tokens=32, temperature=0.8, top_p=0.9, seed=s) for s in range(4)]
    kw = dict(max_num_seqs=8, kv_layout="paged", page_size=64, enable_prefix_caching=False, device=dev)
    src = LLMEngine(cfg, params, telemetry_tags={"model": "phase 4g migrate source"}, **kw)
    ref = [o.token_ids for o in src.generate(prompts, sps)]
    ids = [src.add_request(p, sp) for p, sp in zip(prompts, sps)]
    for _ in range(MIGRATE_STEPS):
        src.step()
    moved = [ids[0], ids[1], ids[4], ids[5]]
    pairs, ckpt_ms = [], []
    for rid in moved:
        sync(torch, dev)
        t0 = time.perf_counter()
        pairs.append(migrate.publish(src.checkpoint_request(rid)))
        ckpt_ms.append((time.perf_counter() - t0) * 1e3)
        check(src.finish_migrated(rid), f"phase 4g migrate: finish_migrated({rid}) refused")
    dst = LLMEngine(cfg, params, telemetry_tags={"model": "phase 4g migrate peer"}, **kw)
    restore_ms, new_ids = [], []
    for meta, r in pairs:
        t0 = time.perf_counter()
        new_ids.append(dst.restore_request(r))  # fetch over the plane, decode, validate
        restore_ms.append((time.perf_counter() - t0) * 1e3)
    sus = ids[2]
    t0 = time.perf_counter()
    info = src.suspend_request(sus)  # publish=True, ray_tpu's default
    suspend_ms = (time.perf_counter() - t0) * 1e3
    check(info["published"] is True and src.suspend_publish_errors == 0, f"phase 4g suspend: {info}")
    sus_id = dst.restore_request(src._suspended[sus]["ref"])
    check(src.drop_suspended(sus), "phase 4g suspend: drop_suspended refused")
    del pairs, meta, r
    finals = {}
    while src.has_unfinished() or dst.has_unfinished():
        for eng in (src, dst):
            finals.update((o.request_id, o.token_ids) for o in eng.step()
                          if o.finished and o.finish_reason not in ("migrated", "suspended"))
    got = [finals[i] for i in new_ids]
    want = [ref[ids.index(rid)] for rid in moved]
    equal = sum(a == b for a, b in zip(got, want))
    check(equal == 4, f"phase 4g migrate: {equal} of 4 restored streams equal the uninterrupted runs")
    check(finals[sus_id] == ref[2], "phase 4g suspend: the lane restored from its plane copy left its stream")
    for label, eng in (("source", src), ("peer", dst)):
        check(eng._decode.captures == 1 or dev.type != "cuda", f"phase 4g migrate {label}: captures")
        kv = eng.kv_cache_stats()
        check(kv["pages_free"] == kv["pages_total"], f"phase 4g migrate {label}: the pool did not drain: {kv}")
    splice = dst._tel.m["rt_llm_migration_splice_s"]
    count, total = splice._series[splice._key(dst._tel.tags)][:2]
    del src, dst
    freed = wait_for(lambda: st.owned.size() == 0, free_wait_s())
    check(freed is not None, f"phase 4g migrate: {st.owned.size()} checkpoints still owned")
    res = dict(checkpoint_publish_ms=sum(ckpt_ms) / 4, restore_ms=sum(restore_ms) / 4, suspend_ms=suspend_ms,
               splice_ms=total / count * 1e3)
    print(f"phase 4g migrate over the plane (paged graph engines, 4 of 8 lanes at 12 tokens: 2 greedy, 2 seeded): "
          f"checkpoint + publish {res['checkpoint_publish_ms']:.3f} ms a lane ({[round(x, 3) for x in ckpt_ms]}), "
          f"restore_request(ref) {res['restore_ms']:.3f} ms ({[round(x, 3) for x in restore_ms]}), restore to first "
          f"token {res['splice_ms']:.3f} ms (rt_llm_migration_splice_s, mean of {int(count)}); 4 of 4 streams equal "
          f"the uninterrupted runs; suspend with publish {suspend_ms:.3f} ms ({info['nbytes']} bytes, published "
          f"True), restored from its plane copy on the peer: its stream equal; captures 1 {card}")
    return res


def plane_kv(torch, cfg, params, leader, followers, hit_firsts, hit_firsts_int8, local_ms, off_ms, card, dev) -> dict:
    """Phase 4g(c): the cluster KV plane. Engine A serves phase 4b's leader
    and publishes its prefix; engine B (its local cache too small for a
    full-width group) takes the 8 followers as remote hits: fetch, upload,
    extend with K4. Then CacheAwareRouter over A and B, a paged int8 pair
    (an int8 wire), and a chaos drop at direct.get_owned_view."""
    from ray_tpu_torch import chaos
    from ray_tpu_torch.core import direct
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.llm.kvplane import CacheAwareRouter, KVPlaneClient, PrefixIndex
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    from ray_tpu_torch.models.llama import torch_dtype

    st = direct.state()
    L = cfg.num_layers
    # engine B's local prefix cache holds less than one 1024-token group, so a
    # fetched prefix is not re-stored there and each of the 8 followers is a remote hit
    b_cache = L * 1024 * cfg.num_kv_heads * cfg.hd * torch_dtype(cfg.dtype).itemsize

    def pair(label, dtype):
        idx = PrefixIndex()
        kw = dict(max_num_seqs=8, kv_layout="paged", page_size=64, prefix_block=64, cache_dtype=dtype, device=dev)
        a = LLMEngine(cfg, params, kv_plane=KVPlaneClient(idx, "A", publish_min_hits=1),
                      telemetry_tags={"model": f"phase 4g kv A {label}"}, **kw)
        b = LLMEngine(cfg, params, kv_plane=KVPlaneClient(idx, "B", publish_min_hits=1),
                      prefix_cache_bytes=b_cache, telemetry_tags={"model": f"phase 4g kv B {label}"}, **kw)
        sync(torch, dev)
        t0 = time.perf_counter()
        a.generate(leader, SamplingParams(max_tokens=32))  # its prefill stores the prefix; the step tail publishes it
        lead_s = time.perf_counter() - t0
        sa = a.prefix_cache_stats()
        check(sa["remote"]["published_blocks"] == 1 and idx.stats()["keys"] == len(leader) // 64 and st.owned.size() == 1,
              f"phase 4g kv {label}: A published {sa['remote']}, index {idx.stats()}, owned {st.owned.size()}")
        splices = []
        b._splice_prefix_fetch = timed_calls(torch, b._splice_prefix_fetch, splices, dev)
        k1_0, k4_0 = flash_attention_fwd.launches, paged_attn_partials.launches
        prefill_before = b.prefill_s
        t0 = time.perf_counter()
        outs = b.generate(followers, SamplingParams(max_tokens=32))
        wall_s = time.perf_counter() - t0
        k1_n, k4_n = flash_attention_fwd.launches - k1_0, paged_attn_partials.launches - k4_0
        s = b.prefix_cache_stats()
        want = hit_firsts if dtype is None else hit_firsts_int8
        firsts = sum(o.token_ids[0] == w for o, w in zip(outs, want))
        check(all(len(o.token_ids) == 32 for o in outs) and firsts == 8,
              f"phase 4g kv {label}: first tokens equal phase 4b/4c's hits in {firsts} of 8")
        check(s["remote"]["hits"] == 8 and s["remote"]["tokens_saved"] == 8 * 1024 and s["local"]["hits"] == 0
              and b.prefill_forwards == 0 and b.extend_forwards == 8,
              f"phase 4g kv {label}: B's stats {s}, prefill forwards {b.prefill_forwards}, extends {b.extend_forwards}")
        check(k1_n == 0 and k4_n == L * (b.decode_steps + b.extend_forwards),
              f"phase 4g kv {label}: K1 {k1_n} (want 0), K4 {k4_n} != {L} x ({b.decode_steps} decode steps + "
              f"{b.extend_forwards} extends)")
        check(s["plane"]["wire_dtype"] == ("int8" if dtype else cfg.dtype), f"phase 4g kv {label}: {s['plane']}")
        fetches = b._tel.recorder.snapshot()["fetches"]
        run = dict(a=a, b=b, idx=idx, k1=k1_n, k4=k4_n, wall_s=wall_s, lead_s=lead_s,
                   prefill_ms=(b.prefill_s - prefill_before) * 1e3, stats=s,
                   fetch_ms=sum(f["t1"] - f["t0"] for f in fetches) / len(fetches) * 1e3,
                   splice_ms=sum(ms for _, ms in splices) / len(splices), fetched=s["remote"]["fetched_bytes"])
        print(f"phase 4g kv plane {label} (paged, A holds phase 4b's prefix, B's local tier {b_cache} bytes): "
              f"leader on A {lead_s:.3f} s (prefill, 32 tokens, the publish at the step tail), 8 remote hits on B: "
              f"fetch {run['fetch_ms']:.3f} ms a hit (worker: index lookup, borrow, decode), splice {run['splice_ms']:.3f}"
              f" ms (upload to the card, counters), B's prefill stage {run['prefill_ms']:.2f} ms over 8 extends "
              f"against phase 4b's local hits {local_ms:.2f} ms and caching off {off_ms:.2f} ms "
              f"({wall_s:.3f} s wall, 32 tokens each), fetched {run['fetched']} bytes ({s['plane']['wire_dtype']} "
              f"wire); K1 {k1_n}, K4 {k4_n}; first tokens equal phase {'4b' if dtype is None else '4c'}'s hits in 8 "
              f"of 8 {card}")
        return run

    bf = pair("bf16", None)
    a, b = bf["a"], bf["b"]
    # the router over A and B: a ninth follower goes to the holder
    ninth = followers[1][:1100]  # the prefix and a new tail: A holds its 1024-token boundary, B nothing
    engines = {"A": a, "B": b}

    def submit(rid, prompt, sp):
        o = engines[rid].generate(prompt, SamplingParams(**sp))
        return {"token_ids": list(o.token_ids), "finish_reason": o.finish_reason, "replica": rid}

    router = CacheAwareRouter(bf["idx"], submit, ["A", "B"], block=64, telemetry_tags={"model": "phase 4g router"})
    a_hits = a.prefix_cache_stats()["local"]["hits"]
    routed = router.generate(ninth, {"max_tokens": 32})
    rs = router.stats()
    check(routed["replica"] == "A" and rs["routed_to_holder"] == 1 and a.prefix_cache_stats()["local"]["hits"] == a_hits + 1,
          f"phase 4g router: landed on {routed['replica']}, stats {rs}")
    # chaos: every borrow-get dropped; B's fetch runs out its budget and prefills locally
    f0 = followers[0]
    ref_first = int(b.prefill_remote(f0)["logits"].argmax())
    lost0 = b.prefix_cache_stats()["remote"]["lost"]
    rule = chaos.inject("direct.get_owned_view", drop_prob=1.0)
    try:
        o = b.generate(f0, SamplingParams(max_tokens=32))
    finally:
        chaos.clear()
    s = b.prefix_cache_stats()
    retries = b._kv_plane.fetch_retries
    check(o.token_ids[0] == ref_first and len(o.token_ids) == 32, f"phase 4g chaos: first token {o.token_ids[0]} != "
          f"the local prefill's {ref_first}")
    check(s["remote"]["lost"] == lost0 + 1 and s["plane"]["fetch_lost"] == 1 and s["remote"]["hits"] == 8
          and rule.hits == retries + 1, f"phase 4g chaos: stats {s}, rule hits {rule.hits}")
    print(f"phase 4g router and chaos: CacheAwareRouter over A and B sent a ninth follower to the holder A (stats "
          f"{ {k: rs[k] for k in ('routed_to_holder', 'cold', 'retries')} }, A local hits +1); a drop at "
          f"direct.get_owned_view: B's fetch lost after {rule.hits} attempts, remote lost {s['remote']['lost']}, "
          f"fetch_lost {s['plane']['fetch_lost']}, local prefill with the first token of a B = 1 prefill {card}")
    for eng in (a, b):
        eng._kv_plane.shutdown()
    del a, b, eng, engines, router, bf["a"], bf["b"]
    gc.collect()  # an engine and its plane client hold each other
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    i8 = pair("int8", "int8")
    for eng in (i8["a"], i8["b"]):
        eng._kv_plane.shutdown()
    out = dict(bf16={k: v for k, v in bf.items() if k not in ("a", "b", "idx")},
               int8={k: v for k, v in i8.items() if k not in ("a", "b", "idx")})
    del i8, eng
    gc.collect()
    freed = wait_for(lambda: st.owned.size() == 0, free_wait_s())
    check(freed is not None, f"phase 4g kv: {st.owned.size()} blocks still owned after the clients' shutdown")
    return out


def object_plane(torch, cfg, params, prompts, ref_tokens, handoff_tokens, leader, followers, hit_firsts,
                 hit_firsts_int8, local_ms, off_ms, card, dev) -> dict:
    """Phase 4g: attach the plane, run legs (a)-(c), detach; /dev/shm's rt
    segments must be gone at the end."""
    from ray_tpu_torch.core import direct
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    size, free = shm_bytes()
    print(f"phase 4g /dev/shm: {size} bytes, {free} free (os.statvfs), rt segments {rt_segments()} {card}")
    authkey = os.urandom(32)
    direct.attach(authkey)
    flash_attention_fwd.launches = 0
    paged_attn_partials.launches = 0
    try:
        a = plane_handoffs(torch, cfg, params, prompts, ref_tokens, handoff_tokens, authkey, card, dev)
        b = plane_migrate(torch, cfg, params, prompts, card, dev)
        c = plane_kv(torch, cfg, params, leader, followers, hit_firsts, hit_firsts_int8, local_ms, off_ms, card, dev)
    finally:
        direct.detach()
    k1_n, k4_n = flash_attention_fwd.launches, paged_attn_partials.launches
    left = rt_segments()
    check(not left, f"phase 4g: /dev/shm still holds {left}")
    print(f"phase 4g launches: this process K1 {k1_n}, K4 {k4_n} (the remote hits' extends and decode "
          f"{c['bf16']['k4'] + c['int8']['k4']} of them); the borrower K1 {a['borrower']['k1']}, K4 "
          f"{a['borrower']['k4']}; /dev/shm rt segments at the end: none {card}")
    return dict(handoffs=a, migrate=b, kv=c, k1=k1_n, k4=k4_n, k4_borrower=a["borrower"]["k4"],
                k4_remote=c["bf16"]["k4"] + c["int8"]["k4"], shm=(size, free))


# ---------------------------------------------------------------- phase 4h: the runtime on the card
RUNTIME_TASKS = 1000  # empty tasks timed back to back
RUNTIME_RTT_CALLS = 200  # sequential round trips timed per path
RUNTIME_PUT_BYTES = 256 << 20  # the host tensor put and fetched through the head's store
RUNTIME_MEM_SLACK = 64 << 20  # the card's memory in use after shutdown() vs before phase 4h
RUNTIME_PENDING_S = 2.0  # how long the second card actor must stay pending


@remote(num_gpus=1)
class CardServer:
    """Phase 4h's GPU actor: in its own worker, which sees only its card,
    rebuild phase 4's weights from seed 0 and its paged graph engine
    (``build``), and serve phase 4's prompts. ``build=False``: hold the
    card with a bare CUDA context (the pending second actor)."""

    def __init__(self, spec: dict, build: bool = True):
        import torch

        t0 = time.perf_counter()
        self.visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        self.dev = torch.device("cuda")
        torch.zeros(1, device=self.dev)  # the context: this process holds the card
        self.eng, self.checksum = None, None
        if build:
            from ray_tpu_torch.llm import LLMEngine
            from ray_tpu_torch.models.llama import LlamaConfig, init_params

            cfg = self.cfg = LlamaConfig(**spec["config"])
            params = init_params(cfg, torch.Generator(device=self.dev).manual_seed(0))
            self.checksum = weights_checksum(params)
            # caching off: the streaming leg serves the same prompts again,
            # and a prefix hit's extend would take other arithmetic than
            # phase 4's first pass (with no hit among the 8, equal tokens)
            self.eng = LLMEngine(cfg, params, max_num_seqs=8, kv_layout="paged", page_size=64,
                                 enable_prefix_caching=False, telemetry_tags={"model": "phase 4h card actor"})
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0

    def facts(self) -> dict:
        import torch

        return dict(visible=self.visible, checksum=self.checksum, init_s=self.init_s, pid=os.getpid(),
                    name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
                    allocated=torch.cuda.memory_allocated())

    def ping(self):
        return None

    def generate(self, prompts) -> dict:
        """Phase 4's 8 prompts, 32 greedy tokens each, with K1's and K4's
        launch counters zeroed just before and read just after, here."""
        return _generate(self.eng, prompts)

    def check_kernels(self, lens) -> dict:
        """K1 and K4 held against their plain versions in this worker
        (``hold_kernels``)."""
        return hold_kernels(self.eng, lens)

    def stream(self, prompts):
        """Each request's tokens, yielded as the request finishes: (index, tokens)."""
        from ray_tpu_torch.llm import SamplingParams

        rids = [self.eng.add_request(p, SamplingParams(max_tokens=32)) for p in prompts]
        index = {r: i for i, r in enumerate(rids)}
        while self.eng.has_unfinished():
            for o in self.eng.step():
                if o.finished:
                    yield index[o.request_id], list(o.token_ids)


def hold_kernels(eng, lens) -> dict:
    """K1 at an engine's largest prefill (the prompts in the longest
    prompt's bucket, one batch, as the engine batches a bucket) and K4 at
    its first decode step (a lane per prompt over bf16 pages, each
    lane's bound its prompt's length), each held against its plain
    version here in the worker, on inputs from seed 0, and timed beside
    it (K4: ``hold_k4``); the launch counts are put back as they were."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.llm.engine import _bucket
    from ray_tpu_torch.ops.flash_attention import attention_with_lse_ref, flash_attention_fwd

    counts = flash_attention_fwd.launches, paged_attn_partials.launches
    cfg, dev = eng._mcfg, eng.device  # the model as this rank holds it (its heads at tp > 1)
    H, HKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    g = torch.Generator(device=dev).manual_seed(0)
    buckets = [_bucket(int(n), eng.prefill_buckets) for n in lens]
    T = max(buckets)
    B = buckets.count(T)
    q = torch.randn((B, H, T, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, HKV, T, D), generator=g, device=dev).bfloat16() for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = attention_with_lse_ref(q, k, v, causal=True)
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    bound_ms, bound_by = k1_bound(B, H, HKV, T, D)
    k1 = dict(shape=(B, H, HKV, T, D), err_o=err_o, err_lse=err_lse,
              ok=err_o <= K1_TOL_O and err_lse <= K1_TOL_LSE,
              ms=cuda_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True)),
              plain_ms=cuda_ms(torch, lambda: attention_with_lse_ref(q, k, v, causal=True), iters=3, warmup=1),
              sdpa_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                            enable_gqa=True)),
              bound_ms=bound_ms, bound_by=bound_by)
    del q, k, v, o, lse, o_ref, lse_ref
    k4 = hold_k4(eng, g, 1, [int(n) for n in lens])
    flash_attention_fwd.launches, paged_attn_partials.launches = counts
    return dict(k1=k1, k4=k4)


def hold_k4(eng, g, rows, bounds) -> dict:
    """K4 on an engine's pages (bf16, its page size, a random table per
    lane) at ``rows`` query positions a lane (1: a decode step; a suffix's
    bucket: an extend) over lanes whose cached positions are ``bounds``,
    held against its plain version and timed beside it."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials, paged_attn_partials_ref

    cfg, dev, page = eng._mcfg, eng.device, eng._pcfg.page_size
    H, HKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    Bl, max_pg = len(bounds), eng._pcfg.max_pages_per_seq
    P = Bl * max_pg + 1
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(rng.permutation(np.arange(1, P)).reshape(Bl, max_pg).astype(np.int32)).to(dev)
    bound = torch.tensor(bounds, dtype=torch.int32, device=dev)
    pk, pv = (torch.randn((P, page, HKV, D), generator=g, device=dev).bfloat16() for _ in range(2))
    qf = torch.randn((Bl, HKV, H // HKV, rows, D), generator=g, device=dev) * D**-0.5
    m, l, acc = paged_attn_partials(qf, pk, pv, tables, bound)
    m_r, l_r, acc_r = paged_attn_partials_ref(qf, pk, pv, tables, bound)
    err = max((m - m_r).abs().max().item(), (l - l_r).abs().max().item(), (acc - acc_r).abs().max().item())
    rel = max(((l - l_r).abs() / l_r.abs().clamp(min=1)).max().item(),
              ((acc - acc_r).abs() / acc_r.abs().clamp(min=1)).max().item())
    bound_ms, bound_by = k4_bound(qf, pk, None, tables, bound, m, acc, bounds)
    return dict(shape=tuple(qf.shape), err=err, rel=rel, ok=(m - m_r).abs().max().item() <= 1e-4 and rel <= K4_TOL,
                ms=cuda_ms(torch, lambda: paged_attn_partials(qf, pk, pv, tables, bound)),
                plain_ms=cuda_ms(torch, lambda: paged_attn_partials_ref(qf, pk, pv, tables, bound), iters=5,
                                 warmup=1),
                bound_ms=bound_ms, bound_by=bound_by)


def hold_k4_extend(eng, start, suffix_lens) -> dict:
    """K4 at an engine's prefix-hit extend: one lane over ``start`` cached
    positions, its query rows the largest bucket among the suffixes'
    lengths, held against its plain version here in the worker on inputs
    from seed 0 (``hold_k4``); the launch count is put back."""
    import torch

    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.llm.engine import _bucket

    launches = paged_attn_partials.launches
    T = max(_bucket(int(n), eng.prefill_buckets) for n in suffix_lens)
    out = hold_k4(eng, torch.Generator(device=eng.device).manual_seed(0), T, [int(start)])
    paged_attn_partials.launches = launches
    return out


@remote(num_gpus=1)
def card_k1_task(shape: tuple, tol_o: float, tol_lse: float) -> dict:
    """Phase 4h's GPU task: K1 at phase 2's shape in the task's worker,
    held against its plain version there; its launches and times."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import attention_with_lse_ref, flash_attention_fwd

    B, H, HKV, T, D = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, H, T, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, HKV, T, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, HKV, T, D), generator=g, device=dev).bfloat16()
    flash_attention_fwd.launches = 0
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    launches = flash_attention_fwd.launches
    o_ref, lse_ref = attention_with_lse_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    ms = cuda_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True))
    plain_ms = cuda_ms(torch, lambda: attention_with_lse_ref(q, k, v, causal=True), iters=3, warmup=1)
    sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True))
    return dict(err_o=err_o, err_lse=err_lse, launches=launches, ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                ok=err_o <= tol_o and err_lse <= tol_lse, visible=os.environ.get("CUDA_VISIBLE_DEVICES"))


@remote
def noop():
    return None


def median_us(fn, calls: int) -> float:
    """The median of ``calls`` sequential calls of ``fn``, in µs."""
    import statistics

    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def card_used(torch) -> int:
    """Bytes in use on the card, by every process (cudaMemGetInfo)."""
    free, total = torch.cuda.mem_get_info()
    return total - free


def runtime_on_card(torch, cfg, prompts, serve_run, drv_checksum, card, dev) -> dict:
    """Phase 4h: the port's runtime (``ray_tpu_torch.init``) with the card as
    a resource. Legs: (1) the GPU count; (2) a GPU actor serving phase 4's
    engine; (3) its streaming method; (4) a second card actor pending until
    the first is killed; (5) a restart after SIGKILL; (6) a GPU task
    running K1; (7) host costs; (8) shutdown leaves no worker, no rt
    segment and the card's memory as before. Every leg is gated."""
    import dataclasses

    import ray_tpu_torch as rtt
    from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager
    from ray_tpu_torch.core import context
    from ray_tpu_torch.core.object_ref import ObjectRef
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    torch.cuda.synchronize()
    used0 = card_used(torch)
    spec = {"config": dataclasses.asdict(cfg)}
    want_visible = GPUAcceleratorManager.worker_env_for_chips([0])["CUDA_VISIBLE_DEVICES"]
    out = {}
    t_phase = time.perf_counter()
    # (1) the runtime, with the card counted
    t0 = time.perf_counter()
    rt = rtt.init(num_cpus=4)
    total = rtt.cluster_resources()
    check(total.get("GPU") == torch.cuda.device_count(),
          f"phase 4h: cluster_resources GPU {total.get('GPU')} != torch.cuda.device_count() {torch.cuda.device_count()}")
    print(f"phase 4h init: {time.perf_counter() - t0:.3f} s, cluster_resources {total} {card}")
    try:
        # (2) a GPU actor serving phase 4's engine in its own worker
        flash_attention_fwd.launches = 0
        paged_attn_partials.launches = 0
        t0 = time.perf_counter()
        a = CardServer.remote(spec)
        fa = rtt.get(a.facts.remote(), timeout=600)
        ready_s = time.perf_counter() - t0
        check(fa["checksum"] == drv_checksum, f"phase 4h: the actor's weights checksum {fa['checksum']} != the "
                                               f"driver's {drv_checksum}")
        check(fa["visible"] == want_visible, f"phase 4h: the actor's CUDA_VISIBLE_DEVICES {fa['visible']!r} != "
                                             f"the assigned {want_visible!r}")
        check(fa["count"] == 1 and fa["pid"] != os.getpid(), f"phase 4h: the actor sees {fa['count']} cards in "
                                                             f"pid {fa['pid']}")
        run = rtt.get(a.generate.remote(prompts), timeout=600)
        same = sum(x == y for s1, s2 in zip(run["tokens"], serve_run["tokens"]) for x, y in zip(s1, s2))
        check(run["tokens"] == serve_run["tokens"], f"phase 4h: the GPU actor's tokens equal phase 4's in {same} of "
                                                    "256")
        check(run["k1"] == serve_run["k1"] and run["k4"] == serve_run["k4"],
              f"phase 4h: the actor's launches K1 {run['k1']} K4 {run['k4']} != phase 4's K1 {serve_run['k1']} K4 "
              f"{serve_run['k4']}")
        check(flash_attention_fwd.launches == 0 and paged_attn_partials.launches == 0,
              f"phase 4h: the driver's K1/K4 counts moved: {flash_attention_fwd.launches}, "
              f"{paged_attn_partials.launches}")
        kc = rtt.get(a.check_kernels.remote([len(p) for p in prompts]), timeout=600)
        k1c, k4c = kc["k1"], kc["k4"]
        check(k1c["ok"], f"phase 4h: K1 in the actor's worker at {k1c['shape']}: |do| {k1c['err_o']:.3g} (tol "
                         f"{K1_TOL_O}) |dlse| {k1c['err_lse']:.3g} (tol {K1_TOL_LSE})")
        check(k4c["ok"], f"phase 4h: K4 in the actor's worker at {k4c['shape']}: max |d| {k4c['err']:.3g}, relative "
                         f"{k4c['rel']:.3g} (tol {K4_TOL})")
        print(f"phase 4h GPU actor's kernels, held against their plain versions in its worker: K1 at its largest "
              f"prefill (B, H, Hkv, T, D) = {k1c['shape']}: |do| {k1c['err_o']:.3g} |dlse| {k1c['err_lse']:.3g}, "
              f"kernel {k1c['ms']:.4f} ms, plain {k1c['plain_ms']:.4f} ms, sdpa {k1c['sdpa_ms']:.4f} ms, bound "
              f"{k1c['bound_ms']:.4f} ms ({k1c['bound_by']}); K4 at its first decode step (B, kv, rep, T, hd) = "
              f"{k4c['shape']}, bounds the prompts' lengths: max |d| {k4c['err']:.3g} (rel {k4c['rel']:.3g}), kernel "
              f"{k4c['ms']:.4f} ms, plain {k4c['plain_ms']:.4f} ms, bound {k4c['bound_ms']:.4f} ms "
              f"({k4c['bound_by']}) {card}")
        direct_us = median_us(lambda: rtt.get(a.ping.remote(), timeout=60), RUNTIME_RTT_CALLS)
        client = context.get_client()

        def head_ping():
            ids = client.submit_actor_task(actor_id=a._actor_id, method_name="ping", args=[], kwargs={},
                                           num_returns=1, streaming=False, options={})
            rtt.get(ObjectRef(ids[0]), timeout=60)

        head_us = median_us(head_ping, RUNTIME_RTT_CALLS)
        out.update(k1_actor=run["k1"], k4_actor=run["k4"], k1_check=k1c, k4_check=k4c, ready_s=ready_s,
                   gen_wall_s=run["wall_s"],
                   direct_us=direct_us, head_us=head_us)
        print(f"phase 4h GPU actor (num_gpus=1, CUDA_VISIBLE_DEVICES={fa['visible']}, pid {fa['pid']}, "
              f"{fa['name']}): ready {ready_s:.3f} s after .remote() (its __init__ {fa['init_s']:.3f} s: CUDA "
              f"context, weights from seed 0, the paged graph engine), weights checksum equal to the driver's; "
              f"generate 8 x 32 greedy tokens {run['wall_s']:.3f} s wall vs phase 4's in-process "
              f"{serve_run['wall_s']:.3f} s, 256 of 256 tokens equal phase 4's, in the worker K1 {run['k1']} (= "
              f"{cfg.num_layers} x {run['prefill_forwards']} prefill forwards) and K4 {run['k4']} (= {cfg.num_layers} "
              f"x {run['decode_steps']} decode steps), the driver's K1 and K4 0; an empty method's round trip "
              f"{direct_us:.1f} us direct, {head_us:.1f} us through the head (medians of {RUNTIME_RTT_CALLS}) {card}")
        # (3) its streaming method
        t0 = time.perf_counter()
        streamed = {}
        for ref in a.stream.options(num_returns="streaming").remote(prompts):
            i, toks = rtt.get(ref, timeout=600)
            streamed[i] = toks
        check([streamed.get(i) for i in range(len(prompts))] == run["tokens"],
              f"phase 4h: the streamed tokens differ from leg 2's in "
              f"{sum(streamed.get(i) != t for i, t in enumerate(run['tokens']))} of 8 requests")
        print(f"phase 4h streaming method: 8 requests streamed in {time.perf_counter() - t0:.3f} s, each equal to "
              f"leg 2's stream {card}")
        # (4) the card as a resource: a second card actor waits for the first
        b = CardServer.remote(spec, build=False)
        b_ready = b.facts.remote()
        ready, _ = rtt.wait([b_ready], timeout=RUNTIME_PENDING_S)
        avail = rtt.available_resources().get("GPU", 0)
        check(ready == [] and avail == 0, f"phase 4h: the second card actor was not pending ({ready}), or GPU "
                                          f"available {avail} != 0")
        free_before = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        rtt.kill(a)
        fb = rtt.get(b_ready, timeout=600)
        swap_s = time.perf_counter() - t0
        free_after = torch.cuda.mem_get_info()[0]
        check(fb["visible"] == want_visible and fb["pid"] != fa["pid"], f"phase 4h: the second actor {fb}")
        print(f"phase 4h card as a resource: the second num_gpus=1 actor pending {RUNTIME_PENDING_S} s with GPU "
              f"available 0; ready {swap_s:.3f} s after kill() of the first (its process exited, its card released); "
              f"the card's free memory {free_before} bytes before the kill, {free_after} after {card}")
        rtt.kill(b)
        # (5) a restart: SIGKILL the worker of a max_restarts=1 actor
        t0 = time.perf_counter()
        c = CardServer.options(max_restarts=1).remote(spec)
        fc = rtt.get(c.facts.remote(), timeout=600)
        c_ready_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        os.kill(fc["pid"], signal.SIGKILL)
        fc2 = None
        while time.perf_counter() - t0 < 600:
            try:
                fc2 = rtt.get(c.facts.remote(), timeout=600)
            except rtt.exceptions.ActorDiedError:
                time.sleep(0.1)  # the call raced the death: the restart is under way
                continue
            if fc2["pid"] != fc["pid"]:
                break
        restart_s = time.perf_counter() - t0
        check(fc2 is not None and fc2["pid"] != fc["pid"] and fc2["checksum"] == drv_checksum,
              f"phase 4h: the actor did not restart with the weights: {fc2}")
        rerun = rtt.get(c.generate.remote(prompts), timeout=600)
        check(rerun["tokens"] == serve_run["tokens"], "phase 4h: the restarted actor's tokens differ from phase 4's")
        print(f"phase 4h restart: a max_restarts=1 card actor ready {c_ready_s:.3f} s after .remote(); its worker "
              f"(pid {fc['pid']}) SIGKILLed, the restarted actor (pid {fc2['pid']}) ready {restart_s:.3f} s later "
              f"(engine rebuilt), 256 of 256 tokens equal phase 4's {card}")
        rtt.kill(c)
        # (6) a GPU task running K1 at phase 2's shape in its worker
        t0 = time.perf_counter()
        task = rtt.get(card_k1_task.remote((2, 32, 8, 2048, 128), K1_TOL_O, K1_TOL_LSE), timeout=600)
        check(task["ok"], f"phase 4h: the GPU task's K1 |do| {task['err_o']:.3g} (tol {K1_TOL_O}) |dlse| "
                          f"{task['err_lse']:.3g} (tol {K1_TOL_LSE})")
        check(task["launches"] >= 1 and task["visible"] == want_visible, f"phase 4h: the GPU task {task}")
        out["task"] = task
        print(f"phase 4h GPU task (num_gpus=1): K1 B=2 H=32/8 T=2048 D=128 bf16 causal in its worker: |do| "
              f"{task['err_o']:.3g} |dlse| {task['err_lse']:.3g}, {task['launches']} launch, kernel {task['ms']:.4f} "
              f"ms vs plain {task['plain_ms']:.4f} ms, {time.perf_counter() - t0:.3f} s with the worker's start {card}")
        # (7) host costs
        rtt.get(noop.remote(), timeout=60)
        t0 = time.perf_counter()
        rtt.get([noop.remote() for _ in range(RUNTIME_TASKS)], timeout=600)
        tasks_s = RUNTIME_TASKS / (time.perf_counter() - t0)
        task_us = median_us(lambda: rtt.get(noop.remote(), timeout=60), RUNTIME_RTT_CALLS)
        host = torch.empty(RUNTIME_PUT_BYTES // 4, dtype=torch.float32).uniform_(generator=torch.Generator().manual_seed(0))
        t0 = time.perf_counter()
        ref = rtt.put(host)
        put_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = rtt.get(ref, timeout=600)
        get_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(back, host), "phase 4h: the 256 MiB tensor came back different")
        del back, ref, host
        boots = list(rt.worker_ready_s)
        later = sorted(boots[1:])
        out.update(tasks_s=tasks_s, task_us=task_us, put_ms=put_ms, get_ms=get_ms, boot_first_s=boots[0],
                   boot_later_s=later[len(later) // 2] if later else None)
        print(f"phase 4h host costs: {RUNTIME_TASKS} empty tasks {tasks_s:.1f} tasks/s; one task's round trip "
              f"{task_us:.1f} us (median of {RUNTIME_RTT_CALLS}); put of a {RUNTIME_PUT_BYTES >> 20} MiB host "
              f"tensor {put_ms:.2f} ms ({RUNTIME_PUT_BYTES / put_ms / 1e6:.2f} GB/s), get {get_ms:.2f} ms "
              f"({RUNTIME_PUT_BYTES / get_ms / 1e6:.2f} GB/s); worker boot: the first {boots[0]:.3f} s (the zygote's "
              f"start included), later ones median {out['boot_later_s']:.3f} s over {len(later)} {card}")
    finally:
        pids = [p for node in context.get_client().nodes.values() for p in node.worker_pids]
        t0 = time.perf_counter()
        rtt.shutdown()
        shutdown_s = time.perf_counter() - t0
    # (8) shutdown: no worker left, no rt segment, the card's memory back
    alive = []
    for p in pids:
        try:
            os.kill(p, 0)
            alive.append(p)
        except ProcessLookupError:
            pass
    check(not alive, f"phase 4h: worker processes left after shutdown(): {alive}")
    left = rt_segments()
    check(not left, f"phase 4h: /dev/shm still holds {left}")
    torch.cuda.synchronize()
    used1 = card_used(torch)
    check(abs(used1 - used0) <= RUNTIME_MEM_SLACK, f"phase 4h: the card's memory in use {used1} bytes after "
                                                   f"shutdown() vs {used0} before phase 4h")
    print(f"phase 4h shutdown: {shutdown_s:.3f} s, none of the {len(pids)} workers left, no rt segment, the card's "
          f"memory in use {used1} bytes vs {used0} before phase 4h; phase 4h {time.perf_counter() - t_phase:.1f} s "
          f"{card}")
    return out


# ---------------------------------------------------------------- phase 4k: the runtime across processes
PHASE4K_HEALTH = (0.5, 4)  # the phase's head: health_check_period_s, health_check_failure_threshold
PHASE4K_DETECT_SLACK_S = 5.0  # a dead agent's node marked dead within period x threshold + this
PHASE4K_DIED_S = 60.0  # calls to the dead agent's actor fail with ActorDiedError within this
PHASE4K_MEM_S = 120.0  # the card's memory back within this after a head or an agent is killed
PHASE4K_XFER_BYTES = 256 << 20  # (c): the host tensor a task on an shm-isolated node returns
PHASE4K_CHILD_S = 900  # a child process (an attached driver, a job, a head) ends within this
PHASE4K_SCRIPT = os.path.abspath(__file__)  # the script the children run in a sub-mode


@remote(num_cpus=0)
def host_block(nbytes: int, seed: int):
    """(c): ``nbytes`` seeded random bytes as a host tensor, made on the
    node the task runs on (its own shm namespace)."""
    import torch

    return torch.randint(0, 256, (nbytes,), dtype=torch.uint8, generator=torch.Generator().manual_seed(seed))


def proc_state(pid: int) -> str:
    """``pid``'s state letter from /proc (R, S, D, Z, ...), "-" when it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError):
        return "-"


def process_runs(pid: int) -> bool:
    """``pid`` runs: a zombie has exited (phase 4k's orphans, whose parent
    died first, may wait for a reaper that never comes in a container
    whose first process reaps none)."""
    return proc_state(pid) not in ("Z", "-")


def _ppid(pid: int) -> int:
    with open(f"/proc/{pid}/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[1])


def _phase4k_ref(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _emit(tag: str, obj: dict):
    print(f"{tag} {json.dumps(obj)}", flush=True)


def _child_lines(text: str, tag: str) -> dict:
    """The JSON a child printed after ``tag`` (its last such line)."""
    lines = [ln for ln in text.splitlines() if ln.startswith(tag + " ")]
    check(bool(lines), f"phase 4k: no {tag} line in the child's output:\n{text[-4000:]}")
    return json.loads(lines[-1][len(tag) + 1:])


def phase4k_attached(ref_path: str, tag: str) -> int:
    """--phase4k-driver and --phase4k-job: attach to the running head
    (``init(address="auto")``, or the job's ``RT_HEAD_ADDRESS`` through a
    plain ``init()``), get (a)'s actor by name, generate phase 4's prompts
    and print the result after ``tag``."""
    import ray_tpu_torch as rtt

    ref = _phase4k_ref(ref_path)
    t0 = time.perf_counter()
    client = rtt.init(address="auto") if tag == "PHASE4K_DRIVER" else rtt.init()
    attach_s = time.perf_counter() - t0
    try:
        a = rtt.get_actor("phase4k_engine")
        run = rtt.get(a.generate.remote(ref["prompts"]), timeout=600)
        _emit(tag, dict(attach_s=attach_s, attached=type(client).__name__, tokens=run["tokens"], k1=run["k1"],
                        k4=run["k4"], wall_s=run["wall_s"], head_address=os.environ.get("RT_HEAD_ADDRESS")))
    finally:
        rtt.shutdown()
    return 0


def phase4k_driver(ref_path: str) -> int:
    return phase4k_attached(ref_path, "PHASE4K_DRIVER")


def phase4k_job(ref_path: str) -> int:
    return phase4k_attached(ref_path, "PHASE4K_JOB")


def phase4k_head1(ref_path: str, log_path: str) -> int:
    """--phase4k-head1: a head on the persistent GCS at ``log_path``: a
    detached named num_gpus=1 engine actor, its tokens, a KV key and a job;
    then SIGKILL of this process (no shutdown)."""
    import ray_tpu_torch as rtt
    from ray_tpu_torch.core import context
    from ray_tpu_torch.job import JobManager, JobStatus

    ref = _phase4k_ref(ref_path)
    rtt.init(num_cpus=2, _system_config={"gcs_persist_path": log_path})
    client = context.get_client()
    a = CardServer.options(name="phase4k_ft", lifetime="detached").remote(ref["spec"])
    fa = rtt.get(a.facts.remote(), timeout=600)
    run = rtt.get(a.generate.remote(ref["prompts"]), timeout=600)
    client.gcs.kv.put(b"phase4k", b"survives the head")
    jm = JobManager(client)
    jid = jm.submit_job(entrypoint="echo phase4k-job", submission_id="phase4k_job")
    status = jm.wait_until_finished(jid, timeout=120)
    _emit("PHASE4K_HEAD1", dict(tokens_equal=run["tokens"] == ref["tokens"], checksum=fa["checksum"],
                                actor_pid=fa["pid"], job=status == JobStatus.SUCCEEDED, pid=os.getpid(),
                                k1=run["k1"], k4=run["k4"]))
    os.kill(os.getpid(), signal.SIGKILL)
    return 1


def phase4k_head2(ref_path: str, log_path: str) -> int:
    """--phase4k-head2: a head on the killed head's log: the KV key, the
    job, and the detached actor re-created under its name; its tokens."""
    import ray_tpu_torch as rtt
    from ray_tpu_torch.core import context

    ref = _phase4k_ref(ref_path)
    t0 = time.perf_counter()
    rtt.init(num_cpus=2, _system_config={"gcs_persist_path": log_path})
    init_s = time.perf_counter() - t0
    client = context.get_client()
    try:
        kv = client.gcs.kv.get(b"phase4k")
        jobs = {str(k): v for k, v in ((k, client.gcs.kv.get(k, namespace="_jobs"))
                                       for k in client.gcs.kv.keys(namespace="_jobs"))}
        job = next((v for k, v in jobs.items() if "phase4k_job" in k), None)
        a = rtt.get_actor("phase4k_ft")
        fa = rtt.get(a.facts.remote(), timeout=600)
        ready_s = time.perf_counter() - t0
        run = rtt.get(a.generate.remote(ref["prompts"]), timeout=600)
        first_s = time.perf_counter() - t0
        rehydrated = client.gcs.events.query(kind="actor_rehydrated")
        _emit("PHASE4K_HEAD2", dict(kv=kv.decode() if kv else None, job_status=(job or {}).get("status"),
                                    tokens=run["tokens"], k1=run["k1"], k4=run["k4"], checksum=fa["checksum"],
                                    actor_id=a._actor_id.hex(), init_s=init_s, ready_s=ready_s, first_s=first_s,
                                    rehydrated=len(rehydrated), actor_pid=fa["pid"]))
        rtt.kill(a)
    finally:
        rtt.shutdown()
    return 0


PHASE4K_MODES = {"--phase4k-driver": phase4k_driver, "--phase4k-job": phase4k_job,
                 "--phase4k-head1": phase4k_head1, "--phase4k-head2": phase4k_head2}


def _run_child(args: list, label: str, env: dict | None = None):
    """This script in a sub-mode, in a process of its own, within
    PHASE4K_CHILD_S; (return code, output)."""
    p = subprocess.run([sys.executable, PHASE4K_SCRIPT, *args], capture_output=True, text=True,
                       timeout=PHASE4K_CHILD_S, env={**os.environ, **(env or {})})
    if p.returncode not in (0, -signal.SIGKILL):
        print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
    return p.returncode, p.stdout + p.stderr


def _wait_mem(torch, level: int, within: float) -> float | None:
    """Seconds until the card's memory in use is back to ``level`` (plus
    RUNTIME_MEM_SLACK), None past ``within``."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < within:
        if card_used(torch) <= level + RUNTIME_MEM_SLACK:
            return time.perf_counter() - t0
        time.sleep(0.1)
    return None


def agents_on_card(torch, cfg, prompts, serve_run, drv_checksum, card, dev) -> dict:
    """Phase 4k: the runtime across processes on the card (the module
    docstring's (a)-(f)). Every leg is gated."""
    import dataclasses
    import shutil
    import tempfile

    import ray_tpu_torch as rtt
    from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager
    from ray_tpu_torch.core import context, transport
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    t_phase = time.perf_counter()
    ref = serve_run["tokens"]
    spec = {"config": dataclasses.asdict(cfg)}
    want_visible = GPUAcceleratorManager.worker_env_for_chips([0])["CUDA_VISIBLE_DEVICES"]
    tmp = tempfile.mkdtemp(prefix="phase4k_")
    ref_path = os.path.join(tmp, "ref.json")
    with open(ref_path, "w") as f:
        json.dump(dict(prompts=[[int(t) for t in p] for p in prompts], tokens=ref, spec=spec), f)
    torch.cuda.synchronize()
    used0 = card_used(torch)
    out = {}
    period, threshold = PHASE4K_HEALTH
    agents, pids = [], []
    try:
        # (a) a GPU actor on an agent's node
        rt = rtt.init(num_cpus=4, num_gpus=0, _system_config={"health_check_period_s": period,
                                                              "health_check_failure_threshold": threshold})
        check("GPU" not in rtt.cluster_resources(), f"phase 4k: the head counts a card: {rtt.cluster_resources()}")
        t0 = time.perf_counter()
        node = rt.add_node({"CPU": 2, "GPU": 1})
        boot_s = time.perf_counter() - t0
        agents.append(node.agent_proc)
        total = rtt.cluster_resources()
        check(total.get("GPU") == 1, f"phase 4k (a): cluster_resources GPU {total.get('GPU')} != 1")
        used_agent = card_used(torch)
        check(used_agent <= used0 + RUNTIME_MEM_SLACK, f"phase 4k (a): the card's memory in use {used_agent} after "
                                                      f"add_node vs {used0} before: the agent holds a CUDA context")
        drv_counts = (flash_attention_fwd.launches, paged_attn_partials.launches)
        t0 = time.perf_counter()
        a = CardServer.options(name="phase4k_engine", lifetime="detached").remote(spec)
        fa = rtt.get(a.facts.remote(), timeout=600)
        ready_s = time.perf_counter() - t0
        pids += node.worker_pids
        zygote = _ppid(fa["pid"])
        check(fa["pid"] in node.worker_pids and _ppid(zygote) == node.agent_proc.pid,
              f"phase 4k (a): the actor's worker {fa['pid']} (parent {zygote}) is not the agent's "
              f"({node.agent_proc.pid}, workers {node.worker_pids})")
        check(fa["visible"] == want_visible and fa["count"] == 1 and fa["checksum"] == drv_checksum,
              f"phase 4k (a): the actor's CUDA_VISIBLE_DEVICES {fa['visible']!r}, {fa['count']} cards, checksum "
              f"{fa['checksum']} vs {drv_checksum}")
        run = rtt.get(a.generate.remote(prompts), timeout=600)
        same = sum(x == y for s1, s2 in zip(run["tokens"], ref) for x, y in zip(s1, s2))
        check(run["tokens"] == ref, f"phase 4k (a): the agent-node actor's tokens equal phase 4's in {same} of 256")
        check((run["k1"], run["k4"]) == (serve_run["k1"], serve_run["k4"]),
              f"phase 4k (a): the actor's K1/K4 {run['k1']}/{run['k4']} != phase 4's "
              f"{serve_run['k1']}/{serve_run['k4']}")
        check((flash_attention_fwd.launches, paged_attn_partials.launches) == drv_counts,
              "phase 4k (a): the driver's K1/K4 counts moved")
        kc = rtt.get(a.check_kernels.remote([len(p) for p in prompts]), timeout=600)
        check(kc["k1"]["ok"], f"phase 4k (a): K1 in the agent-node worker at {kc['k1']['shape']}: |do| "
                              f"{kc['k1']['err_o']:.3g} |dlse| {kc['k1']['err_lse']:.3g}")
        check(kc["k4"]["ok"], f"phase 4k (a): K4 in the agent-node worker at {kc['k4']['shape']}: max |d| "
                              f"{kc['k4']['err']:.3g} (rel {kc['k4']['rel']:.3g})")
        out["a"] = dict(k1=run["k1"], k4=run["k4"], check=kc, boot_s=boot_s, ready_s=ready_s)
        print(f"phase 4k (a) GPU actor on an agent's node: the head with no card, add_node(remote=True, GPU 1) "
              f"{boot_s:.3f} s (the agent's boot; cluster_resources GPU {total.get('GPU')}; the card's memory in use "
              f"{used_agent} bytes after it vs {used0} before: no CUDA context in the agent); the detached named "
              f"num_gpus=1 actor's worker pid {fa['pid']} forked by the agent's zygote {zygote} (agent pid "
              f"{node.agent_proc.pid}), CUDA_VISIBLE_DEVICES={fa['visible']}, ready {ready_s:.3f} s; 256 of 256 "
              f"tokens equal phase 4's, K1 {run['k1']} K4 {run['k4']} in the worker (= phase 4's), the driver's "
              f"unmoved; held there: K1 at {kc['k1']['shape']} |do| {kc['k1']['err_o']:.3g} |dlse| "
              f"{kc['k1']['err_lse']:.3g} kernel {kc['k1']['ms']:.4f} ms plain {kc['k1']['plain_ms']:.4f} ms sdpa "
              f"{kc['k1']['sdpa_ms']:.4f} ms bound {kc['k1']['bound_ms']:.4f} ms; K4 at {kc['k4']['shape']} max |d| "
              f"{kc['k4']['err']:.3g} kernel {kc['k4']['ms']:.4f} ms plain {kc['k4']['plain_ms']:.4f} ms bound "
              f"{kc['k4']['bound_ms']:.4f} ms {card}")
        # (b) an attached driver, then a submitted job
        rc, text = _run_child(["--phase4k-driver", ref_path], "driver")
        drv = _child_lines(text, "PHASE4K_DRIVER")
        check(rc == 0 and drv["tokens"] == ref and drv["attached"] == "DriverClient",
              f"phase 4k (b): the attached driver (rc {rc}, {drv['attached']}): its tokens differ from phase 4's")
        check((drv["k1"], drv["k4"]) == (serve_run["k1"], serve_run["k4"]),
              f"phase 4k (b): the attached driver's generate ran K1/K4 {drv['k1']}/{drv['k4']} in the actor's worker, "
              f"not phase 4's {serve_run['k1']}/{serve_run['k4']}")
        out["driver"] = dict(k1=drv["k1"], k4=drv["k4"], attach_s=drv["attach_s"])
        jc = JobSubmissionClient()
        t0 = time.perf_counter()
        jid = jc.submit_job(entrypoint=f"{sys.executable} {PHASE4K_SCRIPT} --phase4k-job {ref_path}")
        status = jc._mgr.wait_until_finished(jid, timeout=PHASE4K_CHILD_S)
        job_s = time.perf_counter() - t0
        logs = jc.get_job_logs(jid)
        check(status == JobStatus.SUCCEEDED, f"phase 4k (b): the job ended {status}:\n{logs[-4000:]}")
        job = _child_lines(logs, "PHASE4K_JOB")
        check(job["tokens"] == ref and job["attached"] == "DriverClient" and job["head_address"],
              f"phase 4k (b): the job ({job['attached']}, RT_HEAD_ADDRESS {job['head_address']}): its tokens differ "
              "from phase 4's")
        check((job["k1"], job["k4"]) == (serve_run["k1"], serve_run["k4"]),
              f"phase 4k (b): the job's generate ran K1/K4 {job['k1']}/{job['k4']} in the actor's worker, not phase "
              f"4's {serve_run['k1']}/{serve_run['k4']}")
        out["job"] = dict(k1=job["k1"], k4=job["k4"], job_s=job_s)
        print(f"phase 4k (b) attached driver: init(address='auto') {drv['attach_s']:.3f} s, get_actor by name, 256 of "
              f"256 tokens equal phase 4's ({drv['wall_s']:.3f} s), K1 {drv['k1']} K4 {drv['k4']}; job through "
              f"JobSubmissionClient: plain init() attached through RT_HEAD_ADDRESS={job['head_address']} in "
              f"{job['attach_s']:.3f} s, SUCCEEDED {job_s:.3f} s after submit_job, its log holds 256 of 256 tokens "
              f"equal phase 4's, K1 {job['k1']} K4 {job['k4']} (= phase 4's) {card}")
        # (c) a 256 MiB host tensor across shm namespaces, then onto the card
        iso = rt.add_node({"CPU": 2, "iso": 1}, shm_isolation=True)
        agents.append(iso.agent_proc)
        transport.reset_stats()
        r = host_block.options(resources={"iso": 1}).remote(PHASE4K_XFER_BYTES, 4)
        rtt.wait([r], timeout=600)
        t0 = time.perf_counter()
        x = rtt.get(r, timeout=600)
        pull_s = time.perf_counter() - t0
        stats = dict(transport.STATS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xc = x.to(dev)
        torch.cuda.synchronize()
        up_s = time.perf_counter() - t0
        want = torch.randint(0, 256, (PHASE4K_XFER_BYTES,), dtype=torch.uint8,
                             generator=torch.Generator().manual_seed(4))
        check(stats["pulls"] >= 1 and stats["pull_bytes"] >= PHASE4K_XFER_BYTES,
              f"phase 4k (c): the tensor did not cross the transfer server: {stats}")
        check(torch.equal(xc.cpu(), want), "phase 4k (c): the bytes on the card differ from the task's")
        pull_gbs, up_gbs = PHASE4K_XFER_BYTES / pull_s / 1e9, PHASE4K_XFER_BYTES / up_s / 1e9
        out["c"] = dict(pull_s=pull_s, up_s=up_s, pull_gbs=pull_gbs, up_gbs=up_gbs, stats=stats)
        print(f"phase 4k (c) cross-namespace transfer: a task on the shm_isolation node (ns {iso.shm_ns}) returned "
              f"{PHASE4K_XFER_BYTES >> 20} MiB; the driver's get pulled it over the transfer server in {pull_s:.3f} s "
              f"({pull_gbs:.3f} GB/s; {stats['pulls']} pull, {stats['pull_bytes']} bytes, warm page cache), the "
              f"upload to the card {up_s:.3f} s ({up_gbs:.3f} GB/s, pageable), the bytes equal {card}")
        del x, xc, want, r
        torch.cuda.empty_cache()  # the upload's block: (d) and (e) compare the card's memory in use with before
        # the iso node's agent stops: its socket stays open, so only the health loop can declare the node dead
        t0 = time.perf_counter()
        os.kill(iso.agent_proc.pid, signal.SIGSTOP)
        while iso.alive and time.perf_counter() - t0 < period * threshold + PHASE4K_DETECT_SLACK_S:
            time.sleep(0.01)
        health_s = time.perf_counter() - t0
        os.kill(iso.agent_proc.pid, signal.SIGKILL)  # the removal waits for the stopped agent
        # threshold - 1 periods pass after the last pong at least; one period less for the loop's own timing
        check(not iso.alive and period * (threshold - 2) <= health_s,
              f"phase 4k (c): the stopped agent's node {'dead' if not iso.alive else 'alive'} {health_s:.3f} s after "
              f"its SIGSTOP (the health loop: between {period} x {threshold - 2} s and {period} x {threshold} + "
              f"{PHASE4K_DETECT_SLACK_S} s)")
        check(node.alive, "phase 4k (c): (a)'s node was declared dead with the stopped one")
        out["c"]["health_s"] = health_s
        print(f"phase 4k (c) the shm_isolation node's agent stopped (SIGSTOP): the health loop marked its node dead "
              f"{health_s:.3f} s later (period {period} s x threshold {threshold}; bound {period} x {threshold - 2} to "
              f"{period} x {threshold} + {PHASE4K_DETECT_SLACK_S} s), (a)'s node alive {card}")
        # (d) the persistent GCS: a head killed with SIGKILL, a second head on its log
        log_path = os.path.join(tmp, "gcs.log")
        torch.cuda.synchronize()
        used_d = card_used(torch)
        rc1, text1 = _run_child(["--phase4k-head1", ref_path, log_path], "head1")
        h1 = _child_lines(text1, "PHASE4K_HEAD1")
        check(rc1 == -signal.SIGKILL and h1["tokens_equal"] and h1["job"] and h1["checksum"] == drv_checksum,
              f"phase 4k (d): the first head (rc {rc1}): {h1}")
        back_s = _wait_mem(torch, used_d, PHASE4K_MEM_S)
        check(back_s is not None and not process_runs(h1["actor_pid"]),
              f"phase 4k (d): {PHASE4K_MEM_S} s after the head's SIGKILL, the card's memory in use "
              f"{card_used(torch)} vs {used_d} before it, its actor's worker alive {process_runs(h1['actor_pid'])}")
        left = [n for n in rt_segments() if n.startswith(f"rt{h1['pid']}")]
        print(f"phase 4k (d) first head (pid {h1['pid']}, gcs_persist_path): a detached named num_gpus=1 engine "
              f"actor, 256 of 256 tokens equal phase 4's, a KV key, a job SUCCEEDED, then SIGKILL; the card's memory "
              f"back {back_s:.3f} s later (its actor's worker {h1['actor_pid']} gone); the killed head's /dev/shm "
              f"segments: {left} {card}")
        rc2, text2 = _run_child(["--phase4k-head2", ref_path, log_path], "head2")
        h2 = _child_lines(text2, "PHASE4K_HEAD2")
        check(rc2 == 0 and h2["kv"] == "survives the head" and h2["job_status"] == JobStatus.SUCCEEDED,
              f"phase 4k (d): the second head (rc {rc2}) shows the KV key {h2['kv']!r}, the job {h2['job_status']}")
        check(h2["tokens"] == ref and h2["checksum"] == drv_checksum and h2["rehydrated"] == 1,
              f"phase 4k (d): the re-created actor ({h2['rehydrated']} rehydrated): its tokens differ from phase 4's")
        check((h2["k1"], h2["k4"]) == (serve_run["k1"], serve_run["k4"]),
              f"phase 4k (d): the re-created actor's K1/K4 {h2['k1']}/{h2['k4']} != phase 4's "
              f"{serve_run['k1']}/{serve_run['k4']}")
        for n in left:
            os.unlink(os.path.join("/dev/shm", n))
        out["d"] = dict(k1=h2["k1"], k4=h2["k4"], back_s=back_s, ready_s=h2["ready_s"], first_s=h2["first_s"])
        print(f"phase 4k (d) second head on the same log: the KV key and the job (SUCCEEDED) are there; the "
              f"detached actor re-created under its name (init {h2['init_s']:.3f} s, ready {h2['ready_s']:.3f} s, "
              f"generate done {h2['first_s']:.3f} s after init began), 256 of 256 tokens equal phase 4's, K1 "
              f"{h2['k1']} K4 {h2['k4']} (= phase 4's); the killed head's {len(left)} segments removed {card}")
        # (e) the agent that holds (a)'s actor dies
        t0 = time.perf_counter()
        os.kill(node.agent_proc.pid, signal.SIGKILL)
        while node.alive and time.perf_counter() - t0 < period * threshold + PHASE4K_DETECT_SLACK_S:
            time.sleep(0.01)
        detect_s = time.perf_counter() - t0
        check(not node.alive, f"phase 4k (e): the node not marked dead from its agent's end of file {detect_s:.3f} s "
                              f"after the SIGKILL (bound {period} x {threshold} + {PHASE4K_DETECT_SLACK_S} s)")
        died = None
        while died is None and time.perf_counter() - t0 < PHASE4K_DIED_S:
            try:
                rtt.get(a.ping.remote(), timeout=PHASE4K_DIED_S)
            except rtt.exceptions.ActorDiedError:
                died = time.perf_counter() - t0
            except rtt.exceptions.GetTimeoutError:
                break
        check(died is not None, f"phase 4k (e): calls to the dead agent's actor did not fail with ActorDiedError "
                                f"within {PHASE4K_DIED_S} s")
        mem_s = _wait_mem(torch, used0, PHASE4K_MEM_S)
        check(mem_s is not None and not process_runs(fa["pid"]),
              f"phase 4k (e): the card's memory in use {card_used(torch)} vs {used0} {PHASE4K_MEM_S} s after the "
              f"agent's SIGKILL, its worker alive {process_runs(fa['pid'])}")
        out["e"] = dict(detect_s=detect_s, died_s=died, mem_s=mem_s)
        print(f"phase 4k (e) agent SIGKILL: the node marked dead from its socket's end of file {detect_s:.3f} s later "
              f"(bound {period} x {threshold} + {PHASE4K_DETECT_SLACK_S} s), a call to its actor raised ActorDiedError {died:.3f} s after the kill, "
              f"the card's memory back {mem_s:.3f} s after it (its worker gone) {card}")
    finally:
        client = context.maybe_client()
        if client is not None:
            pids += [p for n in client.nodes.values() for p in n.worker_pids]
        t0 = time.perf_counter()
        rtt.shutdown()
        shutdown_s = time.perf_counter() - t0
        shutil.rmtree(tmp, ignore_errors=True)
    # (f) nothing left
    alive = [p for p in set(pids) if process_runs(p)]
    live_agents = [p.pid for p in agents if p.poll() is None]
    check(not alive and not live_agents, f"phase 4k (f): after shutdown() workers {alive}, agents {live_agents}")
    left = rt_segments()
    check(not left, f"phase 4k (f): /dev/shm still holds {left}")
    mem_s = _wait_mem(torch, used0, PHASE4K_MEM_S)
    check(mem_s is not None, f"phase 4k (f): the card's memory in use {card_used(torch)} after shutdown() vs {used0}")
    total_s = time.perf_counter() - t_phase
    out["total_s"] = total_s
    print(f"phase 4k (f) shutdown {shutdown_s:.3f} s: no agent, none of the {len(set(pids))} workers, no rt segment "
          f"left, the card's memory in use back to {used0} bytes; costs: agent boot {out['a']['boot_s']:.3f} s, "
          f"attach {out['driver']['attach_s']:.3f} s, job start to SUCCEEDED {out['job']['job_s']:.3f} s, "
          f"re-created actor to its tokens {out['d']['first_s']:.3f} s, dead node detected by the health loop "
          f"{out['c']['health_s']:.3f} s and from end of file {out['e']['detect_s']:.3f} s; phase 4k {total_s:.1f} s "
          f"{card}")
    return out


# ---------------------------------------------------------------- phase 4i: Serve on the card
SERVE_TIMEOUT_S = 600  # a replica's start (weights from seed 0, graph capture, prewarm) and each request
# the replicas' engine: phase 4's (prefix caching on only in (d)), weights from seed 0
SERVE_ENGINE_KWARGS = dict(max_num_seqs=8, kv_layout="paged", page_size=64, enable_prefix_caching=False, seed=0)


class _CardReplica:
    """Phase 4i's additions to a serve replica, run in its worker: the
    weights' checksum with the worker's card, the worker's launch counts,
    and K1 and K4 held against their plain versions there."""

    def __init__(self, *args, **kwargs):
        t0 = time.perf_counter()
        super().__init__(*args, **kwargs)
        self.init_s = time.perf_counter() - t0
        self._base = (0, 0, 0)

    def weights_checksum(self) -> dict:
        import torch

        return dict(checksum=weights_checksum(self.engine.params), visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                    count=torch.cuda.device_count(), pid=os.getpid(), init_s=self.init_s,
                    device=str(self.engine.device))

    def kernel_counts(self, reset: bool = False) -> dict:
        """K1's and K4's launches in this worker and the engine's forwards
        since the last reset; ``reset`` zeroes them first."""
        from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
        from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

        eng = self.engine
        if reset:
            flash_attention_fwd.launches = 0
            paged_attn_partials.launches = 0
            self._base = (eng.prefill_forwards, eng.decode_steps, eng.extend_forwards)
        p0, d0, e0 = self._base
        return dict(k1=flash_attention_fwd.launches, k4=paged_attn_partials.launches,
                    prefill_forwards=eng.prefill_forwards - p0, decode_steps=eng.decode_steps - d0,
                    extend_forwards=eng.extend_forwards - e0)

    def check_kernels(self, lens) -> dict:
        return hold_kernels(self.engine, lens)

    def check_extend(self, start, suffix_lens) -> dict:
        return hold_k4_extend(self.engine, start, suffix_lens)


class CardLLMServer(_CardReplica, LLMServer):
    pass


class CardOpenAIServer(_CardReplica, OpenAIServer):
    pass


class CardPrefillServer(_CardReplica, PrefillServer):
    pass


class CardDecodeServer(_CardReplica, DecodeServer):
    pass


class CardKVPlaneServer(_CardReplica, KVPlaneServer):
    pass


def worker_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def serve_on_card(torch, cfg, prompts, serve_run, drv_checksum, leader, followers, hit_firsts, card) -> dict:
    """Phase 4i: Serve over the port's runtime on the card. Legs: (a) a GPU
    replica of build_llm_deployment; (b) build_openai_app behind the
    asyncio HTTP proxy; (c) build_pd_disagg_deployment, both engines on the
    one card; (d) build_kvplane_deployment, two replicas; then shutdown
    leaves no worker, no rt segment and the card's memory as before.
    Every leg is gated."""
    import http.client

    import ray_tpu_torch as rtt
    from ray_tpu_torch import serve
    from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager
    from ray_tpu_torch.core import context
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.serve.llm import (LLMConfig, build_kvplane_deployment, build_llm_deployment, build_openai_app,
                                         build_pd_disagg_deployment)

    L, n = cfg.num_layers, len(prompts)
    torch.cuda.synchronize()
    used0 = card_used(torch)
    want_visible = GPUAcceleratorManager.worker_env_for_chips([0])["CUDA_VISIBLE_DEVICES"]
    ek = dict(SERVE_ENGINE_KWARGS)
    ref = serve_run["tokens"]
    out = {}
    t_phase = time.perf_counter()
    rtt.init(num_cpus=8)
    flash_attention_fwd.launches = 0
    paged_attn_partials.launches = 0

    def card_back(pid, label):
        """The card's "GPU" back after ``serve.delete``, and only once the
        replica's worker has exited."""
        deadline = time.perf_counter() + SERVE_TIMEOUT_S
        while rtt.available_resources().get("GPU", 0) < 1 and time.perf_counter() < deadline:
            time.sleep(0.05)
        back = rtt.available_resources().get("GPU", 0)
        check(back == 1 and not worker_alive(pid), f"phase 4i {label}: GPU available {back} after delete, the "
                                                   f"replica's worker {pid} alive {worker_alive(pid)}")

    try:
        # (a) a GPU replica of the LLM deployment
        t0 = time.perf_counter()
        h = serve.run(build_llm_deployment(LLMConfig(model_config=cfg, engine_kwargs=ek, num_tpus_per_replica=1),
                                           _cls={LLMServer: CardLLMServer}),
                      name="llm", blocking_timeout_s=SERVE_TIMEOUT_S)
        up_a = time.perf_counter() - t0
        fa = h.weights_checksum.remote().result(timeout_s=SERVE_TIMEOUT_S)
        held = rtt.available_resources().get("GPU", 0)
        check(fa["checksum"] == drv_checksum, f"phase 4i (a): the replica's weights checksum {fa['checksum']} != "
                                              f"phase 4's {drv_checksum}")
        check(fa["visible"] == want_visible and fa["count"] == 1 and fa["pid"] != os.getpid(),
              f"phase 4i (a): the replica's worker sees CUDA_VISIBLE_DEVICES {fa['visible']!r} ({fa['count']} cards) "
              f"in pid {fa['pid']}, not {want_visible!r}")
        check(held == 0, f"phase 4i (a): GPU available {held} while the replica lives")
        h.kernel_counts.remote(True).result(timeout_s=SERVE_TIMEOUT_S)
        t0 = time.perf_counter()
        outs = [r.result(timeout_s=SERVE_TIMEOUT_S) for r in [h.generate.remote(p, {"max_tokens": 32}) for p in prompts]]
        wall_a = time.perf_counter() - t0
        ka = h.kernel_counts.remote().result(timeout_s=SERVE_TIMEOUT_S)
        ov = h.overload_stats.remote().result(timeout_s=SERVE_TIMEOUT_S)
        toks = [o["token_ids"] for o in outs]
        check(all(len(t) == 32 and o["finish_reason"] == "length" for t, o in zip(toks, outs)),
              f"phase 4i (a): not every request finished with 32 tokens: "
              f"{[(len(o['token_ids']), o['finish_reason']) for o in outs]}")
        firsts = sum(t[0] == r[0] for t, r in zip(toks, ref))
        check(firsts == n, f"phase 4i (a): first tokens equal phase 4's in {firsts} of {n}")
        check(ka["k1"] == L * ka["prefill_forwards"] > 0 and ka["k4"] == L * ka["decode_steps"] > 0,
              f"phase 4i (a): in the replica's worker K1 {ka['k1']} != {L} x {ka['prefill_forwards']} prefill "
              f"forwards or K4 {ka['k4']} != {L} x {ka['decode_steps']} decode steps")
        check(flash_attention_fwd.launches == 0 and paged_attn_partials.launches == 0,
              f"phase 4i (a): the driver's K1/K4 counts moved: {flash_attention_fwd.launches}, "
              f"{paged_attn_partials.launches}")
        shed = sum(v for k, v in ov.items() if k.startswith("shed_") and isinstance(v, int))
        check(ov["admitted"] == n and shed == 0, f"phase 4i (a): overload_stats {ov}")
        same = sum(x == y for s1, s2 in zip(toks, ref) for x, y in zip(s1, s2))
        kc = h.check_kernels.remote([len(p) for p in prompts]).result(timeout_s=SERVE_TIMEOUT_S)
        k1c, k4c = kc["k1"], kc["k4"]
        check(k1c["ok"], f"phase 4i (a): K1 in the replica's worker at {k1c['shape']}: |do| {k1c['err_o']:.3g} "
                         f"(tol {K1_TOL_O}) |dlse| {k1c['err_lse']:.3g} (tol {K1_TOL_LSE})")
        check(k4c["ok"], f"phase 4i (a): K4 in the replica's worker at {k4c['shape']}: max |d| {k4c['err']:.3g}, "
                         f"relative {k4c['rel']:.3g} (tol {K4_TOL})")
        print(f"phase 4i (a) the replica's kernels, held against their plain versions in its worker: K1 at "
              f"{k1c['shape']}: |do| {k1c['err_o']:.3g} |dlse| {k1c['err_lse']:.3g}, kernel {k1c['ms']:.4f} ms, "
              f"plain {k1c['plain_ms']:.4f} ms, sdpa {k1c['sdpa_ms']:.4f} ms, bound {k1c['bound_ms']:.4f} ms "
              f"({k1c['bound_by']}); K4 at {k4c['shape']}: max |d| {k4c['err']:.3g} (rel {k4c['rel']:.3g}), "
              f"kernel {k4c['ms']:.4f} ms, plain {k4c['plain_ms']:.4f} ms, bound {k4c['bound_ms']:.4f} ms "
              f"({k4c['bound_by']}) {card}")
        out.update(a=dict(up_s=up_a, init_s=fa["init_s"], wall_s=wall_a, counts=ka, check=kc, same=same))
        print(f"phase 4i (a) GPU replica (build_llm_deployment, num_tpus_per_replica=1, CUDA_VISIBLE_DEVICES="
              f"{fa['visible']}, pid {fa['pid']}): RUNNING {up_a:.3f} s after serve.run (its __init__ {fa['init_s']:.3f} "
              f"s: weights from seed 0, the paged graph engine, prewarm), GPU available 0 while it lives, weights "
              f"checksum equal to phase 4's; 8 concurrent handle.generate x 32 greedy tokens {wall_a:.3f} s wall vs "
              f"phase 4's in-process {serve_run['wall_s']:.3f} s; 8 of 8 finished (length), first tokens 8 of 8 equal "
              f"phase 4's, {same} of 256 tokens equal phase 4's graph streams (not gated: other prefill waves); in "
              f"the worker K1 {ka['k1']} (= {L} x {ka['prefill_forwards']} prefill forwards), K4 {ka['k4']} (= {L} x "
              f"{ka['decode_steps']} decode steps), the driver's K1 and K4 0; overload_stats admitted "
              f"{ov['admitted']}, shed {shed} {card}")
        serve.delete("llm")
        card_back(fa["pid"], "(a)")
        # (b) the OpenAI app behind the asyncio HTTP proxy
        serve.start(serve.HTTPOptions(port=0), proxy=True)
        port = serve.api._http_proxy.port
        t0 = time.perf_counter()
        ho = serve.run(build_openai_app(LLMConfig(model_config=cfg, engine_kwargs=ek, num_tpus_per_replica=1),
                                        _cls={OpenAIServer: CardOpenAIServer}),
                       name="openai", route_prefix="/v1", blocking_timeout_s=SERVE_TIMEOUT_S)
        up_b = time.perf_counter() - t0
        fb = ho.weights_checksum.remote().result(timeout_s=SERVE_TIMEOUT_S)
        check(fb["checksum"] == drv_checksum and fb["visible"] == want_visible, f"phase 4i (b): the replica {fb}")
        ho.kernel_counts.remote(True).result(timeout_s=SERVE_TIMEOUT_S)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVE_TIMEOUT_S)

        def call(method, path, body=None):
            conn.request(method, path, None if body is None else json.dumps(body),
                         {} if body is None else {"Content-Type": "application/json"})
            return conn.getresponse()

        t0 = time.perf_counter()
        r = call("GET", "/v1/models")
        models = json.loads(r.read())
        models_ms = (time.perf_counter() - t0) * 1e3
        check(r.status == 200 and models["data"][0]["id"] == "ray_tpu_torch-llama", f"phase 4i (b): /v1/models {models}")
        body = {"prompt": prompts[0], "max_tokens": 32, "temperature": 0}
        t0 = time.perf_counter()
        r = call("POST", "/v1/completions", body)
        unary = json.loads(r.read())
        unary_s = time.perf_counter() - t0
        check(r.status == 200, f"phase 4i (b): /v1/completions {r.status} {unary}")
        utoks = unary["choices"][0]["text"]
        t0 = time.perf_counter()
        r = call("POST", "/v1/completions", {**body, "stream": True})
        check(r.status == 200, f"phase 4i (b): the stream's status {r.status}")
        events, stamps = [], []
        while True:
            line = r.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                stamps.append(time.perf_counter())
                events.append(line[len(b"data: "):].strip())
        stoks = [t for e in events[:-1] for t in json.loads(e)["choices"][0]["text"]]
        check(events[-1:] == [b"[DONE]"] and len(events) == 33 and stoks == utoks,
              f"phase 4i (b): {len(events)} SSE events (want 32 + [DONE]), the chunks' tokens equal the unary "
              f"response's: {stoks == utoks}")
        check(len(utoks) == 32 and utoks[0] == ref[0][0], f"phase 4i (b): the unary response's first token "
                                                          f"{utoks[:1]} vs phase 4's {ref[0][0]}")
        ttfc_ms = (stamps[0] - t0) * 1e3
        gap_ms = (stamps[31] - stamps[0]) / 31 * 1e3
        kb = ho.kernel_counts.remote().result(timeout_s=SERVE_TIMEOUT_S)
        conn.close()
        out.update(b=dict(up_s=up_b, init_s=fb["init_s"], models_ms=models_ms, unary_s=unary_s, ttfc_ms=ttfc_ms,
                          gap_ms=gap_ms, counts=kb))
        print(f"phase 4i (b) build_openai_app behind the asyncio proxy (route /v1, port {port}): RUNNING {up_b:.3f} s "
              f"after serve.run (its __init__ {fb['init_s']:.3f} s); /v1/models round trip {models_ms:.3f} ms; unary "
              f"/v1/completions (phase 4's first prompt, {len(prompts[0])} tokens, 32 greedy) {unary_s:.3f} s, first "
              f"token equal to phase 4's; the same request with stream: 32 SSE chunks then [DONE], tokens equal the "
              f"unary's, first chunk {ttfc_ms:.3f} ms after the request, mean gap {gap_ms:.3f} ms between chunks; in "
              f"the worker K1 {kb['k1']}, K4 {kb['k4']} {card}")
        serve.delete("openai")
        card_back(fb["pid"], "(b)")
        # (c) the disaggregated deployment: a prefill and a decode replica, neither asking for a card
        free_c0 = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        hd = serve.run(build_pd_disagg_deployment(LLMConfig(model_config=cfg, engine_kwargs=ek),
                                                  _cls={PrefillServer: CardPrefillServer,
                                                        DecodeServer: CardDecodeServer}),
                       name="pd", blocking_timeout_s=SERVE_TIMEOUT_S)
        up_c = time.perf_counter() - t0
        free_c1 = torch.cuda.mem_get_info()[0]
        pre, dec = (serve.get_deployment_handle(f"LLM-{k}", "pd") for k in ("prefill", "decode"))
        fp, fd = (x.weights_checksum.remote().result(timeout_s=SERVE_TIMEOUT_S) for x in (pre, dec))
        check(fp["checksum"] == fd["checksum"] == drv_checksum and fp["pid"] != fd["pid"],
              f"phase 4i (c): the prefill replica {fp}, the decode replica {fd}")
        check(rtt.available_resources().get("GPU", 0) == 1, "phase 4i (c): a replica holds the GPU resource")
        for x in (pre, dec):
            x.kernel_counts.remote(True).result(timeout_s=SERVE_TIMEOUT_S)
        t0 = time.perf_counter()
        outs = [r.result(timeout_s=SERVE_TIMEOUT_S) for r in [hd.generate.remote(p, {"max_tokens": 32}) for p in prompts]]
        wall_c = time.perf_counter() - t0
        kp, kd = (x.kernel_counts.remote().result(timeout_s=SERVE_TIMEOUT_S) for x in (pre, dec))
        st = hd.disagg_stats.remote().result(timeout_s=SERVE_TIMEOUT_S)
        toks = [o["token_ids"] for o in outs]
        firsts = sum(t[0] == r[0] for t, r in zip(toks, ref))
        check(all(len(t) == 32 for t in toks) and firsts == n,
              f"phase 4i (c): first tokens equal phase 4's in {firsts} of {n}, lengths {[len(t) for t in toks]}")
        check(st["prefills"] == n and st["decode_retries"] == 0, f"phase 4i (c): disagg_stats {st}")
        check(kp["k1"] == L * kp["prefill_forwards"] > 0, f"phase 4i (c): the prefill worker's K1 {kp['k1']} != {L} x "
                                                          f"{kp['prefill_forwards']} forwards")
        check(kd["k1"] == 0 and kd["k4"] == L * kd["decode_steps"] > 0,
              f"phase 4i (c): the decode worker's K1 {kd['k1']} (want 0), K4 {kd['k4']} != {L} x {kd['decode_steps']}")
        same = sum(x == y for s1, s2 in zip(toks, ref) for x, y in zip(s1, s2))
        out.update(c=dict(up_s=up_c, init_s=(fp["init_s"], fd["init_s"]), wall_s=wall_c, prefill=kp, decode=kd,
                          stats=st, free=(free_c0, free_c1)))
        print(f"phase 4i (c) build_pd_disagg_deployment (1 prefill + 1 decode replica on the one card, neither "
              f"asking for it; phase 4's peak of 22.09 GB an engine: about 44 GB of 80): RUNNING {up_c:.3f} s after "
              f"serve.run (__init__ prefill {fp['init_s']:.3f} s, decode {fd['init_s']:.3f} s); the card's free "
              f"memory {free_c0} bytes before, {free_c1} with both replicas up; 8 concurrent requests through the "
              f"router {wall_c:.3f} s wall; first tokens 8 of 8 equal phase 4's, {same} of 256 tokens (not gated); "
              f"disagg_stats prefills {st['prefills']}, decode retries {st['decode_retries']}, handoff bytes "
              f"{st['handoff_bytes']}; the prefill worker K1 {kp['k1']} (= {L} x {kp['prefill_forwards']} forwards), "
              f"K4 {kp['k4']}; the decode worker K1 {kd['k1']}, K4 {kd['k4']} (= {L} x {kd['decode_steps']} decode "
              f"steps) {card}")
        serve.delete("pd")
        deadline = time.perf_counter() + SERVE_TIMEOUT_S
        while rtt.available_resources().get("CPU", 0) < 8 and time.perf_counter() < deadline:
            time.sleep(0.05)
        # (d) the kvplane deployment: two replicas behind the cache-aware router, prefix caching on
        ekd = dict(ek, enable_prefix_caching=True, prefix_block=64)
        t0 = time.perf_counter()
        hk = serve.run(build_kvplane_deployment(LLMConfig(model_config=cfg, engine_kwargs=ekd), num_replicas=2,
                                                _cls={KVPlaneServer: CardKVPlaneServer}),
                       name="kv", blocking_timeout_s=SERVE_TIMEOUT_S)
        up_d = time.perf_counter() - t0
        reps = [serve.get_deployment_handle(f"LLM-r{i}", "kv") for i in range(2)]
        fr = [x.weights_checksum.remote().result(timeout_s=SERVE_TIMEOUT_S) for x in reps]
        check(all(f["checksum"] == drv_checksum for f in fr), f"phase 4i (d): the replicas {fr}")
        for x in reps:
            x.kernel_counts.remote(True).result(timeout_s=SERVE_TIMEOUT_S)
        t0 = time.perf_counter()
        lead = hk.generate.remote(leader, {"max_tokens": 32}).result(timeout_s=SERVE_TIMEOUT_S)
        outs = [hk.generate.remote(f, {"max_tokens": 32}).result(timeout_s=SERVE_TIMEOUT_S) for f in followers]
        wall_d = time.perf_counter() - t0
        rs = hk.kvplane_stats.remote().result(timeout_s=SERVE_TIMEOUT_S)
        per = [x.kvplane_stats.remote().result(timeout_s=SERVE_TIMEOUT_S) for x in reps]
        kk = [x.kernel_counts.remote().result(timeout_s=SERVE_TIMEOUT_S) for x in reps]
        firsts = sum(o["token_ids"][0] == f for o, f in zip(outs, hit_firsts))
        hits = sum(p["local"]["hits"] + p["remote"]["hits"] for p in per)
        saved = sum(p["tokens_saved"] for p in per)
        check(len(lead["token_ids"]) == 32 and all(len(o["token_ids"]) == 32 for o in outs) and firsts == len(followers),
              f"phase 4i (d): first tokens equal phase 4b's hits in {firsts} of {len(followers)}")
        check(hits == len(followers) and saved == len(followers) * PREFIX_LEN and rs["failed"] == 0,
              f"phase 4i (d): {hits} hits (local + remote), {saved} tokens saved (want {len(followers)} and "
              f"{len(followers) * PREFIX_LEN}); the router {rs}")
        for p, k in zip(per, kk):
            check(k["k1"] == L * k["prefill_forwards"] and k["k4"] == L * (k["decode_steps"] + k["extend_forwards"]),
                  f"phase 4i (d): a replica's K1 {k['k1']} / K4 {k['k4']} vs its forwards {k}")
        # K4 at the extend's shape, held in the worker of the replica that extended most
        ext = max(range(2), key=lambda i: kk[i]["extend_forwards"])
        kx = reps[ext].check_extend.remote(PREFIX_LEN, [len(f) - PREFIX_LEN for f in followers]).result(
            timeout_s=SERVE_TIMEOUT_S)
        check(kx["ok"], f"phase 4i (d): K4 in replica r{ext}'s worker at the extend {kx['shape']}: max |d| "
                        f"{kx['err']:.3g}, relative {kx['rel']:.3g} (tol {K4_TOL})")
        print(f"phase 4i (d) K4 held against its plain version in replica r{ext}'s worker at its extend {kx['shape']} "
              f"over a {PREFIX_LEN}-token prefix: max |d| {kx['err']:.3g} (rel {kx['rel']:.3g}), kernel "
              f"{kx['ms']:.4f} ms, plain {kx['plain_ms']:.4f} ms, bound {kx['bound_ms']:.4f} ms ({kx['bound_by']}) "
              f"{card}")
        out.update(d=dict(up_s=up_d, init_s=[f["init_s"] for f in fr], wall_s=wall_d, router=rs, counts=kk,
                          hits=hits, saved=saved, extend_check=kx))
        print(f"phase 4i (d) build_kvplane_deployment (2 replicas, prefix caching on, 64-token blocks): RUNNING "
              f"{up_d:.3f} s after serve.run (__init__ {[round(f['init_s'], 3) for f in fr]} s); phase 4b's leader, then "
              f"its 8 followers one at a time through the cache-aware router, {wall_d:.3f} s wall; first tokens 8 of 8 "
              f"equal phase 4b's hits; {hits} hits (local {sum(p['local']['hits'] for p in per)}, remote "
              f"{sum(p['remote']['hits'] for p in per)}), {saved} tokens saved; router routed to the holder "
              f"{rs['routed_to_holder']}, off it {rs['routed_off_holder']}, cold {rs['cold']}, matched tokens "
              f"{rs['matched_tokens']}; K1 {[k['k1'] for k in kk]}, K4 {[k['k4'] for k in kk]} in the two workers "
              f"{card}")
    finally:
        pids = [p for node in context.get_client().nodes.values() for p in node.worker_pids]
        t0 = time.perf_counter()
        serve.shutdown()
        serve_down_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rtt.shutdown()
        shutdown_s = time.perf_counter() - t0
    alive = [p for p in pids if worker_alive(p)]
    check(not alive, f"phase 4i: worker processes left after shutdown: {alive}")
    left = rt_segments()
    check(not left, f"phase 4i: /dev/shm still holds {left}")
    torch.cuda.synchronize()
    used1 = card_used(torch)
    check(abs(used1 - used0) <= RUNTIME_MEM_SLACK, f"phase 4i: the card's memory in use {used1} bytes after shutdown vs "
                                                   f"{used0} before phase 4i")
    out.update(serve_down_s=serve_down_s, shutdown_s=shutdown_s)
    print(f"phase 4i shutdown: serve.shutdown() {serve_down_s:.3f} s, ray_tpu_torch.shutdown() {shutdown_s:.3f} s, none "
          f"of the {len(pids)} workers left, no rt segment, the card's memory in use {used1} bytes vs {used0} before "
          f"phase 4i; phase 4i {time.perf_counter() - t_phase:.1f} s {card}")
    return out


# ---------------------------------------------------------------- phase 4j: Data and batch inference on the card
DATA_ROWS = 32  # phase 4's 8 prompts at rows 0, 4, ..., 28 among 24 seeded ones
DATA_PROMPT_LENS = (64, 1024)  # the seeded prompts' lengths
DATA_FEED_SHAPE = (1 << 20, 256)  # the feed's .npy: 2^20 rows of 256 f32, 1 GiB
DATA_FEED_BATCH = 8192
DATA_FEED_TOL = 1e-6  # per column: |card sum - host sum| <= this x the column's sum of |x| (f64 sums of f32 rows)
DATA_STORE_BYTES = 8 << 30  # the store's budget in 4j: the feed's 1 GiB block, its chunks and the map's outputs
DATA_RELEASE_S = 120  # a leg's engine actors' workers gone and the card's memory back, after the stream ends


class DataCardEngine(LLMEngine):
    """Phase 4j's engine, built in a Data actor's worker by ``data_engine``
    (``build_llm_processor``'s factory): K1's and K4's launch counters are
    zeroed once the engine is built; after each ``generate`` (one Data
    batch) the worker's counts, the engine's forwards since then and, after
    the first, K1 and K4 held against their plain versions here
    (``hold_kernels``) go to ``<report_dir>/engine_<pid>.json``, which the
    driver reads after the run."""

    def __init__(self, cfg, params, report_dir: str, **kwargs):
        from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
        from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

        super().__init__(cfg, params, **kwargs)
        flash_attention_fwd.launches = 0
        paged_attn_partials.launches = 0
        self._base = (self.prefill_forwards, self.decode_steps)
        self.report_path = os.path.join(report_dir, f"engine_{os.getpid()}.json")
        self.report = dict(pid=os.getpid(), visible=os.environ.get("CUDA_VISIBLE_DEVICES"), batches=0, rows=0,
                           generate_s=0.0, check=None, mem=[], apps=None)

    def generate(self, prompts, params=None):
        import torch

        from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
        from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

        t0 = time.perf_counter()
        outs = super().generate(prompts, params)
        torch.cuda.synchronize()
        rep = self.report
        rep["generate_s"] += time.perf_counter() - t0
        rep["batches"] += 1
        rep["rows"] += len(prompts)
        rep.update(k1=flash_attention_fwd.launches, k4=paged_attn_partials.launches,
                   prefill_forwards=self.prefill_forwards - self._base[0],
                   decode_steps=self.decode_steps - self._base[1])
        if rep["check"] is None:
            rep["mem"].append(data_mem(torch, "batch 1"))
            rep["check"] = hold_kernels(self, [len(p) for p in prompts])
            rep["mem"].append(data_mem(torch, "held"))
            rep["apps"] = card_apps()
        else:
            last = data_mem(torch, "later batches")
            if rep["mem"][-1]["stage"] == last["stage"]:
                prev = rep["mem"].pop()
                last.update(peak_reserved=max(last["peak_reserved"], prev["peak_reserved"]),
                            peak_allocated=max(last["peak_allocated"], prev["peak_allocated"]))
            rep["mem"].append(last)
        rep.update(peak=max(m["peak_allocated"] for m in rep["mem"]), reserved=rep["mem"][-1]["reserved"])
        self.write_report()
        return outs

    def write_report(self):
        tmp = f"{self.report_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.report, f)
        os.replace(tmp, self.report_path)


def data_engine(spec: dict):
    """The engine factory of phase 4j's processors (a ``functools.partial``
    of it travels to each actor): phase 4's weights rebuilt from seed 0 on
    the card, their checksum, and phase 4i's engine settings."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    t0 = time.perf_counter()
    mem = [data_mem(torch, "context")]  # the first CUDA call in this worker: its context is made here
    cfg = LlamaConfig(**spec["config"])
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    mem.append(data_mem(torch, "weights"))
    eng = DataCardEngine(cfg, params, spec["report_dir"], telemetry_tags={"model": f"phase 4j actor {os.getpid()}"},
                         **SERVE_ENGINE_KWARGS)
    torch.cuda.synchronize()
    mem.append(data_mem(torch, "engine"))
    eng.report["mem"] = mem
    eng.report.update(checksum=weights_checksum(params), init_s=time.perf_counter() - t0,
                      device=str(eng.device), free=mem[-1]["free"])
    eng.write_report()
    return eng


def data_mem(torch, stage: str) -> dict:
    """The card's free bytes (every process) beside this process's
    caching allocator at the end of a stage: what it reserves from the
    card and what is allocated in that, now and at their peaks in the
    stage (the peaks are reset for the next)."""
    out = dict(stage=stage, free=torch.cuda.mem_get_info()[0], reserved=torch.cuda.memory_reserved(),
               allocated=torch.cuda.memory_allocated(), peak_reserved=torch.cuda.max_memory_reserved(),
               peak_allocated=torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    return out


def card_apps() -> list:
    """nvidia-smi's processes on the card, with the device memory each uses."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,process_name,used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()] or [f"rc {out.returncode}: "
                                                                                 f"{out.stderr.strip()}"]


def data_prompt(row):
    """preprocess: a row's token ids become the processor's prompt column."""
    return {"row": row["row"], "prompt": row["ids"]}


def data_result(row):
    """postprocess: the row, its stream and its finish reason (the prompt dropped)."""
    return {"row": row["row"], "tokens": row["generated"], "reason": row["generated_finish_reason"]}


def feed_half(batch):
    """The feed's map_batches UDF: every value halved (exact in f32)."""
    return {"data": batch["data"] * np.float32(0.5)}


def data_reports(report_dir: str) -> list:
    out = []
    for name in sorted(os.listdir(report_dir)):
        if name.endswith(".json"):
            with open(os.path.join(report_dir, name)) as f:
                out.append(json.load(f))
    return out


def data_on_card(torch, cfg, prompts, serve_run, drv_checksum, card, dev) -> dict:
    """Phase 4j: Data and offline batch inference over the port's runtime on
    the card. (a) build_llm_processor with one engine actor over 32 rows;
    (b) the same with two engine actors sharing the card, neither asking
    for it; (c) a 1 GiB .npy fed through read_numpy -> map_batches ->
    iter_torch_batches to the card; then shutdown leaves no worker, no rt
    segment and the card's memory as before. Every leg is gated."""
    import dataclasses
    import tempfile
    import threading
    from functools import partial

    import ray_tpu_torch as rtt
    from ray_tpu_torch import _native, data
    from ray_tpu_torch.core import context
    from ray_tpu_torch.data.executor import split_stats
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.batch import build_llm_processor
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    L, ref = cfg.num_layers, serve_run["tokens"]
    torch.cuda.synchronize()
    used0 = card_used(torch)
    rng = np.random.default_rng(4)
    seeded = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
              for n in rng.integers(DATA_PROMPT_LENS[0], DATA_PROMPT_LENS[1] + 1, size=DATA_ROWS - len(prompts))]
    it = iter(seeded)
    rows_in = [prompts[i // 4] if i % 4 == 0 else next(it) for i in range(DATA_ROWS)]
    phase4_rows = list(range(0, DATA_ROWS, 4))
    sampling = SamplingParams(max_tokens=32, temperature=0.0)
    out = dict(native=_native.native_available())
    check(out["native"], "phase 4j: the native hashing kernels (g++ -O3) did not build")
    t_phase = time.perf_counter()
    rtt.init(num_cpus=8, _system_config={"object_store_memory": DATA_STORE_BYTES})
    flash_attention_fwd.launches = 0
    paged_attn_partials.launches = 0

    def leg(name, concurrency):
        report_dir = tempfile.mkdtemp(prefix=f"rt4j_{name}_")
        factory = partial(data_engine, dict(config=dataclasses.asdict(cfg), report_dir=report_dir))
        proc = build_llm_processor(factory, sampling=sampling, batch_size=8, concurrency=concurrency,
                                   preprocess=data_prompt, postprocess=data_result)
        ds = data.from_items([{"row": i, "ids": p} for i, p in enumerate(rows_in)], parallelism=4)
        free = [torch.cuda.mem_get_info()[0]]
        done = threading.Event()

        def sample():
            while not done.wait(0.1):
                free.append(torch.cuda.mem_get_info()[0])

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        t0 = time.perf_counter()
        try:
            rows = proc(ds).take_all()
        finally:
            done.set()
            sampler.join()
        wall = time.perf_counter() - t0
        reps = data_reports(report_dir)
        toks = [list(r["tokens"]) for r in rows]
        check([r["row"] for r in rows] == list(range(DATA_ROWS)),
              f"phase 4j ({name}): rows back {[r['row'] for r in rows]}, not {DATA_ROWS} in input order")
        check(all(len(t) == 32 and r["reason"] == "length" for t, r in zip(toks, rows)),
              f"phase 4j ({name}): not every row finished with 32 tokens: "
              f"{[(len(t), r['reason']) for t, r in zip(toks, rows)]}")
        firsts = sum(toks[i][0] == ref[k][0] for k, i in enumerate(phase4_rows))
        check(firsts == len(prompts), f"phase 4j ({name}): phase 4's prompts' first tokens equal phase 4's in "
                                      f"{firsts} of {len(prompts)}")
        check(len(reps) == concurrency and all(r["checksum"] == drv_checksum for r in reps),
              f"phase 4j ({name}): {len(reps)} engine reports (want {concurrency}), checksums "
              f"{[r['checksum'] for r in reps]} vs phase 4's {drv_checksum}")
        check(all(r["pid"] != os.getpid() and r["device"].startswith("cuda") for r in reps),
              f"phase 4j ({name}): an engine ran in the driver or off the card: {reps}")
        for r in reps:
            check(r["k1"] == L * r["prefill_forwards"] > 0 and r["k4"] == L * r["decode_steps"] > 0,
                  f"phase 4j ({name}): in worker {r['pid']} K1 {r['k1']} != {L} x {r['prefill_forwards']} prefill "
                  f"forwards or K4 {r['k4']} != {L} x {r['decode_steps']} decode steps")
        check(sum(r["rows"] for r in reps) == DATA_ROWS, f"phase 4j ({name}): the engines generated "
                                                         f"{[r['rows'] for r in reps]} rows")
        check(flash_attention_fwd.launches == 0 and paged_attn_partials.launches == 0,
              f"phase 4j ({name}): the driver's K1/K4 counts moved: {flash_attention_fwd.launches}, "
              f"{paged_attn_partials.launches}")
        # the pool kills its actors when the stream ends: their workers exit and hand the card's memory back
        t_end = time.perf_counter()

        def held():
            return any(worker_alive(r["pid"]) for r in reps) or card_used(torch) > used0 + RUNTIME_MEM_SLACK

        while held() and time.perf_counter() - t_end < DATA_RELEASE_S:
            time.sleep(0.05)
        release_s = time.perf_counter() - t_end
        check(not held(), f"phase 4j ({name}): {DATA_RELEASE_S} s after the stream the engine workers alive "
                          f"{[worker_alive(r['pid']) for r in reps]}, the card's memory in use {card_used(torch)} vs "
                          f"{used0} before 4j")
        same = sum(x == y for k, i in enumerate(phase4_rows) for x, y in zip(toks[i], ref[k]))
        gen = sum(len(t) for t in toks)
        res = dict(rows=toks, wall_s=wall, reports=reps, same=same, release_s=release_s,
                   free=(free[0], min(free), torch.cuda.mem_get_info()[0]),
                   tok_s=gen / wall, rows_s=DATA_ROWS / wall, generate_s=max(r["generate_s"] for r in reps),
                   k1=sum(r["k1"] for r in reps), k4=sum(r["k4"] for r in reps))
        for r in reps:
            c = r["check"]
            check(c["k1"]["ok"], f"phase 4j ({name}): K1 in worker {r['pid']} at {c['k1']['shape']}: |do| "
                                 f"{c['k1']['err_o']:.3g} (tol {K1_TOL_O}) |dlse| {c['k1']['err_lse']:.3g} "
                                 f"(tol {K1_TOL_LSE})")
            check(c["k4"]["ok"], f"phase 4j ({name}): K4 in worker {r['pid']} at {c['k4']['shape']}: max |d| "
                                 f"{c['k4']['err']:.3g}, relative {c['k4']['rel']:.3g} (tol {K4_TOL})")
        print(f"phase 4j ({name}) build_llm_processor, concurrency={concurrency} (engine actors asking only for CPUs, "
              f"pids {[r['pid'] for r in reps]}, CUDA_VISIBLE_DEVICES {[r['visible'] for r in reps]}): {DATA_ROWS} rows "
              f"(from_items, parallelism 4, batch_size 8, preprocess + postprocess) x 32 greedy tokens in {wall:.3f} s "
              f"wall ({res['rows_s']:.2f} rows/s, {res['tok_s']:.2f} generated tok/s; the engines' generate "
              f"{[round(r['generate_s'], 3) for r in reps]} s) vs phase 4's in-process {serve_run['wall_s']:.3f} s for "
              f"its 8 prompts; the actors' time to ready (weights from seed 0, the paged graph engine) "
              f"{[round(r['init_s'], 3) for r in reps]} s; rows in input order, 32 of 32 with 32 tokens (length); "
              f"phase 4's prompts' first tokens {firsts} of {len(prompts)} equal phase 4's, {same} of 256 tokens equal "
              f"phase 4's streams (not gated); in the workers K1 {[r['k1'] for r in reps]} (= {L} x "
              f"{[r['prefill_forwards'] for r in reps]} prefill forwards), K4 {[r['k4'] for r in reps]} (= {L} x "
              f"{[r['decode_steps'] for r in reps]} decode steps), the driver's K1 and K4 0; weights checksums equal "
              f"phase 4's; each worker's peak allocated {[r['peak'] for r in reps]} and reserved "
              f"{[r['reserved'] for r in reps]} bytes; the card's free memory {res['free'][0]} bytes before, "
              f"{res['free'][1]} at its least, "
              f"{res['free'][2]} once the workers had exited, {release_s:.3f} s after the stream ended {card}")
        for r in reps:
            stages = "; ".join(f"{m['stage']}: free {m['free']}, reserved {m['reserved']} (peak {m['peak_reserved']}), "
                               f"allocated {m['allocated']} (peak {m['peak_allocated']}), the card's drop since the "
                               f"leg began less this reserve {res['free'][0] - m['free'] - m['reserved']}"
                               for m in r["mem"])
            print(f"phase 4j ({name}) worker {r['pid']}'s memory (bytes; the card's free {res['free'][0]} before the "
                  f"leg): {stages}; nvidia-smi's processes after 'held': {r['apps']} {card}")
        for r in reps:
            k1c, k4c = r["check"]["k1"], r["check"]["k4"]
            print(f"phase 4j ({name}) worker {r['pid']}'s kernels, held against their plain versions there: K1 at "
                  f"{k1c['shape']}: |do| {k1c['err_o']:.3g} |dlse| {k1c['err_lse']:.3g}, kernel {k1c['ms']:.4f} ms, "
                  f"plain {k1c['plain_ms']:.4f} ms, sdpa {k1c['sdpa_ms']:.4f} ms, bound {k1c['bound_ms']:.4f} ms "
                  f"({k1c['bound_by']}); K4 at {k4c['shape']}: max |d| {k4c['err']:.3g} (rel {k4c['rel']:.3g}), kernel "
                  f"{k4c['ms']:.4f} ms, plain {k4c['plain_ms']:.4f} ms, bound {k4c['bound_ms']:.4f} ms "
                  f"({k4c['bound_by']}) {card}")
        return res

    try:
        out["a"] = leg("a", 1)
        out["b"] = leg("b", 2)
        a, b = out["a"], out["b"]
        b_firsts = sum(x[0] == y[0] for x, y in zip(b["rows"], a["rows"]))
        b_same = sum(u == v for x, y in zip(b["rows"], a["rows"]) for u, v in zip(x, y))
        print(f"phase 4j (b) vs (a): first tokens {b_firsts} of {DATA_ROWS} equal, {b_same} of {DATA_ROWS * 32} "
              f"tokens equal (not gated: the two pools batch the rows differently) {card}")
        # (c) the feed: a seeded 1 GiB .npy through read_numpy -> map_batches -> iter_torch_batches to the card
        with tempfile.TemporaryDirectory(prefix="rt4j_feed_") as tmp:
            path = os.path.join(tmp, "feed.npy")
            arr = np.random.default_rng(5).standard_normal(DATA_FEED_SHAPE, dtype=np.float32)
            np.save(path, arr)
            host = arr.sum(axis=0, dtype=np.float64) * 0.5
            mag = np.abs(arr).sum(axis=0, dtype=np.float64) * 0.5
            nbytes = arr.nbytes
            del arr
            s_blocks, s_chunks = split_stats.blocks, split_stats.chunks
            acc = torch.zeros(DATA_FEED_SHAPE[1], dtype=torch.float64, device=dev)
            n_rows = n_batches = 0
            wait_s = to_s = 0.0  # host seconds: waiting on the iterator; inside .to(dev) and the sum's launch
            events = []  # per batch, on the card: before the upload, after it, after the sum
            t0 = time.perf_counter()
            batches = iter(data.read_numpy(path).map_batches(feed_half).iter_torch_batches(batch_size=DATA_FEED_BATCH))
            while True:
                t1 = time.perf_counter()
                batch = next(batches, None)
                t2 = time.perf_counter()
                wait_s += t2 - t1
                if batch is None:
                    break
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                x = batch["data"].to(dev)
                ev[1].record()
                acc += x.sum(dim=0, dtype=torch.float64)
                ev[2].record()
                to_s += time.perf_counter() - t2
                events.append(ev)
                n_rows += x.shape[0]
                n_batches += 1
            torch.cuda.synchronize()
            feed_s = time.perf_counter() - t0
            up_s = sum(e[0].elapsed_time(e[1]) for e in events) / 1e3
            sum_s = sum(e[1].elapsed_time(e[2]) for e in events) / 1e3
        err = np.abs(acc.cpu().numpy() - host)
        worst = float((err / mag).max())
        splits, chunks = split_stats.blocks - s_blocks, split_stats.chunks - s_chunks
        check(n_rows == DATA_FEED_SHAPE[0] and n_batches == DATA_FEED_SHAPE[0] // DATA_FEED_BATCH,
              f"phase 4j (c): {n_rows} rows in {n_batches} batches reached the card")
        check(worst <= DATA_FEED_TOL, f"phase 4j (c): the per-column sums on the card differ from numpy's by "
                                      f"{worst:.3g} of the column's sum of |x| (tol {DATA_FEED_TOL})")
        target = context.get_client().cfg.target_max_block_size
        check(splits >= 1 and chunks >= nbytes // target,
              f"phase 4j (c): _split_oversized split {splits} blocks into {chunks} chunks; the 1 GiB read block must "
              f"split into at least {nbytes // target} at target_max_block_size {target}")
        out["c"] = dict(wall_s=feed_s, rows_s=n_rows / feed_s, gb_s=nbytes / feed_s / 1e9, splits=splits,
                        chunks=chunks, err=worst, wait_s=wait_s, to_s=to_s, upload_s=up_s, sum_s=sum_s,
                        card_share=(up_s + sum_s) / feed_s)
        print(f"phase 4j (c) the feed: a seeded {nbytes}-byte .npy ({DATA_FEED_SHAPE[0]} x {DATA_FEED_SHAPE[1]} f32) "
              f"through read_numpy -> map_batches(feed_half) -> iter_torch_batches(batch_size={DATA_FEED_BATCH}) -> "
              f".to(cuda): {n_batches} batches in {feed_s:.3f} s ({out['c']['rows_s']:.1f} rows/s, "
              f"{out['c']['gb_s']:.3f} GB/s); _split_oversized split {splits} block(s) into {chunks} chunks at "
              f"target_max_block_size {target}; per-column sums on the card within {worst:.3g} of the column's "
              f"sum of |x| of numpy's (tol {DATA_FEED_TOL}); native hashing built {out['native']} {card}")
        print(f"phase 4j (c) where the feed's {feed_s:.3f} s go: on the host {wait_s:.3f} s waiting on the iterator "
              f"(read, split, map, fetch, rebatch), {to_s:.3f} s in .to(cuda) and the sum's launch; on the card (CUDA "
              f"events) the uploads {up_s:.4f} s ({nbytes / up_s / 1e9:.2f} GB/s, pageable) and the sums {sum_s:.4f} s: "
              f"the card's share of the wall {out['c']['card_share']:.4f} {card}")
    finally:
        pids = [p for node in context.get_client().nodes.values() for p in node.worker_pids]
        t0 = time.perf_counter()
        rtt.shutdown()
        shutdown_s = time.perf_counter() - t0
    alive = [p for p in pids if worker_alive(p)]
    check(not alive, f"phase 4j: worker processes left after shutdown: {alive}")
    left = rt_segments()
    check(not left, f"phase 4j: /dev/shm still holds {left}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    used1 = card_used(torch)
    check(abs(used1 - used0) <= RUNTIME_MEM_SLACK, f"phase 4j: the card's memory in use {used1} bytes after shutdown vs "
                                                   f"{used0} before phase 4j")
    out["shutdown_s"] = shutdown_s
    print(f"phase 4j shutdown: ray_tpu_torch.shutdown() {shutdown_s:.3f} s, none of the {len(pids)} workers left, no "
          f"rt segment, the card's memory in use {used1} bytes vs {used0} before phase 4j; phase 4j "
          f"{time.perf_counter() - t_phase:.1f} s {card}")
    return out


# ---------------------------------------------------------------- phase 7b: a training job on the runtime
def hold_train_kernels(B: int, H: int, HKV: int, T: int, D: int) -> dict:
    """K1 at the sft step's shape (bf16, causal) held against its plain
    version, and K2/K3 against the plain backward, here in the train
    worker on inputs from seed 0, each timed beside them (phase 6's
    method); the launch counts are put back."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.flash_attention import (attention_bwd_ref, attention_with_lse_ref, flash_attention_bwd_dkv,
                                                   flash_attention_bwd_dq, flash_attention_fwd)

    kernels = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    counts = [k.launches for k in kernels]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, dout = (torch.randn((B, H, T, D), generator=g, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn((B, HKV, T, D), generator=g, device=dev).bfloat16() for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = attention_with_lse_ref(q, k, v, causal=True)
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    del o_ref, lse_ref
    bound_ms, bound_by = k1_bound(B, H, HKV, T, D)
    k1 = dict(shape=(B, H, HKV, T, D), err_o=err_o, err_lse=err_lse, ok=err_o <= K1_TOL_O and err_lse <= K1_TOL_LSE,
              ms=cuda_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True)),
              plain_ms=cuda_ms(torch, lambda: attention_with_lse_ref(q, k, v, causal=True), iters=3, warmup=1),
              sdpa_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)),
              bound_ms=bound_ms, bound_by=bound_by)
    delta = (dout.float() * o.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=True)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=True)

    def plain():
        dq_r, dk_r, dv_r = attention_bwd_ref(q, k, v, o, lse, dout, causal=True)
        return dq_r.bfloat16(), fa._sum_rep(dk_r, HKV).bfloat16(), fa._sum_rep(dv_r, HKV).bfloat16()

    errs = {}
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), plain()):
        diff = (got.float() - ref.float()).abs().max().item()
        errs[name] = (diff, diff / ref.float().abs().max().item())
    del ref
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

    fwd_ms = cuda_ms(torch, sdpa_fwd, iters=10)
    k23 = dict(shape=(B, H, HKV, T, D), errs=errs, ok=all(e[1] <= K23_TOL["bf16"] for e in errs.values()),
               dq_ms=cuda_ms(torch, lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=True)),
               dkv_ms=cuda_ms(torch, lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=True)),
               plain_ms=cuda_ms(torch, plain, iters=2, warmup=1),
               sdpa_bwd_ms=cuda_ms(torch, lambda: sdpa_fwd().backward(dout), iters=10) - fwd_ms)
    for kern, (b_ms, b_by, _) in k23_bound(B, H, HKV, T, D).items():
        k23[f"{kern}_bound_ms"], k23[f"{kern}_bound_by"] = b_ms, b_by
    for kern, c in zip(kernels, counts):
        kern.launches = c
    return dict(k1=k1, k23=k23)


def card_steps(config: dict, ckpt, batches, report, first: dict):
    """The body that phase 7b's train loop and phase 7c (b)'s trainable
    share: phase 7's model and optimizer at ``config["lr"]`` (phase 7's
    3e-4 by default) on this process's card, restored from ``ckpt`` when
    there is one (skipping the batches of ``batches``, an iterator of host
    batches from batch 0, that it consumed), stepped to ``config["steps"]``.
    Each step's metrics: loss, grad norm, the optimizer's learning rate,
    the CUDA-event step time, the wait on the iterator, K1/K2/K3 launches,
    the batch's key, the peak allocation, and on the first step ``first``,
    the loop's start and the init (or restore) time. A checkpoint of
    parameters, AdamW state and step (``jax_checkpoint.save_pytree``) after
    step ``save_at``; the kernels held after the last step when ``hold``.
    ``report(metrics, checkpoint)`` returns metrics for the next step's
    report. With ``config["log"]`` each step's metrics also go, before the
    report, to a JSON line in ``steps_<pid>.jsonl`` there: a Tune trial
    commits a trainer's reports only after its fit, and a stopped trial's
    last steps only there. After step ``fail_at`` (0: never), while the
    marker file is missing, it writes the marker and raises."""
    from functools import partial

    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops.flash_attention import flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step, to_device
    from ray_tpu_torch.train import Checkpoint, jax_checkpoint

    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    cfg = LlamaConfig(**config["cfg"])
    first = dict(first, visible=os.environ.get("CUDA_VISIBLE_DEVICES"), count=torch.cuda.device_count(),
                 t_start=t_start)
    init_fn, step_fn = make_train_step(partial(loss_fn, config=cfg), adamw(config.get("lr", 3e-4), weight_decay=0.01))
    t0 = time.perf_counter()
    if ckpt is None:
        state = init_fn(0, partial(init_params, cfg))
    else:
        tree = jax_checkpoint.restore_pytree(ckpt.path)  # onto the card
        state = init_fn(0, lambda _: tree["params"])
        state.opt_state.load_state_dict(tree["opt"])
        state.step = int(tree["step"])
        del tree
    torch.cuda.synchronize()
    first.update(init_s=time.perf_counter() - t0, resumed_at=state.step)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(state.step):
        next(batches)  # consumed before the checkpoint
    log = config.get("log") and os.path.join(config["log"], f"steps_{os.getpid()}.jsonl")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    carried = {}
    while state.step < config["steps"]:
        t_iter = time.perf_counter()
        host = next(batches)
        wait_s = time.perf_counter() - t_iter
        batch = to_device(host)
        before = [k.launches for k in kernels]
        ev[0].record()
        state, m = step_fn(state, batch)
        ev[1].record()
        torch.cuda.synchronize()
        metrics = dict(step=state.step, loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
                       lr=state.opt_state.param_groups[0]["lr"], step_ms=ev[0].elapsed_time(ev[1]), wait_s=wait_s,
                       pid=os.getpid(), launches=[k.launches - b for k, b in zip(kernels, before)],
                       key=int(torch.as_tensor(host["tokens"])[:, :8].long().sum()),
                       peak=torch.cuda.max_memory_allocated(), **first, **carried)
        first = {}
        checkpoint = None
        if state.step == config.get("save_at"):
            d = os.path.join(config["tmp"], f"step{state.step}_{os.getpid()}")
            t0 = time.perf_counter()
            jax_checkpoint.save_pytree(d, {"params": state.params, "opt": state.opt_state.state_dict(),
                                           "step": state.step})
            metrics.update(save_s=time.perf_counter() - t0, ckpt_bytes=os.path.getsize(os.path.join(d, "state")))
            checkpoint = Checkpoint.from_directory(d)
        if state.step == config["steps"] and config.get("hold"):
            del batch, m
            metrics["hold"] = hold_train_kernels(*host["tokens"].shape[:1], cfg.num_heads, cfg.num_kv_heads,
                                                 host["tokens"].shape[1], cfg.hd)
        metrics.update(iter_s=time.perf_counter() - t_iter, t_report=time.time())
        if log:
            with open(log, "a") as f:
                f.write(json.dumps(metrics) + "\n")
        carried = report(metrics, checkpoint)
        if state.step == config.get("fail_at") and not os.path.exists(config["marker"]):
            with open(config["marker"], "w") as f:
                f.write(repr(time.time()))
            raise RuntimeError(f"the injected failure after step {state.step}")


def train_worker_loop(config: dict):
    """Phase 7b's train loop, run by the train worker: ``card_steps`` on
    the worker's dataset shard, reporting through ``train.report``.
    ``config``: the model config, steps, the learning rate (a Tune trial's,
    phase 7c), the step to checkpoint at and the step to fail after (0:
    never), the phase's scratch directory and failure marker, whether to
    hold the kernels after the last step, and where to log each step."""
    import torch.distributed as dist

    from ray_tpu_torch import train

    first = dict(device=str(train.torch.get_device()), backend=dist.get_backend() if dist.is_initialized() else None)
    batches = iter(train.get_dataset_shard("train").iter_torch_batches(batch_size=8, drop_last=True))

    def report(metrics, checkpoint):
        train.report(metrics, checkpoint=checkpoint)
        return {}

    card_steps(config, train.get_checkpoint(), batches, report, first)


def train_on_card(torch, cfg7, data7, ref_first_loss, ref_step_s, card) -> dict:
    """Phase 7b: a user's training job on the port's runtime. JaxTrainer
    with one GPU train worker runs phase 7's step on 12 dataset batches:
    fit A uninterrupted (a one-rank nccl group), fit B with a checkpoint at
    step 4, a failure after step 6 and a restart that resumes from it.
    Every leg is gated (module docstring)."""
    import dataclasses
    import shutil
    import statistics
    import tempfile

    import ray_tpu_torch as rtt
    from ray_tpu_torch import data, train
    from ray_tpu_torch.core import context
    from ray_tpu_torch.models.llama import flops_per_token
    from ray_tpu_torch.ops.flash_attention import flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd

    L, steps = cfg7.num_layers, TRAIN_WORKER_STEPS
    Bt, Tt = data7["tokens"].shape
    want_launches = [2 * L, L, L]
    batches = [data7] + [seeded_batch(cfg7.vocab_size, Bt, Tt, i) for i in range(1, steps)]
    keys = [int(b["tokens"][:, :8].astype(np.int64).sum()) for b in batches]
    rows = [{"tokens": b["tokens"][i], "targets": b["targets"][i]} for b in batches for i in range(Bt)]
    del batches
    kernels = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    drv_counts = [k.launches for k in kernels]
    tmp = tempfile.mkdtemp(prefix="rt7b_")
    marker = os.path.join(tmp, "failed_once")
    torch.cuda.synchronize()
    used0 = card_used(torch)
    t_phase = time.perf_counter()
    rtt.init(num_cpus=4)
    out = {}

    def fit(name, backend, max_failures, save_at, fail_at, hold):
        t0 = time.time()
        result = train.JaxTrainer(
            train_worker_loop,
            train_loop_config=dict(cfg=dataclasses.asdict(cfg7), steps=steps, save_at=save_at, fail_at=fail_at,
                                   tmp=tmp, marker=marker, hold=hold),
            scaling_config=train.ScalingConfig(num_workers=1, resources_per_worker={"CPU": 1, "GPU": 1}),
            run_config=train.RunConfig(name=f"fit_{name}", storage_path=tmp,
                                       failure_config=train.FailureConfig(max_failures=max_failures)),
            backend_config=train.backend.JaxConfig(distributed=backend),
            datasets={"train": data.from_items(rows)},
        ).fit(raise_on_error=False)
        wall = time.time() - t0
        check(result.error is None, f"phase 7b fit {name}: {result.error!r}, in the worker: "
                                    f"{getattr(result.error, 'training_error', None)}")
        hist = result.metrics_history
        pids = sorted({m["pid"] for m in hist})
        # the group's workers exit once the fit returns: their processes and the card's memory go back
        t_end = time.perf_counter()

        def held():
            return any(worker_alive(p) for p in pids) or card_used(torch) > used0 + RUNTIME_MEM_SLACK

        while held() and time.perf_counter() - t_end < DATA_RELEASE_S:
            time.sleep(0.05)
        release_s = time.perf_counter() - t_end
        check(not held(), f"phase 7b fit {name}: {DATA_RELEASE_S} s after fit() the train workers alive "
                          f"{[worker_alive(p) for p in pids]} (states {[proc_state(p) for p in pids]}), the card's "
                          f"memory in use {card_used(torch)} vs {used0} before 7b ({release_s:.3f} s waited)")
        for m in hist:
            check(m["launches"] == want_launches, f"phase 7b fit {name} step {m['step']}: K1/K2/K3 launches "
                                                  f"{m['launches']} in the worker, not {want_launches}")
            check(m["key"] == keys[m["step"] - 1], f"phase 7b fit {name} step {m['step']}: the worker's batch is not "
                                                   f"the dataset's batch {m['step']}")
        check([k.launches for k in kernels] == drv_counts, f"phase 7b fit {name}: the driver's K1/K2/K3 counts moved")
        # the segments left are the dataset's read tasks' by-value arguments, kept with their lineage while
        # the runtime lives (ray_tpu's design); shutdown unlinks them (gated below)
        return dict(result=result, hist=hist, pids=pids, wall=wall, t0=t0, release_s=release_s,
                    segments=len(rt_segments()))

    try:
        # ---- fit A: uninterrupted, a one-rank nccl group
        a = fit("A", "always", 0, 0, 0, True)
        hist = a["hist"]
        h0 = hist[0]
        check([m["step"] for m in hist] == list(range(1, steps + 1)),
              f"phase 7b fit A: steps committed {[m['step'] for m in hist]}")
        check(h0["count"] == 1 and h0["visible"] not in (None, ""), f"phase 7b fit A: the worker sees {h0['count']} "
                                                                    f"cards, CUDA_VISIBLE_DEVICES {h0['visible']!r}")
        check(h0["backend"] == "nccl" and h0["device"] == "cuda:0",
              f"phase 7b fit A: backend {h0['backend']!r}, get_device() {h0['device']!r}")
        losses = [m["loss"] for m in hist]
        check(abs(losses[0] - ref_first_loss) < TRAIN_LOSS_TOL,
              f"phase 7b fit A: step 1's loss {losses[0]} != phase 7's step 1 {ref_first_loss} (tol {TRAIN_LOSS_TOL})")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"phase 7b fit A: losses {losses}")
        step_ms = statistics.median(m["step_ms"] for m in hist[1:])
        ratio = step_ms / (ref_step_s * 1e3)
        check(ratio <= TRAIN_WORKER_GATE, f"phase 7b fit A: the worker's median {step_ms:.2f} ms/step is {ratio:.4f} x "
                                          f"phase 7's {ref_step_s * 1e3:.2f} ms (gate {TRAIN_WORKER_GATE})")
        hold = hist[-1]["hold"]
        check(hold["k1"]["ok"], f"phase 7b: K1 in the worker at {hold['k1']['shape']}: |do| {hold['k1']['err_o']:.3g} "
                                f"|dlse| {hold['k1']['err_lse']:.3g} (tol {K1_TOL_O}, {K1_TOL_LSE})")
        check(hold["k23"]["ok"], f"phase 7b: K2/K3 in the worker at {hold['k23']['shape']}: relative errors "
                                 f"{hold['k23']['errs']} (tol {K23_TOL['bf16']})")
        tok_s = Bt * Tt / (step_ms / 1e3)
        mfu = flops_per_token(cfg7, Tt) * tok_s / BF16_FLOPS
        ref_tok_s = Bt * Tt / ref_step_s
        waits = [m["wait_s"] for m in hist[1:]]
        share = sum(waits) / sum(m["iter_s"] for m in hist[1:])
        out["A"] = dict(step_ms=step_ms, ratio=ratio, tok_s=tok_s, mfu=mfu, losses=losses,
                        ready_s=h0["t_start"] - a["t0"], init_s=h0["init_s"], wait_s=statistics.median(waits),
                        wait_share=share, peak=max(m["peak"] for m in hist), wall=a["wall"], hold=hold,
                        launches=[sum(m["launches"][i] for m in hist) for i in range(3)], release_s=a["release_s"])
        print(f"phase 7b fit A (JaxTrainer, 1 GPU train worker pid {a['pids'][0]}, CUDA_VISIBLE_DEVICES "
              f"{h0['visible']!r}, {h0['count']} card seen, get_device() {h0['device']}, torch.distributed backend "
              f"{h0['backend']}): {steps} steps of phase 7's sft step on dataset batches {Bt} x {Tt}; time to ready "
              f"(fit() to the loop's start) {out['A']['ready_s']:.3f} s, init {h0['init_s']:.3f} s; loss step 1 "
              f"{losses[0]:.4f} (phase 7's {ref_first_loss:.4f}) -> {losses[-1]:.4f} (step {steps}); median "
              f"{step_ms:.2f} ms/step (CUDA events around step_fn, steps 2-{steps}) vs phase 7's in-process "
              f"{ref_step_s * 1e3:.2f} ms/step: {ratio:.4f}x (gate {TRAIN_WORKER_GATE}); {tok_s:.1f} tok/s vs "
              f"{ref_tok_s:.1f}, MFU {mfu:.4f} vs {flops_per_token(cfg7, Tt) * ref_tok_s / BF16_FLOPS:.4f}; the feed's "
              f"wait a step (median) {out['A']['wait_s'] * 1e3:.3f} ms, {share:.4f} of the loop's wall; launches per "
              f"step K1/K2/K3 {want_launches} in every step; peak allocated {out['A']['peak']} bytes in the worker; "
              f"fit wall {a['wall']:.2f} s; workers gone and the card's memory back {a['release_s']:.3f} s after "
              f"fit(), {a['segments']} rt segments (the dataset's read arguments, with their lineage) {card}")
        k1c, k23c = hold["k1"], hold["k23"]
        print(f"phase 7b fit A worker's kernels, held against their plain versions there at {k1c['shape']} bf16 "
              f"causal: K1 |do| {k1c['err_o']:.3g} |dlse| {k1c['err_lse']:.3g}, kernel {k1c['ms']:.4f} ms, plain "
              f"{k1c['plain_ms']:.4f} ms, sdpa {k1c['sdpa_ms']:.4f} ms, bound {k1c['bound_ms']:.4f} ms "
              f"({k1c['bound_by']}); K2/K3 relative errors dq {k23c['errs']['dq'][1]:.3g} dk {k23c['errs']['dk'][1]:.3g}"
              f" dv {k23c['errs']['dv'][1]:.3g}, K2 {k23c['dq_ms']:.4f} ms (bound {k23c['dq_bound_ms']:.4f} ms "
              f"{k23c['dq_bound_by']}), K3 {k23c['dkv_ms']:.4f} ms (bound {k23c['dkv_bound_ms']:.4f} ms "
              f"{k23c['dkv_bound_by']}), plain backward {k23c['plain_ms']:.4f} ms, sdpa backward "
              f"{k23c['sdpa_bwd_ms']:.4f} ms {card}")

        # ---- fit B: a checkpoint at step 4, a failure after step 6, a restart that resumes from it
        b = fit("B", "auto", 1, TRAIN_CKPT_STEP, TRAIN_FAIL_STEP, False)
        hist = b["hist"]
        check(os.path.exists(marker) and len(b["pids"]) == 2, f"phase 7b fit B: {len(b['pids'])} worker processes "
                                                              f"(want 2: one restart), marker {os.path.exists(marker)}")
        by_pid = {p: [m for m in hist if m["pid"] == p] for p in b["pids"]}
        first_attempt, second = sorted(by_pid.values(), key=lambda ms: ms[0]["t_report"])
        check([m["step"] for m in first_attempt] == list(range(1, TRAIN_FAIL_STEP + 1))
              and [m["step"] for m in second] == list(range(TRAIN_CKPT_STEP + 1, steps + 1))
              and hist == first_attempt + second,
              f"phase 7b fit B: steps committed {[m['step'] for m in hist]}: want 1-{TRAIN_FAIL_STEP} once, then "
              f"{TRAIN_CKPT_STEP + 1}-{steps} once from the restart, in order")
        check(second[0]["resumed_at"] == TRAIN_CKPT_STEP, f"phase 7b fit B: resumed at {second[0]['resumed_at']}")
        diffs = [abs(m["loss"] - out["A"]["losses"][m["step"] - 1]) for m in hist]
        resumed = max(abs(m["loss"] - out["A"]["losses"][m["step"] - 1]) for m in second)
        check(max(diffs) <= TRAIN_RESUME_TOL, f"phase 7b fit B: losses differ from fit A's by up to {max(diffs):.3g} "
                                              f"(tol {TRAIN_RESUME_TOL}): {[m['loss'] for m in hist]}")
        saved = next(m for m in first_attempt if m["step"] == TRAIN_CKPT_STEP)
        commit_s = next(m for m in b["result"].metrics_history if m["step"] == TRAIN_CKPT_STEP)["timestamp"] \
            - saved["t_report"]
        with open(marker) as f:
            failed_at = float(f.read())
        restart_s = second[0]["t_report"] - failed_at
        out["B"] = dict(restart_s=restart_s, resumed_diff=resumed, diff=max(diffs), ckpt_bytes=saved["ckpt_bytes"],
                        save_s=saved["save_s"], commit_s=commit_s, restore_s=second[0]["init_s"],
                        ready_s=second[0]["t_start"] - failed_at, peak=max(m["peak"] for m in hist), wall=b["wall"],
                        launches=[sum(m["launches"][i] for m in hist) for i in range(3)], release_s=b["release_s"])
        print(f"phase 7b fit B (FailureConfig(max_failures=1), JaxConfig('auto'): no process group for one worker): "
              f"checkpoint after step {TRAIN_CKPT_STEP} ({saved['ckpt_bytes']} bytes: parameters, AdamW state, step; "
              f"save_pytree {saved['save_s']:.3f} s in the worker, report to commit {commit_s:.3f} s with the "
              f"controller's copy), the injected failure after step {TRAIN_FAIL_STEP}, one restart (worker pids "
              f"{b['pids']}): the new worker ready {out['B']['ready_s']:.3f} s after the failure, restored the "
              f"checkpoint onto the card in {second[0]['init_s']:.3f} s, skipped {TRAIN_CKPT_STEP} batches; restart "
              f"to the first resumed step's report {restart_s:.3f} s; steps committed {[m['step'] for m in hist]}; "
              f"resumed losses (steps {TRAIN_CKPT_STEP + 1}-{steps}) vs fit A's: max |d| {resumed:.3g}, every step "
              f"{max(diffs):.3g} (tol {TRAIN_RESUME_TOL}); peak allocated {out['B']['peak']} bytes; fit wall "
              f"{b['wall']:.2f} s; workers gone and the card's memory back {b['release_s']:.3f} s after fit(), "
              f"{b['segments']} rt segments {card}")
    finally:
        pids = [p for node in context.get_client().nodes.values() for p in node.worker_pids]
        rtt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    alive = [p for p in pids if worker_alive(p)]
    check(not alive, f"phase 7b: worker processes left after shutdown: {alive}")
    left = rt_segments()
    check(not left, f"phase 7b: /dev/shm still holds {left}")
    check(not os.path.exists(tmp), f"phase 7b: the checkpoints' directory {tmp} is still there")
    torch.cuda.synchronize()
    used1 = card_used(torch)
    check(abs(used1 - used0) <= RUNTIME_MEM_SLACK, f"phase 7b: the card's memory in use {used1} bytes after shutdown vs "
                                                   f"{used0} before phase 7b")
    out["launches"] = [x + y for x, y in zip(out["A"]["launches"], out["B"]["launches"])]
    print(f"phase 7b end: no worker, no rt segment, the checkpoints' directory removed, the card's memory in use "
          f"{used1} bytes vs {used0} before; phase 7b {time.perf_counter() - t_phase:.1f} s {card}")
    return out



# ---------------------------------------------------------------- phase 7c: Tune over the trainers, the actor utilities
def seeded_batch(vocab: int, B: int, T: int, i: int) -> dict:
    """Batch ``i`` (from 0) of phases 7b and 7c: tokens, then targets, drawn
    from ``default_rng(i)``; batch 0 is phase 7's."""
    r = np.random.default_rng(i)
    return {"tokens": r.integers(0, vocab, (B, T)).astype(np.int32),
            "targets": r.integers(0, vocab, (B, T)).astype(np.int32)}


class CommitTimes(Callback):
    """A Tune callback in the driver: when the controller committed each
    result (after its checkpoint's copy into the run directory)."""

    def __init__(self):
        self.rows: list = []

    def log_trial_result(self, trial, result: dict):
        self.rows.append((trial.trial_id, result.get("step"), time.time()))


def card_trial(config: dict):
    """Phase 7c (b)'s trainable, run in a trial actor bound to the card:
    ``card_steps`` on batches 1-6 (``seeded_batch``), reporting through
    ``tune.report``. The report stages a copy of the step's checkpoint
    before it returns; the trainable then removes its own and reports the
    staging time with the next step."""
    import itertools
    import shutil

    from ray_tpu_torch import tune
    from ray_tpu_torch.models.llama import LlamaConfig

    vocab = LlamaConfig(**config["cfg"]).vocab_size
    B, T = config["batch"]

    def report(metrics, checkpoint):
        t0 = time.perf_counter()
        tune.report(metrics, checkpoint=checkpoint)
        if checkpoint is None:
            return {}
        stage_s = time.perf_counter() - t0
        shutil.rmtree(checkpoint.path)  # the staged copy is the trial's now
        return dict(stage_s=stage_s)

    card_steps(config, tune.get_checkpoint(), (seeded_batch(vocab, B, T, i) for i in itertools.count()), report, {})


@remote(num_cpus=1)
class PoolEngine:
    """Phase 7c (c)'s actor: phase 4's engine (phase 4's weights rebuilt from
    seed 0 on the card, phase 4i's engine settings) in this worker, its K1
    and K4 counters zeroed once it is built. ``generate`` serves one
    (index, prompt) item of an ActorPool's map, 32 greedy tokens."""

    def __init__(self, spec: dict):
        import torch

        from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
        from ray_tpu_torch.models.llama import LlamaConfig, init_params
        from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

        t0 = time.perf_counter()
        cfg = LlamaConfig(**spec["config"])
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        self.checksum = weights_checksum(params)
        self.eng = LLMEngine(cfg, params, telemetry_tags={"model": f"phase 7c actor {os.getpid()}"},
                             **SERVE_ENGINE_KWARGS)
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0
        flash_attention_fwd.launches = 0
        paged_attn_partials.launches = 0
        self.base = (self.eng.prefill_forwards, self.eng.decode_steps)

    def generate(self, item) -> dict:
        from ray_tpu_torch.llm import SamplingParams

        i, prompt = item
        (out,) = self.eng.generate([prompt], SamplingParams(max_tokens=32))
        return dict(i=i, pid=os.getpid(), tokens=list(out.token_ids), reason=out.finish_reason)

    def counts(self) -> dict:
        import torch

        from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
        from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

        return dict(pid=os.getpid(), visible=os.environ.get("CUDA_VISIBLE_DEVICES"), checksum=self.checksum,
                    init_s=self.init_s, device=str(self.eng.device), k1=flash_attention_fwd.launches,
                    k4=paged_attn_partials.launches, prefill_forwards=self.eng.prefill_forwards - self.base[0],
                    decode_steps=self.eng.decode_steps - self.base[1], peak=torch.cuda.max_memory_allocated())

    def check_kernels(self, lens) -> dict:
        """K1 and K4 held at the shapes ``generate`` runs them: each prompt
        alone, a B=1 prefill at its bucket and one decode lane bounded by
        its length (``hold_kernels``). Each kernel's row is the longest
        prompt's, with the largest errors of all, ``ok`` if every hold
        passed, and every shape held."""
        holds = [hold_kernels(self.eng, [n]) for n in lens]
        longest = holds[int(np.argmax(lens))]
        out = {}
        for k, errs in (("k1", ("err_o", "err_lse")), ("k4", ("err", "rel"))):
            rows = [h[k] for h in holds]
            out[k] = dict(longest[k], ok=all(r["ok"] for r in rows), shapes=sorted({r["shape"] for r in rows}),
                          **{e: max(r[e] for r in rows) for e in errs})
        return out


def tune_on_card(torch, cfg7, data7, ref_first_loss, ref_step_s, fit_a_losses, cfg, prompts, serve_run, drv_checksum,
                 card) -> dict:
    """Phase 7c: Tune over the port's trainers on the card, then the actor
    utilities. (a) A Tuner over JaxTrainer (one GPU train worker, phase 7's
    step on 7b's batches 1-6) with a grid of two learning rates under
    ASHA; (b) a function trainable in a trial actor bound to the card that
    checkpoints, fails, and resumes through ``Tuner.restore``; (c) an
    ActorPool of two engine actors serving phase 4's prompts. Each leg runs
    on a fresh runtime and ends with no actor alive, no worker, no rt
    segment, the staging root gone and the card's memory as before; every
    checkpoint byte is removed at the end. Every leg is gated (module
    docstring)."""
    import dataclasses
    import shutil
    import statistics
    import tempfile

    import ray_tpu_torch as rtt
    from ray_tpu_torch import data, train, tune
    from ray_tpu_torch.core import context
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.models.llama import flops_per_token
    from ray_tpu_torch.ops.flash_attention import flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd
    from ray_tpu_torch.tune.tune_controller import _stage_root
    from ray_tpu_torch.util.actor_pool import ActorPool

    L, steps = cfg7.num_layers, TUNE_STEPS
    Bt, Tt = data7["tokens"].shape
    want_launches = [2 * L, L, L]
    batches = [seeded_batch(cfg7.vocab_size, Bt, Tt, i) for i in range(steps)]
    check(all(np.array_equal(batches[0][k], data7[k]) for k in data7), "phase 7c: batch 1 is not phase 7's batch")
    keys = [int(b["tokens"][:, :8].astype(np.int64).sum()) for b in batches]
    rows = [{"tokens": b["tokens"][i], "targets": b["targets"][i]} for b in batches for i in range(Bt)]
    del batches
    drv_kernels = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv, paged_attn_partials)
    drv_counts = [k.launches for k in drv_kernels]
    tmp = tempfile.mkdtemp(prefix="rt7c_")
    torch.cuda.synchronize()
    used0 = card_used(torch)
    t_phase = time.perf_counter()
    out = {}
    tok_step = Bt * Tt

    def settle(label, pids):
        """After a leg's work: every actor of the runtime dead, ``pids``
        gone and the card's memory back, within DATA_RELEASE_S."""
        client = context.get_client()
        t_end = time.perf_counter()

        def held():
            live = [a for a in list(client.actors.values()) if a.info.state != "DEAD"]
            return live or any(worker_alive(p) for p in pids) or card_used(torch) > used0 + RUNTIME_MEM_SLACK

        while held() and time.perf_counter() - t_end < DATA_RELEASE_S:
            time.sleep(0.05)
        check(not held(), f"phase 7c {label}: {DATA_RELEASE_S} s after the leg actors alive "
                          f"{[a.info.creation_spec.desc() for a in client.actors.values() if a.info.state != 'DEAD']}, "
                          f"workers "
                          f"{[p for p in pids if worker_alive(p)]} (states {[proc_state(p) for p in pids]}), the card's "
                          f"memory in use {card_used(torch)} vs {used0} before 7c "
                          f"({time.perf_counter() - t_end:.3f} s waited)")
        return time.perf_counter() - t_end

    def end_leg(label):
        """Shut the leg's runtime down: no worker, no rt segment, no staging root."""
        client = context.get_client()
        pids = [p for node in client.nodes.values() for p in node.worker_pids]
        stage = _stage_root()
        rtt.shutdown()
        alive = [p for p in pids if worker_alive(p)]
        check(not alive, f"phase 7c {label}: worker processes left after shutdown: {alive}")
        left = rt_segments()
        check(not left, f"phase 7c {label}: /dev/shm still holds {left}")
        check(not os.path.exists(stage), f"phase 7c {label}: the trial staging root {stage} is still there")
        check([k.launches for k in drv_kernels] == drv_counts, f"phase 7c {label}: the driver's K1-K4 counts moved")

    try:
        # ---- (a): a Tuner over JaxTrainer, one GPU train worker per trial, ASHA over TUNE_LRS
        rtt.init(num_cpus=4)
        logs = os.path.join(tmp, "steps_a")
        os.makedirs(logs)
        trainer = train.JaxTrainer(
            train_worker_loop,
            train_loop_config=dict(cfg=dataclasses.asdict(cfg7), steps=steps, save_at=0, fail_at=0, tmp=tmp,
                                   marker=os.path.join(tmp, "unused"), hold=False, log=logs),
            scaling_config=train.ScalingConfig(num_workers=1, resources_per_worker={"CPU": 1, "GPU": 1}),
            run_config=train.RunConfig(name="inner_a", storage_path=tmp),
            backend_config=train.backend.JaxConfig(distributed="always"),
            datasets={"train": data.from_items(rows)})
        sched = tune.ASHAScheduler(metric="loss", mode="min", time_attr="step", max_t=steps, grace_period=2,
                                   reduction_factor=2)
        commits_a = CommitTimes()
        t0 = time.time()
        grid = tune.Tuner(trainer, param_space={"lr": tune.grid_search(list(TUNE_LRS))},
                          tune_config=tune.TuneConfig(metric="loss", mode="min", scheduler=sched),
                          run_config=train.RunConfig(name="tune_a", storage_path=tmp, callbacks=[commits_a])).fit()
        wall = time.time() - t0
        trials = grid._trials
        check(len(trials) == len(TUNE_LRS) and not any(t.status == "ERROR" for t in trials),
              f"phase 7c (a): trials {[(t.config.get('lr'), t.status, t.error) for t in trials]}")
        ran = {}  # every step each train worker ran, committed or not: lr -> its log
        for name in sorted(os.listdir(logs)):
            with open(os.path.join(logs, name)) as f:
                lines = [json.loads(x) for x in f]
            check(len({m["lr"] for m in lines}) == 1 and lines[0]["lr"] not in ran,
                  f"phase 7c (a): {name} holds steps of lrs {[m['lr'] for m in lines]}, or a second worker's")
            ran[lines[0]["lr"]] = lines
        check(sorted(ran) == sorted(TUNE_LRS), f"phase 7c (a): train workers ran lrs {sorted(ran)}, not {TUNE_LRS}")
        pids = sorted({m["pid"] for h in ran.values() for m in h})
        release_s = settle("(a)", pids)
        per = {}
        for t in trials:
            lr, h, log = t.config["lr"], t.metrics_history, ran[t.config["lr"]]
            h0 = log[0]
            st = [m["step"] for m in h]
            check([m["step"] for m in log] == list(range(1, steps + 1)),
                  f"phase 7c (a) lr {lr}: the train worker ran steps {[m['step'] for m in log]}")
            check(st == list(range(1, len(st) + 1)), f"phase 7c (a) lr {lr}: steps committed {st}")
            check(all(m[k] == w[k] for m, w in zip(h, log) for k in ("step", "loss", "pid", "key", "t_report")),
                  f"phase 7c (a) lr {lr}: the committed reports are not the worker's first {len(h)} steps")
            check(len({m["pid"] for m in log}) == 1, f"phase 7c (a) lr {lr}: more than one train worker: {log}")
            check(h0["count"] == 1 and h0["visible"] == "0" and h0["backend"] == "nccl" and h0["device"] == "cuda:0",
                  f"phase 7c (a) lr {lr}: the worker sees {h0['count']} cards, CUDA_VISIBLE_DEVICES "
                  f"{h0['visible']!r}, backend {h0['backend']!r}, get_device() {h0['device']!r}")
            for m in log:
                check(m["launches"] == want_launches, f"phase 7c (a) lr {lr} step {m['step']}: K1/K2/K3 launches "
                                                      f"{m['launches']}, not {want_launches}")
                check(m["key"] == keys[m["step"] - 1], f"phase 7c (a) lr {lr} step {m['step']}: not batch "
                                                       f"{m['step']}")
                check(m["lr"] == lr, f"phase 7c (a): the trial of lr {lr} reported lr {m['lr']} at step {m['step']}")
            check(h0["loss"] == ref_first_loss, f"phase 7c (a) lr {lr}: step 1's loss {h0['loss']!r} != phase 7's "
                                                f"{ref_first_loss!r}")
            if st[-1] < steps:
                check(st[-1] in TUNE_RUNGS, f"phase 7c (a) lr {lr}: ASHA stopped it after step {st[-1]}, not at a "
                                            f"rung {TUNE_RUNGS}")
            step_ms = statistics.median(m["step_ms"] for m in log[1:])
            check(step_ms / (ref_step_s * 1e3) <= TRAIN_WORKER_GATE,
                  f"phase 7c (a) lr {lr}: the worker's median {step_ms:.2f} ms/step is "
                  f"{step_ms / (ref_step_s * 1e3):.4f} x phase 7's {ref_step_s * 1e3:.2f} (gate {TRAIN_WORKER_GATE})")
            tok_s = tok_step / (step_ms / 1e3)
            last_commit = max(c for tid, _, c in commits_a.rows if tid == t.trial_id)
            per[lr] = dict(steps=st[-1], step_ms=step_ms, tok_s=tok_s, mfu=flops_per_token(cfg7, Tt) * tok_s / BF16_FLOPS,
                           pending_s=h0["t_report"] - t0, init_s=h0["init_s"], peak=max(m["peak"] for m in log),
                           window=(h0["t_start"], log[-1]["t_report"]), losses=[m["loss"] for m in h], pid=h0["pid"],
                           steps_s=sum(m["iter_s"] for m in log), first_iter_s=h0["iter_s"],
                           end_s=last_commit - log[-1]["t_report"],
                           last_commit=last_commit)
        want_a = [m["loss"] for m in ran[TUNE_LRS[0]]]
        check(want_a == fit_a_losses[:steps], f"phase 7c (a): the 3e-4 trial's losses {want_a} != phase 7b fit "
                                              f"A's {fit_a_losses[:steps]}")
        order = sorted(per, key=lambda lr: per[lr]["window"])
        windows = [per[lr]["window"] for lr in order]
        check(all(a[1] <= b[0] for a, b in zip(windows, windows[1:])), f"phase 7c (a): the train workers' windows "
                                                                        f"(first step's start, last step's report) "
                                                                        f"overlap: {windows}")
        # each trial's start: from fit() or the previous trial's last commit to its loop's start (the trial's
        # gang admitted, its trial actor started, the inner fit's worker group, train worker fork, nccl group
        # and dataset split)
        for prev, lr in zip([None, *order], order):
            per[lr]["start_s"] = per[lr]["window"][0] - (t0 if prev is None else per[prev]["last_commit"])
        best = grid.get_best_result("loss", "min")
        lasts = {t.config["lr"]: t.last_result["loss"] for t in trials}
        check(best.metrics["loss"] == min(lasts.values()) and best.config["lr"] == min(lasts, key=lasts.get),
              f"phase 7c (a): get_best_result gave lr {best.config['lr']} loss {best.metrics['loss']}, last losses "
              f"{lasts}")
        reports = sum(len(t.metrics_history) for t in trials)
        split = {k: sum(p[k] for p in per.values()) for k in ("start_s", "init_s", "steps_s", "end_s")}
        outside = wall - split["init_s"] - split["steps_s"]
        stopped = {lr: p["steps"] for lr, p in per.items() if p["steps"] < steps}
        # the worse rate, run second, trails the first at rung 2: ASHA's stop-at-a-rung path must run
        check(len(stopped) >= 1, f"phase 7c (a): ASHA stopped no trial at a rung {TUNE_RUNGS} (order {order}, "
                                 f"committed steps {({lr: p['steps'] for lr, p in per.items()})})")
        out["a"] = dict(per=per, wall=wall, outside_s=outside, per_report_s=outside / reports, split=split,
                        rest_s=outside - split["start_s"] - split["end_s"], release_s=release_s, stopped=stopped,
                        launches=[sum(m["launches"][i] for h in ran.values() for m in h) for i in range(3)],
                        best=best.config["lr"], order=order)
        for lr in order:
            p = per[lr]
            print(f"phase 7c (a) trial lr {lr} (train worker pid {p['pid']}, CUDA_VISIBLE_DEVICES '0', nccl, "
                  f"cuda:0): ran {steps} steps, committed {p['steps']}, losses committed "
                  f"{[round(x, 4) for x in p['losses']]}, median {p['step_ms']:.2f} ms/step "
                  f"({p['step_ms'] / (ref_step_s * 1e3):.4f} x phase 7's), {p['tok_s']:.1f} tok/s, MFU {p['mfu']:.4f}, "
                  f"start {p['start_s']:.3f} s, init {p['init_s']:.3f} s, steps {p['steps_s']:.3f} s (step 1 "
                  f"{p['first_iter_s']:.3f} s), last step to "
                  f"last commit {p['end_s']:.3f} s, fit() to first step reported {p['pending_s']:.3f} s, peak "
                  f"allocated {p['peak']} bytes {card}")
        print(f"phase 7c (a) Tuner(JaxTrainer) over lr {list(TUNE_LRS)} with ASHA(grace 2, rf 2, max_t {steps}): "
              f"{len(TUNE_LRS)} trials, none in ERROR, one train worker at a time on the card (order {order}); stopped early "
              f"{len(stopped)} ({stopped}: their committed reports; each worker ran all {steps} steps, since the "
              f"trainer reports once its fit returns); the 3e-4 trial's losses equal phase 7b fit A's; best lr "
              f"{best.config['lr']}; K1/K2/K3 36/18/18 in every step; wall {wall:.3f} s: workers' init "
              f"{split['init_s']:.3f} s, steps {split['steps_s']:.3f} s, the rest {outside:.3f} s "
              f"({outside / reports:.3f} s a report over {reports} reports): trial starts {split['start_s']:.3f} s, "
              f"last steps to last commits {split['end_s']:.3f} s, other {out['a']['rest_s']:.3f} s; actors gone "
              f"and the card's memory back {release_s:.3f} s after fit() {card}")
        end_leg("(a)")

        # ---- (b): a GPU trial actor checkpoints, fails, and resumes through Tuner.restore
        rtt.init(num_cpus=4)
        marker = os.path.join(tmp, "b_fixed")
        commits = CommitTimes()
        fn = tune.with_resources(card_trial, {"CPU": 1, "GPU": 1})
        space = dict(lr=TUNE_LRS[0], cfg=dataclasses.asdict(cfg7), batch=(Bt, Tt), steps=steps,
                     save_at=TUNE_SAVE_STEP, fail_at=TUNE_FAIL_STEP, tmp=tmp, marker=marker)
        t0 = time.time()
        g1 = tune.Tuner(fn, param_space=space, tune_config=tune.TuneConfig(metric="loss", mode="min"),
                        run_config=train.RunConfig(name="tune_b", storage_path=tmp, callbacks=[commits])).fit()
        wall1 = time.time() - t0
        (t1,) = g1._trials
        h1 = t1.metrics_history
        check(t1.status == "ERROR" and [m["step"] for m in h1] == list(range(1, TUNE_FAIL_STEP + 1)),
              f"phase 7c (b): the first fit's trial {t1.status}, steps {[m['step'] for m in h1]}, error {t1.error}")
        settle("(b) first fit", [h1[0]["pid"]])
        path = os.path.join(tmp, "tune_b")
        check(tune.Tuner.can_restore(path), f"phase 7c (b): Tuner.can_restore({path!r}) is false")
        with open(marker, "w") as f:
            f.write("fixed")
        t_restore = time.time()
        g2 = tune.Tuner.restore(path, fn, resume_errored=True,
                                run_config=train.RunConfig(callbacks=[commits])).fit()
        wall2 = time.time() - t_restore
        (t2,) = g2._trials
        h2 = t2.metrics_history[len(h1):]
        resumed = [m["step"] for m in h2]
        check(t2.status == "TERMINATED" and resumed == list(range(TUNE_SAVE_STEP + 1, steps + 1)),
              f"phase 7c (b): the restored trial {t2.status}, steps after the restore {resumed}, error {t2.error}")
        check(h2[0]["resumed_at"] == TUNE_SAVE_STEP, f"phase 7c (b): resumed at {h2[0]['resumed_at']}")
        release_b = settle("(b)", [h1[0]["pid"], h2[0]["pid"]])
        for m0 in (h1[0], h2[0]):
            check(m0["count"] == 1 and m0["visible"] == "0", f"phase 7c (b): the trial actor sees {m0['count']} "
                                                             f"cards, CUDA_VISIBLE_DEVICES {m0['visible']!r}")
        for m in h1 + h2:
            check(m["launches"] == want_launches and m["lr"] == TUNE_LRS[0],
                  f"phase 7c (b) step {m['step']}: launches {m['launches']}, lr {m['lr']}")
        got = [m["loss"] for m in h1[:TUNE_SAVE_STEP] + h2]
        check(got == fit_a_losses[:steps], f"phase 7c (b): losses {got} (steps 1-{TUNE_SAVE_STEP}, then the resumed "
                                           f"{TUNE_SAVE_STEP + 1}-{steps}) != (a)'s 3e-4 trial's and 7b fit A's "
                                           f"{fit_a_losses[:steps]}")
        saved = h1[TUNE_SAVE_STEP - 1]
        commit_t = next(t for _, s_, t in commits.rows if s_ == TUNE_SAVE_STEP)
        stage_s = h1[TUNE_SAVE_STEP]["stage_s"]
        out["b"] = dict(save_s=saved["save_s"], stage_s=stage_s, commit_s=commit_t - saved["t_report"] - stage_s,
                        ckpt_bytes=saved["ckpt_bytes"], restore_s=h2[0]["init_s"], restart_s=h2[0]["t_report"] - t_restore,
                        wall=(wall1, wall2), release_s=release_b, peak=max(m["peak"] for m in h1 + h2),
                        launches=[sum(m["launches"][i] for m in h1 + h2) for i in range(3)])
        print(f"phase 7c (b) a function trainable in a trial actor bound to the card (with_resources {{'CPU': 1, "
              f"'GPU': 1}}, pids {h1[0]['pid']} then {h2[0]['pid']}, CUDA_VISIBLE_DEVICES '0'): checkpoint after step "
              f"{TUNE_SAVE_STEP} ({saved['ckpt_bytes']} bytes: save_pytree {saved['save_s']:.3f} s, the trial actor's "
              f"staging copy {stage_s:.3f} s, report to the controller's commit {out['b']['commit_s']:.3f} s more), the "
              f"injected failure after step {TUNE_FAIL_STEP}: the first fit ERROR in {wall1:.2f} s; Tuner.restore("
              f"resume_errored=True): the restored trial restored the checkpoint onto the card in "
              f"{h2[0]['init_s']:.3f} s, resumed at step {TUNE_SAVE_STEP + 1}, TERMINATED after step {steps} in "
              f"{wall2:.2f} s; restore() to the first resumed step's report {out['b']['restart_s']:.3f} s; losses "
              f"at steps 1-{steps} equal (a)'s 3e-4 trial's and 7b fit A's exactly; peak allocated {out['b']['peak']} "
              f"bytes; the card's memory back {release_b:.3f} s after fit() {card}")
        end_leg("(b)")
        shutil.rmtree(tmp)
        check(not os.path.exists(tmp), f"phase 7c: the checkpoints' directory {tmp} is still there")

        # ---- (c): an ActorPool of two engine actors serving phase 4's prompts
        rtt.init(num_cpus=4)
        ref = serve_run["tokens"]
        spec = dict(config=dataclasses.asdict(cfg))
        t0 = time.perf_counter()
        actors = [PoolEngine.remote(spec) for _ in range(2)]
        pool = ActorPool(actors)
        items = list(enumerate(prompts))
        ordered = list(pool.map(lambda a, v: a.generate.remote(v), items))
        t1 = time.perf_counter()
        unordered = list(pool.map_unordered(lambda a, v: a.generate.remote(v), items))
        t2 = time.perf_counter()
        counts = rtt.get([a.counts.remote() for a in actors])
        held = rtt.get(actors[0].check_kernels.remote([len(p) for p in prompts]))
        check([r["i"] for r in ordered] == list(range(len(prompts))),
              f"phase 7c (c): map returned items {[r['i'] for r in ordered]}, not in submission order")
        by_i = {r["i"]: r for r in unordered}
        check(sorted(by_i) == list(range(len(prompts))), f"phase 7c (c): map_unordered returned {sorted(by_i)}")
        same_m = sum(x == y for r in ordered for x, y in zip(r["tokens"], ref[r["i"]]))
        same_u = sum(x == y for r in unordered for x, y in zip(r["tokens"], ref[r["i"]]))
        check([r["tokens"] for r in ordered] == ref and [by_i[i]["tokens"] for i in range(len(prompts))] == ref,
              f"phase 7c (c): greedy tokens equal phase 4's in {same_m} (map) and {same_u} (map_unordered) of 256")
        check(len({c["pid"] for c in counts} | {os.getpid()}) == 3 and {r["pid"] for r in ordered + unordered}
              == {c["pid"] for c in counts}, f"phase 7c (c): served by {sorted({r['pid'] for r in ordered})} of the "
                                             f"actors' workers {[c['pid'] for c in counts]}")
        for c in counts:
            check(c["checksum"] == drv_checksum and c["device"].startswith("cuda"),
                  f"phase 7c (c): actor {c['pid']} weights checksum {c['checksum']} vs phase 4's {drv_checksum}, "
                  f"device {c['device']}")
            check(c["k1"] == cfg.num_layers * c["prefill_forwards"] > 0
                  and c["k4"] == cfg.num_layers * c["decode_steps"] > 0,
                  f"phase 7c (c): in worker {c['pid']} K1 {c['k1']} != {cfg.num_layers} x {c['prefill_forwards']} "
                  f"prefill forwards or K4 {c['k4']} != {cfg.num_layers} x {c['decode_steps']} decode steps")
        check(held["k1"]["ok"] and held["k4"]["ok"], f"phase 7c (c): K1/K4 held in actor {counts[0]['pid']}: {held}")
        for a in actors:
            rtt.kill(a)
        release_c = settle("(c)", [c["pid"] for c in counts])
        out["c"] = dict(counts=counts, held=held, map_s=t1 - t0, unordered_s=t2 - t1, release_s=release_c,
                        k1=sum(c["k1"] for c in counts), k4=sum(c["k4"] for c in counts))
        print(f"phase 7c (c) ActorPool of 2 engine actors (phase 4's engine from seed 0 in each, num_cpus=1; pids "
              f"{[c['pid'] for c in counts]}, ready in {[round(c['init_s'], 3) for c in counts]} s): map over phase "
              f"4's 8 prompts {t1 - t0:.3f} s from the pool's creation (results in submission order), map_unordered "
              f"{t2 - t1:.3f} s; greedy tokens 256 of 256 equal phase 4's in each; K1 {[c['k1'] for c in counts]} "
              f"(= 32 x prefill forwards {[c['prefill_forwards'] for c in counts]}), K4 {[c['k4'] for c in counts]} "
              f"(= 32 x decode steps {[c['decode_steps'] for c in counts]}), phase 4's engine: 32 per prefill forward "
              f"and 32 per decode step; K1 and K4 held in the first actor at each prompt's own shapes (K1 "
              f"{held['k1']['shapes']}, K4 {held['k4']['shapes']}: one prompt a call), max errors K1 o "
              f"{held['k1']['err_o']:.3g} lse {held['k1']['err_lse']:.3g}, K4 {held['k4']['err']:.3g}; timed at the "
              f"longest prompt's: K1 {held['k1']['shape']} {held['k1']['ms']:.4f} ms (plain "
              f"{held['k1']['plain_ms']:.4f}, SDPA {held['k1']['sdpa_ms']:.4f}, bound {held['k1']['bound_ms']:.4f}), "
              f"K4 {held['k4']['shape']} {held['k4']['ms']:.4f} ms (plain {held['k4']['plain_ms']:.4f}, bound "
              f"{held['k4']['bound_ms']:.4f}); peak allocated "
              f"{[c['peak'] for c in counts]} bytes; workers gone and the card's memory back {release_c:.3f} s after "
              f"the kill {card}")
        end_leg("(c)")
    finally:
        if context.maybe_client() is not None:
            rtt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    used1 = card_used(torch)
    check(abs(used1 - used0) <= RUNTIME_MEM_SLACK, f"phase 7c: the card's memory in use {used1} bytes after the "
                                                   f"phase vs {used0} before")
    out["launches"] = [x + y for x, y in zip(out["a"]["launches"], out["b"]["launches"])]
    print(f"phase 7c end: no actor, no worker, no rt segment, the staging root and every checkpoint byte removed, the "
          f"card's memory in use {used1} bytes vs {used0} before; phase 7c {time.perf_counter() - t_phase:.1f} s "
          f"{card}")
    return out


# ---------------------------------------------------------------- phase 7d: compiled graphs and device objects
DAG_TIMEOUT_S = 600  # each get of phase 7d (an engine actor's start, weights from seed 0, a tree's fetch)
DAG_HOP_EXECS = 300  # (b): executes of the three-actor chain timed, after one warm-up
DAG_RTT_WARM, DAG_RTT_CALLS = 10, 30  # (b): the direct round trip, as ray_tpu's gate times it


@remote(num_cpus=1)
class Summarise:
    """Phase 7d (a)'s CPU actor P: what the engine actor returned, with
    its own pid."""

    def summarise(self, out: dict) -> dict:
        return dict(out, n=len(out["tokens"]), summarised_by=os.getpid())


@remote(num_cpus=1)
class ChainAdd:
    """Phase 7d (b)'s chain stage."""

    def add(self, x):
        return x + 1

    def wait_modes(self) -> list:
        """How this stage's channel readers wait (experimental/channels.py)."""
        from ray_tpu_torch.experimental.channels import reader_modes

        return reader_modes()


def cpu_seconds() -> dict:
    """(pid, comm) -> CPU seconds (user + system) of every process the
    host's /proc lists: two readings apart say what ran in between."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                head, rest = f.read().rsplit(")", 1)
        except OSError:
            continue
        fields = rest.split()
        out[(int(pid), head.split("(", 1)[1])] = (int(fields[11]) + int(fields[12])) / tick
    return out


def _leaves(tree, is_leaf=None) -> list:
    from ray_tpu_torch.experimental.device_objects import tree_map

    out = []
    tree_map(out.append, tree, is_leaf)
    return out


@remote(num_cpus=1)
class TreeEngine:
    """Phase 7d (d)'s actors. The owner (``own=True``, bound to the card
    with ``num_gpus=1``) draws phase 4's weights from seed 0 on the card
    and registers them (``publish``); the consumer asks for no card, runs
    on it all the same and fetches the tree through the owner's export
    (``fetch``). Each serves phase 4's prompts from an engine over its
    tree, with K1's and K4's counters zeroed just before."""

    def __init__(self, spec: dict, own: bool):
        import torch

        from ray_tpu_torch.models.llama import LlamaConfig, init_params

        self.cfg = LlamaConfig(**spec["config"])
        self.params = init_params(self.cfg, torch.Generator(device="cuda").manual_seed(0)) if own else None
        self.eng = None

    def publish(self, me) -> dict:
        """Register every leaf (``device_put_tree``); in this process each
        ref resolves to the registered tensor itself."""
        from ray_tpu_torch.experimental import DeviceRef, device_get, device_put_tree

        refs = device_put_tree(self.params, owner_actor=me)
        flat = _leaves(refs, lambda x: isinstance(x, DeviceRef))
        same = all(device_get(r) is t for r, t in zip(flat, _leaves(self.params)))
        return dict(refs=refs, same=same and len(flat) == len(_leaves(self.params)), n=len(flat),
                    bytes=[t.numel() * t.element_size() for t in _leaves(self.params)])

    def fetch(self, refs) -> dict:
        """The tree from the owner, leaf by leaf (``device_get_tree``'s walk,
        each leaf timed to the card), then ``device_get_tree`` again: the
        cached objects."""
        import torch

        from ray_tpu_torch.experimental import DeviceRef, device_get, device_get_tree
        from ray_tpu_torch.experimental.device_objects import tree_map

        free0 = torch.cuda.mem_get_info()[0]
        leaves = []

        def timed(r):
            t0 = time.perf_counter()
            t = device_get(r)
            torch.cuda.synchronize()
            leaves.append(dict(dtype=r.dtype, shape=list(r.shape), bytes=t.numel() * t.element_size(),
                               s=time.perf_counter() - t0, got=(str(t.dtype).removeprefix("torch."), list(t.shape)),
                               device=str(t.device)))
            return t

        t0 = time.perf_counter()
        self.params = tree_map(timed, refs, lambda x: isinstance(x, DeviceRef))
        total_s = time.perf_counter() - t0
        again = device_get_tree(refs)
        cached = all(a is b for a, b in zip(_leaves(again), _leaves(self.params)))
        return dict(leaves=leaves, total_s=total_s, cached=cached, free0=free0, pid=os.getpid(),
                    visible=os.environ.get("CUDA_VISIBLE_DEVICES"))

    def build(self) -> dict:
        import torch

        t0 = time.perf_counter()
        self.eng = LLMEngine(self.cfg, self.params, telemetry_tags={"model": f"phase 7d actor {os.getpid()}"},
                             **SERVE_ENGINE_KWARGS)
        torch.cuda.synchronize()
        return dict(checksum=weights_checksum(self.params), build_s=time.perf_counter() - t0,
                    device=str(self.eng.device), pid=os.getpid())

    def generate(self, prompts) -> dict:
        return _generate(self.eng, prompts)

    def check_kernels(self, lens) -> dict:
        return hold_kernels(self.eng, lens)

    def free_and_export(self, ref) -> str | None:
        """Free one ref here, then ask for its export: the KeyError's text."""
        from ray_tpu_torch.experimental import export_for_transfer, free_device_object

        free_device_object(ref)
        try:
            export_for_transfer(ref.object_id)
        except KeyError as e:
            return str(e)
        return None

    def memory(self) -> dict:
        import torch

        free, total = torch.cuda.mem_get_info()
        return dict(free=free, total=total, allocated=torch.cuda.memory_allocated(),
                    reserved=torch.cuda.memory_reserved())


def _generate(eng, prompts, max_tokens: int = 32) -> dict:
    """Phase 4's prompts on ``eng`` (in this process), 32 greedy tokens
    each (or ``max_tokens``), K1's and K4's counters zeroed just before and
    read just after."""
    import torch

    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    flash_attention_fwd.launches = 0
    paged_attn_partials.launches = 0
    p0, d0 = eng.prefill_forwards, eng.decode_steps
    t0 = time.perf_counter()
    ids = [eng.add_request(p, SamplingParams(max_tokens=max_tokens)) for p in prompts]
    finals = {}
    while eng.has_unfinished():
        finals.update((o.request_id, o) for o in eng.step() if o.finished)
    torch.cuda.synchronize()
    outs = [finals[i] for i in ids]
    return dict(tokens=[list(o.token_ids) for o in outs], k1=flash_attention_fwd.launches,
                k4=paged_attn_partials.launches, wall_s=time.perf_counter() - t0,
                prefill_forwards=eng.prefill_forwards - p0, decode_steps=eng.decode_steps - d0, pid=os.getpid())


def dag_rings(dag) -> list:
    return sorted(n for n in os.listdir("/dev/shm") if f"_ch{dag._dag_id}_" in n)


def dag_on_card(torch, cfg, prompts, serve_run, drv_checksum, card) -> dict:
    """Phase 7d: compiled graphs and device objects on phase 4's engine
    (module docstring). (a)-(c) on one runtime with the default store; (d)
    on a fresh one whose store holds twice the tree's largest leaf."""
    import dataclasses
    import statistics

    import ray_tpu_torch as rtt
    from ray_tpu_torch.core import context
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.models.llama import torch_dtype
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    t_phase = time.perf_counter()
    ref = serve_run["tokens"]
    L = cfg.num_layers
    spec = dict(config=dataclasses.asdict(cfg))
    lens = [len(p) for p in prompts]
    drv_counts = (flash_attention_fwd.launches, paged_attn_partials.launches)
    torch.cuda.synchronize()
    used0 = card_used(torch)
    out = {}

    def gone(handles, pids, label):
        """Every handle's actor DEAD, ``pids`` gone, the card's memory back."""
        client = context.get_client()
        t_end = time.perf_counter()

        def held():
            live = [h for h in handles if client.actors[h._actor_id].info.state != "DEAD"]
            return live or any(worker_alive(p) for p in pids) or card_used(torch) > used0 + RUNTIME_MEM_SLACK

        while held() and time.perf_counter() - t_end < DATA_RELEASE_S:
            time.sleep(0.05)
        check(not held(), f"phase 7d {label}: {DATA_RELEASE_S} s after the kill, actors alive "
                          f"{[h for h in handles if client.actors[h._actor_id].info.state != 'DEAD']}, workers "
                          f"{[p for p in pids if worker_alive(p)]}, the card's memory in use {card_used(torch)} vs "
                          f"{used0} before 7d")
        return time.perf_counter() - t_end

    def end_runtime(label):
        client = context.get_client()
        pids = [p for node in client.nodes.values() for p in node.worker_pids]
        rtt.shutdown()
        check(not [p for p in pids if worker_alive(p)], f"phase 7d {label}: workers left after shutdown")
        check(not rt_segments(), f"phase 7d {label}: /dev/shm still holds {rt_segments()}")
        check((flash_attention_fwd.launches, paged_attn_partials.launches) == drv_counts,
              f"phase 7d {label}: K1/K4 launched in the driver")

    try:
        # ---- (a): a channel-compiled graph over a GPU engine actor E and a CPU actor P
        rtt.init(num_cpus=8)  # E, P and (b)'s three stages hold a CPU each
        t0 = time.perf_counter()
        E = PoolEngine.options(num_gpus=1).remote(spec)  # phase 4's engine; its counters zeroed once built
        P = Summarise.remote()
        facts = rtt.get(E.counts.remote(), timeout=DAG_TIMEOUT_S)
        ready_s = time.perf_counter() - t0
        with InputNode() as inp:
            dag = P.summarise.bind(E.generate.bind(inp))
        t0 = time.perf_counter()
        comp = dag.experimental_compile(channels=True)
        compile_s = time.perf_counter() - t0
        items = list(enumerate(prompts))
        t0 = time.perf_counter()
        refs = [comp.execute(it) for it in items]  # all 8 in flight (nslots 8)
        inflight = [r.get(timeout=DAG_TIMEOUT_S) for r in refs]
        inflight_s = time.perf_counter() - t0
        per_exec, per_remote = [], []
        for it in items:  # one at a time: each execute beside the same calls through .remote()
            t0 = time.perf_counter()
            r1 = comp.execute(it).get(timeout=DAG_TIMEOUT_S)
            per_exec.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            r2 = rtt.get(P.summarise.remote(E.generate.remote(it)), timeout=DAG_TIMEOUT_S)
            per_remote.append(time.perf_counter() - t0)
            check(r1["tokens"] == r2["tokens"] == ref[it[0]], f"phase 7d (a): prompt {it[0]}'s tokens through the "
                                                              f"graph and through .remote() differ from phase 4's")
        counts = rtt.get(E.counts.remote(), timeout=DAG_TIMEOUT_S)
        held = rtt.get(E.check_kernels.remote(lens), timeout=DAG_TIMEOUT_S)
        same = sum(x == y for r in inflight for x, y in zip(r["tokens"], ref[r["i"]]))
        check([r["i"] for r in inflight] == list(range(len(prompts))) and [r["tokens"] for r in inflight] == ref,
              f"phase 7d (a): {same} of 256 greedy tokens through the compiled graph equal phase 4's")
        p_pids = {r["summarised_by"] for r in inflight}
        check({r["pid"] for r in inflight} == {counts["pid"]} and len(p_pids) == 1 and counts["pid"] not in p_pids
              and os.getpid() not in p_pids | {counts["pid"]}, f"phase 7d (a): served by {[r['pid'] for r in inflight]}"
                                                               f", summarised by {p_pids}, E is {counts['pid']}")
        check(counts["checksum"] == drv_checksum and counts["device"].startswith("cuda") and counts["visible"] == "0",
              f"phase 7d (a): E's checksum {counts['checksum']} vs {drv_checksum}, device {counts['device']}, "
              f"CUDA_VISIBLE_DEVICES {counts['visible']!r}")
        check(counts["k1"] == L * counts["prefill_forwards"] > 0 and counts["k4"] == L * counts["decode_steps"] > 0,
              f"phase 7d (a): in E's worker K1 {counts['k1']} != {L} x {counts['prefill_forwards']} prefill forwards "
              f"or K4 {counts['k4']} != {L} x {counts['decode_steps']} decode steps")
        check(held["k1"]["ok"] and held["k4"]["ok"], f"phase 7d (a): K1/K4 held in E's worker: {held}")
        check((flash_attention_fwd.launches, paged_attn_partials.launches) == drv_counts,
              "phase 7d (a): K1/K4 launched in the driver")
        out["a"] = dict(counts=counts, held=held, ready_s=ready_s, compile_s=compile_s, inflight_s=inflight_s,
                        per_exec=per_exec, per_remote=per_remote)
        print(f"phase 7d (a) a channel-compiled graph P.summarise(E.generate(input)) (E: num_gpus=1, pid "
              f"{counts['pid']}, phase 4's engine from seed 0, ready {ready_s:.3f} s; P: a CPU actor, pid "
              f"{p_pids.pop()}): compiled in {compile_s:.3f} s; phase 4's 8 prompts, one per execute(), all 8 in "
              f"flight: {inflight_s:.3f} s, 256 of 256 greedy tokens equal phase 4's; one at a time: "
              f"{statistics.median(per_exec) * 1e3:.2f} ms per execute (median; min {min(per_exec) * 1e3:.2f}, max "
              f"{max(per_exec) * 1e3:.2f}) vs {statistics.median(per_remote) * 1e3:.2f} ms for the same calls through "
              f".remote() (min {min(per_remote) * 1e3:.2f}, max {max(per_remote) * 1e3:.2f}), ratio "
              f"{statistics.median(per_exec) / statistics.median(per_remote):.4f}; in E's worker K1 {counts['k1']} "
              f"(= {L} x {counts['prefill_forwards']} prefill forwards), K4 {counts['k4']} (= {L} x "
              f"{counts['decode_steps']} decode steps), none in the driver; held in E's worker at each prompt's "
              f"shapes (K1 {held['k1']['shapes']}, K4 {held['k4']['shapes']}), max errors K1 o "
              f"{held['k1']['err_o']:.3g} lse {held['k1']['err_lse']:.3g}, K4 {held['k4']['err']:.3g}; K1 "
              f"{held['k1']['shape']} {held['k1']['ms']:.4f} ms (plain {held['k1']['plain_ms']:.4f}, SDPA "
              f"{held['k1']['sdpa_ms']:.4f}, bound {held['k1']['bound_ms']:.4f}), K4 {held['k4']['shape']} "
              f"{held['k4']['ms']:.4f} ms (plain {held['k4']['plain_ms']:.4f}, bound {held['k4']['bound_ms']:.4f}) "
              f"{card}")

        # ---- (b): hop latency, a three-actor chain against the direct round trip (ray_tpu's gate)
        rtt.get([noop.remote() for _ in range(DAG_RTT_WARM)], timeout=DAG_TIMEOUT_S)
        t0 = time.perf_counter()
        for _ in range(DAG_RTT_CALLS):
            rtt.get(noop.remote(), timeout=DAG_TIMEOUT_S)
        task_rt = (time.perf_counter() - t0) / DAG_RTT_CALLS
        stages = [ChainAdd.remote() for _ in range(3)]
        with InputNode() as inp:
            chain = stages[2].add.bind(stages[1].add.bind(stages[0].add.bind(inp)))
        comp2 = chain.experimental_compile(channels=True)
        check(comp2.execute(0).get(timeout=DAG_TIMEOUT_S) == 3, "phase 7d (b): the chain's warm-up result")
        cpu0 = cpu_seconds()
        execs = []
        t0 = time.perf_counter()
        for i in range(DAG_HOP_EXECS):
            t1 = time.perf_counter()
            check(comp2.execute(i).get(timeout=DAG_TIMEOUT_S) == i + 3, f"phase 7d (b): execute {i}")
            execs.append(time.perf_counter() - t1)
        per_exec2 = (time.perf_counter() - t0) / DAG_HOP_EXECS
        cpu1 = cpu_seconds()
        hop = per_exec2 / 4  # driver -> a -> b -> c -> driver
        # what waited how, and what else ran on the host's cores meanwhile
        modes = [m for st in stages for m in rtt.get(st.wait_modes.remote(), timeout=DAG_TIMEOUT_S)]
        from ray_tpu_torch.experimental.channels import reader_modes

        modes += [dict(m, name="driver " + m["name"]) for m in reader_modes()]
        busy = sorted(((round(c - cpu0.get(k, 0.0), 3), k[1], k[0]) for k, c in cpu1.items()
                       if c - cpu0.get(k, 0.0) > 0), reverse=True)[:8]
        srt = sorted(execs)
        dist = dict(mean_us=per_exec2 * 1e6, median_us=statistics.median(execs) * 1e6,
                    p90_us=srt[int(0.9 * len(srt))] * 1e6, max_us=srt[-1] * 1e6)
        diag = (f"per execute: mean {dist['mean_us']:.1f} us, median {dist['median_us']:.1f}, p90 {dist['p90_us']:.1f}, "
                f"max {dist['max_us']:.1f}; readers (mode, phase, received): "
                f"{[(m['name'][-12:], m['mode'], m['phase'], m['received']) for m in modes]}; "
                f"CPU seconds during the executes, busiest processes (s, comm, pid): {busy}")
        check(hop < task_rt / 4, f"phase 7d (b): a hop {hop * 1e6:.1f} us is not under a quarter of the direct round "
                                 f"trip {task_rt * 1e6:.1f} us; {diag}")
        out["b"] = dict(hop_us=hop * 1e6, rtt_us=task_rt * 1e6, exec_us=per_exec2 * 1e6, **dist)
        print(f"phase 7d (b) hop latency: a three-actor chain of add over {DAG_HOP_EXECS} executes, "
              f"{per_exec2 * 1e6:.1f} us per execute, {hop * 1e6:.1f} us per hop (4 hops) vs the direct call's round "
              f"trip {task_rt * 1e6:.1f} us (mean of {DAG_RTT_CALLS} after {DAG_RTT_WARM}); gate: a hop under a "
              f"quarter of the round trip ({task_rt / 4 * 1e6:.1f} us), {task_rt / hop:.1f}x; {diag} {card}")

        # ---- (c): teardown kills the graphs' actors and leaves no ring
        rings = {id(comp): dag_rings(comp), id(comp2): dag_rings(comp2)}
        check(all(rings.values()), f"phase 7d (c): the graphs' rings before teardown {rings}")
        t0 = time.perf_counter()
        comp.teardown(kill_actors=True)
        comp2.teardown(kill_actors=True)
        teardown_s = time.perf_counter() - t0
        release = gone([E, P, *stages], [counts["pid"]], "(c)")
        left = dag_rings(comp) + dag_rings(comp2)
        check(not left, f"phase 7d (c): rings left after teardown: {left}")
        out["c"] = dict(teardown_s=teardown_s, release_s=release, rings=sum(len(r) for r in rings.values()))
        print(f"phase 7d (c) teardown(kill_actors=True) of both graphs: {teardown_s:.3f} s; their "
              f"{out['c']['rings']} rings gone from /dev/shm, all 5 actors DEAD, E's worker gone and the card's "
              f"memory back {release:.3f} s after {card}")
        end_runtime("(a)-(c)")

        # ---- (d): device objects across processes
        es = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
        largest = es * max(L * cfg.hidden_size * cfg.intermediate_size, cfg.vocab_size * cfg.hidden_size)  # w_gate
        store = 2 * largest  # one leaf in flight while the previous one is released
        rtt.init(num_cpus=4, _system_config={"object_store_memory": store})
        owner = TreeEngine.options(num_gpus=1).remote(spec, True)
        pub = rtt.get(owner.publish.remote(owner), timeout=DAG_TIMEOUT_S)
        check(pub["same"], "phase 7d (d): in the owner's process a DeviceRef did not resolve to the tensor itself")
        check(max(pub["bytes"]) == largest, f"phase 7d (d): the largest leaf {max(pub['bytes'])} bytes, "
                                            f"the store sized for {largest}")
        o_built = rtt.get(owner.build.remote(), timeout=DAG_TIMEOUT_S)
        o_run = rtt.get(owner.generate.remote(prompts), timeout=DAG_TIMEOUT_S)
        shm = os.statvfs("/dev/shm")
        shm_free = shm.f_bavail * shm.f_frsize
        consumer = TreeEngine.options(num_cpus=1).remote(spec, False)
        fetched = rtt.get(consumer.fetch.remote(pub["refs"]), timeout=DAG_TIMEOUT_S)
        c_built = rtt.get(consumer.build.remote(), timeout=DAG_TIMEOUT_S)
        c_run = rtt.get(consumer.generate.remote(prompts), timeout=DAG_TIMEOUT_S)
        c_held = rtt.get(consumer.check_kernels.remote(lens), timeout=DAG_TIMEOUT_S)
        mem = rtt.get(consumer.memory.remote(), timeout=DAG_TIMEOUT_S)
        first = _leaves(pub["refs"], lambda x: hasattr(x, "object_id"))[0]
        freed = rtt.get(owner.free_and_export.remote(first), timeout=DAG_TIMEOUT_S)
        check(o_built["checksum"] == c_built["checksum"] == drv_checksum,
              f"phase 7d (d): checksums owner {o_built['checksum']}, consumer {c_built['checksum']}, phase 4's "
              f"{drv_checksum}")
        same_c = sum(x == y for a, b in zip(c_run["tokens"], o_run["tokens"]) for x, y in zip(a, b))
        check(c_run["tokens"] == o_run["tokens"] == ref, f"phase 7d (d): the consumer's greedy tokens equal the "
                                                         f"owner's in {same_c} of 256 (and phase 4's: "
                                                         f"{o_run['tokens'] == ref})")
        check(fetched["cached"], "phase 7d (d): a second device_get_tree did not return the cached objects")
        kept = all(lf["got"] == (lf["dtype"], lf["shape"]) and lf["device"].startswith("cuda")
                   for lf in fetched["leaves"])
        check(kept and len(fetched["leaves"]) == pub["n"], f"phase 7d (d): leaves' dtypes, shapes or devices "
                                                           f"changed: {fetched['leaves']}")
        check(fetched["visible"] is None and c_built["device"].startswith("cuda") and fetched["pid"] != o_run["pid"],
              f"phase 7d (d): the consumer (pid {fetched['pid']}) CUDA_VISIBLE_DEVICES {fetched['visible']!r}, "
              f"device {c_built['device']}")
        for run, who in ((o_run, "owner"), (c_run, "consumer")):
            check(run["k1"] == L * run["prefill_forwards"] > 0 and run["k4"] == L * run["decode_steps"] > 0,
                  f"phase 7d (d): in the {who}'s worker K1 {run['k1']}, K4 {run['k4']} for "
                  f"{run['prefill_forwards']} prefill forwards and {run['decode_steps']} decode steps")
        check(c_held["k1"]["ok"] and c_held["k4"]["ok"], f"phase 7d (d): K1/K4 held in the consumer: {c_held}")
        check(freed is not None and first.object_id in freed, f"phase 7d (d): the owner's export after "
                                                               f"free_device_object: {freed!r}")
        check((flash_attention_fwd.launches, paged_attn_partials.launches) == drv_counts,
              "phase 7d (d): K1/K4 launched in the driver")
        total_b = sum(lf["bytes"] for lf in fetched["leaves"])
        out["d"] = dict(fetch_s=fetched["total_s"], bytes=total_b, leaves=fetched["leaves"], o_run=o_run,
                        c_run=c_run, held=c_held, mem=mem, shm_free=shm_free, store=store)
        per_leaf = ", ".join(f"{'x'.join(map(str, lf['shape']))} {lf['bytes']} B {lf['bytes'] / lf['s'] / 1e9:.2f} "
                             f"GB/s" for lf in fetched["leaves"])
        print(f"phase 7d (d) device objects: the owner (num_gpus=1, pid {o_run['pid']}) registered phase 4's "
              f"{pub['n']} leaves ({sum(pub['bytes'])} bytes, bf16, from seed 0) with device_put_tree(owner_actor="
              f"itself), each resolving in process to the tensor itself; /dev/shm {shm_free} bytes free before the "
              f"fetch, the store sized {store} bytes (twice the largest leaf, {largest}); the consumer (asking for no "
              f"card, CUDA_VISIBLE_DEVICES unset, pid {fetched['pid']}) fetched the tree in "
              f"{fetched['total_s']:.3f} s ({total_b / fetched['total_s'] / 1e9:.3f} GB/s): {per_leaf}; a second "
              f"device_get_tree returned the cached objects; every leaf's dtype and shape kept; the consumer's engine "
              f"over the fetched tree: 256 of 256 greedy tokens equal the owner's engine's and phase 4's, K1 "
              f"{c_run['k1']} / K4 {c_run['k4']} in its worker ({o_run['k1']} / {o_run['k4']} in the owner's), held "
              f"there: K1 {c_held['k1']['shape']} {c_held['k1']['ms']:.4f} ms (err o {c_held['k1']['err_o']:.3g}), "
              f"K4 {c_held['k4']['shape']} {c_held['k4']['ms']:.4f} ms (err {c_held['k4']['err']:.3g}); the card's "
              f"free memory with both engines {mem['free']} bytes (the consumer's reserve {mem['reserved']}); after "
              f"free_device_object the owner's export raised KeyError {freed!r} {card}")
        for h in (owner, consumer):
            rtt.kill(h)
        release_d = gone([owner, consumer], [o_run["pid"], fetched["pid"]], "(d)")
        out["d"]["release_s"] = release_d
        end_runtime("(d)")
    finally:
        if context.maybe_client() is not None:
            rtt.shutdown()
    torch.cuda.synchronize()
    print(f"phase 7d end: no actor, no worker, no rt segment, the card's memory in use {card_used(torch)} bytes vs "
          f"{used0} before; phase 7d {time.perf_counter() - t_phase:.1f} s {card}")
    return out


# ---------------------------------------------------------------- phase 8: RLlib on the card
RL_UPDATE_TOL = dict(loss_rtol=1e-4, loss_atol=1e-5, param_atol=1e-4)  # card vs host, f32 (TF32 off): one update
RL_TIMED_UPDATES = 5  # each learner's update timed this many times after the compared one
RL_ALLREDUCE_UPDATES = 5  # (b)'s learner actors: updates, one allreduce each


class Box:
    """CartPole-v1's observation space without gymnasium: 4 floats."""

    shape = (4,)


class Discrete:
    """CartPole-v1's action space without gymnasium: 2 actions."""

    n = 2


def cartpole_batches(rng) -> dict:
    """Seeded batches of CartPole-v1's shapes for one update of each
    algorithm: PPO's 2048 rows (ray_tpu's _ppo_config), IMPALA's and
    APPO's 40 fragments of 100 steps (train batch 4000)."""
    n, N, T = 2048, 40, 100
    ppo = {"obs": rng.normal(size=(n, 4)).astype(np.float32), "actions": rng.integers(0, 2, n),
           "logp": (np.log(0.5) + 0.1 * rng.normal(size=n)).astype(np.float32),
           "advantages": rng.normal(size=n).astype(np.float32),
           "value_targets": (5.0 * rng.normal(size=n)).astype(np.float32),
           "vf_preds": rng.normal(size=n).astype(np.float32)}
    mask = np.ones((N, T), np.float32)
    mask[::7, 60:] = 0.0  # some fragments end early
    nonterminal = np.ones((N, T), np.float32)
    nonterminal[::7, 59] = 0.0
    seq = {"obs": rng.normal(size=(N, T + 1, 4)).astype(np.float32), "actions": rng.integers(0, 2, (N, T)),
           "rewards": np.ones((N, T), np.float32), "logp": (np.log(0.5) + 0.1 * rng.normal(size=(N, T))).astype(
               np.float32), "mask": mask, "nonterminal": nonterminal}
    return {"ppo": ppo, "seq": seq}


def rl_setup(name: str):
    """(learner class, CartPole-v1's module spec, config) of ray_tpu's
    learning cases' settings for ``name``."""
    from ray_tpu_torch.rllib import APPOConfig, IMPALAConfig, PPOConfig
    from ray_tpu_torch.rllib.algorithms.appo.appo import APPOLearner
    from ray_tpu_torch.rllib.algorithms.impala.impala import IMPALALearner
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import MLPModule, RLModuleSpec

    cls, cfg = {"ppo": (PPOLearner, PPOConfig().training(lr=1e-3, gamma=0.98, lambda_=0.8, minibatch_size=256)),
                "impala": (IMPALALearner, IMPALAConfig().training(lr=1e-3, entropy_coeff=0.005, vf_loss_coeff=0.25)),
                "appo": (APPOLearner, APPOConfig().training(lr=1e-3, entropy_coeff=0.005, vf_loss_coeff=0.25))}[name]
    return cls, RLModuleSpec(MLPModule, Box(), Discrete(), {"fcnet_hiddens": (256, 256)}), cfg


def rl_learner_pair(name: str) -> list:
    """The algorithm's learner on the card and on the host, both from seed 0."""
    return rl_pair(*rl_setup(name))


def rl_pair(cls, spec, cfg) -> list:
    """``cls`` on the card and on the host, both from seed 0."""
    out = []
    for device in (None, "cpu"):
        c = cfg.copy()
        c.device = device
        ln = cls(spec, c)
        ln.build(seed=0)
        out.append(ln)
    return out


def rl_gate(name: str, mc: dict, mh: dict, on_card, on_host, extra=()) -> float:
    """One update card vs host: the metrics within RL_UPDATE_TOL's loss
    tolerances, every parameter (and each (card tensor, host tensor) pair
    of ``extra``) within its param_atol; the largest parameter error."""
    check({p.device.type for p in on_card.module.parameters()} == {"cuda"},
          f"phase 8 {name}: the learner's parameters are not on the card")
    loss_err = max(abs(mc[k] - mh[k]) - RL_UPDATE_TOL["loss_rtol"] * abs(mh[k]) for k in mh)
    sc, sh = on_card.module.state_dict(), on_host.module.state_dict()
    pairs = [(sc[k], sh[k]) for k in sh] + list(extra)
    param_err = max((c.cpu().float() - h.float()).abs().max().item() for c, h in pairs)
    check(mc.keys() == mh.keys() and all(np.isfinite(v) for v in mc.values())
          and loss_err <= RL_UPDATE_TOL["loss_atol"] and param_err <= RL_UPDATE_TOL["param_atol"],
          f"phase 8 {name}: one update on the card vs the host: metrics {mc} vs {mh}, parameters differ by "
          f"{param_err:.3g} (tolerances {RL_UPDATE_TOL})")
    return param_err


def rl_update(torch, ln, name, batch) -> tuple[dict, float]:
    t0 = time.perf_counter()
    if name == "ppo":
        m = ln.update(batch, minibatch_size=256, num_epochs=1, seed=0)
    else:
        m = ln.update(batch, num_epochs=1, shuffle=False)
    if ln.device.type == "cuda":
        torch.cuda.synchronize()
    return m, time.perf_counter() - t0


def rllib_on_card(torch, card) -> dict:
    """Phase 8: RLlib on the card (module docstring). The learner legs run
    always; the env legs only where gymnasium is installed."""
    import importlib.util
    import statistics

    import ray_tpu_torch as rtt
    from ray_tpu_torch.core import context
    from ray_tpu_torch.rllib.algorithms.impala.impala import IMPALALearner
    from ray_tpu_torch.rllib.core.learner import LearnerGroup

    t_phase = time.perf_counter()
    has_gym = importlib.util.find_spec("gymnasium") is not None
    if has_gym:
        import gymnasium

        print(f"phase 8 gymnasium probe: gymnasium {gymnasium.__version__} present: the env legs run {card}")
    else:
        print(f"phase 8 gymnasium probe: gymnasium absent: the learner legs run, the env legs wait for gymnasium on "
              f"this machine {card}")
    out = {"gymnasium": has_gym}
    batches = cartpole_batches(np.random.default_rng(0))
    for name in ("ppo", "impala", "appo"):
        on_card, on_host = rl_learner_pair(name)
        batch = batches["ppo" if name == "ppo" else "seq"]
        mc, _ = rl_update(torch, on_card, name, batch)
        mh, _ = rl_update(torch, on_host, name, batch)
        param_err = rl_gate(name, mc, mh, on_card, on_host)
        t_card = [rl_update(torch, on_card, name, batch)[1] for _ in range(RL_TIMED_UPDATES)]
        t_host = [rl_update(torch, on_host, name, batch)[1] for _ in range(RL_TIMED_UPDATES)]
        steps = 8 if name == "ppo" else 1  # minibatch steps in one update
        out[name] = dict(card_ms=min(t_card) * 1e3, host_ms=min(t_host) * 1e3, steps=steps, param_err=param_err,
                         metrics=mc)
        print(f"phase 8 {name} learner update on the card (MLP 4 -> 256 -> 256 -> 2 and -> 1, f32, Adam, clip "
              f"{on_card.config.grad_clip}): one update of CartPole-v1's shapes ({steps} minibatch step(s)) "
              f"{min(t_card) * 1e3:.3f} ms (least of {RL_TIMED_UPDATES}; {min(t_card) * 1e3 / steps:.3f} ms a step) "
              f"vs the same update on the host in process {min(t_host) * 1e3:.3f} ms; first update's metrics card "
              f"{ {k: round(v, 6) for k, v in mc.items()} } vs host { {k: round(v, 6) for k, v in mh.items()} }, "
              f"parameters within {param_err:.3g} {card}")
        del on_card, on_host
    torch.cuda.empty_cache()

    # ---- (b)'s allreduce: two learner actors on the card (asking for no card) averaging gradients
    try:
        rtt.init(num_cpus=4)
        _, spec, cfg = rl_setup("impala")
        group = LearnerGroup(IMPALALearner, spec, cfg, num_learners=2)
        rng = np.random.default_rng(1)
        t0 = time.perf_counter()
        for _ in range(RL_ALLREDUCE_UPDATES):
            ms = group.update(cartpole_batches(rng)["seq"], num_epochs=1, shuffle=False)
        upd_s = (time.perf_counter() - t0) / RL_ALLREDUCE_UPDATES
        actors = group._actors
        weights = rtt.get([a.get_weights.remote() for a in actors], timeout=DAG_TIMEOUT_S)
        devices = rtt.get([a.devices.remote() for a in actors], timeout=DAG_TIMEOUT_S)
        syncs = rtt.get([a.sync_ms.remote() for a in actors], timeout=DAG_TIMEOUT_S)
        check(all(d == ["cuda:0"] for d in devices), f"phase 8 (b): the learner actors' parameters on {devices}")
        check(all(torch.equal(weights[0][k], weights[1][k]) for k in weights[0]),
              "phase 8 (b): the two learners' weights differ after the allreduced updates")
        check([len(s) for s in syncs] == [RL_ALLREDUCE_UPDATES] * 2 and all(np.isfinite(m["total_loss"]) for m in ms),
              f"phase 8 (b): allreduces {[len(s) for s in syncs]}, metrics {ms}")
        group.stop()
        out["allreduce"] = dict(ms=[x for s in syncs for x in s], update_s=upd_s)
        flat = sorted(out["allreduce"]["ms"])
        print(f"phase 8 (b) IMPALA's learner group: 2 learner actors on the card (asking for no card), "
              f"{RL_ALLREDUCE_UPDATES} updates of 40 x 100 CartPole-shaped rows (20 fragments each), one allreduce "
              f"of {sum(w.numel() for w in weights[0].values())} f32 gradients a minibatch through the collective's "
              f"object-store backend: {statistics.median(flat):.3f} ms median (min {flat[0]:.3f}, max {flat[-1]:.3f}); "
              f"{upd_s * 1e3:.1f} ms an update through the group; both learners' weights equal {card}")
        out.update(rllib_offpolicy_legs(torch, card))
        if has_gym:
            out.update(rllib_env_legs(torch, card))
            out.update(rllib_offpolicy_env_legs(torch, card))
    finally:
        if context.maybe_client() is not None:
            rtt.shutdown()
    print(f"phase 8 end: phase 8 {time.perf_counter() - t_phase:.1f} s {card}")
    return out


def rllib_env_legs(torch, card) -> dict:
    """Phase 8 (a)-(c) where gymnasium is installed: ray_tpu's PPO,
    multi-learner IMPALA and APPO learning configurations with the
    learners on the card (the runtime is up, 4 CPUs)."""
    import statistics

    import ray_tpu_torch as rtt
    from ray_tpu_torch.rllib import APPOConfig, IMPALAConfig, PPOConfig

    out = {}
    ppo = (PPOConfig().environment("CartPole-v1").env_runners(num_env_runners=0, num_envs_per_env_runner=8)
           .training(lr=1e-3, gamma=0.98, lambda_=0.8, train_batch_size=2048, minibatch_size=256, num_epochs=20)
           .debugging(seed=0))
    algo = ppo.build_algo()
    try:
        devs = {p.device.type for p in algo.learner_group._local.module.parameters()}
        check(devs == {"cuda"}, f"phase 8 (a): the PPO learner's parameters on {devs}")
        best, iters = 0.0, []
        for _ in range(15):
            r = algo.train()
            best = max(best, r["env_runners"]["episode_return_mean"])
            iters.append((r["time_this_iter_s"], r["timers"]["sample_s"], r["timers"]["learn_s"]))
            if best >= 150:
                break
    finally:
        algo.stop()
    check(best >= 120, f"phase 8 (a): PPO's best episode_return_mean {best} < 120")
    steps = algo._total_env_steps
    wall = sum(i[0] for i in iters)
    out["ppo_env"] = dict(best=best, iters=iters, steps_per_s=steps / wall)
    print(f"phase 8 (a) PPO on CartPole-v1 (ray_tpu's _ppo_config, learner on the card): best episode_return_mean "
          f"{best:.1f} (gate 120) in {len(iters)} iterations; each iteration's wall / sampling / learning s "
          f"{[tuple(round(x, 3) for x in i) for i in iters]}; {steps / wall:.1f} env steps/s {card}")
    imp = (IMPALAConfig().environment("CartPole-v1").env_runners(num_env_runners=2, num_envs_per_env_runner=4)
           .training(lr=1e-3, train_batch_size=4000, entropy_coeff=0.005, rollout_fragment_length=100,
                     vf_loss_coeff=0.25).learners(num_learners=2).debugging(seed=0))
    algo = imp.build_algo()
    try:
        rets = [algo.train()["env_runners"]["episode_return_mean"] for _ in range(6)]
        w = rtt.get([a.get_weights.remote() for a in algo.learner_group._actors], timeout=DAG_TIMEOUT_S)
        syncs = rtt.get([a.sync_ms.remote() for a in algo.learner_group._actors], timeout=DAG_TIMEOUT_S)
    finally:
        algo.stop()
    check(np.isfinite(rets[-1]) and rets[-1] > 21, f"phase 8 (b): IMPALA's returns {rets}")
    check(all(torch.equal(w[0][k], w[1][k]) for k in w[0]), "phase 8 (b): the learners' weights differ")
    flat = sorted(x for s in syncs for x in s)
    print(f"phase 8 (b) IMPALA, 2 env runners and 2 learner actors on the card: returns {[round(r, 1) for r in rets]} "
          f"(gate: the last > 21, finite), both learners' weights equal; allreduce {statistics.median(flat):.3f} ms "
          f"a minibatch (median of {len(flat)}) {card}")
    appo = (APPOConfig().environment("CartPole-v1").env_runners(num_env_runners=0, num_envs_per_env_runner=8)
            .training(lr=1e-3, train_batch_size=4000, entropy_coeff=0.005, rollout_fragment_length=100,
                      vf_loss_coeff=0.25).debugging(seed=0))
    algo = appo.build_algo()
    try:
        best_a = 0.0
        for _ in range(22):
            best_a = max(best_a, algo.train()["env_runners"]["episode_return_mean"])
            if best_a >= 60:
                break
    finally:
        algo.stop()
    check(best_a >= 40, f"phase 8 (c): APPO's best {best_a} < 40")
    print(f"phase 8 (c) APPO on CartPole-v1 (learner on the card): best episode_return_mean {best_a:.1f} (gate 40) "
          f"{card}")
    out.update(impala_env=dict(rets=rets, allreduce_ms=flat), appo_env=dict(best=best_a))
    return out


# ---------------------------------------------------------------- phase 8 (d)-(g): off-policy and offline
class PendulumObs:
    """Pendulum-v1's observation space without gymnasium: 3 floats."""

    shape = (3,)


class PendulumAct:
    """Pendulum-v1's action space without gymnasium: 1 float in [-2, 2]."""

    shape = (1,)
    low = np.array([-2.0], np.float32)
    high = np.array([2.0], np.float32)


RL_EPISODES = (40, 50)  # synthetic episodes (count, steps each): 2000 transitions per buffer


def synthetic_episodes(rng, obs_dim: int, continuous: bool) -> list[dict]:
    """Seeded episodes of CartPole-v1's (2 actions) or Pendulum-v1's (one
    action in [-2, 2]) shapes; every other one terminated."""
    n, T = RL_EPISODES
    out = []
    for i in range(n):
        actions = rng.uniform(-2, 2, (T, 1)).astype(np.float32) if continuous else rng.integers(0, 2, T)
        out.append({"obs": rng.normal(size=(T + 1, obs_dim)).astype(np.float32), "actions": actions,
                    "rewards": rng.normal(size=T).astype(np.float32), "logp": np.zeros(T, np.float32),
                    "terminated": i % 2 == 0})
    return out


def rl_least_ms(torch, fn, on_card: bool) -> float:
    """The least wall of RL_TIMED_UPDATES calls of ``fn``, in ms (the card
    synchronized after each)."""
    return rl_least_ms_turns(torch, [fn], on_card)[0]


def rl_least_ms_turns(torch, fns, on_card: bool) -> list[float]:
    """Each of ``fns``' least wall over RL_TIMED_UPDATES rounds that call
    them in turns, in ms (the card synchronized after each call)."""
    times = [[] for _ in fns]
    for _ in range(RL_TIMED_UPDATES):
        for fn, acc in zip(fns, times):
            t0 = time.perf_counter()
            fn()
            if on_card:
                torch.cuda.synchronize()
            acc.append(time.perf_counter() - t0)
    return [min(t) * 1e3 for t in times]


def rl_update_profile(torch, fn, iters: int = 5) -> dict:
    """One learner update's device side from torch.profiler over ``iters``
    calls after a warm-up: the wall a call (under the profiler), the
    device-busy ms, the device operations (kernels and copies) a call,
    and the idle share 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
    dev = [e for e in prof.key_averages() if "CUDA" in str(e.device_type)]
    busy = sum(self_device_us(e) for e in dev) / 1e3 / iters
    return dict(wall_ms=wall, busy_ms=busy, ops=sum(e.count for e in dev) / iters, idle=1.0 - busy / wall)


def rl_profile_text(prof: dict) -> str:
    return (f"under torch.profiler {prof['wall_ms']:.3f} ms a call, the card busy {prof['busy_ms']:.3f} ms of it "
            f"(idle share {prof['idle']:.3f}), {prof['ops']:.0f} device operations a call")


def rl_item_readback(aux: dict) -> dict:
    """The metrics read one ``.item()`` at a time (a sync each): the way
    the single copy of ``read_once`` is timed against."""
    return {k: (v.detach().cpu().numpy() if v.dim() else v.item()) for k, v in aux.items()}


def rllib_offpolicy_legs(torch, card) -> dict:
    """Phase 8 (d)-(f): DQN, SAC, CQL, BC and MARWIL learners on the card
    against the host at ray_tpu's default widths, from seeded synthetic
    episodes and a JSONL dataset written and read back with the port's
    writer and reader."""
    import shutil
    import tempfile

    from ray_tpu_torch.rllib import EpisodeReplayBuffer, PrioritizedEpisodeReplayBuffer
    from ray_tpu_torch.rllib.algorithms.bc import BCConfig, BCLearner
    from ray_tpu_torch.rllib.algorithms.cql import CQLConfig, CQLLearner
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig, DQNLearner, QModule
    from ray_tpu_torch.rllib.algorithms.marwil import MARWILConfig, MARWILLearner, returns_to_go
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig, SACLearner, SACModule
    from ray_tpu_torch.rllib.core.rl_module import MLPModule, RLModuleSpec
    from ray_tpu_torch.rllib.offline import JsonWriter, fill_replay

    out = {}
    rng = np.random.default_rng(3)
    wide = {"fcnet_hiddens": (256, 256)}

    # ---- (d) DQN: prioritized replay, double Q, batch 64
    cart = synthetic_episodes(rng, 4, continuous=False)
    bufs = [PrioritizedEpisodeReplayBuffer(seed=0) for _ in range(2)]  # the card's and the host's: equal
    for buf in bufs:
        for ep in cart:
            buf.add(ep)
    cfg = DQNConfig()
    on_card, on_host = rl_pair(DQNLearner, RLModuleSpec(QModule, Box(), Discrete(), wide), cfg)
    batches = [buf.sample(cfg.train_batch_size) for buf in bufs]
    check(all(np.array_equal(batches[0][k], batches[1][k]) for k in batches[0]), "phase 8 (d): the buffers' draws")
    mc, td_c = on_card.update_dqn(batches[0])
    mh, td_h = on_host.update_dqn(batches[1])
    param_err = rl_gate("(d) DQN", mc, mh, on_card, on_host)
    td_err = float(np.max(np.abs(td_c - td_h)))
    check(td_c.shape == (cfg.train_batch_size,) and np.allclose(td_c, td_h, rtol=RL_UPDATE_TOL["loss_rtol"],
                                                                atol=RL_UPDATE_TOL["loss_atol"]),
          f"phase 8 (d) DQN: |td| card vs host differ by {td_err:.3g}")
    bufs[0].update_priorities(batches[0]["batch_indices"], td_c)
    bufs[1].update_priorities(batches[1]["batch_indices"], td_h)
    pri_c, pri_h = bufs[0]._tree._tree, bufs[1]._tree._tree
    check(np.allclose(pri_c, pri_h, rtol=RL_UPDATE_TOL["loss_rtol"], atol=RL_UPDATE_TOL["loss_atol"])
          and not np.allclose(pri_c[bufs[0]._tree._size:][: len(bufs[0])], 1.0),
          "phase 8 (d) DQN: the priorities updated from the card's |td| differ from the host's")
    on_card.sync_target()
    tgt = on_card.target.state_dict()
    check(all(v.device.type == "cuda" and torch.equal(v, on_card.module.state_dict()[k]) for k, v in tgt.items()),
          "phase 8 (d) DQN: sync_target did not copy the online network on the card")
    b = batches[0]

    def items_update():
        rl_item_readback(on_card.apply_gradients_step(on_card._device_batch(b)))

    ms_card, ms_items = rl_least_ms_turns(torch, [lambda: on_card.update_dqn(b), items_update], True)
    ms_host = rl_least_ms(torch, lambda: on_host.update_dqn(b), False)
    prof = rl_update_profile(torch, lambda: on_card.update_dqn(b))
    out["dqn"] = dict(card_ms=ms_card, host_ms=ms_host, card_items_ms=ms_items, param_err=param_err, td_err=td_err,
                      metrics=mc, profile=prof)
    print(f"phase 8 (d) DQN learner (QModule 4 -> 256 -> 256 -> 2, f32, Adam, double Q, prioritized replay of "
          f"{len(bufs[0])} synthetic CartPole-shaped transitions, batch {cfg.train_batch_size} with IS weights): one "
          f"update on the card {ms_card:.3f} ms (least of {RL_TIMED_UPDATES}; metrics and |td| read in one copy) vs "
          f"{ms_items:.3f} ms with an .item() a metric (in turns), vs the same update on the host in process "
          f"{ms_host:.3f} ms; {rl_profile_text(prof)}; "
          f"first update's metrics card { {k: round(v, 6) for k, v in mc.items()} } vs host "
          f"{ {k: round(v, 6) for k, v in mh.items()} }, |td| within {td_err:.3g}, parameters within "
          f"{param_err:.3g}; the priorities from the card's |td| equal the host's; the target synced on the card "
          f"{card}")
    del on_card, on_host

    # ---- (e) SAC: Pendulum-shaped, batch 256, the same noise on both
    pend = synthetic_episodes(rng, 3, continuous=True)
    buf = EpisodeReplayBuffer(seed=0)
    for ep in pend:
        buf.add(ep)
    cfg = SACConfig()
    on_card, on_host = rl_pair(SACLearner, RLModuleSpec(SACModule, PendulumObs(), PendulumAct(), wide), cfg)
    b = buf.sample(cfg.train_batch_size)
    noise = on_host.draw_noise(cfg.train_batch_size)
    mc, mh = on_card.update_sac(b, noise=noise), on_host.update_sac(b, noise=noise)
    tq_c, tq_h = on_card.target_q.state_dict(), on_host.target_q.state_dict()
    param_err = rl_gate("(e) SAC", mc, mh, on_card, on_host, [(tq_c[k], tq_h[k]) for k in tq_h])
    alpha_after = on_card.module.log_alpha.detach().exp().item()
    check(abs(mc["alpha"] - mh["alpha"]) <= 1e-7 and abs(alpha_after - cfg.initial_alpha) > 1e-7,
          f"phase 8 (e) SAC: alpha before {mc['alpha']} / {mh['alpha']}, after the update {alpha_after}")
    ms_card, ms_items = rl_least_ms_turns(
        torch, [lambda: on_card.update_sac(b), lambda: rl_item_readback(on_card.step(b))], True)
    ms_host = rl_least_ms(torch, lambda: on_host.update_sac(b), False)
    prof = rl_update_profile(torch, lambda: on_card.update_sac(b))
    out["sac"] = dict(card_ms=ms_card, host_ms=ms_host, card_items_ms=ms_items, param_err=param_err, metrics=mc,
                      alpha_after=alpha_after, profile=prof)
    print(f"phase 8 (e) SAC learner (pi 3 -> 256 -> 256 -> 2, critics 4 -> 256 -> 256 -> 1 twice, log_alpha, one "
          f"Adam, polyak tau {cfg.tau}; {len(buf)} synthetic Pendulum-shaped transitions, batch "
          f"{cfg.train_batch_size}): one update on the card {ms_card:.3f} ms (least of {RL_TIMED_UPDATES}; metrics "
          f"in one copy) vs {ms_items:.3f} ms with an .item() a metric (in turns), vs the host in process "
          f"{ms_host:.3f} ms; {rl_profile_text(prof)}; "
          f"first update on the same noise: metrics card { {k: round(v, 6) for k, v in mc.items()} } vs host "
          f"{ {k: round(v, 6) for k, v in mh.items()} }, parameters and polyak targets within {param_err:.3g}; "
          f"alpha {mc['alpha']:.6f} -> {alpha_after:.6f} {card}")
    del on_card, on_host

    # ---- (f) offline: a JSONL dataset through the port's writer and reader
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rl_")
    try:
        w = JsonWriter(tmp)
        for ep in synthetic_episodes(rng, 4, continuous=False):
            w.write(ep)
        w.close()
        buf = EpisodeReplayBuffer(seed=0)
        n = fill_replay(buf, tmp)
        obs, actions, returns = returns_to_go(tmp, MARWILConfig().gamma)
        check(n == len(returns) == RL_EPISODES[0] * RL_EPISODES[1] and np.isfinite(returns).all(),
              f"phase 8 (f): the dataset read back {n} transitions, {len(returns)} returns")
        try:
            fill_replay(EpisodeReplayBuffer(capacity=n - 1), tmp, refuse_overflow=True)
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "exceeds replay_buffer_capacity" in refused,
              f"phase 8 (f): DQN's capacity refusal on an oversized dataset: {refused!r}")
        mrng = np.random.default_rng(MARWILConfig().seed)
        legs = {
            "CQL": (CQLLearner, QModule, CQLConfig(), lambda ln, bt: ln.update_dqn(bt)[0],
                    buf.sample(CQLConfig().train_batch_size)),
            "BC": (BCLearner, MLPModule, BCConfig(), lambda ln, bt: ln.update(bt),
                   buf.sample(BCConfig().train_batch_size)),
            "MARWIL": (MARWILLearner, MLPModule, MARWILConfig(), lambda ln, bt: ln.update_marwil(bt),
                       (lambda i: {"obs": obs[i], "actions": actions[i], "returns": returns[i]})(
                           mrng.integers(0, len(returns), MARWILConfig().train_batch_size))),
        }
        for name, (cls, module, cfg, upd, bt) in legs.items():
            on_card, on_host = rl_pair(cls, RLModuleSpec(module, Box(), Discrete(), wide), cfg)
            mc, mh = upd(on_card, bt), upd(on_host, bt)
            param_err = rl_gate(f"(f) {name}", mc, mh, on_card, on_host)
            if name == "MARWIL":
                check(abs(on_card.ma_adv_norm - on_host.ma_adv_norm) <= 1e-4 * abs(on_host.ma_adv_norm),
                      f"phase 8 (f) MARWIL: ma_adv_norm {on_card.ma_adv_norm} vs {on_host.ma_adv_norm}")
            ms_card = rl_least_ms(torch, lambda: upd(on_card, bt), True)
            ms_host = rl_least_ms(torch, lambda: upd(on_host, bt), False)
            prof = rl_update_profile(torch, lambda: upd(on_card, bt))
            out[name.lower()] = dict(card_ms=ms_card, host_ms=ms_host, param_err=param_err, metrics=mc, profile=prof)
            print(f"phase 8 (f) {name} learner ({module.__name__} 4 -> 256 -> 256 -> 2, f32, Adam; batch "
                  f"{len(bt['obs'])} from the {n}-transition JSONL dataset read back through JsonReader): one update "
                  f"on the card {ms_card:.3f} ms (least of {RL_TIMED_UPDATES}) vs the host in process "
                  f"{ms_host:.3f} ms; {rl_profile_text(prof)}; first update's metrics card "
                  f"{ {k: round(v, 6) for k, v in mc.items()} } vs host { {k: round(v, 6) for k, v in mh.items()} }, "
                  f"parameters within {param_err:.3g} {card}")
            del on_card, on_host
        print(f"phase 8 (f) offline dataset: {RL_EPISODES[0]} episodes written with JsonWriter, {n} transitions read "
              f"back into a replay buffer and into MARWIL's returns-to-go; DQN's capacity refusal raised ValueError "
              f"on a buffer of {n - 1} {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def rllib_offpolicy_env_legs(torch, card) -> dict:
    """Phase 8 (g), where gymnasium is installed: ray_tpu's DQN (recording
    its episodes) and SAC learning configurations with the learners on the
    card; then an offline DQN and a BC train from the DQN run's dataset and
    evaluate greedily."""
    import shutil
    import tempfile

    from ray_tpu_torch.rllib import BCConfig, DQNConfig, SACConfig

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rl_g_")
    ds = os.path.join(tmp, "cartpole")
    try:
        dqn = (DQNConfig().environment("CartPole-v1")
               .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=256).debugging(seed=0)
               .offline_data(output=ds))
        dqn.training(lr=1e-3, train_batch_size=64, num_steps_sampled_before_learning_starts=1000,
                     target_network_update_freq=250, initial_epsilon=1.0, final_epsilon=0.05, epsilon_timesteps=5000,
                     train_intensity=8.0, model={"fcnet_hiddens": (64, 64)})
        algo = dqn.build_algo()
        t0 = time.perf_counter()
        try:
            devs = {p.device.type for p in algo._learner.module.parameters()}
            check(devs == {"cuda"}, f"phase 8 (g): the DQN learner's parameters on {devs}")
            best, iters = 0.0, 0
            for iters in range(1, 81):
                best = max(best, algo.train()["env_runners"]["episode_return_mean"])
                if best >= 120:
                    break
        finally:
            algo.stop()
        check(best >= 100, f"phase 8 (g): DQN's best episode_return_mean {best} < 100")
        out["dqn_env"] = dict(best=best, iterations=iters, s=time.perf_counter() - t0)
        print(f"phase 8 (g) DQN on CartPole-v1 (ray_tpu's _dqn_config, learner on the card, recording its episodes): "
              f"best episode_return_mean {best:.1f} (gate 100) in {iters} iterations, "
              f"{out['dqn_env']['s']:.1f} s {card}")
        sac = (SACConfig().environment("Pendulum-v1")
               .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=256)
               .training(lr=3e-4, train_batch_size=256, num_steps_sampled_before_learning_starts=1000,
                         train_intensity=128.0, model={"fcnet_hiddens": (64, 64)}).debugging(seed=0))
        algo = sac.build()
        t0 = time.perf_counter()
        try:
            best_s, r = -1e9, None
            for iters in range(1, 131):
                r = algo.train()
                ret = r["env_runners"]["episode_return_mean"]
                best_s = max(best_s, ret) if np.isfinite(ret) else best_s
                if best_s > -900.0:
                    break
        finally:
            algo.stop()
        check(best_s > -900.0 and abs(r["learner"]["alpha"] - 0.1) > 1e-4,
              f"phase 8 (g): SAC's best {best_s} (gate -900), alpha {r['learner'].get('alpha')}")
        out["sac_env"] = dict(best=best_s, iterations=iters, s=time.perf_counter() - t0)
        print(f"phase 8 (g) SAC on Pendulum-v1 (ray_tpu's test config, learner on the card): best episode_return_mean "
              f"{best_s:.1f} (gate -900) in {iters} iterations, {out['sac_env']['s']:.1f} s {card}")
        off = DQNConfig().environment("CartPole-v1").debugging(seed=1).offline_data(input_=ds)
        off.training(lr=1e-3, offline_updates_per_iter=30, train_batch_size=64)
        algo = off.build_algo()
        try:
            n0 = len(algo.replay)
            r = [algo.train() for _ in range(3)][-1]
        finally:
            algo.stop()
        check(r["learner"]["num_updates"] == 30 and len(algo.replay) == n0 == r["offline_transitions"]
              and "episode_return_mean" in r["env_runners"], f"phase 8 (g): offline DQN's result {r}")
        bc = BCConfig().environment("CartPole-v1").offline_data(input_=ds).training(updates_per_iter=20)
        algo = bc.build()
        try:
            rb = [algo.train() for _ in range(2)][-1]
        finally:
            algo.stop()
        check(np.isfinite(rb["learner"]["bc_logp_mean"]) and rb["dataset_transitions"] == n0,
              f"phase 8 (g): BC's result {rb}")
        out["offline_env"] = dict(transitions=n0, dqn_return=r["env_runners"]["episode_return_mean"],
                                  bc_logp=rb["learner"]["bc_logp_mean"])
        print(f"phase 8 (g) offline DQN and BC from the DQN run's {n0} recorded transitions (learners on the card, "
              f"greedy evaluation): DQN's greedy episode_return_mean {r['env_runners']['episode_return_mean']}, BC's "
              f"logp mean {rb['learner']['bc_logp_mean']:.4f} {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------- phase 4l: runtime_env and the monitors
PHASE4L_MODULE = "phase4l_actor"  # the actor's module: only the runtime_env's py_modules hold it
PHASE4L_DATA = "phase4l_data.txt"  # in the working_dir: the actor reads it from its cwd
PHASE4L_BLOB = 8 << 20  # seeded random bytes beside it, so the archive crosses the store as a segment
PHASE4L_WAIT_S = 30.0  # (b)-(e): the timeline, the log line, the stack and the counter show within this
PHASE4L_HOLD_BYTES = 4 << 30  # (f): what the retriable GPU task holds on the card
PHASE4L_SOURCE = '''"""Phase 4l's GPU actor: phase 4's engine (chip_smoke.CardServer) served
from a worker that resolves this class by reference only once the
runtime_env's py_modules archive is on its sys.path."""

import os

import chip_smoke
from ray_tpu_torch.runtime_env import packaging
from ray_tpu_torch.util import metrics


class EnvServer(chip_smoke.CardServer._cls):
    def probe(self) -> dict:
        with open("{data}") as f:
            data = f.read()
        return dict(data=data, flavor=os.environ.get("PHASE4L_FLAVOR"), cwd=os.getcwd(),
                    worker=os.environ.get("RT_WORKER_ID"), unpack_s=dict(packaging.unpack_s), pid=os.getpid())

    def generate(self, prompts) -> dict:
        print(f"PHASE4L_ACTOR_LINE pid {{os.getpid()}}", flush=True)
        metrics.Counter("phase4l_generate_total", description="phase 4l's generate calls").inc()
        return super().generate(prompts)
'''


@remote(num_gpus=1)
def card_env_probe() -> dict:
    """(a)'s plain GPU task: where it ran."""
    return dict(worker=os.environ.get("RT_WORKER_ID"), cwd=os.getcwd(), visible=os.environ.get("CUDA_VISIBLE_DEVICES"))


def seeded_sum(torch, dev) -> float:
    """(f)'s result: a seeded draw's sum, the same in any process on ``dev``."""
    x = torch.randn(1 << 20, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    return float(x.double().sum().item())


@remote(num_gpus=1, max_retries=1)
def card_hold_retry(marker: str, release: str, nbytes: int, device: str = "cuda") -> float:
    """(f)'s retriable GPU task: holds ``nbytes`` of card memory and
    returns ``seeded_sum`` + 1 (a byte of what it holds); the first attempt
    writes ``marker`` and waits for ``release`` (at most 300 s), a retry
    returns at once."""
    import torch

    dev = torch.device(device)
    held = torch.empty(nbytes, dtype=torch.uint8, device=dev).fill_(1)
    result = seeded_sum(torch, dev) + float(held[:1].item())
    if not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write(str(os.getpid()))
        deadline = time.monotonic() + 300
        while not os.path.exists(release) and time.monotonic() < deadline:
            time.sleep(0.05)
    return result


class _Tee:
    """The log monitor's stream: each line goes to stderr and is kept."""

    def __init__(self):
        self.lines = []

    def write(self, s):
        self.lines.append(s)
        sys.stderr.write(s)

    def flush(self):
        sys.stderr.flush()


def env_on_card(torch, cfg, prompts, serve_run, drv_checksum, ready_4h, card, dev) -> dict:
    """Phase 4l: runtime_env and the monitors with a GPU actor. A module
    written here holds the actor class (phase 4's engine), shipped with
    ``py_modules``; a data file with ``working_dir``. (a) the actor's
    tokens equal phase 4's, it reads the file from its cwd and sees its env
    var, K1 and K4 held in its worker, and neither a plain task nor a plain
    GPU task runs on its worker; (b) the timeline lists its generate calls
    on its worker; (c) a line it prints reaches the driver with its
    (worker=...) prefix; (d) dump_worker_stacks shows its generating frame;
    (e) its counter in the driver's fold; (f) a MemoryMonitor forced to a
    threshold of 0 kills a retriable GPU task that holds card memory, the
    retry returns the same result and the memory comes back. Every leg is
    gated."""
    import dataclasses
    import importlib.util
    import shutil
    import tempfile

    import ray_tpu_torch as rtt
    from ray_tpu_torch.core import context, memory_monitor
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.runtime_env import packaging
    from ray_tpu_torch.util import metrics

    t_phase = time.perf_counter()
    expect = seeded_sum(torch, dev) + 1.0  # (f)'s task's result, before the card's memory is read
    torch.cuda.synchronize()
    used0 = card_used(torch)
    tmp = tempfile.mkdtemp(prefix="phase4l_")
    wd, mods = os.path.join(tmp, "app"), os.path.join(tmp, "mods")
    os.makedirs(wd)
    os.makedirs(mods)
    token = f"phase4l-{os.getpid()}"
    with open(os.path.join(wd, PHASE4L_DATA), "w") as f:
        f.write(token)
    with open(os.path.join(wd, "blob.bin"), "wb") as f:
        f.write(np.random.default_rng(41).bytes(PHASE4L_BLOB))
    with open(os.path.join(mods, PHASE4L_MODULE + ".py"), "w") as f:
        f.write(PHASE4L_SOURCE.format(data=PHASE4L_DATA))
    # the driver imports the module from its file, its directory not on
    # sys.path (a worker takes the driver's sys.path): only the archive
    # lets the worker resolve the class
    mspec = importlib.util.spec_from_file_location(PHASE4L_MODULE, os.path.join(mods, PHASE4L_MODULE + ".py"))
    mod = importlib.util.module_from_spec(mspec)
    sys.modules[PHASE4L_MODULE] = mod
    mspec.loader.exec_module(mod)
    env = {"working_dir": wd, "py_modules": [mods], "env_vars": {"PHASE4L_FLAVOR": token}}
    out = {"k1": 0, "k4": 0, "generates": 0}
    kills0 = memory_monitor.kills_total
    rtt.init(num_cpus=4)
    client = context.get_client()
    tee = _Tee()
    check(client._log_monitor is not None, "phase 4l: the runtime has no log monitor (log_to_driver)")
    client._log_monitor.out = tee
    try:
        flash_attention_fwd.launches = paged_attn_partials.launches = 0
        t0 = time.perf_counter()
        actor = rtt.remote(num_gpus=1, runtime_env=env)(mod.EnvServer).remote({"config": dataclasses.asdict(cfg)})
        submit_s = time.perf_counter() - t0  # the archives are packed in here
        fa = rtt.get(actor.facts.remote(), timeout=600)
        ready_s = time.perf_counter() - t0
        packed = [p for c in client._renv_cache.values()
                  for p in [c.get("_packed_working_dir"), *(c.get("_packed_py_modules") or [])] if p]
        pr = rtt.get(actor.probe.remote(), timeout=60)
        check(fa["checksum"] == drv_checksum, f"phase 4l: the actor's weights checksum {fa['checksum']} != the "
                                               f"driver's {drv_checksum}")
        check(pr["data"] == token and pr["flavor"] == token, f"phase 4l (a): the actor read {pr['data']!r} from its "
                                                             f"cwd and sees PHASE4L_FLAVOR={pr['flavor']!r}")
        check(pr["cwd"].startswith(packaging.cache_root()), f"phase 4l (a): the actor's cwd {pr['cwd']} is not under "
                                                            f"{packaging.cache_root()}")
        wid = pr["worker"]
        (w,) = [w for n in client.node_list() for w in n.workers.values() if w.worker_id.hex() == wid]
        check(w.env_binding.get("CUDA_VISIBLE_DEVICES") is not None and w.env_binding.get("runtime_env"),
              f"phase 4l (a): the actor's worker's bindings {w.env_binding}")
        # (a) phase 4's prompts
        run = rtt.get(actor.generate.remote(prompts), timeout=600)
        out["generates"] += 1
        out["k1"] += run["k1"]
        out["k4"] += run["k4"]
        same = sum(x == y for s1, s2 in zip(run["tokens"], serve_run["tokens"]) for x, y in zip(s1, s2))
        check(run["tokens"] == serve_run["tokens"], f"phase 4l (a): the actor's tokens equal phase 4's in {same} of 256")
        check(run["k1"] == serve_run["k1"] and run["k4"] == serve_run["k4"],
              f"phase 4l (a): the actor's launches K1 {run['k1']} K4 {run['k4']} != phase 4's K1 {serve_run['k1']} K4 "
              f"{serve_run['k4']}")
        check(flash_attention_fwd.launches == 0 and paged_attn_partials.launches == 0,
              f"phase 4l: the driver's K1/K4 counts moved: {flash_attention_fwd.launches}, "
              f"{paged_attn_partials.launches}")
        kc = rtt.get(actor.check_kernels.remote([len(p) for p in prompts]), timeout=600)
        check(kc["k1"]["ok"], f"phase 4l: K1 in the actor's worker at {kc['k1']['shape']}: |do| "
                              f"{kc['k1']['err_o']:.3g} (tol {K1_TOL_O}) |dlse| {kc['k1']['err_lse']:.3g}")
        check(kc["k4"]["ok"], f"phase 4l: K4 in the actor's worker at {kc['k4']['shape']}: max |d| "
                              f"{kc['k4']['err']:.3g}, relative {kc['k4']['rel']:.3g} (tol {K4_TOL})")
        out["check"] = kc
        plain = rtt.get(probe_worker.remote(), timeout=60)
        check(plain["worker"] != wid and not plain["cwd"].startswith(packaging.cache_root()),
              f"phase 4l (a): a plain task ran on the actor's worker or in its env: {plain} vs {wid}")
        archive = sum(p["bytes"] for p in packed)
        print(f"phase 4l (a) GPU actor from a packed runtime_env (num_gpus=1, working_dir + py_modules + env_vars): "
              f"archives {[p['bytes'] for p in packed]} bytes ({archive} in all), packed and submitted in "
              f"{submit_s:.3f} s, fetched and unpacked in the worker in "
              f"{sum(pr['unpack_s'].values()):.3f} s ({ {k: round(v, 4) for k, v in pr['unpack_s'].items()} }); "
              f"ready {ready_s:.3f} s after .remote() vs phase 4h's {ready_4h:.3f} s (its __init__ {fa['init_s']:.3f} "
              f"s); cwd {pr['cwd']}, the data file and PHASE4L_FLAVOR read there; 256 of 256 tokens equal phase 4's, "
              f"in the worker K1 {run['k1']} K4 {run['k4']}, the driver's 0; generate {run['wall_s']:.3f} s vs phase "
              f"4's {serve_run['wall_s']:.3f} s; a plain task on worker {plain['worker'][:12]}, not the actor's "
              f"{wid[:12]}; K1 held at {kc['k1']['shape']}: |do| {kc['k1']['err_o']:.3g}, kernel "
              f"{kc['k1']['ms']:.4f} ms, plain {kc['k1']['plain_ms']:.4f} ms, sdpa {kc['k1']['sdpa_ms']:.4f} ms, bound "
              f"{kc['k1']['bound_ms']:.4f} ms; K4 held at {kc['k4']['shape']}: max |d| {kc['k4']['err']:.3g}, kernel "
              f"{kc['k4']['ms']:.4f} ms, plain {kc['k4']['plain_ms']:.4f} ms, bound {kc['k4']['bound_ms']:.4f} ms "
              f"{card}")
        out.update(archive_bytes=archive, pack_s=submit_s, unpack_s=sum(pr["unpack_s"].values()), ready_s=ready_s)
        # (d) the stack of the generating worker, taken while it generates
        frame, dumps, t_dump = None, 0, []
        for _attempt in range(5):
            ref = actor.generate.remote(prompts)
            while frame is None:
                t0 = time.perf_counter()
                dump = client.dump_worker_stacks(worker_prefix=wid, timeout=10.0)
                t_dump.append(time.perf_counter() - t0)
                dumps += 1
                check(not dump.get(wid, {}).get("unresponsive"), f"phase 4l (d): the actor's worker did not answer "
                                                                 f"the stack dump: {dump}")
                frame = next((s for s in dump.get(wid, {}).get("stacks", {}).values() if "in _generate" in s), None)
                if rtt.wait([ref], timeout=0)[0]:
                    break
            r = rtt.get(ref, timeout=600)
            out["generates"] += 1
            out["k1"] += r["k1"]
            out["k4"] += r["k4"]
            check(r["tokens"] == serve_run["tokens"], "phase 4l (d): a generate's tokens differ from phase 4's")
            if frame is not None:
                break
        check(frame is not None, f"phase 4l (d): no stack dump of {dumps} showed the generating frame")
        last = frame.strip().splitlines()[-2:]
        print(f"phase 4l (d) dump_worker_stacks while the actor generates: its frame in dump {dumps} (each "
              f"{1e3 * sorted(t_dump)[len(t_dump) // 2]:.1f} ms, median), the innermost lines {last} {card}")
        # (b) the timeline
        path = os.path.join(tmp, "timeline.json")
        t0 = time.perf_counter()
        gens = []
        while time.perf_counter() - t0 < PHASE4L_WAIT_S:
            gens = [e for e in rtt.timeline(path) if e["name"].endswith("generate") and e["tid"] == wid[:8]]
            if len(gens) >= out["generates"]:
                break
            time.sleep(0.2)
        check(len(gens) >= out["generates"], f"phase 4l (b): the timeline lists {len(gens)} generate calls on the "
                                              f"actor's worker {wid[:8]}, not {out['generates']}")
        print(f"phase 4l (b) timeline: {len(gens)} generate calls on worker {wid[:8]} (X events, "
              f"{[round(e['dur'] / 1e6, 3) for e in gens]} s), in {path} with {os.path.getsize(path)} bytes {card}")
        # (c) the actor's print, streamed to this process with its prefix
        want = f"(worker={wid[:12]}) PHASE4L_ACTOR_LINE pid {pr['pid']}"
        t0 = time.perf_counter()
        while not any(want in ln for ln in tee.lines) and time.perf_counter() - t0 < PHASE4L_WAIT_S:
            time.sleep(0.1)
        check(any(want in ln for ln in tee.lines), f"phase 4l (c): the actor's line {want!r} never reached the driver")
        print(f"phase 4l (c) the actor's print reached the driver's stderr as {want!r}, "
              f"{sum(want in ln for ln in tee.lines)} times {card}")
        # (e) the actor's counter in the driver's fold
        t0 = time.perf_counter()
        got = None
        while time.perf_counter() - t0 < PHASE4L_WAIT_S:
            got = metrics.get_metrics_snapshot().get("phase4l_generate_total", {}).get("series", {}).get("")
            if got == out["generates"]:
                break
            time.sleep(0.2)
        check(got == out["generates"], f"phase 4l (e): phase4l_generate_total {got} in the fold, not "
                                       f"{out['generates']}")
        print(f"phase 4l (e) get_metrics_snapshot: phase4l_generate_total {got} (the actor's generate calls), "
              f"{time.perf_counter() - t0:.3f} s after the last call {card}")
        rtt.kill(actor)
        # (a) a plain GPU task after the actor: a worker of its own, outside the env
        gp = rtt.get(card_env_probe.remote(), timeout=600)
        check(gp["worker"] != wid and not gp["cwd"].startswith(packaging.cache_root()) and gp["visible"] is not None,
              f"phase 4l (a): the plain GPU task ran {gp} (the actor's worker {wid})")
        # (f) the memory monitor, its threshold forced to 0
        t_mem = _wait_mem(torch, used0, PHASE4K_MEM_S)
        check(t_mem is not None, "phase 4l (f): the card's memory did not come back after the actor's kill")
        marker, release = os.path.join(tmp, "hold.marker"), os.path.join(tmp, "hold.release")
        ref = card_hold_retry.remote(marker, release, PHASE4L_HOLD_BYTES, dev.type)
        t0 = time.perf_counter()
        while not os.path.exists(marker) and time.perf_counter() - t0 < 600:
            time.sleep(0.05)
        check(os.path.exists(marker), "phase 4l (f): the GPU task never started")
        with open(marker) as f:
            victim_pid = int(f.read())
        held_used = card_used(torch)
        mon = memory_monitor.MemoryMonitor(client)
        mon.cfg = type("Cfg", (), {"memory_usage_threshold": 0.0, "memory_monitor_refresh_ms": 0})()
        mon.check_once()
        t_kill = time.perf_counter()
        check(mon.kills == 1, f"phase 4l (f): the monitor killed {mon.kills} workers, not 1")
        result = rtt.get(ref, timeout=600)
        retry_s = time.perf_counter() - t_kill
        open(release, "w").close()
        check(result == expect, f"phase 4l (f): the retry returned {result}, not {expect}")
        check(not process_runs(victim_pid), f"phase 4l (f): the killed worker {victim_pid} still runs")
        back = _wait_mem(torch, used0, PHASE4K_MEM_S)
        check(back is not None, f"phase 4l (f): the card's memory in use {card_used(torch)} not back to {used0} "
                                f"within {PHASE4K_MEM_S} s")
        out.update(kill_retry_s=retry_s, mem_back_s=back)
        print(f"phase 4l (f) memory monitor (threshold forced to 0): killed the retriable GPU task's worker (pid "
              f"{victim_pid}, holding {PHASE4L_HOLD_BYTES} bytes of the card: in use {held_used} vs {used0}), the "
              f"retry returned the same sum {result} {retry_s:.3f} s after the kill, the card's memory back "
              f"{back:.3f} s after it; the runtime's own monitor (threshold "
              f"{client.cfg.memory_usage_threshold}) killed none {card}")
    finally:
        rtt.shutdown()
        sys.modules.pop(PHASE4L_MODULE, None)
        shutil.rmtree(tmp, ignore_errors=True)
    check(memory_monitor.kills_total - kills0 == 1, f"phase 4l: {memory_monitor.kills_total - kills0} kills by memory "
                                                    f"monitors in the phase, not (f)'s 1")
    check(not rt_segments(), f"phase 4l: /dev/shm still holds {rt_segments()}")
    print(f"phase 4l {time.perf_counter() - t_phase:.1f} s {card}")
    return out


@remote
def probe_worker() -> dict:
    """(a)'s plain task: where it ran."""
    return dict(worker=os.environ.get("RT_WORKER_ID"), cwd=os.getcwd())


# ---------------------------------------------------------------- phase 4m: cross-language and the cluster tooling
PHASE4M_ACTOR = "phase4m_engine"  # the named GPU actor that (a)'s exported function hands the prompts to
PHASE4M_IDLE_S = 5.0  # (c): the autoscaler's idle timeout for the launched GPU node
PHASE4M_JOIN_S = 180.0  # (c): the launched agent's node joins within this after the demand shows
PHASE4M_ROUNDS = 200  # (a): small PUT/GET round trips the C++ driver times
PHASE4M_BULK = 64 << 20  # (a): the payload the C++ driver PUTs and GETs
PHASE4M_WAIT_S = 30.0  # (d): the engine's series reach the head's /metrics within this
PHASE4M_SERIES = ("rt_llm_ttft_s", "rt_llm_tokens_total")  # (d): gated in /metrics and in the serving row
PHASE4M_PROFILED_TOKENS = 4  # (d): the profiled generate's tokens (a prefill and 3 decode steps): the trace's
# CPU events, exported by json in the worker, set its time (32 tokens: 86-103 MB, 18-20 s)
K4_PARTIALS = K4_KERNELS[0]  # (d): K4's __global__ symbol in the profiler's trace
PHASE4M_CPP = ("ray_tpu_torch/cpp/generate_driver.cpp", "cpp/example_worker.cpp")  # built in phase 1, beside nvcc


@remote(num_gpus=1)
class ToolingServer(CardServer._cls):
    """Phase 4m's GPU actor: phase 4's engine (CardServer's methods), where
    it runs, and a generate under util/profiling.profile_trace."""

    def where(self) -> dict:
        import ray_tpu_torch as rtt

        return dict(node=rtt.get_runtime_context().node_id.hex(), worker=os.environ.get("RT_WORKER_ID"),
                    pid=os.getpid())

    def profiled_generate(self, prompts, logdir: str, max_tokens: int) -> dict:
        from ray_tpu_torch.util.profiling import profile_trace

        with profile_trace(logdir):
            return _generate(self.eng, prompts, max_tokens)


def xlang_generate(payload: bytes) -> dict:
    """Phase 4m (a)'s exported function: a CALL's JSON prompts, served by
    the named GPU actor; the tokens and its worker's K1/K4 counts as JSON."""
    import ray_tpu_torch as rtt

    run = rtt.get(rtt.get_actor(PHASE4M_ACTOR).generate.remote(json.loads(payload)), timeout=SERVE_TIMEOUT_S)
    return dict(tokens=[[int(t) for t in s] for s in run["tokens"]], k1=int(run["k1"]), k4=int(run["k4"]),
                wall_s=float(run["wall_s"]), pid=int(run["pid"]))


def _http_json(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def tooling_on_card(torch, cfg, prompts, serve_run, drv_checksum, card, dev) -> dict:
    """Phase 4m: cross-language drivers and workers and the cluster tooling
    on one head with no card (the module docstring's (a)-(d)). Every leg
    is gated."""
    import dataclasses
    import glob
    import re
    import shlex
    import shutil
    import tempfile
    import urllib.request

    import ray_tpu_torch as rtt
    from ray_tpu_torch import cpp
    from ray_tpu_torch.autoscaler import Autoscaler, CommandNodeProvider, NodeTypeConfig
    from ray_tpu_torch.core import lock_sanitizer, xlang
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.dashboard.grafana import grafana_dashboard_json
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    t_phase = time.perf_counter()
    ref = serve_run["tokens"]
    want = (serve_run["k1"], serve_run["k4"])
    spec = {"config": dataclasses.asdict(cfg)}
    lens = [len(p) for p in prompts]
    # built in phase 1 (here from the cache); a failed g++ build fails the run
    driver_bin, worker_bin = (cpp.build(cpp.REPO / src) for src in PHASE4M_CPP)
    tmp = tempfile.mkdtemp(prefix="phase4m_")
    prompts_path = os.path.join(tmp, "prompts.json")
    with open(prompts_path, "w") as f:
        json.dump([[int(t) for t in p] for p in prompts], f)
    here = shlex.quote(os.path.dirname(os.path.abspath(__file__)))
    launch = (f"cd {here} && exec env PYTHONPATH={here} {shlex.quote(sys.executable)} -m ray_tpu_torch.scripts.cli "
              "agent --address {address} --authkey {authkey} --transfer-authkey {transfer_authkey} "
              "--num-cpus {num_cpus} --num-gpus {num_gpus} --reconnect 0")
    torch.cuda.synchronize()
    used0 = card_used(torch)
    drv_counts = (flash_attention_fwd.launches, paged_attn_partials.launches)
    out = {"c": {"k1": 0, "k4": 0, "generates": 0}}
    os.environ["RT_LOCK_SANITIZER"] = "1"
    lock_sanitizer.reset()
    sc = dash = cppw = None
    try:
        rt = rtt.init(num_cpus=4, num_gpus=0)
        check("GPU" not in rtt.cluster_resources(), f"phase 4m: the head counts a card: {rtt.cluster_resources()}")
        check(isinstance(rt._nodes_lock, lock_sanitizer.SanitizedLock), "phase 4m: the head's locks are not sanitized")
        provider = CommandNodeProvider(rt, launch)
        sc = Autoscaler(rt, [NodeTypeConfig("gpu_node", {"CPU": 2, "GPU": 1}, min_workers=0, max_workers=1)],
                        provider=provider, idle_timeout_s=PHASE4M_IDLE_S, interval_s=0.5).start()
        # (c) the actor waits, its demand shows, the autoscaler launches a GPU node, the actor serves there
        t0 = time.perf_counter()
        actor = ToolingServer.options(name=PHASE4M_ACTOR).remote(spec)
        demand = []
        while not demand and time.perf_counter() - t0 < 30:
            demand = rt.scheduler.pending_demand()
            time.sleep(0.01)
        check(demand == [{"GPU": 1.0}], f"phase 4m (c): the pending demand {demand}, not [{{'GPU': 1.0}}]")
        demand_s = time.perf_counter() - t0
        node = None
        while node is None and time.perf_counter() - t0 < PHASE4M_JOIN_S:
            node = next((n for n in rt.node_list() if n.labels.get("ray_tpu.io/node-type") == "gpu_node"), None)
            time.sleep(0.05)
        check(node is not None, f"phase 4m (c): no gpu_node joined within {PHASE4M_JOIN_S} s: "
                                f"{sc.status()}")
        join_s = time.perf_counter() - t0
        agent = provider._procs[node.node_id]
        fa = rtt.get(actor.facts.remote(), timeout=SERVE_TIMEOUT_S)
        wh = rtt.get(actor.where.remote(), timeout=60)
        check(wh["node"] == node.node_id.hex() and wh["pid"] in node.worker_pids,
              f"phase 4m (c): the actor runs on node {wh['node'][:12]} (pid {wh['pid']}), not the launched "
              f"{node.node_id.hex()[:12]} (workers {node.worker_pids})")
        check(fa["checksum"] == drv_checksum and fa["count"] == 1,
              f"phase 4m (c): the actor's checksum {fa['checksum']} vs {drv_checksum}, {fa['count']} cards")
        run = rtt.get(actor.generate.remote(prompts), timeout=SERVE_TIMEOUT_S)
        tokens_s = time.perf_counter() - t0
        same = sum(x == y for s1, s2 in zip(run["tokens"], ref) for x, y in zip(s1, s2))
        check(run["tokens"] == ref, f"phase 4m (c): the autoscaled node's tokens equal phase 4's in {same} of 256")
        check((run["k1"], run["k4"]) == want, f"phase 4m (c): the actor's K1/K4 {run['k1']}/{run['k4']} != phase "
                                              f"4's {want[0]}/{want[1]}")
        out["c"]["k1"] += run["k1"]
        out["c"]["k4"] += run["k4"]
        out["c"]["generates"] += 1
        kc = rtt.get(actor.check_kernels.remote(lens), timeout=SERVE_TIMEOUT_S)
        check(kc["k1"]["ok"], f"phase 4m: K1 in the autoscaled node's worker at {kc['k1']['shape']}: |do| "
                              f"{kc['k1']['err_o']:.3g} (tol {K1_TOL_O}) |dlse| {kc['k1']['err_lse']:.3g}")
        check(kc["k4"]["ok"], f"phase 4m: K4 in the autoscaled node's worker at {kc['k4']['shape']}: max |d| "
                              f"{kc['k4']['err']:.3g}, relative {kc['k4']['rel']:.3g} (tol {K4_TOL})")
        out["check"] = kc
        print(f"phase 4m (c) autoscaled GPU node: the head with no card (RT_LOCK_SANITIZER=1); the named num_gpus=1 "
              f"actor's demand {demand} in {demand_s:.3f} s; the CommandNodeProvider's `rt agent --num-gpus 1` "
              f"joined {join_s:.3f} s after the demand; the "
              f"actor on the joined node (pid {wh['pid']}, CUDA_VISIBLE_DEVICES={fa['visible']}), its __init__ "
              f"{fa['init_s']:.3f} s; 256 of 256 tokens equal phase 4's {tokens_s:.3f} s after the demand, K1 "
              f"{run['k1']} K4 {run['k4']} in its worker; held there: K1 at {kc['k1']['shape']} |do| "
              f"{kc['k1']['err_o']:.3g} kernel {kc['k1']['ms']:.4f} ms plain {kc['k1']['plain_ms']:.4f} ms sdpa "
              f"{kc['k1']['sdpa_ms']:.4f} ms bound {kc['k1']['bound_ms']:.4f} ms; K4 at {kc['k4']['shape']} max |d| "
              f"{kc['k4']['err']:.3g} kernel {kc['k4']['ms']:.4f} ms plain {kc['k4']['plain_ms']:.4f} ms bound "
              f"{kc['k4']['bound_ms']:.4f} ms {card}")
        # (a) the C++ driver: the object plane's round trips, then a CALL served by the actor
        info = xlang.serve()
        xlang.export("generate")(xlang_generate)
        t0 = time.perf_counter()
        py = rtt.get(actor.generate.remote(prompts), timeout=SERVE_TIMEOUT_S)
        py_s = time.perf_counter() - t0
        check(py["tokens"] == ref, "phase 4m (a): the actor's generate.remote() from Python differs from phase 4's")
        out["c"]["k1"] += py["k1"]
        out["c"]["k4"] += py["k4"]
        out["c"]["generates"] += 1
        p = subprocess.run([driver_bin, info["host"], str(info["port"]), info["authkey"], prompts_path,
                            str(PHASE4M_BULK), str(PHASE4M_ROUNDS)], capture_output=True, text=True,
                           timeout=SERVE_TIMEOUT_S)
        check(p.returncode == 0, f"phase 4m (a): the C++ driver exited {p.returncode}: {p.stderr[-4000:]}")
        line = json.loads(p.stdout.strip().splitlines()[-1])
        res = line["result"]
        same = sum(x == y for s1, s2 in zip(res["tokens"], ref) for x, y in zip(s1, s2))
        check(res["tokens"] == ref, f"phase 4m (a): the C++ driver's tokens equal phase 4's in {same} of 256")
        check((res["k1"], res["k4"]) == want, f"phase 4m (a): the CALL's K1/K4 {res['k1']}/{res['k4']} != phase 4's "
                                              f"{want[0]}/{want[1]}")
        check(res["pid"] == wh["pid"], f"phase 4m (a): the CALL was served by pid {res['pid']}, not the actor's")
        out["a"] = dict(k1=res["k1"], k4=res["k4"], py_s=py_s, **{k: v for k, v in line.items() if k != "result"})
        print(f"phase 4m (a) C++ driver (ray_tpu_torch/cpp/generate_driver.cpp over cpp/ray_tpu_client.hpp): "
              f"PUT+GET of a small string {line['rtt_us']:.1f} µs (PUT {line['put_us']:.1f}, GET {line['get_us']:.1f}, "
              f"medians of {PHASE4M_ROUNDS}); {line['bulk_bytes']} bytes PUT {line['put_gbps']:.3f} GB/s, GET "
              f"{line['get_gbps']:.3f} GB/s, compared equal; CALL(\"generate\") to its result {line['call_s']:.3f} s "
              f"beside generate.remote() from Python {py_s:.3f} s (the worker's own generate {res['wall_s']:.3f} s); "
              f"256 of 256 tokens equal phase 4's, K1 {res['k1']} K4 {res['k4']} in the actor's worker {card}")
        # (b) a C++ worker: functions and an actor defined in C++, called from Python
        cppw = subprocess.Popen([worker_bin, info["host"], str(info["port"]), info["authkey"], "cppw"],
                                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        t0 = time.perf_counter()
        scale = xlang.cpp_function("cppw", "scale")
        check(rtt.get(scale.remote(b"14"), timeout=120) == b"42", "phase 4m (b): scale(14) != 42")
        scaled = [int(x) for x in rtt.get([scale.remote(str(i).encode()) for i in range(8)], timeout=120)]
        check(scaled == [3 * i for i in range(8)], f"phase 4m (b): scale(0..7) = {scaled}")
        h = xlang.cpp_actor("cppw", "Counter")
        adds = [int(x) for x in rtt.get([h.call.remote("add", b"2") for _ in range(5)], timeout=120)]
        total = int(rtt.get(h.call.remote("get"), timeout=120))
        h2 = xlang.cpp_actor("cppw", "Counter")
        fresh = int(rtt.get(h2.call.remote("get"), timeout=120))
        check(adds == [2, 4, 6, 8, 10] and total == 10 and fresh == 0,
              f"phase 4m (b): Counter adds {adds}, get {total}, a second instance {fresh}")
        err = None
        try:
            rtt.get(h.call.remote("nope"), timeout=60)
        except Exception as e:  # noqa: BLE001 — the C++ actor's error is the result this leg checks
            err = e
        check(err is not None and "unknown method nope" in str(err), f"phase 4m (b): an unknown method gave {err!r}")
        cpp_s = time.perf_counter() - t0
        rtt.kill(h)
        rtt.kill(h2)
        print(f"phase 4m (b) C++ worker (cpp/example_worker.cpp, unchanged): scale(14) = 42 and scale(0..7) as "
              f"3 i through cpp_function; Counter through cpp_actor: adds {adds}, get {total}, a second instance "
              f"{fresh}, an unknown method raised {type(err).__name__}; {cpp_s:.3f} s in all {card}")
        # (d) the dashboard and the profiler while the actor lives
        dash = start_dashboard(port=0)
        nodes = _http_json(f"{dash.url}/api/nodes")
        mine = [n for n in nodes if n["node_id"] == node.node_id.hex()]
        check(len(mine) == 1 and mine[0]["alive"] and mine[0]["resources"].get("GPU") == 1,
              f"phase 4m (d): /api/nodes lists the launched node as {mine}")
        t0 = time.perf_counter()
        stacks = _http_json(f"{dash.url}/api/stacks/{wh['worker']}")
        stacks_ms = (time.perf_counter() - t0) * 1e3
        check(list(stacks) == [wh["worker"]] and stacks[wh["worker"]].get("stacks"),
              f"phase 4m (d): /api/stacks/{wh['worker'][:12]} gave {list(stacks)}")
        panels = [p for p in json.loads(grafana_dashboard_json())["panels"] if p["title"].startswith("Serving:")]
        queried = {re.sub(r"_(bucket|count|sum)$", "", m) for p in panels for t in p["targets"]
                   for m in re.findall(r"rt_llm_[a-z_]+", t["expr"])}
        check(set(PHASE4M_SERIES) <= queried, f"phase 4m (d): the serving row does not query {PHASE4M_SERIES}")
        t0 = time.perf_counter()
        shown = set()
        while time.perf_counter() - t0 < PHASE4M_WAIT_S:
            with urllib.request.urlopen(f"{dash.url}/metrics", timeout=60) as r:
                prom = r.read().decode()
            shown = {m for m in queried if re.search(rf"^{m}(_bucket|_count|_sum)?[{{ ]", prom, re.M)}
            if set(PHASE4M_SERIES) <= shown:
                break
            time.sleep(0.5)
        check(set(PHASE4M_SERIES) <= shown, f"phase 4m (d): /metrics shows {sorted(shown)} of the serving row's "
                                            f"series, not {PHASE4M_SERIES}")
        metrics_s = time.perf_counter() - t0
        logdir = os.path.join(tmp, "profile")
        t0 = time.perf_counter()
        pr = rtt.get(actor.profiled_generate.remote(prompts[:1], logdir, PHASE4M_PROFILED_TOKENS),
                     timeout=SERVE_TIMEOUT_S)
        prof_s = time.perf_counter() - t0
        check(pr["tokens"] == [ref[0][:PHASE4M_PROFILED_TOKENS]],
              f"phase 4m (d): the profiled generate's tokens {pr['tokens']} are not phase 4's first prompt's first "
              f"{PHASE4M_PROFILED_TOKENS} {ref[0][:PHASE4M_PROFILED_TOKENS]}")
        out["c"]["k1"] += pr["k1"]
        out["c"]["k4"] += pr["k4"]
        out["c"]["generates"] += 1
        traces = glob.glob(os.path.join(logdir, "*.json"))
        check(len(traces) == 1, f"phase 4m (d): profile_trace wrote {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        n_k1 = sum(K1_WGMMA in e.get("name", "") for e in events if e.get("cat") == "kernel")
        n_k4 = sum(K4_PARTIALS in e.get("name", "") for e in events if e.get("cat") == "kernel")
        check(n_k1 > 0 and n_k4 > 0, f"phase 4m (d): the trace names K1's {K1_WGMMA} {n_k1} times and K4's "
                                     f"{K4_PARTIALS} {n_k4} times")
        out["d"] = dict(stacks_ms=stacks_ms, metrics_s=metrics_s, prof_s=prof_s, n_k1=n_k1, n_k4=n_k4,
                        trace_bytes=os.path.getsize(traces[0]))
        print(f"phase 4m (d) dashboard on the head: /api/nodes lists the launched node with GPU 1; "
              f"/api/stacks/<the actor's worker> {stacks_ms:.1f} ms ({len(stacks[wh['worker']]['stacks'])} threads); "
              f"/metrics carries {sorted(shown)} of the serving row's series {metrics_s:.3f} s after the first scrape; "
              f"profile_trace around a generate of phase 4's first prompt, {PHASE4M_PROFILED_TOKENS} tokens, in the worker "
              f"({prof_s:.3f} s, tokens equal): "
              f"the trace "
              f"({os.path.getsize(traces[0])} bytes) names K1's {K1_WGMMA} {n_k1} times (K1 {pr['k1']} launches) and "
              f"K4's {K4_PARTIALS} {n_k4} times (K4 {pr['k4']}) {card}")
        dash.stop()
        dash = None
        xlang.shutdown()
        # (c) the kill, the idle node's termination, the card's memory back, the sanitizer's report
        rtt.kill(actor)
        t0 = time.perf_counter()
        while any(n.node_id == node.node_id for n in rt.node_list()) and time.perf_counter() - t0 < PHASE4M_IDLE_S + 60:
            time.sleep(0.1)
        removed_s = time.perf_counter() - t0
        check(not any(n.node_id == node.node_id for n in rt.node_list()),
              f"phase 4m (c): the idle node still listed {removed_s:.1f} s after the actor's kill: {sc.status()}")
        back = _wait_mem(torch, used0, PHASE4K_MEM_S)
        check(back is not None, f"phase 4m (c): the card's memory in use {card_used(torch)} not back to {used0} "
                                f"within {PHASE4K_MEM_S} s of the node's removal")
        agent.wait(timeout=60)
        gone = wait_for(lambda: not any(process_runs(p) for p in node.worker_pids), PHASE4K_MEM_S)
        check(gone is not None, f"phase 4m (c): the terminated node's workers {node.worker_pids} still run")
        check(flash_attention_fwd.launches == drv_counts[0] and paged_attn_partials.launches == drv_counts[1],
              "phase 4m: the driver's K1/K4 counts moved")
        rep = lock_sanitizer.report()
        check(rep["cycles"] == [], f"phase 4m (c): the lock sanitizer found lock-order cycles {rep['cycles']}")
        out["c"].update(demand_s=demand_s, join_s=join_s, tokens_s=tokens_s, removed_s=removed_s, mem_back_s=back,
                        slow_holds=rep["slow_holds"])
        print(f"phase 4m (c) the actor killed: its node idle, terminated by the autoscaler {removed_s:.3f} s later "
              f"(idle timeout {PHASE4M_IDLE_S} s; the agent exited {agent.returncode}, its workers ({len(node.worker_pids)}) "
              f"{gone:.3f} s later), the card's memory back "
              f"{back:.3f} s after that; the lock sanitizer: no cycle over {len(rep['order_graph'])} ordered locks, "
              f"slow holds (> {lock_sanitizer.SLOW_HOLD_S} s) {rep['slow_holds']} {card}")
    finally:
        if cppw is not None:
            cppw.terminate()
            cppw.wait(timeout=10)
        if dash is not None:
            dash.stop()
        xlang.shutdown()
        if sc is not None:
            sc.stop()
        rtt.shutdown()
        os.environ.pop("RT_LOCK_SANITIZER", None)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not rt_segments(), f"phase 4m: /dev/shm still holds {rt_segments()}")
    print(f"phase 4m {time.perf_counter() - t_phase:.1f} s {card}")
    return out


# ---------------------------------------------------------------- phase 7e: the remat policies
REMAT_WARMUP, REMAT_TIMED = 2, 5  # steps of each policy: warm-ups (step 1's loss gated), then timed
TP_N = 2  # phase 4n: ranks, both on the one card
TP_LOGIT_PREFIX = 64  # (a)'s logit gate: each prompt's first 64 tokens, one decode step after their prefill
TP_LOGIT_TOL = 0.25  # (a): max |tp=2 - tp=1| over the first decode step's f32 logits (bf16 sums in another order)
TP_DRIFT_TOL = 0.2  # (a): int8 vs fp collective, max |logprob| drift at the fp argmax (ray_tpu's bound)
TP_DECODE_STEPS = 8  # (a): decode-only steps timed after the 8 prompts are admitted
TP_SUCC_PERIOD = 16  # (b): the successor map t -> (t + 1) % 16 (ray_tpu's _successor_params)
TP_SUCC_LAYERS = 4  # (b), (d): the copy model's depth, cut (its layers are zeros; full width)
TP_SERVE_TOKENS = 8  # (e) and (a)'s reference for it: the shortest prompt's greedy tokens
TP_INT8_TOKENS = 4  # (a) int8: greedy tokens of each short prompt on the tp_collective="int8" engine
TP_PROBES = "chip_smoke"  # the module the ranks import the rank_* probes from (this file, by its name)


def rank_counts(eng, zero: bool = False) -> dict:
    """This rank's K1 and K4 launches, its engine's forwards, and (zero)
    all set to 0 after the read."""
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    out = dict(k1=flash_attention_fwd.launches, k4=paged_attn_partials.launches, pid=os.getpid())
    if zero:
        flash_attention_fwd.launches = 0
        paged_attn_partials.launches = 0
    return out


def rank_memory(eng, reset: bool = False) -> dict:
    """This rank process's peak and current bytes on the card (its own
    allocations), and its group's host seconds by op."""
    import torch

    torch.cuda.synchronize()
    out = dict(peak=torch.cuda.max_memory_allocated(), now=torch.cuda.memory_allocated(),
               op_s=dict(eng._group.op_s))
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return out


def rank_decode_logits(eng, prompts, collective: str | None = None):
    """One decode step's f32 logits [B, V] after prefilling ``prompts`` into
    a fresh slot cache of this rank's kv heads: the prefill's sums exact,
    the decode step's per-layer sums in ``collective`` (None: exact), as
    the engine's fused step sums them; every rank at once (its
    collectives), or a single device's forward at tp = 1."""
    import torch

    from ray_tpu_torch.llm import kv_cache as kvc
    from ray_tpu_torch.llm import model_runner as mr
    from ray_tpu_torch.llm.engine import _bucket

    cfg, dev = eng._mcfg, eng.device
    tpc = eng._tpc if collective is None or eng._tpc is None else mr.TpSpec(eng._group, collective)
    prefill_tpc = eng._tpc
    T = max(_bucket(len(p), eng.prefill_buckets) for p in prompts)
    toks = np.zeros((len(prompts), T), np.int64)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    logits, ks, vs = mr.prefill(eng.params, torch.from_numpy(toks).to(dev), lens, cfg, prefill_tpc)
    cache = kvc.alloc(kvc.CacheConfig(num_layers=cfg.num_layers, num_slots=len(prompts), max_seq_len=T + 1,
                                      num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd, dtype=eng.kv_dtype), dev)
    for i, p in enumerate(prompts):
        kvc.insert_sequence(cache, i, ks[:, i], vs[:, i], len(p))
    out, _ = mr.decode_step(eng.params, cache, logits.argmax(-1), cfg, tpc)
    return out.float().cpu()


_SAMPLE_TAP: dict = {}  # rank_tap_sample's state in this process


def rank_tap_sample(eng, on: bool):
    """(on) From now on keep the logits of the first fused decode step this
    rank runs: ``model_runner.sample`` is wrapped, which only the fused
    steps call. (off) Unwrap and return them, f32 [max_num_seqs, V] on the
    host by slot, or None if no fused step ran."""
    from ray_tpu_torch.llm import model_runner as mr

    if on:
        orig, seen = mr.sample, []

        def tap(logits, *rest):
            if not seen:
                seen.append(logits.float().cpu())
            return orig(logits, *rest)

        _SAMPLE_TAP.update(orig=orig, seen=seen)
        mr.sample = tap
        return None
    mr.sample = _SAMPLE_TAP.pop("orig")
    seen = _SAMPLE_TAP.pop("seen")
    return seen[0] if seen else None


def rank_hold_kernels(eng, lens):
    """K1 and K4 held against their plain versions and timed in rank 1's
    process at its shapes (``hold_kernels``); the other ranks return None
    (two ranks timing at once on one card would time each other)."""
    return hold_kernels(eng, lens) if eng._group.rank == 1 else None


def successor_params(torch, cfg, dev) -> dict:
    """ray_tpu's decisive-logits copy model (tests/test_llm_tp.py's
    _successor_params) at ``cfg``'s widths, drawn with torch from seed 0:
    attention and MLP zeroed, norms 1, the embedding N(0, 0.01), the
    unembedding wired so greedy decode follows t -> (t + 1) % 16."""
    from ray_tpu_torch.models.llama import torch_dtype

    dt, h, L = torch_dtype(cfg.dtype), cfg.hidden_size, cfg.num_layers
    g = torch.Generator(device=dev).manual_seed(0)
    emb = torch.randn((cfg.vocab_size, h), generator=g, device=dev).mul_(0.1)
    un = torch.zeros((h, cfg.vocab_size), device=dev)
    for t in range(TP_SUCC_PERIOD):
        un[:, (t + 1) % TP_SUCC_PERIOD] += emb[t] * 4.0
    z = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
    layers = dict(wq=z(L, h, cfg.num_heads * cfg.hd), wk=z(L, h, cfg.num_kv_heads * cfg.hd),
                  wv=z(L, h, cfg.num_kv_heads * cfg.hd), wo=z(L, cfg.num_heads * cfg.hd, h),
                  w_gate=z(L, h, cfg.intermediate_size), w_up=z(L, h, cfg.intermediate_size),
                  w_down=z(L, cfg.intermediate_size, h), attn_norm=torch.ones((L, h), dtype=dt, device=dev),
                  mlp_norm=torch.ones((L, h), dtype=dt, device=dev))
    return dict(embed=emb.to(dt), unembed=un.to(dt), final_norm=torch.ones((h,), dtype=dt, device=dev), layers=layers)


class CardTpServer(_CardReplica, LLMServer):
    """Phase 4n (e)'s replica: the LLM server with its engine's rank pids."""

    def tp_pids(self) -> list:
        return self.engine.tp_pids


def tp_on_card(torch, cfg, prompts, serve_run, spec1_tokens, card, dev) -> dict:
    """Phase 4n: tensor-parallel serving, Llama-3-8B at tp=2 with both ranks
    on the one card (gloo). (a) serving on a paged and a slot engine, the
    first decode step's logits against tp=1's, the int8 collective's
    drift, and a tp_collective="int8" engine's first fused step against
    the fp sums; (b) the decisive workload at fp, int8 and tp=1; (c) K1
    and K4 held in rank 1; (d) n-gram speculation against the plain
    engine, on (a)'s weights (gated as phase 4d, whose tp=1 tokens
    ``spec1_tokens`` are the witness of how often spec and plain part
    there) and on (b)'s; (e) a Serve TP replica. Every leg gated; every
    engine's ranks gone after."""
    import dataclasses
    from types import SimpleNamespace

    import ray_tpu_torch as rtt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import SamplingParams, SpecConfig
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.parallel.mesh import create_mesh
    from ray_tpu_torch.serve.llm import LLMConfig, build_llm_deployment

    L, n = cfg.num_layers, len(prompts)
    lens = [len(p) for p in prompts]
    mesh = create_mesh(tp=TP_N, devices=[dev] * TP_N)
    ek = dict(max_num_seqs=8, page_size=64, enable_prefix_caching=False)
    t_phase = time.perf_counter()
    out = {"launches": {"k1": 0, "k4": 0}}
    pids = []
    short = [p[:TP_LOGIT_PREFIX] for p in prompts]
    first = min(prompts, key=len)

    def gone(pid, within=60.0):
        end = time.perf_counter() + within
        while time.perf_counter() < end and process_runs(pid):
            time.sleep(0.05)
        return not process_runs(pid)

    def counted(eng, label, run_fn, k4_each):
        """run_fn() with every rank's K1/K4 counts zeroed just before and read
        just after: K1 once a layer per prefill forward and K4 ``k4_each`` per
        decode step or round on EACH rank."""
        eng.tp_call(TP_PROBES, "rank_counts", True)
        res = run_fn()
        cs = eng.tp_call(TP_PROBES, "rank_counts", True)
        steps = eng.decode_steps + getattr(eng, "_spec_rounds", 0)
        n_l = eng.config.num_layers
        for r, c in enumerate(cs):
            check(c["k1"] == n_l * eng.prefill_forwards > 0, f"phase 4n {label}: rank {r} K1 {c['k1']} != {n_l} x "
                                                            f"{eng.prefill_forwards} prefill forwards")
            check(c["k4"] == k4_each * steps, f"phase 4n {label}: rank {r} K4 {c['k4']} != {k4_each} x {steps} "
                                             f"decode steps or rounds")
        out["launches"]["k1"] += sum(c["k1"] for c in cs)
        out["launches"]["k4"] += sum(c["k4"] for c in cs)
        check(len({c["pid"] for c in cs}) == TP_N, f"phase 4n {label}: ranks' pids {[c['pid'] for c in cs]}")
        return res, cs

    def close(eng):
        ps = eng.tp_pids
        eng.shutdown()
        pids.extend(ps)
        check(all(gone(p) for p in ps), f"phase 4n: rank processes {ps} outlived their engine's shutdown")

    # ---- the tp=1 reference: the first decode step's logits on phase 4's weights (seed 0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    one = SimpleNamespace(params=params, _mcfg=cfg, _tpc=None, _group=None, device=dev, kv_dtype=cfg.dtype,
                          prefill_buckets=(64, 128, 256, 512, 1024, 2048))
    ref_logits = rank_decode_logits(one, short)
    del params, one
    torch.cuda.empty_cache()
    mem0 = card_used(torch)

    # ---- (a) serving: a paged engine, then a slot engine, each from seed 0 on both ranks
    runs = {}
    for layout in ("paged", "slots"):
        t0 = time.perf_counter()
        eng = LLMEngine(cfg, mesh=mesh, kv_layout=layout, seed=0, **ek)
        init_s = time.perf_counter() - t0
        check(eng.graph_capture_s == 0 and eng._decode.captures == 0 and eng.tp == TP_N,
              f"phase 4n (a) {layout}: a tp={eng.tp} engine captured {eng._decode.captures} graphs")
        check(eng.kv_cache_stats()["attn_kernel"] == ("cuda" if layout == "paged" else "torch"),
              f"phase 4n (a) {layout}: attention {eng.kv_cache_stats()['attn_kernel']}")
        eng.tp_call(TP_PROBES, "rank_memory", True)
        op0 = sum(eng._group.op_s.values())
        run, cs = counted(eng, f"(a) {layout}", lambda: serve_engine(
            torch, eng, prompts, f"phase 4n (a) tp=2 {layout}", card, k4_per_step=L if layout == "paged" else 0),
            L if layout == "paged" else 0)
        run["coll_ms"] = (sum(eng._group.op_s.values()) - op0) * 1e3
        # decode-only steps (paged), timed: the step computes all 8 lanes whatever their occupancy, so
        # one short prompt admitted keeps it decode-only without a second wave of long prefills
        run["step_ms"] = run["step_coll_ms"] = float("nan")
        if layout == "paged":
            eng.add_request(short[0], SamplingParams(max_tokens=TP_DECODE_STEPS + 4))
            while eng.num_waiting:
                eng.step()
            op1, steps0 = sum(eng._group.op_s.values()), eng.decode_steps
            t0 = time.perf_counter()
            for _ in range(TP_DECODE_STEPS):
                eng.step()
            run["step_ms"] = (time.perf_counter() - t0) * 1e3 / (eng.decode_steps - steps0)
            run["step_coll_ms"] = (sum(eng._group.op_s.values()) - op1) * 1e3 / (eng.decode_steps - steps0)
            while eng.has_unfinished():
                eng.step()
        run["wire"] = eng.tp_wire_step_bytes
        run["mem"] = eng.tp_call(TP_PROBES, "rank_memory")
        run["init_s"] = init_s
        run["stages"] = eng._ranks.start_stages
        same = sum(x == y for s1, s2 in zip(run["tokens"], serve_run["tokens"]) for x, y in zip(s1, s2))
        firsts = sum(s1[0] == s2[0] for s1, s2 in zip(run["tokens"], serve_run["tokens"]))
        run["same"], run["firsts"] = same, firsts
        print(f"phase 4n (a) tp=2 {layout} (both ranks on the card, gloo, no graph): init {init_s:.2f} s (rank 1's "
              f"start-up stages, s: {run['stages'][0]}), prefill "
              f"{run['prefill_ms']:.2f} ms over {run['prefill_forwards']} forwards, decode {run['decode_ms']:.3f} ms/step, "
              f"{run['tok_s']:.2f} generated tok/s; decode-only {run['step_ms']:.3f} ms/step of which the collectives "
              f"(rank 0's host time in its group ops) {run['step_coll_ms']:.3f} ms; collectives over the whole "
              f"generate {run['coll_ms']:.1f} ms; wire bytes a decode step {run['wire']:.0f}; each rank's peak memory "
              f"{[m['peak'] for m in run['mem']]} bytes; K1 {[c['k1'] for c in cs]}, "
              f"K4 {[c['k4'] for c in cs]} by rank; tokens equal to phase 4's tp=1 streams {same} of {32 * n}, first "
              f"tokens {firsts} of {n} {card}")
        if layout == "paged":
            # (a) logits: the first decode step against tp=1's, and the int8 collective's drift
            lg = eng.tp_call(TP_PROBES, "rank_decode_logits", short)
            lq = eng.tp_call(TP_PROBES, "rank_decode_logits", short, "int8")
            check(all(torch.equal(x, lg[0]) for x in lg) and all(torch.equal(x, lq[0]) for x in lq),
                  "phase 4n (a): the ranks' gathered logits differ")
            d_tp = (lg[0] - ref_logits).abs().max().item()
            top = (lg[0].argmax(-1) == ref_logits.argmax(-1)).sum().item()
            lp, lpq = torch.log_softmax(lg[0], -1), torch.log_softmax(lq[0], -1)
            am = lg[0].argmax(-1, keepdim=True)
            drift = (lp.gather(1, am) - lpq.gather(1, am)).abs().max().item()
            run.update(logit_err=d_tp, top1=top, drift=drift, logit_scale=ref_logits.abs().max().item())
            fp_step = lg[0]  # the fp sums' first decode step: (a) int8's reference
            check(d_tp <= TP_LOGIT_TOL, f"phase 4n (a): the first decode step's logits at tp=2 differ from tp=1's by "
                                        f"{d_tp:.4g} (tol {TP_LOGIT_TOL})")
            check(0.0 < drift < TP_DRIFT_TOL, f"phase 4n (a): int8 collective logprob drift {drift:.4g} not in "
                                              f"(0, {TP_DRIFT_TOL})")
            print(f"phase 4n (a) logits: one decode step after the 8 prompts' first {TP_LOGIT_PREFIX} tokens, tp=2 vs "
                  f"tp=1 max |d| {d_tp:.4g} (tol {TP_LOGIT_TOL}; logits up to {run['logit_scale']:.3g}), argmax equal "
                  f"in {top} of {n}; int8 collective vs fp: logprob drift at the argmax {drift:.4g} (bound "
                  f"{TP_DRIFT_TOL}) {card}")
            # (c) K1 and K4 held in rank 1 at its shapes
            held = eng.tp_call(TP_PROBES, "rank_hold_kernels", lens)[1]
            k1c, k4c = held["k1"], held["k4"]
            check(k1c["ok"], f"phase 4n (c): K1 in rank 1 at {k1c['shape']}: |do| {k1c['err_o']:.3g} |dlse| "
                             f"{k1c['err_lse']:.3g}")
            check(k4c["ok"], f"phase 4n (c): K4 in rank 1 at {k4c['shape']}: max |d| {k4c['err']:.3g} rel "
                             f"{k4c['rel']:.3g}")
            out["held"] = held
            print(f"phase 4n (c) rank 1's kernels at its shapes, held against their plain versions there: K1 "
                  f"{k1c['shape']}: |do| {k1c['err_o']:.3g} |dlse| {k1c['err_lse']:.3g}, {k1c['ms']:.4f} ms (plain "
                  f"{k1c['plain_ms']:.4f}, SDPA {k1c['sdpa_ms']:.4f}, bound {k1c['bound_ms']:.4f} {k1c['bound_by']}); K4 "
                  f"{k4c['shape']}: max |d| {k4c['err']:.3g} (rel {k4c['rel']:.3g}), {k4c['ms']:.4f} ms (plain "
                  f"{k4c['plain_ms']:.4f}, bound {k4c['bound_ms']:.4f} {k4c['bound_by']}) {card}")
            # (e)'s reference: the shortest prompt alone on this engine
            run["alone"] = eng.generate(first, SamplingParams(max_tokens=TP_SERVE_TOKENS)).token_ids
        runs[layout] = run
        close(eng)
        del eng
        torch.cuda.empty_cache()
    out["a"] = runs

    # ---- (a) int8: a tp_collective="int8" engine on the same weights, where every per-layer sum is nonzero; its
    # first fused decode step's logits, tapped at the sampler on each rank, against the fp sums' (lg above)
    eng = LLMEngine(cfg, mesh=mesh, kv_layout="paged", seed=0, tp_collective="int8", **ek)

    def int8_run():
        eng.tp_call(TP_PROBES, "rank_tap_sample", True)
        ids = [eng.add_request(p, SamplingParams(max_tokens=TP_INT8_TOKENS)) for p in short]
        eng.step()  # admits the 8 short prompts and runs the first fused step
        check(eng.num_waiting == 0, f"phase 4n (a) int8: {eng.num_waiting} prompts not admitted in one step")
        slot_of = {st.request_id: st.slot for st in eng._slots if st is not None}
        taps = eng.tp_call(TP_PROBES, "rank_tap_sample", False)
        while eng.has_unfinished():
            eng.step()
        return [slot_of[i] for i in ids], taps

    (rows, taps), cs = counted(eng, "(a) int8", int8_run, L)
    wire8 = eng.tp_wire_step_bytes
    close(eng)
    del eng
    torch.cuda.empty_cache()
    check(taps[0] is not None and all(torch.equal(x, taps[0]) for x in taps),
          "phase 4n (a) int8: no fused step tapped, or the ranks' gathered logits differ")
    l8 = taps[0][rows]
    am = fp_step.argmax(-1, keepdim=True)
    drift8 = (torch.log_softmax(fp_step, -1).gather(1, am) - torch.log_softmax(l8, -1).gather(1, am)).abs().max().item()
    d8 = (l8 - fp_step).abs().max().item()
    top8 = (l8.argmax(-1) == fp_step.argmax(-1)).sum().item()
    check(0.0 < drift8 < TP_DRIFT_TOL, f"phase 4n (a) int8: the int8 engine's first fused step's logprob drift "
                                       f"{drift8:.4g} from the fp sums' not in (0, {TP_DRIFT_TOL})")
    check(wire8 < runs["paged"]["wire"], f"phase 4n (a) int8: wire bytes a step {wire8} not under fp's "
                                         f"{runs['paged']['wire']}")
    out["a_int8"] = dict(drift=drift8, logit_err=d8, top1=top8, wire=wire8, k1=[c["k1"] for c in cs],
                         k4=[c["k4"] for c in cs])
    print(f"phase 4n (a) int8: a tp=2 paged engine with tp_collective='int8' on the same weights, the 8 prompts' first "
          f"{TP_LOGIT_PREFIX} tokens for {TP_INT8_TOKENS} tokens each: its first fused decode step (tapped at the "
          f"sampler, both ranks equal) vs the fp sums: logprob drift at the fp argmax {drift8:.4g} (bound "
          f"{TP_DRIFT_TOL}), max |d logit| {d8:.4g}, argmax equal in {top8} of {n}; wire bytes a decode step {wire8} vs "
          f"fp {runs['paged']['wire']} ({wire8 / runs['paged']['wire']:.3f}x); K1 {out['a_int8']['k1']}, K4 "
          f"{out['a_int8']['k4']} by rank {card}")

    # ---- (d) on (a)'s weights: n-gram spec at tp=2 against (a)'s plain paged engine, gated as phase 4d is (first
    # tokens equal, acceptance > 0); how often the streams part is set beside phase 4d's tp=1 spec vs phase 4
    eng = LLMEngine(cfg, mesh=mesh, kv_layout="paged", seed=0, speculative=SpecConfig(k=SPEC_K), **ek)
    outs, cs = counted(eng, "(d) random", lambda: eng.generate(prompts, SamplingParams(max_tokens=32)), L)
    st = eng.spec_stats()
    close(eng)
    del eng
    torch.cuda.empty_cache()
    toks, plain = [o.token_ids for o in outs], runs["paged"]["tokens"]
    firsts = sum(a[0] == b[0] for a, b in zip(toks, plain))
    check(all(len(t) == 32 for t in toks) and firsts == n and st["accepted"] > 0,
          f"phase 4n (d) random weights: lengths {[len(t) for t in toks]}, first tokens equal the plain tp=2 engine's "
          f"in {firsts} of {n}, accepted {st['accepted']}")
    split2 = sum(a != b for a, b in zip(toks, plain))
    same2 = sum(x == z for a, b in zip(toks, plain) for x, z in zip(a, b))
    split1 = sum(a != b for a, b in zip(spec1_tokens, serve_run["tokens"]))
    same1 = sum(x == z for a, b in zip(spec1_tokens, serve_run["tokens"]) for x, z in zip(a, b))
    out["d_random"] = dict(split=split2, same=same2, split_tp1=split1, same_tp1=same1, stats=st,
                           k4=[c["k4"] for c in cs])
    print(f"phase 4n (d) n-gram spec (k={SPEC_K}) at tp=2, paged, on (a)'s random bf16 weights: first tokens equal the "
          f"plain tp=2 engine's in {n} of {n}, acceptance {st['acceptance_rate']:.3f} ({st['accepted']} of "
          f"{st['proposed']}), {st['rounds']} rounds; streams parting from the plain tp=2 engine's {split2} of {n} "
          f"({same2} of {32 * n} tokens equal); the tp=1 witness, phase 4d's paged n-gram spec vs phase 4's plain "
          f"engine on the same weights and prompts: {split1} of {n} part ({same1} of {32 * n} tokens equal); K4 "
          f"{out['d_random']['k4']} by rank {card}")

    # ---- (b) the decisive workload: tp=1, tp=2 fp and tp=2 int8 on the successor params
    cfg_s = dataclasses.replace(cfg, num_layers=TP_SUCC_LAYERS)
    succ = successor_params(torch, cfg_s, dev)
    sp = [[(i + j) % TP_SUCC_PERIOD for j in range(3 + i)] for i in range(8)]
    want = [[(p[-1] + 1 + j) % TP_SUCC_PERIOD for j in range(32)] for p in sp]
    eng = LLMEngine(cfg_s, succ, kv_layout="paged", device=dev, **ek)
    base = [o.token_ids for o in eng.generate(sp, SamplingParams(max_tokens=32))]
    del eng
    check(base == want, "phase 4n (b): the tp=1 successor streams do not follow the map")
    dec = {}
    for coll in ("fp", "int8", "spec"):
        # (d) rides here too: n-gram speculation at tp=2 (fp sums) on the decisive workload, where the k+1-token
        # verify and the 1-token step must pick the same tokens, so whole streams are gated (on (a)'s random
        # weights, above, only the first tokens are: near-ties part the streams there, as at tp=1 in phase 4d)
        kw = dict(speculative=SpecConfig(k=SPEC_K)) if coll == "spec" else dict(tp_collective=coll)
        eng = LLMEngine(cfg_s, succ, mesh=mesh, kv_layout="paged", **kw, **ek)
        outs, cs = counted(eng, f"(b) {coll}", lambda: eng.generate(sp, SamplingParams(max_tokens=32)),
                           TP_SUCC_LAYERS)
        dec[coll] = dict(tokens=[o.token_ids for o in outs], wire=eng.tp_wire_step_bytes, k4=[c["k4"] for c in cs],
                         stats=eng.spec_stats())
        close(eng)
        del eng
        torch.cuda.empty_cache()
    del succ
    st = dec["spec"]["stats"]
    check(dec["spec"]["tokens"] == dec["fp"]["tokens"] and st["accepted"] > 0,
          f"phase 4n (d): n-gram spec at tp=2 differs from the plain tp=2 engine in "
          f"{sum(a != b for a, b in zip(dec['spec']['tokens'], dec['fp']['tokens']))} of {len(sp)} streams "
          f"(accepted {st['accepted']})")
    print(f"phase 4n (d) n-gram spec (k={SPEC_K}) at tp=2, paged, on the decisive workload: {len(sp)} of {len(sp)} "
          f"greedy streams equal the plain tp=2 engine's; {st['rounds']} rounds, acceptance {st['acceptance_rate']:.3f}, "
          f"{st['mean_tokens_per_round']:.2f} tokens a lane-round, K4 {dec['spec']['k4']} by rank (= {TP_SUCC_LAYERS} x "
          f"rounds) "
          f"{card}")
    torch.cuda.empty_cache()
    check(dec["fp"]["tokens"] == base and dec["int8"]["tokens"] == base,
          f"phase 4n (b): the decisive streams differ: fp {dec['fp']['tokens'] == base}, int8 "
          f"{dec['int8']['tokens'] == base}")
    check(dec["int8"]["wire"] < dec["fp"]["wire"], f"phase 4n (b): int8 wire bytes {dec['int8']['wire']} not under "
                                                   f"fp's {dec['fp']['wire']}")
    out["b"] = dec
    print(f"phase 4n (b) decisive workload (the successor map at full width, {TP_SUCC_LAYERS} layers): tp=1, tp=2 fp and "
          f"tp=2 int8 give 8 of 8 "
          f"identical greedy streams of 32 tokens; wire bytes a decode step fp {dec['fp']['wire']:.0f}, int8 "
          f"{dec['int8']['wire']:.0f} ({dec['int8']['wire'] / dec['fp']['wire']:.3f}x; the once-a-step embed sum and "
          f"logits gather are fp in both; this model's per-layer sums are zeros) {card}")

    # ---- (e) Serve: a TP replica on the one card
    rtt.init(num_cpus=8)
    rpids = []
    try:
        ekw = dict(SERVE_ENGINE_KWARGS, mesh=mesh)
        t0 = time.perf_counter()
        h = serve.run(build_llm_deployment(LLMConfig(model_config=cfg, engine_kwargs=ekw, tensor_parallel_size=TP_N,
                                                     num_tpus_per_replica=1), _cls={LLMServer: CardTpServer}),
                      name="llm_tp", blocking_timeout_s=SERVE_TIMEOUT_S)
        up = time.perf_counter() - t0
        rpids = h.tp_pids.remote().result(timeout_s=SERVE_TIMEOUT_S)
        o = h.generate.remote(first, {"max_tokens": TP_SERVE_TOKENS}).result(timeout_s=SERVE_TIMEOUT_S)
        check(o["token_ids"] == runs["paged"]["alone"], "phase 4n (e): the TP replica's tokens differ from (a)'s "
                                                        "paged engine's on the same prompt")
        check(len(rpids) == TP_N - 1 and all(process_runs(p) for p in rpids),
              f"phase 4n (e): the replica's rank pids {rpids}")
    finally:
        serve.shutdown()
        rtt.shutdown()
    check(all(gone(p) for p in rpids), f"phase 4n (e): rank processes {rpids} outlived serve.shutdown()")
    back = _wait_mem(torch, mem0, 60.0)
    check(back is not None, f"phase 4n (e): the card's memory {card_used(torch)} not back to {mem0} after shutdown")
    print(f"phase 4n (e) Serve TP replica (tensor_parallel_size=2, num_tpus_per_replica=1, one-card mesh): up in "
          f"{up:.2f} s, the shortest prompt's {TP_SERVE_TOKENS} tokens equal (a)'s; after serve.shutdown() its rank "
          f"process gone and the "
          f"card's memory back in {back:.2f} s {card}")
    for k in ("k1", "k4"):
        out["held"][k]["launch_note"] = (f"{out['launches'][k]} launches in 2 ranks x (the paged, slot, int8 and "
                                         f"spec engines on the random weights; the fp, int8 and spec engines on the "
                                         f"copy model)")
    check(len(set(pids)) == len(pids) and all(not process_runs(p) for p in pids),
          f"phase 4n: rank processes left: {[p for p in pids if process_runs(p)]}")
    print(f"phase 4n: {time.perf_counter() - t_phase:.1f} s {card}")
    return out


REMAT_LOSS_TOL = 1e-3  # step 1's loss under each policy vs nothing_saveable's (bf16 ~10.4; the same forward)
REMAT_MEM_SLACK = 16 << 20  # peak bytes: the policies' order may tie within this
# K1's forwards a layer and step under each policy, in the order of their peak memory: the recompute runs K1
# again (no policy keeps attention, a kernel and no product); K2 and K3 run once a layer
REMAT_K1_FORWARDS = {"nothing_saveable": 2, "dots_with_no_batch_dims_saveable": 2, "dots_saveable": 2,
                     "everything_saveable": 1}


def remat_on_card(torch, cfg7, data, card) -> dict:
    """Phase 7e: phase 7's step under each of the four distinct remat
    policies (the aliases are the same policies): step 1's loss, the
    median ms/step of REMAT_TIMED steps after REMAT_WARMUP, tok/s, MFU,
    peak memory after a reset, and K1/K2/K3 launches per step. Gated: the
    loss equal to nothing_saveable's within REMAT_LOSS_TOL, the peaks
    ordered, the launches as REMAT_K1_FORWARDS says; K1-K3 held at the step's shape
    under the dots policy. The times are recorded, not gated."""
    import dataclasses
    import statistics
    from functools import partial

    from ray_tpu_torch.models.llama import flops_per_token, init_params, loss_fn
    from ray_tpu_torch.ops.flash_attention import flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step, to_device

    kernels = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    Bt, Tt = data["tokens"].shape
    L = cfg7.num_layers
    n_steps = REMAT_WARMUP + REMAT_TIMED
    rows = {}
    t_phase = time.perf_counter()
    expect = {p: (f * L, L, L) for p, f in REMAT_K1_FORWARDS.items()}
    for policy in REMAT_K1_FORWARDS:
        cfg = dataclasses.replace(cfg7, remat_policy=policy)
        init_fn, step_fn = make_train_step(partial(loss_fn, config=cfg), adamw(3e-4, weight_decay=0.01))
        state = init_fn(0, partial(init_params, cfg))
        batch = to_device(data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        times, losses = [], []
        for i in range(n_steps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            state, m = step_fn(state, batch)
            e1.record()
            losses.append(m["loss"])
            if i >= REMAT_WARMUP:
                times.append((e0, e1))
        torch.cuda.synchronize()
        per_step = tuple(k.launches / n_steps for k in kernels)
        ms = statistics.median(a.elapsed_time(b) for a, b in times)
        tok_s = Bt * Tt / (ms / 1e3)
        rows[policy] = dict(loss1=losses[0].item(), last=losses[-1].item(), ms=ms, tok_s=tok_s,
                            mfu=flops_per_token(cfg, Tt) * tok_s / BF16_FLOPS, peak=torch.cuda.max_memory_allocated(),
                            launches=per_step, steps=n_steps)
        del state, batch, m, losses
        gc.collect()
        torch.cuda.empty_cache()
        r = rows[policy]
        print(f"phase 7e remat_policy={policy}: step 1 loss {r['loss1']:.6f} (step {n_steps} {r['last']:.6f}), "
              f"{r['ms']:.2f} ms/step (median of {REMAT_TIMED} after {REMAT_WARMUP}), {r['tok_s']:.1f} tok/s, MFU "
              f"{r['mfu']:.4f}, peak memory {r['peak']} bytes, launches per step K1 {per_step[0]:g} K2 "
              f"{per_step[1]:g} K3 {per_step[2]:g} {card}")
    base = rows["nothing_saveable"]
    for policy, r in rows.items():
        check(abs(r["loss1"] - base["loss1"]) <= REMAT_LOSS_TOL,
              f"phase 7e: step 1's loss under {policy} {r['loss1']} != nothing_saveable's {base['loss1']} (tol "
              f"{REMAT_LOSS_TOL})")
        check(r["launches"] == expect[policy], f"phase 7e: launches per step under {policy} {r['launches']} "
                                                     f"!= {expect[policy]}")
    order = list(REMAT_K1_FORWARDS)
    peaks = [rows[p]["peak"] for p in order]
    check(all(a <= b + REMAT_MEM_SLACK for a, b in zip(peaks, peaks[1:])),
          f"phase 7e: peak memory not ordered {dict(zip(order, peaks))}")
    held = hold_train_kernels(Bt, cfg7.num_heads, cfg7.num_kv_heads, Tt, cfg7.hd)
    check(held["k1"]["ok"] and held["k23"]["ok"], f"phase 7e: K1-K3 at the step's shape against their plain "
                                                  f"versions: K1 {held['k1']['err_o']:.3g}, K2/K3 {held['k23']['errs']}")
    print(f"phase 7e K1-K3 held against their plain versions at {held['k1']['shape']} (dots policies' step): K1 |do| "
          f"{held['k1']['err_o']:.3g}, {held['k1']['ms']:.4f} ms; K2/K3 {held['k23']['errs']}, dQ "
          f"{held['k23']['dq_ms']:.4f} ms, dK/dV {held['k23']['dkv_ms']:.4f} ms; phase 7e "
          f"{time.perf_counter() - t_phase:.1f} s {card}")
    return dict(rows=rows, held=held,
                launches=[sum(int(r["launches"][i] * r["steps"]) for r in rows.values()) for i in range(3)])


# ---------------------------------------------------------------- --gates: phases 7b, 7c and 7d alone
def gates_main(torch) -> int:
    """``python3 chip_smoke.py --gates``: build the kernels, serve phase
    4's 8 prompts on phase 4's engine in this process for the reference
    tokens, run phase 7's step for its loss and
    ms/step, then phases 7b, 7c and 7d as the whole script runs them, and
    print one ``GATES`` line with their release times and 7d (b)'s hop
    against its round trip. Compares trees: run one checkout's script
    against another's package by copying it into that checkout."""
    from functools import partial

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step, to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    _kernels.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    cfg = LlamaConfig.llama3_8b(max_seq_len=2048, remat=False)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    drv_checksum = weights_checksum(params)
    rng = np.random.default_rng(0)
    rng.permutation(256)  # phase 3's draw: the prompts are phase 4's
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in rng.integers(50, 1501, size=8)]
    eng = LLMEngine(cfg, params, **SERVE_ENGINE_KWARGS)
    gr = _generate(eng, prompts)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    cfg7 = LlamaConfig(vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_layers=18, num_heads=16,
                       num_kv_heads=8, max_seq_len=2048)
    init_fn, step_fn = make_train_step(partial(loss_fn, config=cfg7), adamw(3e-4, weight_decay=0.01))
    state = init_fn(0, partial(init_params, cfg7))
    trng = np.random.default_rng(0)
    data = {"tokens": trng.integers(0, cfg7.vocab_size, (8, 2048)).astype(np.int32),
            "targets": trng.integers(0, cfg7.vocab_size, (8, 2048)).astype(np.int32)}
    batch = to_device(data)
    state, m = step_fn(state, batch)
    first_loss = m["loss"].item()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step_fn(state, batch)
    m["loss"].item()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    del state, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    marks = {}
    trn = train_on_card(torch, cfg7, data, first_loss, step_s, card)
    marks["7b"] = round(time.perf_counter() - t_start, 1)
    torch.cuda.empty_cache()
    tun = tune_on_card(torch, cfg7, data, first_loss, step_s, trn["A"]["losses"], cfg, prompts, gr, drv_checksum, card)
    marks["7c"] = round(time.perf_counter() - t_start, 1)
    torch.cuda.empty_cache()
    dag = dag_on_card(torch, cfg, prompts, gr, drv_checksum, card)
    marks["7d"] = round(time.perf_counter() - t_start, 1)
    print("GATES " + json.dumps({
        "7b_release_s": [trn["A"]["release_s"], trn["B"]["release_s"]],
        "7c_release_s": [tun["a"]["release_s"], tun["b"]["release_s"], tun["c"]["release_s"]],
        "7d_hop_us": dag["b"]["hop_us"], "7d_rtt_us": dag["b"]["rtt_us"], "7d_hop_gate_us": dag["b"]["rtt_us"] / 4,
        "7d_release_s": [dag["c"]["release_s"], dag["d"]["release_s"]], "marks": marks, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch's serving and training paths on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero before the last line:

1. Build the CUDA kernels (K1 flash-attention forward, K2/K3 its backward,
   K4 paged-attention partials, K5 fused RMSNorm) from ray_tpu_torch/csrc
   with nvcc for sm_90a, in parallel. Prints ptxas's registers and spills
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
8. The training path, card against host: the same widths at 2 layers in
   f32, batch 1 x 128, 2 steps; losses, grad norms and the first step's
   gradients must agree.

Prints the card's name and power limit (nvidia-smi), one JSON line with
the kernels' launches, errors and times, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Times are CUDA-event means after warm-up (L2 warm; the K4 pages exceed it),
K4's and K5's the least of 5 rounds of 20 calls, K5 in turns with F.rms_norm;
for a launch-bound call the CUDA-event time is the host's enqueue, which
the device time and the host cost per call tell apart.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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


def self_device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dataclasses
    from functools import partial

    import numpy as np
    import torch.nn.functional as F

    from ray_tpu_torch import _kernels
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

    def mark(phase):
        marks[phase] = round(time.perf_counter() - t_start, 1)

    # ---------------------------------------------------------------- 1
    build_s = _kernels.build_all()
    for name in _kernels.SOURCES:
        _kernels.library(name)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    print(f"phase 1 build: {build_s:.2f} s for {list(_kernels.SOURCES)} (nvcc sm_90a, parallel) {card}")
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
        nbytes = 2.0 * (2 * B * H * T * D + 2 * B * HKV * T * D) + 4.0 * B * H * T  # q, o, k, v bf16; lse f32
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        row = dict(B=B, H=H, HKV=HKV, T=T, err_o=err_o, err_lse=err_lse, ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                   tflops=flops / ms * 1e-9, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
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
        nkv, hd, R = qf.shape[1], qf.shape[4], qf.shape[2] * qf.shape[3]
        tok = sum(bounds)  # positions read: each lane's bound
        nbytes = tok * nkv * hd * 2 * pk.element_size() + (tok * nkv * 2 * 4 if sk is not None else 0)
        nbytes += qf.numel() * 4 + (m.numel() * 2 + acc.numel()) * 4 + (tables.numel() + bound.numel()) * 4
        t_ops = 4.0 * tok * nkv * R * hd / F32_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return dict(ms=cuda_ms_turns(torch, [call])[0], device_ms=device_ms(torch, call, K4_KERNELS),
                    host_us=host_us(torch, call),
                    plain_ms=cuda_ms(torch, partial(paged_attn_partials_ref, qf, pk, pv, tables, bound, sk, sv),
                                     iters=5, warmup=1),
                    bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")

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
    del params
    torch.cuda.empty_cache()

    mark("4f")
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
            pairs = (T * (T + 1) / 2 if causal else T * T) * B * H_
            es = q.element_size()
            rows_bytes = 2 * 4.0 * B * H_ * T  # lse and delta, f32
            for kern, flops, nbytes in (
                ("dq", 6.0 * D_ * pairs, es * (3.0 * B * H_ * T * D_ + 2.0 * B * HKV_ * T * D_) + rows_bytes),
                ("dkv", 8.0 * D_ * pairs, es * (2.0 * B * H_ * T * D_ + 4.0 * B * HKV_ * T * D_) + rows_bytes),
            ):
                t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
                row[f"{kern}_bound_ms"] = max(t_ops, t_bytes)
                row[f"{kern}_bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
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
    # ---------------------------------------------------------------- 8
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
    print(f"phase 8 training whole path (2 layers, f32, 1 x 128, card vs host): losses {[c[0] for c in on_card]} vs "
          f"{[h[0] for h in on_host]}, loss/grad-norm relative error {max(step_errs):.3g}, first-step gradients "
          f"{grad_err:.3g} of each leaf's max (tol {TRAIN_WHOLE_TOL})")

    rep1 = next(r for r in k1_rows if (r["B"], r["T"]) == (2, 2048))
    rep4 = next(r for r in k4_rows if (r["pool"], r["T"], r["B"]) == ("bf16", 1, Bl))
    rep4q = next(r for r in k4_rows if (r["pool"], r["T"], r["B"]) == ("int8", 1, Bl))
    rep4v = next(r for r in k4_rows if (r["pool"], r["T"], r["B"]) == ("bf16", SPEC_K + 1, Bl))  # the verify's shape
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
        dict(name="K5 rms_norm_fused", route="cuda", source="ray_tpu_torch/csrc/rms_norm.cu",
             replaces="ray_tpu/ops/layers.py:22", launches=k5_launches,
             max_abs_err=max(r["err"] for r in k5_rows), ms=rep5["ms"], plain_ms=rep5["plain_ms"],
             bound_ms=rep5["bound_ms"], bound_by=rep5["bound_by"], library_ms=rep5["lib_ms"],
             device_ms=rep5["device_ms"], host_us=rep5["host_us"]),
    ]
    mark("8")
    print(f"telemetry overhead (phase 4, paged graph engine): {tel_ratio:.4f}x (gate {TEL_GATE}) {card}")
    print(f"total {time.perf_counter() - t_start:.1f} s (each phase's end: {marks})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def profile_step(torch, step_fn, state, batch, card, table_path) -> dict[str, int]:
    """One training step under torch.profiler: the device time by kernel
    into ``table_path``, and one summary line (K1, K2, K3, matrix products,
    the rest, and the device's idle share of the step). Returns how many
    times each wgmma kernel (K1, K2, K3) ran in the step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)[1]["loss"].item()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "gemm": 0.0, "other": 0.0}
    calls = {K1_WGMMA: 0, K2_WGMMA: 0, K3_WGMMA: 0}
    averages = prof.key_averages()
    for e in averages:
        if "CUDA" not in str(e.device_type):  # kernels only: a CPU op's device time repeats its kernels'
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


def timed_calls(torch, fn, log):
    """``fn`` wrapped to append (its arguments, the call's milliseconds on
    the host clock, the card synchronised before and after) to ``log``."""

    def run(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
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


if __name__ == "__main__":
    sys.exit(main())

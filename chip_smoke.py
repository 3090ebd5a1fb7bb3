#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch's serving path on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero before the last line:

1. Build the CUDA kernels (K1 flash-attention forward, K4 paged-attention
   partials) from ray_tpu_torch/csrc with nvcc for sm_90a, in parallel.
2. K1 against its plain PyTorch version on the card, at the prefill shapes
   of Llama-3-8B (32 query heads, 8 kv heads, head_dim 128, bf16), timed
   beside the plain version, PyTorch's scaled_dot_product_attention and
   the card's bound.
3. K4 against its plain version on the card (8 lanes, 8 kv heads, rep 4,
   page 64, T in {1, 5}, bf16 and int8 pools, bounds 0 .. ~2000), plus the
   combined page attention against the host path; timed the same way.
4. The engine: full-width Llama-3-8B (random weights from a seed, bf16)
   serves 8 seeded prompts of 50-1500 tokens, 32 greedy tokens each. The
   kernels' launch counters are zeroed just before and read just after:
   K1 must have run 32 times per prefill forward, K4 32 times per decode
   step.
5. The whole path, card against host: the same widths at 2 layers in f32,
   a 64-token prompt and 8 teacher-forced decode steps; prefill and
   decode logits must agree.

Prints the card's name and power limit (nvidia-smi), one JSON line with
the kernels' launches, errors and times, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Times are CUDA-event means after warm-up (L2 warm; the K4 pages exceed it).
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

K1_SHAPES = [(1, 64), (4, 512), (2, 2048), (1, 1000)]  # (B, T): prefill buckets, one ragged
K1_TOL_O, K1_TOL_LSE = 2e-2, 1e-3  # o: bf16 output rounding; lse: f32 sums in another order
K4_BOUNDS = [0, 1, 64, 65, 2000, 2047, 700, 1500]
K4_TOL = 1e-4  # relative, f32 partials summed in another order
COMBINED_TOL = 1e-4  # absolute, normalised f32 attention output vs the host path
WHOLE_PATH_TOL = 2e-3  # absolute, f32 logits after 2 full-width layers, card vs host


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch.nn.functional as F

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.llm import model_runner as mr
    from ray_tpu_torch.llm import paged_kv as pkv
    from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials, paged_attn_partials_ref
    from ray_tpu_torch.llm.kv_quant import quantize_heads
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.ops.flash_attention import attention_with_lse_ref, flash_attention_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

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
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---------------------------------------------------------------- 2
    H, HKV, D = 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(0)
    k1_rows = []
    for B, T in K1_SHAPES:
        q = torch.randn((B, H, T, D), generator=g, device=dev).bfloat16()
        k = torch.randn((B, HKV, T, D), generator=g, device=dev).bfloat16()
        v = torch.randn((B, HKV, T, D), generator=g, device=dev).bfloat16()
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention_with_lse_ref(q, k, v, causal=True)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        check(err_o <= K1_TOL_O and err_lse <= K1_TOL_LSE,
              f"K1 (B={B}, T={T}): |do| {err_o:.3g} (tol {K1_TOL_O}), |dlse| {err_lse:.3g} (tol {K1_TOL_LSE})")
        ms = cuda_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True))
        plain_ms = cuda_ms(torch, lambda: attention_with_lse_ref(q, k, v, causal=True), iters=3, warmup=1)
        sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True))
        flops = 4.0 * B * H * D * T * (T + 1) / 2  # QK^T and PV over the causal pairs
        nbytes = 2.0 * (2 * B * H * T * D + 2 * B * HKV * T * D) + 4.0 * B * H * T  # q, o, k, v bf16; lse f32
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        row = dict(B=B, T=T, err_o=err_o, err_lse=err_lse, ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                   bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")
        k1_rows.append(row)
        print(f"phase 2 K1 B={B} T={T}: |do| {err_o:.3g} |dlse| {err_lse:.3g} kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}) {card}")
    # the other instances the kernel carries: f32 (phase 5 runs it) and head_dim 64
    for dt, d, tol in ((torch.float32, 128, 1e-4), (torch.float32, 64, 1e-4), (torch.bfloat16, 64, K1_TOL_O)):
        q, k, v = (torch.randn(s, generator=g, device=dev).to(dt) for s in ((2, 8, 200, d), (2, 2, 200, d), (2, 2, 200, d)))
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        o_ref, lse_ref = attention_with_lse_ref(q, k, v, causal=True)
        err = (o.float() - o_ref.float()).abs().max().item()
        check(err <= tol and (lse - lse_ref).abs().max().item() <= K1_TOL_LSE, f"K1 {dt} D={d}: |do| {err:.3g}")
        print(f"phase 2 K1 {dt} D={d} T=200: |do| {err:.3g}")

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
    for pname, (pk, pv, sk, sv) in pools.items():
        esize = pk.element_size()
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
            ms = cuda_ms(torch, lambda: paged_attn_partials(qf, pk, pv, tables, bound, sk, sv))
            plain_ms = cuda_ms(torch, lambda: paged_attn_partials_ref(qf, pk, pv, tables, bound, sk, sv), iters=5, warmup=1)
            tok = sum(K4_BOUNDS)
            nbytes = tok * NKV * HD * 2 * esize + (tok * NKV * 2 * 4 if sk is not None else 0)
            nbytes += qf.numel() * 4 + (m.numel() * 2 + acc.numel()) * 4 + (tables.numel() + bound.numel()) * 4
            flops = 4.0 * tok * NKV * REP * T * HD
            t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            row = dict(pool=pname, T=T, err=err, rel=rel, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")
            k4_rows.append(row)
            print(f"phase 3 K4 {pname} T={T}: max |d| {err:.3g} (rel {rel:.3g}) kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}) {card}")
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

    # ---------------------------------------------------------------- 4
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig.llama3_8b(max_seq_len=2048, remat=False)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = LLMEngine(cfg, params, max_num_seqs=8, page_size=64)
    lens = rng.integers(50, 1501, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    flash_attention_fwd.launches = 0
    paged_attn_partials.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate(prompts, SamplingParams(max_tokens=32))
    wall_s = time.perf_counter() - t0
    k1_launches, k4_launches = flash_attention_fwd.launches, paged_attn_partials.launches
    check(all(len(o.token_ids) == 32 and o.finish_reason == "length" for o in outs),
          f"engine: not every request finished with 32 tokens: {[(len(o.token_ids), o.finish_reason) for o in outs]}")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o.token_ids), "engine: token outside the vocabulary")
    check(k1_launches == cfg.num_layers * eng.prefill_forwards > 0,
          f"K1 launches {k1_launches} != {cfg.num_layers} x {eng.prefill_forwards} prefill forwards")
    check(k4_launches == cfg.num_layers * eng.decode_steps > 0,
          f"K4 launches {k4_launches} != {cfg.num_layers} x {eng.decode_steps} decode steps")
    check(eng.kv_cache_stats()["attn_kernel"] == "cuda", "engine did not resolve the CUDA kernel")
    peak = torch.cuda.max_memory_allocated()
    gen_tok = sum(len(o.token_ids) for o in outs)
    print(f"phase 4 engine llama3_8b (32 layers, bf16, random weights) 8 prompts of {sorted(int(n) for n in lens)} "
          f"tokens, 32 greedy tokens each: init {init_s:.2f} s, prefill {eng.prefill_s * 1e3:.2f} ms over "
          f"{eng.prefill_forwards} forwards, decode {eng.decode_s * 1e3 / eng.decode_steps:.3f} ms/step over "
          f"{eng.decode_steps} steps, {gen_tok / wall_s:.2f} generated tok/s ({wall_s:.3f} s wall), "
          f"K1 launches {k1_launches}, K4 launches {k4_launches}, peak memory {peak} bytes {card}")
    del eng, params, outs
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 5
    cfg2 = LlamaConfig.llama3_8b(max_seq_len=2048, remat=False, num_layers=2, dtype="float32")
    p_gpu = init_params(cfg2, torch.Generator(device=dev).manual_seed(1))
    p_cpu = {k: ({n: w.cpu() for n, w in v.items()} if isinstance(v, dict) else v.cpu()) for k, v in p_gpu.items()}
    prompt = rng.integers(1, cfg2.vocab_size, size=64)
    forced = rng.integers(1, cfg2.vocab_size, size=8)
    flash_attention_fwd.launches = 0
    paged_attn_partials.launches = 0

    def run(params, device):
        pcfg = pkv.PagedCacheConfig(num_layers=2, num_pages=3, page_size=64, max_pages_per_seq=2, num_slots=1,
                                    num_kv_heads=cfg2.num_kv_heads, head_dim=cfg2.hd, dtype="float32")
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

    on_card = run(p_gpu, dev)
    check(flash_attention_fwd.launches == 2 and paged_attn_partials.launches == 2 * len(forced),
          "whole path: the card run did not go through K1 and K4")
    on_host = run(p_cpu, torch.device("cpu"))
    errs = [(a - b).abs().max().item() for a, b in zip(on_card, on_host)]
    scale = max(b.abs().max().item() for b in on_host)
    check(all(np.isfinite(errs)) and max(errs) <= WHOLE_PATH_TOL,
          f"whole path: logits differ by {max(errs):.3g} (tol {WHOLE_PATH_TOL})")
    print(f"phase 5 whole path (2 layers, f32, card vs host): prefill |dlogits| {errs[0]:.3g}, decode max "
          f"{max(errs[1:]):.3g} over {len(forced)} steps (max |logit| {scale:.3g}, tol {WHOLE_PATH_TOL})")

    rep1 = next(r for r in k1_rows if (r["B"], r["T"]) == (2, 2048))
    rep4 = next(r for r in k4_rows if (r["pool"], r["T"]) == ("bf16", 1))
    kernels = [
        dict(name="K1 flash_attention_fwd", route="cuda", source="ray_tpu_torch/csrc/flash_attention.cu",
             replaces="ray_tpu/ops/flash_attention.py:104", launches=k1_launches,
             max_abs_err=max(r["err_o"] for r in k1_rows), ms=rep1["ms"], plain_ms=rep1["plain_ms"],
             bound_ms=rep1["bound_ms"], bound_by=rep1["bound_by"], library_ms=rep1["sdpa_ms"]),
        dict(name="K4 paged_attn_partials", route="cuda", source="ray_tpu_torch/csrc/paged_attn.cu",
             replaces="ray_tpu/llm/pallas/paged_attn.py:134", launches=k4_launches,
             max_abs_err=max(r["err"] for r in k4_rows), ms=rep4["ms"], plain_ms=rep4["plain_ms"],
             bound_ms=rep4["bound_ms"], bound_by=rep4["bound_by"], library_ms=None),
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

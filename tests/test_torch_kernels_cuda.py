"""The CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA card (``cuda`` marker) and skips
elsewhere; the file imports no jax, so it runs on the chip machine:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances: bf16 K1 outputs 2e-2 (both round P to bf16 before P·V, the
kernel relative to the running max and the plain version relative to the
final logsumexp; one bf16 ulp at |o| ~ 1 is 2^-7);
f32 outputs and lse 1e-4 / 1e-3 (f32 sums in another order); K4
partials 1e-4 relative (l and acc where the bound is above 0; at bound 0
the kernel returns l = acc = 0, csrc/paged_attn.cu), at decode and at the
extend's row counts; the extend's normalised attention 1e-4 absolute. K2/K3 gradients relative to the largest |grad| (at least 1):
f32 1e-4 (f32 sums in another order), bf16 2e-2 (the kernels round P and
dS to bf16, 2^-9 relative each, before the f32 sums over up to T terms, and
the outputs to bf16 after them; the plain version keeps P and dS in f32). K5: f32 1e-5
relative, bf16 one bf16 ulp (2^-7 relative).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import paged_kv as pkv
from ray_tpu_torch.llm.cuda import paged_attn as tpa
from ray_tpu_torch.llm.kv_quant import quantize_heads
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops import layers as tl

pytestmark = pytest.mark.cuda

PAGE = 16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, *shape, device):
    return torch.randn(shape, generator=g, device=device)


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("T", [1, 64, 127, 128, 129, 1000, 2048])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_k1_kernel_matches_plain(dev, dtype, atol, T, D, rep, causal):
    """Both instances at every tile edge (the bf16 one tiles 128 rows and
    keys: T = 1 and 64 fill under half a tile, 127-129 straddle one), GQA
    rep 1-4, random (so not symmetric) V at both head dims."""
    g = torch.Generator(device=dev).manual_seed(T * D + rep)
    q = _randn(g, 2, 2 * rep, T, D, device=dev).to(dtype)
    k = _randn(g, 2, 2, T, D, device=dev).to(dtype)
    v = _randn(g, 2, 2, T, D, device=dev).to(dtype)
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1 and o.dtype == dtype
    o_ref, lse_ref = tfa.attention_with_lse_ref(q, k, v, causal=causal)
    assert (o.float() - o_ref.float()).abs().max().item() <= atol
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def test_k1_wrapper_raises_on_inputs_the_kernel_does_not_take(dev):
    q = torch.zeros((1, 4, 8, 128), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q, q[:, :2], q[:, :2])
    q = torch.zeros((1, 4, 8, 96), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 8, 4, 64), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q, q, q)


def test_k1_bf16_raises_on_a_misaligned_base(dev):
    """The bf16 instances read through TMA, which needs 16-byte aligned
    bases: a contiguous tensor sliced one element into its buffer raises,
    in the wrapper and in the C launcher, and nothing runs instead."""
    shape = (1, 2, 64, 128)
    buf = torch.randn(2 * 64 * 128 + 1, device=dev).bfloat16()
    q = buf[1:].view(shape)
    assert q.is_contiguous() and q.data_ptr() % 16
    k = torch.randn(shape, device=dev).bfloat16()
    before = tfa.flash_attention_fwd.launches
    for args in ((q, k, k), (k, k, q)):
        with pytest.raises(ValueError, match="aligned"):
            tfa.flash_attention_fwd(*args)
    assert tfa.flash_attention_fwd.launches == before
    o, lse = torch.empty_like(k), torch.empty((1, 2, 64), device=dev)
    err = tfa._fn()(q.data_ptr(), k.data_ptr(), k.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    1, 2, 2, 64, 128, 1, 128**-0.5, 1, torch.cuda.current_stream().cuda_stream)
    assert err == -2
    # f32 reads element by element: the same offset is taken
    qf = torch.randn(2 * 64 * 128 + 1, device=dev)[1:].view(shape)
    o, _ = tfa.flash_attention_fwd(qf, qf, qf)
    assert torch.isfinite(o).all()


def _pool(g, P, nkv, hd, kind, dev, page=PAGE):
    k, v = _randn(g, P, page, nkv, hd, device=dev), _randn(g, P, page, nkv, hd, device=dev)
    if kind == "int8":
        kq, ks = quantize_heads(k)
        vq, vs = quantize_heads(v)
        return kq, vq, ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    return k.to(dt), v.to(dt), None, None


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("T,hd,rep", [(1, 128, 4), (5, 128, 4), (1, 64, 8), (16, 64, 4)])
def test_k4_kernel_matches_plain(dev, kind, T, hd, rep):
    g = torch.Generator(device=dev).manual_seed(T * hd)
    B, nkv, P, max_pg = 6, 2, 40, 6
    pk, pv, ks, vs = _pool(g, P, nkv, hd, kind, dev)
    qf = _randn(g, B, nkv, rep, T, hd, device=dev) * hd**-0.5
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(rng.permutation(np.arange(1, P))[: B * max_pg].reshape(B, max_pg).astype(np.int32)).to(dev)
    bound = torch.tensor([0, 1, PAGE, PAGE + 1, 70, max_pg * PAGE], dtype=torch.int32, device=dev)
    before = tpa.paged_attn_partials.launches
    m, l, acc = tpa.paged_attn_partials(qf, pk, pv, tables, bound, ks, vs)
    torch.cuda.synchronize()
    assert tpa.paged_attn_partials.launches == before + 1
    m_r, l_r, acc_r = tpa.paged_attn_partials_ref(qf, pk, pv, tables, bound, ks, vs)
    live = bound > 0  # l/acc differ at bound 0 by design (csrc/paged_attn.cu)
    assert torch.allclose(m, m_r, atol=1e-4)
    assert torch.allclose(l[live], l_r[live], rtol=1e-4, atol=1e-4)
    assert torch.allclose(acc[live], acc_r[live], rtol=1e-4, atol=1e-3)
    assert torch.all(l[~live] == 0) and torch.all(acc[~live] == 0)


def _k4_case(layout, dev):
    """(B, nkv, page, max_pg, bounds) of a split-plan case; the bounds
    straddle the split length ``split_plan`` gives this card."""
    B, nkv, page, max_pg = {"edges": (8, 2, PAGE, 14), "all_zero": (3, 2, PAGE, 14), "one_lane": (1, 2, PAGE, 14),
                            "one_page": (4, 2, PAGE, 1), "page64": (2, 8, 64, 32)}[layout]
    pps, nsplit = tpa.split_plan(max_pg, page, B * nkv, tpa._sm_count(dev.index))
    span, full = pps * page, max_pg * page
    bounds = {"edges": [0, 1, span - 1, span, span + 1, 2 * span, 2 * span + 1, full],
              "all_zero": [0] * B, "one_lane": [full - 1], "one_page": [0, 1, page - 1, page],
              "page64": [full - 1, span + 3]}[layout]
    assert (nsplit > 1) == (layout not in ("one_page",)) and all(0 <= b <= full for b in bounds)
    return B, nkv, page, max_pg, bounds


def _k4_inputs(g, kind, T, hd, rep, layout, dev):
    B, nkv, page, max_pg, bounds = _k4_case(layout, dev)
    P = B * max_pg + 1  # every lane its own pages; page 0 unused, as the engine's padding page
    pk, pv, ks, vs = _pool(g, P, nkv, hd, kind, dev, page)
    qf = _randn(g, B, nkv, rep, T, hd, device=dev) * hd**-0.5
    rng = np.random.default_rng(len(bounds))
    tables = torch.from_numpy(rng.permutation(np.arange(1, P)).reshape(B, max_pg).astype(np.int32)).to(dev)
    return qf, pk, pv, tables, torch.tensor(bounds, dtype=torch.int32, device=dev), ks, vs


@pytest.mark.parametrize("layout", ["edges", "all_zero", "one_lane", "one_page", "page64"])
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("T,hd,rep", [(1, 128, 4), (5, 128, 4), (1, 64, 8), (16, 64, 4), (16, 128, 4)])
def test_k4_split_plan_matches_plain(dev, layout, kind, T, hd, rep):
    """The split kernel and its merge against the plain version: bounds at
    0, 1 and a split's edge -1, 0, +1 (the first and the second), a full
    table; every lane at bound 0; a single lane; one table column; page 64
    with 8 kv heads as the served model has; T 1, 5 and 16 (R = 64) at
    both head dims; f32, bf16 and int8 pools."""
    g = torch.Generator(device=dev).manual_seed(T * hd + rep)
    qf, pk, pv, tables, bound, ks, vs = _k4_inputs(g, kind, T, hd, rep, layout, dev)
    before = tpa.paged_attn_partials.launches
    m, l, acc = tpa.paged_attn_partials(qf, pk, pv, tables, bound, ks, vs)
    torch.cuda.synchronize()
    assert tpa.paged_attn_partials.launches == before + 1
    m_r, l_r, acc_r = tpa.paged_attn_partials_ref(qf, pk, pv, tables, bound, ks, vs)
    live = bound > 0
    assert torch.allclose(m, m_r, atol=1e-4)
    assert torch.allclose(l[live], l_r[live], rtol=1e-4, atol=1e-4)
    assert torch.allclose(acc[live], acc_r[live], rtol=1e-4, atol=1e-3)
    assert torch.all(l[~live] == 0) and torch.all(acc[~live] == 0) and torch.all(m[~live] == tpa._NEG)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("T", [17, 64, 512])
def test_k4_extend_rows_match_plain(dev, kind, hd, T):
    """The prefix-cache extend's shapes: rep 4 and a suffix bucket's T, so
    R = 68 (a 64-row tile and a ragged 4-row one), 256 and 2048 rows per kv
    head, one lane at a prefix start as the engine gives it and two more at
    ragged bounds, bf16 and int8 pools at both head dims."""
    g = torch.Generator(device=dev).manual_seed(T + hd)
    B, nkv, rep, max_pg = 3, 2, 4, 20
    P = B * max_pg + 1
    pk, pv, ks, vs = _pool(g, P, nkv, hd, kind, dev)
    qf = _randn(g, B, nkv, rep, T, hd, device=dev) * hd**-0.5
    rng = np.random.default_rng(T)
    tables = torch.from_numpy(rng.permutation(np.arange(1, P)).reshape(B, max_pg).astype(np.int32)).to(dev)
    bound = torch.tensor([4 * PAGE, 9 * PAGE + 5, max_pg * PAGE - 1], dtype=torch.int32, device=dev)
    before = tpa.paged_attn_partials.launches
    m, l, acc = tpa.paged_attn_partials(qf, pk, pv, tables, bound, ks, vs)
    torch.cuda.synchronize()
    assert tpa.paged_attn_partials.launches == before + 1
    m_r, l_r, acc_r = tpa.paged_attn_partials_ref(qf, pk, pv, tables, bound, ks, vs)
    assert torch.allclose(m, m_r, atol=1e-4)
    assert torch.allclose(l, l_r, rtol=1e-4, atol=1e-4)
    assert torch.allclose(acc, acc_r, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("hd", [64, 128])
def test_k4_extend_rows_at_the_served_widths(dev, kind, hd):
    """R = 8192 (T = 2048) on one lane with 8 kv heads and page 64 at a
    1024-token prefix, as the engine's extend of a 2048-token bucket over a
    cached prefix gives it: 1024 row-tile blocks, no split."""
    g = torch.Generator(device=dev).manual_seed(hd)
    nkv, rep, T, max_pg, page = 8, 4, 2048, 32, 64
    pk, pv, ks, vs = _pool(g, max_pg + 1, nkv, hd, kind, dev, page)
    qf = _randn(g, 1, nkv, rep, T, hd, device=dev) * hd**-0.5
    tables = torch.arange(1, max_pg + 1, dtype=torch.int32, device=dev)[None]
    bound = torch.tensor([1024], dtype=torch.int32, device=dev)
    assert tpa.split_plan(max_pg, page, nkv * tpa.row_tiles(rep * T), tpa._sm_count(dev.index))[1] == 1
    m, l, acc = tpa.paged_attn_partials(qf, pk, pv, tables, bound, ks, vs)
    m_r, l_r, acc_r = tpa.paged_attn_partials_ref(qf, pk, pv, tables, bound, ks, vs)
    assert torch.allclose(m, m_r, atol=1e-4)
    assert torch.allclose(l, l_r, rtol=1e-4, atol=1e-4)
    assert torch.allclose(acc, acc_r, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("T", [1, 5, 17, 64, 512])
def test_k4_never_reads_at_or_past_the_bound(dev, kind, T):
    """NaN in every pool position at or past each lane's bound (for int8
    the scales there are NaN and the values 127), including the tail of
    the last page below the bound and the pages of a split past it, at
    decode and extend rows (T 17-512: R = 68-2048, several row tiles): the
    outputs stay finite and equal to those of the clean pool."""
    g = torch.Generator(device=dev).manual_seed(11)
    qf, pk, pv, tables, bound, ks, vs = _k4_inputs(g, kind, T, 128, 4, "edges", dev)
    bound[2] -= 5  # the last page below this lane's bound ends in 5 poisoned positions
    clean = tpa.paged_attn_partials(qf, pk, pv, tables, bound, ks, vs)
    pk2, pv2 = pk.clone(), pv.clone()
    ks2, vs2 = (None, None) if ks is None else (ks.clone(), vs.clone())
    page = pk.shape[1]
    for b in range(tables.shape[0]):
        for j in range(tables.shape[1]):
            first = max(int(bound[b]) - j * page, 0)
            if first >= page:
                continue
            pid = int(tables[b, j])
            if kind == "int8":
                pk2[pid, first:], pv2[pid, first:] = 127, -127
                ks2[pid, :, first:], vs2[pid, :, first:] = float("nan"), float("nan")
            else:
                pk2[pid, first:], pv2[pid, first:] = float("nan"), float("nan")
    dirty = tpa.paged_attn_partials(qf, pk2, pv2, tables, bound, ks2, vs2)
    torch.cuda.synchronize()
    for a, b in zip(clean, dirty):
        assert torch.isfinite(b).all() and torch.equal(a, b)


def test_k4_wrapper_raises_on_inputs_the_kernel_does_not_take(dev):
    pk = torch.zeros((3, PAGE, 2, 128), device=dev, dtype=torch.bfloat16)
    tables = torch.ones((1, 2), dtype=torch.int32, device=dev)
    bound = torch.ones((1,), dtype=torch.int32, device=dev)
    q = torch.zeros((1, 2, 4, 1, 128), device=dev)
    with pytest.raises(ValueError, match="rep"):
        tpa.paged_attn_partials(torch.zeros((1, 2, 4, 0, 128), device=dev), pk, pk, tables, bound)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attn_partials(torch.zeros((1, 2, 4, 1, 96), device=dev), pk, pk, tables, bound)
    with pytest.raises(ValueError, match="aligned"):
        off = torch.zeros(3 * PAGE * 2 * 128 + 1, device=dev, dtype=torch.bfloat16)[1:].view(pk.shape)
        tpa.paged_attn_partials(q, off, pk, tables, bound)
    with pytest.raises(ValueError, match="scales"):
        tpa.paged_attn_partials(q, pk.to(torch.int8), pk.to(torch.int8), tables, bound)


def test_page_attention_on_card_matches_host_and_ignores_write_target(dev):
    """The combined output at every bound (0 included) against the host
    path, and the aliasing contract on the card: poisoning each lane's
    write position changes nothing."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, nkv, rep, hd, P = 4, 2, 4, 128, 17
    pk, pv, _, _ = _pool(g, P, nkv, hd, "f32", dev)
    qg = _randn(g, B, nkv, rep, hd, device=dev)
    k_self, v_self = _randn(g, B, nkv, hd, device=dev), _randn(g, B, nkv, hd, device=dev)
    table = torch.arange(1, 17, dtype=torch.int32, device=dev).reshape(B, 4)
    lengths = torch.tensor([0, 5, PAGE, 2 * PAGE + 1], dtype=torch.int32, device=dev)
    scale = hd**-0.5
    out = pkv._paged_attn_batch(qg, pk, pv, table, lengths, scale, k_self, v_self)
    host = pkv._paged_attn_batch(*(t.cpu() for t in (qg, pk, pv, table, lengths)), scale, k_self.cpu(), v_self.cpu())
    assert (out.cpu() - host).abs().max().item() <= 1e-4
    pk2, pv2 = pk.clone(), pv.clone()
    for b in range(B):
        pos = int(lengths[b])
        page_id = int(table[b, pos // PAGE])
        pk2[page_id, pos % PAGE] = 1e9
        pv2[page_id, pos % PAGE] = -1e9
    assert torch.equal(out, pkv._paged_attn_batch(qg, pk2, pv2, table, lengths, scale, k_self, v_self))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_extend_attention_on_card_matches_host(dev, kind):
    """``_paged_attn_seq_batch`` (K4 over the prefix, the chunk causally from
    registers) on the card against the host path at starts 0, 64 and 100,
    hd 128, rep 4, T 64; and the kernel path against the per-lane plain
    ``_paged_attn_seq`` on the card."""
    g = torch.Generator(device=dev).manual_seed(3)
    B, nkv, rep, hd, T, max_pg = 3, 2, 4, 128, 64, 16
    P = B * max_pg + 1
    pk, pv, ks, vs = _pool(g, P, nkv, hd, kind, dev)
    qg = _randn(g, B, nkv, rep, T, hd, device=dev)
    kc, vc = _randn(g, B, T, nkv, hd, device=dev), _randn(g, B, T, nkv, hd, device=dev)
    tables = torch.arange(1, P, dtype=torch.int32, device=dev).reshape(B, max_pg)
    starts = torch.tensor([0, 64, 100], dtype=torch.int32, device=dev)
    scale = hd**-0.5
    before = tpa.paged_attn_partials.launches
    out = pkv._paged_attn_seq_batch(qg, pk, pv, tables, starts, kc, vc, scale, ks, vs)
    assert tpa.paged_attn_partials.launches == before + 1
    cpu = [None if t is None else t.cpu() for t in (qg, pk, pv, tables, starts, kc, vc, ks, vs)]
    host = pkv._paged_attn_seq_batch(*cpu[:7], scale, *cpu[7:])
    assert (out.cpu() - host).abs().max().item() <= 1e-4
    for b in range(B):
        lane = pkv._paged_attn_seq(qg[b], pk, pv, tables[b], int(starts[b]), kc[b], vc[b], scale, ks, vs)
        assert (lane - out[b]).abs().max().item() <= 1e-4


def _rel_err(out, ref, floor=1e-30):
    return (out.float() - ref.float()).abs().max().item() / max(ref.float().abs().max().item(), floor)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 191, 1000, 2048])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_k2_k3_kernels_match_plain(dev, dtype, tol, T, D, rep, causal):
    """Both instances at every tile edge (the bf16 ones stream 64-row tiles
    past a block's own 128 rows: T = 1 and 63 fill under one streamed tile,
    63-65 and 127-129 straddle one, 191 leaves the second warpgroup one
    row short of a tile), GQA rep 1-4, random (so not symmetric) inputs at
    both head dims, so that a wrong descriptor cannot pass."""
    g = torch.Generator(device=dev).manual_seed(T * D + rep)
    q = _randn(g, 2, 2 * rep, T, D, device=dev).to(dtype)
    k = _randn(g, 2, 2, T, D, device=dev).to(dtype)
    v = _randn(g, 2, 2, T, D, device=dev).to(dtype)
    do = _randn(g, 2, 2 * rep, T, D, device=dev).to(dtype)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    before = (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    dq_r, dk_r, dv_r = tfa.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    refs = (dq_r.to(dtype), tfa._sum_rep(dk_r, 2).to(dtype), tfa._sum_rep(dv_r, 2).to(dtype))
    for out, ref in zip((dq, dk, dv), refs):
        assert out.dtype == dtype and out.shape == ref.shape
        # relative to the largest |grad|, or to 1 where the gradient is ~0 by
        # construction (T = 1: P = 1 and dP = delta, so dq and dk are rounding)
        assert _rel_err(out, ref, floor=1.0) <= tol


def test_flash_attention_function_on_card_matches_host(dev):
    """Forward and gradients of the autograd Function, card (K1, K2, K3)
    against host (plain versions), f32, GQA rep 2."""
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = ((2, 4, 100, 64), (2, 2, 100, 64), (2, 2, 100, 64))
    host = [_randn(gen, *s, device=dev).cpu().requires_grad_(True) for s in shapes]
    card = [t.detach().to(dev).requires_grad_(True) for t in host]
    go = _randn(gen, 2, 4, 100, 64, device=dev)
    for leaves, gout in ((host, go.cpu()), (card, go)):
        tfa.flash_attention(*leaves).backward(gout)
    for h, c in zip(host, card):
        assert _rel_err(c.grad.cpu(), h.grad) <= 1e-4


def test_k2_k3_wrappers_raise_on_inputs_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 4, 8, 64), device=dev)
    kv = torch.zeros((1, 2, 8, 64), device=dev)
    lse = torch.zeros((1, 4, 8), device=dev)
    with pytest.raises(TypeError, match="f32"):
        tfa.flash_attention_bwd(q, kv, kv, q, lse.double(), lse)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_bwd(q, kv, kv, q.transpose(1, 2).contiguous().transpose(1, 2), lse, lse)
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_attention_bwd(q, kv, kv, q, lse[:, :2], lse)


def test_k2_k3_bf16_raise_on_a_misaligned_base(dev):
    """The bf16 instances read q, k, v and dO through TMA, which needs
    16-byte aligned bases: a contiguous tensor sliced one element into its
    buffer raises, in the wrappers and in the C launchers, and nothing runs
    instead; the f32 instances read element by element and take it."""
    shape = (1, 2, 64, 128)
    n = 2 * 64 * 128
    off = torch.randn(n + 1, device=dev).bfloat16()[1:].view(shape)
    assert off.is_contiguous() and off.data_ptr() % 16
    x = torch.randn(shape, device=dev).bfloat16()
    rows = torch.zeros((1, 2, 64), device=dev)
    before = (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches)
    for args in ((off, x, x, x), (x, off, x, x), (x, x, off, x), (x, x, x, off)):
        for fn in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
            with pytest.raises(ValueError, match="aligned"):
                fn(*args, rows, rows)
    assert (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches) == before
    dq_fn, dkv_fn = tfa._bwd_fns()
    out, out2 = torch.empty_like(x), torch.empty_like(x)
    tail = (1, 2, 2, 64, 128, 1, 128**-0.5, 1, torch.cuda.current_stream().cuda_stream)
    ins = (x.data_ptr(), x.data_ptr(), x.data_ptr(), off.data_ptr(), rows.data_ptr(), rows.data_ptr())
    assert dq_fn(*ins, out.data_ptr(), *tail) == -2
    assert dkv_fn(*ins, out.data_ptr(), out2.data_ptr(), *tail) == -2
    xf = torch.randn(n + 1, device=dev)[1:].view(shape)
    dq, dk, dv = tfa.flash_attention_bwd(xf, xf, xf, xf, rows, rows)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", [(5, 64), (300, 2048), (7, 1000), (3, 4096), (4, 13)])
def test_k5_kernel_matches_plain(dev, xdt, wdt, rows, d):
    g = torch.Generator(device=dev).manual_seed(rows * d)
    x = (_randn(g, rows, d, device=dev) * 3).to(xdt)
    w = _randn(g, d, device=dev).to(wdt)
    before = tl.rms_norm_fused.launches
    out = tl.rms_norm_fused(x, w, 1e-5)
    torch.cuda.synchronize()
    assert tl.rms_norm_fused.launches == before + 1 and out.dtype == xdt and out.shape == x.shape
    assert _rel_err(out, tl.rms_norm(x, w, 1e-5)) <= (2**-7 if xdt == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [13, 1000, 4096, 16384])
@pytest.mark.parametrize("rows", [1, 9])
def test_k5_paths_match_plain(dev, aligned, xdt, wdt, d, rows):
    """K5 across its dispatch edges (``rms_norm_plan``): 1 and 9 rows (one
    and two blocks of eight warps), d 13 (element by element), 1000 and
    4096 (a warp per row; 4096 f32 is the warp path's widest row), 16384
    (a block per row), and an x whose base is not 16-byte aligned (element
    by element at every width)."""
    g = torch.Generator(device=dev).manual_seed(rows * d)
    flat = (_randn(g, rows * d + 1, device=dev) * 3).to(xdt)
    x = flat[:-1].view(rows, d) if aligned else flat[1:].view(rows, d)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == aligned
    w = _randn(g, d, device=dev).to(wdt)
    before = tl.rms_norm_fused.launches
    out = tl.rms_norm_fused(x, w, 1e-5)
    torch.cuda.synchronize()
    assert tl.rms_norm_fused.launches == before + 1 and out.dtype == xdt and out.shape == x.shape
    assert _rel_err(out, tl.rms_norm(x, w, 1e-5)) <= (2**-7 if xdt == torch.bfloat16 else 1e-5)


def test_stream_ptr_is_the_current_stream(dev):
    """The wrappers' raw stream handle is the current stream's, on the
    default stream and inside a side stream's context."""
    from ray_tpu_torch import _kernels

    assert _kernels.stream_ptr(dev) == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        x = torch.randn((9, 4096), device=dev).bfloat16()
        w = torch.randn((4096,), device=dev).bfloat16()
        assert _kernels.stream_ptr(x.device) == side.cuda_stream
        out = tl.rms_norm_fused(x, w)
    side.synchronize()
    assert _rel_err(out, tl.rms_norm(x, w)) <= 2**-7

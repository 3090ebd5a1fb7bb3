"""K4 (paged-attention partials): the port's plain version against the
JAX Pallas kernel in interpret mode, m/l/acc compared directly, at the
ragged bounds that break off-by-one page masking (0, 1, page, page+1),
for decode (T=1), wide blocks (T=5) and the extend's chunk rows (rep 4,
T 17/32/64: R = 68, 128, 256, past one 64-row tile), fp and int8 pools.
The kernel's split plan and row tiles emulated in plain PyTorch against
both. The write-target poison test (twin of tests/test_llm_pallas.py),
the combined page attention against ray_tpu's ``_paged_attn_batch`` and
the extend's attention (prefix partials + causal chunk) against ray_tpu's
``_paged_attn_seq_batch`` on both of its paths. f32 throughout: atol
1e-5 (same arithmetic, other summation order); the extend's normalised
output 1e-4 (a T-wide f32 softmax over the chunk in another order).
The CUDA kernel against the plain version is in
tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu.llm import paged_kv as jpkv  # noqa: E402
from ray_tpu.llm.kv_quant import quantize_heads as jquant  # noqa: E402
from ray_tpu.llm.pallas.paged_attn import paged_attn_partials as pallas_partials  # noqa: E402
from ray_tpu_torch.llm import paged_kv as tpkv  # noqa: E402
from ray_tpu_torch.llm.cuda import paged_attn as tpa  # noqa: E402

PAGE = 16
ATOL = 1e-5


def _pool(rng, P, nkv, hd, quant):
    """(k, v, k_scale, v_scale) as numpy; int8 pools quantized by JAX."""
    k = rng.standard_normal((P, PAGE, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((P, PAGE, nkv, hd)).astype(np.float32)
    if not quant:
        return k, v, None, None
    kq, ks = jquant(jnp.asarray(k))
    vq, vs = jquant(jnp.asarray(v))
    return (np.asarray(kq), np.asarray(vq),
            np.ascontiguousarray(np.asarray(ks).transpose(0, 2, 1)), np.ascontiguousarray(np.asarray(vs).transpose(0, 2, 1)))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("T", [1, 5])
def test_plain_k4_matches_pallas_interpret_at_ragged_bounds(quant, T):
    rng = np.random.default_rng(0)
    B, nkv, rep, hd, P = 4, 2, 2, 32, 9
    k, v, ks, vs = _pool(rng, P, nkv, hd, quant)
    qf = (rng.standard_normal((B, nkv, rep, T, hd)) / np.sqrt(hd)).astype(np.float32)
    tables = rng.integers(1, P, size=(B, 4)).astype(np.int32)
    bound = np.array([0, 1, PAGE, PAGE + 1], np.int32)
    ref = pallas_partials(_j(qf), _j(k), _j(v), _j(tables), _j(bound), _j(ks), _j(vs), interpret=True)
    out = tpa.paged_attn_partials(_t(qf), _t(k), _t(v), _t(tables), _t(bound), _t(ks), _t(vs))
    for name, o, r in zip(("m", "l", "acc"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("T", [17, 32, 64])
def test_plain_k4_matches_pallas_interpret_at_chunk_rows(quant, T):
    """The extend's shapes: rep 4 and a suffix bucket's T, so R = 68, 128
    and 256 rows per kv head (two, two and four of the kernel's row
    tiles), at ragged bounds below, on and past page edges."""
    rng = np.random.default_rng(T)
    B, nkv, rep, hd, P = 3, 2, 4, 32, 9
    k, v, ks, vs = _pool(rng, P, nkv, hd, quant)
    qf = (rng.standard_normal((B, nkv, rep, T, hd)) / np.sqrt(hd)).astype(np.float32)
    tables = rng.integers(1, P, size=(B, 4)).astype(np.int32)
    bound = np.array([PAGE - 1, 2 * PAGE, 3 * PAGE + 5], np.int32)
    ref = pallas_partials(_j(qf), _j(k), _j(v), _j(tables), _j(bound), _j(ks), _j(vs), interpret=True)
    out = tpa.paged_attn_partials(_t(qf), _t(k), _t(v), _t(tables), _t(bound), _t(ks), _t(vs))
    for name, o, r in zip(("m", "l", "acc"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_page_attention_matches_jax_paged_attn_batch(quant):
    """The combined output (partials + self fold + normalise) against
    ray_tpu's XLA page scan at bounds 0, 1, page, page+1."""
    rng = np.random.default_rng(1)
    B, nkv, rep, hd, P = 4, 2, 3, 32, 9
    k, v, ks, vs = _pool(rng, P, nkv, hd, quant)
    qg = rng.standard_normal((B, nkv, rep, hd)).astype(np.float32)
    table = rng.integers(1, P, size=(B, 4)).astype(np.int32)
    lengths = np.array([0, 1, PAGE, PAGE + 1], np.int32)
    k_self = rng.standard_normal((B, nkv, hd)).astype(np.float32)
    v_self = rng.standard_normal((B, nkv, hd)).astype(np.float32)
    scale = 1.0 / np.sqrt(hd)
    ref = jpkv._paged_attn_batch(_j(qg), _j(k), _j(v), _j(table), _j(lengths), scale, _j(k_self), _j(v_self),
                                 k_scale_l=_j(ks), v_scale_l=_j(vs))
    out = tpkv._paged_attn_batch(_t(qg), _t(k), _t(v), _t(table), _t(lengths), scale, _t(k_self), _t(v_self),
                                 _t(ks), _t(vs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_write_target_poison_cannot_reach_attention():
    """The aliasing contract: each lane's write position (index
    ``lengths[b]``) is poisoned in the pool and the attention output must
    not change — the current token reaches attention only through the
    k_self/v_self registers, never a pool read."""
    rng = np.random.default_rng(7)
    B, nkv, rep, hd, P = 3, 4, 2, 32, 13
    k, v, _, _ = _pool(rng, P, nkv, hd, False)
    qg = torch.from_numpy(rng.standard_normal((B, nkv, rep, hd)).astype(np.float32))
    # distinct pages per (lane, column), as the allocator guarantees
    table = torch.from_numpy(rng.permutation(np.arange(1, 13)).reshape(B, 4).astype(np.int32))
    k_self = torch.from_numpy(rng.standard_normal((B, nkv, hd)).astype(np.float32))
    v_self = torch.from_numpy(rng.standard_normal((B, nkv, hd)).astype(np.float32))
    lengths = torch.tensor([5, PAGE, 2 * PAGE + 1], dtype=torch.int32)
    scale = 1.0 / np.sqrt(hd)
    clean = tpkv._paged_attn_batch(qg, _t(k), _t(v), table, lengths, scale, k_self, v_self)
    pk, pv = k.copy(), v.copy()
    for b in range(B):
        pos = int(lengths[b])
        page_id = int(table[b, pos // PAGE])
        pk[page_id, pos % PAGE] = 1e9  # the write target the append owns
        pv[page_id, pos % PAGE] = -1e9
    dirty = tpkv._paged_attn_batch(qg, _t(pk), _t(pv), table, lengths, scale, k_self, v_self)
    assert torch.equal(clean, dirty)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(2)
    k, v, _, _ = _pool(rng, 5, 2, 32, False)
    qf = torch.from_numpy(rng.standard_normal((2, 2, 2, 1, 32)).astype(np.float32))
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    bound = torch.tensor([3, 20], dtype=torch.int32)
    before = tpa.paged_attn_partials.launches
    out = tpa.paged_attn_partials(qf, _t(k), _t(v), tables, bound)
    ref = tpa.paged_attn_partials_ref(qf, _t(k), _t(v), tables, bound)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert tpa.paged_attn_partials.launches == before


@pytest.mark.parametrize("max_pg,page,lanes,sms,plan", [
    (32, 64, 64, 132, (4, 8)),  # the served Llama-3-8B at batch 8: 512 blocks, 4 a SM with every table full
    (32, 64, 8, 132, (1, 32)),  # one lane: 256 blocks, where one block per kv head gave 8
    (32, 64, 1024, 132, (32, 1)),  # enough lanes to fill the card without splitting: no merge pass
    (12, 16, 12, 132, (4, 3)),  # at least one 64-position chunk per split at page 16
    (10, 16, 12, 132, (4, 3)),  # max_pg not a multiple of the split: the last split is short
    (1, 16, 2, 132, (4, 1)),
    (0, 64, 8, 132, (1, 1)),  # no table columns: one empty split per lane
    (4096, 16, 10000, 132, (256, 16)),  # at most 256 table entries staged per split
    # the extend at Llama-3-8B (B = 1, 8 kv heads, page 64, max_pg 32): lanes = 8 x row tiles
    (32, 64, 8 * 128, 132, (32, 1)),  # T = 2048, R = 8192: 128 tiles fill the card unsplit, no scratch
    (32, 64, 8 * 4, 132, (2, 16)),  # T = 64, R = 256: 4 tiles
    (32, 64, 8 * 2, 132, (1, 32)),  # T = 17, R = 68: 2 tiles
])
def test_split_plan(max_pg, page, lanes, sms, plan):
    pps, nsplit = tpa.split_plan(max_pg, page, lanes, sms)
    assert (pps, nsplit) == plan
    assert pps * nsplit >= max_pg and pps * (nsplit - 1) < max(max_pg, 1)


def test_row_tiles():
    assert [tpa.row_tiles(R) for R in (1, 4, 64, 65, 68, 256, 8192)] == [1, 1, 1, 2, 2, 4, 128]


def _split_emulation(qf, k, v, tables, bound, ks, vs, sms):
    """The kernel's grid in plain PyTorch: each kv head's R = rep * T rows
    (contiguous in (rep, T) order) cut into ``row_tiles`` tiles of at most
    64 rows, ``split_plan``'s splits over the lanes of row tiles, each
    split's partials over its table columns and positions below the bound
    (the empty partial where the split starts at or past it), then the
    merge: ``_combine`` over the splits that hold data, in order."""
    B, nkv, rep, T, hd = qf.shape
    R = rep * T
    page, max_pg = k.shape[1], tables.shape[1]
    pps, nsplit = tpa.split_plan(max_pg, page, B * nkv * tpa.row_tiles(R), sms)
    span = pps * page
    nb = bound.clamp(max=max_pg * page)
    rows = qf.reshape(B, nkv, R, 1, hd)
    outs = []
    for r0 in range(0, R, tpa.ROWS):
        q_tile = rows[:, :, r0:r0 + tpa.ROWS].contiguous()
        m = torch.full(q_tile.shape[:4], tpa._NEG)
        l, acc = torch.zeros(q_tile.shape[:4]), torch.zeros(q_tile.shape)
        for s in range(nsplit):
            local = (nb - s * span).clamp(0, span).to(torch.int32)
            ms, ls, accs = tpa.paged_attn_partials_ref(q_tile, k, v, tables[:, s * pps:(s + 1) * pps].contiguous(),
                                                       local, ks, vs)
            held = (local > 0)[:, None, None, None]
            mm, ll, aa = tpkv._combine(m, l, acc, ms, ls, accs)
            m, l, acc = torch.where(held, mm, m), torch.where(held, ll, l), torch.where(held[..., None], aa, acc)
        outs.append((m, l, acc))
    m, l, acc = (torch.cat(parts, dim=2) for parts in zip(*outs))
    return nsplit, (m.reshape(B, nkv, rep, T), l.reshape(B, nkv, rep, T), acc.reshape(B, nkv, rep, T, hd))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("T", [1, 5, 40])
def test_split_plan_emulation_matches_plain_and_pallas_interpret(quant, T):
    """Splitting each lane's pages and merging the splits gives the one-pass
    partials: against ``paged_attn_partials_ref`` and ray_tpu's K4 in
    interpret mode, at bounds 0, 1, a split's edge (64) and past it, and a
    full table, with 3 splits (one SM count) and 1 (another); splits past
    a lane's bound hold nothing. T = 40 gives R = 80 rows: a 64-row tile
    and a ragged 16-row one. At bound 0 the split plan gives the kernel's
    l = acc = 0 (the documented difference); m agrees everywhere."""
    rng = np.random.default_rng(5)
    B, nkv, rep, hd, max_pg = 6, 2, 2, 32, 12
    P = B * max_pg + 1
    k, v, ks, vs = _pool(rng, P, nkv, hd, quant)
    qf = (rng.standard_normal((B, nkv, rep, T, hd)) / np.sqrt(hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, P)).reshape(B, max_pg).astype(np.int32)
    bound = np.array([0, 1, 64, 65, 129, max_pg * PAGE], np.int32)
    pallas = pallas_partials(_j(qf), _j(k), _j(v), _j(tables), _j(bound), _j(ks), _j(vs), interpret=True)
    args = (_t(qf), _t(k), _t(v), _t(tables), _t(bound), _t(ks), _t(vs))
    plain = tpa.paged_attn_partials_ref(*args)
    live = bound > 0
    for sms, want_splits in ((132, 3), (1, 1)):
        nsplit, out = _split_emulation(*args, sms)
        assert nsplit == want_splits
        for name, o, p, r in zip(("m", "l", "acc"), out, plain, pallas):
            o = o.numpy()
            if name != "m":
                assert np.all(o[~live] == 0), name
                o, p, r = o[live], p.numpy()[live], np.asarray(r)[live]
            np.testing.assert_allclose(o, np.asarray(p), atol=ATOL, rtol=1e-6, err_msg=name)
            np.testing.assert_allclose(o, np.asarray(r), atol=ATOL, rtol=1e-6, err_msg=name)


def _seq_inputs(rng, quant, T, starts):
    B, nkv, rep, hd, max_pg = len(starts), 2, 4, 32, 8
    P = B * max_pg + 1
    k, v, ks, vs = _pool(rng, P, nkv, hd, quant)
    qg = rng.standard_normal((B, nkv, rep, T, hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, P)).reshape(B, max_pg).astype(np.int32)
    k_chunk = rng.standard_normal((B, T, nkv, hd)).astype(np.float32)
    v_chunk = rng.standard_normal((B, T, nkv, hd)).astype(np.float32)
    return qg, k, v, tables, np.array(starts, np.int32), k_chunk, v_chunk, ks, vs


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("T", [5, 32])
def test_extend_attention_matches_jax_paged_attn_seq_batch(quant, T):
    """The extend's attention, a cached prefix below ``starts`` (K4) plus
    the chunk causally from registers, against ray_tpu's
    ``_paged_attn_seq_batch`` on its XLA path (the vmapped per-lane
    oracle) and its Pallas path (interpret mode), at starts 0, 16, 17, 64;
    and the port's per-lane ``_paged_attn_seq`` against the batched one.
    At start 0 the partials differ by design (csrc/paged_attn.cu) and the
    output agrees: the chunk's own softmax outweighs the empty prefix."""
    rng = np.random.default_rng(T + 100 * quant)
    qg, k, v, tables, starts, kc, vc, ks, vs = _seq_inputs(rng, quant, T, [0, 16, 17, 64])
    scale = 1.0 / np.sqrt(qg.shape[-1])
    out = tpkv._paged_attn_seq_batch(_t(qg), _t(k), _t(v), _t(tables), _t(starts), _t(kc), _t(vc), scale,
                                     _t(ks), _t(vs))
    assert out.shape == qg.shape and out.dtype == torch.float32
    for impl in ("xla", "pallas"):
        ref = jpkv._paged_attn_seq_batch(_j(qg), _j(k), _j(v), _j(tables), _j(starts), _j(kc), _j(vc), scale,
                                         k_scale_l=_j(ks), v_scale_l=_j(vs), impl=impl)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, err_msg=impl)
    for b in range(len(starts)):
        lane = tpkv._paged_attn_seq(_t(qg[b]), _t(k), _t(v), _t(tables[b]), int(starts[b]), _t(kc[b]), _t(vc[b]),
                                    scale, _t(ks), _t(vs))
        np.testing.assert_allclose(lane.numpy(), out[b].numpy(), atol=1e-5)


def test_extend_attention_never_reads_the_chunk_from_the_pool():
    """The extend's aliasing contract: the chunk's own positions
    (start .. start + T - 1, which the append writes after the attention)
    poisoned in the pool change nothing."""
    rng = np.random.default_rng(9)
    qg, k, v, tables, starts, kc, vc, _, _ = _seq_inputs(rng, False, 8, [16, 21])
    args = [_t(qg), None, None, _t(tables), _t(starts), _t(kc), _t(vc), 0.25]
    clean = tpkv._paged_attn_seq_batch(*args[:1], _t(k), _t(v), *args[3:])
    pk, pv = k.copy(), v.copy()
    for b, start in enumerate(starts):
        for pos in range(start, start + 8):
            pk[tables[b, pos // PAGE], pos % PAGE] = 1e9
            pv[tables[b, pos // PAGE], pos % PAGE] = -1e9
    assert torch.equal(clean, tpkv._paged_attn_seq_batch(*args[:1], _t(pk), _t(pv), *args[3:]))

"""The port's speculative-decoding units (ray_tpu_torch/llm/spec/) against
ray_tpu's on the same numpy inputs, JAX on the CPU: ``ngram_propose``
(exact, clamp edges included), ``_accept_and_sample`` (greedy and
temperature lanes, spec_k < k: tokens, acc and keys bit-identical,
logprobs within 1e-6), ``_update_hist`` (writes past the edge dropped),
``draft_steps`` (exact tokens), the slot and paged verify (logits within
1e-5 relative, every other output exact or within f32 rounding),
``spec_append_paged`` in bf16 and int8 (bytes equal), and ``SpecConfig``'s
validation messages. A tiny f32 Llama with weights from a numpy seed via
``params_from_jax``."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.llm import kv_quant as jkq  # noqa: E402
from ray_tpu.llm.spec import controller as jctl  # noqa: E402
from ray_tpu.llm.spec import drafter as jdr  # noqa: E402
from ray_tpu.llm.spec import verify as jver  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.llm.spec import controller as tctl  # noqa: E402
from ray_tpu_torch.llm.spec import drafter as tdr  # noqa: E402
from ray_tpu_torch.llm.spec import verify as tver  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)
JCFG, TCFG = jllama.LlamaConfig.tiny(**KW), tllama.LlamaConfig.tiny(**KW)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64) if np.asarray(a).dtype.kind in "iu" else np.asarray(a))


# ------------------------------------------------------------- ngram drafter
NGRAM_CASES = {
    # (rows, hist_len): repeats with a match, no match, ln < n, ln = 0, a
    # match whose continuation runs into the last k columns (the H - k
    # clamp), the trailing occurrence excluded, and a full row
    "repeat": ([5, 6, 7, 8, 5, 6, 7, 9, 5, 6, 7], 11),
    "no_match": ([1, 2, 3, 4, 5, 6, 7], 7),
    "short": ([9, 9], 2),
    "one": ([4], 1),
    "empty": ([], 0),
    "edge": ([3, 1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3], 20),
    "tail": ([7, 7, 7, 7, 7, 7, 7, 7, 7, 7], 10),
    "full": ([1, 2, 3] * 7 + [1], 22),
}


@pytest.mark.parametrize("n, k", [(3, 4), (2, 3), (1, 2), (3, 6)])
def test_ngram_propose_matches_ray_tpu(n, k):
    H = 22
    rows = np.zeros((len(NGRAM_CASES), H), np.int32)
    lens = np.zeros((len(NGRAM_CASES),), np.int32)
    for i, (row, ln) in enumerate(NGRAM_CASES.values()):
        rows[i, : len(row)] = row
        lens[i] = ln
    ref = np.asarray(jdr.ngram_propose(jnp.asarray(rows), jnp.asarray(lens), n, k))
    got = tdr.ngram_propose(_t(rows), _t(lens), n, k).numpy()
    np.testing.assert_array_equal(got, ref)
    drafter = tdr.NGramDrafter(k=k, n=n)
    np.testing.assert_array_equal(drafter.propose(_t(rows), _t(lens), None).numpy(), ref)


# ----------------------------------------------------------- accept + sample
def _accept_inputs(seed, B=6, k=4, V=64):
    """Peaked logits (so stochastic lanes accept often), proposals that
    follow the argmax for a random prefix then diverge, lanes greedy and
    stochastic with top-k / top-p, effective k from 1 to k."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, k + 1, V)) * 4.0).astype(np.float32)
    greedy = logits.argmax(-1)
    props = rng.integers(0, V, size=(B, k)).astype(np.int32)
    for b in range(B):
        m = int(rng.integers(0, k + 1))
        props[b, :m] = greedy[b, :m]
    keys = rng.integers(0, 2**32, size=(B, 2), dtype=np.uint64).astype(np.uint32)
    temps = np.array([0.0, 0.7, 1.0, 0.0, 1.3, 0.9][:B], np.float32)
    top_k = np.array([0, 0, 5, 0, 0, 3][:B], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 1.0, 0.8, 0.95][:B], np.float32)
    spec_k = np.array([4, 4, 2, 1, 3, 4][:B], np.int32)
    return logits, props, spec_k, keys, temps, top_k, top_p


@pytest.mark.parametrize("seed", range(6))
def test_accept_and_sample_bit_identical(seed):
    args = _accept_inputs(seed)
    ref = [np.asarray(a) for a in jver._accept_and_sample(*(jnp.asarray(a) for a in args))]
    logits, props, spec_k, keys, temps, top_k, top_p = args
    got = [t.numpy() for t in tver._accept_and_sample(
        torch.from_numpy(logits), _t(props), _t(spec_k), _t(keys), torch.from_numpy(temps), _t(top_k),
        torch.from_numpy(top_p))]
    emit, logps, acc, final, new_keys = got
    np.testing.assert_array_equal(acc, ref[2])
    np.testing.assert_array_equal(final, ref[3])
    np.testing.assert_array_equal(new_keys, ref[4].astype(np.int64))
    cols = np.arange(props.shape[1] + 1)[None, :] <= acc[:, None]  # the host reads emit[:, :acc + 1]
    np.testing.assert_array_equal(np.where(cols, emit, 0), np.where(cols, ref[0], 0))
    np.testing.assert_allclose(np.where(cols, logps, 0), np.where(cols, ref[1], 0), rtol=0, atol=1e-6)
    assert acc.max() > 0 and (acc < spec_k).any()  # the inputs exercise both outcomes


def test_update_hist_drops_writes_past_the_edge():
    B, H, k = 4, 12, 3
    rng = np.random.default_rng(1)
    hist = rng.integers(1, 50, size=(B, H)).astype(np.int32)
    hist_len = np.array([2, 9, 10, 15], np.int32)  # fits, straddles the edge twice, past it
    emit = rng.integers(50, 99, size=(B, k + 1)).astype(np.int32)
    acc = np.array([0, 3, 1, 2], np.int32)
    ref_hist, ref_len = (np.asarray(a) for a in jver._update_hist(*(jnp.asarray(a) for a in (hist, hist_len, emit,
                                                                                               acc))))
    th = tver.spec_hist_buffer(B, H, "cpu")
    th.copy_(_t(hist))
    got_len = tver._update_hist(th, _t(hist_len), _t(emit), _t(acc))
    np.testing.assert_array_equal(th.numpy(), ref_hist)
    np.testing.assert_array_equal(got_len.numpy(), ref_len)
    with pytest.raises(ValueError, match="spec_hist_buffer"):
        tver._update_hist(_t(hist), _t(hist_len), _t(emit), _t(acc))


# ------------------------------------------------------------- model drafter
def _slot_cache(rng, cfg, B, S, lengths, dtype="float32"):
    shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    out = {"k": k, "v": v, "length": np.asarray(lengths, np.int32)}
    if dtype == "int8":
        kq, ks = (np.asarray(a) for a in jkq.quantize_heads(jnp.asarray(k)))
        vq, vs = (np.asarray(a) for a in jkq.quantize_heads(jnp.asarray(v)))
        out.update(k=kq, v=vq, k_scale=np.ascontiguousarray(ks.transpose(0, 1, 3, 2)),
                   v_scale=np.ascontiguousarray(vs.transpose(0, 1, 3, 2)))
    return out


def test_draft_steps_matches_ray_tpu(params):
    jp, tp = params
    B, S, H, k = 3, 40, 24, 3
    rng = np.random.default_rng(2)
    cache = _slot_cache(rng, JCFG, B, S, [0, 0, 0])
    hist = rng.integers(1, 500, size=(B, H)).astype(np.int32)
    hist_len = np.array([5, 12, 1], np.int32)
    lengths = np.array([4, 11, 0], np.int32)
    ref_props, ref_cache = jdr.draft_steps(jp, {n: jnp.asarray(a) for n, a in cache.items()}, jnp.asarray(hist),
                                           jnp.asarray(hist_len), jnp.asarray(lengths), JCFG, k)
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    props, tcache = tdr.draft_steps(tp, tcache, _t(hist), _t(hist_len), torch.from_numpy(lengths), TCFG, k)
    np.testing.assert_array_equal(props.numpy(), np.asarray(ref_props))
    np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(ref_cache["length"]))
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(ref_cache["k"]), rtol=1e-5, atol=1e-5)
    # the model drafter around it: prefill into its own cache, then propose
    jd = jdr.ModelDrafter(JCFG, params=jp, k=k)
    td = tdr.ModelDrafter(TCFG, params=tp, k=k)
    for d in (jd, td):
        d.init_slots(B, 32, (16, 32))
    for slot in range(B):
        toks = [int(t) for t in hist[slot, : max(int(hist_len[slot]) - 1, 1)]]
        jd.admit(slot, toks)
        td.admit(slot, toks)
    assert td.cache["k"].shape[2] == 32 + k + 1
    want = np.asarray(jd.propose(jnp.asarray(hist), jnp.asarray(hist_len), jnp.asarray(hist_len - 1)))
    got = td.propose(_t(hist), _t(hist_len), torch.from_numpy(hist_len - 1)).numpy()
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------------- verify
def _verify_lanes(seed, B, k, H):
    rng = np.random.default_rng(seed)
    props = rng.integers(1, 500, size=(B, k)).astype(np.int32)
    tokens = rng.integers(1, 500, size=(B,)).astype(np.int32)
    keys = rng.integers(0, 2**32, size=(B, 2), dtype=np.uint64).astype(np.uint32)
    temps = np.array([0.0, 0.8, 0.0, 1.1][:B], np.float32)
    top_k = np.array([0, 4, 0, 0][:B], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.85][:B], np.float32)
    spec_k = np.array([k, k, 1, 2][:B], np.int32)
    hist = rng.integers(1, 500, size=(B, H)).astype(np.int32)
    hist_len = np.array([9, 20, H - 2, 3][:B], np.int32)
    return props, tokens, keys, temps, top_k, top_p, spec_k, hist, hist_len


def _torch_lanes(lanes, H):
    props, tokens, keys, temps, top_k, top_p, spec_k, hist, hist_len = lanes
    th = tver.spec_hist_buffer(len(tokens), H, "cpu")
    th.copy_(_t(hist))
    return (_t(props), _t(tokens), _t(keys), torch.from_numpy(temps), _t(top_k), torch.from_numpy(top_p),
            _t(spec_k), th, _t(hist_len))


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_spec_verify_slots_matches_ray_tpu(params, dtype):
    """The slot verify: logits within 1e-5 relative, the block written into
    the rows (drops past S = 32 included: the third lane's block straddles
    the row's end), the rollback, accept/sample and the history."""
    jp, tp = params
    B, S, k, H = 4, 32, 4, 30
    rng = np.random.default_rng(3)
    cache = _slot_cache(rng, JCFG, B, S, [7, 18, S - 2, 0], dtype)
    lanes = _verify_lanes(4, B, k, H)
    jcache = {n: jnp.asarray(a) for n, a in cache.items()}
    toks_blk = np.concatenate([lanes[1][:, None], lanes[0]], axis=1)
    ref_logits = np.asarray(jver._forward_block_slots(jp, jcache, jnp.asarray(toks_blk), JCFG)[0])
    got_logits = tver._forward_block_slots(tp, {n: torch.from_numpy(a.copy()) for n, a in cache.items()},
                                           _t(toks_blk), TCFG).numpy()
    assert _rel(got_logits, ref_logits) <= 1e-5
    ref = jver.spec_verify_slots(jp, jcache, *(jnp.asarray(a) for a in lanes), JCFG)
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tl = _torch_lanes(lanes, H)
    emit, logps, acc, final, new_keys, hist_len = tver.spec_verify_slots(tp, tcache, *tl, TCFG)
    r_cache, r_emit, r_logps, r_acc, r_final, r_keys = ref[:6]
    np.testing.assert_array_equal(acc.numpy(), np.asarray(r_acc))
    np.testing.assert_array_equal(final.numpy(), np.asarray(r_final))
    np.testing.assert_array_equal(new_keys.numpy(), np.asarray(r_keys).astype(np.int64))
    cols = np.arange(k + 1)[None, :] <= acc.numpy()[:, None]
    np.testing.assert_array_equal(np.where(cols, emit.numpy(), 0), np.where(cols, np.asarray(r_emit), 0))
    np.testing.assert_allclose(np.where(cols, logps.numpy(), 0), np.where(cols, np.asarray(r_logps), 0), atol=1e-5)
    np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(r_cache["length"]))
    np.testing.assert_array_equal(tl[7].numpy(), np.asarray(ref[10]))
    np.testing.assert_array_equal(hist_len.numpy(), np.asarray(ref[11]))
    for name in r_cache:
        if name == "length":
            continue
        got, want = tcache[name].numpy(), np.asarray(r_cache[name])
        if dtype == "int8" and name in ("k", "v"):
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1, name  # a rounding tie at most
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)


def _pool(rng, cfg, P, page, dtype):
    shape = (cfg.num_layers, P, page, cfg.num_kv_heads, cfg.hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if dtype == "int8":
        kq, ks = (np.asarray(a) for a in jkq.quantize_heads(jnp.asarray(k)))
        vq, vs = (np.asarray(a) for a in jkq.quantize_heads(jnp.asarray(v)))
        return {"k": kq, "v": vq, "k_scale": np.ascontiguousarray(ks.transpose(0, 1, 3, 2)),
                "v_scale": np.ascontiguousarray(vs.transpose(0, 1, 3, 2))}
    return {"k": k, "v": v}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_spec_verify_paged_matches_ray_tpu(params, dtype):
    """The paged verify (prefix pages through K4's plain version): f32
    logits within 1e-5 relative of ray_tpu's slot forward over the same
    prefix, then every output against ray_tpu's spec_verify_paged, int8
    pool included; the last lane's block runs past its table (writes to the
    trash page)."""
    jp, tp = params
    B, k, H, page, max_pg = 4, 4, 40, 8, 4
    rng = np.random.default_rng(5)
    P = B * max_pg + 1
    pool = _pool(rng, JCFG, P, page, dtype)
    tables = rng.permutation(np.arange(1, P)).reshape(B, max_pg).astype(np.int32)
    lengths = np.array([5, 17, 0, max_pg * page - 2], np.int32)
    lanes = _verify_lanes(6, B, k, H)
    jpool = {n: jnp.asarray(a) for n, a in pool.items()}
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    toks_blk = np.concatenate([lanes[1][:, None], lanes[0]], axis=1)
    got_logits, k_blk, v_blk = tver._forward_block_paged(tp, tpool, torch.from_numpy(tables),
                                                         torch.from_numpy(lengths), _t(toks_blk), TCFG)
    if dtype == "float32":
        # the same prefix as slot rows (each lane's pages gathered): ray_tpu's
        # slot forward gives the logits (an int8 slot forward attends to the
        # block's quantized K/V, the paged one folds it in f32: not compared)
        rows = {n: a[:, tables].reshape(a.shape[0], B, max_pg * page, *a.shape[3:]) for n, a in pool.items()}
        slot_cache = {n: jnp.asarray(a) for n, a in {**rows, "length": lengths}.items()}
        ref_logits = np.asarray(jver._forward_block_slots(jp, slot_cache, jnp.asarray(toks_blk), JCFG)[0])
        # the last lane's block straddles its table's end: the slot forward
        # drops what the paged one folds from registers, so its last rows differ
        assert _rel(got_logits.numpy()[:3], ref_logits[:3]) <= 1e-5
        assert _rel(got_logits.numpy()[3, :2], ref_logits[3, :2]) <= 1e-5
    ref = jver.spec_verify_paged(jp, jpool, jnp.asarray(tables), jnp.asarray(lengths), *(jnp.asarray(a) for a in lanes),
                                 cfg=JCFG)
    tl = _torch_lanes(lanes, H)
    got = tver.spec_verify_paged(tp, tpool, torch.from_numpy(tables), torch.from_numpy(lengths), *tl, TCFG)
    emit, logps, acc, final, new_keys, kb, vb, wp, wo, new_lengths, hist_len = got
    (r_emit, r_logps, r_acc, r_final, r_keys, r_kb, r_vb, r_wp, r_wo, r_lengths, _, _, _, _, r_hist,
     r_hist_len) = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(acc.numpy(), r_acc)
    np.testing.assert_array_equal(final.numpy(), r_final)
    np.testing.assert_array_equal(new_keys.numpy(), r_keys.astype(np.int64))
    cols = np.arange(k + 1)[None, :] <= acc.numpy()[:, None]
    np.testing.assert_array_equal(np.where(cols, emit.numpy(), 0), np.where(cols, r_emit, 0))
    np.testing.assert_allclose(np.where(cols, logps.numpy(), 0), np.where(cols, r_logps, 0), atol=1e-5)
    np.testing.assert_allclose(kb.numpy(), r_kb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vb.numpy(), r_vb, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(wp.numpy(), r_wp)
    np.testing.assert_array_equal(wo.numpy(), r_wo)
    np.testing.assert_array_equal(new_lengths.numpy(), r_lengths)
    np.testing.assert_array_equal(tl[7].numpy(), r_hist)
    np.testing.assert_array_equal(hist_len.numpy(), r_hist_len)
    assert (r_wp[3] == 0).any()  # the trash page took the last lane's overflow
    attn_fn, append_fn = tver.make_spec_verify_paged(TCFG, "torch")
    assert append_fn is tver.spec_append_paged
    with pytest.raises(ValueError, match="attn_impl"):
        tver.make_spec_verify_paged(TCFG, "cuda")[0](tp, tpool, torch.from_numpy(tables), torch.from_numpy(lengths),
                                                     *_torch_lanes(lanes, H))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_spec_append_paged_matches_ray_tpu(dtype):
    """The block's K/V into the pool at (wp, wo), trash-page duplicates
    avoided (ray_tpu's scatter order on duplicates is unspecified): bytes
    equal, int8 quantized on the write."""
    L, B, T, kv, hd, P, page = 2, 3, 5, 2, 16, 12, 4
    rng = np.random.default_rng(7)
    k_blk = rng.standard_normal((L, B, T, kv, hd)).astype(np.float32)
    v_blk = rng.standard_normal((L, B, T, kv, hd)).astype(np.float32)
    pages = rng.permutation(np.arange(1, P))[: B * 3].reshape(B, 3)
    pos = np.array([1, 3, 6])[:, None] + np.arange(T)[None, :]  # each lane across two or three pages
    wp = pages[np.arange(B)[:, None], pos // page].astype(np.int32)
    wo = (pos % page).astype(np.int32)
    if dtype == "int8":
        jpool = {"k": jnp.zeros((L, P, page, kv, hd), jnp.int8), "v": jnp.zeros((L, P, page, kv, hd), jnp.int8),
                 "k_scale": jnp.zeros((L, P, kv, page), jnp.float32),
                 "v_scale": jnp.zeros((L, P, kv, page), jnp.float32)}
    else:
        jpool = {"k": jnp.zeros((L, P, page, kv, hd), jnp.bfloat16), "v": jnp.zeros((L, P, page, kv, hd), jnp.bfloat16)}
    tpool = {n: params_from_jax(np.asarray(a), "cpu") for n, a in jpool.items()}
    ref = jver.spec_append_paged(jpool, jnp.asarray(wp), jnp.asarray(wo), jnp.asarray(k_blk), jnp.asarray(v_blk))
    got = tver.spec_append_paged(tpool, torch.from_numpy(wp), torch.from_numpy(wo), torch.from_numpy(k_blk),
                                 torch.from_numpy(v_blk))
    for name, a in ref.items():
        want = np.asarray(a)
        have = got[name].float().numpy() if dtype == "bfloat16" else got[name].numpy()
        np.testing.assert_array_equal(have, want.astype(np.float32) if dtype == "bfloat16" else want, err_msg=name)


# --------------------------------------------------------------- SpecConfig
BAD_CONFIGS = [dict(drafter="nope"), dict(k=0), dict(k=2, k_min=0), dict(k=2, k_min=3), dict(ngram=0),
               dict(ema_alpha=0.0), dict(ema_alpha=1.5)]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=[",".join(f"{k}={v}" for k, v in kw.items()) for kw in BAD_CONFIGS])
def test_spec_config_validation_messages(kw):
    with pytest.raises(ValueError) as want:
        jctl.SpecConfig(**kw)
    with pytest.raises(ValueError) as got:
        tctl.SpecConfig(**kw)
    assert str(got.value) == str(want.value)


def test_spec_config_and_controller_match_ray_tpu():
    assert [f.name for f in dataclasses.fields(tctl.SpecConfig)] == [f.name for f in dataclasses.fields(jctl.SpecConfig)]
    assert dataclasses.asdict(tctl.SpecConfig()) == dataclasses.asdict(jctl.SpecConfig())
    cfg_kw = dict(k=4, k_min=1, ema_alpha=0.6)
    jc, tc = jctl.AdaptiveKController(jctl.SpecConfig(**cfg_kw)), tctl.AdaptiveKController(tctl.SpecConfig(**cfg_kw))
    rng = np.random.default_rng(8)
    for i in range(40):
        rid = f"r{i % 3}"
        if i % 11 == 10:
            jc.forget(rid)
            tc.forget(rid)
            continue
        assert jc.admit(rid) == tc.admit(rid)
        prop = int(rng.integers(0, 5))
        acc = int(rng.integers(0, prop + 1))
        assert jc.observe(rid, prop, acc) == tc.observe(rid, prop, acc)
        assert jc.export(rid) == tc.export(rid)
    jc.restore("m", 0.5, 9)
    tc.restore("m", 0.5, 9)
    assert jc.current() == tc.current()

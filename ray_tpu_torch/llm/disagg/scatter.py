"""KV handoff programs (port of ray_tpu/llm/disagg/scatter.py): extract
on the prefill side, scatter-in on the decode side, one pair per KV
layout, as plain functions on tensors.

- extract: read a request's block OUT of an engine's slot cache or page
  pool into contiguous copies ``[L, T_pad, kv, hd]`` (slots: a row slice;
  paged: a page gather), plus its wire-layout scales ``[L, kv, T_pad]``
  from an int8 cache. They only read.
- scatter-in: write a received block INTO the decode engine's cache or
  pool, in place. On the paged layout one call writes the pages, the
  slot's device table row and its device length lane, so the tensors a
  captured decode graph reads (``cuda/graph.py``) keep their addresses;
  they return the tensors they were given, nothing new.

T_pad is the producer's prefill bucket. Positions n..T_pad are garbage
that the consumer masks by length and overwrites with appends, the
contract of prefill's own padded tail. Producer and consumer cache dtypes
may differ: the inserts requantize in all four directions. ray_tpu
registers these programs with its jaxcheck audit of compiled programs,
which has no meaning for eager torch; they are not registered here.
"""

from __future__ import annotations

from ray_tpu_torch.llm import kv_cache as kvc
from ray_tpu_torch.llm import model_runner as mr
from ray_tpu_torch.llm import paged_kv as pkv


def kv_extract_slots(cache: dict, slot: int, T: int):
    """One slot's first T positions as contiguous copies: (k [L, T, kv,
    hd], v same), plus (k_scale [L, kv, T], v_scale same) for an int8
    cache. Garbage past the real length is masked downstream."""
    return kvc.extract_sequence(cache, slot, T)


def kv_extract_paged(pool: dict, page_ids):
    """A sequence's pages gathered into a contiguous block. page_ids
    [n_pg] (T_pad / page_size entries; padding cells point at the trash
    page). Returns (k [L, n_pg * page, kv, hd], v same) and, for an int8
    pool, the wire-layout scales."""
    return pkv.gather_pages(pool, page_ids)


def kv_scatter_in_slots(cache: dict, slot: int, k_blk, v_blk, n: int, k_scale=None, v_scale=None) -> dict:
    """Write a handoff block into ``slot`` at offset 0 and set its length,
    in place. k_blk/v_blk: [L, T_pad, kv, hd]; k_scale/v_scale: [L, kv,
    T_pad] when the block is int8."""
    return kvc.insert_sequence(cache, slot, k_blk, v_blk, n, k_scale, v_scale)


def kv_scatter_in_paged(pool: dict, tables, lengths, slot: int, table_row, k_blk, v_blk, n: int, k_scale=None,
                        v_scale=None):
    """Write a handoff block into its allocated pages AND the slot's
    device lanes, in place, in one call: the pool pages get the block,
    ``tables[slot]`` the row, ``lengths[slot]`` the real token count.

    table_row: [max_pg] int32 on the pool's device (the allocated pages
    first, 0 = trash beyond); k_blk/v_blk: [L, T_pad, kv, hd] with T_pad a
    page multiple; k_scale/v_scale: [L, kv, T_pad] when the block is int8.
    Stream-ordered after a decode step in flight, which reads none of
    these pages (they were free when it was dispatched). Returns
    (pool, tables, lengths), the tensors it was given."""
    npg = k_blk.shape[1] // pool["k"].shape[2]
    pkv.insert_pages(pool, table_row[:npg], k_blk, v_blk, k_scale, v_scale)
    mr.set_table(tables, lengths, slot, table_row, n)
    return pool, tables, lengths


def make_handoff_fns():
    """(extract_slots, extract_paged, scatter_slots, scatter_paged) for an
    engine: the functions above (ray_tpu jits them, the scatters with
    their buffers donated; here every write is in place)."""
    return kv_extract_slots, kv_extract_paged, kv_scatter_in_slots, kv_scatter_in_paged

"""Device collectives (port of ray_tpu/collective/ici.py).

Two halves, as in ray_tpu:

- Eager helpers over per-device tensors that ONE process holds (one
  tensor per device, e.g. a parameter server pushing to device replicas):
  ``allreduce``, ``allgather``, ``reducescatter`` and ``broadcast``. ray_tpu
  compiles each as one XLA program over a 1-D mesh of the local devices;
  here the reduction runs on the first tensor's device and the results
  are copied to each input's device, so every result sits where ray_tpu
  puts it (each input's device), in the input's dtype.
- The in-group collectives of the tensor-parallel step, which run inside
  each rank process of a tensor-parallel engine (``parallel/ranks.py``,
  one process per rank; ray_tpu runs them inside a ``shard_map`` body):
  ``psum`` (the exact sum), ``quantized_psum`` (EQuARX's int8 all-reduce,
  arxiv 2506.17615) and ``all_gather``. ``group`` is a
  ``parallel.ranks.RankGroup``, which runs the transport and counts the
  bytes each op puts on the wire (``WireCounter``) with ray_tpu's factors
  (``_wire_factor``); ``wire_report`` is the twin of ray_tpu's
  ``collective_wire_report`` over what ran instead of over a traced
  program.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.collective.types import ReduceOp

_REDUCERS = {
    ReduceOp.SUM: lambda x: x.sum(dim=0),
    ReduceOp.PRODUCT: lambda x: x.prod(dim=0),
    ReduceOp.MIN: lambda x: x.amin(dim=0),
    ReduceOp.MAX: lambda x: x.amax(dim=0),
}


def _stack(per_device) -> torch.Tensor:
    """Per-device tensors -> one [W, ...] tensor on the first one's device."""
    dev = per_device[0].device
    return torch.stack([t.to(dev) for t in per_device])


def allreduce(per_device, op: ReduceOp = ReduceOp.SUM) -> list:
    """per_device: same-shape tensors, one per device. Returns the
    reduction materialised on each input's device."""
    out = _REDUCERS[ReduceOp(op)](_stack(per_device))
    return [out.to(t.device, copy=True) for t in per_device]


def allgather(per_device) -> list:
    """Returns on each input's device the stacked [W, ...] of all inputs."""
    out = _stack(per_device)
    return [out.to(t.device, copy=True) for t in per_device]


def reducescatter(per_device, op: ReduceOp = ReduceOp.SUM) -> list:
    """Reduce, then scatter row blocks back: input i's device gets rows
    i*k:(i+1)*k of the reduction (the leading dim must divide by W)."""
    n = len(per_device)
    out = _REDUCERS[ReduceOp(op)](_stack(per_device))
    if out.shape[0] % n:
        raise ValueError(f"leading dim {out.shape[0]} does not divide by world size {n}")
    k = out.shape[0] // n
    return [out[i * k:(i + 1) * k].to(t.device, copy=True) for i, t in enumerate(per_device)]


def broadcast(array: torch.Tensor, n_devices: int, devices=None) -> list:
    """One tensor -> a copy on each of ``n_devices`` devices: ``devices``
    if given, else the first n cards for a tensor on a card (ray_tpu's
    "first n local devices"), or the host n times for a host tensor."""
    if devices is None:
        if array.is_cuda:
            devices = [torch.device("cuda", i) for i in range(n_devices)]
        else:
            devices = [array.device] * n_devices
    if len(devices) != n_devices:
        raise ValueError(f"{n_devices} devices asked for, {len(devices)} given")
    return [array.to(d, copy=True) for d in devices]


# ---------------------------------------------------------------------------
# in-group collectives of the tensor-parallel step
# ---------------------------------------------------------------------------
def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The exact sum of every rank's ``x`` (in place), at ``x``'s dtype."""
    return group.all_reduce(x)


def all_gather(x: torch.Tensor, group, axis: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order
    (``lax.all_gather(..., tiled=True)``)."""
    out = group.all_gather(x)  # [n, *x.shape]
    return torch.cat(list(out.unbind(0)), dim=axis)


def quantized_psum(x: torch.Tensor, group) -> torch.Tensor:
    """EQuARX-style int8 all-reduce: the sum decomposed into its
    reduce-scatter and all-gather halves, the bulk payload int8 on the
    wire in both.

    x: [..., H] local partial sum with H % size == 0. Each rank splits it
    into ``size`` chunks along the last axis and quantizes each chunk row
    to int8 with one f32 amax scale (``kv_quant.quantize_heads``). An
    all-to-all routes chunk j's int8 partials and scales to rank j, which
    dequantizes and accumulates its owned chunk exactly in f32, requantizes
    the reduced chunk once, and an int8 all-gather brings every chunk
    back. Wire bytes per rank ~ 2(n-1)/n (|x| bytes at 1 byte + scales)
    against the fp sum's 2(n-1)/n |x| * itemsize."""
    from ray_tpu_torch.llm.kv_quant import quantize_heads

    n = group.size
    H = x.shape[-1]
    if H % n:
        raise ValueError(f"quantized_psum needs trailing dim {H} divisible by the group size {n}")
    chunks = x.reshape(*x.shape[:-1], n, H // n)
    q, s = quantize_heads(chunks)  # int8 [..., n, C], f32 [..., n]
    # the reduce-scatter half: chunk j (int8 + scale) to rank j, stacked by source rank
    qx = group.all_to_all(q.movedim(-2, 0).contiguous())  # [n, ..., C]
    sx = group.all_to_all(s.movedim(-1, 0).contiguous())  # [n, ...]
    owned = (qx.float() * sx[..., None]).sum(dim=0)  # exact f32 accumulate
    # one requant of the reduced chunk, then the int8 all-gather half
    q2, s2 = quantize_heads(owned)
    qf = group.all_gather(q2)  # [n, ..., C]
    sf = group.all_gather(s2)  # [n, ...]
    out = (qf.float() * sf[..., None]).movedim(0, -2).reshape(x.shape)
    return out.to(x.dtype)


# Per-rank ring wire bytes as a multiple of an op's operand bytes, ray_tpu's
# factors: an all-reduce moves 2(n-1)/n of its (full-size) operand, an
# all-to-all or reduce-scatter (n-1)/n; an all-gather's operand is the
# pre-gather local block, of which a ring ships n-1 copies.
_WIRE_PRIMS = {"psum": 2.0, "all_to_all": 1.0, "psum_scatter": 1.0, "reduce_scatter": 1.0}


def _wire_factor(prim: str, axis_size: int) -> float:
    if prim == "all_gather":
        return float(axis_size - 1)
    return _WIRE_PRIMS[prim] * (axis_size - 1) / max(axis_size, 1)


_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.int8: "int8", torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8"}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype (the key ray_tpu's report uses)."""
    return _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


class WireCounter:
    """The bytes a group's ops put on the wire, by (op, dtype, operand
    shape), counted where each op runs. ``mark()`` / ``since(mark)`` give
    one step's bytes."""

    def __init__(self, size: int):
        self.size = size
        self.total = 0.0
        self._ops: dict = {}  # (prim, dtype, shape) -> [count, bytes]

    def add(self, prim: str, t: torch.Tensor) -> None:
        wire = t.numel() * t.element_size() * _wire_factor(prim, self.size)
        key = (prim, dtype_name(t.dtype), tuple(t.shape))
        ent = self._ops.setdefault(key, [0, 0.0])
        ent[0] += 1
        ent[1] += wire
        self.total += wire

    def mark(self) -> dict:
        return {k: tuple(v) for k, v in self._ops.items()}

    def since(self, mark: dict | None = None) -> dict:
        """``wire_report`` of what ran since ``mark`` (everything: None)."""
        mark = mark or {}
        ops = []
        for (prim, dt, shape), (count, wire) in self._ops.items():
            c0, w0 = mark.get((prim, dt, shape), (0, 0.0))
            if count > c0:
                ops.append({"prim": prim, "dtype": dt, "shape": list(shape), "count": count - c0,
                            "wire_bytes": int(wire - w0)})
        return wire_report(ops)


def wire_report(ops: list) -> dict:
    """ray_tpu's ``collective_wire_report`` layout over counted ops:
    {"bytes_by_dtype": {dtype: bytes}, "total_bytes": n, "ops": [...]}."""
    by_dtype: dict = {}
    for op in ops:
        by_dtype[op["dtype"]] = by_dtype.get(op["dtype"], 0) + op["wire_bytes"]
    return {
        "bytes_by_dtype": {k: int(v) for k, v in sorted(by_dtype.items())},
        "total_bytes": int(sum(by_dtype.values())),
        "ops": ops,
    }

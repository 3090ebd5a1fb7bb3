"""Native (C++) hashing for joins and group-bys, with a numpy fallback
(port of ray_tpu/_native/__init__.py).

hashing.cpp (the port's own copy) is compiled once with g++ -O3 at first
use into ``build/native/`` beside the package (``.gitignore`` lists
``build/``), keyed by the source's hash, and bound with ctypes. Without a
compiler the numpy fallbacks give identical values.

The port's blocks are numpy columns, where ray_tpu's are Arrow arrays, so
the column kinds map onto ray_tpu's hashing rules explicitly:

- a float column hashes its float64 bit pattern (``-0.0`` as ``+0.0``,
  one NaN), an int column its int64 pattern, through splitmix64;
- a column whose values are all ``str`` (or all ``bytes``), ``None``
  allowed, hashes FNV-1a over each value's utf-8 bytes (its bytes), and a
  ``None`` as ``_NULL_SENTINEL``'s bytes: ray_tpu's Arrow string and
  binary path;
- numbers with a ``None`` among them hash as float64 with NaN for the
  ``None``, as an Arrow int column with nulls reaches ray_tpu's float path;
- anything else hashes FNV-1a over ``str(value)``: ray_tpu's generic path.

    from ray_tpu_torch._native import hash_column, partition_indices
"""

from __future__ import annotations

import ctypes
import hashlib
import numbers
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "hashing.cpp"
BUILD_DIR = _HERE.parent.parent / "build" / "native"
_lock = threading.Lock()
_lib = None
_lib_tried = False

MAX_PARTITIONS = 4096  # partition_gather's stack cursor bound


def _build() -> "ctypes.CDLL | None":
    try:
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"hashing_{digest}.so"
        if not so.exists():
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.hash_u64.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.hash_bytes_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.hash_combine.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.partition_assign.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
                                         ctypes.c_void_p]
        lib.partition_gather.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
                                         ctypes.c_void_p]
        return lib
    except Exception:
        return None


def get_lib():
    global _lib, _lib_tried
    if not _lib_tried:
        with _lock:
            if not _lib_tried:
                _lib = _build()
                _lib_tried = True
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


_NULL_SENTINEL = "\x00__rt_null__\x00"
_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211
_U64 = (1 << 64) - 1


def _fnv1a_py(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _U64
    return h


def _hash_bytes_rows(rows: list) -> np.ndarray:
    """FNV-1a of each bytes row (the native kernel over one offsets array
    and one data buffer, or the same loop in Python)."""
    lib = get_lib()
    if lib is None:
        return np.asarray([_fnv1a_py(r) for r in rows], np.uint64)
    lens = np.fromiter((len(r) for r in rows), np.int64, count=len(rows))
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    if offsets[-1] >= 2**31:
        raise ValueError(f"a key column of {int(offsets[-1])} bytes exceeds the kernel's int32 offsets")
    data = np.frombuffer(b"".join(rows), np.uint8) if offsets[-1] else np.zeros(1, np.uint8)
    out = np.empty(len(rows), np.uint64)
    lib.hash_bytes_rows(_ptr(offsets.astype(np.int32)), _ptr(data), len(rows), _ptr(out))
    return out


def _is_number(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, (bool, np.bool_))


def _key_array(col) -> np.ndarray:
    """A 1-D array of the keys: numeric dtypes as they are, everything else
    (str, bytes, None, mixed) as an object array of the values."""
    if isinstance(col, np.ndarray) and col.dtype.kind in "fiub":
        return col
    if isinstance(col, np.ndarray):
        vals = col.tolist()
    else:
        vals = list(col)
    non_null = [v for v in vals if v is not None]
    if non_null and len(non_null) == len(vals) and all(_is_number(v) for v in vals):
        kind = "i" if all(isinstance(v, numbers.Integral) for v in vals) else "f"
        return np.asarray(vals, np.int64 if kind == "i" else np.float64)
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    return out


def hash_column(col) -> np.ndarray:
    """uint64 hashes for one key column: a numpy array or a sequence.

    Every path, native or fallback, gives ray_tpu's values on the same
    keys (the rules in the module's docstring), so bucket assignment
    never diverges between blocks, processes or the two packages."""
    col = _key_array(col)
    if col.dtype == object:
        vals = col.tolist()
        non_null = [v for v in vals if v is not None]
        if non_null and all(isinstance(v, str) for v in non_null):
            return _hash_bytes_rows([(_NULL_SENTINEL if v is None else v).encode() for v in vals])
        if non_null and all(isinstance(v, (bytes, bytearray)) for v in non_null):
            return _hash_bytes_rows([_NULL_SENTINEL.encode() if v is None else bytes(v) for v in vals])
        if non_null and all(_is_number(v) for v in non_null):
            col = np.asarray([np.nan if v is None else v for v in vals], np.float64)
        else:
            # generic objects: FNV-1a over the str form, deterministic across
            # processes (unlike builtin hash(), which is salted per process)
            return np.asarray([_fnv1a_py(str(v).encode()) for v in vals], np.uint64)
    if col.dtype.kind == "f":
        # the float BIT PATTERN (hashing.cpp's contract): -0.0 as +0.0 (they
        # compare equal), every NaN payload as one NaN
        f = np.ascontiguousarray(col).astype(np.float64, copy=False) + 0.0
        f = np.where(np.isnan(f), np.float64("nan"), f)
        keys = f.view(np.uint64)
    elif col.dtype.kind in "iu":
        keys = np.ascontiguousarray(col).astype(np.int64, copy=False).view(np.uint64)
    else:
        # bools: ray_tpu's generic path
        return np.asarray([_fnv1a_py(str(v).encode()) for v in col.tolist()], np.uint64)
    lib = get_lib()
    if lib is not None:
        out = np.empty(len(keys), np.uint64)
        lib.hash_u64(_ptr(np.ascontiguousarray(keys)), len(keys), _ptr(out))
        return out
    # numpy splitmix64
    x = keys + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def combine_hashes(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = get_lib()
    a = np.ascontiguousarray(a, np.uint64)
    if lib is not None:
        out = a.copy()
        lib.hash_combine(_ptr(out), _ptr(np.ascontiguousarray(b, np.uint64)), len(out))
        return out
    x = a ^ (b + np.uint64(0x9E3779B97F4A7C15) + (a << np.uint64(6)) + (a >> np.uint64(2)))
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def partition_indices(hashes: np.ndarray, nparts: int):
    """-> (indices int64[n] grouped by partition, counts int64[nparts]).

    indices[:counts[0]] are partition 0's rows (stable order), etc."""
    if nparts > MAX_PARTITIONS:
        raise ValueError(f"nparts {nparts} exceeds {MAX_PARTITIONS}")
    hashes = np.ascontiguousarray(hashes, np.uint64)
    n = len(hashes)
    lib = get_lib()
    if lib is not None:
        part_of = np.empty(n, np.int32)
        counts = np.empty(nparts, np.int64)
        lib.partition_assign(_ptr(hashes), n, nparts, _ptr(part_of), _ptr(counts))
        out = np.empty(n, np.int64)
        lib.partition_gather(_ptr(part_of), n, nparts, _ptr(counts), _ptr(out))
        return out, counts
    part_of = (hashes % np.uint64(nparts)).astype(np.int64)
    counts = np.bincount(part_of, minlength=nparts).astype(np.int64)
    return np.argsort(part_of, kind="stable").astype(np.int64), counts

"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on
its own by ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at
the repository root. The hash covers the source, every shared header
``csrc/*.cuh`` it may include and ``NVCC_FLAGS``, so an edited kernel,
header or flag is never served from a stale library. The library is loaded with
``ctypes``; the wrappers set ``argtypes`` with ``c_void_p`` for every
pointer and for the stream.

Nothing is built when a module is imported: ``library(name)`` builds at
first use, and ``build_all()`` starts one ``nvcc`` per source, all at
once, so a fresh checkout pays the slowest single build, not the sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
SOURCES = ("flash_attention", "flash_attention_bwd", "paged_attn", "rms_norm")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # name -> nvcc's stderr (ptxas register/smem report)


def _cuda_tool(tool: str) -> str:
    for cand in (shutil.which(tool), f"/usr/local/cuda/bin/{tool}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{tool} not found on PATH or under /usr/local/cuda/bin")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library in parallel; returns wall seconds.
    Raises RuntimeError with nvcc's output if any build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        build_log[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Per kernel (mangled name) in an ``nvcc -Xptxas -v`` log: its
    ``registers`` and its ``spill_stores`` / ``spill_loads`` in bytes."""
    out: dict[str, dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            fn = m.group(1)
            out[fn] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[fn]["spill_stores"], out[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m.group(1))
    return out


def count_sass(sass: str, opcode: str) -> dict[str, int]:
    """Per kernel in ``cuobjdump -sass`` output: how many instructions have
    the opcode ``opcode`` (any modifiers, predicated or not)."""
    out: dict[str, int] = {}
    fn = None
    pattern = re.compile(rf"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?{re.escape(opcode)}[.\s]")
    for line in sass.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            fn = m.group(1)
            out[fn] = 0
        elif fn and pattern.match(line):
            out[fn] += 1
    return out


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library ``name``."""
    return subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True, timeout=120).stdout


def check_launch(err: int, what: str) -> None:
    """Raise if a C launcher returned a non-zero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream, read without
    building a ``torch.cuda.Stream``: this runs on every launch."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device() if index is None else index)

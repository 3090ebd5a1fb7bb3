"""runtime_env: a task's or an actor's working directory and extra import
roots (port of ray_tpu/runtime_env/packaging.py).

``working_dir`` and each of ``py_modules`` are zipped with a content
hash, stored once in the head's object store, and unpacked and cached in
the worker, which adds each root to ``sys.path`` and ``chdir``s into the
working directory's copy. ``env_vars`` are applied by the worker itself
(``core/worker_main.py``). ``pip``, ``conda``, ``uv`` and ``container``
raise ValueError on every submit: the deployment has no package index.

The port sends code by reference (``core/serialization.py``): a class or
function whose module exists only in ``py_modules`` resolves in the
worker because the archive is applied before the task's code resolves.

The unpack root is the port's own, ``<tempdir>/ray_tpu_torch/runtime_env``
(beside ``util/tracing.session_dir()``), never ray_tpu's
``/tmp/ray_tpu/runtime_env``.

Flow:
- head: ``prepare_runtime_env()`` zips the directories (size-capped),
  stores each archive with ``put`` and rewrites the env to carry object
  ids (``_packed_working_dir``, ``_packed_py_modules``);
- worker: ``apply_runtime_env_in_worker()`` fetches the archives it has
  not unpacked yet, unpacks them under the root, puts the py_modules on
  ``sys.path`` and ``chdir``s into the working_dir copy.
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
import sys
import tempfile
import time
import zipfile

_MAX_ARCHIVE_BYTES = 512 * 1024 * 1024
_EXCLUDE_DIRS = {".git", "__pycache__", ".venv", "node_modules"}
GATED = ("pip", "conda", "uv", "container")
# seconds this process took to fetch and unpack each archive, by hash
unpack_s: dict[str, float] = {}


def cache_root() -> str:
    """Where archives are unpacked: ``<tempdir>/ray_tpu_torch/runtime_env``."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "runtime_env")


def _zip_dir(path: str) -> bytes:
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env path {path!r} is not a directory")
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
            for fn in sorted(files):
                full = os.path.join(root, fn)
                try:
                    total += os.path.getsize(full)
                except OSError:
                    continue
                if total > _MAX_ARCHIVE_BYTES:
                    raise ValueError(f"runtime_env dir {path!r} exceeds {_MAX_ARCHIVE_BYTES >> 20}MB")
                zf.write(full, os.path.relpath(full, path))
    return buf.getvalue()


def validate_runtime_env(runtime_env: dict | None):
    """Reject the env kinds this deployment cannot honour; called on every
    submit, before any cache."""
    for gated in GATED:
        if runtime_env and runtime_env.get(gated):
            raise ValueError(
                f"runtime_env[{gated!r}] is not supported in this deployment: the environment has no package "
                "index (zero egress). Bake dependencies into the image or ship code via working_dir/py_modules.")


def dir_fingerprint(path: str) -> str:
    """(relpath, size, mtime_ns) of every file, hashed: the head's cache
    sees an edit without zipping again."""
    path = os.path.abspath(path)
    h = hashlib.sha256()
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for fn in sorted(files):
            full = os.path.join(root, fn)
            try:
                st = os.stat(full)
            except OSError:
                continue
            h.update(f"{os.path.relpath(full, path)}:{st.st_size}:{st.st_mtime_ns};".encode())
    return h.hexdigest()[:16]


def prepare_runtime_env(runtime_env: dict | None, put) -> dict | None:
    """Pack the directories; ``put(bytes) -> ObjectRef`` stores an archive.
    Returns the rewritten env; each packed entry holds its ref under
    ``_ref`` for the caller to keep alive."""
    if not runtime_env:
        return runtime_env
    env = dict(runtime_env)
    validate_runtime_env(env)

    def pack(path: str) -> dict:
        data = _zip_dir(path)
        ref = put(data)
        return {"hash": hashlib.sha256(data).hexdigest()[:16], "ref_hex": ref.id.hex(), "_ref": ref,
                "bytes": len(data)}

    if env.get("working_dir"):
        env["_packed_working_dir"] = pack(env.pop("working_dir"))
    if env.get("py_modules"):
        env["_packed_py_modules"] = [pack(p) for p in env.pop("py_modules")]
    return env


def _materialize(packed: dict, fetch) -> str:
    """The archive's unpacked directory, unpacking it once per host."""
    dest = os.path.join(cache_root(), packed["hash"])
    if os.path.exists(os.path.join(dest, ".complete")):
        return dest
    t0 = time.perf_counter()
    data = fetch(packed["ref_hex"])
    tmp = dest + f".tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        zf.extractall(tmp)
    open(os.path.join(tmp, ".complete"), "w").close()
    try:
        os.rename(tmp, dest)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)  # another worker unpacked it first
    unpack_s[packed["hash"]] = time.perf_counter() - t0
    return dest


def apply_runtime_env_in_worker(runtime_env: dict | None, fetch):
    """``fetch(ref_hex) -> bytes`` reads an archive from the object store.
    Puts each py_modules root first on ``sys.path``, then ``chdir``s into
    the working_dir copy (also put on ``sys.path``, as ray_tpu does)."""
    if not runtime_env:
        return
    for packed in runtime_env.get("_packed_py_modules") or []:
        d = _materialize(packed, fetch)
        if d not in sys.path:
            sys.path.insert(0, d)
    packed = runtime_env.get("_packed_working_dir")
    if packed:
        d = _materialize(packed, fetch)
        os.chdir(d)
        if d not in sys.path:
            sys.path.insert(0, d)

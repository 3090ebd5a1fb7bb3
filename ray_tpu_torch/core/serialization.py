"""Serialization (port of ray_tpu/core/serialization.py): stdlib
``pickle`` protocol 5 with out-of-band buffers, tracking of the
ObjectRefs pickled inside a value, and functions and classes sent to
workers by reference.

A host ``torch.Tensor`` travels out of band: the pickler's
``reducer_override`` turns it into (dtype name, shape, one
``PickleBuffer`` over its bytes), so its bytes never enter the header and
land in shared memory with one ``writev`` (``object_store.write_to_shm``).
A bf16 tensor is viewed as int16 for the buffer (bf16 has no numpy
dtype). Decoding rebuilds it with ``torch.frombuffer`` over the buffer
(a view into the mapped segment on the borrow path); a read-only buffer
(inline ``bytes``) is copied first, so no tensor is ever writable over
memory that must not change. A tensor on the card is refused with
TypeError: move it with ``.cpu()`` first.

**Code travels by reference.** ray_tpu pickles functions and classes by
value with a third-party pickler, which the card's machine lacks. The port
sends a task's function or an actor's class as its module and qualified
name (``code_ref``); the worker imports the module and looks the name up
(``resolve_code``), unwrapping a ``@remote`` decorator. The driver's
``__main__`` is importable in a worker from its file (``core/node.py``
imports it there as ``__mp_main__``, as multiprocessing does), and a
``__main__`` script's code is named with its file (``__main__:<path>``):
so a function of a driver attached to another driver's head, or a class
a restarted head re-creates a detached actor of, resolves to the right
script, which a process that did not start from it imports under a name
of its own (its ``if __name__ == "__main__"`` block does not run). A lambda,
a function defined inside another, or a ``__main__`` with no file (a
heredoc, stdin or ``-c`` driver) has no name a worker can import:
``code_ref`` raises TypeError at ``.remote()`` and says so. Values passed
as arguments pickle as the standard library pickles them: a class of a
file-less ``__main__`` among them fails in the worker.
"""

from __future__ import annotations

import io
import os
import pickle
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Serialized:
    header: bytes
    buffers: list = field(default_factory=list)  # bytes / memoryview / bytearray
    # ObjectRefs found inside the object (the borrow protocol's pins)
    contained_refs: list = field(default_factory=list)

    def total_size(self) -> int:
        return len(self.header) + sum(memoryview(b).nbytes for b in self.buffers)


# exact types that cannot hold ObjectRefs or tensors: the C pickler takes
# them directly, with no sink and no reducer
_FAST_TYPES = frozenset({bytes, bytearray, str, int, float, bool, type(None)})


def _tensor_reduce(t: torch.Tensor):
    """(rebuild, args) of a host tensor whose bytes go out of band."""
    if t.device.type != "cpu":
        raise TypeError(f"a tensor on {t.device} cannot be put on the object plane: move it to the host with .cpu() "
                        "first")
    if t.is_sparse or t.is_quantized or t.is_complex():
        raise TypeError(f"the object plane carries dense real tensors, not {t.layout} {t.dtype}")
    t = t.detach().contiguous()
    flat = t.reshape(-1)
    if t.dtype == torch.bfloat16:
        flat = flat.view(torch.int16)
    arr = flat.numpy()
    return _rebuild_tensor, (str(t.dtype).removeprefix("torch."), tuple(t.shape), pickle.PickleBuffer(arr))


def _rebuild_tensor(dtype_name: str, shape: tuple, buf) -> torch.Tensor:
    dtype = getattr(torch, dtype_name)
    if int(np.prod(shape, dtype=np.int64)) == 0:
        return torch.empty(shape, dtype=dtype)
    mv = memoryview(buf)
    if mv.readonly:
        # an inline payload's bytes: torch.frombuffer would hand back a
        # writable tensor over immutable memory, so copy (< the inline
        # threshold) into a buffer the tensor may own
        mv = memoryview(bytearray(mv))
    return torch.frombuffer(mv, dtype=torch.uint8).view(dtype).reshape(shape)


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _tensor_reduce(obj)
        return NotImplemented


def _dumps(obj, buffer_callback) -> bytes:
    out = io.BytesIO()
    _Pickler(out, protocol=5, buffer_callback=buffer_callback).dump(obj)
    return out.getvalue()


def serialize(obj) -> Serialized:
    if type(obj) in _FAST_TYPES:
        return Serialized(header=pickle.dumps(obj, protocol=5))
    from ray_tpu_torch.core import object_ref as _oref

    buffers: list[pickle.PickleBuffer] = []
    contained: list = []
    _track_contained_refs(obj, contained)
    # pickle-time sink: ObjectRef.__reduce__ reports every ref actually
    # serialized (those nested where the pre-scan cannot see included)
    sink: list = []
    token = _oref.push_ref_sink(sink)
    try:
        header = _dumps(obj, buffer_callback=lambda b: buffers.append(b) or False)
    finally:
        _oref.pop_ref_sink(token)
    seen = {r.id.binary() for r in contained}
    for oid in sink:
        if oid.binary() not in seen:
            seen.add(oid.binary())
            contained.append(_oref.ObjectRef(oid))
    return Serialized(header=header, buffers=[b.raw() for b in buffers], contained_refs=contained)


def deserialize(header: bytes, buffers) -> object:
    return pickle.loads(header, buffers=buffers)


def deserialize_s(s: Serialized) -> object:
    return deserialize(s.header, s.buffers)


def dumps_inband(obj) -> bytes:
    """One pickle of ``obj`` with host tensors in band (a direct call's
    frame: one blob, no buffers)."""
    return _dumps(obj, buffer_callback=None)


# ---------------------------------------------------------------------------
# code by reference
# ---------------------------------------------------------------------------
_DIFFERENCE = ("ray_tpu_torch sends functions and classes to workers by reference (module and qualified name), "
               "where ray_tpu sends them by value (ROADMAP.md, Differences kept on purpose: code by reference)")


def _unwrap(obj):
    """The function or class inside a ``@remote`` wrapper, else ``obj``."""
    return getattr(obj, "_rt_target", obj)


def code_ref(obj) -> tuple[str, str]:
    """(module, qualified name) of a module-level function or class that a
    worker can import; TypeError naming why when there is none."""
    import sys

    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None)
    what = "class" if isinstance(obj, type) else "function"
    if module is None or qualname is None:
        raise TypeError(f"{obj!r} has no module and qualified name: {_DIFFERENCE}")
    if "<lambda>" in qualname:
        raise TypeError(f"the lambda {module}.{qualname} has no name a worker can import: define it with def at "
                        f"the top level of a module. {_DIFFERENCE}")
    if "<locals>" in qualname:
        raise TypeError(f"the {what} {module}.{qualname} is defined inside a function (a closure), so a worker "
                        f"cannot import it: move it to the top level of a module. {_DIFFERENCE}")
    if module == "__main__":
        main = sys.modules.get("__main__")
        spec_name = getattr(getattr(main, "__spec__", None), "name", None)
        path = getattr(main, "__file__", None)
        if not spec_name and not (path and os.path.isfile(path)):
            raise TypeError(f"the {what} {qualname} is defined in a __main__ with no file (a heredoc, stdin or -c "
                            f"driver), which a worker cannot import: put it in a file. {_DIFFERENCE}")
        if not spec_name:
            module = f"__main__:{os.path.abspath(path)}"
    try:
        found = resolve_code(module, qualname)
    except (ImportError, AttributeError):
        found = None
    if found is not obj:
        raise TypeError(f"{module}.{qualname} does not name this {what} in its module, so a worker cannot import "
                        f"it. {_DIFFERENCE}")
    return module, qualname


def _main_script(path: str):
    """The module of the script ``path``: this process's __main__ (or the
    driver's, imported as __mp_main__) when it ran from that file, else
    the file imported under a name of its own, once."""
    import hashlib
    import importlib.util
    import sys

    for name in ("__main__", "__mp_main__"):
        mod = sys.modules.get(name)
        f = getattr(mod, "__file__", None)
        if f and os.path.abspath(f) == path:
            return mod
    name = "__rt_main_" + hashlib.sha1(path.encode()).hexdigest()[:12]
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None:
            raise ImportError(f"cannot import the driver script {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            sys.modules.pop(name, None)
            raise
    return mod


def resolve_code(module: str, qualname: str):
    """Import ``module`` (``__main__:<path>``: that script) and look
    ``qualname`` up in it, unwrapping ``@remote`` wrappers at each step."""
    import importlib

    if module.startswith("__main__:"):
        obj = _main_script(module.split(":", 1)[1])
    else:
        obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = _unwrap(getattr(obj, part))
    return obj


def _track_contained_refs(obj, out: list, depth: int = 0):
    """The cheap shallow scan; the pickle-time sink catches the rest."""
    if depth > 3:
        return
    from ray_tpu_torch.core.object_ref import ObjectRef

    if isinstance(obj, ObjectRef):
        out.append(obj)
    elif isinstance(obj, (list, tuple, set)):
        for x in obj:
            _track_contained_refs(x, out, depth + 1)
    elif isinstance(obj, dict):
        for v in obj.values():
            _track_contained_refs(v, out, depth + 1)

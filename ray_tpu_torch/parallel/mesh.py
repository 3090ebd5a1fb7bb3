"""Device meshes and logical sharding rules (port of ray_tpu/parallel/mesh.py).

ray_tpu's mesh is a ``jax.sharding.Mesh``: one process, devices named on
axes, XLA inserting the collectives. The port follows PyTorch's idiom,
one process per rank, so a mesh here is a PLACEMENT of ranks: the same
axis names and sizes, and one ``torch.device`` per rank (rank r is the
r-th entry of the row-major device array). Several ranks may name the
same device: two ranks on one card is how one H100 serves tp=2, and
``create_mesh(tp=2, devices=["cpu", "cpu"])`` is how the CPU runs it.

  axis   | role
  -------|----------------------------------------------------------
  dp     | data parallel (batch split; gradients summed over dp)
  fsdp   | fully-sharded data parallel (params/opt-state sharded)
  tp     | tensor parallel (matmul column/row sharding)
  sp     | sequence/context parallel
  ep     | expert parallel
  pp     | pipeline stages

A spec is a tuple with one entry per array dimension: ``None``, an axis
name, or a tuple of axis names (ray_tpu's ``PartitionSpec`` entries).
``ShardingRules.spec`` lowers logical dimension names to it, and
``weights.shard_params`` slices a rank's part of a tree by it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "tp", "ep")


@dataclass
class MeshConfig:
    """Sizes per logical axis; -1 means 'absorb remaining devices'."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp, "sp": self.sp, "tp": self.tp, "ep": self.ep}
        fixed = math.prod(v for v in sizes.values() if v > 0)
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh axes product {fixed} != device count {n_devices}")
        return sizes


@dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks placed on devices: ``devices`` is an object array of
    ``torch.device`` of shape ``[size of each axis]``, ``axis_names`` its
    axes, in ``AXIS_ORDER``. Picklable, so it travels to a replica."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """Axis name -> size (jax's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_of(self, rank: int) -> torch.device:
        return self.devices.reshape(-1)[rank]

    def coords(self, rank: int) -> dict:
        """Rank -> its index on each axis (row-major over the device array)."""
        return dict(zip(self.axis_names, (int(i) for i in np.unravel_index(rank, self.devices.shape))))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def local_devices() -> list:
    """The visible cards, in order; with none this raises (no silent CPU:
    name CPU devices to run ranks on the host)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass devices=['cpu', ...] to place ranks on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(d: torch.device) -> torch.device:
    """A card named without an index is the first visible one: each rank
    process binds to its card by index."""
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def create_mesh(config: MeshConfig | dict | None = None, devices=None, **axis_sizes) -> Mesh:
    """Place ranks on ``devices`` (default: the visible cards).

    create_mesh(tp=2)                          -> 2 ranks over the first 2 cards
    create_mesh(tp=2, devices=["cuda:0"] * 2)  -> 2 ranks on one card
    create_mesh(tp=2, devices=["cpu", "cpu"])  -> 2 ranks on the host

    Axis order puts tp/ep innermost and pp outermost, as ray_tpu does."""
    if devices is None:
        devices = local_devices()
    devices = [_indexed(torch.device(d)) for d in devices]
    if config is None:
        config = MeshConfig(**{**{"dp": -1}, **axis_sizes}) if axis_sizes else MeshConfig()
    elif isinstance(config, dict):
        config = MeshConfig(**config)
    sizes = config.resolve(len(devices))
    axes = [a for a in AXIS_ORDER if sizes[a] > 1] or ["dp"]
    shape = [sizes[a] for a in axes]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), tuple(axes))


def mesh_axes(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def axis_or_none(mesh: Mesh, *names: str):
    """The subset of ``names`` present in the mesh (for specs that degrade
    gracefully when an axis is absent)."""
    present = [n for n in names if n in mesh.axis_names]
    if not present:
        return None
    return tuple(present) if len(present) > 1 else present[0]


def axis_size(mesh: Mesh, name: str) -> int:
    """Size of one named axis (1 when absent: the degenerate no-op)."""
    return mesh_axes(mesh).get(name, 1)


def is_tp_only(mesh: Mesh) -> bool:
    """True when the mesh is a pure tensor-parallel mesh, the one the
    serving path runs across rank processes."""
    return set(mesh.axis_names) == {"tp"}


# ----------------------------------------------------------------------
# logical sharding rules
# ----------------------------------------------------------------------
def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


@dataclass
class ShardingRules:
    """Map logical array-dimension names to mesh axes (flax-style
    partitioning rules, applied to trees of logical axis annotations)."""

    rules: dict[str, object] = field(
        default_factory=lambda: {
            "batch": ("dp", "fsdp"),  # batch dim split over dp (+fsdp data shards)
            "sequence": "sp",
            "embed": "fsdp",  # param sharding axis (ZeRO-3 over fsdp)
            "heads": "tp",
            "kv_heads": "tp",
            "mlp": "tp",
            "vocab": "tp",
            "expert": "ep",
            "stage": "pp",
            None: None,
        }
    )

    def spec(self, logical_axes: tuple, mesh: Mesh) -> tuple:
        """One entry per dimension: None, an axis name, or a tuple of names
        (an axis is used at most once per array)."""
        out = []
        used = set()
        for ax in logical_axes:
            m = self.rules.get(ax)
            if m is None:
                out.append(None)
                continue
            names = (m,) if isinstance(m, str) else tuple(m)
            names = tuple(n for n in names if n in mesh.axis_names and n not in used)
            used.update(names)
            if not names:
                out.append(None)
            elif len(names) == 1:
                out.append(names[0])
            else:
                out.append(names)
        return tuple(out)

    def tree_specs(self, logical_tree, mesh: Mesh):
        """Tree of logical-axis tuples -> tree of specs."""
        if _is_axes(logical_tree):
            return self.spec(logical_tree, mesh)
        return {k: self.tree_specs(v, mesh) for k, v in logical_tree.items()}


DEFAULT_RULES = ShardingRules()


def shard_batch_spec(mesh: Mesh) -> tuple:
    """Spec for input batches: batch over dp(+fsdp), sequence over sp."""
    return (axis_or_none(mesh, "dp", "fsdp"), axis_or_none(mesh, "sp"))


def replicated(mesh: Mesh) -> tuple:
    """The spec of an array every rank holds whole (ray_tpu's ``P()``)."""
    return ()


def shard_slices(shape, spec: tuple, mesh: Mesh, rank: int) -> tuple:
    """The index (one slice per dimension) of ``rank``'s block of an array
    of ``shape`` under ``spec``: a dimension on axes (a, b) splits into
    size_a * size_b blocks, the block index ``i_a * size_b + i_b``, as
    jax's NamedSharding lays it out."""
    coords = mesh.coords(rank)
    sizes = mesh_axes(mesh)
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            out.append(slice(None))
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        parts, idx = 1, 0
        for a in names:
            parts *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        if n % parts:
            raise ValueError(f"dimension {d} of size {n} does not divide into {parts} blocks over {names}")
        blk = n // parts
        out.append(slice(idx * blk, (idx + 1) * blk))
    return tuple(out)

"""Blocks: the unit of data movement (port of ray_tpu/data/block.py).

A Dataset is a list of ObjectRef[Block]; only refs flow through the
executor, block payloads stay in the (shared-memory) object store.

ray_tpu's ``Block`` is an Arrow table. The port's is a dict of
equal-length numpy columns, the ``"numpy"`` batch format ray_tpu's UDFs
see by default (ray_tpu's ``BlockAccessor.to_numpy``), so a block needs
no package beyond numpy and crosses processes as out-of-band buffers:

- a numeric or bool column is a 1-D array of its dtype;
- a tensor column is an array of ndim > 1 (row i is ``col[i]``);
- a string, bytes, ragged, nested, null-bearing or mixed column is an
  object array (a ragged list column's elements are 1-D arrays, as Arrow's
  ``to_numpy`` gives them).

Columns built from Python values follow Arrow's type inference (ints to
int64, ints and floats to float64, equal-length numeric lists to a tensor
column), so ``to_batch("numpy")`` equals ray_tpu's ``to_numpy()`` and
``iter_rows`` yields what ray_tpu's ``to_pylist()`` yields: Python
scalars, a tensor column's row as a nested list, ``None`` for a null. A
column holding ``None`` among numbers stays an object array here where
Arrow's ``to_numpy`` gives float64 with NaN.

``schema()`` returns a ``Schema`` with ``.names`` and ``.types`` (numpy
dtypes) where ray_tpu returns ``pa.Schema``. pandas and pyarrow are
imported only by the conversions that need them (``to_pandas``,
``to_arrow``, the ``"pandas"``/``"pyarrow"`` batch formats, a DataFrame or
Arrow table handed to ``batch_to_block``); without them those raise
ImportError naming the package.
"""

from __future__ import annotations

import numbers
from typing import Any, Iterable

import numpy as np

Block = dict  # column name -> np.ndarray, all of one length


class Schema:
    """A block's column names and numpy dtypes (ray_tpu returns ``pa.Schema``)."""

    def __init__(self, names: list, types: list):
        self.names = list(names)
        self.types = list(types)

    def __eq__(self, other):
        return isinstance(other, Schema) and (self.names, self.types) == (other.names, other.types)

    def __repr__(self):
        return "Schema(" + ", ".join(f"{n}: {t}" for n, t in zip(self.names, self.types)) + ")"


def _need(package: str, what: str):
    try:
        return __import__(package)
    except ImportError as e:
        raise ImportError(f"{what} needs {package}, which is not installed; the port's blocks are numpy columns "
                          f"and need only numpy otherwise") from e


def _objects(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _is_int(v) -> bool:
    return isinstance(v, numbers.Integral) and not isinstance(v, (bool, np.bool_))


def _is_real(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, (bool, np.bool_))


def _infer(values) -> np.ndarray:
    """A column from Python values, typed as Arrow would type them."""
    values = list(values)
    present = [v for v in values if v is not None]
    if not present or len(present) < len(values):
        return _objects(values)
    if all(isinstance(v, (bool, np.bool_)) for v in values):
        return np.asarray(values, dtype=bool)
    if all(_is_int(v) for v in values):
        return np.asarray(values, dtype=np.int64)
    if all(_is_real(v) for v in values):
        return np.asarray(values, dtype=np.float64)
    if all(isinstance(v, (list, tuple, np.ndarray)) for v in values):
        rows = [np.asarray(v) for v in values]
        if rows[0].dtype.kind in "biuf" and all(r.shape == rows[0].shape and r.dtype.kind in "biuf" for r in rows):
            return np.stack(rows)
        return _objects(rows)
    return _objects(values)


def _to_column(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        if v.dtype.kind in "US":
            return _objects(v.tolist())
        if v.dtype == object and v.ndim == 1:
            return _infer(v)
        return v
    if isinstance(v, (list, tuple)):
        return _infer(v)
    arr = np.asarray(v)  # a host tensor, a scalar sequence
    return _to_column(arr) if arr.dtype.kind in "USO" else arr


def _arrow_column(pa, col) -> np.ndarray:
    t = col.type
    if col.null_count == 0 and (pa.types.is_integer(t) or pa.types.is_floating(t) or pa.types.is_boolean(t)):
        return col.to_numpy()
    return _infer(col.to_pylist())


def _py(v):
    """One cell as Python gives it back from Arrow's ``to_pylist``."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _cells(col: np.ndarray) -> list:
    return [_py(v) for v in col] if col.dtype == object else col.tolist()


def _num_rows(block: Block) -> int:
    for col in block.values():
        return len(col)
    return 0


class BlockAccessor:
    """Format bridge + row-wise ops over one block."""

    def __init__(self, block: Block):
        self.block = block

    # ---------------- construction ----------------
    @staticmethod
    def batch_to_block(batch: Any) -> Block:
        """dict-of-arrays | pandas | arrow | list-of-rows -> block."""
        if isinstance(batch, dict):
            block = {k: _to_column(v) for k, v in batch.items()}
            lens = {k: len(c) for k, c in block.items()}
            if len(set(lens.values())) > 1:
                raise ValueError(f"a block's columns must have one length, got {lens}")
            return block
        top = type(batch).__module__.split(".")[0]
        if top == "pandas":
            return {str(c): _to_column(batch[c].to_numpy()) for c in batch.columns}
        if top == "pyarrow":
            pa = _need("pyarrow", "an Arrow table")
            if isinstance(batch, pa.Table):
                return {name: _arrow_column(pa, batch.column(name)) for name in batch.column_names}
        if isinstance(batch, list):
            if batch and isinstance(batch[0], dict):
                return BlockAccessor.rows_to_block(batch)
            return {"item": _infer(batch)}
        if isinstance(batch, np.ndarray):
            return BlockAccessor.batch_to_block({"data": batch})
        raise TypeError(f"cannot convert {type(batch)} to a block")

    @staticmethod
    def rows_to_block(rows: list[dict]) -> Block:
        """The columns are the first row's keys (``pa.Table.from_pylist``)."""
        return {k: _infer([r.get(k) for r in rows]) for k in (rows[0] if rows else ())}

    # ---------------- properties ----------------
    def num_rows(self) -> int:
        return _num_rows(self.block)

    def size_bytes(self) -> int:
        total = 0
        for col in self.block.values():
            total += col.nbytes
            if col.dtype == object:
                total += sum(v.nbytes if isinstance(v, np.ndarray) else len(v) if isinstance(v, (str, bytes)) else 8
                             for v in col)
        return total

    def schema(self) -> Schema:
        return Schema(list(self.block), [c.dtype for c in self.block.values()])

    # ---------------- conversion ----------------
    def to_arrow(self):
        pa = _need("pyarrow", "to_arrow")
        return pa.table({k: pa.array(_cells(c)) if c.dtype == object or c.ndim > 1 else c
                         for k, c in self.block.items()})

    def to_pandas(self):
        pd = _need("pandas", "to_pandas")
        return pd.DataFrame({k: list(c) if c.ndim > 1 else c for k, c in self.block.items()})

    def to_numpy(self, columns=None) -> dict[str, np.ndarray]:
        return {c: self.block[c] for c in (columns or self.block)}

    def to_batch(self, batch_format: str):
        if batch_format in ("numpy", "default"):
            return self.to_numpy()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    # ---------------- row ops ----------------
    def iter_rows(self) -> Iterable[dict]:
        names = list(self.block)
        for vals in zip(*(_cells(c) for c in self.block.values())):
            yield dict(zip(names, vals))

    def slice(self, start: int, end: int) -> Block:
        """Views of the rows [start, end), as Arrow's zero-copy slice."""
        return {k: c[start:end] for k, c in self.block.items()}

    def take_indices(self, idx) -> Block:
        """The rows at ``idx``, each column a copy that owns its buffer."""
        idx = np.asarray(idx, dtype=np.int64)
        return {k: c[idx] for k, c in self.block.items()}

    @staticmethod
    def concat(blocks: list[Block]) -> Block:
        """Rows of ``blocks`` in order; a column a block lacks is null there
        (Arrow's ``promote_options="default"``)."""
        blocks = [b for b in blocks if _num_rows(b) > 0] or blocks[:1]
        if not blocks:
            return {}
        if len(blocks) == 1:
            return dict(blocks[0])
        names: dict = {}
        for b in blocks:
            for k in b:
                names.setdefault(k, None)
        out = {}
        for k in names:
            cols = [b.get(k) for b in blocks]
            if all(c is not None and c.dtype != object for c in cols) and \
                    len({c.shape[1:] for c in cols}) == 1:
                out[k] = np.concatenate(cols)
                continue
            values = []
            for b, c in zip(blocks, cols):
                values.extend([None] * _num_rows(b) if c is None else (list(c) if c.dtype == object or c.ndim > 1
                                                                       else c.tolist()))
            out[k] = _infer(values)
        return out


def block_size_rows(block: Block) -> int:
    return _num_rows(block)

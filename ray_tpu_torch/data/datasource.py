"""Datasources: pluggable readers producing ReadTasks (port of
ray_tpu/data/datasource.py).

A ReadTask is a zero-arg callable executed as a remote task that yields
Blocks; planning (file listing, splitting) happens on the driver.

ray_tpu's read tasks are closures and lambdas, shipped by value. The
port pickles a task's arguments with the standard library, which cannot
pickle a nested function, so each ReadTask here holds a module-level
function under ``functools.partial`` or a bound method of its (picklable)
datasource. Parquet, CSV and JSON files are read through pyarrow and
images through PIL, each imported when a file is read; ``.npy`` and
binary files need nothing beyond numpy.
"""

from __future__ import annotations

import functools
import glob as _glob
import os
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, _need


@dataclass
class ReadTask:
    fn: Callable[[], Iterator[Block]]
    num_rows: int | None = None  # estimate for planning

    def __call__(self):
        return self.fn()


class Datasource:
    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        raise NotImplementedError

    def estimated_num_rows(self) -> int | None:
        return None


def _range_block(start: int, end: int):
    yield BlockAccessor.batch_to_block({"id": np.arange(start, end, dtype=np.int64)})


def _items_blocks(part: list):
    if part and isinstance(part[0], dict):
        yield BlockAccessor.rows_to_block(part)
    else:
        yield BlockAccessor.batch_to_block({"item": part})


def _one_block(block: Block):
    return iter([block])


class RangeDatasource(Datasource):
    def __init__(self, n: int, use_tensor: bool = False):
        self.n = n
        self.use_tensor = use_tensor

    def estimated_num_rows(self):
        return self.n

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        tasks = []
        chunk = max(1, self.n // max(parallelism, 1))
        start = 0
        while start < self.n:
            end = min(start + chunk, self.n)
            if self.n - end < max(1, chunk // 4):  # avoid tiny tail block
                end = self.n
            tasks.append(ReadTask(functools.partial(_range_block, start, end), num_rows=end - start))
            start = end
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: list):
        self.items = list(items)

    def estimated_num_rows(self):
        return len(self.items)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        n = len(self.items)
        if n == 0:
            return [ReadTask(functools.partial(_one_block, BlockAccessor.rows_to_block([])), num_rows=0)]
        chunk = max(1, n // max(parallelism, 1))
        return [ReadTask(functools.partial(_items_blocks, self.items[s : s + chunk]),
                         num_rows=len(self.items[s : s + chunk])) for s in range(0, n, chunk)]


class BlocksDatasource(Datasource):
    """From in-memory batches (from_numpy / from_pandas / from_arrow)."""

    def __init__(self, batches: list):
        self.blocks = [BlockAccessor.batch_to_block(b) for b in batches]

    def estimated_num_rows(self):
        return sum(BlockAccessor(b).num_rows() for b in self.blocks)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        return [ReadTask(functools.partial(_one_block, b), num_rows=BlockAccessor(b).num_rows()) for b in self.blocks]


def _expand_paths(paths, suffix: str | None = None) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        if os.path.isdir(p):
            pat = os.path.join(p, "**", f"*{suffix}" if suffix else "*")
            out.extend(sorted(f for f in _glob.glob(pat, recursive=True) if os.path.isfile(f)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(f for f in _glob.glob(p) if os.path.isfile(f)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


class FileDatasource(Datasource):
    suffix: str | None = None

    def __init__(self, paths, **read_kwargs):
        self.paths = _expand_paths(paths, self.suffix)
        self.read_kwargs = read_kwargs

    def read_file(self, path: str) -> Iterator[Block]:
        raise NotImplementedError

    def read_files(self, group: list) -> Iterator[Block]:
        for f in group:
            yield from self.read_file(f)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        files = self.paths
        k = max(1, len(files) // max(parallelism, 1))
        return [ReadTask(functools.partial(self.read_files, files[s : s + k])) for s in range(0, len(files), k)]


class ParquetDatasource(FileDatasource):
    suffix = ".parquet"

    def read_file(self, path):
        _need("pyarrow", "read_parquet")
        import pyarrow.parquet as pq

        yield BlockAccessor.batch_to_block(pq.read_table(path, **self.read_kwargs))


class CSVDatasource(FileDatasource):
    suffix = ".csv"

    def read_file(self, path):
        _need("pyarrow", "read_csv")
        import pyarrow.csv as pacsv

        yield BlockAccessor.batch_to_block(pacsv.read_csv(path, **self.read_kwargs))


class JSONDatasource(FileDatasource):
    suffix = ".json"

    def read_file(self, path):
        _need("pyarrow", "read_json")
        import pyarrow.json as pajson

        yield BlockAccessor.batch_to_block(pajson.read_json(path, **self.read_kwargs))


class NumpyDatasource(FileDatasource):
    suffix = ".npy"

    def read_file(self, path):
        arr = np.load(path, allow_pickle=False)
        yield BlockAccessor.batch_to_block({"data": arr})


class BinaryDatasource(FileDatasource):
    def read_file(self, path):
        with open(path, "rb") as f:
            data = f.read()
        yield BlockAccessor.batch_to_block({"bytes": [data], "path": [path]})


class ImageDatasource(FileDatasource):
    """Requires PIL, imported when a file is read."""

    def __init__(self, paths, size: tuple[int, int] | None = None, mode: str | None = None):
        super().__init__(paths)
        self.size = size
        self.mode = mode

    def read_file(self, path):
        _need("PIL", "read_images")
        from PIL import Image

        img = Image.open(path)
        if self.mode:
            img = img.convert(self.mode)
        if self.size:
            img = img.resize(self.size)
        yield BlockAccessor.batch_to_block({"image": np.asarray(img)[None], "path": [path]})

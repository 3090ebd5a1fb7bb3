"""ray_tpu_torch.data: streaming distributed datasets (port of ray_tpu/data).

Lazy plans over numpy-column blocks in the port's shared-memory object
store, executed by a pull-driven streaming pipeline with bounded
in-flight windows on the port's runtime (``ray_tpu_torch.init``). UDFs
travel by reference (``dataset.py``). Nothing here imports pyarrow,
pandas or PIL until a conversion or reader that needs one runs.
"""

from ray_tpu_torch.util.usage import record_library_usage as _rlu

_rlu("data")

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.dataset import (
    Dataset,
    GroupedData,
    MaterializedDataset,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_binary_files,
    read_csv,
    read_datasource,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
)
from ray_tpu_torch.data.datasource import Datasource, ReadTask
from ray_tpu_torch.data.iterator import DataIterator

__all__ = [
    "Block",
    "BlockAccessor",
    "DataIterator",
    "Dataset",
    "Datasource",
    "GroupedData",
    "MaterializedDataset",
    "ReadTask",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "read_binary_files",
    "read_csv",
    "read_datasource",
    "read_images",
    "read_json",
    "read_numpy",
    "read_parquet",
]

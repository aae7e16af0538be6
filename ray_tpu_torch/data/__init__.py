"""ray_tpu_torch.data: streaming distributed datasets over the port's
object plane (counterpart of `ray_tpu.data`).

Parity: reference `python/ray/data/` (Dataset `dataset.py:154`, streaming
executor `_internal/execution/streaming_executor.py:48`, read_api, grouped
data, DataContext). Blocks are dicts of numpy columns (block.py; the JAX
package's are pyarrow Tables); transforms run as tasks or actor pools with
windowed backpressure; consumption feeds numpy and torch batches, onto the
card with `iter_torch_batches(device="cuda")`. Nothing here imports pyarrow
or pandas unless a caller asks for them (`from_arrow`, `from_pandas`,
`to_pandas`, the "pandas" and "pyarrow" batch formats), and every function
that travels to a worker pickles by reference.

The readers that need pyarrow or pandas (parquet, csv, json, images, ...),
avro, tfrecord, the write sinks and the preprocessors are not ported yet.
"""

from ray_tpu_torch.data import aggregate  # noqa: F401
from ray_tpu_torch.data.block import Schema  # noqa: F401
from ray_tpu_torch.data.context import DataContext  # noqa: F401
from ray_tpu_torch.data.dataset import (  # noqa: F401
    DataIterator,
    Dataset,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
)
from ray_tpu_torch.data.datasource import (  # noqa: F401
    read_binary_files,
    read_numpy,
    read_text,
)

__all__ = [
    "Dataset", "DataIterator", "DataContext", "Schema", "aggregate",
    "range", "from_items", "from_pandas", "from_numpy", "from_arrow",
    "read_text", "read_binary_files", "read_numpy",
]

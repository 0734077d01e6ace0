"""ray_tpu_torch.data — distributed datasets on the task/object plane.

Reference surface: Ray Data (ray: python/ray/data/ — Dataset lazy
logical plan -> optimized physical plan -> StreamingExecutor with
back-pressured object-store queues; blocks as ObjectRefs;
task- or actor-pool compute for map_batches). This is the
capability-parity core: lazy plans, block streaming with bounded
in-flight work, operator fusion, both compute strategies, per-operator
stats. Blocks here are Python lists (the reference uses Arrow tables;
the block protocol is pluggable by construction — executor and plan
never look inside a block except in driver-side aggregations).

    import ray_tpu_torch
    from ray_tpu_torch import data

    ds = data.range(1000).map_batches(lambda b: [x * 2 for x in b])
    ds.take(5)   # [0, 2, 4, 6, 8]
"""

from ray_tpu_torch.data.dataset import (  # noqa: F401
    ActorPoolStrategy, AggregateFn, Dataset, from_items,
    range)  # noqa: A004
from ray_tpu_torch.data.datasource import (  # noqa: F401
    from_arrow, from_numpy, from_pandas, read_binary_files, read_csv,
    read_json, read_numpy, read_parquet, read_text)

__all__ = ["Dataset", "range", "from_items", "ActorPoolStrategy",
           "AggregateFn",
           "read_text", "read_csv", "read_json", "read_binary_files",
           "read_numpy", "read_parquet", "from_pandas", "from_numpy",
           "from_arrow"]

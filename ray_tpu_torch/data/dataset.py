"""Dataset — the lazy logical plan + user API.

Reference: ray: python/ray/data/dataset.py (Dataset),
_internal/logical/ (LogicalPlan operators). Execution happens only at
consumption (take/count/materialize/iter_*), through the streaming
executor (ray_tpu_torch/data/_streaming.py).
"""

from __future__ import annotations

import builtins
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple, Union)

# ----------------------------------------------------------------------
# logical operators
# ----------------------------------------------------------------------


class _LogicalOp:
    """Node in the lazy plan. kind:
    read        make_block(i) -> block  (runs IN a task)
    map_block   fn(block) -> block      (1:1, fusible)
    limit       truncate to n rows (applied streaming, driver-side)
    """

    def __init__(self, kind: str, *, name: str = "", fn=None,
                 num_blocks: int = 0, make_block=None, items=None,
                 blocks=None, refs=None, limit: int = 0, compute=None,
                 parent: Optional["_LogicalOp"] = None):
        self.kind = kind
        self.name = name or kind
        self.fn = fn
        self.num_blocks = num_blocks
        self.make_block = make_block
        self.items = items           # driver-resident source ROWS
        self.blocks = blocks         # driver-resident source BLOCKS
        self.refs = refs             # already-materialized block refs
        self.limit = limit
        self.compute = compute       # None = tasks | ActorPoolStrategy
        self.parent = parent

    def chain(self) -> List["_LogicalOp"]:
        ops: List[_LogicalOp] = []
        node: Optional[_LogicalOp] = self
        while node is not None:
            ops.append(node)
            node = node.parent
        return list(reversed(ops))


import itertools as _itertools

_SAMPLE_COUNTER = _itertools.count()


class ActorPoolStrategy:
    """compute= strategy: run map_batches on a pool of long-lived actors
    (reference: ray.data.ActorPoolStrategy / ActorPoolMapOperator)."""

    def __init__(self, size: int = 2):
        if size < 1:
            raise ValueError("actor pool size must be >= 1")
        self.size = size


class Dataset:
    """Lazy, immutable; every transform returns a new Dataset."""

    def __init__(self, op: _LogicalOp):
        self._op = op
        self._last_stats = None

    # -- transforms (lazy) ----------------------------------------------
    def map_batches(self, fn: Callable[[Any], Any],
                    batch_size: Optional[int] = None,
                    compute: Optional[ActorPoolStrategy] = None,
                    batch_format: str = "default",
                    name: str = "") -> "Dataset":
        """fn: batch -> batch. compute=None runs tasks (fusible);
        ActorPoolStrategy(n) runs on a pool of n actors. batch_size
        slices each block into fn-sized batches (batches do not cross
        block boundaries — the reference re-bundles across blocks).

        batch_format (reference: Dataset.map_batches batch_format):
        "default" passes the block through as-is (list blocks arrive
        as lists, Arrow blocks as pyarrow.Table); "pyarrow" /
        "pandas" / "numpy" convert each batch before fn, and fn may
        return a list, Table, DataFrame, or dict of arrays."""
        from ray_tpu_torch.data import block as blk

        inner = fn
        fmt = batch_format

        def wrapped(block, _f=inner, _fmt=fmt,
                    _bs=(int(batch_size) if batch_size else None)):
            if _bs is None:
                return blk.from_batch_output(
                    _f(blk.to_batch_format(block, _fmt)))
            outs: List[Any] = []
            n = blk.block_rows(block)
            for i in builtins.range(0, n, _bs):
                piece = blk.block_slice(block, i, min(i + _bs, n))
                outs.append(blk.from_batch_output(
                    _f(blk.to_batch_format(piece, _fmt))))
            return blk.concat_blocks(outs)

        return Dataset(_LogicalOp("map_block", fn=wrapped, compute=compute,
                                  name=name or getattr(inner, "__name__",
                                                       "map_batches"),
                                  parent=self._op))

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        from ray_tpu_torch.data import block as blk

        return self.map_batches(
            lambda block, _f=fn: [_f(x)
                                  for x in blk.iter_block_rows(block)],
            name=getattr(fn, "__name__", "map"))

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        from ray_tpu_torch.data import block as blk

        return self.map_batches(
            lambda block, _f=fn: [x for x in blk.iter_block_rows(block)
                                  if _f(x)],
            name=f"filter({getattr(fn, '__name__', 'fn')})")

    def flat_map(self, fn: Callable[[Any], Sequence[Any]]) -> "Dataset":
        from ray_tpu_torch.data import block as blk

        return self.map_batches(
            lambda block, _f=fn: [y for x in blk.iter_block_rows(block)
                                  for y in _f(x)],
            name=f"flat_map({getattr(fn, '__name__', 'fn')})")

    def limit(self, n: int) -> "Dataset":
        return Dataset(_LogicalOp("limit", limit=n, parent=self._op))

    # -- column ops (reference: Dataset.select_columns / drop_columns /
    # rename_columns / add_column — columnar on Arrow blocks, dict-row
    # fallback otherwise) --------------------------------------------

    def _map_columns(self, name: str, arrow_fn, row_fn) -> "Dataset":
        from ray_tpu_torch.data import block as blk

        def apply(block, _a=arrow_fn, _r=row_fn):
            if blk._is_arrow(block):
                return _a(block)
            return [_r(dict(row)) for row in blk.block_to_rows(block)]

        return Dataset(_LogicalOp("map_block", fn=apply, name=name,
                                  parent=self._op))

    def select_columns(self, cols: Sequence[str]) -> "Dataset":
        cols = list(cols)
        return self._map_columns(
            f"select_columns({cols})",
            lambda t: t.select(cols),
            lambda r: {k: r[k] for k in cols})

    def drop_columns(self, cols: Sequence[str]) -> "Dataset":
        cols = list(cols)
        return self._map_columns(
            f"drop_columns({cols})",
            lambda t: t.drop_columns(cols),
            lambda r: {k: v for k, v in r.items() if k not in cols})

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        mapping = dict(mapping)
        return self._map_columns(
            f"rename_columns({mapping})",
            lambda t: t.rename_columns(
                [mapping.get(c, c) for c in t.column_names]),
            lambda r: {mapping.get(k, k): v for k, v in r.items()})

    def add_column(self, name: str,
                   fn: Callable[[Any], Any]) -> "Dataset":
        """fn receives the BLOCK in pyarrow form (reference: fn gets
        the batch) and returns the new column's values."""
        import pyarrow as pa

        def arrow_fn(t, _f=fn, _n=name):
            return t.append_column(_n, pa.array(_f(t)))

        def row_fn(r):
            raise TypeError(
                "add_column needs columnar (Arrow) blocks; use "
                "map() for row datasets")

        return self._map_columns(f"add_column({name})", arrow_fn,
                                 row_fn)

    def unique(self, column: str) -> List[Any]:
        """Distinct values of a column (reference: Dataset.unique)."""
        from ray_tpu_torch.data import block as blk

        seen: set = set()
        out: List[Any] = []
        for b in self._execute():
            if blk._is_arrow(b):
                vals = b.column(column).unique().to_pylist()
            else:
                vals = [r[column] for r in blk.block_to_rows(b)]
            for v in vals:
                if v not in seen:
                    seen.add(v)
                    out.append(v)
        return out

    def random_sample(self, fraction: float,
                      seed: Optional[int] = None) -> "Dataset":
        """Bernoulli row sample (reference: Dataset.random_sample)."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1]: {fraction}")
        if seed is None:
            import random as _random
            seed = _random.randrange(1 << 31)
        from ray_tpu_torch.data import block as blk

        def sample(block, _frac=fraction, _seed=seed):
            import os as _os

            import numpy as np

            # (pid, per-process counter) decorrelates equal-sized
            # blocks WHEREVER they execute — the counter alone restarts
            # at 0 in every process-pool worker, which would hand
            # identical keep-masks to same-sized blocks on different
            # workers. Like the reference, row selection is
            # statistically stable but not bit-reproducible across
            # runs (block -> stream assignment follows execution)
            k = next(_SAMPLE_COUNTER)
            n = blk.block_rows(block)
            rng = np.random.default_rng((_seed, n, _os.getpid(), k))
            keep = np.flatnonzero(rng.random(n) < _frac)
            if blk._is_arrow(block):
                return block.take(keep)
            rows = blk.block_to_rows(block)
            return [rows[i] for i in keep]

        return Dataset(_LogicalOp("map_block", fn=sample,
                                  name=f"random_sample({fraction})",
                                  parent=self._op))

    def train_test_split(self, test_size: float,
                         shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> Tuple["Dataset", "Dataset"]:
        """(train, test) split by proportion (reference:
        Dataset.train_test_split)."""
        if not 0.0 < test_size < 1.0:
            raise ValueError(
                f"test_size must be in (0, 1): {test_size}")
        ds: "Dataset" = self
        if shuffle:
            ds = ds.random_shuffle(seed=seed)
        refs = ds.materialize().block_refs
        import ray_tpu_torch as _rt
        from ray_tpu_torch.data._streaming import _count_rows_task

        counts = _rt.get([_count_rows_task.remote(r) for r in refs])
        total = sum(counts)
        n_test = int(round(total * test_size))
        # walk blocks from the END until the test quota fills; the
        # boundary block splits via a slicing task
        test_refs: List[Any] = []
        acc = 0
        i = len(refs)
        while acc < n_test and i > 0:
            i -= 1
            acc += counts[i]
        from ray_tpu_torch.data._streaming import _split_block_task

        train_refs = list(refs[:i])
        test_refs = list(refs[i + 1:]) if acc > n_test else list(refs[i:])
        if acc > n_test:
            keep_train = acc - n_test
            a, b = _split_block_task.options(num_returns=2).remote(
                refs[i], keep_train)
            train_refs.append(a)
            test_refs.insert(0, b)
        return (Dataset(_refs_source(train_refs, "train_split")),
                Dataset(_refs_source(test_refs, "test_split")))

    # -- all-to-all ops (reference: AllToAllOperator — shuffle/sort/
    # groupby run map tasks that partition + reduce tasks that gather)
    def repartition(self, num_blocks: int) -> "Dataset":
        return Dataset(_LogicalOp(
            "all_to_all", name=f"repartition({num_blocks})",
            num_blocks=num_blocks,
            fn=("repartition", None), parent=self._op))

    def sort(self, key: Union[str, Callable[[Any], Any], None] = None,
             descending: bool = False,
             num_blocks: int = 0) -> "Dataset":
        """Distributed range-partitioned sort: sample -> partition by
        boundary -> per-partition sort (reference: sort.py push-based
        shuffle at minimum scale). A STRING key names a column — on
        Arrow blocks the whole exchange then stays columnar (vectorized
        range partition + table.sort_by, rows never materialize)."""
        return Dataset(_LogicalOp(
            "all_to_all", name="sort", num_blocks=num_blocks,
            fn=("sort", (key, descending)), parent=self._op))

    def groupby(self, key: Union[str, Callable[[Any], Any]]
                ) -> "GroupedDataset":
        """A STRING key names a column (the reference's form); named
        aggregations (count/sum/mean/min/max) then run COLUMNAR on
        Arrow blocks via hash partition + table.group_by."""
        return GroupedDataset(self, key)

    def random_shuffle(self, seed: Optional[int] = None,
                       num_blocks: int = 0) -> "Dataset":
        """Row shuffle via the two-stage PRP exchange.

        seed=None (the reference's default) draws a fresh seed at plan
        time, so unseeded shuffles differ across runs and chained
        shuffles are uncorrelated; pass a seed for reproducibility."""
        if seed is None:
            import random as _random
            seed = _random.randrange(1 << 31)
        return Dataset(_LogicalOp(
            "all_to_all", name="random_shuffle", num_blocks=num_blocks,
            fn=("shuffle", seed), parent=self._op))

    # -- consumption (triggers streaming execution) ---------------------
    def take(self, n: int = 20) -> List[Any]:
        from ray_tpu_torch.data import block as blk

        out: List[Any] = []
        for block in self._execute(limit=n):
            out.extend(blk.block_to_rows(block))
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> List[Any]:
        from ray_tpu_torch.data import block as blk

        out: List[Any] = []
        for block in self._execute():
            out.extend(blk.block_to_rows(block))
        return out

    def count(self) -> int:
        from ray_tpu_torch.data import block as blk

        return sum(blk.block_rows(b) for b in self._execute())

    def sum(self, on: Optional[str] = None) -> Any:
        from ray_tpu_torch.data import block as blk

        if on is not None:
            return self._numeric_stats(on)["sum"]
        total = 0
        for b in self._execute():
            total = total + builtins.sum(blk.iter_block_rows(b))
        return total

    def min(self, on: str) -> Any:
        return self._column_stats(on)["min"]

    def max(self, on: str) -> Any:
        return self._column_stats(on)["max"]

    def mean(self, on: str) -> Any:
        st = self._numeric_stats(on)
        return st["sum"] / st["count"] if st["count"] else None

    def std(self, on: str, ddof: int = 1) -> Any:
        """Whole-dataset column std (reference: Dataset.std), combined
        from per-block partials — no row gather on the driver."""
        import math

        st = self._numeric_stats(on)
        n = st["count"]
        if n <= ddof:
            return None
        var = (st["sumsq"] - st["sum"] * st["sum"] / n) / (n - ddof)
        return math.sqrt(max(var, 0.0))

    def _numeric_stats(self, col: str) -> Dict[str, Any]:
        st = self._column_stats(col)
        if st["count"] and not st["numeric"]:
            raise TypeError(
                f"sum/mean/std need a numeric column; {col!r} is not "
                "(min/max support any ordered type)")
        return st

    def _column_stats(self, col: str) -> Dict[str, Any]:
        """One pass, per-block numpy partials (nulls skipped, matching
        Arrow aggregation semantics). min/max keep the column's NATIVE
        type and work on any ordered values (strings included);
        sum/mean/std require a numeric column."""
        import numpy as np

        from ray_tpu_torch.data import block as blk

        count = 0
        total = 0.0
        sumsq = 0.0
        mn = None
        mx = None
        numeric = True
        for b in self._execute():
            if blk._is_arrow(b):
                vals = b.column(col).drop_null().to_numpy(
                    zero_copy_only=False)
            else:
                vals = np.asarray(
                    [r[col] for r in blk.block_to_rows(b)
                     if r[col] is not None])
            if len(vals) == 0:
                continue
            count += len(vals)
            bmn, bmx = vals.min(), vals.max()
            bmn = bmn.item() if hasattr(bmn, "item") else bmn
            bmx = bmx.item() if hasattr(bmx, "item") else bmx
            mn = bmn if mn is None else builtins.min(mn, bmn)
            mx = bmx if mx is None else builtins.max(mx, bmx)
            if numeric and vals.dtype.kind in "iufb":
                f = vals.astype(np.float64)
                total += float(f.sum())
                sumsq += float(np.square(f).sum())
            else:
                numeric = False
        return {"count": count, "sum": total, "sumsq": sumsq,
                "min": mn, "max": mx, "numeric": numeric}

    def iter_batches(self, *, batch_size: Optional[int] = None,
                     batch_format: str = "default") -> Iterator[Any]:
        """Batches in the requested format (reference:
        Dataset.iter_batches): by default, blocks in their native
        format (lists or pyarrow Tables); batch_size re-slices blocks
        (batches do not cross block boundaries); batch_format
        "pyarrow"/"pandas"/"numpy" converts each batch."""
        from ray_tpu_torch.data import block as blk

        for b in self._execute():
            n = blk.block_rows(b)
            if n == 0:
                # empty blocks (e.g. a filter that drained one) yield
                # NOTHING in every mode — an empty list block can't
                # honor a dict-of-columns contract, and batch_size
                # already skips them
                continue
            if batch_size is None:
                yield blk.to_batch_format(b, batch_format)
                continue
            for i in builtins.range(0, n, batch_size):
                piece = blk.block_slice(b, i, min(i + batch_size, n))
                yield blk.to_batch_format(piece, batch_format)

    def iter_torch_batches(self, *, batch_size: Optional[int] = None,
                           dtypes=None, device=None) -> Iterator[Any]:
        """Batches as dicts of torch tensors (reference:
        Dataset.iter_torch_batches) — numpy columns convert zero-copy
        via torch.from_numpy; dtypes maps column name -> torch dtype."""
        import torch

        def to_tensor(v):
            if v.dtype.kind in "iufb":
                # zero-copy views out of the shm arena are read-only;
                # torch requires writable memory, so only those copy
                t = torch.from_numpy(v if v.flags.writeable
                                     else v.copy())
            else:
                t = torch.as_tensor(v.tolist())
            if device is not None:
                t = t.to(device)
            return t

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy"):
            if not isinstance(batch, dict):
                # scalar-row blocks become one unnamed tensor
                yield to_tensor(batch)
                continue
            out = {}
            for k, v in batch.items():
                t = to_tensor(v)
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                out[k] = t
            yield out

    def iter_rows(self) -> Iterator[Any]:
        from ray_tpu_torch.data import block as blk

        for block in self._execute():
            yield from blk.iter_block_rows(block)

    # -- datasinks (reference: Dataset.write_* -> Datasink tasks) -------
    def write_csv(self, path: str) -> List[str]:
        from ray_tpu_torch.data import datasource

        return datasource.write_csv(self, path)

    def write_json(self, path: str) -> List[str]:
        from ray_tpu_torch.data import datasource

        return datasource.write_json(self, path)

    def write_parquet(self, path: str) -> List[str]:
        from ray_tpu_torch.data import datasource

        return datasource.write_parquet(self, path)

    def to_pandas(self):
        from ray_tpu_torch.data import datasource

        return datasource.to_pandas(self)

    def schema(self):
        """Column names of the first non-empty block (reference:
        Dataset.schema at minimum fidelity): a pyarrow.Schema for
        Arrow datasets, the sorted key list for dict-row datasets,
        None for scalar rows / empty datasets."""
        from ray_tpu_torch.data import block as blk

        for b in self._execute():
            if blk.block_rows(b) == 0:
                continue  # e.g. a filter drained this block: scan on
            if blk._is_arrow(b):
                return b.schema
            rows = blk.block_to_rows(b)
            if rows and isinstance(rows[0], dict):
                return sorted(rows[0].keys())
            return None
        return None

    def split(self, n: int) -> List["Dataset"]:
        """n datasets over contiguous slices of this one's blocks
        (reference: Dataset.split — a materializing operation; the
        splits are full Datasets and keep transforming lazily)."""
        if n < 1:
            raise ValueError("split needs n >= 1")
        refs = self.materialize().block_refs
        out = []
        for i in builtins.range(n):
            # near-even distribution: ceil-division would exhaust the
            # refs early and hand later splits zero blocks
            lo = (i * len(refs)) // n
            hi = ((i + 1) * len(refs)) // n
            out.append(Dataset(_refs_source(refs[lo:hi], f"split_{i}")))
        return out

    def streaming_split(self, n: int, equal: bool = False,
                        locality_hints: Optional[List[Any]] = None
                        ) -> List["StreamingShard"]:
        """n concurrent shard iterators over ONE streaming execution
        (reference: Dataset.streaming_split). Unlike split(), nothing
        materializes: a splitter routes each finished block to a
        per-consumer bounded queue as upstream tasks complete, so
        consumption overlaps production. ``equal=True`` round-robins
        blocks deterministically (consumer i gets blocks i, i+n, ...);
        ``equal=False`` routes each block to the least-backlogged
        consumer. Re-iterating an exhausted shard starts the next
        epoch: the lazy plan replays once every live shard finished
        the current one. Shards are single-use handles — call
        ``close()`` on a shard you abandon so the others don't wait on
        it at the epoch barrier."""
        from ray_tpu_torch.data._streaming import StreamingSplitCoordinator

        coord = StreamingSplitCoordinator(
            self, n, equal=equal, locality_hints=locality_hints)
        return coord.shards()

    def zip(self, other: "Dataset") -> "Dataset":
        """Positional column-merge of two same-length datasets
        (reference: Dataset.zip — right-side duplicate column names
        get a "_1" suffix). A materializing barrier like union: both
        sides execute to refs; right blocks re-chunk to the left's row
        boundaries in tasks, so the merge itself stays columnar and
        off-driver."""
        from ray_tpu_torch.data._streaming import zip_exchange

        left = self.materialize().block_refs
        right = other.materialize().block_refs
        return Dataset(_refs_source(zip_exchange(left, right), "zip"))

    def join(self, other: "Dataset", on: str, how: str = "inner",
             num_blocks: int = 0) -> "Dataset":
        """Key-based hash join (reference: the all-to-all join over
        Ray Data's hash shuffle). Both sides hash-partition by the key
        COLUMN through the same streamed exchange the shuffle tier
        uses; each reducer joins its partitions columnar via Arrow's
        hash join (duplicate right columns get an "_r" suffix).
        ``how``: inner | left | right | full."""
        from ray_tpu_torch.data._streaming import join_exchange

        if how not in ("inner", "left", "right", "full"):
            raise ValueError(
                f"how must be inner|left|right|full, got {how!r}")
        left = self.materialize().block_refs
        right = other.materialize().block_refs
        out = join_exchange(left, right, on, how,
                            num_blocks or len(left) or 1)
        return Dataset(_refs_source(out, f"join({on},{how})"))

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenation of this dataset and `others` (reference:
        Dataset.union). A materializing barrier here: every input
        executes to block refs, and the union is a new lazy Dataset
        over their concatenation (input order preserved)."""
        refs: List[Any] = list(self.materialize().block_refs)
        for o in others:
            refs.extend(o.materialize().block_refs)
        return Dataset(_refs_source(refs, "union"))

    def materialize(self) -> "MaterializedDataset":
        """Run the pipeline, keeping blocks in the object store as refs
        (the reference's ds.materialize())."""
        source, ex = self._final_executor(limit=None)
        refs = list(ex.run_refs())
        self._last_stats = ex.stats()
        return MaterializedDataset(refs)

    def stats(self):
        """Per-operator stats of the LAST execution segment (None
        before any)."""
        return self._last_stats

    def _final_executor(self, limit: Optional[int]):
        """Resolve all-to-all barriers: each exchange materializes its
        upstream segment's blocks and re-enters as a ref source
        (reference: AllToAllOperator is a materializing barrier in the
        streaming plan)."""
        from ray_tpu_torch.data._streaming import StreamingExecutor, all_to_all

        ops = self._op.chain()
        source = ops[0]
        segments: List[List[_LogicalOp]] = [[]]
        exchanges: List[_LogicalOp] = []
        for op in ops[1:]:
            if op.kind == "all_to_all":
                exchanges.append(op)
                segments.append([])
            else:
                segments[-1].append(op)
        for seg, a2a in zip(segments[:-1], exchanges):
            ex = StreamingExecutor([source] + seg)
            # the exchange consumes the STREAM: partition/sample tasks
            # launch per block as the upstream segment produces it (no
            # driver-side materialize barrier). A limit truncates the
            # stream, so only a limit-free segment can predict its
            # block count (0 = the exchange counts the drained stream)
            truncates = any(o.kind == "limit" for o in seg)
            out_refs = all_to_all(
                ex.run_refs(), a2a,
                default_num_out=0 if truncates else source.num_blocks)
            source = _refs_source(out_refs, a2a.name)
        return source, StreamingExecutor([source] + segments[-1],
                                         row_limit=limit)

    def _execute(self, limit: Optional[int] = None) -> Iterator[List[Any]]:
        _source, ex = self._final_executor(limit)
        try:
            yield from ex.run_blocks()
        finally:
            self._last_stats = ex.stats()

    def __repr__(self) -> str:
        names = " -> ".join(op.name for op in self._op.chain())
        return f"Dataset({names})"


class GroupedDataset:
    """ds.groupby(key).aggregate/count/map_groups (reference:
    GroupedData). Executes as an all-to-all: rows hash-partition by key
    to reducers, each reducer groups its partition."""

    def __init__(self, ds: Dataset, key: Callable[[Any], Any]):
        self._ds = ds
        self._key = key

    def map_groups(self, fn: Callable[[Any, List[Any]], Any]) -> Dataset:
        """fn(key, rows) -> row; one output row per group."""
        return Dataset(_LogicalOp(
            "all_to_all", name="groupby.map_groups",
            fn=("groupby", (self._key, fn)), parent=self._ds._op))

    def _named_agg(self, specs) -> Dataset:
        """Named aggregation exchange (reference: GroupedData.sum("c")
        etc.): hash-partition by the key COLUMN, reduce columnar via
        pyarrow group_by when blocks are Arrow, row accumulators
        otherwise — same output schema either way."""
        if not isinstance(self._key, str):
            raise TypeError(
                "named aggregations (count/sum/mean/min/max) need a "
                "column-name groupby key; use map_groups/aggregate for "
                "callable keys")
        return Dataset(_LogicalOp(
            "all_to_all", name=f"groupby_agg({specs})",
            fn=("groupby_agg", (self._key, specs)), parent=self._ds._op))

    def count(self) -> Dataset:
        if isinstance(self._key, str):
            return self._named_agg([(None, "count")])
        return self.map_groups(lambda k, rows: (k, len(rows)))

    def sum(self, col: str) -> Dataset:
        return self._named_agg([(col, "sum")])

    def mean(self, col: str) -> Dataset:
        return self._named_agg([(col, "mean")])

    def min(self, col: str) -> Dataset:
        return self._named_agg([(col, "min")])

    def max(self, col: str) -> Dataset:
        return self._named_agg([(col, "max")])

    def std(self, col: str, ddof: int = 1) -> Dataset:
        """Sample standard deviation per group (reference: Std
        aggregation, default ddof=1)."""
        return self._named_agg([(col, "std", ddof)])

    def quantile(self, col: str, q: float = 0.5) -> Dataset:
        """Exact per-group quantile (reference: Quantile aggregation;
        exact because each group's rows land on ONE reducer)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        return self._named_agg([(col, "quantile", q)])

    def aggregate(self, *aggs) -> Dataset:
        """Custom aggregations (reference: GroupedData.aggregate):
        each arg is an AggregateFn (init/accumulate_row/merge/finalize)
        OR — legacy form — one plain callable rows->value."""
        if len(aggs) == 1 and callable(aggs[0]) \
                and not isinstance(aggs[0], AggregateFn):
            agg = aggs[0]
            return self.map_groups(lambda k, rows, _a=agg: (k, _a(rows)))
        for a in aggs:
            if not isinstance(a, AggregateFn):
                raise TypeError(
                    f"aggregate() takes AggregateFn args, got {a!r}")
        if not isinstance(self._key, str):
            fns = list(aggs)

            def apply(k, rows, _fns=fns):
                rec = {"key": k}
                for f in _fns:
                    rec[f.name] = f.of_rows(k, rows)
                return rec

            return self.map_groups(apply)
        return self._named_agg([(None, "custom", a) for a in aggs])


class AggregateFn:
    """Custom streaming aggregation (reference: ray.data.AggregateFn):
    ``init(key) -> acc``, ``accumulate_row(acc, row) -> acc``,
    ``finalize(acc) -> value``. The hash exchange lands ALL rows of a
    group on one reducer, which folds them in a single accumulate
    pass — ``merge`` (accepted for reference-API compatibility) is
    therefore never invoked by the current execution tier; it becomes
    load-bearing only if reducers ever fold partial accumulators."""

    def __init__(self, init: Callable[[Any], Any],
                 accumulate_row: Callable[[Any, Any], Any],
                 merge: Optional[Callable[[Any, Any], Any]] = None,
                 finalize: Optional[Callable[[Any], Any]] = None,
                 name: str = "custom_agg"):
        self.init = init
        self.accumulate_row = accumulate_row
        self.merge = merge
        self.finalize = finalize or (lambda acc: acc)
        self.name = name

    def of_rows(self, key: Any, rows: List[Any]) -> Any:
        acc = self.init(key)
        for row in rows:
            acc = self.accumulate_row(acc, row)
        return self.finalize(acc)


class MaterializedDataset:
    """Executed dataset: blocks pinned as ObjectRefs."""

    def __init__(self, block_refs):
        self._refs = block_refs

    @property
    def block_refs(self):
        return list(self._refs)

    def num_blocks(self) -> int:
        return len(self._refs)

    def take_all(self) -> List[Any]:
        import ray_tpu_torch

        out: List[Any] = []
        for b in ray_tpu_torch.get(self._refs):
            out.extend(b)
        return out

    def iter_rows(self):
        import ray_tpu_torch

        for ref in self._refs:
            yield from ray_tpu_torch.get(ref)


def _refs_source(refs, name: str) -> _LogicalOp:
    """Source over already-materialized block refs (post-exchange).
    The executor passes these through DIRECTLY (or as _map_task args
    when a map fuses in) — re-reading them inside a source task would
    copy every block through the object store a second time."""
    return _LogicalOp("read", name=f"{name}_out",
                      num_blocks=len(refs),  # 0 = an EMPTY dataset
                      refs=list(refs))


# ----------------------------------------------------------------------
# sources (reference: ray.data.range / from_items / read_* datasources)
# ----------------------------------------------------------------------

def range(n: int, *, parallelism: int = 200) -> Dataset:  # noqa: A001
    """Integers [0, n) in ~parallelism blocks, generated INSIDE tasks."""
    num_blocks = max(1, min(parallelism, n)) if n else 1
    per = -(-n // num_blocks) if n else 0

    def make_block(i: int) -> List[int]:
        lo = i * per
        return list(builtins.range(lo, min(lo + per, n)))

    return Dataset(_LogicalOp("read", name=f"range({n})",
                              num_blocks=num_blocks,
                              make_block=make_block))


def from_items(items: Sequence[Any], *, parallelism: int = 200) -> Dataset:
    """Driver-resident data; the executor moves it through the object
    store once (a ref per block) rather than closing the whole list into
    every source task's pickled closure."""
    items = list(items)
    num_blocks = max(1, min(parallelism, len(items) or 1))
    return Dataset(_LogicalOp("read", name=f"from_items({len(items)})",
                              num_blocks=num_blocks, items=items))

"""Block format helpers: list-of-rows and Arrow-columnar blocks.

Reference: ray's Data blocks ARE Arrow tables (ray: python/ray/data/
_internal/block accessors, SURVEY.md §2.4 Data row) — the whole perf
model rests on columnar zero-copy exchange through plasma. Here both
formats are first-class: list blocks remain the row-oriented default
(shuffles exchange rows), pyarrow.Table blocks carry columnar data
through scan/map/write paths without ever materializing Python row
objects. Arrow tables pickle with protocol-5 out-of-band buffers, so
the shm object store writes/reads their column buffers zero-copy
(serialization.py keeps buffers out of band end to end).

batch_format (map_batches): "default" hands the block through as-is
(list stays list, Table stays Table), "pandas" / "numpy" / "pyarrow"
convert per batch; the fn's return value may be any block type (list,
Table, DataFrame, dict-of-arrays) and is normalized back to a block.
"""

from __future__ import annotations

from typing import Any, Iterator, List


def _is_arrow(block: Any) -> bool:
    try:
        import pyarrow as pa
    except ImportError:
        return False
    return isinstance(block, pa.Table)


def _is_pandas(block: Any) -> bool:
    # type-name check, no import: workers that never touch pandas must
    # not pay its import (and a partially-imported module in
    # sys.modules must not break block dispatch)
    t = type(block)
    return (t.__module__ or "").split(".")[0] == "pandas" \
        and t.__name__ == "DataFrame"


def block_rows(block: Any) -> int:
    """Row count of either block format."""
    if _is_arrow(block):
        return block.num_rows
    if _is_pandas(block):
        return len(block)
    return len(block)


def block_slice(block: Any, start: int, stop: int) -> Any:
    if _is_arrow(block):
        return block.slice(start, stop - start)
    if _is_pandas(block):
        return block.iloc[start:stop]
    return block[start:stop]


def block_to_rows(block: Any) -> List[Any]:
    """Rows as Python values (dict rows for columnar blocks)."""
    if _is_arrow(block):
        return block.to_pylist()
    if _is_pandas(block):
        return block.to_dict("records")
    return list(block)


def iter_block_rows(block: Any) -> Iterator[Any]:
    if _is_arrow(block) or _is_pandas(block):
        yield from block_to_rows(block)
    else:
        yield from block


def to_batch_format(block: Any, fmt: str) -> Any:
    """Convert a block to the format a map_batches fn asked for."""
    if fmt in (None, "default"):
        return block
    if fmt == "pyarrow":
        import pyarrow as pa

        if _is_arrow(block):
            return block
        if _is_pandas(block):
            return pa.Table.from_pandas(block, preserve_index=False)
        return pa.Table.from_pylist(list(block))
    if fmt == "pandas":
        if _is_pandas(block):
            return block
        if _is_arrow(block):
            return block.to_pandas()
        import pandas as pd

        return pd.DataFrame(list(block))
    if fmt == "numpy":
        # dict of column ndarrays (the reference's "numpy" batch format)
        if _is_arrow(block):
            return {name: col.to_numpy(zero_copy_only=False)
                    for name, col in zip(block.column_names,
                                         block.columns)}
        if _is_pandas(block):
            return {c: block[c].to_numpy() for c in block.columns}
        import numpy as np

        rows = list(block)
        if rows and all(isinstance(r, dict) for r in rows):
            # dict rows -> the same dict-of-columns shape Arrow blocks
            # produce, so one fn serves both block provenances
            keys = list(rows[0].keys())
            return {k: np.asarray([r.get(k) for r in rows]) for k in keys}
        return np.asarray(rows)
    raise ValueError(f"unknown batch_format {fmt!r} "
                     "(default | pyarrow | pandas | numpy)")


def from_batch_output(out: Any) -> Any:
    """Normalize a map_batches fn's return value into a block."""
    if out is None:
        return []
    if _is_arrow(out) or _is_pandas(out) or isinstance(out, list):
        return out
    if isinstance(out, dict):
        # dict of arrays -> arrow table (columnar stays columnar)
        import pyarrow as pa

        return pa.table(out)
    import numpy as np

    if isinstance(out, np.ndarray):
        return list(out)
    return list(out)


def block_nbytes(block: Any) -> int:
    """Approximate in-memory payload size (bytes backpressure)."""
    if _is_arrow(block):
        return block.nbytes
    if _is_pandas(block):
        return int(block.memory_usage(index=False, deep=False).sum())
    import sys

    return sys.getsizeof(block)


def compact_table(table: Any) -> Any:
    """Detach an Arrow table from an oversized backing buffer.

    ``Table.slice`` is a zero-copy VIEW: pickling a 2 MB slice of a
    128 MB table ships the whole 128 MB buffer. When the backing
    buffers dwarf the logical payload, round-trip through the IPC
    stream format to materialize a tight copy."""
    import pyarrow as pa

    if table.get_total_buffer_size() <= max(table.nbytes, 1) * 1.2:
        return table
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return pa.ipc.open_stream(sink.getvalue()).read_all()


def concat_blocks(blocks: List[Any]) -> Any:
    """Concatenate same-format blocks (arrow stays arrow)."""
    if blocks and all(_is_arrow(b) for b in blocks):
        import pyarrow as pa

        return pa.concat_tables(blocks)
    rows: List[Any] = []
    for b in blocks:
        rows.extend(block_to_rows(b))
    return rows

"""File datasources and datasinks for ray_tpu_torch.data.

Reference surfaces: ray python/ray/data/read_api.py (read_text /
read_csv / read_json / read_binary_files / read_numpy / read_parquet,
from_pandas / from_numpy) and the Datasink write path
(python/ray/data/_internal/datasource/*): reads discover files
driver-side and parse INSIDE tasks (one block per file); writes run one
task per block, each producing one output file.

Blocks here are plain Python lists (row lists), so parsers emit rows:
dicts for csv/parquet/pandas, str lines for text, parsed objects for
json, bytes for binary files. Parquet support is gated on pyarrow
(baked into this image; the import stays inside the task fn so the
driver never needs it).
"""

from __future__ import annotations

import glob as _glob
import os
from builtins import range as builtins_range
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.data.dataset import Dataset, _LogicalOp

Paths = Union[str, Sequence[str]]


def _expand_paths(paths: Paths) -> List[str]:
    """str | list of str; dirs list recursively (sorted), globs expand."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            for root, _dirs, files in sorted(os.walk(p)):
                out.extend(os.path.join(root, f) for f in sorted(files))
        elif os.path.exists(p):
            # existence first: a real file named "part[1].txt" must not
            # be misread as a glob character class
            out.append(p)
        elif any(ch in p for ch in "*?["):
            hits = sorted(_glob.glob(p))
            if not hits:
                raise FileNotFoundError(f"no files match {p!r}")
            out.extend(hits)
        else:
            raise FileNotFoundError(p)
    if not out:
        raise FileNotFoundError(f"no files under {paths!r}")
    return out


def _file_source(paths: Paths, name: str, parse) -> Dataset:
    files = _expand_paths(paths)

    def make_block(i: int, _files=tuple(files), _parse=parse) -> List[Any]:
        return _parse(_files[i])

    return Dataset(_LogicalOp("read", name=f"{name}({len(files)} files)",
                              num_blocks=len(files),
                              make_block=make_block))


# ----------------------------------------------------------------------
# readers
# ----------------------------------------------------------------------

def read_text(paths: Paths, *, encoding: str = "utf-8",
              drop_empty_lines: bool = True) -> Dataset:
    """One row per line; one block per file."""
    def parse(path: str) -> List[str]:
        with open(path, "r", encoding=encoding) as f:
            lines = [ln.rstrip("\n") for ln in f]
        if drop_empty_lines:
            lines = [ln for ln in lines if ln]
        return lines

    return _file_source(paths, "read_text", parse)


def read_csv(paths: Paths, *, encoding: str = "utf-8") -> Dataset:
    """One dict row per record (header-keyed); one block per file.
    Numeric-looking fields are converted (int, then float)."""
    def parse(path: str) -> List[Dict[str, Any]]:
        import csv

        def conv(v: Any) -> Any:
            if not isinstance(v, str):
                return v  # ragged row: DictReader's restval/restkey fill
            try:
                return int(v)
            except ValueError:
                try:
                    return float(v)
                except ValueError:
                    return v

        with open(path, "r", encoding=encoding, newline="") as f:
            return [{k: conv(v) for k, v in row.items()}
                    for row in csv.DictReader(f)]

    return _file_source(paths, "read_csv", parse)


def read_json(paths: Paths, *, encoding: str = "utf-8") -> Dataset:
    """JSONL (one object per line) or a top-level JSON array; one block
    per file."""
    def parse(path: str) -> List[Any]:
        import json

        with open(path, "r", encoding=encoding) as f:
            text = f.read().strip()
        if not text:
            return []
        if text[0] == "[":
            try:
                return list(json.loads(text))
            except json.JSONDecodeError:
                pass  # JSONL whose rows are arrays: fall through
        return [json.loads(ln) for ln in text.splitlines() if ln.strip()]

    return _file_source(paths, "read_json", parse)


def read_binary_files(paths: Paths, *,
                      include_paths: bool = False) -> Dataset:
    """One row per file: bytes, or (path, bytes) with include_paths."""
    def parse(path: str):
        with open(path, "rb") as f:
            data = f.read()
        return [(path, data)] if include_paths else [data]

    return _file_source(paths, "read_binary_files", parse)


def read_numpy(paths: Paths) -> Dataset:
    """Rows of each .npy's leading axis; one block per file."""
    def parse(path: str) -> List[Any]:
        import numpy as np

        return list(np.load(path, allow_pickle=False))

    return _file_source(paths, "read_numpy", parse)


def read_parquet(paths: Paths,
                 columns: Optional[List[str]] = None,
                 block_format: str = "arrow") -> Dataset:
    """One block per file. block_format="arrow" (default) keeps each
    file as a COLUMNAR pyarrow.Table block — the column buffers travel
    zero-copy through the shm object store (pickle-5 out-of-band) and
    map_batches sees tables; "rows" converts to dict rows per record
    (the pre-Arrow behavior). Requires pyarrow."""
    def parse(path: str) -> Any:
        try:
            import pyarrow.parquet as pq
        except ImportError as e:  # pragma: no cover - pyarrow is baked in
            raise ImportError(
                "read_parquet requires pyarrow") from e

        table = pq.read_table(path, columns=columns)
        return table if block_format == "arrow" else table.to_pylist()

    return _file_source(paths, "read_parquet", parse)


def from_pandas(df) -> Dataset:
    """One dict row per DataFrame record (single block)."""
    from ray_tpu_torch.data.dataset import from_items

    return from_items(df.to_dict("records"), parallelism=1)


def from_numpy(arr, *, parallelism: int = 8) -> Dataset:
    """Rows of the leading axis."""
    from ray_tpu_torch.data.dataset import from_items

    return from_items(list(arr), parallelism=parallelism)


def from_arrow(table, *, parallelism: int = 1) -> Dataset:
    """COLUMNAR blocks: the table splits into ``parallelism`` Table
    slices (zero-copy views) that stay Arrow end to end. Slices enter
    the object store once at execution (refs), not per task."""
    from ray_tpu_torch.data.dataset import Dataset, _LogicalOp

    from ray_tpu_torch.data.block import compact_table

    n = max(1, min(parallelism, table.num_rows or 1))
    per = -(-table.num_rows // n) if table.num_rows else 0
    # compact: a slice VIEW would ship the whole table's buffers with
    # every block (see block.compact_table)
    blocks = [compact_table(table.slice(i * per, per))
              for i in builtins_range(n)] if table.num_rows else [table]

    return Dataset(_LogicalOp("read", name=f"from_arrow({table.num_rows})",
                              num_blocks=len(blocks), blocks=blocks))


# ----------------------------------------------------------------------
# writers (datasinks): one task per block -> one file per block
# ----------------------------------------------------------------------

def _write_blocks(ds: Dataset, path: str, ext: str, write_fn) -> List[str]:
    """Materialize, then one write task per block (the reference's
    Datasink.write: tasks write their block and return the path).

    Write paths must live on storage shared by all nodes when the
    cluster has remote nodes — each write task creates the directory on
    whatever machine it runs on."""
    import ray_tpu_torch

    os.makedirs(path, exist_ok=True)
    mat = ds.materialize()

    @ray_tpu_torch.remote
    def write_block(block, out_path, _w=write_fn):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        _w(block, out_path)
        return out_path

    refs = [
        write_block.remote(
            ref, os.path.join(path, f"block_{i:05d}.{ext}"))
        for i, ref in enumerate(mat.block_refs)
    ]
    return ray_tpu_torch.get(refs)


def write_csv(ds: Dataset, path: str) -> List[str]:
    """Dict rows -> one CSV file per block (union of keys = header)."""
    def write_fn(block, out_path):
        import csv

        from ray_tpu_torch.data.block import block_to_rows
        block = block_to_rows(block)
        keys: List[str] = []
        for row in block:
            for k in row:
                if k not in keys:
                    keys.append(k)
        with open(out_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(block)

    return _write_blocks(ds, path, "csv", write_fn)


def write_json(ds: Dataset, path: str) -> List[str]:
    """JSONL: one object per line, one file per block."""
    def write_fn(block, out_path):
        import json

        from ray_tpu_torch.data.block import block_to_rows
        with open(out_path, "w") as f:
            for row in block_to_rows(block):
                f.write(json.dumps(row) + "\n")

    return _write_blocks(ds, path, "json", write_fn)


def write_parquet(ds: Dataset, path: str) -> List[str]:
    """One parquet file per block; Arrow blocks write COLUMNAR without
    ever materializing Python rows. Requires pyarrow."""
    def write_fn(block, out_path):
        import pyarrow as pa
        import pyarrow.parquet as pq

        from ray_tpu_torch.data.block import block_to_rows

        if not isinstance(block, pa.Table):
            block = pa.Table.from_pylist(block_to_rows(block))
        pq.write_table(block, out_path)

    return _write_blocks(ds, path, "parquet", write_fn)


def to_pandas(ds: Dataset):
    """Collect all rows into one DataFrame (driver-side)."""
    import pandas as pd

    rows = ds.take_all()
    return pd.DataFrame(rows)

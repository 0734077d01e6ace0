"""The port's Data library (``ray_tpu_torch.data``) on the CPU: the cases
of ``tests/test_data.py``, ``tests/test_datasource.py`` and
``tests/test_streaming_split.py`` run on the port (thread mode, the
TensorScheduler's device path on the host: ``sched_device`` "cpu"; the
process-mode cases in exec'd workers), then parity programs that feed the
same seeded numpy inputs through ``ray_tpu`` and ``ray_tpu_torch`` one
after the other and require exactly equal outputs.

The reference is imported only inside the parity tests: workers of the
process-mode cases unpickle this module's functions by value (registered
below) and must never load jax, flax or ray_tpu.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch import data
from ray_tpu_torch.data import ActorPoolStrategy

cloudpickle.register_pickle_by_value(sys.modules[__name__])

REPO = Path(__file__).resolve().parents[1]
SYSTEM = {"sched_device": "cpu"}
THREAD = dict(num_workers=8, scheduler="tensor", _system_config=SYSTEM,
              ignore_reinit_error=True)


@pytest.fixture(scope="module")
def _thread_runtime():
    ray.shutdown()
    yield
    ray.shutdown()


@pytest.fixture(autouse=True)
def rt(_thread_runtime):
    """The module's thread-mode runtime of 8 workers (tests/test_data.py's
    fixture; tests/test_datasource.py's autouse one), brought back up
    after a case that ran its own (process mode, a parity program)."""
    if not ray.is_initialized():
        ray.init(**THREAD)
    return ray


@pytest.fixture
def ray_start_tensor_sched():
    """tests/conftest.py's fixture of that name, on the port."""
    ray.shutdown()
    ray.init(num_workers=4, scheduler="tensor", _system_config=SYSTEM)
    yield ray
    ray.shutdown()


# == tests/test_data.py =======================================================

class TestBasics:
    def test_range_take(self, rt):
        assert data.range(100).take(5) == [0, 1, 2, 3, 4]

    def test_lazy_until_consumed(self, rt):
        calls = []
        ds = data.range(10).map(lambda x: calls.append(x) or x)
        assert calls == []  # nothing ran yet
        ds.count()

    def test_count_sum(self, rt):
        ds = data.range(1000)
        assert ds.count() == 1000
        assert ds.sum() == 499500

    def test_from_items(self, rt):
        assert sorted(data.from_items(["a", "b", "c"]).take_all()) == \
            ["a", "b", "c"]

    def test_map_filter_flat_map(self, rt):
        out = (data.range(20)
               .map(lambda x: x * 2)
               .filter(lambda x: x % 4 == 0)
               .flat_map(lambda x: [x, x])
               .take_all())
        assert out == [y for x in range(20) if (x * 2) % 4 == 0
                       for y in (x * 2, x * 2)]

    def test_map_batches_batch_size(self, rt):
        seen = []

        def f(batch):
            seen.append(len(batch))
            return batch

        out = data.range(100, parallelism=2).map_batches(
            f, batch_size=10).take_all()
        assert out == list(range(100))

    def test_limit_streams_early(self, rt):
        # a huge dataset consumed with take() must not execute every block
        ds = data.range(1_000_000, parallelism=1000).map(lambda x: x + 1)
        assert ds.take(10) == list(range(1, 11))
        stats = ds.stats()
        assert stats is not None
        submitted = stats["stages"][0]["submitted"]
        assert submitted < 200, f"streamed take ran {submitted} blocks"

    def test_limit_truncates_mid_block(self, rt):
        # blocks of 10 rows; limit 5 must cut INSIDE the first block
        ds = data.range(100, parallelism=10).limit(5)
        assert ds.take_all() == [0, 1, 2, 3, 4]
        assert ds.count() == 5
        assert ds.sum() == 10

    def test_limit_applies_at_its_position(self, rt):
        # limit BEFORE filter: filter sees only the first 10 rows
        out = (data.range(100, parallelism=10)
               .limit(10)
               .filter(lambda x: x >= 5)
               .take_all())
        assert out == [5, 6, 7, 8, 9]

    def test_limit_respected_by_materialize(self, rt):
        mds = data.range(10_000, parallelism=100).limit(5).materialize()
        assert mds.take_all() == [0, 1, 2, 3, 4]

    def test_order_preserved(self, rt):
        out = data.range(500, parallelism=50).map(lambda x: x).take_all()
        assert out == list(range(500))

    def test_fusion(self, rt):
        ds = data.range(100, parallelism=4).map(lambda x: x + 1).map(
            lambda x: x * 2)
        assert ds.take_all() == [(x + 1) * 2 for x in range(100)]
        stats = ds.stats()
        # read + both maps fused into ONE stage
        assert len(stats["stages"]) == 1

    def test_materialize(self, rt):
        mds = data.range(50).materialize()
        assert mds.num_blocks() >= 1
        assert mds.take_all() == list(range(50))

    def test_exception_propagates(self, rt):
        def boom(x):
            raise ValueError("bad row")

        with pytest.raises(Exception):
            data.range(10).map(boom).take_all()


class TestActorCompute:
    def test_actor_pool_map_batches(self, rt):
        ds = data.range(200, parallelism=8).map_batches(
            lambda b: [x * 3 for x in b], compute=ActorPoolStrategy(2))
        assert ds.take_all() == [x * 3 for x in range(200)]
        stats = ds.stats()
        assert any(s["compute"] == "actors(2)" for s in stats["stages"])

    def test_actor_pool_stateful_warmup(self, rt):
        """Actors hold state across blocks (the point of actor compute:
        expensive setup amortized, reference: model inference)."""

        class Model:
            def __init__(self):
                self.offset = 100

        # the fn runs inside the actor; closure state initializes once
        # per actor via a lazy global
        def infer(batch):
            global _MODEL
            try:
                _MODEL
            except NameError:
                _MODEL = Model()
            return [x + _MODEL.offset for x in batch]

        ds = data.range(100, parallelism=4).map_batches(
            infer, compute=ActorPoolStrategy(2))
        assert ds.take_all() == [x + 100 for x in range(100)]


class TestBackpressure:
    def test_bounded_live_blocks(self, rt):
        """100k-row pipeline with many blocks completes with bounded
        buffering (the VERDICT 'done when': bounded memory)."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        ds = data.range(100_000, parallelism=500).map_batches(
            lambda b: [x + 1 for x in b])
        total = ds.count()
        assert total == 100_000
        stats = ds.stats()
        assert stats["stages"][0]["completed"] == 500
        # the backpressure budget bounds live blocks; indirect check:
        # executor never buffers more than data_buffer_blocks outputs
        assert GLOBAL_CONFIG.data_buffer_blocks < 500


class TestAllToAll:
    def test_repartition(self, rt):
        ds = data.range(100, parallelism=10).repartition(4)
        mds = ds.materialize()
        assert mds.num_blocks() == 4
        assert sorted(mds.take_all()) == list(range(100))

    def test_sort(self, rt):
        ds = data.from_items([5, 3, 9, 1, 7, 2, 8, 0, 6, 4] * 10,
                             parallelism=5).sort()
        out = ds.take_all()
        assert out == sorted(out)
        assert len(out) == 100

    def test_sort_key_descending(self, rt):
        ds = data.from_items([(i % 7, i) for i in range(50)],
                             parallelism=4).sort(
            key=lambda t: t[0], descending=True)
        keys = [t[0] for t in ds.take_all()]
        assert keys == sorted(keys, reverse=True)

    def test_random_shuffle_preserves_multiset(self, rt):
        ds = data.range(200, parallelism=8).random_shuffle(seed=1)
        out = ds.take_all()
        assert sorted(out) == list(range(200))
        assert out != list(range(200))  # actually shuffled

    def test_groupby_count_and_aggregate(self, rt):
        ds = data.range(100, parallelism=10)
        counts = dict(ds.groupby(lambda x: x % 3).count().take_all())
        assert counts == {0: 34, 1: 33, 2: 33}
        sums = dict(data.range(10).groupby(lambda x: x % 2)
                    .aggregate(sum).take_all())
        assert sums == {0: 0 + 2 + 4 + 6 + 8, 1: 1 + 3 + 5 + 7 + 9}

    def test_exchange_then_streaming_continues(self, rt):
        out = (data.range(100, parallelism=10)
               .sort(descending=True)
               .map(lambda x: x * 2)
               .take(3))
        assert out == [198, 196, 194]

    def test_groupby_string_keys_process_mode(self):
        """Stable hashing: builtin hash() is per-process randomized, so
        string keys must still group correctly when partition tasks run
        in separate worker processes."""
        ray.shutdown()
        ray.init(num_workers=2, scheduler="tensor",
                 _system_config={**SYSTEM, "worker_mode": "process"})
        try:
            names = ["alpha", "beta", "gamma"] * 20
            counts = dict(data.from_items(names, parallelism=6)
                          .groupby(lambda s: s).count().take_all())
            assert counts == {"alpha": 20, "beta": 20, "gamma": 20}
        finally:
            ray.shutdown()


class TestBatchIteration:
    """iter_batches(batch_size/batch_format) + iter_torch_batches
    (reference: Dataset.iter_batches / iter_torch_batches)."""

    def test_iter_batches_sizes_and_format(self, rt):
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"x": list(range(100))})
        sizes = [b.num_rows for b in
                 data.from_arrow(t, parallelism=4).iter_batches(
                     batch_size=8, batch_format="pyarrow")]
        assert sum(sizes) == 100 and max(sizes) <= 8
        np_batches = list(data.from_arrow(t, parallelism=2).iter_batches(
            batch_format="numpy"))
        assert all(isinstance(b, dict) and b["x"].dtype.kind == "i"
                   for b in np_batches)

    def test_empty_blocks_skipped(self, rt):
        """A filter that drains blocks must not leak empty non-dict
        batches into numpy/torch iteration."""
        pytest.importorskip("torch")
        ds = data.from_items([{"x": i} for i in range(10)],
                             parallelism=5).filter(lambda r: r["x"] == 3)
        got = list(ds.iter_torch_batches())
        assert len(got) == 1 and int(got[0]["x"][0]) == 3
        np_batches = list(ds.iter_batches(batch_format="numpy"))
        assert all(isinstance(b, dict) for b in np_batches)

    def test_iter_torch_batches(self, rt):
        torch = pytest.importorskip("torch")
        pa = pytest.importorskip("pyarrow")
        import numpy as np

        t = pa.table({"x": np.arange(40, dtype=np.int64),
                      "y": np.arange(40, dtype=np.float32) / 2})
        total = 0
        for b in data.from_arrow(t, parallelism=2).iter_torch_batches(
                batch_size=16, dtypes={"y": torch.float64}):
            assert isinstance(b["x"], torch.Tensor)
            assert b["y"].dtype == torch.float64
            total += len(b["x"])
        assert total == 40
        # scalar-row datasets yield plain tensors
        out = list(data.range(10, parallelism=2).iter_torch_batches())
        assert all(isinstance(x, torch.Tensor) for x in out)
        assert sum(int(x.sum()) for x in out) == sum(range(10))


class TestSplitUnionSchema:
    """Dataset.split / union / schema (reference: the same names on
    ray.data.Dataset; split and union materialize, the results stay
    lazy Datasets)."""

    def test_split_partitions_blocks(self, rt):
        parts = data.range(100, parallelism=10).split(3)
        assert len(parts) == 3
        seen = [x for p in parts for x in p.take_all()]
        assert sorted(seen) == list(range(100))
        # splits keep transforming lazily
        assert parts[0].map(lambda x: x * 2).count() > 0

    def test_union_concatenates_in_order(self, rt):
        a = data.range(5, parallelism=2)
        b = data.from_items([10, 11, 12], parallelism=1)
        out = a.union(b).take_all()
        assert out == [0, 1, 2, 3, 4, 10, 11, 12]

    def test_schema(self, rt):
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"a": [1], "b": ["x"]})
        sch = data.from_arrow(t, parallelism=1).schema()
        assert sch.names == ["a", "b"]
        assert data.from_items([{"k": 1, "j": 2}]).schema() == ["j", "k"]
        assert data.range(5).schema() is None


class TestJoinZipAggregations:
    """VERDICT round-5 task 6: relational breadth on the exchange tier
    (reference: ray.data join/zip/aggregations over the hash shuffle)."""

    def _sides(self):
        left = data.from_items(
            [{"k": i % 5, "v": float(i)} for i in range(40)])
        right = data.from_items(
            [{"k": k, "w": k * 100} for k in (0, 1, 2, 7)])
        return left, right

    def test_inner_join_columnar_path(self, rt):
        import numpy as np
        import pyarrow as pa

        from ray_tpu_torch.data import _streaming as st

        # Arrow blocks end-to-end: partition (vectorized key hashing)
        # -> Arrow hash join in the reducer
        left = data.from_arrow(pa.table(
            {"k": np.arange(40, dtype=np.int64) % 5,
             "v": np.arange(40, dtype=np.float64)}), parallelism=4)
        right = data.from_arrow(pa.table(
            {"k": np.array([0, 1, 2, 7], dtype=np.int64),
             "w": np.array([0, 100, 200, 700], dtype=np.int64)}),
            parallelism=2)
        before = st._JOIN_COLUMNAR_REDUCES
        rows = left.join(right, on="k").take_all()
        # thread-mode workers share the module global: the reduce must
        # have taken Arrow's hash join, not the row fallback
        assert st._JOIN_COLUMNAR_REDUCES > before
        # k in {0,1,2} matches: 8 left rows each
        assert len(rows) == 24
        for r in rows:
            assert r["w"] == r["k"] * 100
            assert set(r) == {"k", "v", "w"}

    def test_left_right_full_join(self, rt):
        left, right = self._sides()
        lj = left.join(right, on="k", how="left").take_all()
        assert len(lj) == 40  # every left row survives
        assert sum(1 for r in lj if r["w"] is None) == 16  # k=3,4
        rj = left.join(right, on="k", how="right").take_all()
        # 24 matches + the unmatched right k=7
        assert len(rj) == 25
        assert sum(1 for r in rj if r["v"] is None) == 1
        fj = left.join(right, on="k", how="full").take_all()
        assert len(fj) == 41

    def test_join_duplicate_columns_get_suffix(self, rt):
        left = data.from_items([{"k": 1, "x": 10}])
        right = data.from_items([{"k": 1, "x": 20}])
        rows = left.join(right, on="k").take_all()
        assert rows == [{"k": 1, "x": 10, "x_r": 20}]

    def test_zip(self, rt):
        a = data.from_items([{"a": i} for i in range(25)])
        b = data.from_items([{"b": i * 2} for i in range(25)])
        rows = a.zip(b).take_all()
        assert rows == [{"a": i, "b": i * 2} for i in range(25)]

    def test_zip_duplicate_columns_and_mismatch(self, rt):
        a = data.from_items([{"x": i} for i in range(4)])
        b = data.from_items([{"x": i + 1} for i in range(4)])
        assert a.zip(b).take_all() == [
            {"x": i, "x_1": i + 1} for i in range(4)]
        short = data.from_items([{"y": 0}])
        with pytest.raises(Exception, match="equal row counts"):
            a.zip(short).take_all()

    def test_std_and_quantile(self, rt):
        import numpy as np

        rows = [{"k": i % 3, "v": float(i) ** 1.5 } for i in range(30)]
        ds = data.from_items(rows)
        std = {r["k"]: r["std(v)"]
               for r in ds.groupby("k").std("v").take_all()}
        q = {r["k"]: r["quantile(v)"]
             for r in ds.groupby("k").quantile("v", 0.5).take_all()}
        for k in range(3):
            vals = np.array([r["v"] for r in rows if r["k"] == k])
            assert std[k] == pytest.approx(np.std(vals, ddof=1))
            assert q[k] == pytest.approx(np.quantile(vals, 0.5))

    def test_custom_aggregate_fn(self, rt):
        from ray_tpu_torch.data import AggregateFn

        span = AggregateFn(
            init=lambda k: [float("inf"), float("-inf")],
            accumulate_row=lambda a, r: [min(a[0], r["v"]),
                                         max(a[1], r["v"])],
            merge=lambda a, b: [min(a[0], b[0]), max(a[1], b[1])],
            finalize=lambda a: a[1] - a[0],
            name="span(v)")
        ds = data.from_items(
            [{"k": i % 2, "v": float(i)} for i in range(20)])
        rows = {r["k"]: r["span(v)"]
                for r in ds.groupby("k").aggregate(span).take_all()}
        assert rows == {0: 18.0, 1: 18.0}

    def test_custom_aggregate_fn_with_callable_key(self, rt):
        from ray_tpu_torch.data import AggregateFn

        total = AggregateFn(
            init=lambda k: 0.0,
            accumulate_row=lambda a, r: a + r["v"],
            merge=lambda a, b: a + b,
            name="sum(v)")
        ds = data.from_items(
            [{"k": i, "v": float(i)} for i in range(10)])
        rows = ds.groupby(lambda r: r["k"] % 2).aggregate(
            total).take_all()
        got = {r["key"]: r["sum(v)"] for r in rows}
        assert got == {0: 20.0, 1: 25.0}

    def test_mixed_native_and_extended_aggs(self, rt):
        """std next to sum in one exchange takes the sorted-group walk
        for BOTH, same names/semantics as the split paths."""
        ds = data.from_items(
            [{"k": i % 2, "v": float(i)} for i in range(10)])
        rows = ds.groupby("k")._named_agg(
            [("v", "sum"), ("v", "std", 1)]).take_all()
        by_k = {r["k"]: r for r in rows}
        assert by_k[0]["sum(v)"] == 20.0
        import numpy as np

        assert by_k[0]["std(v)"] == pytest.approx(
            np.std([0, 2, 4, 6, 8], ddof=1))


class TestColumnOpsAndStats:
    """Reference Dataset surface breadth: select/drop/rename/
    add_column, unique, random_sample, train_test_split, and
    whole-dataset column stats."""

    def _ds(self):
        import numpy as np
        import pyarrow as pa

        return data.from_arrow(pa.table(
            {"a": np.arange(50, dtype=np.int64),
             "b": np.arange(50, dtype=np.float64) * 2.0,
             "c": np.arange(50, dtype=np.int64) % 5}), parallelism=4)

    def test_select_drop_rename_add(self, rt):
        ds = self._ds()
        assert ds.select_columns(["a"]).schema().names == ["a"]
        assert ds.drop_columns(["b"]).schema().names == ["a", "c"]
        rows = ds.rename_columns({"a": "x"}).take(1)
        assert set(rows[0]) == {"x", "b", "c"}
        rows = ds.add_column(
            "d", lambda t: (t.column("a").to_numpy() + 1)).take(2)
        assert [r["d"] for r in rows] == [1, 2]

    def test_column_ops_on_row_blocks(self, rt):
        ds = data.from_items([{"a": i, "b": -i} for i in range(10)])
        assert ds.select_columns(["b"]).take(2) == [{"b": 0}, {"b": -1}]
        assert ds.rename_columns({"b": "z"}).take(1) == [{"a": 0, "z": 0}]

    def test_unique(self, rt):
        assert sorted(self._ds().unique("c")) == [0, 1, 2, 3, 4]

    def test_random_sample(self, rt):
        n = len(self._ds().random_sample(0.5, seed=7).take_all())
        assert 10 <= n <= 40  # Bernoulli around 25
        assert self._ds().random_sample(0.0).take_all() == []
        assert len(self._ds().random_sample(1.0).take_all()) == 50

    def test_train_test_split(self, rt):
        train, test = self._ds().train_test_split(test_size=0.2)
        tr, te = train.take_all(), test.take_all()
        assert len(tr) == 40 and len(te) == 10
        # order-preserving split: test is the TAIL
        assert [r["a"] for r in tr] == list(range(40))
        assert [r["a"] for r in te] == list(range(40, 50))

    def test_dataset_level_stats(self, rt):
        import numpy as np

        ds = self._ds()
        b = np.arange(50, dtype=np.float64) * 2.0
        assert ds.sum(on="b") == pytest.approx(b.sum())
        assert ds.min(on="b") == 0.0 and ds.max(on="b") == 98.0
        assert ds.mean(on="b") == pytest.approx(b.mean())
        assert ds.std(on="b") == pytest.approx(np.std(b, ddof=1))
        # legacy row-sum form still works
        assert data.range(5).sum() == 10


# == tests/test_datasource.py =================================================

def test_read_text(tmp_path):
    for i in range(3):
        (tmp_path / f"f{i}.txt").write_text(f"a{i}\nb{i}\n\n")
    ds = data.read_text(str(tmp_path))
    rows = ds.take_all()
    assert sorted(rows) == ["a0", "a1", "a2", "b0", "b1", "b2"]


def test_read_text_glob_and_pipeline(tmp_path):
    for i in range(4):
        (tmp_path / f"part-{i}.log").write_text(f"line{i}\n")
    (tmp_path / "ignore.dat").write_text("nope\n")
    ds = data.read_text(str(tmp_path / "part-*.log"))
    n = ds.map(lambda s: s.upper()).filter(
        lambda s: s.endswith(("1", "3"))).count()
    assert n == 2


def test_read_csv_typed(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("name,age,score\nalice,31,9.5\nbob,44,7.25\n")
    rows = data.read_csv(str(p)).take_all()
    assert rows == [{"name": "alice", "age": 31, "score": 9.5},
                    {"name": "bob", "age": 44, "score": 7.25}]


def test_read_json_jsonl_and_array(tmp_path):
    (tmp_path / "a.jsonl").write_text('{"x": 1}\n{"x": 2}\n')
    (tmp_path / "b.json").write_text('[{"x": 3}, {"x": 4}]')
    rows = data.read_json([str(tmp_path / "a.jsonl"),
                           str(tmp_path / "b.json")]).take_all()
    assert sorted(r["x"] for r in rows) == [1, 2, 3, 4]


def test_read_binary_files(tmp_path):
    (tmp_path / "x.bin").write_bytes(b"\x00\x01")
    (tmp_path / "y.bin").write_bytes(b"\x02")
    rows = data.read_binary_files(str(tmp_path),
                                  include_paths=True).take_all()
    assert {os.path.basename(p): b for p, b in rows} == {
        "x.bin": b"\x00\x01", "y.bin": b"\x02"}


def test_read_numpy(tmp_path):
    np.save(tmp_path / "a.npy", np.arange(6).reshape(3, 2))
    rows = data.read_numpy(str(tmp_path / "a.npy")).take_all()
    assert len(rows) == 3
    np.testing.assert_array_equal(rows[1], [2, 3])


def test_parquet_roundtrip(tmp_path):
    pytest.importorskip("pyarrow")
    ds = data.from_items([{"k": i, "v": i * i} for i in range(10)],
                         parallelism=2)
    files = ds.write_parquet(str(tmp_path / "out"))
    assert len(files) == 2 and all(f.endswith(".parquet") for f in files)
    back = data.read_parquet(str(tmp_path / "out")).take_all()
    assert sorted(r["v"] for r in back) == [i * i for i in range(10)]


def test_write_csv_roundtrip(tmp_path):
    ds = data.from_items([{"a": i, "b": f"s{i}"} for i in range(6)],
                         parallelism=3)
    files = ds.write_csv(str(tmp_path / "csv"))
    assert len(files) == 3
    back = data.read_csv(files).take_all()
    assert sorted(r["a"] for r in back) == list(range(6))


def test_write_json_roundtrip(tmp_path):
    ds = data.range(10, parallelism=2).map(lambda x: {"n": x})
    files = ds.write_json(str(tmp_path / "js"))
    total = 0
    for f in files:
        with open(f) as fh:
            total += sum(json.loads(ln)["n"] for ln in fh)
    assert total == sum(range(10))


def test_pandas_interop():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"x": [1, 2, 3], "y": ["a", "b", "c"]})
    ds = data.from_pandas(df)
    assert ds.count() == 3
    df2 = ds.map(lambda r: {**r, "x": r["x"] * 10}).to_pandas()
    assert sorted(df2["x"].tolist()) == [10, 20, 30]


def test_from_numpy():
    ds = data.from_numpy(np.arange(12).reshape(4, 3))
    assert ds.count() == 4


def test_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        data.read_text("/nonexistent/path/file.txt")
    with pytest.raises(FileNotFoundError):
        data.read_text("/tmp/definitely-no-match-*.zzz")


# ----------------------------------------------------------------------
# Arrow columnar blocks (reference: Data blocks ARE Arrow tables)
# ----------------------------------------------------------------------

class TestArrowBlocks:
    def test_from_arrow_blocks_stay_columnar(self):
        pa = pytest.importorskip("pyarrow")
        table = pa.table({"x": list(range(100)),
                          "y": [float(i) * 0.5 for i in range(100)]})
        ds = data.from_arrow(table, parallelism=4)
        seen_types = []

        def probe(batch):
            seen_types.append(type(batch))
            return batch

        out = ds.map_batches(probe).take_all()
        assert len(out) == 100 and out[0] == {"x": 0, "y": 0.0}
        # the fn saw pyarrow Tables, not row lists
        assert all(t is pa.Table for t in seen_types)

    def test_batch_formats(self):
        pa = pytest.importorskip("pyarrow")
        pd = pytest.importorskip("pandas")
        table = pa.table({"x": [1, 2, 3, 4]})
        ds = data.from_arrow(table)

        got = ds.map_batches(lambda df: df.assign(x=df["x"] * 2),
                             batch_format="pandas").take_all()
        assert [r["x"] for r in got] == [2, 4, 6, 8]

        got = ds.map_batches(lambda cols: {"x": cols["x"] * 10},
                             batch_format="numpy").take_all()
        assert [r["x"] for r in got] == [10, 20, 30, 40]

        got = ds.map_batches(
            lambda t: t.append_column(
                "y", pa.array([v.as_py() + 1 for v in t["x"]])),
            batch_format="pyarrow").take_all()
        assert got[0] == {"x": 1, "y": 2}

    def test_arrow_block_crosses_process_without_row_pickling(self):
        """An Arrow block round-trips driver -> process worker as a
        TABLE (columnar buffers through the shm arena), never as
        per-row Python objects."""
        pa = pytest.importorskip("pyarrow")
        import numpy as np

        ray.shutdown()
        ray.init(num_workers=2,
                 _system_config={**SYSTEM, "worker_mode": "process",
                                     # force the shm path (not inline)
                                     "inline_object_max_bytes": 1024})
        try:
            n = 50_000
            table = pa.table({"x": np.arange(n, dtype=np.int64)})
            ds = data.from_arrow(table, parallelism=2)

            def check(batch):
                # arrived as a Table in the worker process
                assert isinstance(batch, pa.Table), type(batch)
                return {"x": batch["x"].to_numpy() * 2}

            out = ds.map_batches(check, batch_format="pyarrow")
            total = sum(r["x"] for r in out.iter_rows())
            assert total == 2 * sum(range(n))
        finally:
            ray.shutdown()

    def test_parquet_arrow_roundtrip(self, tmp_path):
        pa = pytest.importorskip("pyarrow")
        table = pa.table({"a": list(range(20)), "b": ["s"] * 20})
        ds = data.from_arrow(table, parallelism=2)
        files = ds.write_parquet(str(tmp_path / "pq"))
        back = data.read_parquet(sorted(files))  # arrow blocks default
        assert back.count() == 20
        blocks = list(back.iter_batches())
        assert all(isinstance(b, pa.Table) for b in blocks)
        assert back.sum.__self__ is back  # smoke: API intact

    def test_bytes_backpressure_accounting(self):
        """Arena-resident block sizes feed the executor's bytes budget
        and surface in stats()."""
        pa = pytest.importorskip("pyarrow")
        import numpy as np

        ray.shutdown()
        ray.init(num_workers=2,
                 _system_config={**SYSTEM, "worker_mode": "process",
                                     "inline_object_max_bytes": 1024})
        try:
            n = 100_000
            table = pa.table({"x": np.arange(n, dtype=np.int64)})
            ds = data.from_arrow(table, parallelism=4)
            assert ds.count() == n
            stats = ds.stats()
            out_bytes = sum(st["out_bytes"] for st in stats["stages"])
            # 8 bytes per int64 row, at least one stage accounted
            assert out_bytes >= n * 8
        finally:
            ray.shutdown()


class TestColumnarExchange:
    """The all-to-all tier stays Arrow end-to-end for repartition /
    random_shuffle / sort("col") — no row materialization (reference:
    block-level push-based shuffle)."""

    def _types_seen(self, ds):
        import pyarrow as pa
        seen = []

        def probe(batch):
            seen.append(type(batch))
            return batch
        out = ds.map_batches(probe, batch_format="default").take_all()
        return out, seen

    def test_repartition_stays_columnar(self):
        pa = pytest.importorskip("pyarrow")
        table = pa.table({"x": list(range(97))})
        ds = data.from_arrow(table, parallelism=3).repartition(5)
        out, seen = self._types_seen(ds)
        assert sorted(r["x"] for r in out) == list(range(97))
        assert seen and all(t is pa.Table for t in seen), seen

    def test_random_shuffle_stays_columnar(self):
        pa = pytest.importorskip("pyarrow")
        table = pa.table({"x": list(range(200))})
        ds = data.from_arrow(table, parallelism=4).random_shuffle(seed=7)
        out, seen = self._types_seen(ds)
        xs = [r["x"] for r in out]
        assert sorted(xs) == list(range(200))
        assert xs != list(range(200))  # actually shuffled
        assert seen and all(t is pa.Table for t in seen), seen

    def test_sort_by_column_stays_columnar(self):
        pa = pytest.importorskip("pyarrow")
        import random
        vals = list(range(150))
        random.Random(3).shuffle(vals)
        table = pa.table({"k": vals, "v": [x * 2 for x in vals]})
        ds = data.from_arrow(table, parallelism=5).sort("k")
        out, seen = self._types_seen(ds)
        assert [r["k"] for r in out] == list(range(150))
        assert [r["v"] for r in out] == [k * 2 for k in range(150)]
        assert seen and all(t is pa.Table for t in seen), seen

    def test_sort_by_column_descending(self):
        pa = pytest.importorskip("pyarrow")
        table = pa.table({"k": [3, 1, 4, 1, 5, 9, 2, 6]})
        got = data.from_arrow(table, parallelism=2).sort(
            "k", descending=True).take_all()
        assert [r["k"] for r in got] == sorted([3, 1, 4, 1, 5, 9, 2, 6],
                                               reverse=True)

    def test_string_sort_key_on_row_blocks(self):
        """Column-name keys also work for plain row datasets of dicts."""
        rows = [{"a": i % 7, "i": i} for i in range(30)]
        ds = data.from_items(rows).sort("a")
        got = ds.take_all()
        assert [r["a"] for r in got] == sorted(i % 7 for i in range(30))

    def test_groupby_callable_still_works_on_arrow(self):
        pa = pytest.importorskip("pyarrow")
        table = pa.table({"x": list(range(40))})
        ds = data.from_arrow(table, parallelism=2)
        counts = dict(ds.groupby(lambda r: r["x"] % 4).count().take_all())
        assert counts == {0: 10, 1: 10, 2: 10, 3: 10}

    def test_single_block_exchange(self):
        """num_out == 1: the one piece must arrive as the sub-block
        itself, not nested (regression: repartition(1) returned
        blocks-as-rows; sort on parallelism=1 crashed)."""
        got = data.from_items(list(range(6)), parallelism=3) \
            .repartition(1).take_all()
        assert got == list(range(6))
        got = data.from_items([{"a": 3}, {"a": 1}], parallelism=1) \
            .sort("a").take_all()
        assert [r["a"] for r in got] == [1, 3]
        pa = pytest.importorskip("pyarrow")
        got = data.from_arrow(pa.table({"k": [2, 1]}), parallelism=1) \
            .sort("k").take_all()
        assert [r["k"] for r in got] == [1, 2]

    def test_negative_shuffle_seed_columnar(self):
        """random.Random accepts negative seeds; the numpy generator on
        the columnar path must too (regression: ValueError)."""
        pa = pytest.importorskip("pyarrow")
        got = data.from_arrow(pa.table({"k": list(range(20))}),
                              parallelism=2) \
            .random_shuffle(seed=-1).take_all()
        assert sorted(r["k"] for r in got) == list(range(20))

    def test_groupby_named_aggregations_columnar(self):
        """groupby("col").count/sum/mean/min/max run columnar on Arrow
        blocks (hash partition by key column + pyarrow group_by) with
        the reference's output naming."""
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"g": [i % 4 for i in range(80)],
                      "v": [float(i) for i in range(80)]})
        ds = data.from_arrow(t, parallelism=4)
        got = sorted((r["g"], r["count()"]) for r in
                     ds.groupby("g").count().take_all())
        assert got == [(0, 20), (1, 20), (2, 20), (3, 20)]
        sums = {r["g"]: r["sum(v)"] for r in
                ds.groupby("g").sum("v").take_all()}
        expect = {g: float(sum(i for i in range(80) if i % 4 == g))
                  for g in range(4)}
        assert sums == expect
        means = {r["g"]: r["mean(v)"] for r in
                 ds.groupby("g").mean("v").take_all()}
        assert means == {g: expect[g] / 20 for g in range(4)}
        mins = {r["g"]: r["min(v)"] for r in
                ds.groupby("g").min("v").take_all()}
        assert mins == {0: 0.0, 1: 1.0, 2: 2.0, 3: 3.0}

    def test_groupby_named_aggs_row_blocks_same_schema(self):
        rows = [{"g": i % 3, "v": i} for i in range(30)]
        got = sorted((r["g"], r["sum(v)"]) for r in
                     data.from_items(rows, parallelism=3)
                     .groupby("g").sum("v").take_all())
        assert got == [(g, sum(i for i in range(30) if i % 3 == g))
                       for g in range(3)]

    def test_groupby_string_key_column(self):
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"g": ["x", "y"] * 15, "v": list(range(30))})
        got = sorted((r["g"], r["count()"]) for r in
                     data.from_arrow(t, parallelism=3)
                     .groupby("g").count().take_all())
        assert got == [("x", 15), ("y", 15)]

    def test_named_agg_requires_column_key(self):
        with pytest.raises(TypeError):
            data.from_items([1, 2]).groupby(lambda x: x).sum("v")

    def test_groupby_agg_null_handling(self):
        """None aggregation values skip (Arrow null semantics) and
        null-ish keys don't crash the row hash."""
        pa = pytest.importorskip("pyarrow")
        rows = [{"g": 1, "v": None}, {"g": 1, "v": 2},
                {"g": None, "v": 5}]
        got = {r["g"]: r["sum(v)"] for r in
               data.from_items(rows, parallelism=2)
               .groupby("g").sum("v").take_all()}
        assert got == {1: 2, None: 5}
        # arrow block with a null key: one group, nulls skipped in v
        t = pa.table({"g": [1, 1, None], "v": [None, 2, 5]})
        got = {r["g"]: r["sum(v)"] for r in
               data.from_arrow(t, parallelism=2)
               .groupby("g").sum("v").take_all()}
        assert got == {1: 2, None: 5}


# == tests/test_streaming_split.py =============================================

def _slow_ds(rt, n_rows=200, parallelism=20, sleep_s=0.01):
    from ray_tpu_torch import data

    def slow(b, _s=sleep_s):
        time.sleep(_s)
        return [x * 2 for x in b]

    return data.range(n_rows, parallelism=parallelism).map_batches(slow)


def _drain_concurrently(shards, collect=None):
    rows = [[] for _ in shards]
    errs = []

    def drain(i):
        try:
            for r in shards[i].iter_rows():
                rows[i].append(r)
        except BaseException as e:  # surfaced to the test, not swallowed
            errs.append(e)

    threads = [threading.Thread(target=drain, args=(i,))
               for i in range(len(shards))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    return rows


class TestStreamingSplit:
    def test_two_consumers_disjoint_cover_with_overlap(
            self, ray_start_tensor_sched):
        """THE tentpole claim: two consumers drain disjoint shards while
        upstream map tasks are still producing — proven by the op-stats
        overlap fraction, not by timing luck."""
        rt = ray_start_tensor_sched
        ds = _slow_ds(rt)
        shards = ds.streaming_split(2)
        rows = _drain_concurrently(shards)
        # disjoint cover: every row exactly once, split across both
        assert sorted(rows[0] + rows[1]) == [x * 2 for x in range(200)]
        assert rows[0] and rows[1]
        st = shards[0].stats()
        assert st["blocks_produced"] == 20
        assert st["blocks_consumed"] == 20
        # blocks were popped WHILE the producer still ran: with 20
        # blocks x 10ms through 4 workers the consumers provably
        # overlap production (0 would mean drain-after-the-fact)
        assert st["overlap_fraction"] > 0
        per = st["per_consumer"]
        assert sum(c["blocks_consumed"] for c in per) == 20
        assert all(c["bytes_consumed"] >= 0 for c in per)

    def test_equal_split_is_deterministic_round_robin(
            self, ray_start_tensor_sched):
        """equal=True routes block i to consumer i % n — the contract
        Train's rank sharding relies on (matches refs[rank::n])."""
        rt = ray_start_tensor_sched
        ds = _slow_ds(rt, n_rows=100, parallelism=10, sleep_s=0.002)
        shards = ds.streaming_split(2, equal=True)
        rows = _drain_concurrently(shards)
        # range(100) in 10 blocks of 10: consumer 0 gets even blocks
        expect0 = [x * 2 for b in range(0, 10, 2)
                   for x in range(b * 10, b * 10 + 10)]
        assert sorted(rows[0]) == expect0
        assert len(rows[1]) == 50

    def test_epoch_restart_replays_plan(self, ray_start_tensor_sched):
        """Re-iterating exhausted shards replays the lazy plan through
        a FRESH executor — same rows again, epoch counter advances."""
        rt = ray_start_tensor_sched
        ds = _slow_ds(rt, n_rows=60, parallelism=6, sleep_s=0.002)
        shards = ds.streaming_split(2, equal=True)
        first = _drain_concurrently(shards)
        second = _drain_concurrently(shards)
        want = [x * 2 for x in range(60)]
        assert sorted(first[0] + first[1]) == want
        assert sorted(second[0] + second[1]) == want
        assert shards[0].stats()["epoch"] == 2

    def test_dead_consumer_drains_back(self, ray_start_tensor_sched):
        """Elastic-train composition: a closed consumer's queue (and
        its future round-robin share) flows to the survivors instead of
        poisoning the run."""
        rt = ray_start_tensor_sched
        ds = _slow_ds(rt, n_rows=100, parallelism=10, sleep_s=0.002)
        shards = ds.streaming_split(2, equal=True)
        shards[1].close()
        got = sorted(shards[0].iter_rows())
        assert got == [x * 2 for x in range(100)]
        st = shards[0].stats()
        assert st["per_consumer"][1]["alive"] is False
        with pytest.raises(RuntimeError):
            next(iter(shards[1].iter_rows()))

    def test_per_consumer_backpressure_bounds_production(
            self, ray_start_tensor_sched):
        """A consumer that never pops caps production at its queue
        budget — the splitter must not buffer the whole dataset."""
        rt = ray_start_tensor_sched
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        q = GLOBAL_CONFIG.data_split_queue_blocks
        ds = _slow_ds(rt, n_rows=400, parallelism=40, sleep_s=0.001)
        shards = ds.streaming_split(2)
        coord = shards[0].coordinator
        # kick the producer without consuming: ask for one block only
        first = coord._pop(0)
        assert first is not None
        deadline = time.monotonic() + 5
        while (coord.stats()["producing"]
               and coord.stats()["blocks_produced"] < 2 * q + 2
               and time.monotonic() < deadline):
            time.sleep(0.05)
        st = coord.stats()
        # both lanes full + the one we popped; anything near 40 means
        # backpressure did nothing
        assert st["blocks_produced"] <= 2 * q + 2, st
        coord.shutdown()
        assert coord.stats()["live"] is False

    def test_streaming_split_validates_args(self, ray_start_tensor_sched):
        rt = ray_start_tensor_sched
        ds = _slow_ds(rt, n_rows=10, parallelism=2)
        with pytest.raises(ValueError):
            ds.streaming_split(0)
        with pytest.raises(ValueError):
            ds.streaming_split(2, locality_hints=["a"])

    def test_state_verb_and_recent_registry(self, ray_start_tensor_sched):
        """The registry behind util.state.list_data_streams surfaces live
        splits and keeps shut-down ones readable."""
        rt = ray_start_tensor_sched
        from ray_tpu_torch.util import state

        ds = _slow_ds(rt, n_rows=40, parallelism=4, sleep_s=0.002)
        shards = ds.streaming_split(2)
        _drain_concurrently(shards)
        live = state.list_data_streams()
        assert any(s["live"] and s["consumers"] == 2 for s in live)
        shards[0].coordinator.shutdown()
        done = state.list_data_streams()
        assert any(not s["live"] and s["blocks_consumed"] == 4
                   for s in done)


# == parity: the same seeded programs through ray_tpu and ray_tpu_torch =======

def _plain(v):
    """A comparable form that keeps the kind of every value: numpy
    scalars and arrays become (dtype, python value)."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    if isinstance(v, (np.ndarray, np.generic)):
        return (str(v.dtype), v.tolist())
    return v


def _ints(seed, n, hi=1000):
    return np.random.default_rng(seed).integers(0, hi, n)


def _rows(seed, n):
    g = np.random.default_rng(seed)
    return [{"k": int(k), "v": float(v)}
            for k, v in zip(g.integers(0, 7, n), g.standard_normal(n))]


PROGRAMS = {
    "map_batches": lambda ray_, data_, s: data_.from_items(
        _ints(s, 1000).tolist(), parallelism=10).map_batches(
            lambda b: [x * 3 + 1 for x in b], batch_size=32).take_all(),
    "map_batches_numpy": lambda ray_, data_, s: data_.from_numpy(
        _ints(s, 1000), parallelism=8).map_batches(
            lambda b: list(b * 2), batch_format="numpy").take_all(),
    "filter": lambda ray_, data_, s: data_.from_items(
        _ints(s, 1000).tolist(), parallelism=10).filter(
            lambda x: x % 3 == 0).take_all(),
    "random_shuffle": lambda ray_, data_, s: data_.from_items(
        _ints(s, 2000, 10 ** 6).tolist(), parallelism=16).random_shuffle(
            seed=s).take_all(),
    "random_shuffle_range": lambda ray_, data_, s: data_.range(
        5000, parallelism=50).random_shuffle(seed=s,
                                             num_blocks=7).take_all(),
    "sort": lambda ray_, data_, s: data_.from_items(
        _ints(s, 1000).tolist(), parallelism=10).sort().take_all(),
    "sort_key": lambda ray_, data_, s: data_.from_items(
        _rows(s, 500), parallelism=5).sort(key="v",
                                           descending=True).take_all(),
    "groupby_aggregate": lambda ray_, data_, s: sorted(data_.from_items(
        _rows(s, 600), parallelism=6).groupby("k")._named_agg(
            [("v", "sum"), ("v", "mean"), ("v", "std", 1),
             ("v", "count")]).take_all(), key=lambda r: r["k"]),
    "groupby_callable": lambda ray_, data_, s: sorted(data_.from_items(
        _ints(s, 800).tolist(), parallelism=8).groupby(
            lambda x: x % 5).aggregate(sum).take_all()),
    "join": lambda ray_, data_, s: sorted(data_.from_items(
        _rows(s, 200), parallelism=4).join(data_.from_items(
            [{"k": k, "w": k * 10} for k in (0, 2, 4, 9)], parallelism=2),
            on="k", how="left").take_all(),
        key=lambda r: (r["k"], r["v"])),
    "zip": lambda ray_, data_, s: data_.from_items(
        [{"a": x} for x in _ints(s, 300).tolist()], parallelism=3).zip(
            data_.from_items([{"b": x} for x in _ints(s + 1, 300).tolist()],
                             parallelism=5)).take_all(),
    "split": lambda ray_, data_, s: [p.take_all() for p in data_.from_items(
        _ints(s, 900).tolist(), parallelism=9).split(4)],
}


def _run_both(program, seed):
    """program(module, its data package, seed) through ray_tpu, then
    through ray_tpu_torch, each on a fresh 4-worker tensor runtime."""
    import ray_tpu
    from ray_tpu import data as ref_data

    ray.shutdown()
    ray_tpu.shutdown()
    ray_tpu.init(num_workers=4, scheduler="tensor")
    try:
        want = program(ray_tpu, ref_data, seed)
    finally:
        ray_tpu.shutdown()
    ray.init(num_workers=4, scheduler="tensor", _system_config=SYSTEM)
    try:
        got = program(ray, data, seed)
    finally:
        ray.shutdown()
    return _plain(got), _plain(want)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_outputs_equal_the_reference(name, seed):
    got, want = _run_both(PROGRAMS[name], seed)
    assert got == want


def test_arrow_shuffle_and_sort_equal_the_reference():
    """The columnar exchange (native PRP gathers, Arrow sort) on the
    same seeded table: the same rows in the same order."""
    pytest.importorskip("pyarrow")

    def program(ray_, data_, s):
        import pyarrow as pa

        g = np.random.default_rng(s)
        t = pa.table({"x": g.integers(0, 10 ** 6, 4000),
                      "f": g.standard_normal(4000)})
        shuffled = data_.from_arrow(t, parallelism=8).random_shuffle(
            seed=s).take_all()
        ordered = data_.from_arrow(t, parallelism=8).sort("x").take_all()
        return shuffled, ordered

    got, want = _run_both(program, 3)
    assert got == want


# == the port's own contracts =================================================

def test_import_needs_neither_pyarrow_nor_pandas():
    """`import ray_tpu_torch.data` and the list-block and numpy-block
    paths (map_batches, the PRP shuffle, sort, groupby, torch batches)
    work with pyarrow and pandas unimportable, as on the card's host."""
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import numpy as np, ray_tpu_torch as ray\n"
        "from ray_tpu_torch import data\n"
        "ray.init(num_workers=2, scheduler='tensor', "
        "_system_config={'sched_device': 'cpu'})\n"
        "assert data.range(1000, parallelism=10).map_batches("
        "lambda b: [x * 2 for x in b]).take_all() == "
        "[2 * i for i in range(1000)]\n"
        "s = data.range(1000, parallelism=10).random_shuffle(seed=0)"
        ".take_all()\n"
        "assert sorted(s) == list(range(1000)) and s != list(range(1000))\n"
        "assert data.from_items([3, 1, 2]).sort().take_all() == [1, 2, 3]\n"
        "assert dict(data.range(10).groupby(lambda x: x % 2).count()"
        ".take_all()) == {0: 5, 1: 5}\n"
        "col = np.arange(100, dtype=np.int64)\n"
        "tot = sum(int(b.sum()) for b in data.from_numpy(col)"
        ".iter_torch_batches(batch_size=16))\n"
        "assert tot == int(col.sum())\n"
        "ray.shutdown()\n"
        "assert 'pyarrow' not in [m.split('.')[0] for m, v in "
        "sys.modules.items() if v is not None]\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_iter_torch_batches_device_none_stays_on_the_host():
    """The reference's signature: device=None leaves host tensors (a
    loader's placement is its caller's choice); a named device moves
    every batch there."""
    import torch

    col = np.arange(10_000, dtype=np.int64)
    ds = data.from_numpy(col, parallelism=4)
    total = 0
    for b in ds.iter_torch_batches(batch_size=4096):
        assert b.device.type == "cpu" and b.dtype == torch.int64
        total += int(b.sum())
    assert total == int(col.sum())
    moved = list(ds.iter_torch_batches(batch_size=4096, device="meta"))
    assert len(moved) == 4   # batches do not cross the 4 blocks
    assert all(b.device.type == "meta" for b in moved)
    rows = data.from_items([{"x": np.int64(i)} for i in range(100)],
                           parallelism=1)
    got = list(rows.iter_torch_batches(batch_size=64))
    assert [b["x"].device.type for b in got] == ["cpu", "cpu"]


def test_data_knobs_match_the_reference():
    """The five Data knobs, with the reference's defaults."""
    from ray_tpu._private.config import GLOBAL_CONFIG as REF
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    for knob in ("data_op_inflight", "data_buffer_blocks",
                 "data_buffer_bytes", "data_split_queue_blocks",
                 "data_split_queue_bytes"):
        assert GLOBAL_CONFIG.get(knob) == REF.get(knob), knob


def test_map_batches_in_process_mode_keeps_workers_clean():
    """Module-scope remote functions of _streaming resolve in the
    workers, the user's lambda crosses by value, the count is exact and
    no worker loads jax, flax or ray_tpu."""
    ray.shutdown()
    ray.init(num_workers=2, scheduler="tensor",
             _system_config={**SYSTEM, "worker_mode": "process"})
    try:
        ds = data.range(20_000, parallelism=200).map_batches(
            lambda b: [x * 2 for x in b])
        assert ds.count() == 20_000
        assert ds.take_all() == [2 * i for i in range(20_000)]

        @ray.remote
        def mods():
            return os.getpid(), sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "ray_tpu"))

        got = ray.get([mods.remote() for _ in range(4)], timeout=60)
        assert all(pid != os.getpid() and not loaded
                   for pid, loaded in got), got
    finally:
        ray.shutdown()


def test_data_pipeline_throughput_is_baseline_config_3():
    """perf.data_pipeline_throughput on its own runtime (the device path's
    plain version): the reference's pipeline and stages, an exact count,
    and the timed run's device assigns counted."""
    from ray_tpu._private.perf import data_pipeline_throughput as ref_run
    from ray_tpu_torch._private.perf import data_pipeline_throughput

    ray.shutdown()
    got = data_pipeline_throughput(
        300, num_workers=4, system_config={"sched_backend": "cuda",
                                           "sched_device": "cpu"})
    want = ref_run(300, num_workers=4)
    assert not ray.is_initialized()
    assert got["count"] == got["rows"] == want["rows"] == 3000
    assert got["mode"] == "thread" and got["device_assigns"] > 0
    assert got["device_assign_errors"] == 0
    keys = ("name", "compute", "submitted", "completed")
    assert [{k: st[k] for k in keys} for st in got["stages"]] == \
        [{k: st[k] for k in keys} for st in want["stages"]]

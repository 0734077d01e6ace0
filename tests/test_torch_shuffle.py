"""The port's shuffle kernels (``ray_tpu_torch/data/_shuffle.py`` and its
own ``_native/exchange.cc``): the cases of ``tests/test_shuffle_kernels.py``
run on the port, and ``prp_indices`` / ``prp_take_table`` held bit-equal to
the reference's, on the native and the numpy paths, across drawn sizes.

The port's exchange library is built from ``ray_tpu_torch/_native/`` into
``ray_tpu_torch/_build/``; it never loads the reference's.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import ray_tpu_torch as ray
from ray_tpu_torch import data
from ray_tpu_torch.data._shuffle import (_keys, _prp_indices_numpy,
                                         prp_indices, prp_take_table)

SYSTEM = {"sched_device": "cpu"}


def _native():
    from ray_tpu_torch._native import load_exchange_lib

    lib = load_exchange_lib()
    if lib is None:
        pytest.skip("no g++: the native exchange library cannot be built")
    return lib


# -- tests/test_shuffle_kernels.py: TestPrpIndices ---------------------------

class TestPrpIndices:
    def test_bijection_odd_sizes(self):
        for n in (1, 2, 7, 200, 1000, 65537, 1 << 20):
            out = prp_indices(0, n, n, 42)
            assert np.array_equal(np.sort(out), np.arange(n)), n

    def test_slices_compose(self):
        n = 1000
        full = prp_indices(0, n, n, 9)
        parts = np.concatenate(
            [prp_indices(i * 100, (i + 1) * 100, n, 9) for i in range(10)])
        assert np.array_equal(full, parts)

    def test_native_matches_numpy(self):
        _native()
        for n, seed in ((999, 3), (4096, 17), (100_000, 5)):
            native = prp_indices(0, n, n, seed)
            fallback = _prp_indices_numpy(0, n, n, _keys(seed, n))
            assert np.array_equal(native, fallback), (n, seed)

    def test_shuffle_quality(self):
        """Displacement ~n/3 and negligible serial correlation — the
        statistical profile of a uniform permutation."""
        n = 100_000
        p = prp_indices(0, n, n, 1)
        disp = np.abs(p - np.arange(n)).mean() / n
        assert 0.30 < disp < 0.37, disp
        corr = np.corrcoef(p[:-1], p[1:])[0, 1]
        assert abs(corr) < 0.01, corr

    def test_seeds_differ(self):
        n = 10_000
        assert not np.array_equal(prp_indices(0, n, n, 1),
                                  prp_indices(0, n, n, 2))


# -- tests/test_shuffle_kernels.py: TestPrpTakeTable --------------------------

class TestPrpTakeTable:
    def test_row_alignment_across_column_paths(self):
        """Numeric columns ride the native gather, strings the Arrow
        take — the SAME permutation must apply to both."""
        pa = pytest.importorskip("pyarrow")
        n = 50_000
        t = pa.table({"x": np.arange(n, dtype=np.int64),
                      "f": np.arange(n, dtype=np.float32),
                      "s": pa.array([str(i) for i in range(n)])})
        out = prp_take_table(t, 0, n, n, 5)
        xs = out.column("x").to_numpy()
        assert np.array_equal(np.sort(xs), np.arange(n))
        assert np.array_equal(out.column("f").to_numpy().astype(np.int64),
                              xs)
        for i in range(0, n, 7919):
            assert out.column("s")[i].as_py() == str(xs[i])

    def test_chunked_equals_contiguous(self):
        pa = pytest.importorskip("pyarrow")
        n = 40_000
        t = pa.table({"x": np.arange(n, dtype=np.int64)})
        chunked = pa.concat_tables(
            [t.slice(i * 5000, 5000) for i in range(8)])
        assert prp_take_table(chunked, 0, n, n, 3).equals(
            prp_take_table(t, 0, n, n, 3))

    def test_nulls_fall_back_and_align(self):
        pa = pytest.importorskip("pyarrow")
        n = 10_000
        xs = np.arange(n, dtype=np.int64)
        with_nulls = pa.array(
            [None if i % 97 == 0 else int(i) for i in range(n)])
        t = pa.table({"x": pa.array(xs), "y": with_nulls})
        out = prp_take_table(t, 0, n, n, 11)
        ox = out.column("x").to_numpy()
        for i in range(0, n, 997):
            y = out.column("y")[i].as_py()
            assert y is None and ox[i] % 97 == 0 or y == ox[i]


# -- bit-equality with the reference -----------------------------------------

def _ref_numpy_path(monkeypatch):
    """The reference's _shuffle with its native library hidden."""
    from ray_tpu.data import _shuffle as ref

    monkeypatch.setattr(ref, "_lib", lambda: None)
    return ref


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 1 << 20), seed=st.integers(0, 2 ** 31 - 1),
       data_=st.data())
def test_prp_indices_bit_equal_to_the_reference_native_path(n, seed, data_):
    """Native against native: the port's exchange.cc and the reference's
    give the same sigma([lo, hi)) to the bit for any domain and slice."""
    from ray_tpu.data import _shuffle as ref

    _native()
    if ref._lib() is None:
        pytest.skip("the reference's native exchange library is missing")
    lo = data_.draw(st.integers(0, n - 1))
    hi = data_.draw(st.integers(lo, n))
    got = prp_indices(lo, hi, n, seed)
    assert got.dtype == np.int64
    assert np.array_equal(got, ref.prp_indices(lo, hi, n, seed))


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 1 << 20), seed=st.integers(0, 2 ** 31 - 1),
       data_=st.data())
def test_prp_indices_bit_equal_to_the_reference_numpy_path(n, seed, data_):
    """The numpy PRP of both packages, and the port's native one against
    the reference's numpy one: one permutation everywhere."""
    from ray_tpu.data import _shuffle as ref

    lo = data_.draw(st.integers(0, n - 1))
    hi = data_.draw(st.integers(lo, n))
    want = ref._prp_indices_numpy(lo, hi, n, ref._keys(seed, n))
    assert np.array_equal(_keys(seed, n), ref._keys(seed, n))
    assert np.array_equal(_prp_indices_numpy(lo, hi, n, _keys(seed, n)),
                          want)
    assert np.array_equal(prp_indices(lo, hi, n, seed), want)


@settings(max_examples=15, deadline=None)
@given(n=st.integers(1, 20_000), seed=st.integers(0, 2 ** 31 - 1),
       chunks=st.integers(1, 5), data_=st.data())
def test_prp_take_table_equal_to_the_reference(n, seed, chunks, data_):
    """Arrow gathers (native numeric columns, Arrow take for strings and
    nulls), chunked or not, against the reference's on both paths."""
    pa = pytest.importorskip("pyarrow")
    from ray_tpu.data import _shuffle as ref

    lo = data_.draw(st.integers(0, n - 1))
    hi = data_.draw(st.integers(lo, n))
    xs = np.random.default_rng(seed).integers(-2 ** 40, 2 ** 40, n)
    t = pa.table({"x": xs, "f": xs.astype(np.float32),
                  "s": pa.array([str(v) for v in xs[:n]]),
                  "y": pa.array([None if v % 7 == 0 else int(v)
                                 for v in xs])})
    step = -(-n // chunks)
    t = pa.concat_tables([t.slice(i, step) for i in range(0, n, step)])
    got = prp_take_table(t, lo, hi, n, seed)
    assert got.equals(ref.prp_take_table(t, lo, hi, n, seed))


def test_numpy_paths_equal_with_the_libraries_hidden(monkeypatch):
    """Both packages on their numpy PRP alone (no native library)."""
    from ray_tpu_torch.data import _shuffle as port

    ref = _ref_numpy_path(monkeypatch)
    monkeypatch.setattr(port, "_lib", lambda: None)
    for n, seed in ((1, 0), (999, 3), (65537, 17), (200_000, 5)):
        assert np.array_equal(port.prp_indices(0, n, n, seed),
                              ref.prp_indices(0, n, n, seed)), n


def test_numpy_prp_refuses_domains_above_2_32_rows():
    """The uint32 rounds stop being a bijection past 2^32; the numpy PRP
    refuses such a domain (the native path runs 64-bit state)."""
    with pytest.raises(ValueError, match="2\\^32"):
        _prp_indices_numpy(0, 4, (1 << 32) + 1, _keys(0, 5))
    assert len(_prp_indices_numpy(0, 4, 1 << 32, _keys(0, 1 << 32))) == 4


def test_the_port_loads_its_own_exchange_library():
    """Built from ray_tpu_torch/_native/exchange.cc into the port's build
    directory; the reference's .so is never loaded."""
    import ray_tpu_torch._native as nat

    lib = _native()
    path = str(nat.target("exchange"))
    assert lib._name == path
    assert "/ray_tpu_torch/_build/native_exchange-" in path


# -- tests/test_shuffle_kernels.py: the exchange through Data -----------------

@pytest.fixture(scope="module")
def rt():
    ray.shutdown()
    ray.init(num_workers=2, scheduler="tensor", _system_config=SYSTEM)
    yield ray
    ray.shutdown()


class TestShuffleSemantics:
    def test_shuffle_deterministic_per_seed(self, rt):
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"x": list(range(500))})
        a = [r["x"] for r in data.from_arrow(t, parallelism=4)
             .random_shuffle(seed=3).take_all()]
        b = [r["x"] for r in data.from_arrow(t, parallelism=4)
             .random_shuffle(seed=3).take_all()]
        c = [r["x"] for r in data.from_arrow(t, parallelism=4)
             .random_shuffle(seed=4).take_all()]
        assert a == b
        assert a != c
        assert sorted(a) == list(range(500)) == sorted(c)

    def test_shuffle_num_blocks(self, rt):
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"x": list(range(300))})
        mds = (data.from_arrow(t, parallelism=6)
               .random_shuffle(seed=1, num_blocks=3).materialize())
        assert mds.num_blocks() == 3

    def test_repartition_multiset_and_balance(self, rt):
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"x": list(range(1000))})
        mds = data.from_arrow(t, parallelism=7).repartition(4).materialize()
        assert mds.num_blocks() == 4
        sizes = [len(ray.get(r)) for r in mds.block_refs]
        assert sum(sizes) == 1000
        assert max(sizes) - min(sizes) <= 1  # contiguous range split

    def test_shuffle_mixes_across_blocks(self, rt):
        """Every output block must contain rows from several input
        blocks (stage B interleaving)."""
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"x": list(range(1600))})
        mds = (data.from_arrow(t, parallelism=8)
               .random_shuffle(seed=2).materialize())
        for ref in mds.block_refs:
            xs = ray.get(ref).column("x").to_pylist()
            src_blocks = {x // 200 for x in xs}
            assert len(src_blocks) >= 6, src_blocks


class TestCallableKeyGroupbyColumnar:
    """A lambda groupby key must not silently drop the exchange to
    Python-object rows — the key evaluates once per row into a COLUMN,
    and partitioning/grouping stay columnar."""

    def test_callable_key_takes_columnar_path(self, rt):
        pa = pytest.importorskip("pyarrow")
        from ray_tpu_torch.data import _streaming as st_

        before = st_._GROUPBY_COLUMNAR_PARTITIONS
        t = pa.table({"x": list(range(400)), "s": ["v"] * 400})
        counts = dict(data.from_arrow(t, parallelism=4)
                      .groupby(lambda r: r["x"] % 5).count().take_all())
        assert counts == {k: 80 for k in range(5)}
        # thread mode: partition tasks run in-process, so the counter
        # is visible — every partition must have gone columnar
        assert st_._GROUPBY_COLUMNAR_PARTITIONS - before >= 4

    def test_callable_key_string_keys_columnar(self, rt):
        pa = pytest.importorskip("pyarrow")
        from ray_tpu_torch.data import _streaming as st_

        before = st_._GROUPBY_COLUMNAR_PARTITIONS
        t = pa.table({"name": ["alpha", "beta", "gamma"] * 40})
        counts = dict(data.from_arrow(t, parallelism=3)
                      .groupby(lambda r: r["name"]).count().take_all())
        assert counts == {"alpha": 40, "beta": 40, "gamma": 40}
        assert st_._GROUPBY_COLUMNAR_PARTITIONS - before >= 3

    def test_rows_do_not_see_key_column(self, rt):
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"x": list(range(60))})
        out = dict(data.from_arrow(t, parallelism=2)
                   .groupby(lambda r: r["x"] % 2)
                   .map_groups(lambda k, rows: (k, sorted(rows[0].keys())))
                   .take_all())
        assert out == {0: ["x"], 1: ["x"]}

    def test_empty_blocks_do_not_poison_schema(self, rt):
        """Empty upstream blocks infer null-typed key columns; the
        reducer must not crash concatenating them with typed pieces."""
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"x": list(range(10))})
        # parallelism > rows after a repartition leaves empty blocks
        out = dict(data.from_arrow(t, parallelism=2).repartition(6)
                   .groupby(lambda r: r["x"] % 2).count().take_all())
        assert out == {0: 5, 1: 5}

    def test_none_keys_form_one_group(self, rt):
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"x": list(range(12))})
        out = dict(data.from_arrow(t, parallelism=2)
                   .groupby(lambda r: r["x"] % 3 if r["x"] < 6 else None)
                   .count().take_all())
        assert out == {0: 2, 1: 2, 2: 2, None: 6}

    def test_limit_before_exchange_counts_real_blocks(self, rt):
        mds = (data.range(1000, parallelism=64).limit(10)
               .repartition(2).materialize())
        assert mds.num_blocks() == 2
        assert sorted(mds.take_all()) == list(range(10))

    def test_non_primitive_keys_fall_back(self, rt):
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"x": list(range(40))})
        counts = dict(data.from_arrow(t, parallelism=2)
                      .groupby(lambda r: (r["x"] % 2, "t")).count()
                      .take_all())
        assert counts == {(0, "t"): 20, (1, "t"): 20}

    def test_string_column_groupby_agg_columnar(self, rt):
        """String key COLUMNS also partition vectorized (uniques hashed
        once, routing broadcast through dictionary indices)."""
        pa = pytest.importorskip("pyarrow")
        t = pa.table({"k": ["a", "b", "c", None] * 25,
                      "v": list(range(100))})
        out = data.from_arrow(t, parallelism=4).groupby("k").sum("v")
        got = {r["k"]: r["sum(v)"] for r in out.take_all()}
        expect: dict = {}
        for i, k in enumerate(["a", "b", "c", None] * 25):
            expect[k] = expect.get(k, 0) + i
        assert got == expect


def test_list_and_numpy_blocks_shuffle_without_arrow(rt, monkeypatch):
    """The chip phase's shuffle: list blocks and numpy-dict blocks go
    through the PRP exchange with pyarrow unimportable; the rows are a
    permutation, and the same seed gives the same order."""
    import sys

    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pandas", None)
    a = data.range(2000, parallelism=20).random_shuffle(seed=0).take_all()
    b = data.range(2000, parallelism=20).random_shuffle(seed=0).take_all()
    assert a == b and a != list(range(2000))
    assert sorted(a) == list(range(2000))
    col = np.arange(3000, dtype=np.int64)
    rows = data.from_numpy(col, parallelism=10).random_shuffle(
        seed=1).take_all()
    got = sorted(int(r["data"]) if isinstance(r, dict) else int(r)
                 for r in rows)
    assert got == list(range(3000))

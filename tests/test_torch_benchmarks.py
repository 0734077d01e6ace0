"""ray_tpu_torch._private.benchmarks against ray_tpu._private.benchmarks,
on the CPU.

The copied graph builders give the reference's arrays, array for array;
``device_state`` gives ``_device_state``'s arrays without mutating the
graph; the port's plain drive (what the CUDA drive is held against on the
card) gives ``jax_drive``'s tick count and final state, indegrees, avail
and consumed flags on the smoke sizes of ``run_all`` and on the full
north-star graphs (1 and 64 ticks); ``run_graph`` and ``run_all`` run the
plain drive with ``device="cpu"`` and refuse a graph that does not
complete.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from ray_tpu._private import benchmarks as RB  # noqa: E402
from ray_tpu._private.scheduler import kernels as ref  # noqa: E402
from ray_tpu_torch._private import benchmarks as PB  # noqa: E402

SMOKE = {
    "fanout": (1000, 8),
    "map_reduce": (2020, 100, 8),
    "pipeline": (3, 500, 8),
    "actor_heavy": (50, 20, 8),
    "ppo": (200, 10, 3, 4),
    "north_star": (10_000, 8),
    "north_star_waves": (4096, 16, 8),
}
FIELDS = [f.name for f in dataclasses.fields(RB.BenchGraph)]


def _same_graph(a, b):
    assert [f.name for f in dataclasses.fields(PB.BenchGraph)] == FIELDS
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


def test_configs_are_the_reference_configs():
    assert list(PB.CONFIGS) == list(RB.CONFIGS)


@pytest.mark.parametrize("name", list(RB.CONFIGS))
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_builder_equals_the_reference(name, size):
    args = SMOKE[name] if size == "smoke" else ()
    _same_graph(PB.CONFIGS[name](*args), RB.CONFIGS[name](*args))


def test_device_state_sorts_like_the_reference_and_mutates_nothing():
    g = PB.build_map_reduce(2020, 100, 8)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(g.src))
    g.src, g.dst = g.src[perm], g.dst[perm]     # unsorted dst
    src0, dst0 = g.src.copy(), g.dst.copy()
    rg = RB.BenchGraph(**{f: getattr(g, f) for f in FIELDS})
    got = PB.device_state(g, "cpu")
    want = RB._device_state(rg)
    np.testing.assert_array_equal(g.src, src0)
    np.testing.assert_array_equal(g.dst, dst0)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype


def test_device_state_refuses_edges_outside_the_graph():
    g = PB.build_pipeline(2, 10, 2)
    g.dst = g.dst + 100
    with pytest.raises(ValueError, match="edge ends"):
        PB.device_state(g, "cpu")


def _drive_both(g, threshold=0.99):
    st = PB.device_state(g, "cpu")
    want = ref.jax_drive(*(np.asarray(x.numpy()) for x in st),
                         num_classes=len(g.demands), threshold=threshold,
                         max_ticks=g.max_ticks, donate=False)
    got = PB.kernels.drive(*st, threshold=threshold, max_ticks=g.max_ticks)
    for name, a, b in zip(("state", "indeg", "avail", "consumed", "ticks"),
                          got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("name", list(SMOKE))
def test_plain_drive_matches_jax_drive_at_smoke_size(name):
    got = _drive_both(PB.CONFIGS[name](*SMOKE[name]))
    assert (got[0].numpy() == PB.DONE).all()


@pytest.mark.parametrize("name, ticks", [("north_star", 1),
                                         ("north_star_waves", 64)])
def test_plain_drive_matches_jax_drive_at_north_star_size(name, ticks):
    g = PB.CONFIGS[name]()
    assert len(g.indeg) == 1_000_000
    got = _drive_both(g)
    assert int(got[4]) == ticks
    assert (got[0].numpy() == PB.DONE).all()
    np.testing.assert_array_equal(got[2].numpy(), g.cap)


@pytest.mark.parametrize("name, ticks", [
    ("fanout", 1), ("map_reduce", 2), ("pipeline", 3), ("actor_heavy", 2),
    ("ppo", 6), ("north_star", 1), ("north_star_waves", 16)])
def test_run_graph_on_the_cpu(name, ticks):
    r = PB.run_graph(PB.CONFIGS[name](*SMOKE[name]), device="cpu",
                     repeats=1)
    assert r["ticks"] == ticks and r["device"] == "cpu"
    assert r["tasks"] == len(PB.CONFIGS[name](*SMOKE[name]).indeg)
    assert r["scheduling_ms"] > 0 and r["tasks_per_sec"] > 0


def test_run_graph_refuses_an_incomplete_drive():
    g = PB.build_pipeline(3, 50, 4)
    g.max_ticks = 2
    with pytest.raises(RuntimeError, match="did not complete"):
        PB.run_graph(g, device="cpu", repeats=1)


def test_run_all_smoke_on_the_cpu():
    out = PB.run_all("smoke", device="cpu")
    assert list(out) == ["fanout_1000", "map_reduce_2020", "pipeline_3x500",
                         "actor_50x20", "ppo_3r", "north_star_fanout_10000"]
    assert [r["ticks"] for r in out.values()] == [1, 2, 3, 2, 6, 1]

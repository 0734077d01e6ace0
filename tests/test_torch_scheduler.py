"""ray_tpu_torch._private.scheduler.kernels against
ray_tpu._private.scheduler.kernels, on the CPU.

The same seeded numpy inputs go to the reference's numpy oracles and jitted
device path (``jax_assign``, ``jax_tick``, ``jax_drive``, ``jax_bench``,
``jax_pack_many``, ``jax_pack_many_tiered``) and to the port's dispatchers
on CPU tensors, where they run the plain PyTorch versions that the CUDA
kernels are held against on the card. Integer outputs (node per task,
state, indegree, consumed, ok, tick counts) must be equal; avail too, to
the bit, where demands are dyadic (0.25, 0.5, 1, 2), else within
atol 1e-4 as the reference's own tests hold it. The cases mirror
tests/test_tensor_scheduler.py (TestAssignKernelNp, TestEdgeFireNp,
TestJaxTickParity, TestManyClasses) and
tests/test_placement_group.py::test_jax_pack_many_matches_feasibility,
plus the edge cases of the reference's tick: dead nodes, all-zero demand,
t0 forced to 0, classes with no members, FREE rows.
"""

import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from ray_tpu._private.scheduler import kernels as ref  # noqa: E402
from ray_tpu_torch._private.scheduler import kernels as port  # noqa: E402
from ray_tpu_torch._private.scheduler.kernels import (  # noqa: E402
    DONE, FREE, RUNNING, WAITING)

DYADIC = np.asarray([0, 0.25, 0.5, 1, 2], dtype=np.float32)
TICK_OUTPUTS = ("state", "indeg", "avail", "node_of", "consumed")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_equal(got, want, names):
    for name, a, b in zip(names, got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def _assign_both(cls, demands, avail, cap, threshold, mask=None,
                 spread=None):
    want = ref.jax_assign(cls, demands, avail.copy(), cap, threshold, mask,
                          spread)
    got = port.assign(cls, demands, avail.copy(), cap, threshold, mask,
                      spread, device="cpu")
    _assert_equal(got, want, ("node_of", "avail"))
    return got


def _graph_args(state, indeg, cls, pin, demands, avail, cap, src, dst,
                consumed):
    return [_t(x) for x in (state, indeg, cls, pin, demands, avail, cap,
                            src, dst, consumed)]


def _tick_both(args, threshold, instant):
    """One tick of each on the same inputs; returns the port's outputs
    as numpy after checking them equal to jax_tick's."""
    state, indeg, cls, pin, demands, avail, cap, src, dst, consumed = args
    want = ref.jax_tick(state, indeg, cls, pin, demands, avail, cap, src,
                        dst, consumed, num_classes=len(demands),
                        threshold=threshold, instant_completion=instant)
    got = port.tick(*_graph_args(*args), threshold=threshold,
                    instant_completion=instant)
    _assert_equal(got, want, TICK_OUTPUTS)
    return [x.numpy() for x in got]


def _step_both(args, threshold, instant, ticks):
    """Step both ticks from the same state, comparing every output after
    each tick; returns the last state."""
    args = list(args)
    for _ in range(ticks):
        state, indeg, avail, _node_of, consumed = _tick_both(args, threshold,
                                                             instant)
        args[0], args[1], args[5], args[9] = state, indeg, avail, consumed
    return args


def _random_dag(rng, C, E, K, N, pins=0.1, free=0.05, running=0.03):
    src = rng.integers(0, C - 1, size=E).astype(np.int32)
    dst = (src + rng.integers(1, 16, size=E)).clip(max=C - 1).astype(
        np.int32)
    keep = src < dst
    src, dst = src[keep], dst[keep]
    order = np.argsort(dst, kind="stable")   # the reference needs it
    src, dst = src[order], dst[order]
    indeg = np.zeros(C, dtype=np.int32)
    np.add.at(indeg, dst, 1)
    cls = rng.integers(0, K, size=C).astype(np.int32)
    pin = np.where(rng.random(C) < pins, rng.integers(0, N, size=C),
                   -1).astype(np.int32)
    state = np.full(C, WAITING, dtype=np.int8)
    state[rng.random(C) < free] = FREE
    state[rng.random(C) < running] = RUNNING
    demands = rng.choice(DYADIC, size=(K, 4)).astype(np.float32)
    cap = rng.choice(np.asarray([0, 2, 4, 8, 32], np.float32),
                     size=(N, 4)).astype(np.float32)
    return [state, indeg, cls, pin, demands, cap.copy(), cap, src, dst,
            np.zeros(len(src), dtype=bool)]


# ----------------------------------------------------------------------
# the numpy oracles are the reference's, verbatim
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["assign_np", "fire_edges_np",
                                  "pack_bundles_np", "pack_gangs_tiered_np"])
def test_numpy_oracle_is_the_reference_verbatim(name):
    assert inspect.getsource(getattr(port, name)) == \
        inspect.getsource(getattr(ref, name))


def test_state_constants():
    assert (FREE, WAITING, RUNNING, DONE) == (ref.FREE, ref.WAITING,
                                              ref.RUNNING, ref.DONE)


# ----------------------------------------------------------------------
# TestAssignKernelNp's cases through assign (plain) and jax_assign
# ----------------------------------------------------------------------

def _rows(*rows):
    return np.asarray(rows, dtype=np.float32)


ASSIGN_CASES = {
    "fills_local_then_spills": (
        _rows([1, 0, 0, 0]), _rows([4, 0, 0, 0], [4, 0, 0, 0]),
        np.zeros(6, np.int32), 0.5),
    "oversubscription_defers": (
        _rows([1, 0, 0, 0]), _rows([3, 0, 0, 0]), np.zeros(10, np.int32),
        0.5),
    "infeasible_never_assigned": (
        _rows([8, 0, 0, 0]), _rows([4, 0, 0, 0]), np.zeros(2, np.int32),
        0.5),
    "zero_demand_tasks_all_run": (
        _rows([0, 0, 0, 0]), _rows([1, 0, 0, 0]), np.zeros(100, np.int32),
        0.5),
    "multi_class": (
        _rows([1, 0, 0, 0], [0, 1, 0, 0]), _rows([2, 1, 0, 0]),
        np.asarray([0, 0, 1, 1], np.int32), 1.1),
}


@pytest.mark.parametrize("case", sorted(ASSIGN_CASES))
def test_assign_matches_jax_assign(case):
    demands, cap, ready_cls, threshold = ASSIGN_CASES[case]
    node_of, avail = _assign_both(ready_cls, demands, cap.copy(), cap,
                                  threshold)
    if case == "fills_local_then_spills":
        counts = np.bincount(node_of, minlength=2)
        assert (node_of >= 0).all() and counts[0] >= 2
        assert (counts <= 4).all()
    elif case == "oversubscription_defers":
        assert (node_of >= 0).sum() == 3 and avail[0, 0] == 0
    elif case == "infeasible_never_assigned":
        assert (node_of == -1).all()
    elif case == "zero_demand_tasks_all_run":
        assert (node_of >= 0).all()
    else:
        assert (node_of[:2] >= 0).all() and (node_of[2:] >= 0).sum() == 1
        assert avail[0, 0] == 0 and avail[0, 1] == 0


@pytest.mark.parametrize("seed", range(4))
def test_assign_random_matches_both_references(seed):
    """Random multi-class batches, uneven starting loads: the plain
    assign equals jax_assign per task and in avail; assign_np agrees on
    how many tasks each class placed."""
    rng = np.random.default_rng(seed)
    K, N, C = int(rng.integers(1, 6)), int(rng.integers(1, 9)), \
        int(rng.integers(1, 300))
    demands = rng.choice(DYADIC, size=(K, 4)).astype(np.float32)
    cap = rng.choice(np.asarray([0, 2, 8, 32], np.float32),
                     size=(N, 4)).astype(np.float32)
    avail = np.maximum(cap - rng.choice(DYADIC, size=(N, 4)), 0).astype(
        np.float32)
    cls = rng.integers(0, K, size=C).astype(np.int32)
    node_of, _ = _assign_both(cls, demands, avail, cap, 0.5)
    node_np, _ = ref.assign_np(np.arange(C), cls, demands, avail.copy(),
                               cap, 0.5)
    for c in range(K):
        assert (node_of[cls == c] >= 0).sum() == (node_np[cls == c] >= 0).sum()


def test_assign_non_dyadic_demands():
    """Demands that f32 cannot hold exactly: node per task equal, avail
    within the reference tests' atol."""
    rng = np.random.default_rng(5)
    demands = np.asarray([[0.3, 0, 0, 0], [1.1, 0.7, 0, 0]], np.float32)
    cap = rng.integers(1, 9, size=(6, 4)).astype(np.float32)
    cls = rng.integers(0, 2, size=200).astype(np.int32)
    want = ref.jax_assign(cls, demands, cap.copy(), cap, 0.5)
    got = port.assign(cls, demands, cap.copy(), cap, 0.5, device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=1e-4)


def test_assign_empty_batch():
    cap = _rows([4, 0, 0, 0])
    node_of, avail = port.assign(np.zeros(0, np.int32), _rows([1, 0, 0, 0]),
                                 cap.copy(), cap, 0.5, device="cpu")
    assert node_of.shape == (0,)
    np.testing.assert_array_equal(avail, cap)


# ----------------------------------------------------------------------
# TestManyClasses: 64 classes, and SPREAD per task
# ----------------------------------------------------------------------

def test_64_classes_match_jax_and_numpy():
    rng = np.random.default_rng(7)
    K, C, N = 64, 512, 8
    demands = np.zeros((K, 4), dtype=np.float32)
    demands[:, 0] = rng.integers(1, 4, size=K)
    cls = rng.integers(0, K, size=C).astype(np.int32)
    cap = np.zeros((N, 4), dtype=np.float32)
    cap[:, 0] = rng.integers(16, 64, size=N)
    node_of, avail = _assign_both(cls, demands, cap.copy(), cap, 0.5)
    node_np, avail_np = ref.assign_np(np.arange(C), cls, demands,
                                      cap.copy(), cap, 0.5)
    np.testing.assert_array_equal(node_of, node_np)
    np.testing.assert_allclose(avail, avail_np, atol=1e-4)


@pytest.mark.parametrize("trial", range(6))
def test_spread_matches_jax_per_task(trial):
    """SPREAD's water-fill: the same node per task as jax_assign (and the
    same per-node counts as the numpy round-robin)."""
    rng = np.random.default_rng(11 + trial)
    N, C = int(rng.integers(2, 9)), int(rng.integers(1, 64))
    demands = np.asarray([[1, 0, 0, 0]], dtype=np.float32)
    cls = np.zeros(C, dtype=np.int32)
    cap = np.zeros((N, 4), dtype=np.float32)
    cap[:, 0] = rng.integers(1, 32, size=N)
    avail = cap.copy()
    avail[:, 0] = np.maximum(avail[:, 0] - rng.integers(0, 2, size=N), 0)
    spread = np.ones(1, dtype=bool)
    node_of, _ = _assign_both(cls, demands, avail, cap, 0.5,
                              spread=spread)
    node_np, _ = ref.assign_np(np.arange(C), cls, demands, avail.copy(),
                               cap, 0.5, class_spread=spread)
    np.testing.assert_array_equal(
        np.bincount(node_of[node_of >= 0], minlength=N),
        np.bincount(node_np[node_np >= 0], minlength=N))


@pytest.mark.parametrize("seed", range(4))
def test_masks_and_spread_classes_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    K, N, C = 12, 16, 700
    demands = rng.choice(DYADIC, size=(K, 4)).astype(np.float32)
    cap = rng.choice(np.asarray([0, 4, 16, 64], np.float32),
                     size=(N, 4)).astype(np.float32)
    cls = rng.integers(0, K, size=C).astype(np.int32)
    _assign_both(cls, demands, cap.copy(), cap, 0.5,
                 mask=rng.random((K, N)) < 0.7, spread=rng.random(K) < 0.5)


# ----------------------------------------------------------------------
# the reference tick's edge cases, through assign and both ticks
# ----------------------------------------------------------------------

def _edge_case(name):
    """(state, indeg, cls, pin, demands, avail, cap, src, dst, consumed,
    class_spread or None) for one edge case."""
    C = 40
    cls = np.zeros(C, np.int32)
    state = np.full(C, WAITING, np.int8)
    demands = _rows([1, 0, 0, 0])
    cap = np.tile(_rows([8, 2, 0, 0]), (4, 1))
    spread = None
    if name == "dead_nodes":          # zero capacity takes nothing
        demands = _rows([1, 0, 0, 0], [0, 0, 0, 0])
        cls[::2] = 1
        cap[1] = 0
        cap[3] = 0
    elif name == "all_zero_demand":   # fit = batch, t0 = k on node 0
        demands = _rows([0, 0, 0, 0])
    elif name == "dead_node0":        # t0 forced to 0
        demands = _rows([1, 0, 0, 0], [0, 0, 0, 0])
        cls[1::3] = 1
        cap[0] = 0
    elif name == "spread_t0":         # t0 forced to 0 for SPREAD
        spread = np.ones(1, bool)
    elif name == "empty_classes":     # classes 1 and 2 have no members
        demands = _rows([1, 0, 0, 0], [2, 0, 0, 0], [4, 0, 0, 0],
                        [0.5, 1, 0, 0])
        cls[::2] = 3
    elif name == "free_rows":         # FREE rows are never ready
        state[::3] = FREE
    elif name == "node0_loaded":      # node 0 at the threshold
        pass
    elif name == "class_out_of_range":
        cls[::4] = 5
    avail = cap.copy()
    if name == "node0_loaded":
        avail[0, 0] = 0.0
    return [state, np.zeros(C, np.int32), cls, np.full(C, -1, np.int32),
            demands, avail, cap, np.zeros(0, np.int32),
            np.zeros(0, np.int32), np.zeros(0, bool)], spread


EDGE_CASES = ("dead_nodes", "all_zero_demand", "dead_node0", "spread_t0",
              "empty_classes", "free_rows", "node0_loaded",
              "class_out_of_range")


@pytest.mark.parametrize("instant", [False, True])
@pytest.mark.parametrize("name", [n for n in EDGE_CASES if n != "spread_t0"])
def test_tick_edge_case(name, instant):
    args, _spread = _edge_case(name)
    state, _indeg, avail, node_of, _c = _tick_both(args, 0.99, instant)
    if name == "dead_nodes":
        assert not np.isin(node_of, [1, 3]).any()
    if name == "dead_node0":
        assert (node_of != 0).all()
    if name == "free_rows":
        assert (state[::3] == FREE).all()
    if name == "class_out_of_range":
        assert (state[::4] == WAITING).all()


@pytest.mark.parametrize("name", [n for n in EDGE_CASES
                                  if n not in ("free_rows",
                                               "class_out_of_range")])
def test_assign_edge_case(name):
    args, spread = _edge_case(name)
    cls, demands, avail, cap = args[2], args[4], args[5], args[6]
    node_of, _ = _assign_both(cls, demands, avail, cap, 0.99,
                              spread=spread)
    if name == "all_zero_demand":
        assert (node_of == 0).all()      # t0 = k: all on node 0
    if name == "spread_t0":
        assert set(node_of[node_of >= 0].tolist()) == {0, 1, 2, 3}


# ----------------------------------------------------------------------
# TestEdgeFireNp, and the tick's edge wave
# ----------------------------------------------------------------------

def test_fire_decrements_once():
    src = np.asarray([0, 0, 1], dtype=np.int32)
    dst = np.asarray([2, 3, 3], dtype=np.int32)
    consumed = np.zeros(3, dtype=bool)
    indeg = np.asarray([0, 0, 1, 2], dtype=np.int32)
    done = np.asarray([True, False, False, False])
    indeg, consumed = port.fire_edges_np(done, src, dst, consumed, indeg)
    assert indeg.tolist() == [0, 0, 0, 1]
    indeg, consumed = port.fire_edges_np(done, src, dst, consumed, indeg)
    assert indeg.tolist() == [0, 0, 0, 1]
    done = np.asarray([True, True, False, False])
    indeg, consumed = port.fire_edges_np(done, src, dst, consumed, indeg)
    assert indeg.tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("seed", range(3))
def test_tick_edge_wave_is_fire_edges_np(seed):
    """The instant tick's edge wave equals fire_edges_np on the tick's own
    DONE mask, from a state where some edges already fired."""
    rng = np.random.default_rng(seed)
    args = _random_dag(rng, 200, 500, 2, 4)
    args[9] = rng.random(len(args[7])) < 0.3
    state, indeg, _a, _n, consumed = _tick_both(args, 0.5, True)
    want_indeg, want_consumed = ref.fire_edges_np(
        state == DONE, args[7], args[8], args[9], args[1])
    np.testing.assert_array_equal(indeg, want_indeg)
    np.testing.assert_array_equal(consumed, want_consumed)


# ----------------------------------------------------------------------
# TestJaxTickParity: tick by tick against jax_tick
# ----------------------------------------------------------------------

def test_diamond_graph_completes_in_waves():
    src = np.asarray([0, 0, 1, 2], dtype=np.int32)
    dst = np.asarray([1, 2, 3, 3], dtype=np.int32)
    args = [np.full(4, WAITING, np.int8), np.asarray([0, 1, 1, 2], np.int32),
            np.zeros(4, np.int32), np.full(4, -1, np.int32),
            _rows([1, 0, 0, 0]), _rows([8, 0, 0, 0]), _rows([8, 0, 0, 0]),
            src, dst, np.zeros(4, bool)]
    waves = []
    for _ in range(3):
        before = args[0].copy()
        args = _step_both(args, 0.5, True, 1)
        waves.append(set(np.flatnonzero((args[0] == DONE)
                                        & (before != DONE)).tolist()))
    assert waves == [{0}, {1, 2}, {3}]


@pytest.mark.parametrize("instant", [True, False])
@pytest.mark.parametrize("seed", range(5))
def test_tick_matches_jax_tick_each_tick(seed, instant):
    """Random DAGs with 1-3 classes, pins, FREE and RUNNING rows, dead
    nodes: state, indeg, avail, node_of and consumed equal after every
    tick (the non-instant tick keeps its state, so it repeats)."""
    rng = np.random.default_rng(42 + seed)
    C = int(rng.integers(50, 400))
    args = _random_dag(rng, C, 2 * C, int(rng.integers(1, 4)),
                       int(rng.integers(1, 7)))
    args = _step_both(args, 0.5, instant, 8)
    if instant:
        assert ((args[0] == DONE) | (args[0] == FREE)
                | (args[0] == WAITING)).all()


def test_random_dag_completes_like_the_reference_simulation():
    """TestJaxTickParity's whole-DAG case: 2 classes on 2 nodes, the tick
    stepped to completion; every task DONE, avail back at cap."""
    rng = np.random.default_rng(42)
    C, E = 256, 512
    src = rng.integers(0, C - 1, size=E).astype(np.int32)
    dst = (src + rng.integers(1, 16, size=E).clip(max=C - 1)).clip(
        max=C - 1).astype(np.int32)
    keep = src < dst
    src, dst = src[keep], dst[keep]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    indeg = np.zeros(C, dtype=np.int32)
    np.add.at(indeg, dst, 1)
    cap = _rows([64, 0, 0, 0], [32, 0, 0, 0])
    args = [np.full(C, WAITING, np.int8), indeg,
            rng.integers(0, 2, size=C).astype(np.int32),
            np.full(C, -1, np.int32), _rows([1, 0, 0, 0], [2, 0, 0, 0]),
            cap.copy(), cap, src, dst, np.zeros(len(src), bool)]
    for _ in range(C):
        args = _step_both(args, 0.5, True, 1)
        if (args[0] == DONE).all():
            break
    assert (args[0] == DONE).all()
    np.testing.assert_array_equal(args[5], cap)
    assert (args[1] <= 0).all()


# ----------------------------------------------------------------------
# drive and bench against jax_drive and jax_bench
# ----------------------------------------------------------------------

@pytest.mark.parametrize("max_ticks", [0, 3, 40])
def test_drive_matches_jax_drive(max_ticks):
    rng = np.random.default_rng(9)
    args = _random_dag(rng, 300, 600, 3, 5, running=0.0)
    want = ref.jax_drive(*args, num_classes=3, threshold=0.99,
                         max_ticks=max_ticks, donate=False)
    got = port.drive(*_graph_args(*args), threshold=0.99,
                     max_ticks=max_ticks)
    _assert_equal(got, want, ("state", "indeg", "avail", "consumed",
                              "ticks"))


def test_bench_matches_jax_bench():
    rng = np.random.default_rng(10)
    args = _random_dag(rng, 200, 400, 2, 4, free=0.0, running=0.1)
    want = ref.jax_bench(*args, num_classes=2, threshold=0.99,
                         max_ticks=30, k_reps=3)
    got = port.bench(*_graph_args(*args), threshold=0.99, max_ticks=30,
                     k_reps=3)
    _assert_equal(got, want, ("total_ticks", "state"))
    assert int(got[0]) % 3 == 0


# ----------------------------------------------------------------------
# the gang pack
# ----------------------------------------------------------------------

def _cluster(n, cpus):
    cap = np.zeros((n, 4), np.float32)
    cap[:, 0] = cpus
    return cap.copy(), cap


def test_pack_many_matches_feasibility():
    avail, cap = _cluster(4, 4)
    groups = np.asarray([[[3, 0, 0, 0]] * 2] * 3, np.float32)
    node_of, ok, _ = port.pack_many(groups, avail, cap, strict_spread=True,
                                    device="cpu")
    want = ref.jax_pack_many(groups, avail, cap, strict_spread=True)
    _assert_equal((node_of, ok), want[:2], ("node_of", "ok"))
    assert ok.tolist() == [True, True, False]
    for g in range(2):
        assert len(set(node_of[g].tolist())) == 2


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_pack_many_and_tiered_match_jax(seed, strict):
    """Random gangs, zero-demand bundles and dead nodes included: both
    dispatchers equal the JAX functions in node_of, ok and avail."""
    rng = np.random.default_rng(seed)
    G, B, N = int(rng.integers(1, 12)), int(rng.integers(1, 5)), \
        int(rng.integers(1, 8))
    demands = rng.choice(np.asarray([0, 1, 2, 3], np.float32),
                         size=(G, B, 4)).astype(np.float32)
    cap = rng.choice(np.asarray([0, 2, 4, 8], np.float32),
                     size=(N, 4)).astype(np.float32)
    tiers = rng.integers(0, 3, size=G)
    names = ("node_of", "ok", "avail")
    _assert_equal(port.pack_many(demands, cap.copy(), cap,
                                 strict_spread=strict, device="cpu"),
                  ref.jax_pack_many(demands, cap.copy(), cap,
                                    strict_spread=strict), names)
    _assert_equal(port.pack_many_tiered(demands, tiers, cap.copy(), cap,
                                        strict_spread=strict, device="cpu"),
                  ref.jax_pack_many_tiered(demands, tiers, cap.copy(), cap,
                                           strict_spread=strict), names)


def test_tiered_pack_equals_the_oracle_without_empty_bundles():
    """With every bundle demanding something, jax_pack_many_tiered's
    spreading equals pack_gangs_tiered_np's."""
    rng = np.random.default_rng(3)
    demands = rng.integers(1, 4, size=(20, 3, 4)).astype(np.float32)
    cap = rng.integers(2, 12, size=(16, 4)).astype(np.float32)
    tiers = rng.integers(0, 3, size=20)
    for strict in (False, True):
        _assert_equal(
            port.pack_many_tiered(demands, tiers, cap.copy(), cap,
                                  strict_spread=strict, device="cpu"),
            port.pack_gangs_tiered_np(demands, tiers, cap.copy(), cap,
                                      spread=np.full(20, strict)),
            ("node_of", "ok", "avail"))


# ----------------------------------------------------------------------
# dispatch: CPU tensors run the plain version; nothing falls back
# ----------------------------------------------------------------------

def _tiny_graph():
    return _graph_args(np.full(3, WAITING, np.int8), np.zeros(3, np.int32),
                       np.zeros(3, np.int32), np.full(3, -1, np.int32),
                       _rows([1, 0, 0, 0]), _rows([4, 0, 0, 0]),
                       _rows([4, 0, 0, 0]), np.zeros(0, np.int32),
                       np.zeros(0, np.int32), np.zeros(0, bool))


def test_cpu_tensors_launch_nothing():
    counters = (port.tick, port.assign, port.drive, port.bench,
                port.pack_many, port.pack_many_tiered)
    before = [fn.launches for fn in counters]
    args = _tiny_graph()
    port.tick(*args, threshold=0.5, instant_completion=True)
    port.drive(*args, threshold=0.5, max_ticks=2)
    port.bench(*args, threshold=0.5, max_ticks=2, k_reps=2)
    port.assign(np.zeros(3, np.int32), _rows([1, 0, 0, 0]),
                _rows([4, 0, 0, 0]), _rows([4, 0, 0, 0]), 0.5, device="cpu")
    cap = _rows([4, 0, 0, 0])
    port.pack_many_tiered(np.ones((2, 1, 4), np.float32), [0, 1], cap, cap,
                          strict_spread=False, device="cpu")
    assert [fn.launches for fn in counters] == before


def test_numpy_inputs_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cap = _rows([4, 0, 0, 0])
    with pytest.raises((RuntimeError, AssertionError)):
        port.assign(np.zeros(3, np.int32), _rows([1, 0, 0, 0]), cap, cap,
                    0.5)
    with pytest.raises((RuntimeError, AssertionError)):
        port.pack_many(np.ones((1, 1, 4), np.float32), cap, cap,
                       strict_spread=False)


def test_other_devices_raise():
    args = [x.to("meta") for x in _tiny_graph()]
    with pytest.raises(ValueError, match="no kernel for meta"):
        port.tick(*args, threshold=0.5)
    with pytest.raises(ValueError, match="runs on the card"):
        port.Drive(*_tiny_graph(), threshold=0.5, max_ticks=2)
    with pytest.raises(ValueError, match="a tensor on cpu"):
        port.tick(*_tiny_graph(), threshold=0.5, device="meta")


def test_check_graph_rejects_what_the_kernel_does_not_take():
    args = _tiny_graph()
    port._check_graph(*args)
    bad = list(args)
    bad[5] = torch.zeros((MAX := port.MAX_NODES + 1, 4))
    bad[6] = bad[5]
    with pytest.raises(ValueError, match=f"N={MAX}"):
        port._check_graph(*bad)
    bad = list(args)
    bad[1] = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes"):
        port._check_graph(*bad)
    bad = list(args)
    bad[7] = torch.tensor([0], dtype=torch.int32)
    bad[8] = torch.tensor([3], dtype=torch.int32)
    bad[9] = torch.zeros(1, dtype=torch.bool)
    with pytest.raises(ValueError, match="edge ends"):
        port._check_graph(*bad)

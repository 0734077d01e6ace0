"""The Data and task sections of the port's ``perf.py`` against the
reference's, on the CPU: ``data_ingest_overlap``, the three Arrow
sections (``data_arrow_throughput``, ``data_shuffle_throughput``,
``data_join_throughput``), ``data_pipeline_throughput`` and
``e2e_task_throughput``.

Both packages run each section with the same arguments at a small size
(the port's scheduler with its device path on the host:
``sched_device="cpu"``). The keys are the reference's plus the port's
listed ones (``test_torch_perf.added_keys``), and the counted quantities
are equal (bounds: equal, exactly): rows, blocks, consumers, tasks, and
the MB the Arrow sections count from the blocks' own nbytes (the port's
blocks are the same Arrow tables). Times are this host's and are not compared.
``e2e_task_throughput`` takes ``{"worker_mode": ...}`` in
``system_config`` where the reference takes ``mode``.
"""

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("pyarrow")

from ray_tpu_torch._private import perf  # noqa: E402
from test_torch_perf import assert_keys  # noqa: E402

CPU = {"sched_device": "cpu"}


def _check(name, got, want, counted):
    assert_keys(name, got, want)
    for k in counted:
        assert got[k] == want[k], (k, got[k], want[k])


def test_data_ingest_overlap_matches_the_reference():
    from ray_tpu._private import perf as rperf

    kw = dict(num_blocks=24, rows_per_block=10, sleep_s=0.02, consumers=2,
              num_workers=4)
    want = rperf.data_ingest_overlap(**kw)
    got = perf.data_ingest_overlap(**kw, system_config=CPU)
    _check("data_ingest_overlap", got, want,
           ("num_blocks", "rows", "consumers"))
    assert got["rows"] == 240
    assert 0.0 <= got["overlap_fraction"] <= 1.0
    assert got["ttfb_streaming_s"] > 0 and got["ttfb_materialize_s"] > 0


ARROW = {
    "data_arrow_throughput": dict(total_mb=2, num_blocks=4, num_workers=2),
    "data_shuffle_throughput": dict(total_mb=2, num_blocks=4,
                                    num_workers=2),
    "data_join_throughput": dict(total_mb=2, num_blocks=4, num_workers=2),
}


@pytest.mark.parametrize("name", sorted(ARROW))
def test_arrow_sections_match_the_reference(name):
    """Each section asserts its own row count (n_rows of the table, every
    row out once); the MB counted from the output blocks must equal the
    reference's."""
    from ray_tpu._private import perf as rperf

    want = getattr(rperf, name)(**ARROW[name])
    got = getattr(perf, name)(**ARROW[name], system_config=CPU)
    _check(name, got, want, ("total_mb", "num_blocks"))
    assert got["total_mb"] > 0 and got["mb_per_sec"] > 0


def test_data_pipeline_throughput_keys_match_the_reference():
    from ray_tpu._private import perf as rperf

    want = rperf.data_pipeline_throughput(50, rows_per_block=4,
                                          num_workers=2)
    got = perf.data_pipeline_throughput(50, rows_per_block=4, num_workers=2,
                                        system_config=CPU)
    _check("data_pipeline_throughput", got, want, ("num_blocks", "rows"))
    assert got["count"] == got["rows"] == 200
    assert [s["name"] for s in got["stages"]] == \
        [s["name"] for s in want["stages"]]


def test_e2e_task_throughput_keys_match_the_reference():
    from ray_tpu._private import perf as rperf

    want = rperf.e2e_task_throughput(n_tasks=300, num_workers=2)
    got = perf.e2e_task_throughput(n_tasks=300, num_workers=2,
                                   system_config=CPU)
    _check("e2e_task_throughput", got, want,
           ("n_tasks", "mode", "scheduler"))
    assert set(got["budget_us"]) == set(want["budget_us"])
    assert got["sched_ticks"] > 0 and got["device_assign_errors"] == 0

"""The chaos soak with both runtime mirrors armed, on the port: the case
``tests/test_chaos.py::test_chaos_soak_sanitizer_armed`` on
``ray_tpu_torch`` (process mode, the scheduler's device path on the host).

A two-stage numpy pipeline runs under a seeded fault plan (worker kills,
task exceptions, a hang, a link delay) with ``runtime_checks`` and the
sanitizer armed before ``init``: the results must be exact and the report
filed at shutdown clean, the lock witness diffed against the port's
static lock graph and the wire frames checked against the schema compiled
from the port's channel table. Then one round of arena-sized results
(six of 1.6 MB) must fill the shm leak ledger and drain it. Functions of
this module go to workers by value.
"""

import gc
import sys
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch import chaos

cloudpickle.register_pickle_by_value(sys.modules[__name__])

SOAK_PLAN = [
    ("worker", 1, "kill"),
    ("worker", 9, "kill"),
    ("task", 3, "exception"),
    ("task", 11, "exception"),
    ("task", 17, "hang", {"hang_s": 0.1}),
    ("link", 5, "delay", {"delay_s": 0.05}),
]


def wait_for(cond, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def _soak_run(seed):
    from ray_tpu_torch.util.state import list_faults

    ray.shutdown()
    ray.init(num_cpus=8, num_workers=2,
             _system_config={"worker_mode": "process",
                             "sched_device": "cpu",
                             "object_store_memory": 32 * 1024 * 1024,
                             "task_retry_delay_s": 0.02,
                             # keep the profile plane hot: worker kills
                             # and retries exercise the "prof"/"util"
                             # frames under the wire schema checks
                             "profile_hz": 25.0})
    try:
        chaos.arm(chaos.FaultPlan(seed, faults=SOAK_PLAN))

        @ray.remote(max_retries=4)
        def stage1(i):
            return np.arange(64, dtype=np.float64) * i

        @ray.remote(max_retries=4)
        def stage2(a):
            return float(a.sum())

        refs = [stage2.remote(stage1.remote(i)) for i in range(24)]
        out = ray.get(refs, timeout=120)
        log = [(e["site"], e["when"], e["kind"]) for e in list_faults()]
        return out, log
    finally:
        ray.shutdown()


@pytest.mark.chaos
def test_chaos_soak_sanitizer_armed(monkeypatch):
    from ray_tpu_torch._private.analysis import (PACKAGE_ROOT, lock_order,
                                                 runtime_checks,
                                                 runtime_sanitizer)

    monkeypatch.setattr(runtime_checks, "_ENABLED", True)
    runtime_sanitizer.arm()  # BEFORE init: wrap_lock sites fire at setup
    try:
        expected = [float((np.arange(64, dtype=np.float64) * i).sum())
                    for i in range(24)]
        out, log = _soak_run(4321)
        assert out == expected
        assert {k for _, _, k in log} >= {"kill", "exception"}

        report = runtime_sanitizer.last_report()
        assert report is not None, "Worker.shutdown never filed a report"
        assert report["lock_inversions"] == []
        assert report["shm_leaks"] == []
        assert report["ref_leaks"] == []
        assert report["wire_violations"] == []
        assert runtime_sanitizer.clean(report)
        # the witness diffed what it saw against a static graph that is
        # not empty
        assert lock_order.collect_edges(PACKAGE_ROOT)

        # the soak's 512-byte payloads are inlined and never touch the
        # arena: one arena-sized round must fill the ledger and drain it
        runtime_sanitizer.arm()
        ray.init(num_cpus=4, num_workers=2,
                 _system_config={"worker_mode": "process",
                                 "sched_device": "cpu",
                                 "object_store_memory": 32 * 1024 * 1024})

        @ray.remote
        def big(i):
            return np.arange(200_000, dtype=np.float64) * i

        refs = [big.remote(i) for i in range(6)]
        assert len(ray.get(refs, timeout=60)) == 6
        assert runtime_sanitizer.ledger_size() >= 6
        del refs
        gc.collect()
        assert wait_for(lambda: runtime_sanitizer.ledger_size() == 0,
                        timeout=10), "leak ledger never drained"
        ray.shutdown()
        assert runtime_sanitizer.clean(runtime_sanitizer.last_report())
    finally:
        runtime_sanitizer.disarm()
        ray.shutdown()

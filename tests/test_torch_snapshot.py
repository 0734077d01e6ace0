"""The port's cluster snapshot: the cases of ``tests/test_dag_snapshot_
dashboard.py::TestSnapshot`` on ``ray_tpu_torch``, and the snapshot
file held to the reference's for the same workload: the same top-level
keys, the same scheduler-array names, the same counts of pending and
unsnapshottable tasks, KV entries and actors.

On the card the tensor scheduler's arrays are host copies
(``TensorScheduler.device_state_snapshot``); phase ``ops`` of
``chip_smoke.py`` saves num_gpus tasks pending behind a gate and
restores them under their original ids.
"""

import threading
import time

import cloudpickle
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch import ObjectRef

CPU = {"sched_device": "cpu"}


@pytest.fixture
def rt():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=2, scheduler="tensor",
                       _system_config=CPU)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _blocked_fn(gate_file):
    def blocked(x, _gate=gate_file):
        import os as _os
        import time as _time

        t0 = _time.monotonic()
        while not _os.path.exists(_gate) \
                and _time.monotonic() - t0 < 30:
            _time.sleep(0.02)
        return x * 7
    return blocked


@pytest.mark.parametrize("scheduler", ["tensor", "event"])
def test_snapshot_restore_pending_tasks(tmp_path, scheduler):
    """Pending work survives a full session restart: results land under
    the original object ids in the restored session; KV comes back."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=2, scheduler=scheduler,
                       _system_config=CPU)
    gate_file = str(tmp_path / "gate")
    blocked = ray_tpu_torch.remote(_blocked_fn(gate_file))
    blockers = [blocked.remote(i) for i in range(2)]
    pend = [blocked.remote(i) for i in range(5, 8)]
    pend_ids = [r.object_id() for r in pend]
    time.sleep(0.2)
    meta = ray_tpu_torch.snapshot_cluster(str(tmp_path / "snap.bin"))
    assert meta["pending_tasks"] >= 1
    w = ray_tpu_torch._worker.get_worker()
    w.gcs.kv_put(b"mykey", b"myvalue")
    meta = ray_tpu_torch.snapshot_cluster(str(tmp_path / "snap.bin"))
    assert meta["kv_entries"] >= 1
    open(gate_file, "w").close()
    del blockers
    ray_tpu_torch.shutdown()

    ray_tpu_torch.init(num_workers=2, scheduler=scheduler,
                       _system_config=CPU)
    try:
        info = ray_tpu_torch.restore_cluster(str(tmp_path / "snap.bin"))
        assert info["resubmitted_tasks"] >= 1
        w2 = ray_tpu_torch._worker.get_worker()
        assert w2.gcs.kv_get(b"mykey") == b"myvalue"
        vals = ray_tpu_torch.get([ObjectRef(oid) for oid in pend_ids],
                                 timeout=30)
        assert vals == [i * 7 for i in range(5, 8)]
    finally:
        ray_tpu_torch.shutdown()


def test_device_state_in_snapshot(rt, tmp_path):
    @ray_tpu_torch.remote
    def f(x):
        return x

    ray_tpu_torch.get([f.remote(i) for i in range(5)], timeout=30)
    ray_tpu_torch.snapshot_cluster(str(tmp_path / "s.bin"))
    with open(tmp_path / "s.bin", "rb") as fh:
        snap = cloudpickle.load(fh)
    arrays = snap["scheduler_arrays"]
    assert "state" in arrays and "avail" in arrays
    assert arrays["cap"].shape[0] >= 1
    # host copies: numpy, never a device tensor
    assert all(type(v).__module__ == "numpy" for v in arrays.values()
               if hasattr(v, "shape"))


def test_restore_refuses_another_format_version(rt, tmp_path):
    path = tmp_path / "bad.bin"
    with open(path, "wb") as fh:
        cloudpickle.dump({"version": 99}, fh)
    with pytest.raises(ValueError, match="version"):
        ray_tpu_torch.restore_cluster(str(path))


def _snapshot_of(ray, tmp_path, cfg):
    """One workload through either package: 2 tasks held running, 3
    pending behind them, 1 pending task whose closure holds a lock
    (unsnapshottable), a KV entry, a named actor; the snapshot file."""
    ray.shutdown()
    ray.init(num_workers=2, scheduler="tensor", _system_config=cfg)
    gate = str(tmp_path / "gate")
    try:
        @ray.remote
        class Named:
            def ping(self):
                return 1

        a = Named.options(name="snap_actor").remote()
        ray.get(a.ping.remote(), timeout=30)
        blocked = ray.remote(_blocked_fn(gate))
        held = [blocked.remote(i) for i in range(2)]
        pend = [blocked.remote(i) for i in range(3)]
        lock = threading.Lock()

        @ray.remote
        def locked():
            with lock:
                return 1

        odd = locked.remote()
        time.sleep(0.3)
        ray._worker.get_worker().gcs.kv_put(b"k", b"v", namespace="ns")
        meta = ray.snapshot_cluster(str(tmp_path / "snap.bin"))
        open(gate, "w").close()
        ray.get(held + pend, timeout=60)
        del odd
        with open(tmp_path / "snap.bin", "rb") as fh:
            return meta, cloudpickle.load(fh)
    finally:
        open(gate, "w").close()
        ray.shutdown()


def test_snapshot_file_matches_the_references(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_meta, ref_snap = _snapshot_of(ray_tpu, tmp_path / "ref", {})
    meta, snap = _snapshot_of(ray_tpu_torch, tmp_path / "port", CPU)
    assert meta == ref_meta
    assert meta["pending_tasks"] == 3
    assert meta["unsnapshottable_tasks"] == 1
    assert sorted(snap) == sorted(ref_snap)
    assert snap["version"] == ref_snap["version"]
    assert sorted(snap["scheduler_arrays"]) == sorted(
        ref_snap["scheduler_arrays"])
    # the same KV keys; the session's log dir differs by package root
    assert sorted(snap["kv"]) == sorted(ref_snap["kv"])
    assert snap["kv"]["ns\x00k"] == ref_snap["kv"]["ns\x00k"] == b"v"
    assert [a["name"] for a in snap["actors"]] == \
        [a["name"] for a in ref_snap["actors"]] == ["snap_actor"]

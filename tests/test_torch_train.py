"""ray_tpu_torch.train on the CPU: tests/test_train_rllib.py's Train cases
(TestTrainer, TestDataIngest, the elastic floor) on the port's runtime
(thread mode, the scheduler's device path on the host: ``sched_device``
"cpu"), the checkpoint pair that replaces the reference's Orbax pair,
and parity programs: the same seeded numpy loop, with its failure and
restart, through ``ray_tpu.train`` and then ``ray_tpu_torch.train``,
with equal results. ``test_group_downsizes_after_node_death`` (``slow``,
as in the reference) takes a remote node down under a running group.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ray_tpu_torch as ray  # noqa: E402
from ray_tpu_torch import train  # noqa: E402

SYSTEM = {"sched_device": "cpu"}


@pytest.fixture(scope="module")
def rt():
    ray.shutdown()
    ray.init(num_workers=8, scheduler="tensor", _system_config=SYSTEM,
             ignore_reinit_error=True)
    yield ray
    ray.shutdown()


class TestTrainer:
    def test_worker_group_reports(self, rt):
        def loop(config):
            ctx = train.get_context()
            for step in range(3):
                train.report({"step": step, "rank": ctx.get_world_rank(),
                              "world": ctx.get_world_size()})

        trainer = train.Trainer(
            loop, scaling_config=train.ScalingConfig(num_workers=2))
        result = trainer.fit()
        assert result.metrics["step"] == 2
        assert result.metrics["world"] == 2
        assert len(result.metrics_history) == 3

    def test_result_comes_from_rank_zero(self, rt):
        """Result metrics must be rank 0's, not the first finisher's."""
        import time

        def loop(config):
            ctx = train.get_context()
            if ctx.get_world_rank() == 0:
                time.sleep(0.5)  # rank 0 finishes LAST
            train.report({"rank": ctx.get_world_rank()})

        result = train.Trainer(
            loop,
            scaling_config=train.ScalingConfig(num_workers=2)).fit()
        assert result.metrics["rank"] == 0

    def test_checkpoint_report_and_result(self, rt, tmp_path):
        def loop(config):
            for step in range(2):
                d = os.path.join(config["dir"], f"ckpt_{step}")
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump({"step": step}, f)
                train.report({"step": step},
                             checkpoint=train.Checkpoint.from_directory(d))

        trainer = train.Trainer(
            loop, train_loop_config={"dir": str(tmp_path)},
            scaling_config=train.ScalingConfig(num_workers=1))
        result = trainer.fit()
        assert result.checkpoint is not None
        with open(os.path.join(result.checkpoint.as_directory(),
                               "state.json")) as f:
            assert json.load(f)["step"] == 1

    def test_failure_restarts_from_checkpoint(self, rt, tmp_path):
        """A worker crash restarts the group from the latest checkpoint
        (the reference FailureConfig loop)."""
        marker = tmp_path / "crashed_once"

        def loop(config):
            start = 0
            ckpt = train.get_checkpoint()
            if ckpt is not None:
                with open(os.path.join(ckpt.as_directory(),
                                       "state.json")) as f:
                    start = json.load(f)["step"] + 1
            for step in range(start, 4):
                if step == 2 and not os.path.exists(config["marker"]):
                    open(config["marker"], "w").close()
                    raise RuntimeError("injected worker death")
                d = os.path.join(config["dir"], f"ckpt_{step}")
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump({"step": step}, f)
                train.report({"step": step, "resumed_from": start},
                             checkpoint=train.Checkpoint.from_directory(d))

        trainer = train.Trainer(
            loop,
            train_loop_config={"dir": str(tmp_path),
                               "marker": str(marker)},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(
                failure_config=train.FailureConfig(max_failures=2)))
        result = trainer.fit()
        assert result.metrics["step"] == 3
        # the restart resumed from step 2 (checkpoint of step 1), not 0
        assert result.metrics["resumed_from"] == 2

    def test_failure_budget_exhausted(self, rt):
        def loop(config):
            raise RuntimeError("always fails")

        trainer = train.Trainer(
            loop, scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(
                failure_config=train.FailureConfig(max_failures=1)))
        with pytest.raises(Exception):
            trainer.fit()

    def test_torch_checkpoint_roundtrip(self, rt, tmp_path):
        """The counterpart of test_orbax_sharded_checkpoint_roundtrip: a
        tree of tensors, a model's and an AdamW's state dicts through
        save_torch_checkpoint / load_torch_checkpoint, onto the device
        map_location names."""
        model = torch.nn.Linear(4, 3)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
        model(torch.ones(2, 4)).sum().backward()
        opt.step()
        tree = {"w": torch.arange(16.0).reshape(4, 4),
                "opt": {"mu": torch.ones(4, 4), "step": 7},
                "model": model.state_dict(), "optim": opt.state_dict()}
        ckpt = train.save_torch_checkpoint(str(tmp_path / "ck"), tree)
        assert os.path.isdir(ckpt.as_directory())
        restored = train.load_torch_checkpoint(ckpt, map_location="cpu")
        assert restored["opt"]["step"] == 7
        np.testing.assert_allclose(restored["w"].numpy(),
                                   np.arange(16.0).reshape(4, 4))
        assert restored["w"].device.type == "cpu"
        for k, v in model.state_dict().items():
            assert torch.equal(restored["model"][k], v)
        opt2 = torch.optim.AdamW(torch.nn.Linear(4, 3).parameters(),
                                 lr=1e-2)
        opt2.load_state_dict(restored["optim"])
        assert opt2.state_dict()["state"][0]["step"] == \
            opt.state_dict()["state"][0]["step"]
        # overwriting a checkpoint leaves no partial file behind
        train.save_torch_checkpoint(str(tmp_path / "ck"), {"a": 1})
        assert sorted(os.listdir(ckpt.as_directory())) == ["state.pt"]
        assert train.load_torch_checkpoint(ckpt) == {"a": 1}

    def test_use_gpu_is_declared_and_read_nowhere(self, rt):
        """ScalingConfig.use_gpu (the reference's use_tpu) has no effect:
        the group is the same with it set."""
        def loop(config):
            train.report({"world": train.get_context().get_world_size()})

        r = train.Trainer(loop, scaling_config=train.ScalingConfig(
            num_workers=2, use_gpu=True)).fit()
        assert r.metrics["world"] == 2


class TestDataIngest:
    def test_get_dataset_shard_splits_blocks(self, rt):
        from ray_tpu_torch import data

        def loop(config):
            shard = train.get_dataset_shard("train")
            total = sum(shard.iter_rows())
            n = shard.count()
            train.report({"sum": total, "rows": n,
                          "rank": train.get_context().get_world_rank()})

        ds = data.range(100, parallelism=10)
        trainer = train.Trainer(
            loop, scaling_config=train.ScalingConfig(num_workers=2),
            datasets={"train": ds})
        result = trainer.fit()
        # rank 0 gets even-indexed blocks; both shards together cover
        # everything exactly once
        assert result.metrics["rank"] == 0
        assert result.metrics["rows"] == 50
        assert result.metrics["sum"] == sum(
            x for b in range(0, 10, 2) for x in range(b * 10, b * 10 + 10))

    def test_shards_are_disjoint_and_cover_every_row(self, rt, tmp_path):
        """Two workers over a 10k-row range (chip_smoke's train_lib
        case): each rank's rows, written to a file, disjoint, and their
        union every row."""
        from ray_tpu_torch import data

        def loop(config):
            rank = train.get_context().get_world_rank()
            rows = list(train.get_dataset_shard("train").iter_rows())
            with open(os.path.join(config["dir"], f"{rank}.json"), "w") as f:
                json.dump(rows, f)
            train.report({"rows": len(rows)})

        train.Trainer(loop, train_loop_config={"dir": str(tmp_path)},
                      scaling_config=train.ScalingConfig(num_workers=2),
                      datasets={"train": data.range(10_000,
                                                    parallelism=20)}).fit()
        parts = [json.load(open(tmp_path / f"{r}.json")) for r in (0, 1)]
        assert parts[0] and parts[1]
        assert not set(parts[0]) & set(parts[1])
        assert sorted(parts[0] + parts[1]) == list(range(10_000))

    def test_missing_dataset_raises(self, rt):
        def loop(config):
            try:
                train.get_dataset_shard("nope")
            except KeyError:
                train.report({"ok": 1})

        r = train.Trainer(
            loop,
            scaling_config=train.ScalingConfig(num_workers=1)).fit()
        assert r.metrics["ok"] == 1

    def test_fit_does_not_materialize_up_front(self):
        """The ingest path must not run the whole Data pipeline before
        the retry loop: fit() opens streaming splits; only the
        pickling fallback inside _run_attempt may materialize."""
        import inspect

        src = inspect.getsource(train.Trainer.fit)
        assert "materialize" not in src.replace("materializing", "")

    def test_train_ingest_overlaps_pipeline(self, rt):
        """Train workers consume their shards WHILE the upstream map
        tasks still produce, proven by the split's overlap fraction
        (> 0) after fit() shut the split down, read through
        util.state.list_data_streams."""
        import time as _time

        from ray_tpu_torch import data
        from ray_tpu_torch.util import state

        def slow(b):
            _time.sleep(0.01)
            return b

        def loop(config):
            shard = train.get_dataset_shard("train")
            train.report({"rows": sum(1 for _ in shard.iter_rows())})

        ds = data.range(200, parallelism=20).map_batches(slow)
        r = train.Trainer(
            loop, scaling_config=train.ScalingConfig(num_workers=2),
            datasets={"train": ds}).fit()
        assert r.metrics["rows"] == 100
        streams = [s for s in state.list_data_streams() if not s["live"]]
        assert streams, "fit() left no shut-down split in the registry"
        st = streams[-1]
        assert st["blocks_produced"] == 20
        assert st["blocks_consumed"] == 20
        assert st["overlap_fraction"] > 0, st

    def test_process_mode_takes_the_materialized_fallback(self):
        """Process workers pickle actor args: the shards are the
        materialized blocks round-robined by rank."""
        from ray_tpu_torch import data

        ray.shutdown()
        ray.init(num_workers=2, scheduler="tensor",
                 _system_config={**SYSTEM, "worker_mode": "process"})
        try:
            assert not train.Trainer._streaming_ingest_ok()

            def loop(config):
                shard = train.get_dataset_shard("train")
                train.report({"rows": sorted(shard.iter_rows())})

            r = train.Trainer(
                loop, scaling_config=train.ScalingConfig(num_workers=2),
                datasets={"train": data.range(40, parallelism=4)}).fit()
            assert r.metrics["rows"] == list(range(0, 10)) + \
                list(range(20, 30))
        finally:
            ray.shutdown()
        ray.init(num_workers=8, scheduler="tensor", _system_config=SYSTEM)


class TestElasticTraining:
    @pytest.mark.slow
    def test_group_downsizes_after_node_death(self, tmp_path):
        """A failure-restart resizes the group to current cluster
        capacity instead of wedging at a size that can no longer
        schedule (reference: train/v2 elastic worker groups)."""
        import json as _json
        import os as _os
        import threading
        import time as _t

        from ray_tpu_torch.cluster_utils import Cluster

        ray.shutdown()
        c = Cluster(initialize_head=True,
                    head_node_args=dict(num_cpus=2, num_workers=2,
                                        scheduler="tensor",
                                        _system_config=SYSTEM))
        node = c.add_node(num_cpus=2, remote=True)
        c.wait_for_nodes()
        try:
            marker = str(tmp_path / "crashed_once")

            def loop(config):
                ctx = train.get_context()
                world = ctx.get_world_size()
                start = 0
                ckpt = train.get_checkpoint()
                if ckpt is not None:
                    with open(_os.path.join(ckpt.as_directory(),
                                            "state.json")) as f:
                        start = _json.load(f)["step"] + 1
                for step in range(start, 3):
                    # every worker of the 4-wide attempt crashes at step 1
                    if step == 1 and world == 4:
                        open(config["marker"], "w").close()
                        raise RuntimeError("injected group failure")
                    d = _os.path.join(config["dir"], f"ck_{step}")
                    _os.makedirs(d, exist_ok=True)
                    with open(_os.path.join(d, "state.json"), "w") as f:
                        _json.dump({"step": step}, f)
                    train.report(
                        {"step": step, "world": world},
                        checkpoint=train.Checkpoint.from_directory(d))

            trainer = train.Trainer(
                loop,
                train_loop_config={"dir": str(tmp_path),
                                   "marker": marker},
                scaling_config=train.ScalingConfig(
                    num_workers=4, min_workers=2,
                    resources_per_worker={"CPU": 1.0}),
                run_config=train.RunConfig(
                    failure_config=train.FailureConfig(max_failures=3)))
            result_box = {}

            def _fit():
                result_box["result"] = trainer.fit()

            t = threading.Thread(target=_fit)
            t.start()
            # let the 4-worker attempt crash, then take the node down so
            # the restart sees half the capacity
            deadline = _t.monotonic() + 60
            while not _os.path.exists(marker) \
                    and _t.monotonic() < deadline:
                _t.sleep(0.05)
            assert _os.path.exists(marker)
            node.kill_worker_processes()
            c.remove_node(node)
            t.join(timeout=180)
            assert not t.is_alive()
            result = result_box["result"]
            # resumed from the step-0 checkpoint at the downsized world
            assert result.metrics["step"] == 2
            assert result.metrics["world"] == 2
        finally:
            c.shutdown()
            ray.shutdown()

    def test_elastic_target_respects_floor(self, rt):
        # the slow node-death test above tears the shared runtime down in
        # its finally; re-init so capacity queries see a cluster
        if not ray.is_initialized():
            ray.init(num_workers=8, scheduler="tensor",
                     _system_config=SYSTEM, ignore_reinit_error=True)
        trainer = train.Trainer(
            lambda config: None,
            scaling_config=train.ScalingConfig(
                num_workers=64, min_workers=2,
                resources_per_worker={"CPU": 1.0}))
        # the 8-worker test cluster can't hold 64: clamp to capacity
        n = trainer._elastic_target()
        assert 2 <= n < 64
        fixed = train.Trainer(
            lambda config: None,
            scaling_config=train.ScalingConfig(num_workers=64))
        assert fixed._elastic_target() == 64  # non-elastic: unclamped


# == parity: the same loop through ray_tpu.train and ray_tpu_torch.train ====

def _regression_loop(config):
    """Least squares by gradient descent on seeded numpy data, one
    checkpoint a step (a JSON state file), a crash at step 3 on the first
    attempt; works under either package's train module (config["pkg"])."""
    import importlib

    tr = importlib.import_module(config["pkg"] + ".train")
    rng = np.random.default_rng(config["seed"])
    x = rng.normal(size=(64, 3))
    y = x @ np.array([1.0, -2.0, 0.5]) + 0.1 * rng.normal(size=64)
    w, start = np.zeros(3), 0
    ckpt = tr.get_checkpoint()
    if ckpt is not None:
        with open(os.path.join(ckpt.as_directory(), "state.json")) as f:
            st = json.load(f)
        w, start = np.asarray(st["w"]), st["step"] + 1
    for step in range(start, 6):
        if step == 3 and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            raise RuntimeError("injected worker death")
        w = w - 0.1 * (x.T @ (x @ w - y)) / len(y)
        d = os.path.join(config["dir"], f"ckpt_{step}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "state.json"), "w") as f:
            json.dump({"w": w.tolist(), "step": step}, f)
        tr.report({"step": step, "loss": float(np.mean((x @ w - y) ** 2)),
                   "resumed_from": start},
                  checkpoint=tr.Checkpoint.from_directory(d))


@pytest.mark.parametrize("seed", [0, 5])
def test_restart_history_equals_the_reference(seed, tmp_path):
    import ray_tpu
    from ray_tpu import train as ref_train

    def run(pkg, mod, tm):
        sub = tmp_path / pkg
        sub.mkdir()
        return tm.Trainer(
            _regression_loop,
            train_loop_config={"pkg": pkg, "seed": seed, "dir": str(sub),
                               "marker": str(sub / "crashed")},
            scaling_config=tm.ScalingConfig(num_workers=1),
            run_config=tm.RunConfig(
                failure_config=tm.FailureConfig(max_failures=1))).fit()

    ray.shutdown()
    ray_tpu.shutdown()
    ray_tpu.init(num_workers=4, scheduler="tensor")
    try:
        want = run("ray_tpu", ray_tpu, ref_train)
    finally:
        ray_tpu.shutdown()
    ray.init(num_workers=4, scheduler="tensor", _system_config=SYSTEM)
    try:
        got = run("ray_tpu_torch", ray, train)
    finally:
        ray.shutdown()
    assert got.metrics == want.metrics
    assert got.metrics_history == want.metrics_history
    assert got.metrics["resumed_from"] == 3
    assert os.path.basename(got.checkpoint.path) == \
        os.path.basename(want.checkpoint.path) == "ckpt_5"
    ray.init(num_workers=8, scheduler="tensor", _system_config=SYSTEM)

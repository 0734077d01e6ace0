"""``qos_ab``, ``locality_ab``, ``model_mfu`` and ``rl_rollout_throughput``
of the port against the reference's, on the CPU.

Both packages run each section with the same arguments at a small size
(the port's scheduler with its device path on the host,
``sched_device="cpu"``; its model and learner on the host,
``device="cpu"``). The keys are the reference's plus the port's listed
ones (``test_torch_perf.added_keys``); counted quantities are equal
(bounds: equal, exactly): tasks and their total, nested submissions, the
consumers' sum, parameters and flops, env steps. ``rl_rollout_throughput`` runs on the
caller's runtime in the port (the reference starts its own).
"""

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch._private import perf  # noqa: E402
from test_torch_perf import assert_keys  # noqa: E402

CPU = {"sched_device": "cpu"}


def _check(name, got, want, counted):
    assert_keys(name, got, want)
    for k in counted:
        assert got[k] == want[k], (k, got[k], want[k])


def test_qos_ab_matches_the_reference():
    from ray_tpu._private import perf as rperf

    want = rperf.qos_ab(True, n_per_tenant=6, n_submit=4)
    got = perf.qos_ab(True, n_per_tenant=6, n_submit=4, system_config=CPU)
    _check("qos_ab", got, want, ("mode", "n_tasks", "n_submit", "total"))
    assert got["total"] == 2 * sum(range(6))


def test_locality_ab_matches_the_reference():
    from ray_tpu._private import perf as rperf

    want = rperf.locality_ab(True, n_consumers=2, arg_mb=0.25)
    got = perf.locality_ab(True, n_consumers=2, arg_mb=0.25,
                           system_config=CPU)
    _check("locality_ab", got, want,
           ("locality", "n_consumers", "arg_mb", "sum"))
    assert got["bytes_pulled"] == want["bytes_pulled"] == 0


def test_model_mfu_matches_the_reference():
    """SMOKE_MODEL through both train steps: the same parameters, batch,
    sequence and model flops (6 N D); the reference's compiled count
    (flops_per_step) includes what its compiler adds, the port's is the
    analytic one, so those two differ by design."""
    from ray_tpu._private import perf as rperf

    want = rperf.model_mfu(smoke=True)
    got = perf.model_mfu(smoke=True, device="cpu")
    _check("model_mfu", got, want,
           ("platform", "n_params", "batch_size", "seq_len",
            "model_flops_per_step", "peak_flops", "mfu", "hfu"))
    assert got["flops_per_step"] == got["model_flops_per_step"]


def test_rl_rollout_throughput_matches_the_reference():
    from ray_tpu._private import perf as rperf

    want = rperf.rl_rollout_throughput(iters=1)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=8, scheduler="tensor",
                       _system_config=CPU)
    try:
        got = perf.rl_rollout_throughput(iters=1, device="cpu")
    finally:
        ray_tpu_torch.shutdown()
    _check("rl_rollout_throughput", got, want, ("env_steps",))
    assert got["env_steps"] == 8 * 8 * 64

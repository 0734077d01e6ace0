"""chip_smoke.py's phase ``perf`` helpers on the CPU: the reference's form
of the time sinks (at most top_k rows, descending, each share in (0, 100],
summing to at most 100 plus rounding), the flash kernels found among the
ops by their device names (the sm90 templates' entry points; the forward
told from ring attention's by its epilogue), the phase's sizes (the
reference's parameter count at the decode width, and a serving model whose
head_dim is kernel 1's), and the host state it reads before its first
section."""

import pytest

torch = pytest.importorskip("torch")
import chip_smoke  # noqa: E402

# device names as CUPTI reports the sm90 instances
FWD = ("void (anonymous namespace)::attention_fwd_kernel<FlashFwdOut>"
       "(CUtensorMap, CUtensorMap, CUtensorMap, Problem, FlashFwdOut)")
RING = ("void (anonymous namespace)::attention_fwd_kernel<RingBlockOut>"
        "(CUtensorMap, CUtensorMap, CUtensorMap, Problem, RingBlockOut)")
DQ = "void (anonymous namespace)::attention_bwd_dq_kernel(CUtensorMap, ...)"
DKV = "void (anonymous namespace)::attention_bwd_dkv_kernel(CUtensorMap, ...)"


def _rows(*pairs):
    return [{"op": op, "pct_of_device_time": pct} for op, pct in pairs]


@pytest.mark.parametrize("rows,top_k,problems", [
    (_rows(("gemm", 60.0), ("add", 30.0), ("copy", 10.0)), 5, []),
    (_rows(("gemm", 60.0), ("add", 30.0)), 1, ["2 rows > top_k 1"]),
    (_rows(("add", 30.0), ("gemm", 60.0)), 5, ["not descending"]),
    (_rows(("gemm", 60.0), ("add", 0.0)), 5, ["a share outside (0, 100]"]),
    (_rows(("gemm", 60.0), ("add", 40.1)), 5, ["shares sum to 100.1"]),
    ([], 5, ["no rows"]),
])
def test_sinks_form(rows, top_k, problems):
    got = chip_smoke.sinks_form(rows, top_k)
    assert [p.split(" to ")[0] for p in got] == \
        [p.split(" to ")[0] for p in problems]


def test_flash_ops_finds_each_kernel_by_its_device_name():
    rows = _rows(("gemm", 50.0), (RING, 20.0), (DKV, 3.0), (FWD, 2.0),
                 (DQ, 1.5))
    got = chip_smoke.flash_ops(rows)
    assert got == {"flash_fwd": (FWD, 2.0), "flash_bwd_dq": (DQ, 1.5),
                   "flash_bwd_dkv": (DKV, 3.0)}
    assert chip_smoke.flash_ops(_rows((RING, 20.0), (DQ, 1.0))) == {
        "flash_fwd": None, "flash_bwd_dq": (DQ, 1.0), "flash_bwd_dkv": None}
    assert set(chip_smoke.PERF_FLASH_OPS) == set(chip_smoke.FLASH_NAMES)


def test_perf_phase_sizes():
    """The decode width's parameter count is the reference's (held to
    flax's count in tests/test_torch_perf.py); the serving A/B's model is
    the reference's own, whose head_dim 16 kernel 1 is built for; the
    forward reruns in the remat recompute, so the time sinks' flash
    counts are 48 / 24 / 24."""
    from ray_tpu_torch._private import perf
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.ops import paged_attention as pa

    assert chip_smoke.PERF_DECODE_PARAMS == 127_157_248
    cfg = TransformerConfig(**perf.SERVING_AB_MODEL)
    assert not hasattr(chip_smoke, "PERF_SERVING_MODEL")
    assert cfg.head_dim == 16 and cfg.head_dim in pa._HEAD_DIMS
    assert cfg.n_heads == perf.SERVING_AB_MODEL["n_heads"]
    assert cfg.vocab_size == perf.SERVING_AB_MODEL["vocab_size"]
    assert chip_smoke.PERF_SINK_STEPS == 3
    assert chip_smoke.PERF_INGEST_ROWS == 96 * 50
    assert chip_smoke.PERF_ARROW == ("data_arrow_throughput",
                                     "data_shuffle_throughput",
                                     "data_join_throughput")


def test_host_state_lists_threads_and_live_children():
    import subprocess
    import sys
    import threading
    import time
    from pathlib import Path

    gate = threading.Event()
    t = threading.Thread(target=gate.wait, name="perf-phase-probe")
    t.start()
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(30)"])
    try:
        # Popen can return while the child is still inside execve, its
        # new argv not yet in /proc (read there as empty): wait for it
        deadline = time.monotonic() + 10
        while b"sleep" not in Path(f"/proc/{child.pid}/cmdline").read_bytes():
            assert time.monotonic() < deadline, "the child never exec'd"
            time.sleep(0.01)
        state = chip_smoke.host_state()
        assert "perf-phase-probe" in state["threads"]
        assert child.pid in [c["pid"] for c in state["children"]]
        assert "time.sleep(30)" in next(
            c["cmdline"] for c in state["children"] if c["pid"] == child.pid)
        assert state["gc_objects"] > 0 and state["rss_bytes"] > 0
    finally:
        child.kill()
        child.wait(timeout=10)
        gate.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert child.pid not in [c["pid"]
                             for c in chip_smoke.host_state()["children"]]


CPU = {"sched_device": "cpu"}


@pytest.fixture(scope="module")
def serving_oracle():
    return chip_smoke.serving_oracle(torch, torch.device("cpu"))


@pytest.mark.parametrize("disagg", [False, True], ids=["mono", "disagg"])
def test_serving_streams_hold_to_the_plain_model(disagg, serving_oracle):
    """Phase perf's value check of the serving A/B on the host: each
    stream's tokens, teacher-forced through the plain f32 model, stay
    within PERF_SERVING_TOL of its top logit (the engines take the plain
    paged attention here, kernel 1 on the card)."""
    from ray_tpu_torch._private import perf

    r = perf.serving_ab(disagg, sessions=2, turns=2, max_new=8,
                        device="cpu", system_config=CPU)
    assert [(s["session"], s["turn"]) for s in r["streams"]] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert sum(len(s["tokens"]) for s in r["streams"]) == r["total_tokens"]
    d = chip_smoke.stream_deficits(torch, serving_oracle, r["streams"], 8,
                                   perf.SERVING_AB_MODEL["vocab_size"])
    assert d["tokens"] == 32 and d["malformed"] == 0, d
    assert d["worst"] <= chip_smoke.PERF_SERVING_TOL, d


def test_stream_deficits_catch_a_wrong_token(serving_oracle):
    """A stream of the oracle's own greedy tokens has no deficit; one token
    swapped for the oracle's least likely one exceeds the tolerance, and a
    stream of the wrong length or out of vocab counts as malformed."""
    prompt, toks = [3, 1, 4, 1, 5, 9], []
    for _ in range(8):
        toks.append(int(serving_oracle(prompt + toks)[-1].argmax()))
    ok = {"prompt": prompt, "tokens": toks}
    d = chip_smoke.stream_deficits(torch, serving_oracle, [ok], 8, 128)
    assert d == {"tokens": 8, "worst": 0.0, "off_argmax": 0, "malformed": 0}
    worst = int(serving_oracle(prompt + toks[:4])[-1].argmin())
    bad = {"prompt": prompt, "tokens": toks[:4] + [worst] + toks[5:]}
    d = chip_smoke.stream_deficits(torch, serving_oracle, [bad], 8, 128)
    assert d["worst"] > chip_smoke.PERF_SERVING_TOL and d["off_argmax"] >= 1
    short = {"prompt": prompt, "tokens": toks[:7]}
    oov = {"prompt": prompt, "tokens": toks[:7] + [128]}
    d = chip_smoke.stream_deficits(torch, serving_oracle, [short, oov], 8,
                                   128)
    assert d["malformed"] == 2 and d["tokens"] == 0


@pytest.mark.parametrize("backend,recorded", [("cuda", True),
                                              ("numpy", False)])
def test_assign_recorder_keeps_device_path_snapshots(backend, recorded):
    """AssignRecorder(any_backend=True): each snapshot that went through
    the device path (its plain version here, sched_device "cpu") is kept
    and agrees with assign_np; a numpy tick is not kept; each scheduler
    that assigned on the device path is entered with its count before."""
    import ray_tpu_torch as ray
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.scheduler import kernels as sk
    from ray_tpu_torch._private.scheduler.tensor import TensorScheduler

    ray.shutdown()
    ray.init(num_workers=2, _system_config={**CPU,
                                            "sched_backend": backend})
    rec = chip_smoke.AssignRecorder(torch, TensorScheduler, sk,
                                    GLOBAL_CONFIG, any_backend=True)
    try:
        sched = ray._worker.get_worker().scheduler
        before = sched.stats()["device_assigns"]
        rec.snapshots, rec.schedulers = [], {}

        @ray.remote
        def f(i):
            return i

        assert ray.get([f.remote(i) for i in range(40)]) == list(range(40))
        assigns = sched.stats()["device_assigns"] - before
        assert bool(rec.snapshots) == recorded == (assigns > 0)
        assert len(rec.snapshots) == assigns
        assert rec.schedulers == ({sched: before} if recorded else {})
        assert chip_smoke.replay_oracle(
            sk, rec.snapshots, GLOBAL_CONFIG.sched_hybrid_threshold) == 0
    finally:
        rec.remove()
        ray.shutdown()

"""ray_tpu_torch's InferenceEngine against ray_tpu's, on the CPU.

Both engines get the same flax-initialised tiny f32 model (the config of
tests/test_inference.py); the port runs with ``device="cpu"``, where its
paged-attention wrapper takes the plain PyTorch path. Greedy token
streams must be EXACTLY equal — ragged prompts, more requests than
slots, streaming, the prefill-export -> decode-import hand-off, and an
EOS id inside a decode chunk and in the overrun past max_new.
Also: the port imports no JAX, and without CUDA an engine with no
``device`` refuses to start.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import inference as jinf  # noqa: E402
from ray_tpu.models.transformer import Transformer as JTransformer  # noqa: E402
from ray_tpu.models.transformer import (  # noqa: E402
    TransformerConfig as JConfig)
from ray_tpu_torch.models import inference as tinf  # noqa: E402
from ray_tpu_torch.models import transformer as tt  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq_len=128)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JConfig(dtype=jnp.float32, **TINY)
    variables = JTransformer(jcfg).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32))
    params = tt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       variables))
    tcfg = tt.TransformerConfig(dtype=torch.float32, **TINY)
    return jcfg, variables["params"], tcfg, params


def _run(engine, prompts, max_new):
    try:
        futs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
        return [f.result(timeout=120) for f in futs]
    finally:
        engine.shutdown()


def _both(tiny, icfg, prompts, max_new):
    jcfg, jparams, tcfg, params = tiny
    want = _run(jinf.InferenceEngine(jparams, jcfg, icfg), prompts, max_new)
    port = tinf.InferenceEngine(params, tcfg, tinf.InferenceConfig(
        **vars(icfg)), device="cpu")
    got = _run(port, prompts, max_new)
    return got, want, port


def test_ragged_prompts_match_jax_engine(tiny):
    icfg = jinf.InferenceConfig(batch_size=3, page_size=4,
                                max_pages_per_seq=8, num_pages=32,
                                prefill_buckets=(8, 16))
    prompts = [[7], [1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9]]
    got, want, _ = _both(tiny, icfg, prompts, 5)
    assert got == want
    assert all(len(o) == 5 for o in got)


def test_more_requests_than_slots_match_jax_engine(tiny):
    icfg = jinf.InferenceConfig(batch_size=2, page_size=4,
                                max_pages_per_seq=8, num_pages=16,
                                prefill_buckets=(8,))
    prompts = [[i + 1, i + 2] for i in range(5)]
    got, want, port = _both(tiny, icfg, prompts, 6)
    assert got == want
    st = port.stats()
    assert st["active"] == 0 and st["queued"] == 0
    assert port.max_concurrent <= 2
    # all pages returned to the pool
    assert st["free_pages"] == icfg.num_pages - 1


def test_token_stream_matches_generate_and_jax(tiny):
    """submit_stream yields what generate() returns (small decode_chunk
    forces several sync bursts), and both equal the JAX engine."""
    jcfg, jparams, tcfg, params = tiny
    kw = dict(batch_size=2, page_size=4, max_pages_per_seq=8, num_pages=32,
              prefill_buckets=(8,), decode_chunk=2)
    prompt = [3, 14, 15]
    (want,) = _run(jinf.InferenceEngine(jparams, jcfg,
                                        jinf.InferenceConfig(**kw)),
                   [prompt], 8)
    engine = tinf.InferenceEngine(params, tcfg, tinf.InferenceConfig(**kw),
                                  device="cpu")
    try:
        gen = engine.generate(prompt, max_new_tokens=8)
        stream = engine.submit_stream(prompt, max_new_tokens=8)
        got = list(stream)
        assert stream.result(timeout=10) == got
    finally:
        engine.shutdown()
    assert got == gen == want


def test_prefill_export_to_decode_engine_matches_jax(tiny):
    """prefill-mode engine -> exported K/V + first token -> decode-mode
    engine: the stream equals the JAX monolithic engine's tokens."""
    jcfg, jparams, tcfg, params = tiny
    kw = dict(batch_size=2, page_size=4, max_pages_per_seq=8, num_pages=32,
              prefill_buckets=(8, 16), decode_chunk=4)
    prompts = [[4, 8, 15, 16, 23, 42], [1], [2, 7, 1, 8, 2, 8, 1, 8, 2]]
    want = _run(jinf.InferenceEngine(jparams, jcfg,
                                     jinf.InferenceConfig(**kw)), prompts, 7)
    pre = tinf.InferenceEngine(params, tcfg, tinf.InferenceConfig(**kw),
                               mode="prefill", device="cpu")
    dec = tinf.InferenceEngine(params, tcfg, tinf.InferenceConfig(**kw),
                               mode="decode", device="cpu")
    try:
        with pytest.raises(RuntimeError, match="mode"):
            dec.submit([1, 2], max_new_tokens=2)
        kvs = [pre.prefill_export(p, max_new_tokens=7) for p in prompts]
        assert kvs[0]["k"].shape == (2, 6, 2, 8)
        assert kvs[0]["kv_bytes"] == 2 * 2 * 6 * 2 * 8 * 4
        streams = [dec.submit_stream_from_kv(kv) for kv in kvs]
        got = [list(s) for s in streams]
        assert [s.result(timeout=10) for s in streams] == got
        assert dec.stats()["free_pages"] == kw["num_pages"] - 1
    finally:
        pre.shutdown()
        dec.shutdown()
    assert got == want
    assert [kv["first_token"] for kv in kvs] == [w[0] for w in want]


_EOS_PROMPTS = [[9, 2, 6, 5], [3, 14, 15], [1], [27, 18, 28, 18, 28]]
_EOS_CHUNKS = dict(page_size=4, max_pages_per_seq=8, num_pages=32,
                   prefill_buckets=(8,), decode_chunk=4)


def _eos_at(tiny, prompts, at):
    """(prompt index, token): the first of the prompts whose greedy stream
    (the port's, no EOS) has a token at index `at` that it has not
    emitted before, to serve as the EOS id."""
    _jcfg, _jparams, tcfg, params = tiny
    streams = _run(tinf.InferenceEngine(
        params, tcfg, tinf.InferenceConfig(batch_size=len(prompts),
                                           **_EOS_CHUNKS), device="cpu"),
        prompts, at + 1)
    which = next(i for i, s in enumerate(streams) if s[at] not in s[:at])
    return which, streams[which]


def test_eos_mid_chunk_matches_jax_engine(tiny):
    """EOS at index 2 of a stream: the prefill gives index 0, the first
    decode chunk (4 steps) indices 1-4, so the stream stops inside a
    chunk, trimmed after the EOS. Four ragged prompts over two slots: the
    other streams stop at their own first EOS, or run to max_new."""
    which, stream = _eos_at(tiny, _EOS_PROMPTS[:2], 2)
    icfg = jinf.InferenceConfig(batch_size=2, eos_id=stream[2],
                                **_EOS_CHUNKS)
    got, want, _ = _both(tiny, icfg, _EOS_PROMPTS, 12)
    assert got == want
    assert got[which] == stream[:3]
    assert all(len(o) == 12 or o[-1] == stream[2] for o in got)


def test_eos_in_the_overrun_is_not_honored_as_jax(tiny):
    """max_new 4: the decode chunk covering the budget runs 4 steps after
    the prefill token, one past max_new. An EOS first produced at index 4
    lies in that overrun: the output is the 4-token budget, no EOS."""
    which, stream = _eos_at(tiny, _EOS_PROMPTS, 4)
    icfg = jinf.InferenceConfig(batch_size=1, eos_id=stream[4],
                                **_EOS_CHUNKS)
    got, want, port = _both(tiny, icfg, [_EOS_PROMPTS[which]], 4)
    assert got == want == [stream[:4]]
    assert port.decode_steps >= 4       # index 4 was decoded


def test_engine_without_device_needs_cuda(tiny):
    _jcfg, _jparams, tcfg, params = tiny
    icfg = tinf.InferenceConfig(batch_size=1, page_size=4,
                                max_pages_per_seq=2, num_pages=8,
                                prefill_buckets=(8,))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.InferenceEngine(params, tcfg, icfg)


def test_engine_rejects_oversized_and_empty(tiny):
    _jcfg, _jparams, tcfg, params = tiny
    engine = tinf.InferenceEngine(
        params, tcfg, tinf.InferenceConfig(batch_size=1, page_size=4,
                                           max_pages_per_seq=2, num_pages=8,
                                           prefill_buckets=(8,)),
        device="cpu")
    try:
        with pytest.raises(ValueError, match="max context"):
            engine.submit([1, 2, 3, 4], max_new_tokens=32)
        with pytest.raises(ValueError, match="empty"):
            engine.submit([])
    finally:
        engine.shutdown()


def test_port_imports_no_jax():
    """Every module of the port imports, and the runtime runs init, a
    task, an actor and shutdown (the scheduler's device path on the host:
    sched_device "cpu"), in thread mode and then a task and a Data
    map_batches in process mode, with no jax and no ray_tpu module loaded
    in the driver or the worker processes; the package's import, and
    Serve's, the metrics plane's, the process runtime's, Data's, the
    cluster's, the autoscaler's, RLlib's (each submodule), Train's, and
    those of MoE, Tune, workflow, the DAG, the queue, the node daemon,
    the remote pool and the ray:// client, and of the optional planes
    and the ops layer (qos, profile_plane, snapshot, util.state, the
    dashboard, job_submission, the CLI's __main__), and of sharded
    training (parallel.distributed, parallel.collectives, ops.pipeline;
    tests/test_torch_sharded*.py check the rank processes), and of
    raylint's passes (_private.analysis and its eight pass modules),
    leave CUDA
    uninitialised; a PPO iteration with its learner on the host, and a
    process-mode task under both planes (qos, profile_hz), load no jax
    or ray_tpu module either."""
    code = ("import os, sys, torch, ray_tpu_torch as ray\n"
            "assert not torch.cuda.is_initialized()\n"
            "import ray_tpu_torch.models.inference, "
            "ray_tpu_torch.models.train_step, ray_tpu_torch.ops.flash, "
            "ray_tpu_torch.ops.paged_attention, ray_tpu_torch._private.perf, "
            "ray_tpu_torch.ops.ring_attention, ray_tpu_torch.parallel, "
            "ray_tpu_torch.parallel.mesh, "
            "ray_tpu_torch.parallel.distributed, "
            "ray_tpu_torch.parallel.collectives, ray_tpu_torch.ops.pipeline, "
            "ray_tpu_torch._private.runtime.listener, "
            "ray_tpu_torch._private.scheduler.kernels, "
            "ray_tpu_torch._private.scheduler.tensor, "
            "ray_tpu_torch._private.benchmarks, ray_tpu_torch.util, "
            "ray_tpu_torch._private.serialization, "
            "ray_tpu_torch._private.runtime_envs, ray_tpu_torch.serve, "
            "ray_tpu_torch.serve.core, ray_tpu_torch.serve.llm, "
            "ray_tpu_torch._private.metrics, ray_tpu_torch.util.metrics, "
            "ray_tpu_torch._private.runtime.process_pool, "
            "ray_tpu_torch._private.runtime.worker_process, "
            "ray_tpu_torch._private.runtime.shm_store, "
            "ray_tpu_torch._private.spawn_env, "
            "ray_tpu_torch._private.protocol, ray_tpu_torch._native, "
            "ray_tpu_torch._private.runtime.node_daemon, "
            "ray_tpu_torch._private.runtime.remote_pool, "
            "ray_tpu_torch._private.client, "
            "ray_tpu_torch.data, ray_tpu_torch.data._streaming, "
            "ray_tpu_torch.data._shuffle, ray_tpu_torch.cluster_utils, "
            "ray_tpu_torch.autoscaler, ray_tpu_torch.rllib, "
            "ray_tpu_torch.rllib.core, ray_tpu_torch.rllib.env, "
            "ray_tpu_torch.rllib.connectors, ray_tpu_torch.rllib.optim, "
            "ray_tpu_torch.rllib.runner_group, ray_tpu_torch.rllib.ppo, "
            "ray_tpu_torch.rllib.impala, ray_tpu_torch.rllib.dqn, "
            "ray_tpu_torch.rllib.sac, ray_tpu_torch.rllib.offline, "
            "ray_tpu_torch.rllib.multi_agent, ray_tpu_torch.train, "
            "ray_tpu_torch.train.api, ray_tpu_torch.ops.moe, "
            "ray_tpu_torch.tune, ray_tpu_torch.tune.tuner, "
            "ray_tpu_torch.tune.search, ray_tpu_torch.workflow, "
            "ray_tpu_torch.dag, ray_tpu_torch.util.queue, "
            "ray_tpu_torch._private.qos, "
            "ray_tpu_torch._private.profile_plane, "
            "ray_tpu_torch._private.snapshot, ray_tpu_torch.util.state, "
            "ray_tpu_torch.dashboard, ray_tpu_torch.job_submission, "
            "ray_tpu_torch.__main__, ray_tpu_torch._private.analysis, "
            "ray_tpu_torch._private.analysis._astutil\n"
            "assert not torch.cuda.is_initialized()\n"
            "ray.init(num_workers=2, scheduler='tensor', "
            "_system_config={'sched_device': 'cpu'})\n"
            "f = ray.remote(lambda x: x + 1)\n"
            "assert ray.get(f.remote(1), timeout=30) == 2\n"
            "@ray.remote\n"
            "class A:\n"
            "    def m(self):\n"
            "        return 3\n"
            "assert ray.get(A.remote().m.remote(), timeout=30) == 3\n"
            "from ray_tpu_torch.rllib import PPOConfig\n"
            "a = PPOConfig(num_env_runners=1, num_envs_per_runner=2, "
            "rollout_len=8, device='cpu').build()\n"
            "assert a.train()['num_env_steps'] == 16\n"
            "a.stop()\n"
            "ray.shutdown()\n"
            "ray.init(num_workers=1, scheduler='tensor', _system_config="
            "{'sched_device': 'cpu', 'worker_mode': 'process', "
            "'qos': True, 'profile_hz': 50.0})\n"
            "@ray.remote\n"
            "def mods():\n"
            "    import os, sys\n"
            "    return os.getpid(), [m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'flax', 'ray_tpu')]\n"
            "pid, loaded = ray.get(mods.remote(), timeout=60)\n"
            "assert pid != os.getpid() and loaded == [], loaded\n"
            "from ray_tpu_torch import data\n"
            "got = data.range(100, parallelism=4).map_batches(lambda b: "
            "[(x * 2, os.getpid(), [m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'flax', 'ray_tpu')]) for x in b])"
            ".take_all()\n"
            "assert [g[0] for g in got] == [2 * i for i in range(100)]\n"
            "assert all(g[1] != os.getpid() and g[2] == [] for g in got)\n"
            "ray.shutdown()\n"
            "assert not torch.cuda.is_initialized()\n"
            "import sys\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', "
            "'ray_tpu.')) or m == 'ray_tpu' for m in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)

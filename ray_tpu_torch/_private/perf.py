"""End-to-end performance measurements of the port.

1. ``e2e_task_throughput`` — task throughput through the PUBLIC API
   (``f.remote()`` -> ``get``), including submit(), the arena, locks,
   the scheduler's assignment (``kernels.assign`` on the card under
   ``sched_backend="cuda"``), dispatch and result plumbing. Counterpart
   of ``e2e_task_throughput`` in ``ray_tpu/_private/perf.py``, in
   thread or process mode.

2. ``data_pipeline_throughput`` — BASELINE config 3: a ``map_batches``
   pipeline through the public ``ray_tpu_torch.data`` API (the streaming
   executor on the runtime above), in blocks/s and rows/s.

3. ``rl_rollout_throughput`` — BASELINE config 5 through the port's
   RLlib: IMPALA's actor-to-learner stream (runner actors stepping
   CartPole on the host, the V-trace learner on the card), in
   env-steps/s and learner ms per update.

4. ``locality_ab`` — one arm of the locality A/B on two remote nodes:
   cross-node argument bytes with the scheduler's locality column on or
   off. Counterpart of the reference's function of that name.

5. ``qos_ab`` — one arm of the QoS-plane A/B on a head and one remote
   node: a two-tenant, two-tier burst with the plane on or off, per-tier
   latency percentiles and the head-skip rate of a racing nested
   submitter. Counterpart of the reference's function of that name.

6. ``model_mfu`` — train-step performance of the flagship transformer on
   one device. The same defaults as the reference's (the repo's training
   configuration: vocab 32768, d_model 2048, 8 layers, 16 query / 8 KV
   heads, d_ff 5632, seq 2048, batch 16, remat "dots"), the same halving
   of the batch on out-of-memory, the same MFU convention (useful model
   flops, 6·N·tokens, over the device's peak). The step's flop count is
   the reference's analytic one (there is no compiler cost analysis
   here), so hfu equals mfu. Runs on the current CUDA device and raises
   without one; only an explicit ``device="cpu"`` runs on the host (the
   tests), where there is no peak and mfu is None.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

# dense bf16 peak FLOP/s by device name (NVIDIA data sheet, H100 SXM)
_PEAK_FLOPS = (
    ("h100", 989e12),
)

# the reference's pinned small config (ray_tpu/_private/perf.py)
SMOKE_MODEL: Dict[str, int] = {
    "d_model": 256, "n_layers": 2, "n_heads": 8, "n_kv_heads": 4,
    "d_ff": 704, "vocab_size": 2048, "seq_len": 256, "batch_size": 4,
    "steps": 3,
}


def _peak_flops(device_kind: str) -> Optional[float]:
    kind = device_kind.lower()
    for key, peak in _PEAK_FLOPS:
        if key in kind:
            return peak
    return None


def e2e_task_throughput(n_tasks: int = 10_000,
                        scheduler: str = "tensor",
                        num_workers: int = 8,
                        batched: bool = False,
                        best_of: int = 1,
                        system_config: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
    """Submit n_tasks no-op tasks through the public API and get() them.

    Measures the full path: RemoteFunction._remote -> Worker.submit ->
    scheduler tick -> dispatch -> execution -> result store -> get.
    batched=True submits through map_remote (the vectorized path the
    libraries use); best_of>1 keeps the fastest trial. ``system_config``
    goes to ``init`` (e.g. ``{"sched_backend": "cuda"}``, or
    ``{"worker_mode": "process"}`` in place of the reference's ``mode``
    argument).
    """
    import resource

    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_workers=num_workers, scheduler=scheduler,
                       _system_config=system_config)
    try:
        @ray_tpu_torch.remote
        def _noop():
            return None

        # Warm the pool / caches (and build the device path's kernels)
        # so the measurement is steady-state.
        ray_tpu_torch.get([_noop.remote() for _ in range(min(200, n_tasks))])

        sched = worker_mod.global_worker.scheduler
        best = None
        for _ in range(max(1, best_of)):
            ticks0 = getattr(sched, "_num_ticks", 0)
            assigns0 = getattr(sched, "_num_device_assigns", 0)
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            t0 = time.perf_counter()
            if batched:
                refs = _noop.map_remote([()] * n_tasks)
            else:
                refs = [_noop.remote() for _ in range(n_tasks)]
            t_submit = time.perf_counter() - t0
            ray_tpu_torch.get(refs)
            trial_dt = time.perf_counter() - t0
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            trial_ticks = getattr(sched, "_num_ticks", 0) - ticks0
            trial_assigns = getattr(sched, "_num_device_assigns", 0) - assigns0
            trial = (trial_dt, t_submit, ru0, ru1, trial_ticks,
                     trial_assigns)
            if best is None or trial_dt < best[0]:
                best = trial
            del refs
        dt, t_submit, ru0, ru1, ticks, assigns = best
        stats = sched.stats()
    finally:
        ray_tpu_torch.shutdown()
    driver_cpu = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
    return {
        "n_tasks": n_tasks,
        "mode": (system_config or {}).get("worker_mode", "thread"),
        "scheduler": scheduler,
        "seconds": dt,
        "tasks_per_sec": n_tasks / dt,
        # per-task host-overhead budget (microseconds)
        "budget_us": {
            "submit": round(t_submit / n_tasks * 1e6, 1),
            "driver_cpu_total": round(driver_cpu / n_tasks * 1e6, 1),
            "wall_total": round(dt / n_tasks * 1e6, 1),
        },
        "sched_ticks": ticks,
        "tasks_per_tick": round(n_tasks / max(ticks, 1), 1),
        # the kept trial's device assignments; the session's totals
        "device_assigns": assigns,
        "device_assigns_total": stats.get("device_assigns", 0),
        "device_assign_errors": stats.get("device_assign_errors", 0),
    }


def data_pipeline_throughput(num_blocks: int = 100_000,
                             rows_per_block: int = 10,
                             num_workers: int = 8,
                             system_config: Optional[Dict[str, Any]] = None,
                             own_runtime: bool = True) -> Dict[str, Any]:
    """BASELINE config 3 through the REAL library: a map_batches pipeline
    over num_blocks blocks via the public ray_tpu_torch.data API
    (streaming executor, backpressure, fused read+map), not a synthetic
    DAG. ``system_config`` goes to ``init`` (e.g. ``{"sched_backend":
    "cuda"}`` or ``{"worker_mode": "process"}``). ``own_runtime=False``
    runs on the caller's runtime (warmed and checked by the caller)
    instead of starting and shutting down one; ``num_workers`` and
    ``system_config`` are then unused. Counterpart of
    ``data_pipeline_throughput`` in ``ray_tpu/_private/perf.py``."""
    import ray_tpu_torch
    from ray_tpu_torch import data
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if own_runtime:
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_workers=num_workers, scheduler="tensor",
                           _system_config=system_config)
    try:
        sched = worker_mod.global_worker.scheduler
        assigns0 = sched.stats().get("device_assigns", 0)
        n_rows = num_blocks * rows_per_block
        ds = data.range(n_rows, parallelism=num_blocks).map_batches(
            lambda b: [x * 2 for x in b])
        t0 = time.perf_counter()
        total = ds.count()
        dt = time.perf_counter() - t0
        assert total == n_rows, (total, n_rows)
        stats = ds.stats()
        sched_stats = sched.stats()
        mode = GLOBAL_CONFIG.worker_mode
    finally:
        if own_runtime:
            ray_tpu_torch.shutdown()
    return {
        "num_blocks": num_blocks,
        "rows": n_rows,
        "count": total,
        "mode": mode,
        "seconds": dt,
        "blocks_per_sec": num_blocks / dt,
        "rows_per_sec": n_rows / dt,
        "stages": stats["stages"] if stats else None,
        # the timed pipeline's device assignments; the session's errors
        "device_assigns": sched_stats.get("device_assigns", 0) - assigns0,
        "device_assign_errors": sched_stats.get("device_assign_errors", 0),
    }


def qos_ab(qos: bool, n_per_tenant: int = 30,
           n_submit: int = 16,
           system_config: Optional[dict] = None) -> Dict[str, Any]:
    """One arm of the QoS-plane A/B: a head + 1-remote-node cluster
    under a mixed two-tenant load (tenant "prod" at priority tier 1,
    weight 3; tenant "batch" at tier 0, weight 1), every task stamping
    its completion wall-clock so the driver gets honest per-task
    latency (submit -> finish) without serializing the gets.

    With ``qos=True`` the head drains by strict tier + weighted
    fair-share and resview frames carry the watermark (a queued tier-1
    backlog makes node daemons spill tier-0 nested submissions). With
    ``qos=False`` — the escape hatch, byte-for-byte the pre-QoS wire —
    the same submission mix runs FIFO. Preemption grace is set long so
    neither arm's latencies include kill/respawn time (the preemption
    path has its own tests).

    The head-skip lane runs DURING the load: a node-resident task
    submits ``n_submit`` nested no-ops, so the on-arm number shows
    what the watermark costs local admission under tier pressure.

    ``system_config`` adds the head's other knobs (the scheduler's
    backend and device). Returns {mode, n_tasks, seconds, tasks_per_sec,
    per-tier p50/p99 ms, head_skip, local_dispatch, spillback,
    spillback_tier, preemptions, total}. ``total`` must match between
    arms."""
    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.cluster_utils import Cluster

    overrides: Dict[str, Any] = {**(system_config or {}), "qos": bool(qos)}
    if qos:
        overrides["tenant_quotas"] = '{"prod": 3, "batch": 1}'
        overrides["preempt_grace_s"] = 300.0
    ray_tpu_torch.shutdown()
    c = Cluster(initialize_head=True,
                head_node_args=dict(
                    num_cpus=2, num_workers=2, scheduler="tensor",
                    _system_config=overrides))
    try:
        c.add_node(num_cpus=2, remote=True, resources={"a": 100.0})
        c.wait_for_nodes()
        w = worker_mod.get_worker()

        @ray_tpu_torch.remote(priority=1, tenant="prod")
        def prod_task(x):
            import time
            time.sleep(0.01)
            return (x, time.time())

        @ray_tpu_torch.remote(tenant="batch")
        def batch_task(x):
            import time
            time.sleep(0.01)
            return (x, time.time())

        @ray_tpu_torch.remote(max_retries=0)
        def _nested_noop():
            return 1

        @ray_tpu_torch.remote(resources={"a": 1.0})
        def submitter(n):
            import ray_tpu_torch
            return sum(ray_tpu_torch.get(
                [_nested_noop.remote() for _ in range(n)],
                timeout=120.0))

        # one saturating burst, tiers interleaved adversarially
        # (every batch submitted before its prod peer), with the
        # head-skip submitter racing the same window
        refs, submits, tiers = [], [], []
        t0 = time.perf_counter()
        sub_ref = submitter.remote(n_submit)
        for i in range(n_per_tenant):
            submits.append(time.time())
            refs.append(batch_task.remote(i))
            tiers.append(0)
            submits.append(time.time())
            refs.append(prod_task.remote(i))
            tiers.append(1)
        out = ray_tpu_torch.get(refs, timeout=300.0)
        wall = time.perf_counter() - t0
        n_done = ray_tpu_torch.get(sub_ref, timeout=120.0)

        lat_ms: Dict[int, list] = {0: [], 1: []}
        total = 0
        for (x, end), t_sub, tier in zip(out, submits, tiers):
            total += x
            lat_ms[tier].append((end - t_sub) * 1000.0)

        def _pct(vals, q):
            vals = sorted(vals)
            return round(vals[min(len(vals) - 1,
                                  int(q * (len(vals) - 1)))], 2)

        stats = dict(w.two_level_stats)
        ld = int(stats.get("local_dispatch", 0))
        sb = int(stats.get("spillback", 0))
        plane = w.qos_plane
        return {
            "mode": "on" if qos else "off",
            "n_tasks": 2 * n_per_tenant,
            "seconds": round(wall, 3),
            "tasks_per_sec": round(2 * n_per_tenant / wall, 1),
            "tier0_p50_ms": _pct(lat_ms[0], 0.50),
            "tier0_p99_ms": _pct(lat_ms[0], 0.99),
            "tier1_p50_ms": _pct(lat_ms[1], 0.50),
            "tier1_p99_ms": _pct(lat_ms[1], 0.99),
            "n_submit": int(n_done),
            "local_dispatch": ld,
            "spillback": sb,
            "spillback_tier": int(stats.get("spillback:tier", 0)),
            "head_skip": (round(ld / (ld + sb), 3) if ld + sb else None),
            "preemptions": (plane.stats()["preemptions_total"]
                            if plane is not None else 0),
            "total": int(total),
        }
    finally:
        c.shutdown()


def rl_rollout_throughput(iters: int = 4, device=None) -> Dict[str, Any]:
    """BASELINE config 5 through the REAL library: IMPALA's async
    pipeline under load, env-steps/s streamed from runner actors through
    the object store into the V-trace learner on ``device`` (None: the
    card, raising without one). The reference's sizes: 4 runners x 8
    envs x 64 steps, 8 updates an iteration; one warm iteration, then
    ``iters`` timed. It runs on the caller's runtime, which the
    reference's configuration starts as ``init(num_workers=8,
    scheduler="tensor")``; ``device_assigns`` counts the whole call, the
    algorithm's build included. Counterpart of ``rl_rollout_throughput``
    in ``ray_tpu/_private/perf.py``, which starts and stops that runtime
    itself."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.rllib import IMPALAConfig

    sched = worker_mod.global_worker.scheduler
    assigns0 = sched.stats().get("device_assigns", 0)
    algo = IMPALAConfig(num_env_runners=4, num_envs_per_runner=8,
                        rollout_len=64, updates_per_iter=8, seed=0,
                        device=device).build()
    try:
        algo.train()  # warm the pipeline
        steps, secs, returns, learner_ms = 0, 0.0, [], []
        for _ in range(iters):
            m = algo.train()
            steps += m["num_env_steps"]
            secs += m["num_env_steps"] / m["env_steps_per_sec"]
            learner_ms.append(m["learner_ms"])
            if m["num_episodes"]:
                returns.append(m["episode_return_mean"])
        dev = str(algo.device)
    finally:
        algo.stop()
    sched_stats = sched.stats()
    return {
        "env_steps_per_sec": steps / max(secs, 1e-9),
        "env_steps": steps,
        "seconds": secs,
        "episode_return_mean": (sum(returns) / len(returns)
                                if returns else None),
        "learner_ms_per_update": sum(learner_ms) / len(learner_ms),
        "learner_ms_by_iteration": learner_ms,
        "learner_device": dev,
        "device_assigns": sched_stats.get("device_assigns", 0) - assigns0,
        "device_assign_errors": sched_stats.get("device_assign_errors", 0),
    }


def locality_ab(locality: bool, n_consumers: int = 8,
                arg_mb: float = 1.0,
                spill_depth: int = 32,
                system_config: Optional[dict] = None) -> Dict[str, Any]:
    """One arm of the locality-scheduling A/B: a 2-remote-node cluster,
    large objects produced on the SOURCE node, a consumer fanout free to
    run on either remote node.

    With ``locality=True`` the scheduler scores candidates by
    resident-arg-bytes and the consumers land (or wait, bounded by
    ``spill_depth``) on the source node — cross-node arg bytes stay
    near zero. With ``locality=False`` (the pre-PR placement) the
    least-loaded fill sends a batch of consumers to the sink node,
    each pulling its argument across. The SINK node is added first so
    the load-tiebreak favors it: the off arm genuinely moves bytes.

    ``system_config`` adds the head's other knobs (the scheduler's
    backend and device). Returns {sum, bytes_pulled, bytes_saved,
    seconds, hits, misses}. ``sum`` must match between arms (equal task
    results)."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.cluster_utils import Cluster

    n = max(1, int(arg_mb * 1024 * 1024) // 8)
    ray_tpu_torch.shutdown()
    c = Cluster(initialize_head=True,
                head_node_args=dict(
                    num_cpus=2, num_workers=2, scheduler="tensor",
                    _system_config={
                        **(system_config or {}),
                        "scheduler_locality": bool(locality),
                        "locality_spillback_queue_depth": spill_depth}))
    try:
        c.add_node(num_cpus=4, remote=True, resources={"r": 100.0})
        c.add_node(num_cpus=4, remote=True,
                   resources={"r": 100.0, "src": 100.0})
        c.wait_for_nodes()
        w = worker_mod.get_worker()

        @ray_tpu_torch.remote(resources={"src": 1.0})
        def produce(i):
            import numpy as np  # task-side: don't close over the
            return np.full(n, float(i))  # driver's local module binding

        @ray_tpu_torch.remote(resources={"r": 1.0})
        def consume(x):
            return float(x[0]) * len(x)

        refs = [produce.remote(i) for i in range(n_consumers)]
        for r in refs:
            ray_tpu_torch.wait([r], timeout=120.0)
        ts = w.transfer_stats
        p0 = ts["bytes_pulled"]
        t0 = time.perf_counter()
        out = ray_tpu_torch.get([consume.remote(r) for r in refs],
                          timeout=300.0)
        dt = time.perf_counter() - t0
        return {
            "locality": bool(locality),
            "n_consumers": n_consumers,
            "arg_mb": arg_mb,
            "sum": float(sum(out)),
            "bytes_pulled": int(ts["bytes_pulled"] - p0),
            "bytes_saved": int(ts["bytes_saved"]),
            "hits": int(ts["locality_hits"]),
            "misses": int(ts["locality_misses"]),
            "seconds": round(dt, 3),
        }
    finally:
        c.shutdown()


def flops_per_step(n_params: int, batch: int, seq: int) -> float:
    """Analytic fwd+bwd flops of one step: 6 * n_params * tokens."""
    return 6.0 * n_params * batch * seq


def model_mfu(d_model: int = 2048, n_layers: int = 8, n_heads: int = 16,
              n_kv_heads: int = 8, d_ff: int = 5632,
              vocab_size: int = 32_768, seq_len: int = 2048,
              batch_size: int = 16, steps: int = 10,
              smoke: bool = False, remat_policy: str = "dots",
              device=None) -> Dict[str, Any]:
    """Flagship transformer train-step perf on ``device``.

    Random parameters (seed 0) and random tokens (seed 1) made on the
    device; the same batch every step. One untimed step, then ``steps``
    steps timed between two device synchronisations. Adaptive batch:
    halves on out-of-memory until the step fits. Returns step_ms,
    tokens_per_sec, flops_per_step, mfu, device info and the last loss."""
    from ray_tpu_torch.models import train_step as ts
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  init_params, param_count,
                                                  resolve_device)

    dev = resolve_device(device, "model_mfu")
    if smoke:
        sm = SMOKE_MODEL
        d_model, n_layers = sm["d_model"], sm["n_layers"]
        n_heads, n_kv_heads = sm["n_heads"], sm["n_kv_heads"]
        d_ff, vocab_size = sm["d_ff"], sm["vocab_size"]
        seq_len, batch_size, steps = (sm["seq_len"], sm["batch_size"],
                                      sm["steps"])
    cfg = TransformerConfig(vocab_size=vocab_size, d_model=d_model,
                            n_layers=n_layers, n_heads=n_heads,
                            n_kv_heads=n_kv_heads, d_ff=d_ff,
                            max_seq_len=seq_len, remat=not smoke,
                            remat_policy=remat_policy)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    last_err = None
    while batch_size >= 1:
        try:
            gen = torch.Generator(device=dev)
            params = init_params(cfg, gen.manual_seed(0))
            n_params = param_count(params)
            model = Transformer(cfg, device=dev).load_params(params)
            del params
            # random tokens: constant data is memorised within a few steps
            tokens = torch.randint(0, vocab_size, (batch_size, seq_len),
                                   generator=gen.manual_seed(1), device=dev)
            batch = {"tokens": tokens}
            optimizer = ts.make_optimizer(model.parameters())
            step = ts.make_train_step(model, optimizer)
            step(batch)
            sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                metrics = step(batch)
            sync()
            dt = (time.perf_counter() - t0) / steps
            break
        except torch.cuda.OutOfMemoryError as e:
            last_err = str(e)   # not e: its traceback holds the tensors
        model = optimizer = step = batch = tokens = metrics = None
        if cuda:
            torch.cuda.empty_cache()
        batch_size //= 2
    else:
        raise RuntimeError(f"model_mfu: could not fit batch: {last_err}")

    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    peak = _peak_flops(name) if cuda else None
    # MFU convention: USEFUL model flops (6·N·D) over peak — remat
    # recompute does not count
    model_flops = flops_per_step(n_params, batch_size, seq_len)
    return {
        "device": name,
        "platform": "gpu" if cuda else "cpu",
        "n_params": int(n_params),
        "batch_size": batch_size,
        "seq_len": seq_len,
        "step_ms": dt * 1e3,
        "tokens_per_sec": batch_size * seq_len / dt,
        "flops_per_step": model_flops,
        "model_flops_per_step": model_flops,
        "model_flops_per_sec": model_flops / dt,
        "hardware_flops_per_sec": model_flops / dt,
        "peak_flops": peak,
        "mfu": (model_flops / dt / peak) if peak else None,
        "hfu": (model_flops / dt / peak) if peak else None,
        "loss": float(metrics["loss"]),
    }

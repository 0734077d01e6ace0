"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The port grows slice by slice beside the JAX package (``ray_tpu``), which
stays the reference it is tested against. Module names follow
``ray_tpu``'s so each counterpart is easy to find. The port imports
``torch`` and never ``jax``, ``flax`` or anything under ``ray_tpu``.

Ported so far: the runtime core (``init``, ``remote``, ``get``, ``put``,
``wait``, ``cancel``, ``ObjectRef``, actors, placement groups) with the
thread worker pool and, under ``worker_mode="process"``, exec'd worker
processes and a shared-memory object store, on the array-state
scheduler, whose batched assignment and whole-DAG tick run as
hand-written CUDA kernels (``ops/csrc/scheduler_tick.cu``); Serve on that
runtime (deployments,
the router, HTTP/SSE and gRPC ingress, the disaggregated prefill/decode
pools, the Prometheus metrics plane); the LLM serving engine; the
training step; and ring attention (sequence parallelism over a mesh's
``seq`` axis), with every TPU kernel of the JAX package as a
hand-written CUDA kernel.

    import ray_tpu_torch as ray

    ray.init()                          # TensorScheduler, assigns on "cuda"

    @ray.remote
    def f(x):
        return x * 2

    ray.get(f.remote(21))               # 42

    @ray.remote(num_gpus=1)
    class Server:                       # an actor holding a model
        def __init__(self, params, cfg, icfg):
            self.engine = InferenceEngine(params, cfg, icfg)

        def generate(self, prompt, n):
            return self.engine.generate(prompt, max_new_tokens=n)

Serve puts one engine (and with it the paged-attention kernel) behind
each replica actor; in thread mode every replica shares the caller's
parameter tensors:

    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import build_llm_app, run_disagg_llm

    handle = serve.run(build_llm_app(params, cfg, icfg))   # engines on "cuda"
    ray.get(handle.generate.remote([1, 2, 3], 16))
    port = serve.start_http(0)          # POST /llm, POST /llm/stream (SSE)
    serve.shutdown()                    # stops every replica's engine

    split = run_disagg_llm(params, cfg, icfg, prefill_replicas=1,
                           decode_replicas=1)
    for frame in split.stream_frames([1, 2, 3], 16, session_id="s1"):
        print(frame["tokens"])          # first token straight off prefill

Process mode runs tasks and single-threaded actors in worker processes
(large values travel through the shared-memory arena; ``get`` returns a
CPU tensor viewing the arena, a CUDA tensor put comes back on the host).
Workers see no CUDA device unless ``worker_gpu_access`` is set; only then
does the node offer GPUs, so a ``num_gpus`` actor owns the card in its
own process:

    ray.init(_system_config={"worker_mode": "process",
                             "worker_gpu_access": True})
    server = Server.remote(params, cfg, icfg)   # in its own process; the
                                                # params go through the arena

``init(_system_config={"metrics_export_port": port})`` serves the
Prometheus text endpoint (Serve's families included); the deployments
take ``device="cpu"`` to run their engines' plain path on the host.

On a host without CUDA, ``init`` raises unless the scheduler's device
path is told to run its plain version on the host:
``ray.init(_system_config={"sched_device": "cpu"})`` (the tests), or
``sched_backend="numpy"``.

    from ray_tpu_torch.models.inference import InferenceConfig, InferenceEngine
    from ray_tpu_torch.models.train_step import make_optimizer, make_train_step
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  init_params)

    cfg = TransformerConfig(...)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    engine = InferenceEngine(params, cfg, InferenceConfig(...))  # on "cuda"
    tokens = engine.generate([1, 2, 3], max_new_tokens=16)

    model = Transformer(cfg).load_params(params)                 # on "cuda"
    step = make_train_step(model, make_optimizer(model.parameters()))
    metrics = step({"tokens": batch})      # {"loss", "grad_norm"}; in place

    from ray_tpu_torch.models.train_step import make_forward
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh, use_mesh

    ring = Transformer(dataclasses.replace(cfg, ring_attention=True))
    ring.load_params(params)
    mesh = make_mesh(MeshConfig(seq=4), ["cuda:0"] * 4)  # one card, 4 shards
    with use_mesh(mesh):
        logits = make_forward(ring)(long_tokens)   # forward only on the card

On the CPU the ring runs over ``make_mesh(MeshConfig(seq=n), ["cpu"] * n)``
and is differentiable there; on the card its block kernel has no
backward, and a call that autograd would differentiate raises.

Entry points run on the card unless the caller passes ``device="cpu"``.
On the card, every kernel runs as the hand-written CUDA kernel in
``ops/csrc``; there is no fallback to a plain PyTorch path. Importing the
package neither initialises CUDA nor builds a kernel.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch import chaos  # noqa: F401
from ray_tpu_torch import exceptions  # noqa: F401
from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.config import GLOBAL_CONFIG as _config  # noqa: F401
from ray_tpu_torch._private.ids import (ActorID, JobID, NodeID,  # noqa: F401
                                        ObjectID, PlacementGroupID, TaskID,
                                        WorkerID)
from ray_tpu_torch._private.object_ref import ObjectRef  # noqa: F401
from ray_tpu_torch.actor import (ActorClass, ActorHandle,  # noqa: F401
                                 get_actor, kill)
from ray_tpu_torch.remote_function import RemoteFunction, remote  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "cancel", "kill", "get_actor", "ObjectRef", "ActorHandle", "method",
    "available_resources", "cluster_resources", "nodes", "timeline",
    "trace", "profile", "snapshot_cluster", "restore_cluster",
    "get_runtime_context", "chaos", "__version__",
]


def snapshot_cluster(path: str) -> dict:
    """Checkpoint control-plane tables + scheduler state (incl. the
    tensor scheduler's resident arrays) to a file. Reference role: GCS
    persistence/restart; see _private/snapshot.py."""
    from ray_tpu_torch._private.snapshot import save_cluster_state

    return save_cluster_state(_worker.get_worker(), path)


def restore_cluster(path: str) -> dict:
    """Restore a snapshot into this session: KV re-populates and
    pending tasks resubmit under their original return ids."""
    from ray_tpu_torch._private.snapshot import load_cluster_state

    return load_cluster_state(_worker.get_worker(), path)


def timeline(filename: Optional[str] = None):
    """Chrome-trace events for task execution (reference: ray.timeline);
    writes JSON to filename when given, else returns the event list.

    Sourced from the cluster-wide task event plane: per task, a dep-wait
    span and a queue span on the scheduler lane plus an exec span on the
    owning (node, worker) lane — remote-node timestamps aligned onto the
    head's clock via the daemon handshake offset. Retries and failures
    appear as instant events. Works over ray:// (renders head-side)."""
    from ray_tpu_torch.util.state import task_timeline

    events = task_timeline()
    if filename is not None:
        import json

        with open(filename, "w") as f:
            json.dump(events, f)
        return filename
    return events


def trace(trace_id: Optional[str] = None, filename: Optional[str] = None):
    """Perfetto/Chrome-trace events for one distributed trace; writes
    JSON to filename when given, else returns the event list.

    With ``trace_id=None`` the most recently active trace is exported.
    Sourced from the trace plane: per logical span, a submit→resolve
    span on the driver lane, per-attempt scheduler-decision spans, and
    exec spans on the owning (node, worker) lanes — all on the head's
    clock axis, with flow arrows connecting dispatch→exec and parent
    exec→child exec across lanes. Retried attempts land under the same
    logical span. Works over ray:// (renders head-side)."""
    from ray_tpu_torch.util.state import get_trace, list_traces

    if trace_id is None:
        rows = list_traces()
        trace_id = rows[0]["trace_id"] if rows else None
    events = get_trace(trace_id) if trace_id is not None else []
    if filename is not None:
        import json

        with open(filename, "w") as f:
            json.dump(events, f)
        return filename
    return events


def profile(duration_s: float = 5.0, filename: Optional[str] = None):
    """Flamegraph of the last ``duration_s`` seconds of cluster CPU
    time, from the continuous profiler (requires ``profile_hz > 0``).

    Snapshots the profile plane's folded-stack counts, sleeps
    ``duration_s``, snapshots again and diffs — so the report covers
    exactly the window, not the whole session. Returns a dict with
    ``collapsed`` (Brendan Gregg folded-stack text), ``speedscope``
    (drop the JSON on speedscope.app), ``top_tasks`` (samples + CPU
    share by task) and ``samples``. With ``filename`` writes the
    speedscope JSON (or the collapsed text for ``.txt``/``.folded``
    names) and returns the path. Works over ray:// (stack counts read
    head-side)."""
    import time as _time

    from ray_tpu_torch._private import profile_plane as _pp
    from ray_tpu_torch.util.state import profile_stacks

    key = (lambda r: (r["node"], r["task"], r["stack"]))
    base = {key(r): r["count"] for r in profile_stacks()}
    _time.sleep(duration_s)
    rows = []
    for r in profile_stacks():
        delta = r["count"] - base.get(key(r), 0)
        if delta > 0:
            rows.append(dict(r, count=delta))
    report = _pp.flamegraph_report(rows)
    if filename is not None:
        if filename.endswith((".txt", ".folded")):
            with open(filename, "w") as f:
                f.write(report["collapsed"])
        else:
            import json

            with open(filename, "w") as f:
                json.dump(report["speedscope"], f)
        return filename
    return report


def init(*args, **kwargs):
    """Start the runtime. Idempotent with ignore_reinit_error=True.

    Reference: ray.init (python/ray/_private/worker.py).
    """
    return _worker.init(*args, **kwargs)


def shutdown():
    _worker.shutdown()


def is_initialized() -> bool:
    return _worker.is_initialized()


def put(value: Any) -> ObjectRef:
    return _worker.get_worker().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    worker = _worker.get_worker()
    if isinstance(refs, ObjectRef):
        return worker.get([refs], timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError("ray_tpu_torch.get() takes an ObjectRef or a list of them, "
                        f"got {type(refs).__name__}")
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError("ray_tpu_torch.get() list elements must be ObjectRefs, "
                            f"got {type(r).__name__}")
    return worker.get(list(refs), timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None,
         fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    """fetch_local note: the object plane is a single owner store + one
    node-shared arena, so readiness and local availability coincide —
    both fetch_local settings behave identically BY DESIGN (in the
    reference they differ only when objects live on remote nodes)."""
    if isinstance(refs, ObjectRef):
        raise TypeError("ray_tpu_torch.wait() takes a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError(f"num_returns={num_returns} exceeds {len(refs)} refs")
    if num_returns <= 0:
        raise ValueError("num_returns must be >= 1")
    return _worker.get_worker().wait(list(refs), num_returns, timeout)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    """LIMITATION: recursive cancellation of a task's descendants is not
    implemented (child-task lineage is tracked for reconstruction, not
    submission trees); recursive=True cancels only the task itself.
    force=True kills process-mode workers mid-task; thread mode is
    cooperative-only."""
    _worker.get_worker().cancel_task(ref, force=force)


def method(num_returns: int = 1, concurrency_group: str = None):
    """Decorator to set per-method defaults on actor methods.
    ``concurrency_group`` routes the method to a NAMED thread pool
    declared via ``@remote(concurrency_groups={...})`` (reference:
    ray.method(concurrency_group=...))."""
    def deco(f):
        f.__ray_tpu_num_returns__ = num_returns
        if concurrency_group is not None:
            f.__ray_tpu_concurrency_group__ = concurrency_group
        return f
    return deco


def available_resources() -> dict:
    """Cluster-wide free resources over PHYSICAL nodes (placement-group
    bundle rows are reservations, not new capacity)."""
    w = _worker.get_worker()
    if getattr(w, "is_client", False):
        return w.state("available_resources")
    stats = w.scheduler.stats()
    out: dict = {}
    from ray_tpu_torch._private.task_spec import RESOURCE_NAMES
    for node in stats.get("nodes", []):
        if node.get("is_bundle"):
            continue
        for name, avail in zip(RESOURCE_NAMES, node["available"]):
            out[name] = out.get(name, 0.0) + avail
        # per-name availability mirrors cluster_resources()' per-name
        # capacities (the reference idiom diffs the two dicts by name)
        for name, avail in node.get("custom_avail", {}).items():
            out[name] = out.get(name, 0.0) + avail
    return out


def cluster_resources() -> dict:
    w = _worker.get_worker()
    if getattr(w, "is_client", False):
        return w.state("cluster_resources")
    stats = w.scheduler.stats()
    out: dict = {}
    from ray_tpu_torch._private.task_spec import RESOURCE_NAMES
    for node in stats.get("nodes", []):
        if node.get("is_bundle"):
            continue
        for name, cap in zip(RESOURCE_NAMES, node["capacity"]):
            out[name] = out.get(name, 0.0) + cap
        # named customs reported per-name (reference semantics); the
        # aggregate stays under "custom"
        for name, cap in node.get("custom", {}).items():
            out[name] = out.get(name, 0.0) + cap
    return out


def nodes() -> List[dict]:
    w = _worker.get_worker()
    if getattr(w, "is_client", False):
        return w.state("nodes")
    stats = w.scheduler.stats()
    from ray_tpu_torch._private.task_spec import RESOURCE_NAMES
    return [
        {"NodeID": i, "Alive": any(c > 0 for c in n["capacity"]),
         "Resources": dict(zip(RESOURCE_NAMES, n["capacity"]))}
        for i, n in enumerate(stats.get("nodes", []))
        if not n.get("is_bundle")
    ]


class RuntimeContext:
    """Reference: ray.runtime_context.RuntimeContext."""

    @property
    def job_id(self) -> JobID:
        return _worker.get_worker().job_id

    @property
    def task_id(self) -> TaskID:
        return _worker.get_worker().current_task_id

    @property
    def worker_id(self) -> WorkerID:
        return _worker.get_worker().worker_id

    def get_job_id(self) -> str:
        return self.job_id.hex()

    def get_task_id(self) -> str:
        return self.task_id.hex()

    def was_current_actor_restarted(self) -> bool:
        return False


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()

"""Core worker: task submission + execution engine + object access.

Reference surfaces: ray src/ray/core_worker/core_worker.cc (CoreWorker:
SubmitTask/Put/Get/Wait, ownership), task_manager.cc (TaskManager:
pending tasks, retries, lineage), python/ray/_private/worker.py (the
module-level API: init/shutdown/get/put/wait/cancel).

Two worker modes: in thread mode the driver and all workers share one
process and workers are threads in an executor pool; in process mode
(``worker_mode="process"``, and every node ``add_cluster_node`` adds)
tasks and sync actors run in exec'd worker processes, with large objects
in a shared-memory arena (``runtime/``). Remote nodes
(``add_remote_cluster_node``) are node-daemon processes with arenas of
their own, reached over TCP through the head endpoint, which also serves
``ray://`` clients (``enable_head_endpoint``). The scheduler is
pluggable (event-driven oracle or device-tensor scheduler). The optional
planes, QoS (``qos``) and the profile plane (``profile_hz``), are off by
default and start here when their knob is on.
"""

from __future__ import annotations

import collections
import heapq
from collections import OrderedDict
import logging
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private.analysis import runtime_sanitizer
from ray_tpu_torch._private.chaos import get_controller as _chaos_controller
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import (ActorID, JobID, NodeID, ObjectID, TaskID,
                                  WorkerID, _Counter)
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.object_store import MemoryStore
from ray_tpu_torch._private.ref_counting import ReferenceCounter
from ray_tpu_torch._private.scheduler.base import PendingTask, SchedulerBase
from ray_tpu_torch._private.scheduler.local import EventScheduler, NodeState
from ray_tpu_torch._private.task_spec import TaskSpec, TaskType
from ray_tpu_torch._private import trace_plane

logger = logging.getLogger(__name__)

global_worker: Optional["Worker"] = None

_init_lock = threading.Lock()
_gc_tuned = False
_gc_saved_threshold = (700, 10, 10)


def _noop_exec(task, node_index) -> None:
    """Placeholder PendingTask.execute (dispatch goes through the
    worker's dispatcher, not the task) — shared, not a per-task lambda."""


def _task_error_type(exc: BaseException) -> str:
    """Error-type label for task event records: unwrap one chaining
    level so TaskError(ValueError) reports "ValueError", not the
    wrapper."""
    cause = getattr(exc, "__cause__", None)
    return type(cause).__name__ if cause is not None else type(exc).__name__


class _TaskContext(threading.local):
    """Per-thread execution context (reference: WorkerContext)."""

    def __init__(self):
        self.task_id: Optional[TaskID] = None
        self.put_counter = 0
        self.actor_id: Optional[ActorID] = None
        self.cancel_requested = False


class TaskManager:
    """Owner-side pending-task table: retries + lineage.

    Reference: src/ray/core_worker/task_manager.cc — AddPendingTask,
    retry-on-failure resubmission, lineage kept while returned objects
    remain in scope (capped by max_lineage_bytes).
    """

    def __init__(self, worker: "Worker"):
        self._worker = worker
        self._lock = threading.RLock()
        self._pending: Dict[TaskID, Tuple[TaskSpec, List[ObjectID]]] = {}
        # original-id -> current retry id for in-flight retries
        self._pending_origin: Dict[TaskID, TaskID] = {}
        self._lineage: Dict[TaskID, TaskSpec] = {}
        self._lineage_bytes = 0
        self._lineage_cap = GLOBAL_CONFIG.entry("max_lineage_bytes")
        self.num_retries = 0

    def add_pending(self, spec: TaskSpec, deps: List[ObjectID]) -> None:
        with self._lock:
            self._pending[spec.task_id] = (spec, deps)

    def add_pending_batch(self, specs: List[TaskSpec]) -> None:
        """One lock hold; deps must already be memoized on each spec."""
        with self._lock:
            pending = self._pending
            for spec in specs:
                pending[spec.task_id] = (spec, spec._deps_memo)

    def filter_not_pending(self, object_ids: List[ObjectID]) -> List[ObjectID]:
        """Ids whose producing task is NOT in flight (one lock hold) —
        the recovery path's bulk pre-filter."""
        with self._lock:
            pending = self._pending
            origin = self._pending_origin
            out = []
            for oid in object_ids:
                tid = oid.task_id()
                if tid in pending or origin.get(tid) in pending:
                    continue
                out.append(oid)
            return out

    def rekey_pending(self, old_id: TaskID, spec: TaskSpec,
                      deps: List[ObjectID]) -> None:
        """A retry gets a fresh attempt id: move the pending entry (the
        old id would otherwise leak and shadow lineage lookups forever)
        and remember the ORIGINAL id — return ids derive from it, and
        recovery/lineage must resolve through it."""
        with self._lock:
            self._pending.pop(old_id, None)
            self._pending[spec.task_id] = (spec, deps)
            rr = getattr(spec, "_retry_return_ids", None)
            origin = rr[0].task_id() if rr else old_id
            self._pending_origin[origin] = spec.task_id
        plane = self._worker.qos_plane
        if plane is not None:
            plane.note_rekeyed(old_id, spec.task_id)

    def pending_spec_for_object(self, oid: ObjectID) -> Optional[TaskSpec]:
        """The in-flight spec that will produce oid, or None if its
        task already completed (return ids derive from the ORIGINAL
        task id, so retries resolve through _pending_origin)."""
        with self._lock:
            tid = oid.task_id()
            tid = self._pending_origin.get(tid, tid)
            entry = self._pending.get(tid)
            return entry[0] if entry else None

    def complete(self, task_id: TaskID) -> None:
        with self._lock:
            self._complete_locked(task_id)

    def complete_batch(self, task_ids: List[TaskID]) -> None:
        """One lock hold for a drain-loop's worth of completions (the
        fast-path executor defers these — lineage bookkeeping never
        gates scheduling, unlike the finished-notification)."""
        with self._lock:
            for task_id in task_ids:
                self._complete_locked(task_id)

    def complete_batch_with_refs(self, pairs,
                                 has_reference) -> None:
        """Deferred completion for the fast path: ``pairs`` is
        [(task_id, return_oid)]. Because these completions run AFTER
        the object-ready notification, the return ref may already be
        dead — its out-of-scope eviction would then have run before
        this lineage insert, stranding the spec in ``_lineage``
        forever. Checking liveness under the table lock closes that
        window (a concurrent eviction blocks on this same lock)."""
        plane = self._worker.qos_plane
        with self._lock:
            for task_id, oid in pairs:
                entry = self._pending.pop(task_id, None)
                if entry is None:
                    continue
                if plane is not None:
                    plane.note_done(task_id)
                spec, _ = entry
                rr = getattr(spec, "_retry_return_ids", None)
                key = rr[0].task_id() if rr else task_id
                self._pending_origin.pop(key, None)
                if not has_reference(oid):
                    continue  # returns already dead: nothing to recover
                if key not in self._lineage:
                    self._lineage_bytes += 256
                self._lineage[key] = spec
                if self._lineage_bytes > self._lineage_cap.value:
                    self._evict_lineage_locked()

    def _complete_locked(self, task_id: TaskID) -> None:
        entry = self._pending.pop(task_id, None)
        if entry is not None:
            plane = self._worker.qos_plane
            if plane is not None:
                plane.note_done(task_id)
            spec, _ = entry
            # retain lineage for reconstruction while returns in
            # scope — keyed by the id the RETURN ids derive from, so
            # recovery of a retried/reconstructed task's outputs
            # still finds the spec
            rr = getattr(spec, "_retry_return_ids", None)
            key = rr[0].task_id() if rr else task_id
            self._pending_origin.pop(key, None)
            if key not in self._lineage:  # overwrites don't grow
                self._lineage_bytes += 256  # coarse estimate per spec
            self._lineage[key] = spec
            if self._lineage_bytes > self._lineage_cap.value:
                self._evict_lineage_locked()

    def should_retry(self, spec: TaskSpec, exc: BaseException) -> bool:
        if spec.attempt_number >= spec.max_retries:
            return False
        if isinstance(exc, (rex.WorkerCrashedError, rex.OutOfMemoryError,
                            rex.NodeDiedError, rex.TaskTimeoutError)):
            return True  # system failures always retriable up to max_retries
        retry_exc = spec.retry_exceptions
        if retry_exc is True:
            return True
        if isinstance(retry_exc, (list, tuple)):
            return isinstance(exc, tuple(retry_exc))
        return False

    def get_lineage(self, task_id: TaskID) -> Optional[TaskSpec]:
        with self._lock:
            return self._lineage.get(task_id)

    def get_pending_spec(self, task_id: TaskID) -> Optional[TaskSpec]:
        with self._lock:
            entry = self._pending.get(task_id)
            if entry is None:
                # the task may be in flight under a retry id
                current = self._pending_origin.get(task_id)
                if current is not None:
                    entry = self._pending.get(current)
            return entry[0] if entry is not None else None

    def evict_lineage(self, task_id: TaskID) -> None:
        with self._lock:
            if self._lineage.pop(task_id, None) is not None:
                self._lineage_bytes -= 256

    def evict_lineage_batch(self, object_ids: List[ObjectID]) -> None:
        """One lock hold for a whole out-of-scope drain."""
        with self._lock:
            pop = self._lineage.pop
            for oid in object_ids:
                if pop(oid.task_id(), None) is not None:
                    self._lineage_bytes -= 256

    def _evict_lineage_locked(self):
        while self._lineage_bytes > self._lineage_cap.value // 2 \
                and self._lineage:
            self._lineage.pop(next(iter(self._lineage)))
            self._lineage_bytes -= 256

    def num_pending(self) -> int:
        with self._lock:
            return len(self._pending)


class _Dispatcher:
    """Scheduler -> execution boundary. Callable for one task (every
    scheduler supports this); dispatch_many lets batch-aware schedulers
    hand a whole tick's grants over at once (per-worker message
    coalescing in the process pools)."""

    __slots__ = ("_worker",)

    def __init__(self, worker: "Worker"):
        self._worker = worker

    def __call__(self, pending) -> None:
        plane = self._worker.qos_plane
        if plane is not None:
            plane.note_dispatched(pending.spec.task_id)
        self._worker._dispatch(pending)

    def dispatch_many(self, pendings) -> None:
        plane = self._worker.qos_plane
        if plane is not None:
            for pending in pendings:
                plane.note_dispatched(pending.spec.task_id)
        self._worker._dispatch_many(pendings)


class _WorkQueue:
    """Purpose-built thread-pool for the execution hot path.

    ThreadPoolExecutor pays, per submission, a Future (one Condition
    allocation), a set_result notify, and an unconditional queue notify
    — all discarded by the dispatcher, which never reads the Future.
    This pool is fire-and-forget: no Future, and the wake notify is
    skipped whenever no thread is parked (under load none are)."""

    def __init__(self, nworkers: int, name: str = "ray_tpu_worker"):
        self.num_threads = nworkers
        self._cv = threading.Condition()
        self._q: collections.deque = collections.deque()
        self._idle = 0
        self._stop = False
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"{name}_{i}") for i in range(nworkers)]
        for t in self._threads:
            t.start()
        # ThreadPoolExecutor's non-daemon threads drained the queue at
        # interpreter exit; daemon threads need an explicit atexit drain
        # to keep that guarantee (unregistered by shutdown())
        import atexit
        atexit.register(self._drain_at_exit)

    def _drain_at_exit(self) -> None:
        if not self._stop:
            self.shutdown(wait=True)

    def submit(self, fn, *args) -> None:
        with self._cv:
            if self._stop:
                raise RuntimeError(
                    "cannot schedule new futures after shutdown")
            self._q.append((fn, args))
            if self._idle:
                self._cv.notify()

    def submit_many(self, items) -> None:
        """Enqueue [(fn, args), ...] under ONE lock acquisition."""
        with self._cv:
            if self._stop:
                raise RuntimeError(
                    "cannot schedule new futures after shutdown")
            self._q.extend(items)
            if self._idle:
                self._cv.notify(min(len(items), self._idle))

    def _run(self) -> None:
        cv, q = self._cv, self._q
        while True:
            with cv:
                while not q and not self._stop:
                    self._idle += 1
                    cv.wait()
                    self._idle -= 1
                if not q:
                    return  # stopping and drained
                fn, args = q.popleft()
            try:
                fn(*args)
            except BaseException:  # noqa: BLE001
                logger.exception("executor task failed")
            # drop the call's references before parking: an idle thread
            # would otherwise hold its last batch (and the ObjectRefs in
            # its specs' args) until its next task
            fn = args = None

    def shutdown(self, wait: bool = False,
                 cancel_futures: bool = False) -> None:
        with self._cv:
            self._stop = True
            if cancel_futures:
                self._q.clear()
            self._cv.notify_all()
        import atexit
        atexit.unregister(self._drain_at_exit)
        if wait:
            # workers drain the remaining queue before exiting (the run
            # loop only returns once stopped AND empty), so joining them
            # gives ThreadPoolExecutor's shutdown(wait=True) semantics
            me = threading.current_thread()
            for t in self._threads:
                if t is not me:
                    t.join()


class Worker:
    """The in-process runtime: one per driver/worker process."""

    def __init__(self, *, num_cpus: Optional[float] = None,
                 num_workers: Optional[int] = None,
                 scheduler_factory: Optional[Callable] = None,
                 job_id: Optional[JobID] = None,
                 resources: Optional[Dict[str, float]] = None,
                 log_to_driver: bool = True):
        self.job_id = job_id or JobID.from_random()
        self.worker_id = WorkerID.from_random()
        self.alive = True
        self._context = _TaskContext()
        self._driver_task_id = TaskID.of(self.job_id)
        self._driver_put_seq = _Counter()
        self._task_seq = _Counter()
        # ONE random 8-byte namespace for this worker's task ids; the
        # sequence provides uniqueness within it (an os.urandom syscall
        # per task id was a measurable slice of the submission path)
        self._task_unique = os.urandom(8)

        self.memory_store = MemoryStore()
        self._oos_q: collections.deque = collections.deque()
        # flips when a REMOTE node pool registers: only then can a
        # dying ref have a remote copy worth a per-ref GCS lookup
        self._has_remote_nodes = False
        # one-shot guard for the post-failover lease reconciler (kicked
        # by the first daemon rejoin after a journaled head restart)
        self._failover_reconciler_started = False
        self.reference_counter = ReferenceCounter(self._on_object_out_of_scope)
        # declared before the task manager / scheduler exist: both read
        # it on their hot paths (None = QoS plane off)
        self.qos_plane = None
        self.task_manager = TaskManager(self)

        nworkers = num_workers or GLOBAL_CONFIG.num_workers or os.cpu_count() or 4
        self.num_workers = nworkers
        capacity_cpu = num_cpus if num_cpus is not None else float(nworkers)
        self._pool = _WorkQueue(nworkers)

        # log plane: resolve the session log directory BEFORE any pool
        # can exec a worker — spawners name each child's capture files
        # inside it. A `log_dir` knob that is set but unusable raises
        # (loud by design); the default /tmp path degrades to
        # capture-off with a warning.
        from ray_tpu_torch._private import log_plane
        self.session_log_dir: Optional[str] = None
        if GLOBAL_CONFIG.log_capture:
            try:
                self.session_log_dir = log_plane.resolve_session_log_dir(
                    GLOBAL_CONFIG.log_dir)
            except OSError as e:
                logger.warning("log capture disabled: cannot create "
                               "session log dir (%s)", e)
        log_plane.set_session_log_dir(self.session_log_dir)

        # process mode: exec'd worker processes + the shm object store
        # (reference: raylet WorkerPool + plasma). Thread mode keeps the
        # single-process semantics as the conformance oracle.
        self.shm_store = None
        self.process_pool = None
        if GLOBAL_CONFIG.worker_mode == "process":
            from ray_tpu_torch._private.runtime.process_pool import (
                ProcessWorkerPool)
            from ray_tpu_torch._private.runtime.shm_store import (
                ShmObjectStore)
            self.shm_store = ShmObjectStore(GLOBAL_CONFIG.object_store_memory)
            self.process_pool = ProcessWorkerPool(self, nworkers,
                                                  self.shm_store)

        # node 0 = "this node"; virtual cluster tests add more. Named
        # custom resources must be DECLARED (init(resources={...})) to be
        # schedulable here — an undeclared name parks tasks as infeasible
        # until a node providing it joins (reference semantics).
        self.node_id = NodeID.from_random()
        head_custom = dict(resources or {})
        # thread mode gets a dispatch window too: the bounded executor
        # (max_workers=n) queues over-dispatched tasks while running at
        # most n concurrently — the same guarantee the process pool's
        # worker pipes give
        from ray_tpu_torch._private.runtime.process_pool import (
            auto_pipeline_depth)
        win = (self.process_pool._pipeline_depth
               if self.process_pool is not None
               else auto_pipeline_depth(nworkers))
        # the head's GPUs: the card the driver sees, unless its work runs
        # in worker processes that are not given the card (then none: a
        # num_gpus task or actor must not run on the host's CPU)
        gpus = (_detect_gpu_count()
                if self.process_pool is None
                or GLOBAL_CONFIG.worker_gpu_access else 0.0)
        node = NodeState((capacity_cpu, gpus, 1e18,
                          sum(head_custom.values())),
                         node_id=self.node_id,
                         custom_resources=head_custom,
                         window_factor=win)
        contains = self.memory_store.contains
        dispatcher = _Dispatcher(self)
        if scheduler_factory is not None:
            self.scheduler: SchedulerBase = scheduler_factory(
                [node], dispatcher, contains)
        else:
            self.scheduler = EventScheduler([node], dispatcher, contains)

        # control plane (node/actor/job tables, KV, pubsub, health checks)
        from ray_tpu_torch._private.gcs import GcsJournal, GcsService
        journal = None
        if GLOBAL_CONFIG.gcs_journal_path:
            journal = GcsJournal(GLOBAL_CONFIG.gcs_journal_path)
        self.gcs = GcsService(self, journal=journal)
        self.gcs.register_node(
            self.node_id, 0,
            {"CPU": capacity_cpu, "GPU": gpus, **head_custom},
            kind="process" if self.process_pool is not None else "local",
            pool=self.process_pool)
        self.gcs.register_job(self.job_id)
        # per-node worker pools (row -> ProcessWorkerPool); node 0's pool
        # is process_pool
        self._node_pools: Dict[int, Any] = {}
        # pools of nodes that died: out of the table, still holding their
        # accept and demux threads and listener until shutdown()
        self._dead_pools: List[Any] = []
        if self.process_pool is not None:
            self._node_pools[0] = self.process_pool
        # TCP registration endpoint for remote node daemons / clients
        # (created lazily with the first remote node)
        self._head_server = None
        self.client_server = None

        # cross-node transfer accounting (tests assert the head's relay
        # stays flat when a direct peer path exists). locality_hit/miss
        # count dispatches whose args were fully/partially resident on
        # the chosen node; bytes_pulled is cross-node staging traffic,
        # bytes_saved is arg bytes already resident where the task ran.
        # mutated from the scheduler tick, daemon demux threads, and
        # head pull paths concurrently — all writers go through
        # note_transfer() under _transfer_stats_lock (raylint
        # shared_state pass: unguarded += across threads drops counts)
        self.transfer_stats: Dict[str, int] = {"head_relayed_bytes": 0,
                                               "head_relayed_objects": 0,
                                               "locality_hits": 0,
                                               "locality_misses": 0,
                                               "bytes_pulled": 0,
                                               "bytes_saved": 0}
        self._transfer_stats_lock = runtime_sanitizer.wrap_lock(
            threading.Lock(), "_private.worker.Worker._transfer_stats_lock")
        # two-level scheduling / p2p actor plane accounting (zeros keep
        # the metric families schema-stable while the knobs are off).
        # Written from daemon demux threads and the head rpc pool at
        # once — same locked-increment contract as transfer_stats.
        self.two_level_stats: Dict[str, int] = {"local_dispatch": 0,
                                                "spillback": 0,
                                                "p2p": 0,
                                                "head_fallback": 0,
                                                "node_deaths": 0,
                                                "orphan_retried": 0,
                                                "orphan_fenced": 0}
        # p2p exactly-once arbiter: first arrival (completion receipt
        # OR head fallback) for a task id claims it, the loser no-ops.
        # Bounded FIFO — duplicates race within seconds, not hours.
        self._p2p_seen: "OrderedDict[bytes, bool]" = OrderedDict()
        self._p2p_seen_lock = runtime_sanitizer.wrap_lock(
            threading.Lock(), "_private.worker.Worker._p2p_seen_lock")
        # arg-object pins for locally-dispatched ref-carrying leases
        # (tid_bin -> [ObjectID]); released when the lease resolves
        self._local_lease_pins: Dict[bytes, List[ObjectID]] = {}
        self._local_pin_lock = runtime_sanitizer.wrap_lock(
            threading.Lock(), "_private.worker.Worker._local_pin_lock")
        # resubmittable bodies of adopted local leases (tid_bin ->
        # journal-shaped record), retained IN MEMORY regardless of the
        # journal knob: the node-death reconciler needs them to retry
        # a dead node's orphaned leases under their original return
        # oids, and the default config journals nothing. Dropped when
        # the lease resolves (same lifetime as the arg pins above).
        self._local_lease_records: Dict[bytes, dict] = {}
        # COMPLETED local leases' records, kept for lineage
        # reconstruction (their returns may be the sole copy in the
        # producing node's arena, and no head-side TaskSpec exists to
        # re-run them) — see release_local_lease_pins(keep_lineage=True)
        self._local_lease_lineage: Dict[bytes, dict] = {}
        # arena names of nodes declared DEAD whose daemon may still
        # re-dial (partition, not death): their rejoin gets a FENCED
        # pool so stale outbox replays from the dead era can never
        # double-resolve work the reconciler already settled
        self._fenced_arenas: Dict[str, float] = {}
        # resource-view push thread (started with the first remote
        # node; sends only while a two-level knob is on)
        self._resview_thread: Optional[threading.Thread] = None
        # resview versioning: v is a monotonic per-push counter; e is a
        # per-head-instance epoch so gossiped views from a dead head's
        # era can never outrank a restarted head's fresh pushes
        self._resview_push_v = 0
        self._resview_epoch = os.urandom(8).hex()
        # single-flight head-side peer pulls (oid -> completion event)
        self._head_pull_lock = runtime_sanitizer.wrap_lock(
            threading.Lock(), "_private.worker.Worker._head_pull_lock")
        self._head_pulls: Dict[ObjectID, threading.Event] = {}

        # placement groups (bundle reservation over the scheduler)
        from ray_tpu_torch._private.placement_groups import PlacementGroupManager
        self.placement_groups = PlacementGroupManager(self)

        # lineage reconstruction for lost objects
        from ray_tpu_torch._private.object_recovery import ObjectRecoveryManager
        self.object_recovery = ObjectRecoveryManager(self)

        # observability: task profile events + optional Prometheus port
        from ray_tpu_torch._private.events import EventBuffer
        self.events = EventBuffer()
        # task event plane: cluster-wide lifecycle records (None when
        # task_events_max=0 — every producer hook is a None check)
        from ray_tpu_torch._private.task_events import TaskEventAggregator
        self.task_events = (TaskEventAggregator()
                            if GLOBAL_CONFIG.task_events_max != 0
                            else None)
        self.scheduler.task_events = self.task_events
        self.scheduler.fail_tasks = self._fail_unassigned
        # locality column input: the scheduler reads copy locations
        # straight off the GCS object directory (primary first)
        self.scheduler.locations_of = self.gcs.object_locations
        # profile/utilization plane: continuous sampling profiler +
        # per-node resource time series (None when profile_hz=0, the
        # default — no sampler threads anywhere, every producer hook is
        # a None check, metric families render schema-stable zeros)
        self.profile_plane = None
        if GLOBAL_CONFIG.profile_hz > 0:
            from ray_tpu_torch._private.profile_plane import ProfilePlane
            self.profile_plane = ProfilePlane()
            self.profile_plane.start_head_samplers(
                gauges=self._head_util_gauges())
        # trace plane: causal spans keyed by trace_id (None when
        # trace_sample_rate=0 or traces_max=0 — specs are never stamped
        # and every producer hook is a None check)
        from ray_tpu_torch._private.trace_plane import TraceAggregator
        self.trace_plane = (TraceAggregator()
                            if (GLOBAL_CONFIG.trace_sample_rate > 0
                                and GLOBAL_CONFIG.traces_max != 0)
                            else None)
        self.metrics_server = None
        if GLOBAL_CONFIG.metrics_export_port:
            from ray_tpu_torch._private.metrics import MetricsServer
            try:
                self.metrics_server = MetricsServer(
                    self, GLOBAL_CONFIG.metrics_export_port)
            except OSError as e:
                # a port conflict degrades to metrics-disabled; it must
                # not fail init and leak the already-started runtime
                logger.warning("metrics endpoint disabled: cannot bind "
                               "port %d (%s)",
                               GLOBAL_CONFIG.metrics_export_port, e)

        # log plane: announce the session dir in the GCS KV (clients /
        # tools discover it there), mirror control-plane log records
        # into logs/gcs.out, and start the driver-streaming monitor
        self.log_to_driver = log_to_driver
        self.log_monitor = None
        self._gcs_log_handler = None
        if self.session_log_dir is not None:
            self.gcs.kv_put(b"session_log_dir",
                            self.session_log_dir.encode(),
                            namespace="session")
            import logging as _logging
            try:
                h = _logging.FileHandler(
                    os.path.join(self.session_log_dir, "gcs.out"),
                    delay=True)
                h.setFormatter(_logging.Formatter(
                    "%(asctime)s %(levelname)s %(name)s: %(message)s"))
                h.setLevel(_logging.INFO)
                _logging.getLogger("ray_tpu_torch").addHandler(h)
                self._gcs_log_handler = h
            except OSError:
                pass
            if log_to_driver:
                from ray_tpu_torch._private.log_monitor import LogMonitor
                self.log_monitor = LogMonitor(self, self.session_log_dir)

        # actors: ActorID -> _ActorRuntime (see actor.py)
        self.actors: Dict[ActorID, Any] = {}
        self.dead_actors: set = set()
        self._actors_lock = runtime_sanitizer.wrap_lock(
            threading.Lock(), "_private.worker.Worker._actors_lock")

        # id -> False (running) | True (cancelled) | "timeout" (the
        # deadline watcher failed this attempt; its results are zombie)
        self._running_tasks: Dict[TaskID, Any] = {}
        # cancelled while window-leased but not yet executing (queued in
        # the executor): flagged here, honored at execution start
        self._precancelled: set = set()
        # deadline expired while executor-queued: timed out at exec start
        self._pretimeout: set = set()
        self._running_lock = runtime_sanitizer.wrap_lock(
            threading.Lock(), "_private.worker.Worker._running_lock")
        if runtime_sanitizer._ENABLED:
            # leak-ledger attribution: the task context current at each
            # shm allocation (the id the task-event plane records under)
            runtime_sanitizer.set_owner_provider(
                lambda: f"task {self.current_task_id.hex()[:16]}")

        # chaos plane: every injection decision flows through the
        # process-wide seeded controller (see _private/chaos.py)
        self._chaos = _chaos_controller()
        self._tick_delay_entry = GLOBAL_CONFIG.entry("testing_tick_delay_s")
        # per-task deadlines (spec.timeout_s): a lazily-started watcher
        # cancels attempts past their deadline; each expiry counts
        # against max_retries and surfaces TaskTimeoutError
        self._deadline_cv = threading.Condition()
        self._deadline_heap: List[tuple] = []
        self._deadline_seq = _Counter()
        self._deadline_thread: Optional[threading.Thread] = None

        # QoS plane (config.qos, declared early in __init__): tenant
        # fair-share ordering at the head, starvation-triggered
        # preemption, and the top-spilled-tier watermark on resview
        # frames. Stays None when the knob is off — every QoS hook is a
        # `plane is not None` check, so the off state stays
        # byte-for-byte pre-QoS.
        self._qos_thread: Optional[threading.Thread] = None
        if GLOBAL_CONFIG.qos:
            from ray_tpu_torch._private.qos import QosPlane
            self.qos_plane = QosPlane(
                tenant_quotas=GLOBAL_CONFIG.tenant_quotas,
                preempt_grace_s=GLOBAL_CONFIG.preempt_grace_s)
            self.scheduler.qos_plane = self.qos_plane
            self._qos_thread = threading.Thread(
                target=self._qos_loop, daemon=True, name="ray_tpu_qos")
            self._qos_thread.start()

        # deferred unref queue: ObjectRef.__del__ may fire during GC while
        # runtime locks are held, so deletions drain on a dedicated thread
        self._unref_queue: collections.deque = collections.deque()
        self._unref_event = threading.Event()
        self._unref_thread = threading.Thread(
            target=self._unref_loop, daemon=True, name="ray_tpu_unref")
        self._unref_thread.start()

        # memory monitor LAST: its thread scans worker state
        # (_running_tasks, _node_pools) that must exist before the first
        # tick can fire
        from ray_tpu_torch._private.memory_monitor import MemoryMonitor
        self.memory_monitor = MemoryMonitor(self)

    # ------------------------------------------------------------------
    # Context helpers
    # ------------------------------------------------------------------
    @property
    def needs_serialized_funcs(self) -> bool:
        """True when tasks may cross a process boundary, so
        RemoteFunction should attach its cached pickled-function blob
        to specs (thread-only mode skips the pickle entirely)."""
        return self.process_pool is not None or bool(self._node_pools)

    @property
    def current_task_id(self) -> TaskID:
        return self._context.task_id or self._driver_task_id

    def next_task_id(self) -> TaskID:
        return TaskID.of(self.job_id, unique=self._task_unique,
                         seq=self._task_seq.next())

    # -- cluster KV (same surface as ClientWorker.kv_*, so code using
    # `w.kv_put(...)` works in both driver and client mode) -----------
    def kv_get(self, key: bytes, namespace: str = ""):
        return self.gcs.kv_get(key, namespace=namespace)

    def kv_put(self, key: bytes, value: bytes, namespace: str = "") -> None:
        self.gcs.kv_put(key, value, namespace=namespace)

    def kv_del(self, key: bytes, namespace: str = "") -> bool:
        return self.gcs.kv_del(key, namespace=namespace)

    def kv_keys(self, prefix: bytes = b"", namespace: str = ""):
        return self.gcs.kv_keys(prefix, namespace=namespace)

    def next_put_id(self) -> ObjectID:
        if self._context.task_id is None:
            # outside a task (the driver, an actor method, a client
            # thread), every thread puts under the driver's task id: one
            # counter for all of them. The reference counts per thread
            # there, so concurrent actor calls that put got the same id
            # and read each other's objects back
            return ObjectID.for_put(self._driver_task_id,
                                    self._driver_put_seq.next())
        self._context.put_counter += 1
        return ObjectID.for_put(self._context.task_id,
                                self._context.put_counter)

    # ------------------------------------------------------------------
    # Object plane: put / get / wait
    # ------------------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        self._drain_out_of_scope()
        if isinstance(value, ObjectRef):
            raise TypeError(
                "Calling put() on an ObjectRef is not allowed: the ref can be "
                "passed around directly (reference semantics).")
        object_id = self.next_put_id()
        self.reference_counter.add_owned_object(object_id)
        if self.shm_store is not None and _likely_large(value):
            # large puts go straight to the shm arena (plasma path) so
            # worker processes read them zero-copy; the driver resolves
            # the placeholder lazily on first get. A CUDA tensor is
            # copied to the host here, once (serialize), and comes back
            # from get as a CPU tensor
            from ray_tpu_torch._private.object_store import (
                ObjectStoreFullError)
            from ray_tpu_torch._private.runtime.process_pool import (
                _PLACEHOLDER)
            from ray_tpu_torch._private.serialization import serialize
            sobj = serialize(value)
            if sobj.framed_nbytes() > GLOBAL_CONFIG.inline_object_max_bytes:
                try:
                    # a full arena evicts/spills internally; only a DISK
                    # failure can surface here
                    self.shm_store.put_serialized(object_id, sobj)
                    self.memory_store.put(object_id, _PLACEHOLDER)
                    return ObjectRef(object_id, self.worker_id)
                except (ObjectStoreFullError, OSError) as e:
                    logger.warning(
                        "shm store rejected %d-byte object (%s); storing "
                        "in the host memory store",
                        sobj.framed_nbytes(), e)
        # otherwise the value itself, by reference (in thread mode a CUDA
        # tensor stays on its device)
        self.memory_store.put(object_id, value)
        return ObjectRef(object_id, self.worker_id)

    def _entry_value(self, object_id: ObjectID, entry) -> Any:
        """Resolve a memory-store entry, deserializing shm-resident bytes
        zero-copy on first access (plasma client get analog): a tensor
        or array read from the arena is a view of its bytes there, and
        the arena range stays pinned while any view of it lives."""
        from ray_tpu_torch._private.runtime.process_pool import (
            RemotePlaceholder, ShmPlaceholder)
        value = entry.value
        if isinstance(value, ShmPlaceholder):
            from ray_tpu_torch._private.serialization import (
                deserialize, deserialize_with_release)
            sobj, pinned = self.shm_store.get_serialized_for_view(object_id)
            if sobj is None:
                raise rex.ObjectLostError(object_id.hex())
            if pinned:
                # the arena range stays pinned until the LAST view that
                # aliases it (incl. later-taken sub-views) is collected;
                # the helper owns the release even on deserialize errors
                value = deserialize_with_release(
                    sobj,
                    lambda oid=object_id: self.shm_store.unpin(oid))
            else:
                value = deserialize(sobj)  # spill read: copied bytes
            entry.value = value  # memoize the zero-copy view object
        elif isinstance(value, RemotePlaceholder):
            from ray_tpu_torch._private.serialization import (SerializedObject,
                                                        deserialize)
            node_index = value.node_index
            value = self._pull_remote_value(object_id, node_index)
            if value is None:
                # control-channel blob fetch (daemons without a peer
                # plane / pull failure)
                data = self.fetch_object_bytes(object_id, node_index)
                if data is None:
                    raise rex.ObjectLostError(object_id.hex())
                value = deserialize(SerializedObject.from_bytes(data))
            entry.value = value  # memoize: later reads are local
        return value

    def _pull_remote_value(self, object_id: ObjectID,
                           node_index: int) -> Optional[Any]:
        """Chunked peer pull of a remote-resident object into the
        HEAD's own store, then a local read — a multi-GB result never
        rides the daemon CONTROL link as one message (that link also
        carries dispatch and pings). None = peer plane unavailable;
        the caller falls back to the control-channel blob fetch."""
        peer = self.peer_address_of(node_index)
        if peer is None or self._head_server is None:
            return None
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.runtime.node_daemon import peer_pull_bytes
        from ray_tpu_torch._private.serialization import (SerializedObject,
                                                    deserialize)

        timeout = GLOBAL_CONFIG.object_transfer_timeout_s
        authkey = self._head_server.authkey
        if self.shm_store is not None:
            # single-flight per object: two user threads racing the
            # same pull would both begin_adopt — in the spill case onto
            # the SAME temp file (one pid), interleaving writes into a
            # corrupted object
            with self._head_pull_lock:
                ev = self._head_pulls.get(object_id)
                if ev is None:
                    self._head_pulls[object_id] = ev = threading.Event()
                    leader = True
                else:
                    leader = False
            if not leader:
                ev.wait(timeout)
                if not self.shm_store.contains(object_id):
                    return None  # leader failed: fall back
                return self._read_pulled(object_id)
            try:
                return self._leader_pull(peer, authkey, object_id,
                                         timeout)
            finally:
                with self._head_pull_lock:
                    self._head_pulls.pop(object_id, None)
                ev.set()
        # thread-mode head: no arena to adopt into — stream the frames
        # into ONE buffer and deserialize from it (no shared sink, so
        # no single-flight needed beyond memoization upstream)
        buf = peer_pull_bytes(peer, authkey, object_id, timeout)
        if buf is None:
            return None
        self.note_transfer("head_peer_pulled_objects")
        return deserialize(SerializedObject.from_bytes(memoryview(buf)))

    def _leader_pull(self, peer, authkey: bytes, object_id: ObjectID,
                     timeout: float) -> Optional[Any]:
        from ray_tpu_torch._private.runtime.node_daemon import peer_pull_once

        if not peer_pull_once(peer, authkey, self.shm_store, object_id,
                              timeout):
            return None
        self.note_transfer("head_peer_pulled_objects")
        return self._read_pulled(object_id)

    def _read_pulled(self, object_id: ObjectID) -> Optional[Any]:
        from ray_tpu_torch._private.serialization import (
            deserialize, deserialize_with_release)

        sobj, pinned = self.shm_store.get_serialized_for_view(object_id)
        if sobj is None:
            return None
        if pinned:
            return deserialize_with_release(
                sobj, lambda oid=object_id: self.shm_store.unpin(oid))
        return deserialize(sobj)  # spill read: copied bytes

    def fetch_object_bytes(self, object_id: ObjectID,
                           node_index: int) -> Optional[bytes]:
        """Framed bytes of an object primary-resident on a remote node
        (None if the node or object is gone). Every byte returned here
        crossed the HEAD's link — the relay counter lets tests assert
        that peer-capable transfers bypass it."""
        pool = self._node_pools.get(node_index)
        if pool is None or not getattr(pool, "is_remote", False):
            return None
        data = pool.fetch_object(object_id)
        if data is not None:
            from ray_tpu_torch._private.serialization import SerializedObject
            if not SerializedObject.frame_complete(data):
                # partial transfer (chaos truncation or a dying daemon):
                # treat as lost so lineage recovery rebuilds the object
                # instead of deserializing short buffers into garbage
                logger.warning("truncated transfer of %s from node %d "
                               "(%d bytes); treating as lost",
                               object_id.hex()[:16], node_index, len(data))
                self._chaos.note_recovery("transfer")
                return None
            self.note_transfer("head_relayed_bytes", len(data))
            self.note_transfer("head_relayed_objects")
        return data

    def note_transfer(self, key: str, delta: int = 1) -> None:
        """Bump a transfer_stats counter. The dict is written from the
        scheduler tick, daemon demux threads, and head pull paths at
        once; a bare ``+=`` there is a read-modify-write race that
        silently drops counts."""
        with self._transfer_stats_lock:
            self.transfer_stats[key] = \
                self.transfer_stats.get(key, 0) + delta

    def peer_address_of(self, node_index: int) -> Optional[tuple]:
        """The direct-transfer endpoint of a remote node's daemon, or
        None (head-local nodes / daemons predating the peer plane)."""
        pool = self._node_pools.get(node_index)
        if pool is not None and getattr(pool, "is_remote", False):
            return getattr(pool, "peer_address", None)
        return None

    # ------------------------------------------------------------------
    # Two-level scheduling + p2p actor plane (bottom-up dispatch: the
    # node daemons admit work and execute actor calls peer-to-peer; the
    # head stays the single placement/bookkeeping authority and only
    # sees sequenced reports)
    # ------------------------------------------------------------------
    def note_two_level(self, key: str, delta: int = 1) -> None:
        with self._transfer_stats_lock:
            self.two_level_stats[key] = \
                self.two_level_stats.get(key, 0) + delta

    def _p2p_claim(self, tid_bin: bytes) -> bool:
        """First claim on a p2p call's completion wins: the completion
        receipt and the head-fallback retry race for the same task id,
        and exactly one of them may resolve/execute it."""
        with self._p2p_seen_lock:
            if tid_bin in self._p2p_seen:
                return False
            self._p2p_seen[tid_bin] = True
            while len(self._p2p_seen) > 4096:
                self._p2p_seen.popitem(last=False)
            return True

    def on_local_lease(self, pool, tid_bin: bytes, info: dict) -> None:
        """A node's LocalScheduler admitted a worker-submitted task
        from its bounded local queue without a head round-trip. Adopt
        the lease head-side: own + journal it so failover
        reconciliation and ref bookkeeping behave exactly as if the
        head had placed it (outbox FIFO guarantees this report lands
        before the lease's own done/err)."""
        self.note_two_level("local_dispatch")
        note = getattr(self.scheduler, "note_local_dispatch", None)
        if note is not None:
            note()
        returns = list(info.get("returns") or ())
        rids = [ObjectID(b) for b in returns]
        for oid in rids:
            self.reference_counter.add_owned_object(oid)
        with pool._lock:
            h = pool._by_num.get(info.get("worker_num"))
            sub = pool._by_num.get(info.get("submitter"))
        attempt = int(info.get("attempt", 0))
        if h is not None:
            pool.adopt_inflight(h, tid_bin, returns, attempt)
        record = {
            "name": info.get("name"),
            "fn_blob": info.get("fn_blob"),
            "args_blob": info.get("args_blob"),
            "num_returns": int(info.get("num_returns", 1)),
            "returns": returns,
            "resources": dict(info.get("resources") or {}),
            "attempt": attempt,
            "max_retries": int(info.get("max_retries", 0)),
            "node_index": pool.node_index,
        }
        # retained in memory for the node-death reconciler even when
        # the durable journal is off (the default): a whole-node
        # SIGKILL must be able to retry this lease under its original
        # return oids without any WAL to replay
        with self._local_pin_lock:
            self._local_lease_records[tid_bin] = record
        if self.gcs.journal_enabled:
            self.gcs.journal_lease(tid_bin, dict(record))
        arg_pin = [ObjectID(b) for b in info.get("arg_refs") or ()]
        if arg_pin:
            # pin the arg objects for the lease's lifetime, mirroring
            # the head path's submitted-task references (released when
            # the adopted lease resolves — see release_local_lease_pins)
            self.reference_counter.add_submitted_task_references(arg_pin)
            with self._local_pin_lock:
                self._local_lease_pins[tid_bin] = arg_pin
        if sub is not None:
            # the submitting task borrows its nested refs until it
            # completes, mirroring the head-path _rpc_submit
            borrows = pool._task_borrows(sub)
            for oid in rids:
                self.reference_counter.add_borrower(oid, sub.worker_id)
                borrows.add(oid)
        tp = self.trace_plane
        if tp is not None:
            ts = info.get("t")
            tp.record_local_dispatch(
                TaskID(tid_bin), info.get("name") or "?",
                info.get("trace"), pool.node_index,
                now=(ts + pool.clock_offset) if ts else None)

    def on_local_retry(self, pool, tid_bin: bytes, info: dict) -> None:
        """The node daemon re-leased a locally-dispatched task to a
        fresh local worker after its first worker died (per-attempt
        accounting rides the journaled lease, so failover replay and
        the real claimant agree on who owns the attempt). Move the
        inflight entry off the dead handle and bump the journal's
        attempt token — outbox FIFO guarantees this report lands
        before the dead worker's worker_died, so the failure sweep
        never sees the retried lease on the old handle."""
        self.note_two_level("local_retry")
        attempt = int(info.get("attempt", 1))
        returns = list(info.get("returns") or ())
        task_id = TaskID(tid_bin)
        with pool._lock:
            old = pool._by_task.pop(task_id, None)
            h = pool._by_num.get(info.get("worker_num"))
            if old is not None:
                old.inflight.pop(task_id, None)
        if h is not None:
            pool.adopt_inflight(h, tid_bin, returns, attempt)
        with self._local_pin_lock:
            rec = self._local_lease_records.get(tid_bin)
            if rec is not None:
                rec["attempt"] = attempt
        if self.gcs.journal_enabled:
            lease = self.gcs.journal_get(tid_bin)
            if lease is not None:
                lease = dict(lease, attempt=attempt)
                self.gcs.journal_lease(tid_bin, lease)
        tp = self.trace_plane
        if tp is not None:
            tp.record_failed(TaskID(tid_bin),
                             "worker died (local retry %d)" % attempt)

    def release_local_lease_pins(self, tid_bin: bytes,
                                 keep_lineage: bool = False) -> None:
        """Drop the arg-object pins taken at local-lease adoption,
        plus the retained resubmittable record (the lease reached a
        terminal state on every path that calls this). No-op for tasks
        without pinned args (head-path tasks, failover re-attached
        leases).

        ``keep_lineage`` (the SUCCESS completion path): the head never
        built a TaskSpec for a locally-dispatched lease, so the lease
        record is the ONLY thing that can reconstruct its sole-copy
        returns after the producing node dies. Migrate it to the
        bounded lineage-record table instead of dropping it; the
        recovery manager resubmits through it on loss."""
        with self._local_pin_lock:
            pins = self._local_lease_pins.pop(tid_bin, None)
            rec = self._local_lease_records.pop(tid_bin, None)
            if keep_lineage and rec is not None \
                    and rec.get("fn_blob") is not None \
                    and int(rec.get("attempt", 0)) \
                    < int(rec.get("max_retries", 0)):
                lt = self._local_lease_lineage
                lt[tid_bin] = rec
                # count-capped FIFO (records carry real fn/args blobs,
                # unlike the 256-byte-estimated head-path specs);
                # evicted entries are simply no longer recoverable
                while len(lt) > 2048:
                    lt.pop(next(iter(lt)))
        if pins:
            self.reference_counter.remove_submitted_task_references(pins)

    def take_local_lease_lineage(self, tid_bin: bytes) -> Optional[dict]:
        """Claim (pop) a completed local lease's lineage record for
        reconstruction. Popping is the dedup: once the resubmission
        completes, the rebuilt spec lands in the task manager's normal
        lineage table (keyed by this same original id), and further
        losses recover through that path."""
        with self._local_pin_lock:
            return self._local_lease_lineage.pop(tid_bin, None)

    def on_p2p_done(self, pool, tid_bin: bytes, receipt: dict) -> None:
        """Sequenced completion receipt for a peer-to-peer actor call:
        the result bytes already moved worker -> peer daemon directly,
        so this is lineage, ownership and observability only.
        ``pool`` is the EXECUTING node's pool (its daemon reported)."""
        if not self._p2p_claim(tid_bin):
            return  # the head-fallback retry already resolved the call
        self.note_two_level("p2p")
        returns = list(receipt.get("returns") or ())
        rids = [ObjectID(b) for b in returns]
        for oid in rids:
            self.reference_counter.add_owned_object(oid)
        err = receipt.get("err")
        if err is not None:
            import cloudpickle
            try:
                exc = cloudpickle.loads(err[0])
            except Exception:
                exc = RuntimeError(
                    "p2p actor call failed (exception undeserializable)")
            if not isinstance(exc, (rex.TaskError, rex.ActorError)):
                exc = rex.TaskError(
                    f"{receipt.get('name')}.{receipt.get('method')}",
                    exc, err[1] or "")
            for oid in rids:
                self.memory_store.put(oid, exc, is_exception=True)
                self.scheduler.notify_object_ready(oid)
        else:
            pool.store_result_entries(rids,
                                      list(receipt.get("entries") or ()))
        # the calling task (on the CALLER's node) borrows the refs
        # until it completes, mirroring the head-path _rpc_actor_call
        cpool = self._node_pools.get(receipt.get("caller_node"))
        if cpool is not None:
            with cpool._lock:
                ch = cpool._by_num.get(receipt.get("caller"))
            if ch is not None:
                borrows = cpool._task_borrows(ch)
                for oid in rids:
                    self.reference_counter.add_borrower(oid, ch.worker_id)
                    borrows.add(oid)
        tp = self.trace_plane
        if tp is not None:
            tp.record_p2p_span(
                TaskID(tid_bin),
                f"{receipt.get('name')}.{receipt.get('method')}",
                receipt.get("trace"), pool.node_index,
                receipt.get("timing"),
                worker=receipt.get("worker_num"),
                offset=pool.clock_offset,
                error_type=(type(exc).__name__ if err is not None
                            else None))

    def on_p2p_fallback(self, pool, tid_bin: bytes, info: dict) -> None:
        """A peer lane died/dropped/timed out mid-call: re-execute
        through the normal head-side actor runtime with the SAME task
        id / return ids / trace context. The executing worker's dedup
        cache re-emits the recorded completion if the peer actually
        ran the first attempt — exactly-once either way. ``pool`` is
        the CALLER's pool (its daemon reported the fallback)."""
        import cloudpickle

        from ray_tpu_torch.actor import ActorState, _Call

        if not self._p2p_claim(tid_bin):
            return  # the completion receipt beat the fallback report
        # count only claimed fallbacks (mirrors on_p2p_done's 'p2p'
        # accounting) — a lost race here was a fully-served p2p call
        self.note_two_level("head_fallback")
        self._chaos.note_recovery("peer_link")
        returns = list(info.get("returns") or ())
        rids = [ObjectID(b) for b in returns]
        for oid in rids:
            self.reference_counter.add_owned_object(oid)

        def _fail(exc: BaseException) -> None:
            for oid in rids:
                self.memory_store.put(oid, exc, is_exception=True)
                self.scheduler.notify_object_ready(oid)

        try:
            t = cloudpickle.loads(info["blob"])
            args, kwargs = t[2], t[3]
        except Exception as e:
            _fail(rex.TaskError(str(info.get("method")), e, ""))
            return
        aid = ActorID(info["actor"])
        with self._actors_lock:
            rt = self.actors.get(aid)
        if rt is None or rt.state == ActorState.DEAD:
            _fail(rex.ActorDiedError(
                f"p2p fallback: actor {aid.hex()[:16]} is gone "
                f"({info.get('reason')})", actor_id=aid))
            return
        call = _Call(info["method"], args, kwargs, rids,
                     int(info.get("num_returns", 1)), TaskID(tid_bin),
                     trace_ctx=info.get("trace"), dedup=True)
        tp = self.trace_plane
        if tp is not None and call.trace_ctx is not None:
            tp.on_actor_call(call, str(info.get("method")),
                             rt._current_node_index)
        with pool._lock:
            ch = pool._by_num.get(info.get("caller"))
        if ch is not None:
            borrows = pool._task_borrows(ch)
            for oid in rids:
                self.reference_counter.add_borrower(oid, ch.worker_id)
                borrows.add(oid)
        try:
            rt.submit(call)
        except Exception as e:  # e.g. PendingCallsLimitExceeded
            _fail(e if isinstance(e, rex.RayTpuError)
                  else rex.TaskError(str(info.get("method")), e, ""))

    def resolve_actor_address(self, aid_bin: bytes) -> Optional[tuple]:
        """(node_index, peer_address, worker_num) of a live process
        actor's dedicated worker, or None (thread-mode actor, not
        alive, or node without a peer plane) — a None route keeps the
        daemon on the head path. Knob-gated: with actor_p2p off no
        route exists anywhere (``state.list_actors`` shows None and
        aroute requests — which should not occur — resolve to the
        head path)."""
        from ray_tpu_torch.actor import ActorState

        if not GLOBAL_CONFIG.actor_p2p:
            return None
        with self._actors_lock:
            rt = self.actors.get(ActorID(aid_bin))
        if rt is None or rt.state != ActorState.ALIVE:
            return None
        h = getattr(rt, "_h", None)
        rpool = getattr(rt, "_pool", None)
        if h is None or rpool is None or h.dead \
                or not getattr(rpool, "is_remote", False):
            return None
        peer = getattr(rpool, "peer_address", None)
        if peer is None:
            return None
        return (rpool.node_index, tuple(peer), h.worker_num)

    def _ensure_resview_push(self) -> None:
        """Start the resource-view push loop with the first remote
        node. The loop itself is knob-gated per tick, so toggling
        local_dispatch/actor_p2p mid-session takes effect without a
        restart; with both knobs off it sends NOTHING (wire bytes stay
        byte-for-byte pre-two-level)."""
        if self._resview_thread is not None:
            return
        t = threading.Thread(target=self._resview_push_loop, daemon=True,
                             name="ray_tpu_resview_push")
        self._resview_thread = t
        t.start()

    # residency digests above this size stop being pushed (a node
    # hoarding tens of thousands of objects gains little from local
    # ref admission and the push would dominate the view payload)
    _RESVIEW_DIGEST_CAP = 4096

    def _resview_push_loop(self) -> None:
        while self.alive:
            try:
                if GLOBAL_CONFIG.local_dispatch or GLOBAL_CONFIG.actor_p2p:
                    snap = self._chaos.plan_snapshot()
                    self._resview_push_v += 1
                    pools = [e.pool for e in self.gcs.node_table()
                             if e.pool is not None
                             and getattr(e.pool, "is_remote", False)]
                    addrs = {p.node_index: getattr(p, "peer_address", None)
                             for p in pools}
                    # per-node top-spilled-tier watermark (config.qos):
                    # the highest priority tier still queued at the
                    # head — daemons must not locally admit below it
                    # (a low-tier nested task would jump a spilled
                    # high-tier one). The key is absent entirely when
                    # the plane is off: qos=False frames stay
                    # byte-for-byte pre-QoS.
                    wm = (self.qos_plane.top_queued_tier()
                          if self.qos_plane is not None else None)
                    for p in pools:
                        try:
                            view = {
                                "accept": bool(GLOBAL_CONFIG.local_dispatch),
                                "p2p": bool(GLOBAL_CONFIG.actor_p2p),
                                "cap": int(GLOBAL_CONFIG.local_queue_depth),
                                "job": self.job_id.binary(),
                                "node": p.node_index,
                                "chaos": snap,
                                "v": self._resview_push_v,
                                "e": self._resview_epoch,
                                "peers": [a for i, a in addrs.items()
                                          if i != p.node_index
                                          and a is not None],
                                "resident": self._residency_digest(
                                    p.node_index),
                            }
                            if self.qos_plane is not None:
                                view["wm"] = wm
                            p.send_resview(view)
                        except Exception:
                            pass  # a dying link re-syncs after rejoin
            except Exception:
                logger.exception("resview push tick failed")
            time.sleep(0.5)

    def _head_util_gauges(self) -> dict:
        """Internal gauges the head's resource sampler folds into node
        0's utilization series: shm arena occupancy, scheduler queue
        depths, inflight leases, control-ring traffic. Closures are
        evaluated once per utilization_interval_s tick, so the cheap
        locked reads below never touch a hot path."""
        def _arena_used() -> int:
            arena = getattr(getattr(self, "shm_store", None), "arena",
                            None)
            if arena is None:
                return 0
            return max(arena.size - arena.free_bytes(), 0)

        def _sched(key: str):
            def g():
                return self.scheduler.stats().get(key, 0)
            return g

        def _ring(key: str):
            def g():
                total = 0
                for e in self.gcs.node_table():
                    rs = getattr(e.pool, "ring_stats", None)
                    if rs:
                        total += rs.get(key, 0)
                return total
            return g

        return {
            "arena_used_bytes": _arena_used,
            "sched_ready_queue": _sched("ready_queue"),
            "sched_waiting_deps": _sched("waiting_deps"),
            "inflight_tasks": _sched("running"),
            "ring_msgs_total": _ring("msgs"),
            "ring_fallback_total": _ring("fallback"),
            "head_failovers": lambda: getattr(self.gcs,
                                              "head_failovers", 0),
        }

    def _residency_digest(self, node_index: int) -> Optional[list]:
        """8-byte oid prefixes of every object copy on the node, for
        the LocalScheduler's ref-carrying admission check. None when
        the directory slice is too large to ship (the daemon then
        falls back to its own arena residency, which it always checks
        first anyway)."""
        oids = self.gcs.objects_resident(node_index)
        if len(oids) > self._RESVIEW_DIGEST_CAP:
            return None
        return [oid.binary()[:8] for oid in oids]

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        self._drain_out_of_scope()
        ids = [r.object_id() for r in refs]
        # lost objects (freed/evicted while still referenced) reconstruct
        # from lineage before we block on the store
        missing = self.memory_store.missing_of(ids)
        if missing:
            self._check_env_lock_deadlock(missing)
            self.object_recovery.recover_all(missing)
        try:
            entries = self.memory_store.wait_and_get(ids, timeout)
        except TimeoutError as e:
            raise rex.GetTimeoutError(str(e)) from None
        out = []
        for oid, entry in zip(ids, entries):
            if entry.is_exception:
                exc = entry.value
                if isinstance(exc, rex.TaskError):
                    raise exc.as_instanceof_cause()
                raise exc
            out.append(self._entry_value(oid, entry))
        return out

    def _env_lock_blocked_specs(self, missing: List[ObjectID]) -> List[TaskSpec]:
        """Pending producers of `missing` that need the thread-mode
        runtime-env lock, when the CALLING thread holds it — those
        tasks can never run until the caller finishes (thread workers
        serialize env'd tasks under one lock)."""
        if Worker._env_lock_owner != threading.get_ident():
            return []
        blocked = []
        for oid in missing:
            spec = self.task_manager.pending_spec_for_object(oid)
            env = spec.runtime_env if spec is not None else None
            if env and (env.get("working_dir_pkg") or env.get("pip")):
                if self._spec_fits_process_pool(spec):
                    # mixed topology: a process-backed node can satisfy
                    # this producer's demands, and its workers apply
                    # runtime envs WITHOUT the thread-mode lock — the
                    # task is not necessarily stuck behind the caller,
                    # so flagging it would be a spurious deadlock error
                    continue
                blocked.append(spec)
        return blocked

    def _spec_fits_process_pool(self, spec: TaskSpec) -> bool:
        """True when some process-backed node's declared resources cover
        the spec's demands (i.e. the scheduler CAN run it off the local
        thread pool). Heuristic on purpose: the grant may still land on
        local threads, but erring toward not-raising beats failing a
        program that can make progress."""
        if not self._node_pools:
            return False
        demands = dict(spec.resources or {})
        demands.setdefault("CPU", 0.0)
        for entry in self.gcs.node_table():
            if entry.pool is None or entry.kind == "local":
                continue
            caps = entry.resources
            if all(caps.get(k, 0.0) >= v for k, v in demands.items()):
                return True
        return False

    def _check_env_lock_deadlock(self, missing: List[ObjectID]) -> None:
        """Fail loudly where a thread-mode env'd task would deadlock
        blocking on another env'd task (fire-and-forget nested env'd
        tasks remain legal — they run after the blocker releases)."""
        blocked = self._env_lock_blocked_specs(missing)
        if blocked:
            raise RuntimeError(
                f"deadlock: task {blocked[0].name} needs the "
                "thread-mode runtime-env lock held by the task blocking "
                "on it (thread workers serialize env'd tasks). Use "
                "process workers for nested runtime environments, or "
                "don't block on env'd children from an env'd task.")

    def wait(self, refs: Sequence[ObjectRef], num_returns: int,
             timeout: Optional[float]) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        self._drain_out_of_scope()
        ids = [r.object_id() for r in refs]
        if timeout is None:
            # deadlock only if the wait CANNOT be satisfied without an
            # env-lock-blocked producer: refs already ready or produced
            # by plain tasks still count toward num_returns
            missing = [oid for oid in ids
                       if not self.memory_store.contains(oid)]
            blocked = self._env_lock_blocked_specs(missing)
            if blocked and len(ids) - len(blocked) < num_returns:
                raise RuntimeError(
                    f"deadlock: wait(num_returns={num_returns}) cannot "
                    f"complete without task {blocked[0].name}, which "
                    "needs the thread-mode runtime-env lock held by the "
                    "waiting task. Use process workers for nested "
                    "runtime environments.")
        ready_set = self.memory_store.wait(ids, num_returns, timeout)
        ready, not_ready = [], []
        for r in refs:
            (ready if r.object_id() in ready_set and len(ready) < num_returns
             else not_ready).append(r)
        return ready, not_ready

    def run_callback_when_ready(self, object_id: ObjectID, cb: Callable[[], None]):
        self.memory_store.add_ready_callback(object_id, cb)

    # ------------------------------------------------------------------
    # Task submission
    # ------------------------------------------------------------------
    def prepare_runtime_env(self, runtime_env: Optional[dict]
                            ) -> Optional[dict]:
        """Driver-side half of the env agent: package working_dir into
        a content-addressed zip in the GCS KV (once per content), so
        every node can fetch it on demand. Returns the env with the
        path replaced by its package hash."""
        if not runtime_env or "working_dir" not in runtime_env:
            return runtime_env
        from ray_tpu_torch._private import runtime_envs as rte

        pkg_hash, data = rte.package_working_dir(runtime_env["working_dir"])
        key = rte.kv_key(pkg_hash)
        if self.gcs.kv_get(key) is None:
            self.gcs.kv_put(key, data)
        out = dict(runtime_env)
        out.pop("working_dir")
        out["working_dir_pkg"] = pkg_hash
        return out

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        if spec.runtime_env and "working_dir" in spec.runtime_env:
            spec.runtime_env = self.prepare_runtime_env(spec.runtime_env)
        return_ids = spec.return_ids()
        for oid in return_ids:
            self.reference_counter.add_owned_object(oid, lineage_task=spec.task_id)

        deps = _top_level_deps(spec.args, spec.kwargs)
        spec._deps_memo = deps  # args never change; reused at completion
        if deps:
            self.reference_counter.add_submitted_task_references(deps)
            self._stamp_arg_sizes(spec, deps)
        self.task_manager.add_pending(spec, deps)
        if self.qos_plane is not None:
            self.qos_plane.note_queued(spec.task_id, spec.tenant,
                                       spec.priority)
        self.events.record(spec.task_id, spec.name, "submitted",
                           attempt=spec.attempt_number)
        # trace stamping runs BEFORE the task-event record so the
        # event plane's detail rows can carry the spec's trace context
        if (self.trace_plane is not None
                and spec.task_type == TaskType.NORMAL_TASK):
            self.trace_plane.on_submit(spec)
        if (self.task_events is not None
                and spec.task_type == TaskType.NORMAL_TASK):
            self.task_events.record_submitted(spec)
        if spec.timeout_s:
            self._register_deadline(spec)

        # drop deps already available locally; a missing dep with no
        # pending producer was LOST and must reconstruct or the task
        # waits forever
        unresolved = []
        for d in deps:
            if self.memory_store.contains(d):
                continue
            unresolved.append(d)
            self.object_recovery.maybe_recover(d)
        pending = PendingTask(spec=spec, deps=unresolved, execute=_noop_exec)
        self.scheduler.submit(pending)
        return [ObjectRef(oid, self.worker_id) for oid in return_ids]

    def submit_task_batch(self, specs: List[TaskSpec]) -> List[List[ObjectRef]]:
        """Vectorized submit: per-task work hoisted to per-batch — one
        refcount lock hold, one task-manager lock hold, one scheduler
        wakeup (reference: the lease-amortization idea of SURVEY §3.2's
        hot-loops note, applied to the submit side). Per-task return
        value shape matches submit_task."""
        self._drain_out_of_scope()
        store_contains = self.memory_store.contains
        owned: List[tuple] = []
        all_deps: List[ObjectID] = []
        for spec in specs:
            # env packaging does GCS I/O — never under a refcount lock
            if spec.runtime_env and "working_dir" in spec.runtime_env:
                spec.runtime_env = self.prepare_runtime_env(
                    spec.runtime_env)
            for oid in spec.return_ids():  # id-keyed memo inside
                owned.append((oid, spec.task_id))
            deps = (_top_level_deps(spec.args, spec.kwargs)
                    if (spec.args or spec.kwargs) else [])
            spec._deps_memo = deps
            if deps:
                self._stamp_arg_sizes(spec, deps)
            all_deps.extend(deps)
        self.reference_counter.register_submit_batch(owned, all_deps)
        self.task_manager.add_pending_batch(specs)
        if self.qos_plane is not None:
            for spec in specs:
                self.qos_plane.note_queued(spec.task_id, spec.tenant,
                                           spec.priority)
        self.events.record_batch(((s.task_id, s.name) for s in specs),
                                 "submitted")
        # trace stamping BEFORE the task-event records (detail rows
        # carry the trace context stamped here)
        if self.trace_plane is not None:
            self.trace_plane.on_submit_batch(
                s for s in specs if s.task_type == TaskType.NORMAL_TASK)
        if self.task_events is not None:
            self.task_events.record_submitted_batch(
                s for s in specs if s.task_type == TaskType.NORMAL_TASK)
        pendings: List[PendingTask] = []
        out: List[List[ObjectRef]] = []
        for spec in specs:
            unresolved = []
            for d in spec._deps_memo:
                if store_contains(d):
                    continue
                unresolved.append(d)
                self.object_recovery.maybe_recover(d)
            pendings.append(PendingTask(spec=spec, deps=unresolved,
                                        execute=_noop_exec))
            if spec.timeout_s:
                self._register_deadline(spec)
            refs = []
            for oid in spec.return_ids():
                ref = ObjectRef(oid, self.worker_id, _register=False)
                ref._weak = False  # counted in register_submit_batch
                if runtime_sanitizer._ENABLED:
                    runtime_sanitizer.track_ref(ref)
                refs.append(ref)
            out.append(refs)
        self.scheduler.submit_many(pendings)
        return out

    def _stamp_arg_sizes(self, spec: TaskSpec, deps: List[ObjectID]) -> None:
        """Per-arg (ObjectID, nbytes) summary for locality scoring and
        dispatch-time staging. Only stamped when remote arenas exist and
        the knob is on: single-node runs (and locality-off runs) skip
        the per-dep size lookups entirely, keeping submit byte-for-byte
        pre-locality."""
        if not self._has_remote_nodes \
                or not GLOBAL_CONFIG.scheduler_locality:
            return
        get_entry = self.memory_store.get_entry
        sizes = []
        for d in deps:
            e = get_entry(d)
            # 0 = size unknown (dep not yet produced); the scheduler
            # still counts the copy, weighted minimally
            sizes.append((d, e.size if e is not None else 0))
        spec.arg_sizes = tuple(sizes)

    def cancel_task(self, ref: ObjectRef, force: bool = False) -> None:
        task_id = ref.task_id()
        if self.scheduler.cancel(task_id):
            err = rex.TaskCancelledError(task_id)
            # resolve ALL the task's return refs, not just the one passed
            # in — a get() on a sibling return must not hang forever
            spec = self.task_manager.get_pending_spec(task_id)
            return_ids = (spec.return_ids() if spec is not None
                          else [ref.object_id()])
            for oid in return_ids:
                self.memory_store.put(oid, err, is_exception=True)
                self.scheduler.notify_object_ready(oid)
            self.task_manager.complete(task_id)
            return
        for pool in list(self._node_pools.values()):
            if pool.cancel(task_id, force):
                return  # running in a worker process: flagged or killed there
        with self._running_lock:
            running = task_id in self._running_tasks
            if running:
                # cooperative flag read via was_current_task_cancelled
                self._running_tasks[task_id] = True
            elif self.task_manager.get_pending_spec(task_id) is not None:
                # leased through the dispatch window but still queued in
                # the executor: mark for cancellation at execution start
                self._precancelled.add(task_id)
        if running and force:
            _async_raise_in_task(task_id)

    def was_current_task_cancelled(self) -> bool:
        task_id = self._context.task_id
        if task_id is None:
            return False
        # dict.get is GIL-atomic; the value is a plain bool flag
        return bool(self._running_tasks.get(task_id, False))

    # ------------------------------------------------------------------
    # Execution (dispatcher target)
    # ------------------------------------------------------------------
    def pool_for_node(self, node_index: int):
        """ProcessWorkerPool backing a scheduler row (bundle rows resolve
        through their parent node), or None for host-local execution."""
        pool = self._node_pools.get(node_index)
        if pool is not None:
            return pool
        ns = self.scheduler.node_state(node_index)
        if ns is not None and ns.is_bundle and ns.parent >= 0:
            return self._node_pools.get(ns.parent)
        return None

    def _chaos_tick(self) -> None:
        """Dispatch-path injection point: the testing_tick_delay_s knob
        (re-read live) plus the chaos ``sched_tick`` site, both
        simulating a slow scheduling node."""
        d = self._tick_delay_entry.value
        if d > 0.0:
            time.sleep(d)
        fault = self._chaos.poll("sched_tick")
        if fault is not None:
            time.sleep(fault.get("delay_s", 0.05))

    def _stage_args(self, pool, pending: PendingTask) -> None:
        """Dispatch-time arg staging: args NOT resident on the assigned
        node but resident on a peer with a transfer endpoint ship their
        known locations with the lease, so the daemon's pull manager
        overlaps the peer pull with the task's queue wait (instead of
        paying the transfer at exec start). Also keeps the locality
        hit/miss and bytes-saved/pulled accounting."""
        sizes = getattr(pending.spec, "arg_sizes", None)
        if not sizes:
            return
        stage: List[tuple] = []
        resident = 0
        missing = 0
        located = 0
        for oid, nbytes in sizes:
            locs = self.gcs.object_locations(oid)
            if not locs:
                continue  # head-resident: embedded in the lease payload
            located += 1
            if pool.node_index in locs:
                resident += nbytes
                continue
            missing += 1
            for src in locs:
                peer = self.peer_address_of(src)
                if peer is not None:
                    stage.append((oid.binary(), tuple(peer), nbytes))
                    break
        if located:
            self.note_transfer(
                "locality_misses" if missing else "locality_hits")
            if resident:
                self.note_transfer("bytes_saved", resident)
        if stage:
            pool.stage_args(stage)
            if self.task_events is not None:
                self.task_events.record_staged(pending.spec.task_id,
                                               pending.node_index)
            if self.trace_plane is not None:
                self.trace_plane.record_staged(pending.spec.task_id,
                                               pending.node_index)

    def _dispatch(self, pending: PendingTask) -> None:
        self._chaos_tick()
        self.events.record(pending.spec.task_id, pending.spec.name,
                           "dispatched", pending.node_index,
                           attempt=pending.spec.attempt_number)
        te = self.task_events
        if te is not None:
            te.record_dispatched_batch(
                ((pending.spec.task_id, pending.node_index),))
        if self.trace_plane is not None:
            self.trace_plane.record_dispatched_batch(
                ((pending.spec.task_id, pending.node_index),))
        boot = getattr(pending.spec, "_actor_boot", None)
        pool = self.pool_for_node(pending.node_index)
        if boot is not None:
            self._pool.submit(self._boot_actor, pending, boot)
        elif (pool is not None
              and pending.spec.task_type == TaskType.NORMAL_TASK):
            if pool.is_remote:
                self._stage_args(pool, pending)
            # lease grant: the decision becomes a payload shipped to a
            # worker process on the ASSIGNED node (payload build + pipe
            # send run OFF the tick thread: a full pipe buffer blocks
            # the send, and a blocked tick thread would stall all
            # scheduling — the batch path amortizes the executor hop)
            self._pool.submit(pool.run_task, pending)
        else:
            self._pool.submit(self._execute_task, pending)

    def _dispatch_many(self, pendings: List[PendingTask]) -> None:
        """One tick's grants: normal tasks bound for process pools batch
        into per-pool lease grants (one executor hop and one pipe or
        ring message per worker per tick, instead of per task); plain
        host-thread tasks take the shared drain fast path; everything
        else the per-task path."""
        self._chaos_tick()
        groups: Dict[Any, List[PendingTask]] = {}
        local: List[tuple] = []
        fast: List[PendingTask] = []
        te = self.task_events
        tp = self.trace_plane
        te_rows: List[tuple] = []
        # profile-event rows batch per node (record_batch takes one
        # node): one ring append pass per tick, not one call per task
        ev_rows: Dict[int, List[tuple]] = {}
        for pending in pendings:
            spec = pending.spec
            pool = self.pool_for_node(pending.node_index)
            if (getattr(spec, "_actor_boot", None) is not None
                    or spec.task_type != TaskType.NORMAL_TASK):
                self._dispatch(pending)
            elif pool is not None and not pool.is_remote:
                ev_rows.setdefault(pending.node_index, []).append(
                    (spec.task_id, spec.name))
                if te is not None or tp is not None:
                    te_rows.append((spec.task_id, pending.node_index))
                groups.setdefault(pool, []).append(pending)
            elif pool is None:
                # host-thread execution. Plain tasks (no deps to
                # resolve, no runtime env, no placement group, single
                # return) take the drain fast path: a SHARED deque that
                # every executor thread pulls from one task at a time —
                # work stealing is preserved (pre-chunking per thread
                # would let a blocking task head-of-line its chunk;
                # worst case: deadlock a producer queued behind its own
                # consumer) while completion bookkeeping amortizes
                # per-drain instead of per-task
                if (not spec.runtime_env
                        and spec.placement_group_id is None
                        and spec.num_returns == 1
                        and not spec.kwargs
                        and not getattr(spec, "_deps_memo", None)):
                    fast.append(pending)
                else:
                    ev_rows.setdefault(pending.node_index, []).append(
                        (spec.task_id, spec.name))
                    if te is not None or tp is not None:
                        te_rows.append((spec.task_id,
                                        pending.node_index))
                    local.append((self._execute_task, (pending,)))
            else:
                self._dispatch(pending)
        for node, rows in ev_rows.items():
            self.events.record_batch(rows, "dispatched", node)
        if te_rows or fast:
            all_rows = te_rows + [(p.spec.task_id, p.node_index)
                                  for p in fast]
            if te is not None:
                te.record_dispatched_batch(all_rows)
            if tp is not None:
                tp.record_dispatched_batch(all_rows)
        if fast:
            self.events.record_batch(
                ((p.spec.task_id, p.spec.name) for p in fast),
                "dispatched")
            dq: collections.deque = collections.deque(fast)
            k = min(self._pool.num_threads, len(fast))
            self._pool.submit_many(
                [(self._drain_local_batch, (dq,))] * k)
        if local:
            self._pool.submit_many(local)
        for pool, batch in groups.items():
            self._pool.submit(self._run_pool_batch, pool, batch)

    def _drain_local_batch(self, dq) -> None:
        """Fast-path executor drain: plain no-dep NORMAL tasks from one
        tick's grants. Per task it does only the irreducible work —
        cancel-registry bracket, the user function, the result put, and
        the scheduler notification (slot release must never wait on a
        batch, or a blocked sibling could deadlock dependants).
        Everything deferrable — task-manager lineage completion — is
        flushed per drain. The deque is SHARED with the other executor
        threads: each pops one task at a time, so a blocking task
        stalls only itself (see _dispatch_many)."""
        running = self._running_tasks
        rlock = self._running_lock
        record = self.events.record
        put = self.memory_store.put
        notify = self.scheduler.notify_batch
        ctx = self._context
        prev_task = ctx.task_id
        prev_put = ctx.put_counter
        complete = self.task_manager.complete_batch_with_refs
        has_ref = self.reference_counter.has_reference
        done: List[tuple] = []
        te = self.task_events
        te_done: List[tuple] = []
        tp = self.trace_plane
        tp_done: List[tuple] = []
        wkey = threading.get_ident()
        try:
            while True:
                try:
                    pending = dq.popleft()
                except IndexError:
                    break
                spec = pending.spec
                exec_id = spec.task_id
                pre_timed_out = False
                with rlock:
                    running[exec_id] = False
                    if self._precancelled \
                            and exec_id in self._precancelled:
                        self._precancelled.discard(exec_id)
                        running[exec_id] = True
                    elif self._pretimeout \
                            and exec_id in self._pretimeout:
                        self._pretimeout.discard(exec_id)
                        pre_timed_out = True
                ctx.task_id = exec_id
                ctx.put_counter = 0
                record(exec_id, spec.name, "started", pending.node_index)
                rids = (getattr(spec, "_retry_return_ids", None)
                        or spec.return_ids())  # id-keyed memo inside
                retry_task = None
                ready = ()
                try:
                    if pre_timed_out:
                        # deadline expired while executor-queued: fail
                        # the attempt (retriably) without running it
                        if self._claim_task_completion(exec_id) != "timeout":
                            retry_task = self._handle_task_failure(
                                spec, rids, rex.TaskTimeoutError(
                                    f"task {spec.name} timed out after "
                                    f"{spec.timeout_s}s before starting",
                                    task_id=exec_id,
                                    timeout_s=spec.timeout_s))
                    elif running.get(exec_id) == "timeout":
                        pass  # watcher already failed/retried it
                    elif running.get(exec_id):
                        self._store_error(
                            spec, rids, rex.TaskCancelledError(exec_id))
                    else:
                        try:
                            self._maybe_inject_failure()
                            t0 = time.time()
                            with trace_plane.parent_scope(
                                    spec.trace_ctx if tp is not None
                                    else None):
                                result = spec.func(*spec.args)
                            t1 = time.time()
                        except BaseException as e:  # noqa: BLE001
                            flag = self._claim_task_completion(exec_id)
                            if flag == "timeout":
                                pass  # watcher already failed/retried it
                            elif flag:
                                # cancelled mid-run: never retry
                                self._store_error(
                                    spec, rids,
                                    rex.TaskCancelledError(exec_id))
                            else:
                                retry_task = self._handle_task_failure(
                                    spec, rids, e)
                        else:
                            flag = self._claim_task_completion(exec_id)
                            if flag == "timeout":
                                pass  # retry owns the return ids now
                            elif flag:
                                # cancel landed mid-run: drop the result
                                self._store_error(
                                    spec, rids,
                                    rex.TaskCancelledError(exec_id))
                            else:
                                put(rids[0], result)
                                ready = (rids[0],)
                                done.append((exec_id, rids[0]))
                                if te is not None:
                                    te_done.append(
                                        (exec_id, (t0, t1), wkey,
                                         pending.node_index))
                                if (tp is not None
                                        and spec.trace_ctx is not None
                                        and spec.trace_ctx[3]):
                                    tp_done.append(
                                        (exec_id, (t0, t1), wkey,
                                         pending.node_index))
                finally:
                    with rlock:
                        running.pop(exec_id, None)
                    record(exec_id, spec.name, "finished",
                           pending.node_index)
                    notify(ready, ((exec_id, pending.node_index,
                                    spec.resources),))
                    if retry_task is not None:
                        # finished-notification already out: the
                        # scheduler sees the slot release before the
                        # retry (same ordering as _execute_task)
                        if done:
                            complete(done, has_ref)
                            done = []
                        self._submit_retry(retry_task)
                if len(done) >= 256:
                    complete(done, has_ref)
                    done = []
                if len(te_done) >= 256:
                    te.record_finished_batch(te_done)
                    te_done = []
                if len(tp_done) >= 256:
                    tp.record_finished_batch(tp_done)
                    tp_done = []
        finally:
            ctx.task_id = prev_task
            ctx.put_counter = prev_put
            if done:
                complete(done, has_ref)
            if te_done:
                te.record_finished_batch(te_done)
            if tp_done:
                tp.record_finished_batch(tp_done)
            self.placement_groups.poke()

    def _run_pool_batch(self, pool, batch: List[PendingTask]) -> None:
        try:
            pool.run_task_batch(batch)
        except Exception:
            logger.exception("batch dispatch failed on node %d",
                             batch[0].node_index)

    def _boot_actor(self, pending: PendingTask, boot) -> None:
        try:
            boot(pending, pending.node_index)
        except Exception:
            logger.exception("actor bootstrap failed")

    # ------------------------------------------------------------------
    # Virtual multi-node (reference: python/ray/cluster_utils.py — each
    # added node is a REAL per-node runtime: its own exec'd worker
    # processes behind its own pool, with declared resources)
    # ------------------------------------------------------------------
    def add_cluster_node(self, num_cpus: float = 4.0, num_gpus: float = 0.0,
                         num_workers: Optional[int] = None,
                         resources: Optional[Dict[str, float]] = None):
        """A process-backed node: its own pool of exec'd workers on this
        host, sharing the head's arena. ``num_gpus`` > 0 needs
        ``worker_gpu_access``: a node whose workers cannot see the card
        advertises no GPU, so this raises instead."""
        from ray_tpu_torch._private.runtime.process_pool import (
            ProcessWorkerPool, auto_pipeline_depth)
        from ray_tpu_torch._private.runtime.shm_store import ShmObjectStore

        if num_gpus and not GLOBAL_CONFIG.worker_gpu_access:
            raise ValueError(
                f"add_cluster_node(num_gpus={num_gpus}): the node's worker "
                "processes cannot see the card; set worker_gpu_access=True "
                "to give them it")
        if self.shm_store is None:
            # thread-mode head: the cluster's shared object arena appears
            # with the first process-backed node
            self.shm_store = ShmObjectStore(GLOBAL_CONFIG.object_store_memory)
        custom = sum((resources or {}).values())
        node_id = NodeID.from_random()
        nw = num_workers or max(int(num_cpus), 1)
        state = NodeState((num_cpus, num_gpus, 1e18, custom),
                          node_id=node_id, custom_resources=resources,
                          window_factor=auto_pipeline_depth(nw))
        row = self.scheduler.add_node(state, wake=False)
        pool = ProcessWorkerPool(self, nw, self.shm_store, node_index=row)
        self._node_pools[row] = pool
        self.scheduler.poke()
        entry = self.gcs.register_node(
            node_id, row, {"CPU": num_cpus, "GPU": num_gpus,
                           **(resources or {})},
            kind="process", pool=pool)
        self.gcs.start_health_checks()
        return entry

    def add_remote_cluster_node(self, num_cpus: float = 4.0,
                                num_gpus: float = 0.0,
                                num_workers: Optional[int] = None,
                                resources: Optional[Dict[str, float]] = None,
                                object_store_memory: Optional[int] = None):
        """Add a node backed by a NODE DAEMON process with its OWN shm
        arena, connected over TCP (localhost stands in for the DCN) —
        the real multi-host topology, unlike add_cluster_node's
        same-process pools sharing the head arena. Reference: one
        raylet+plasma per node, registered with the GCS over the
        network. ``num_gpus`` > 0 needs ``worker_gpu_access``, as
        add_cluster_node does: the daemon gives its workers the card
        only then, and never touches it itself."""
        import subprocess

        from ray_tpu_torch._private.runtime.remote_pool import (HeadServer,
                                                          RemoteNodePool)

        if num_gpus and not GLOBAL_CONFIG.worker_gpu_access:
            raise ValueError(
                f"add_remote_cluster_node(num_gpus={num_gpus}): the node's "
                "worker processes cannot see the card; set "
                "worker_gpu_access=True to give them it")
        if self._head_server is None:
            self._head_server = HeadServer()
        # a severed daemon link (chaos flap, transient network drop)
        # comes back as an UNSOLICITED rejoin hello — without the hook
        # the accept loop would silently close it and the node would
        # burn its whole REJOINING grace window dialing a deaf head
        self._head_server.on_unsolicited = self._on_unsolicited_hello
        token = self._head_server.issue_token()
        slot_ev, slot = self._head_server.expect(token)
        # the daemon never touches the card; it keeps the card visible
        # for its workers only on a GPU node (node_daemon's
        # _workers_see_card makes the same choice for each worker)
        from ray_tpu_torch._private import log_plane, spawn_env
        from ray_tpu_torch._private.runtime.node_daemon import HEAD_AUTHKEY_ENV
        extra = {HEAD_AUTHKEY_ENV: self._head_server.authkey.hex()}
        if GLOBAL_CONFIG.profile_hz > 0:
            # hand the daemon the head's live profile knobs (they may
            # have arrived via _system_config, not env) so it starts
            # its utilization sampler and re-exports to its workers
            from ray_tpu_torch._private.runtime.worker_process import (
                PROFILE_HZ_ENV)
            extra[PROFILE_HZ_ENV] = str(GLOBAL_CONFIG.profile_hz)
            extra["RAY_TPU_TORCH_UTILIZATION_INTERVAL_S"] = str(
                GLOBAL_CONFIG.utilization_interval_s)
        if self.session_log_dir is not None:
            # the daemon's own node log dir nests under the head's
            # session dir (same-host clusters; a true remote host just
            # creates the path locally), and the daemon's own
            # stdout/stderr capture files live inside it
            node_dir = os.path.join(self.session_log_dir,
                                    f"node-{token[:8]}")
            extra["RAY_TPU_TORCH_LOG_DIR"] = node_dir
            extra.update(log_plane.child_log_env(
                node_dir, f"node_daemon-{token[:8]}",
                GLOBAL_CONFIG.log_rotation_bytes,
                GLOBAL_CONFIG.log_rotation_backups))
        env = spawn_env.child_env(use_accelerator=bool(num_gpus),
                                  extra=extra)
        host, port = self._head_server.address
        import json as _json
        info = _json.dumps({"num_cpus": num_cpus, "num_gpus": num_gpus,
                            "gpu_access": bool(num_gpus),
                            "resources": resources or {},
                            "num_workers": num_workers
                            or max(int(num_cpus), 1)})
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.runtime.node_daemon",
             host, str(port), token,
             str(object_store_memory
                 or GLOBAL_CONFIG.object_store_memory),
             str(GLOBAL_CONFIG.inline_object_max_bytes),
             info, str(GLOBAL_CONFIG.daemon_rejoin_timeout_s)],
            env=env, close_fds=True,
            # its own session: the daemon leads a process group holding
            # its whole worker tree, so machine-death chaos can killpg
            # the entire "machine" at once (and a SIGINT at the driver
            # terminal never reaches the simulated remote node)
            start_new_session=True)
        if not slot_ev.wait(timeout=30.0) or not slot:
            proc.kill()
            raise RuntimeError("node daemon failed to register with the "
                               "head within 30s")
        conn, hello = slot[0], slot[1]
        arena_name = hello[3] if len(hello) > 3 else None
        peer_address = hello[4] if len(hello) > 4 else None
        custom = sum((resources or {}).values())
        node_id = NodeID.from_random()
        state = NodeState((num_cpus, num_gpus, 1e18, custom),
                          node_id=node_id, custom_resources=resources)
        # row wiring order: the pool must be reachable through
        # pool_for_node BEFORE the scheduler may dispatch to the row, or
        # a pending task/actor lands on a half-registered node
        row = self.scheduler.add_node(state, wake=False)
        pool = RemoteNodePool(self, num_workers or max(int(num_cpus), 1),
                              row, conn, node_id, daemon_proc=proc,
                              arena_name=arena_name,
                              peer_address=peer_address)
        self._node_pools[row] = pool
        self._has_remote_nodes = True
        self.scheduler.poke()
        entry = self.gcs.register_node(
            node_id, row, {"CPU": num_cpus, "GPU": num_gpus,
                           **(resources or {})},
            kind="remote", pool=pool)
        self.gcs.start_health_checks()
        self._ensure_resview_push()
        return entry

    def enable_head_endpoint(self, host: str = "127.0.0.1", port: int = 0):
        """Open (or return) the head's TCP endpoint and accept
        UNSOLICITED registrations: remote clients (`ray://` sessions)
        and joining node daemons (``python -m
        ray_tpu_torch._private.runtime.node_daemon <host> <port> join
        ...``).
        Returns the HeadServer; its address/authkey form the connect
        string."""
        from ray_tpu_torch._private.client import ClientServer
        from ray_tpu_torch._private.runtime.remote_pool import HeadServer

        if self._head_server is not None:
            cur_host, cur_port = self._head_server.address
            if (port != 0 and port != cur_port) or host != cur_host:
                raise RuntimeError(
                    f"head endpoint already bound to {cur_host}:{cur_port} "
                    f"(created when the first remote node was added); call "
                    f"enable_head_endpoint(host=..., port=...) BEFORE "
                    f"adding remote nodes to pick the bind address")
        if self._head_server is None:
            authkey = None
            if GLOBAL_CONFIG.gcs_journal_path:
                # persist (port, authkey) beside the journal: after a
                # head restart, orphaned daemons re-dial the SAME
                # address with the SAME cluster secret
                import json as _json
                secret_path = GLOBAL_CONFIG.gcs_journal_path + ".secret"
                if os.path.exists(secret_path):
                    with open(secret_path) as f:
                        d = _json.load(f)
                    authkey = bytes.fromhex(d["authkey"])
                    if port == 0:
                        port = int(d["port"])
                self._head_server = HeadServer(host, port, authkey=authkey)
                # the authkey is the cluster credential: owner-only
                # permissions, like ssh key material
                fd = os.open(secret_path,
                             os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
                with os.fdopen(fd, "w") as f:
                    _json.dump({"authkey":
                                self._head_server.authkey.hex(),
                                "port": self._head_server.address[1]}, f)
            else:
                self._head_server = HeadServer(host, port)
        if self.client_server is None:
            self.client_server = ClientServer(self)
        self._head_server.on_unsolicited = self._on_unsolicited_hello
        return self._head_server

    def _on_unsolicited_hello(self, conn, hello: tuple) -> None:
        kind = hello[1]
        if kind == "client":
            self.client_server.attach(conn, hello)
        elif kind == "join" and len(hello) >= 5:
            self.adopt_remote_node(conn, hello)
        elif kind == "rejoin" and len(hello) >= 7:
            pool = self._find_rejoin_pool(hello[3])
            if pool is not None:
                # link flap, not a head restart: THIS head already runs
                # the node — its pool (leases, refs, worker handles) is
                # intact, so only the transport swaps. The daemon's
                # outbox replay follows and the sequence dedup drops
                # everything this head already processed.
                pool.reattach(conn)
            else:
                self.readopt_remote_node(conn, hello)
        else:
            conn.close()

    def _find_rejoin_pool(self, arena_name):
        """Match a rejoin hello to a pool this head already owns (by
        arena name — unique per daemon). A true head restart has no
        pools to match and falls through to full re-adoption."""
        if not arena_name:
            return None
        for pool in list(self._node_pools.values()):
            if getattr(pool, "is_remote", False) \
                    and getattr(pool, "_arena_name", None) == arena_name \
                    and not pool._node_dead:
                return pool
        return None

    def adopt_remote_node(self, conn, hello: tuple):
        """A node daemon started out-of-band (``python -m
        ray_tpu_torch._private.runtime.node_daemon <host> <port> join
        ...``) registers itself: same runtime as
        add_remote_cluster_node but the daemon process belongs to
        another launcher (possibly another machine)."""
        from ray_tpu_torch._private.runtime.remote_pool import RemoteNodePool

        arena_name, info = hello[3], hello[4]
        peer_address = hello[5] if len(hello) > 5 else None
        num_cpus = float(info.get("num_cpus", 4.0))
        num_gpus = _node_gpus(info)
        resources = dict(info.get("resources") or {})
        num_workers = int(info.get("num_workers") or max(int(num_cpus), 1))
        node_id = NodeID.from_random()
        state = NodeState((num_cpus, num_gpus, 1e18,
                           sum(resources.values())),
                          node_id=node_id, custom_resources=resources)
        row = self.scheduler.add_node(state, wake=False)
        # arena_name travels so a SAME-host joined daemon's segment can
        # be reaped after death (on another host the name matches
        # nothing here and the reap is a no-op)
        pool = RemoteNodePool(self, num_workers, row, conn, node_id,
                              daemon_proc=None, arena_name=arena_name,
                              peer_address=peer_address)
        self._node_pools[row] = pool
        self._has_remote_nodes = True
        self.scheduler.poke()
        entry = self.gcs.register_node(
            node_id, row, {"CPU": num_cpus, "GPU": num_gpus, **resources},
            kind="remote", pool=pool)
        self.gcs.start_health_checks()
        self._ensure_resview_push()
        logger.info("adopted remote node %s (row %d, arena %s)",
                    node_id.hex()[:16], row, arena_name)
        return entry

    def readopt_remote_node(self, conn, hello: tuple):
        """Control-plane FT, node side: an orphaned daemon (its head
        died without an exit) rejoins a RESTARTED head. Its live worker
        processes are adopted instead of respawned, and dedicated
        workers hosting journaled (detached) actors get their runtimes
        re-attached — actor state survives the head restart inside the
        worker process (reference: GCS restart with Redis replay while
        raylets keep running, SURVEY.md §5 GCS FT)."""
        from ray_tpu_torch._private.ids import ActorID
        from ray_tpu_torch._private.runtime.remote_pool import RemoteNodePool

        _, _, pid, arena_name, info, peer_address, workers = hello[:7]
        num_cpus = float(info.get("num_cpus", 4.0))
        num_gpus = _node_gpus(info)
        resources = dict(info.get("resources") or {})
        # epoch fence: a daemon whose node this head already DECLARED
        # DEAD (partition outlived the grace window) comes back as a
        # fresh node, but nothing from its dead era may resolve — the
        # node-death reconciler already resubmitted or failed every
        # adopted lease and restarted its actors elsewhere. The fenced
        # pool acks-but-drops outbox REPLAY envelopes, no dead-era
        # lease is re-attached, and the ("fence", epoch) frame below
        # tells the daemon to clear its dead-era local-lease state.
        fenced = bool(arena_name) and arena_name in self._fenced_arenas
        node_id = NodeID.from_random()
        state = NodeState((num_cpus, num_gpus, 1e18,
                           sum(resources.values())),
                          node_id=node_id, custom_resources=resources)
        row = self.scheduler.add_node(state, wake=False)
        pool = RemoteNodePool(self, 0, row, conn, node_id,
                              daemon_proc=None, arena_name=arena_name,
                              peer_address=peer_address, fenced=fenced,
                              adopting=True)
        self._node_pools[row] = pool
        self._has_remote_nodes = True
        adopted_actors = 0
        adopted_leases = 0
        try:
            for num, winfo in sorted(workers.items()):
                actor_hex = winfo.get("actor")
                inflight = winfo.get("inflight") or {}
                h = pool.adopt_worker(int(num), winfo.get("pid"),
                                      is_actor=actor_hex is not None,
                                      busy=bool(inflight) and not fenced)
                if fenced:
                    # dead-era state is unwanted: stale in-flight results
                    # find no inflight entry and drop; actor workers are
                    # released (their actors already restarted elsewhere
                    # or went DEAD when the node did)
                    if actor_hex is not None:
                        pool.release_actor_worker(h, kill=True)
                    continue
                if actor_hex is None:
                    # lease reconciliation: tasks this worker still RUNS,
                    # or finished while no head was up (the completion
                    # waits in the daemon's outbox, replayed once the
                    # demux opens), re-attach as synthetic inflight
                    # entries under their ORIGINAL return oids, so the
                    # done/err (live or outbox replay) resolves the refs
                    # a resumed client is blocked on. Attempt skew
                    # (journal ahead of the report) means the old head
                    # re-dispatched the task elsewhere before dying:
                    # leave the record for its real claimant and let
                    # this worker's stale result drop (no inflight
                    # entry).
                    for tid_hex, rep in inflight.items():
                        tid_bin = bytes.fromhex(tid_hex)
                        rep_attempt = int(rep.get("attempt", 0))
                        lease = self.gcs.claim_lease(tid_bin)
                        if lease is not None and int(
                                lease.get("attempt", 0)) != rep_attempt:
                            self.gcs.journal_lease(tid_bin, lease)
                            continue
                        returns = [bytes.fromhex(x)
                                   for x in rep.get("returns", [])]
                        for rbin in returns:
                            self.reference_counter.add_owned_object(
                                ObjectID(rbin))
                        pool.adopt_inflight(h, tid_bin, returns, rep_attempt)
                        adopted_leases += 1
                    continue
                actor_id = ActorID(bytes.fromhex(actor_hex))
                entry = self.gcs.orphaned_actor(actor_id)
                recovery = self.gcs.actor_recovery_blob(actor_id)
                if entry is None or recovery is None:
                    # not a journaled detached actor: its owner died with
                    # the old head — release the worker
                    pool.release_actor_worker(h, kill=True)
                    continue
                try:
                    from ray_tpu_torch.actor import adopt_process_actor
                    adopt_process_actor(self, actor_id, entry, recovery,
                                        pool, h, row)
                    adopted_actors += 1
                except Exception:
                    logger.exception("actor %s re-adoption failed",
                                     actor_id.hex()[:16])
                    pool.release_actor_worker(h, kill=True)
        finally:
            # the outbox replay behind the hello reaches the adopted
            # workers and leases now
            pool.open_dispatch()
        if fenced:
            # the daemon clears its dead-era local-lease/outbox/p2p
            # bookkeeping so no zombie re-lease or stale fallback ever
            # resurfaces; the epoch value is an opaque fence token for
            # the daemon's log
            pool._send_daemon(("fence", int(time.monotonic() * 1000)))
            self._fenced_arenas.pop(arena_name, None)
        # plain workers survive with their leases now (the daemon no
        # longer kills mid-task workers at rejoin); still top up to the
        # node's declared worker count so the row never advertises CPUs
        # with no process to run on
        target = int(info.get("num_workers") or max(int(num_cpus), 1))
        plain = sum(1 for w in workers.values() if not w.get("actor"))
        for _ in range(max(0, target - plain)):
            h = pool._spawn()  # takes the pool lock itself
            with pool._lock:
                pool._handles.append(h)
        entry = self.gcs.register_node(
            node_id, row, {"CPU": num_cpus, "GPU": num_gpus, **resources},
            kind="remote", pool=pool)
        self.gcs.start_health_checks()
        self.scheduler.poke()
        self._ensure_resview_push()
        logger.info("re-adopted node %s (row %d)%s: %d workers, "
                    "%d actors, %d in-flight leases",
                    node_id.hex()[:16], row,
                    " FENCED (rejoin after declared dead)" if fenced
                    else "", len(workers), adopted_actors,
                    adopted_leases)
        self._start_failover_reconciler()
        return entry

    # ------------------------------------------------------------------
    # head-failover lease reconciliation (the resubmission half;
    # readopt_remote_node above re-attaches the leases survivors claim)
    # ------------------------------------------------------------------
    def _start_failover_reconciler(self) -> None:
        """One-shot, kicked by the first post-restart rejoin: wait for
        the rest of the pre-crash daemons (count-based — rejoined
        daemons carry fresh NodeIDs, so identity can't match) and then
        resubmit every journaled lease no survivor claimed."""
        if self._failover_reconciler_started:
            return
        self._failover_reconciler_started = True
        if not self.gcs.journal_enabled:
            return
        threading.Thread(target=self._reconcile_failover_leases,
                         args=(self.gcs.replayed_node_count,),
                         daemon=True,
                         name="ray_tpu_failover_reconcile").start()

    def _reconcile_failover_leases(self, expected: int) -> None:
        deadline = time.monotonic() + GLOBAL_CONFIG.daemon_rejoin_grace_s
        while time.monotonic() < deadline:
            alive = sum(1 for e in self.gcs.node_table()
                        if e.kind == "remote" and e.state == "ALIVE")
            if alive >= expected:
                break
            time.sleep(0.2)
        unclaimed = self.gcs.pending_leases()
        resub = 0
        for tid_bin, rec in unclaimed.items():
            if self.gcs.claim_lease(tid_bin) is None:
                continue  # a late rejoin claimed it under us
            self.gcs.journal_lease_done(tid_bin)  # consumed either way
            if self._resubmit_lease(tid_bin, rec):
                resub += 1
        if unclaimed:
            logger.warning(
                "head failover: %d journaled leases unclaimed by "
                "rejoining nodes; %d resubmitted", len(unclaimed), resub)

    def _resubmit_lease(self, tid_bin: bytes, rec: dict,
                        why: str = "head failover") -> bool:
        """Rebuild a TaskSpec from a retained/journaled lease record
        and submit it under the ORIGINAL return oids with a bumped
        attempt token — a stale replay of the dead attempt finds no
        inflight entry and drops, so the task's side effects run at
        most once post-recovery. Records without a resubmittable body
        fail their refs instead of hanging the owner's get()."""
        import cloudpickle

        returns = [ObjectID(b) for b in rec.get("returns", [])]
        name = rec.get("name") or "failover_resubmit"
        fn_blob, args_blob = rec.get("fn_blob"), rec.get("args_blob")
        try:
            if fn_blob is None or args_blob is None:
                raise ValueError("lease record has no resubmit body")
            func = cloudpickle.loads(fn_blob)
            args, kwargs = cloudpickle.loads(args_blob)
        except Exception as e:
            exc = rex.WorkerCrashedError(
                f"task {name} was in flight on a dead node ({why}), "
                f"and its lease record cannot be resubmitted ({e})")
            for oid in returns:
                self.reference_counter.add_owned_object(oid)
                self.memory_store.put(oid, exc, is_exception=True)
                self.scheduler.notify_object_ready(oid)
            return False
        spec = TaskSpec(
            task_id=self.next_task_id(),
            name=name,
            func=func,
            func_descriptor=name,
            args=args,
            kwargs=kwargs,
            num_returns=int(rec.get("num_returns", len(returns) or 1)),
            resources=dict(rec.get("resources") or {"CPU": 1}),
            max_retries=int(rec.get("max_retries", 0)),
            serialized_func=fn_blob,
            attempt_number=int(rec.get("attempt", 0)) + 1,
        )
        spec._retry_return_ids = returns  # type: ignore[attr-defined]
        for oid in returns:
            self.reference_counter.add_owned_object(
                oid, lineage_task=spec.task_id)
        self.task_manager.add_pending(spec, [])
        self.scheduler.submit(PendingTask(spec=spec, deps=[],
                                          execute=_noop_exec))
        logger.warning("%s: resubmitting %s (lease %s, attempt %d)",
                       why, name, tid_bin.hex()[:16],
                       spec.attempt_number)
        return True

    def on_node_failure(self, node_id: NodeID, reason: str = "") -> None:
        """Node death: mark dead, stop scheduling to it, fail/retry its
        in-flight work, reschedule its placement-group bundles, and fail
        or restart its actors (reference: NodeManager/GcsNodeManager
        death handling + lineage-driven resubmission). A remote node's
        copies also leave the object directory, and the leases its
        daemon admitted are reconciled."""
        entry = None
        for e in self.gcs.node_table():
            if e.node_id == node_id:
                entry = e
                break
        if entry is None or entry.state == "DEAD":
            return
        self.gcs.mark_node_dead(node_id, reason)
        # 1) no new assignments to the node (also invalidates in-flight
        #    snapshot decisions at apply time)
        self.scheduler.remove_node(entry.index)
        # 1b) the dead node's copies leave the object directory. Objects
        #     whose LAST copy died are LOST unless already
        #     fetched/memoized head-side — drop them so a later get()
        #     reconstructs from lineage. Objects with a surviving
        #     secondary (a completed staging pull) promote it to primary
        #     instead: the head's placeholder repoints and no
        #     reconstruction is needed.
        from ray_tpu_torch._private.runtime.process_pool import RemotePlaceholder
        lost, promoted = self.gcs.drop_node_locations(entry.index)
        for oid in lost:
            e = self.memory_store.get_entry(oid)
            if e is not None and not e.is_exception \
                    and isinstance(e.value, RemotePlaceholder) \
                    and e.value.node_index == entry.index:
                self.object_recovery.note_freed(oid)
                self.memory_store.delete([oid])
        for oid, new_primary in promoted.items():
            e = self.memory_store.get_entry(oid)
            if e is not None and not e.is_exception \
                    and isinstance(e.value, RemotePlaceholder) \
                    and e.value.node_index == entry.index:
                e.value.node_index = new_primary
        # 2) placement groups with bundles on the node reschedule
        self.placement_groups.on_node_dead(entry.index)
        # 3) two-level plane reconciliation: decide the fate of every
        #    lease the node's LocalScheduler admitted (retry under the
        #    original return oids or fail the refs), release their arg
        #    pins, fence the arena against stale rejoin replays, and
        #    broadcast route invalidation so peers drop cached p2p
        #    routes NOW instead of waiting out the lane-sever timeout.
        self.note_two_level("node_deaths")
        pool = self._node_pools.pop(entry.index, None)
        if pool is not None:
            self._dead_pools.append(pool)
            if getattr(pool, "is_remote", False):
                self._reconcile_orphan_leases(pool, reason)
                arena = getattr(pool, "_arena_name", None)
                if arena:
                    self._fenced_arenas[arena] = time.monotonic()
                self._broadcast_node_death(entry.index, pool)
            # 4) fail queued + running work retriably; kill worker
            #    processes. Monitors drive per-task retries; actor
            #    runtimes observe their worker's death and restart
            #    elsewhere or go DEAD.
            pool.fail_node(reason or "node removed")
        self.placement_groups.poke()

    def _reconcile_orphan_leases(self, pool, reason: str) -> None:
        """Node-death half of adopted-lease reconciliation: claim every
        lease the dead node's LocalScheduler still had in flight and
        route it through :meth:`reconcile_orphan_lease`. Claiming the
        inflight entry here (under the pool lock) keeps the per-worker
        failure sweep from double-handling the same lease when the
        dead daemon's ``__died__`` notifications race this call."""
        tids = pool.take_local_tids()
        retried = 0
        for tid_bin in sorted(tids):
            task_id = TaskID(tid_bin)
            with pool._lock:
                h = pool._by_task.get(task_id)
            if h is None:
                continue
            inf = pool._take_inflight(h, task_id)
            if inf is None:
                continue  # a failure sweep claimed it first
            err = rex.NodeDiedError(
                f"node {pool.node_index} died while running a locally "
                f"dispatched lease: {reason or 'node removed'}")
            if self.reconcile_orphan_lease(
                    tid_bin, [o.binary() for o in inf.return_ids], err):
                retried += 1
        if tids:
            logger.warning(
                "node %d death: %d adopted local leases reconciled "
                "(%d resubmitted, %d failed)", pool.node_index,
                len(tids), retried, len(tids) - retried)

    def reconcile_orphan_lease(self, tid_bin: bytes, return_bins,
                               err: BaseException) -> bool:
        """An adopted local lease lost its worker (or whole node) with
        no daemon-side retry in flight. Popping the retained record is
        the exactly-once arbiter between the node-death reconciler and
        the per-worker failure sweep: the claimant resubmits the lease
        head-side under its ORIGINAL return oids when attempts remain,
        or fails its refs terminally. Arg pins release either way (a
        dead node can never send the resolution that would have freed
        them). Returns True when the lease was resubmitted."""
        with self._local_pin_lock:
            rec = self._local_lease_records.pop(tid_bin, None)
        self.release_local_lease_pins(tid_bin)
        if self.gcs.journal_enabled:
            if self.gcs.claim_lease(tid_bin) is not None:
                self.gcs.journal_lease_done(tid_bin)
        if rec is not None and int(rec.get("attempt", 0)) \
                < int(rec.get("max_retries", 0)):
            if self._resubmit_lease(tid_bin, dict(rec),
                                    why="node death"):
                self.note_two_level("orphan_retried")
                return True
            return False  # _resubmit_lease already failed the refs
        returns = [ObjectID(b) for b in
                   ((rec or {}).get("returns") or return_bins or ())]
        for oid in returns:
            self.memory_store.put(oid, err, is_exception=True)
            self.scheduler.notify_object_ready(oid)
        return False

    def _broadcast_node_death(self, index: int, pool) -> None:
        """Route invalidation: tell every surviving daemon the node is
        gone NOW. Peers evict its gossip view, drop cached p2p actor
        routes to its address, and sweep in-flight lane calls to the
        head path immediately instead of waiting out the 15s p2p
        result timeout."""
        peer = getattr(pool, "peer_address", None)
        info = {"index": index,
                "peer": tuple(peer) if peer else None}
        for p in list(self._node_pools.values()):
            if p is pool or not getattr(p, "is_remote", False):
                continue
            try:
                p._send_daemon(("node_dead", info))
            except Exception:
                pass  # a dying link has nothing to invalidate

    def _execute_task(self, pending: PendingTask) -> None:
        spec = pending.spec
        # retries keep the ORIGINAL return ids so existing refs resolve
        return_ids = getattr(spec, "_retry_return_ids", None) or spec.return_ids()
        # capture the id this execution runs under: a retry mutates
        # spec.task_id, and the scheduler must be notified for THIS id
        # (and only after the retry has a fresh id) or its slot leaks
        exec_task_id = spec.task_id
        pre_timed_out = False
        with self._running_lock:
            # value is the cancellation flag: False = running, flipped
            # to True by cancel_task (an Event per task cost ~2us each)
            self._running_tasks[exec_task_id] = False
            if self._precancelled and exec_task_id in self._precancelled:
                self._precancelled.discard(exec_task_id)
                self._running_tasks[exec_task_id] = True
            elif self._pretimeout and exec_task_id in self._pretimeout:
                self._pretimeout.discard(exec_task_id)
                pre_timed_out = True

        prev_task = self._context.task_id
        prev_put = self._context.put_counter
        self._context.task_id = exec_task_id
        self._context.put_counter = 0
        self.events.record(exec_task_id, spec.name, "started",
                           pending.node_index)
        retry_task: Optional[PendingTask] = None
        ready_oids: List[ObjectID] = []
        pg_token = None
        if spec.placement_group_id is not None \
                and spec.placement_group_capture_child_tasks:
            from ray_tpu_torch.util.placement_group import _current_pg
            pg_token = _current_pg.set(spec.placement_group_id)
        # runtime_env env_vars: set for the task's duration. NOTE thread
        # mode shares one process environment — concurrent tasks with
        # conflicting env_vars can observe each other mid-flight
        # (process workers are the isolated path, as in the reference);
        # depth-counted push/pop guarantees the final restore is correct
        env_vars = (spec.runtime_env.get("env_vars")
                    if spec.runtime_env else None)
        if env_vars:
            env_vars_push(env_vars)
        env_ctx = None
        try:
            if pre_timed_out:
                # deadline expired while executor-queued: fail the
                # attempt (retriably) without running it
                if self._claim_task_completion(exec_task_id) != "timeout":
                    retry_task = self._handle_task_failure(
                        spec, return_ids, rex.TaskTimeoutError(
                            f"task {spec.name} timed out after "
                            f"{spec.timeout_s}s before starting",
                            task_id=exec_task_id,
                            timeout_s=spec.timeout_s))
                return
            try:
                # INSIDE the try: an env build failure (bad pip spec,
                # missing package) must fail the TASK — store the error
                # and let the finally release the slot (the process-
                # worker twin does the same)
                env_ctx = self._enter_runtime_env(spec.runtime_env)
            except Exception as e:
                self._store_error(spec, return_ids, e)
                return
            args, kwargs, dep_error, requeue_deps = self._resolve_args(spec)
            if requeue_deps:
                # lost deps are reconstructing: give the slot back and
                # wait for them through the normal dependency machinery
                # (the finally block releases this execution first)
                self.reference_counter.add_submitted_task_references(
                    getattr(spec, "_deps_memo", None)
                    or _top_level_deps(spec.args, spec.kwargs))
                retry_task = PendingTask(spec=spec, deps=requeue_deps,
                                         execute=_noop_exec)
                return
            if dep_error is not None:
                self._store_error(spec, return_ids, dep_error)
                return
            flag = self._running_tasks.get(exec_task_id)
            if flag == "timeout":
                return  # watcher already failed/retried this attempt
            if flag:
                self._store_error(spec, return_ids,
                                  rex.TaskCancelledError(exec_task_id))
                return
            try:
                self._maybe_inject_failure()
                t0 = time.time()
                with trace_plane.parent_scope(
                        spec.trace_ctx if self.trace_plane is not None
                        else None):
                    result = spec.func(*args, **kwargs)
                t1 = time.time()
            except BaseException as e:  # noqa: BLE001
                flag = self._claim_task_completion(exec_task_id)
                if flag == "timeout":
                    return  # watcher already failed/retried the attempt
                if flag:
                    # cancelled mid-run: the failure is moot, and a
                    # cancelled task must never retry
                    self._store_error(spec, return_ids,
                                      rex.TaskCancelledError(exec_task_id))
                    return
                retry_task = self._handle_task_failure(spec,
                                                       return_ids, e)
                return
            finally:
                # tear the env down BEFORE results publish: a caller
                # unblocked by _store_returns may submit a follow-up
                # task that must not see this env's modules/sys.path
                if env_ctx is not None:
                    env_ctx.__exit__(None, None, None)
                    env_ctx = None
            flag = self._claim_task_completion(exec_task_id)
            if flag == "timeout":
                # the deadline fired mid-run: the watcher already
                # failed/retried the attempt, and the retry owns the
                # return ids now — suppress this zombie's results
                return
            if flag:
                # cancel landed while the func ran (thread mode is
                # cooperative): discard the result
                self._store_error(spec, return_ids,
                                  rex.TaskCancelledError(exec_task_id))
                return
            ready_oids = self._store_returns(spec, return_ids, result)
            if self.task_events is not None:
                # no-op for records _store_returns already failed
                # (num_returns mismatch -> _store_error finalized them)
                self.task_events.record_finished_batch(
                    ((exec_task_id, (t0, t1), threading.get_ident(),
                      pending.node_index),))
            if self.trace_plane is not None:
                self.trace_plane.record_finished_batch(
                    ((exec_task_id, (t0, t1), threading.get_ident(),
                      pending.node_index),))
        finally:
            if env_ctx is not None:
                env_ctx.__exit__(None, None, None)
            if env_vars:
                env_vars_pop(env_vars)
            if pg_token is not None:
                from ray_tpu_torch.util.placement_group import _current_pg
                _current_pg.reset(pg_token)
            self._context.task_id = prev_task
            self._context.put_counter = prev_put
            with self._running_lock:
                self._running_tasks.pop(exec_task_id, None)
            self.events.record(exec_task_id, spec.name, "finished",
                               pending.node_index)
            deps = getattr(spec, "_deps_memo", None)
            if deps is None:
                deps = _top_level_deps(spec.args, spec.kwargs)
            if deps:
                self.reference_counter.remove_submitted_task_references(deps)
            # object-ready + task-finished in ONE scheduler wakeup
            self.scheduler.notify_batch(
                ready_oids,
                [(exec_task_id, pending.node_index, spec.resources)])
            self.placement_groups.poke()
            # resubmit AFTER the finished notification so the scheduler
            # releases this execution's slot before seeing the retry
            if retry_task is not None:
                self._submit_retry(retry_task)

    # serializes thread-mode env'd tasks: sys.path / sys.modules are
    # process-global, and two concurrent tasks with DIFFERENT
    # working_dirs would resolve each other's imports (env_vars gets a
    # depth-counted push/pop; import visibility cannot be layered the
    # same way, so env'd tasks take turns — process workers are the
    # isolated path, as in the reference)
    _env_serial_lock = threading.Lock()
    _env_lock_owner: Optional[int] = None  # thread ident holding the lock

    def _enter_runtime_env(self, runtime_env: Optional[dict]):
        """Thread-mode env application: working_dir extraction +
        pip-venv site-packages on sys.path for the task's duration
        (no chdir — one process cwd is shared across thread workers,
        same documented caveat as thread-mode env_vars)."""
        if not runtime_env or not (runtime_env.get("working_dir_pkg")
                                   or runtime_env.get("pip")):
            return None
        from ray_tpu_torch._private import runtime_envs as rte

        Worker._env_serial_lock.acquire()
        Worker._env_lock_owner = threading.get_ident()
        try:
            mgr = rte.get_manager()
            wd_path = None
            pkg = runtime_env.get("working_dir_pkg")
            if pkg:
                wd_path = mgr.ensure_working_dir(
                    pkg, lambda: self.gcs.kv_get(rte.kv_key(pkg)))
            sp = None
            if runtime_env.get("pip"):
                sp = mgr.ensure_pip(list(runtime_env["pip"]))
            ctx = rte.applied_env(wd_path, sp, use_cwd=False)
            ctx.__enter__()
        except BaseException:
            Worker._env_lock_owner = None
            Worker._env_serial_lock.release()
            raise

        class _LockedEnv:
            """applied_env + the serialization lock, released together."""

            def __exit__(self, *exc):
                try:
                    ctx.__exit__(*exc)
                finally:
                    Worker._env_lock_owner = None
                    Worker._env_serial_lock.release()
                return False

        return _LockedEnv()

    def _resolve_args(self, spec: TaskSpec):
        """Replace top-level ObjectRefs by values (reference semantics: only
        top-level args are awaited/inlined; nested refs pass through).

        Returns (args, kwargs, dep_error, requeue_deps): requeue_deps
        lists LOST deps now under lineage reconstruction — the caller
        re-queues the task to wait for them instead of blocking an
        executor thread (which the reconstruction itself may need)."""
        if not spec.args and not spec.kwargs:
            return (), {}, None, None
        dep_error = None
        requeue_deps: List[ObjectID] = []

        def resolve(v):
            nonlocal dep_error
            if isinstance(v, ObjectRef):
                oid = v.object_id()
                entry = self.memory_store.get_entry(oid)
                if entry is None:
                    # scheduler guaranteed readiness, so the object was
                    # LOST since: reconstruct from lineage
                    if self.object_recovery.maybe_recover(oid):
                        requeue_deps.append(oid)
                        return None
                    # unrecoverable: a tombstoned loss stored its error
                    entry = self.memory_store.get_entry(oid)
                if entry is None:
                    dep_error = rex.ObjectLostError(v.hex())
                    return None
                if entry.is_exception:
                    dep_error = entry.value
                    return None
                return self._entry_value(oid, entry)
            return v

        args = tuple(resolve(a) for a in spec.args)
        kwargs = {k: resolve(v) for k, v in spec.kwargs.items()}
        return args, kwargs, dep_error, requeue_deps

    def _store_returns(self, spec: TaskSpec, return_ids: List[ObjectID],
                       result) -> List[ObjectID]:
        """Store results; returns the stored oids — the CALLER delivers
        the object-ready notifications (batched with task-finished)."""
        if spec.num_returns == 1:
            values = [result]
        else:
            values = list(result) if result is not None else []
            if len(values) != spec.num_returns:
                err = ValueError(
                    f"task {spec.name} declared num_returns={spec.num_returns} "
                    f"but returned {len(values)} values")
                self._store_error(spec, return_ids, err)
                return []
        for oid, v in zip(return_ids, values):
            self.memory_store.put(oid, v)
        self.task_manager.complete(spec.task_id)
        return return_ids

    def _handle_task_failure(self, spec: TaskSpec, return_ids,
                             exc: BaseException) -> Optional[PendingTask]:
        """Store the error, or build the retry task for the caller to submit
        once this execution's finished-notification has gone out."""
        if self.task_manager.should_retry(spec, exc):
            spec.attempt_number += 1
            old_id = spec.task_id
            spec.task_id = self.next_task_id()  # retries get a fresh attempt id
            self.task_manager.num_retries += 1
            logger.warning("retrying task %s (attempt %d/%d): %s", spec.name,
                           spec.attempt_number, spec.max_retries, exc)
            msg = str(exc)
            if "(chaos" in msg:
                # an injected fault reached the retry machinery: count
                # the recovery against its site
                self._chaos.note_recovery(
                    "worker" if "chaos worker kill" in msg else "task")
            # resubmit under the ORIGINAL return ids
            spec._retry_return_ids = return_ids  # type: ignore[attr-defined]
            spec._backoff = True  # failure retry: _submit_retry delays it
            deps = _top_level_deps(spec.args, spec.kwargs)
            self.task_manager.rekey_pending(old_id, spec, deps)
            if self.task_events is not None:
                # old attempt -> failed ring (flagged retried); the new
                # attempt id opens its own record
                self.task_events.record_retry(
                    old_id, _task_error_type(exc), spec)
            if self.trace_plane is not None:
                # same logical span (spec.trace_ctx is untouched by the
                # in-place retry): the attempts link under one span
                self.trace_plane.record_retry(
                    old_id, _task_error_type(exc), spec)
            unresolved = [d for d in deps if not self.memory_store.contains(d)]
            return PendingTask(spec=spec, deps=unresolved,
                               execute=_noop_exec)
        if isinstance(exc, rex.TaskCancelledError):
            self._store_error(spec, return_ids, exc)
        elif isinstance(exc, rex.TaskTimeoutError):
            # exhausted deadline retries: one summary error chaining the
            # last per-attempt timeout (`raise ... from last_err`)
            final = rex.TaskTimeoutError(
                f"task {spec.name} timed out after {spec.attempt_number + 1} "
                f"attempt(s) of {spec.timeout_s}s each",
                task_id=spec.task_id, timeout_s=spec.timeout_s)
            final.__cause__ = exc
            self._store_error(spec, return_ids, final)
        else:
            tb = "".join(traceback.format_exception(type(exc), exc,
                                                    exc.__traceback__))
            err = rex.TaskError(spec.name, exc, tb)
            err.__cause__ = exc  # retry exhaustion chains the last failure
            self._store_error(spec, return_ids, err)
        return None

    def _store_error(self, spec: TaskSpec, return_ids, exc: BaseException):
        if self.task_events is not None:
            # terminal failure (retries, if any, were exhausted)
            self.task_events.record_failed(
                spec.task_id, _task_error_type(exc), name=spec.name,
                attempt=spec.attempt_number)
        if self.trace_plane is not None:
            self.trace_plane.record_failed(spec.task_id,
                                           _task_error_type(exc))
        for oid in return_ids:
            self.memory_store.put(oid, exc, is_exception=True)
            self.scheduler.notify_object_ready(oid)
        self.task_manager.complete(spec.task_id)

    def _fail_unassigned(self, tasks: List[PendingTask],
                         exc: BaseException) -> None:
        """The scheduler's fail_tasks hook: its batched device assignment
        raised, so these tasks fail with SchedulingError carrying the
        cause (the port never retries the batch on another backend)."""
        for pending in tasks:
            spec = pending.spec
            return_ids = (getattr(spec, "_retry_return_ids", None)
                          or spec.return_ids())
            err = rex.SchedulingError(
                f"task {spec.name} was not scheduled: the scheduler's "
                f"device assignment raised {exc!r}")
            err.__cause__ = exc
            deps = getattr(spec, "_deps_memo", None)
            if deps:
                self.reference_counter.remove_submitted_task_references(deps)
            self._store_error(spec, return_ids, err)

    def _maybe_inject_failure(self):
        """Thread-mode ``task`` injection site. The controller also
        honors the live testing_inject_task_failure_prob knob."""
        fault = self._chaos.poll("task")
        if fault is None:
            return
        if fault["kind"] == "hang":
            time.sleep(fault.get("hang_s", 0.2))
            return
        raise rex.WorkerCrashedError("injected failure (chaos)")

    # ------------------------------------------------------------------
    # Supervision: QoS preemption (config.qos)
    # ------------------------------------------------------------------
    def _qos_loop(self) -> None:
        """Preemption monitor: once the plane reports a starved higher
        tier (past preempt_grace_s), kill the lowest-tier running
        victim through the same paths the deadline watcher uses — the
        failure is a synthetic worker death, so the victim retries with
        a bumped attempt under its original return ids (journaled
        lease, exactly-once), never a double execution."""
        while self.alive:
            time.sleep(0.05)
            plane = self.qos_plane
            if plane is None or not self.alive:
                continue
            victim = plane.check_preempt(time.monotonic())
            if victim is None:
                continue
            tid, tenant, tier, starved_tier = victim
            try:
                if self._preempt_task(tid, tier, starved_tier):
                    plane.note_preempted(tenant, tier)
                    self.note_two_level("preempts")
            except Exception:
                logger.exception("preemption failed for task %s",
                                 tid.hex()[:16])

    def _preempt_task(self, tid: TaskID, tier: int,
                      starved_tier: int) -> bool:
        """Kill one running attempt to make room for a starved higher
        tier. Returns True when a kill was delivered (the retry is
        owned by whichever failure path runs it)."""
        spec = self.task_manager.get_pending_spec(tid)
        if spec is None or spec.task_id != tid:
            return False  # attempt resolved (or retried) under the wire
        # the preemption contract: a victim is re-queued, never
        # terminally failed — grant the synthetic death an attempt if
        # the victim had none left
        if spec.attempt_number >= spec.max_retries:
            spec.max_retries = spec.attempt_number + 1
        err = rex.WorkerCrashedError(
            f"task {spec.name} preempted by tier-{starved_tier} work "
            f"(was running at tier {tier}); attempt will retry")
        return_ids = (getattr(spec, "_retry_return_ids", None)
                      or spec.return_ids())
        # (a) leased to a process/remote pool: force-kill the attempt
        #     there — the pool failure path classifies it retriable
        pools = list(self._node_pools.values())
        if self.process_pool is not None and self.process_pool not in pools:
            pools.append(self.process_pool)
        for pool in pools:
            c = getattr(pool, "cancel_for_preemption", None)
            if c is not None and c(tid):
                return True
        # (b) thread mode: flag the attempt as supervisor-failed (the
        #     cooperative zombie's results are suppressed, exactly like
        #     a deadline kill) and synthesize the worker death
        synthesize = False
        with self._running_lock:
            if self._running_tasks.get(tid) is False:
                self._running_tasks[tid] = "timeout"
                synthesize = True
        if synthesize:
            retry = self._handle_task_failure(spec, return_ids, err)
            if retry is not None:
                self._submit_retry(retry)
            return True
        return False

    # ------------------------------------------------------------------
    # Supervision: retry backoff + per-task deadlines
    # ------------------------------------------------------------------
    def _claim_task_completion(self, exec_task_id: TaskID):
        """Atomically end an attempt's cancellable window and return the
        flag it finished under: "timeout" means the deadline watcher
        already failed/retried the attempt (suppress the zombie's
        results), True means cancel_task flipped it mid-run (store
        TaskCancelledError, never retry), False/None is a clean finish."""
        with self._running_lock:
            return self._running_tasks.pop(exec_task_id, None)

    def _submit_retry(self, retry_task: PendingTask) -> None:
        """Resubmit a failed attempt's retry after exponential backoff
        (base delay doubling per attempt, capped, with seeded jitter) so
        a flapping node is not hammered with immediate resubmissions.
        Dep-requeues (no attempt bump) resubmit immediately. Call AFTER
        the attempt's finished-notification, like scheduler.submit."""
        spec = retry_task.spec
        if not getattr(spec, "_backoff", False):
            self.scheduler.submit(retry_task)
            return
        spec._backoff = False
        base = GLOBAL_CONFIG.task_retry_delay_s
        delay = 0.0
        if base > 0.0:
            delay = min(base * (2 ** max(spec.attempt_number - 1, 0)),
                        GLOBAL_CONFIG.task_retry_max_delay_s)
            if GLOBAL_CONFIG.task_retry_jitter:
                delay *= self._chaos.backoff_jitter(spec.attempt_number,
                                                    spec.name)
        # per-attempt delays kept on the spec so tests can assert growth
        delays = getattr(spec, "_retry_delays", None)
        if delays is None:
            delays = spec._retry_delays = []  # type: ignore[attr-defined]
        delays.append(delay)
        if delay <= 0.0:
            self._submit_retry_now(retry_task)
            return
        t = threading.Timer(delay, self._submit_retry_now, (retry_task,))
        t.daemon = True
        t.start()

    def _submit_retry_now(self, retry_task: PendingTask) -> None:
        if not self.alive:
            return
        spec = retry_task.spec
        try:
            if spec.timeout_s:
                self._register_deadline(spec)
            self.scheduler.submit(retry_task)
        except Exception:
            logger.exception("retry submission failed for %s", spec.name)

    def _register_deadline(self, spec: TaskSpec) -> None:
        """Arm the per-attempt deadline for spec's CURRENT task id; the
        watcher thread starts lazily with the first armed deadline."""
        if not spec.timeout_s or spec.timeout_s <= 0:
            return
        with self._deadline_cv:
            heapq.heappush(self._deadline_heap,
                           (time.monotonic() + spec.timeout_s,
                            self._deadline_seq.next(), spec.task_id, spec))
            if self._deadline_thread is None:
                self._deadline_thread = threading.Thread(
                    target=self._deadline_loop, daemon=True,
                    name="ray_tpu_deadline")
                self._deadline_thread.start()
            self._deadline_cv.notify()

    def _deadline_loop(self) -> None:
        while self.alive:
            with self._deadline_cv:
                if not self._deadline_heap:
                    self._deadline_cv.wait(timeout=0.5)
                    continue
                now = time.monotonic()
                due_at = self._deadline_heap[0][0]
                if due_at > now:
                    self._deadline_cv.wait(
                        timeout=min(due_at - now, 0.5))
                    continue
                _, _, tid, spec = heapq.heappop(self._deadline_heap)
            try:
                self._on_task_deadline(spec, tid)
            except Exception:
                logger.exception("deadline enforcement failed for %s",
                                 spec.name)

    def _on_task_deadline(self, spec: TaskSpec, tid: TaskID) -> None:
        """One expired deadline. ``tid`` is the attempt the deadline was
        armed for; a later attempt id on the spec means that attempt
        already resolved (each retry re-arms its own deadline)."""
        if spec.task_id is not tid and spec.task_id != tid:
            return
        if self.task_manager.get_pending_spec(tid) is None:
            return  # attempt completed under the wire
        err = rex.TaskTimeoutError(
            f"task {spec.name} exceeded its {spec.timeout_s}s deadline "
            f"(attempt {spec.attempt_number + 1})",
            task_id=tid, timeout_s=spec.timeout_s)
        return_ids = (getattr(spec, "_retry_return_ids", None)
                      or spec.return_ids())
        # (a) still queued in the scheduler: pull it out (no slot held,
        #     so no finished-notification is owed)
        if self.scheduler.cancel(tid):
            retry = self._handle_task_failure(spec, return_ids, err)
            if retry is not None:
                self._submit_retry(retry)
            return
        # (b) leased to a process pool: force-kill the attempt there,
        #     classified as a timeout (retriable)
        for pool in list(self._node_pools.values()):
            if pool.cancel_for_timeout(tid):
                return  # pool failure path raises TaskTimeoutError
        # (c) thread mode: running (flag the attempt as timed out and
        #     fail it now — the zombie thread's results are suppressed)
        #     or executor-queued (timed out at execution start)
        synthesize = False
        with self._running_lock:
            flag = self._running_tasks.get(tid)
            if flag is False:
                self._running_tasks[tid] = "timeout"
                synthesize = True
            elif flag is None and spec.task_id == tid \
                    and self.task_manager.get_pending_spec(tid) is not None:
                self._pretimeout.add(tid)
        if synthesize:
            retry = self._handle_task_failure(spec, return_ids, err)
            if retry is not None:
                self._submit_retry(retry)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def defer_unref(self, object_id: ObjectID) -> None:
        self._unref_queue.append(object_id)
        self._unref_event.set()

    def _unref_loop(self) -> None:
        while self.alive:
            self._unref_event.wait(timeout=0.5)
            self._unref_event.clear()
            while self._unref_queue:
                try:
                    oid = self._unref_queue.popleft()
                except IndexError:
                    break
                try:
                    self.reference_counter.remove_local_reference(oid)
                except Exception:
                    logger.exception("unref failed for %s", oid)

    def free_objects(self, refs: Sequence[ObjectRef]) -> None:
        """Drop stored values WITHOUT touching reference counts — the
        analog of ray._private.internal_api.free (and of losing the
        objects to eviction/node death). A later get() reconstructs them
        from lineage if their producing tasks are still recoverable."""
        for r in refs:
            oid = r.object_id()
            self.object_recovery.note_freed(oid)
            self.memory_store.delete([oid])
            if self.shm_store is not None:
                self.shm_store.free_object(oid)
            self._free_remote_copy(oid)

    def _free_remote_copy(self, object_id: ObjectID) -> None:
        # EVERY copy frees — staged secondaries pin peer arenas too
        for node in self.gcs.object_locations_pop(object_id):
            pool = self._node_pools.get(node)
            if pool is not None and getattr(pool, "is_remote", False):
                pool.free_remote([object_id])

    def _on_object_out_of_scope(self, object_id: ObjectID) -> None:
        # Deferred batch free: __del__-driven releases arrive one at a
        # time (e.g. 50k refs dying after a batched get), and freeing
        # per object pays store/lineage lock acquisitions per oid. A
        # zero-refcount object can never regain references, so deferral
        # is safe; the size threshold plus drains at the API entry
        # points bound how long reclaim can lag.
        q = self._oos_q
        q.append(object_id)
        if len(q) >= 128 or (self.shm_store is not None
                             and self.shm_store.contains(object_id)) \
                or (self._has_remote_nodes
                    and self.gcs.object_location_get(object_id)
                    is not None):
            # arena-resident and REMOTE-resident objects are the
            # memory that matters — reclaim those immediately (a
            # remote copy pins another node's arena); only small
            # in-process entries ride the deferred batch. The GCS
            # location lookup is gated on a REMOTE pool existing:
            # single-node runs — thread OR process mode, the common
            # case and the bench — must not pay a GCS lock round trip
            # per dying ref
            self._drain_out_of_scope()

    def _drain_out_of_scope(self) -> None:
        q = self._oos_q
        if not q:
            return
        batch: List[ObjectID] = []
        while True:
            try:
                batch.append(q.popleft())
            except IndexError:
                break
        if not batch:
            return
        self.memory_store.delete(batch)
        if self.shm_store is not None:
            for oid in batch:
                self.shm_store.free_object(oid)
        for oid in batch:
            self._free_remote_copy(oid)
        self.task_manager.evict_lineage_batch(batch)

    def shutdown(self) -> None:
        self.alive = False
        with self._deadline_cv:
            self._deadline_cv.notify_all()  # release the watcher promptly
        if self.log_monitor is not None:
            # stop BEFORE the pools die: the final sweep re-emits any
            # trailing captured output while the files still matter
            self.log_monitor.stop()
        if self._gcs_log_handler is not None:
            import logging as _logging
            _logging.getLogger("ray_tpu_torch").removeHandler(
                self._gcs_log_handler)
            try:
                self._gcs_log_handler.close()
            except Exception:
                pass
            self._gcs_log_handler = None
        from ray_tpu_torch._private import log_plane
        if log_plane.get_session_log_dir() == self.session_log_dir:
            log_plane.set_session_log_dir(None)
        self._drain_out_of_scope()
        self.placement_groups.shutdown()
        with self._actors_lock:
            actors = list(self.actors.values())
        for rt in actors:
            try:
                rt.stop(no_restart=True)
            except Exception:
                pass
        self.scheduler.shutdown()
        self.gcs.shutdown()
        self.memory_monitor.shutdown()
        if self.metrics_server is not None:
            self.metrics_server.shutdown()
        if self.profile_plane is not None:
            self.profile_plane.shutdown()
        for pool in list(self._node_pools.values()) + self._dead_pools:
            pool.shutdown()
        self._dead_pools = []
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self.client_server is not None:
            self.client_server.shutdown()
        if self._head_server is not None:
            self._head_server.close()
        if runtime_sanitizer._ENABLED:
            # lock-witness diff + leak ledgers, while the refcount table
            # still distinguishes live objects from leaked segments
            runtime_sanitizer.report_at_shutdown(
                self.reference_counter.snapshot())
        if self.shm_store is not None:
            self.shm_store.shutdown()


def _top_level_deps(args, kwargs) -> List[ObjectID]:
    deps = [a.object_id() for a in args if isinstance(a, ObjectRef)]
    if kwargs:
        deps.extend(v.object_id() for v in kwargs.values()
                    if isinstance(v, ObjectRef))
    return deps


def _likely_large(value: Any) -> bool:
    """Cheap size probe deciding whether a put should try the shm path
    (avoids serializing every small put twice). Arrays/bytes report real
    sizes; other objects are assumed small and stay in the memory store.
    Only the shm store asks (thread mode stores every put by
    reference)."""
    import numpy as _np
    if isinstance(value, _np.ndarray):
        return value.nbytes > GLOBAL_CONFIG.inline_object_max_bytes
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value) > GLOBAL_CONFIG.inline_object_max_bytes
    t = type(value)
    if ((t.__module__ or "").split(".")[0] == "pyarrow"
            and hasattr(value, "nbytes")):
        # Arrow tables/arrays: data-plane blocks — workers must read
        # them zero-copy from the arena, not over the task pipe
        return value.nbytes > GLOBAL_CONFIG.inline_object_max_bytes
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        # a CUDA tensor counts its device bytes: serializing it copies
        # them to the host (see serialization.py)
        return (value.numel() * value.element_size()
                > GLOBAL_CONFIG.inline_object_max_bytes)
    return False


def _node_gpus(info: dict) -> float:
    """GPUs a daemon's node offers: those it declared, when its workers
    see the card (``gpu_access`` in its node info), else none."""
    if not info.get("gpu_access"):
        return 0.0
    return float(info.get("num_gpus", 0.0))


def _detect_gpu_count() -> float:
    """CUDA devices visible to this process, without creating a CUDA
    context: ``torch.cuda.device_count()`` asks the driver for the count
    and leaves torch's CUDA state uninitialised
    (``torch.cuda.is_initialized()`` stays False), so a CPU-only run never
    touches a card. 0 without a CUDA build."""
    import torch

    if not torch.backends.cuda.is_built():
        return 0.0
    return float(torch.cuda.device_count())


# runtime_env env_vars in THREAD mode share one process environment.
# Depth-counted apply/restore: concurrent env-bearing tasks may observe
# each other mid-flight (documented caveat), but completion always
# restores the TRUE pre-task value — naive save/restore interleaving
# would leak a task's value into the process forever.
_env_state_lock = threading.Lock()
_env_depth: Dict[str, Tuple[int, Optional[str]]] = {}


def env_vars_push(env_vars: Dict[str, str]) -> None:
    with _env_state_lock:
        for k, v in env_vars.items():
            depth, orig = _env_depth.get(k, (0, os.environ.get(k)))
            _env_depth[k] = (depth + 1, orig)
            os.environ[k] = v


def env_vars_pop(env_vars: Dict[str, str]) -> None:
    with _env_state_lock:
        for k in env_vars:
            entry = _env_depth.pop(k, None)
            if entry is None:
                continue
            depth, orig = entry
            if depth > 1:
                _env_depth[k] = (depth - 1, orig)
            elif orig is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = orig


def _async_raise_in_task(task_id: TaskID) -> None:
    """Best-effort forced cancellation in thread mode."""
    # thread-level force-kill is unsafe; cooperative cancellation only.
    logger.warning("force cancel requested for %s; thread workers support "
                   "cooperative cancellation only", task_id)


# ----------------------------------------------------------------------
# Module-level API used by ray_tpu_torch/__init__.py
# ----------------------------------------------------------------------

def init(num_cpus: Optional[float] = None, num_workers: Optional[int] = None,
         scheduler: Optional[str] = None, ignore_reinit_error: bool = False,
         resources: Optional[Dict[str, float]] = None,
         address: Optional[str] = None,
         log_to_driver: bool = True,
         _system_config: Optional[dict] = None, **kwargs) -> "Worker":
    global global_worker
    with _init_lock:
        if global_worker is not None and global_worker.alive:
            if ignore_reinit_error:
                return global_worker
            raise RuntimeError("ray_tpu_torch.init() called twice; pass "
                               "ignore_reinit_error=True to allow")
        if address is not None:
            if not address.startswith("ray://"):
                # the reference ignores such an address and starts a head
                # of its own; the port refuses rather than do that
                raise ValueError(
                    f"address {address!r}: init connects only as a client, "
                    "ray://host:port?key=...")
            # client mode: this process becomes a THIN CLIENT of a
            # running head (reference: ray client, python/ray/util/client)
            from ray_tpu_torch._private.client import (ClientWorker,
                                                       parse_client_address)
            host, port, key = parse_client_address(address)
            if key is None:
                raise ValueError(
                    "client address needs the head's key: use the "
                    "ray://host:port?key=... string of "
                    "Worker.enable_head_endpoint (client_server.address)")
            global_worker = ClientWorker(host, port, key)  # type: ignore
            return global_worker  # type: ignore[return-value]
        try:
            scheduler_factory = _configure(scheduler, _system_config)
        except BaseException:
            # a refused init leaves no setting behind for the next one
            GLOBAL_CONFIG.unfreeze()
            GLOBAL_CONFIG.reset()
            raise
        GLOBAL_CONFIG.freeze()
        global_worker = Worker(num_cpus=num_cpus, num_workers=num_workers,
                               scheduler_factory=scheduler_factory,
                               resources=resources,
                               log_to_driver=log_to_driver)
        if GLOBAL_CONFIG.gc_tuning:
            # see the config knob's docstring (including the freeze
            # caveat); shutdown() undoes both, restoring the HOST
            # program's thresholds, not CPython defaults
            import gc
            global _gc_tuned, _gc_saved_threshold
            _gc_saved_threshold = gc.get_threshold()
            gc.collect()
            gc.freeze()
            gc.set_threshold(20_000, 20, 20)
            _gc_tuned = True
        return global_worker


def _configure(scheduler: Optional[str],
               system_config: Optional[dict]) -> Optional[Callable]:
    """Apply init's ``_system_config``, refuse what the port cannot run,
    and return the scheduler factory (None = the event scheduler)."""
    if system_config:
        GLOBAL_CONFIG.unfreeze()
        GLOBAL_CONFIG.apply_system_config(system_config)
    _check_ported()
    # max_direct_call_object_size is the reference API's name for
    # inline_object_max_bytes: an override of the alias (env or
    # _system_config) flows into the real knob, unless the real
    # knob was itself overridden — then the specific name wins
    alias = GLOBAL_CONFIG.entry("max_direct_call_object_size")
    inline = GLOBAL_CONFIG.entry("inline_object_max_bytes")
    if alias.value != alias.default and inline.value == inline.default:
        inline.value = int(alias.value)
    # Two separate knobs (previously conflated): ``scheduler`` picks the
    # scheduler CLASS (tensor = device-array north star, the default;
    # event = per-event oracle); ``sched_backend`` picks the tensor
    # scheduler's assignment backend (auto|cuda|numpy).
    impl = scheduler or GLOBAL_CONFIG.scheduler
    if impl == "event":
        return None
    if impl != "tensor":
        raise ValueError(f"unknown scheduler {impl!r}: tensor | event")
    from ray_tpu_torch._private.scheduler.tensor import (
        TensorScheduler, check_device)
    check_device()  # raises before any thread starts
    return (lambda nodes, dispatch, contains:
            TensorScheduler(nodes, dispatch, contains))


def _check_ported() -> None:
    """Refuse, before anything starts, a config the port cannot run
    (an unknown worker mode, unparsable tenant quotas)."""
    if GLOBAL_CONFIG.worker_mode not in ("thread", "process"):
        raise ValueError(f"unknown worker_mode {GLOBAL_CONFIG.worker_mode!r}:"
                         " thread | process")
    if GLOBAL_CONFIG.qos:
        # bad quotas raise here, before any thread starts, rather than
        # running unfair
        from ray_tpu_torch._private.qos import parse_tenant_quotas
        parse_tenant_quotas(GLOBAL_CONFIG.tenant_quotas)


def shutdown() -> None:
    global global_worker, _gc_tuned
    with _init_lock:
        if global_worker is not None:
            global_worker.shutdown()
            global_worker = None
        if _gc_tuned:
            import gc
            gc.unfreeze()
            gc.set_threshold(*_gc_saved_threshold)
            _gc_tuned = False
        GLOBAL_CONFIG.unfreeze()
        # _system_config is scoped to one init/shutdown cycle; a leaked
        # worker_mode=process would silently re-route the next runtime
        GLOBAL_CONFIG.reset()
        # chaos schedules are scoped the same way: an armed plan must
        # not leak into the next runtime's fault decisions
        _chaos_controller().reset()


def is_initialized() -> bool:
    return global_worker is not None and global_worker.alive


def get_worker(auto_init: bool = True) -> Worker:
    if global_worker is None or not global_worker.alive:
        if not auto_init:
            raise RuntimeError("ray_tpu_torch.init() has not been called")
        init()
    return global_worker  # type: ignore

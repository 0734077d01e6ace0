"""Process worker pool — driver side of the multi-process node runtime.

Reference surfaces: ray src/ray/raylet/worker_pool.cc (WorkerPool:
prestarted worker processes, PopWorker/PushWorker), the dispatch half of
src/ray/raylet/local_task_manager.cc (a scheduler decision becomes a
lease grant to a worker process), and the owner side of
src/ray/core_worker/ (results stored under the owner's ids, borrower
bookkeeping for refs that cross the process boundary).

Data plane: small values cross the task pipe inline; large values go
through the node's shm arena (create/seal RPC, zero-copy reads) — the
plasma split. Control plane: one duplex pipe per worker for tasks + RPC,
a second for cancellation, and a pair of shared-memory rings per worker
for lease and completion envelopes (the pipe stays their doorbell and
fallback).

Remote nodes reuse it: ``RemoteNodePool`` (runtime/remote_pool.py)
subclasses the pool, with ``RemotePlaceholder`` results, adopted leases
and the failover hooks here, QoS preemption (``cancel_for_preemption``)
and the profile sampler's ``("prof", ...)`` frames included.
"""

from __future__ import annotations

import collections
import io
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from multiprocessing.connection import Listener
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

import cloudpickle

from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private import log_plane, spawn_env
from ray_tpu_torch._private.analysis import runtime_sanitizer
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private import trace_plane
from ray_tpu_torch._private.ids import ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.runtime.listener import (JOIN_TIMEOUT_S,
                                                     close_listener)
from ray_tpu_torch._private.runtime.shm_store import (
    RING_TAG_BYTE as _RING_TAG_BYTE, RING_TAGS as _RING_TAGS, ControlRing)
from ray_tpu_torch._private.runtime.worker_process import (
    AUTHKEY_ENV, PROFILE_HZ_ENV, _ShmValue, fn_id_of)
from ray_tpu_torch._private.scheduler.base import PendingTask
from ray_tpu_torch._private.serialization import (
    NONE_FRAMED, SerializedObject, decode_completion_envelope,
    deserialize, serialize)
from ray_tpu_torch._private.task_spec import (
    EMPTY_ARGS_BLOB, TaskSpec, encode_task_envelope)

logger = logging.getLogger(__name__)


class ShmPlaceholder:
    """Memory-store entry whose bytes live in the shm arena; resolved
    (deserialized zero-copy) on first driver-side access."""

    __slots__ = ()


class RemotePlaceholder:
    """Memory-store entry whose bytes live in a REMOTE node's arena
    (see runtime/remote_pool.py); the GCS object directory records
    which node. Resolved head-side by fetching on first access."""

    __slots__ = ("node_index",)

    def __init__(self, node_index: int):
        self.node_index = node_index


_PLACEHOLDER = ShmPlaceholder()

DIAL_BACKLOG = 1024


def auto_pipeline_depth(num_workers: int) -> int:
    """Lease-pipeline depth for a pool of num_workers processes: the
    configured value, or (auto) the worker/core oversubscription ratio
    capped at 8 — 1 on hosts with a core per worker."""
    depth = GLOBAL_CONFIG.worker_pipeline_depth
    if depth <= 0:
        depth = max(1, min(8, -(-num_workers // (os.cpu_count() or 1))))
    return depth


class _RefCollectPickler(cloudpickle.Pickler):
    """cloudpickle that records every ObjectRef crossing the boundary so
    the owner can register borrows (reference: ReferenceCounter borrower
    protocol, src/ray/core_worker/reference_count.cc)."""

    def __init__(self, file, contained: List[ObjectRef]):
        super().__init__(file, protocol=5)
        self._contained = contained

    def reducer_override(self, obj):
        if isinstance(obj, ObjectRef):
            self._contained.append(obj)
        return super().reducer_override(obj)


def _dumps_collect_refs(value: Any) -> Tuple[bytes, List[ObjectRef]]:
    contained: List[ObjectRef] = []
    f = io.BytesIO()
    _RefCollectPickler(f, contained).dump(value)
    return f.getvalue(), contained


class _InFlight:
    """One task leased onto a worker's pipe (the worker executes its
    pipe FIFO; several may be in flight per worker — the reference's
    lease pipelining, ray: NormalTaskSubmitter max_tasks_in_flight)."""

    __slots__ = ("pending", "return_ids", "borrows", "started_at")

    def __init__(self, pending: Optional[PendingTask],
                 return_ids: List[ObjectID]):
        # pending=None marks a SYNTHETIC entry: a lease adopted from a
        # rejoining daemon after head failover. The restarted head's
        # scheduler/task_manager never saw the task, so completion
        # handling for these stores results and frees the worker but
        # must skip every scheduler-side notification.
        self.pending = pending
        self.return_ids = return_ids
        self.borrows: Set[ObjectID] = set()
        self.started_at = time.monotonic()


class _Handle:
    __slots__ = ("worker_num", "proc", "conn", "ctrl", "worker_id", "pid",
                 "inflight", "borrows",
                 "sent_fns", "sent_hdrs", "dead", "force_cancel_id",
                 "timeout_cancel_id", "preempt_cancel_id",
                 "chaos_kill", "send_lock",
                 "ready", "actor_rt", "oom_kill", "log_paths",
                 "ring_in", "ring_out", "ring_region")

    def __init__(self, worker_num: int):
        self.actor_rt = None  # set for dedicated actor workers
        self.worker_num = worker_num
        self.proc: Optional[subprocess.Popen] = None
        self.conn = None
        self.ctrl = None
        self.worker_id = WorkerID.from_random()
        self.pid: Optional[int] = None
        # exec task_id -> _InFlight, in send (= execution) order
        self.inflight: "collections.OrderedDict[TaskID, _InFlight]" = \
            collections.OrderedDict()
        self.oom_kill = False         # memory monitor killed this worker
        self.borrows: Set[ObjectID] = set()  # actor-runtime bookkeeping
        self.sent_fns: Set[bytes] = set()
        # lease-envelope header dedupe: (fn_id, name, num_returns) ->
        # small int id the worker caches the pickled header under
        self.sent_hdrs: Dict[tuple, int] = {}
        # shm control rings (local pools with control_ring on): task
        # ring owner->worker, completion ring worker->owner, plus the
        # (offset, nbytes) pairs to hand back to the arena free list
        self.ring_in: Optional[ControlRing] = None
        self.ring_out: Optional[ControlRing] = None
        self.ring_region: Optional[Tuple[Tuple[int, int], ...]] = None
        self.dead = False
        self.force_cancel_id: Optional[TaskID] = None
        # deadline enforcement killed this worker for this task: the
        # target fails with TaskTimeoutError (retriable), not cancelled
        self.timeout_cancel_id: Optional[TaskID] = None
        # QoS preemption killed this worker for this task: the target
        # fails as a synthetic worker death (retriable WorkerCrashedError
        # carrying the preemption message), never cancelled
        self.preempt_cancel_id: Optional[TaskID] = None
        self.chaos_kill = False       # chaos plane SIGKILLed this worker
        self.send_lock = threading.Lock()
        self.ready = False
        # (out_path, err_path) of the capture files, when the session
        # log dir exists — used to attach a crash's .err tail
        self.log_paths: Optional[Tuple[str, str]] = None


class ProcessWorkerPool:
    is_remote = False
    # head_wall - node_wall at handshake; local pools share the head's
    # clock. RemoteNodePool overwrites this from the daemon's "clock"
    # message so worker execution windows land on the head's time axis.
    clock_offset = 0.0

    def __init__(self, worker, num_workers: int, shm_store,
                 node_index: int = 0):
        self._worker = worker
        self._shm = shm_store
        self.node_index = node_index   # scheduler row this pool serves
        self._node_dead = False        # node died: fail, don't respawn
        self._respawn_disabled = False  # machine gone: no self-heal
        self._lock = threading.Lock()
        self._idle: Deque[_Handle] = collections.deque()
        self._queue: Deque[Tuple[PendingTask, dict]] = collections.deque()
        self._handles: List[_Handle] = []
        # each worker's exit monitor, joined by shutdown()
        self._monitors: List[threading.Thread] = []
        self._actor_handles: List[_Handle] = []
        self._by_num: Dict[int, _Handle] = {}
        self._by_task: Dict[TaskID, _Handle] = {}
        self._shutdown = False
        self._worker_seq = 0
        self._inline_max = GLOBAL_CONFIG.inline_object_max_bytes
        # fault injection routes through the seeded controller, polled
        # PER TASK at payload build (the former per-pool snapshot of
        # testing_inject_task_failure_prob went stale immediately: a
        # probability set after pool construction was never observed)
        from ray_tpu_torch._private.chaos import get_controller
        self._chaos = get_controller()
        # shared-memory control ring (local pools only; remote pools
        # get the same batched-envelope trims over their framed daemon
        # link — the daemon decodes a bookkeeping copy — via
        # RemoteNodePool._assign_many's ("env", ...) path)
        self._ring_on = bool(GLOBAL_CONFIG.control_ring) \
            and not self.is_remote
        self._ring_slots = int(GLOBAL_CONFIG.control_ring_slots)
        self._ring_slot_bytes = int(GLOBAL_CONFIG.control_ring_slot_bytes)
        # control-plane counters exported as the
        # ray_tpu_control_ring_* metric families; plain ints bumped
        # under each handle's send lock (msgs/bytes/full_waits) or the
        # demux thread (drained completions), schema-stable zeros when
        # the ring is off
        self.ring_stats = {"msgs": 0, "bytes": 0, "fallback": 0,
                           "full_waits": 0}
        # per-reason spillback counters (LocalScheduler declines routed
        # through _rpc_submit); keyed by the daemon's reason string,
        # surfaced per node by state.list_nodes
        self.spill_reasons: Dict[str, int] = {}
        # pool-level pickle cache for envelope invariant headers
        self._hdr_blobs: Dict[tuple, bytes] = {}
        # lease pipelining (reference: NormalTaskSubmitter
        # max_tasks_in_flight_per_worker + ReportWorkerBacklog): several
        # tasks ride one worker pipe so a wakeup executes a batch. Depth
        # auto-scales with core oversubscription — on hosts with >= one
        # core per worker it stays 1 (pure spread, lowest latency); on
        # small hosts packing beats fake parallelism.
        self._pipeline_depth = auto_pipeline_depth(num_workers)
        # children exec `python -m ...worker_process` and dial back here
        # (reference: raylet execs default_worker.py; registration over a
        # unix socket) — never fork/spawn of this process, whose CUDA
        # context and threads are not fork-safe and whose __main__ must
        # not be re-run
        self._start_transport()
        for _ in range(num_workers):
            self._handles.append(self._spawn())

    def _start_transport(self) -> None:
        """Local transport: a unix socket the exec'd workers dial back
        to. ONE demux
        thread multiplexes every worker pipe (connection.wait) instead
        of a reader thread per worker: on small hosts the per-task
        thread ping-pong, not the pipe itself, is the dominant cost,
        and a single drain point lets completions batch into one
        scheduler wakeup (the reference's lease-return batching)."""
        import socket

        self._authkey = os.urandom(16)
        self._sock_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_pool_")
        # a deep backlog: every worker dials twice, and a burst of actor
        # processes coming up together overflows Listener's default of
        # 1 (an AF_UNIX dial past the backlog is refused, not queued)
        self._listener = Listener(
            address=os.path.join(self._sock_dir, "pool.sock"),
            family="AF_UNIX", authkey=self._authkey, backlog=DIAL_BACKLOG)
        self._demux_conns: Dict[Any, _Handle] = {}
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="ray_tpu_pool_accept")
        self._accept_thread.start()
        self._demux_thread = threading.Thread(
            target=self._demux_loop, daemon=True,
            name=f"ray_tpu_pool_demux_{self.node_index}")
        self._demux_thread.start()

    # ------------------------------------------------------------------
    # worker lifecycle
    # ------------------------------------------------------------------
    def _spawn(self) -> _Handle:
        with self._lock:
            self._worker_seq += 1
            num = self._worker_seq
        h = _Handle(num)
        with self._lock:
            self._by_num[num] = h
        # workers see the card only when worker_gpu_access is set: each
        # process that touches it makes a CUDA context of its own
        # (hundreds of MB of the card), and the driver holds one for the
        # scheduler already
        extra = {AUTHKEY_ENV: self._authkey.hex()}
        if GLOBAL_CONFIG.profile_hz > 0:
            # the owner may have been configured via _system_config (no
            # env var) — re-export so the fresh interpreter's GLOBAL_CONFIG
            # starts its profile sampler
            extra[PROFILE_HZ_ENV] = str(GLOBAL_CONFIG.profile_hz)
        log_dir = log_plane.get_session_log_dir()
        if log_dir:
            stem = f"worker-{h.worker_id.hex()[:12]}"
            log_env = log_plane.child_log_env(
                log_dir, stem, GLOBAL_CONFIG.log_rotation_bytes,
                GLOBAL_CONFIG.log_rotation_backups)
            h.log_paths = (log_env[log_plane.ENV_LOG_OUT],
                           log_env[log_plane.ENV_LOG_ERR])
            extra.update(log_env)
        env = spawn_env.child_env(
            use_accelerator=GLOBAL_CONFIG.worker_gpu_access, extra=extra)
        ring_arg = "-"
        if self._ring_on:
            ring_arg = self._alloc_rings(h)
        h.proc = subprocess.Popen(
            [sys.executable, "-m",
             "ray_tpu_torch._private.runtime.worker_process",
             self._listener.address, self._shm.arena.name,
             str(self._inline_max), str(num), ring_arg],
            env=env, close_fds=True)
        h.pid = h.proc.pid
        monitor = threading.Thread(target=self._monitor_proc, args=(h,),
                                   daemon=True,
                                   name=f"ray_tpu_pool_monitor_{num}")
        with self._lock:
            self._monitors.append(monitor)
        monitor.start()
        return h

    def _alloc_rings(self, h: _Handle) -> str:
        """Carve this worker's pair of control rings out of the shm
        arena; returns the geometry argv token the child attaches with
        ("-" = no rings, pipe-only — e.g. the arena has no room)."""
        from ray_tpu_torch._private.object_store import ObjectStoreFullError

        arena = self._shm.arena
        nslots, sbytes = self._ring_slots, self._ring_slot_bytes
        rb = ControlRing.region_bytes(nslots, sbytes)
        try:
            off_in = arena.allocate(rb)
        except ObjectStoreFullError:
            return "-"
        try:
            off_out = arena.allocate(rb)
        except ObjectStoreFullError:
            arena.free(off_in, rb)
            return "-"
        h.ring_in = ControlRing(arena, off_in, nslots, sbytes, create=True)
        h.ring_out = ControlRing(arena, off_out, nslots, sbytes, create=True)
        h.ring_region = ((off_in, rb), (off_out, rb))
        return f"{off_in}:{off_out}:{nslots}:{sbytes}"

    def _free_rings(self, h: _Handle) -> None:
        """Return a dead/released worker's ring regions to the arena.
        Detach under the send lock so a racing producer (executor
        thread) or the demux drain never touches freed memory; a
        respawned replacement gets fresh zeroed rings."""
        with h.send_lock:
            rings = (h.ring_in, h.ring_out)
            region = h.ring_region
            h.ring_in = h.ring_out = h.ring_region = None
        for r in rings:
            if r is not None:
                r.close()
        if region is not None:
            for off, rb in region:
                try:
                    self._shm.arena.free(off, rb)
                except Exception:
                    pass  # arena already shut down

    def _monitor_proc(self, h: _Handle) -> None:
        h.proc.wait()
        self._on_worker_failure(h, f"exit code {h.proc.returncode}")

    @staticmethod
    def _err_tail(h: _Handle) -> str:
        """Last lines of the dead worker's .err capture — the actual
        crash traceback — appended to WorkerCrashedError messages so
        the real cause surfaces instead of just "worker died"."""
        if h.log_paths is None:
            return ""
        return log_plane.err_tail_message(h.log_paths[1])

    def _death_cause(self, h: _Handle, cause) -> str:
        """An actor worker's death cause for its ActorDiedError: the
        exit code where the pipe closed before the monitor saw the
        process end, and the tail of its .err capture."""
        if cause is None and h.proc is not None:
            try:
                h.proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                pass
            else:
                cause = f"exit code {h.proc.returncode}"
        return f"{cause}{self._err_tail(h)}"

    def _accept_loop(self) -> None:
        from multiprocessing import AuthenticationError

        while not self._shutdown:
            try:
                conn = self._listener.accept()
            except AuthenticationError:
                continue  # a stale/foreign dialer must not kill accepts
            except (OSError, EOFError):
                return
            try:
                hello = conn.recv()
            except (EOFError, OSError):
                conn.close()
                continue
            from ray_tpu_torch._private import protocol

            ver, fields = protocol.split_any_hello(hello)
            if len(fields) != 2:
                conn.close()
                continue
            if ver != protocol.PROTOCOL_VERSION:
                try:
                    conn.send(protocol.mismatch_error("worker pool", ver))
                except (OSError, ValueError):
                    pass
                conn.close()
                continue
            num, kind = fields
            with self._lock:
                h = self._by_num.get(num)
            if h is None or h.dead:
                conn.close()
                continue
            if kind == "task":
                h.conn = conn
                self._demux_conns[conn] = h
                try:
                    self._wake_w.send(b"w")
                except OSError:
                    pass
            else:
                h.ctrl = conn

    def pids(self) -> List[int]:
        with self._lock:
            return [h.pid for h in self._handles if h.pid is not None]

    def live_process_count(self) -> int:
        """Workers whose OS process is still running (health checks)."""
        with self._lock:
            handles = list(self._handles) + list(self._actor_handles)
        n = 0
        for h in handles:
            if h.proc is not None and h.proc.poll() is None:
                n += 1
        return n

    def simulate_machine_death(self) -> None:
        """Chaos helper: the machine is gone — workers die and the pool
        cannot self-heal (a lone worker crash respawns a replacement; a
        dead machine cannot). The control plane is NOT told; the GCS
        health checker must detect it."""
        self._respawn_disabled = True
        with self._lock:
            handles = list(self._handles) + list(self._actor_handles)
        for h in handles:
            self._kill_handle(h)

    def fail_node(self, reason: str) -> None:
        """The node this pool backs died: fail queued work retriably, kill
        every worker process, and stop respawning replacements (the
        monitors' _on_worker_failure handles each running task). Actor
        workers get killed too; their runtimes observe _on_process_died
        and restart on another node or go DEAD."""
        with self._lock:
            if self._node_dead:
                return
            self._node_dead = True
            queued = list(self._queue)
            self._queue.clear()
            handles = list(self._handles) + list(self._actor_handles)
        for pending, payload in queued:
            spec = pending.spec
            return_ids = [ObjectID(b) for b in payload["return_ids"]]
            exc = rex.NodeDiedError(
                f"node died before task {spec.name} started: {reason}")
            retry = self._worker._handle_task_failure(spec, return_ids, exc)
            self._finish_task(pending, spec.task_id, retry)
        for h in handles:
            self._kill_handle(h)
            if h.actor_rt is not None:
                # a REMOTE pool has no per-process monitor to observe
                # that kill — the daemon that would report worker_died
                # died with the node — so synthesize the failure here
                # or the actor runtime never learns its process is
                # gone (no restart, in-flight rounds hang). Idempotent
                # under _on_worker_failure's was_dead guard, so the
                # local-pool monitor double-firing is harmless.
                self._on_worker_failure(h, rex.NodeDiedError(
                    f"node died: {reason}"))

    def _kill_handle(self, h: _Handle) -> None:
        """SIGKILL the worker behind a handle (remote pools route this
        through the node daemon)."""
        if h.proc is not None:
            try:
                h.proc.kill()
            except Exception:
                pass

    # ------------------------------------------------------------------
    # dedicated actor workers (reference: every actor gets its own
    # worker process; GcsActorScheduler leases one at creation)
    # ------------------------------------------------------------------
    def spawn_actor_worker(self, actor_rt) -> _Handle:
        h = self._spawn()
        h.actor_rt = actor_rt
        with self._lock:
            self._actor_handles.append(h)
        return h

    def send_to(self, h: _Handle, msg: tuple) -> None:
        with h.send_lock:
            h.conn.send(msg)

    def release_actor_worker(self, h: _Handle, kill: bool = False) -> None:
        with self._lock:
            try:
                self._actor_handles.remove(h)
            except ValueError:
                pass
            h.dead = True
            self._by_num.pop(h.worker_num, None)
        if kill:
            self._kill_handle(h)
        elif h.conn is not None:
            try:
                with h.send_lock:
                    h.conn.send(("exit",))
            except (OSError, ValueError):
                pass

    # ------------------------------------------------------------------
    # submission (called from the driver's dispatch thread pool)
    # ------------------------------------------------------------------
    def run_task(self, pending: PendingTask) -> None:
        payload = self._prepare_payload(pending)
        if payload is None:
            return
        with self._lock:
            if self._shutdown:
                return
            h = self._pick_worker_locked()
            if h is None:
                self._queue.append((pending, payload))
                return
        self._assign(h, pending, payload)

    def run_task_batch(self, pendings: List[PendingTask]) -> None:
        """One tick's lease grants for this node in one pass: payloads
        build back to back, each worker receives ALL its tasks in a
        single pipe message (one wakeup, one preemption — the per-send
        context switch was the dominant cost of the one-at-a-time
        path on oversubscribed hosts)."""
        built: List[tuple] = []  # (pending, payload)
        for pending in pendings:
            payload = self._prepare_payload(pending)
            if payload is not None:
                built.append((pending, payload))
        if not built:
            return
        per_handle: Dict[_Handle, list] = {}
        provisional: Dict[_Handle, int] = {}
        with self._lock:
            if self._shutdown:
                return
            for pending, payload in built:
                # Picks within one batch must see each other: inflight
                # counts only update in _assign_many, so without the
                # provisional map every post-idle task would land on the
                # same "least-loaded" worker and blow the depth invariant.
                h = self._pick_worker_locked(provisional)
                if h is None:
                    self._queue.append((pending, payload))
                else:
                    per_handle.setdefault(h, []).append((pending, payload))
                    provisional[h] = provisional.get(h, 0) + 1
        for h, items in per_handle.items():
            self._assign_many(h, items)

    def _prepare_payload(self, pending: PendingTask) -> Optional[dict]:
        """run_task's build/error half: a payload ready to lease, or
        None if the task already resolved to an error/requeue."""
        spec = pending.spec
        exec_task_id = spec.task_id
        return_ids = (getattr(spec, "_retry_return_ids", None)
                      or spec.return_ids())
        if self._node_dead:
            exc = rex.NodeDiedError(
                f"task {spec.name} dispatched to a dead node")
            retry = self._worker._handle_task_failure(spec, return_ids, exc)
            self._finish_task(pending, exec_task_id, retry)
            return None
        try:
            return self._build_payload(spec, return_ids)[0]
        except _RequeueDeps as e:
            from ray_tpu_torch._private.worker import _top_level_deps

            self._worker.reference_counter.add_submitted_task_references(
                _top_level_deps(spec.args, spec.kwargs))
            self._finish_task(pending, exec_task_id,
                              PendingTask(spec=spec, deps=list(e.oids),
                                          execute=lambda t, n: None))
            return None
        except _DepError as e:
            self._worker._store_error(spec, return_ids, e.error)
            self._finish_task(pending, exec_task_id, None)
            return None
        except Exception as e:  # unserializable task
            self._worker._store_error(
                spec, return_ids,
                rex.TaskError(spec.name, e, "task serialization failed"))
            self._finish_task(pending, exec_task_id, None)
            return None

    def _assign_many(self, h: _Handle, items: List[tuple]) -> None:
        """Lease a run of tasks onto one worker with ONE pipe write."""
        if self._ring_on:
            self._assign_many_ring(h, items)
            return
        out = []
        for pending, payload in items:
            spec = pending.spec
            contained = payload.pop("_contained")
            inf = _InFlight(pending,
                            [ObjectID(b) for b in payload["return_ids"]])
            h.oom_kill = False
            for oid in contained:
                self._worker.reference_counter.add_borrower(oid, h.worker_id)
                inf.borrows.add(oid)
            with self._lock:
                h.inflight[spec.task_id] = inf
                self._by_task[spec.task_id] = h
            self._worker.events.record(spec.task_id, spec.name, "started",
                                       self.node_index)
            out.append(payload)
        for pending, _payload in items:
            if self._chaos_assign(h, pending.spec):
                return  # killed or dropped: inflight recovers retriably
        try:
            with h.send_lock:
                # fn-blob strip under the send lock (see _assign)
                for i, payload in enumerate(out):
                    if payload["fn_id"] in h.sent_fns:
                        out[i] = dict(payload, fn_blob=None)
                    else:
                        h.sent_fns.add(payload["fn_id"])
                h.conn.send(("tasks", out))
        except (OSError, ValueError) as e:
            self._on_worker_failure(h, e)

    def _assign_many_ring(self, h: _Handle, items: List[tuple]) -> None:
        """Envelope variant of _assign_many: the tick's leases for this
        worker pack into ONE struct-framed envelope on the shm ring
        (pipe doorbell after; framed pipe send as fallback).

        Tasks are grouped by invariant header first and all owner-side
        bookkeeping runs in that grouped order — the worker executes
        the envelope front to back, and the inflight FIFO must match
        execution order (a worker RPC's borrow attaches to the OLDEST
        inflight lease)."""
        groups: Dict[tuple, list] = {}
        for pending, payload in items:
            groups.setdefault(
                (payload["fn_id"], payload["name"],
                 payload["num_returns"]), []).append((pending, payload))
        infs = []
        for pairs in groups.values():
            for pending, payload in pairs:
                contained = payload.pop("_contained")
                inf = _InFlight(pending,
                                [ObjectID(b)
                                 for b in payload["return_ids"]])
                for oid in contained:
                    self._worker.reference_counter.add_borrower(
                        oid, h.worker_id)
                    inf.borrows.add(oid)
                infs.append((pending.spec.task_id, inf))
        h.oom_kill = False
        with self._lock:
            for tid, inf in infs:
                h.inflight[tid] = inf
                self._by_task[tid] = h
        self._worker.events.record_batch(
            [(p.spec.task_id, p.spec.name)
             for pairs in groups.values() for p, _ in pairs],
            "started", self.node_index)
        if self._chaos.armed():
            for pairs in groups.values():
                for pending, _payload in pairs:
                    if self._chaos_assign(h, pending.spec):
                        return  # killed/dropped: inflight recovers
        try:
            with h.send_lock:
                blob = encode_task_envelope(
                    [(key, [p for _, p in pairs])
                     for key, pairs in groups.items()],
                    h.sent_fns, h.sent_hdrs, self._hdr_blobs)
                self._ring_send(("env", blob), h)
        except (OSError, ValueError) as e:
            self._on_worker_failure(h, e)

    def _ring_send(self, msg: tuple, h: _Handle) -> None:
        """Ship one control message to the worker: ring slot + pipe
        doorbell when it fits, framed pipe message otherwise. Caller
        holds h.send_lock — the ring is strictly single-producer, and
        the doorbell-after-put ordering is what keeps ring traffic
        FIFO-consistent with everything else on the pipe."""
        ring = h.ring_in
        stats = self.ring_stats
        if ring is not None:
            data = _RING_TAG_BYTE[msg[0]] + msg[1]
            if len(data) <= ring.max_msg:
                if ring.try_put(data):
                    stats["msgs"] += 1
                    stats["bytes"] += len(data)
                    h.conn.send(("ring",))
                    return
                stats["full_waits"] += 1
        stats["fallback"] += 1
        h.conn.send(msg)

    def _pick_worker_locked(
            self, provisional: Optional[Dict["_Handle", int]] = None,
    ) -> Optional[_Handle]:
        """Lease target for one task: an IDLE worker first (true
        process concurrency — tasks that sleep or block must overlap),
        then, at depth > 1, the least-loaded busy worker with pipe room
        (the backlog pipelines instead of round-tripping the
        scheduler). `provisional` counts picks made earlier in the same
        batch that haven't reached the handles' inflight sets yet."""
        if self._idle:
            return self._idle.popleft()
        if self._pipeline_depth <= 1:
            return None
        # while a worker is still booting, QUEUE instead of pipelining
        # onto an already-busy sibling: its ready message parks it via
        # _mark_idle, which drains the queue — piling up early would
        # serialize a burst onto the first worker to come up (the
        # envelope transport made first-task latency shorter than
        # worker startup, so this window is routinely hit now)
        for h in self._handles:
            if not h.dead and not h.ready and h.actor_rt is None:
                return None
        best = None
        best_n = self._pipeline_depth
        for h in self._handles:
            if h.dead or not h.ready or h.actor_rt is not None:
                continue
            n = len(h.inflight)
            if provisional:
                n += provisional.get(h, 0)
            # n == 0 here means a FREE worker that simply hasn't been
            # re-parked in _idle yet (completion handling re-parks after
            # popping inflight) — it must win over piling a second task
            # onto a busy handle, or a burst submitted right as the
            # previous one completes serializes onto one process
            if n < best_n:
                best, best_n = h, n
                if n == 0:
                    break
        return best

    def _build_payload(self, spec: TaskSpec,
                       return_ids: List[ObjectID]) -> Tuple[dict, list]:
        if not spec.args and not spec.kwargs:
            # the dominant high-rate shape (fan-outs of no-arg tasks)
            # skips the pickler entirely; the shared constant also lets
            # the envelope encoder elide the blob by identity
            args_blob, contained = EMPTY_ARGS_BLOB, []
        else:
            args = tuple(self._resolve_for_ship(a) for a in spec.args)
            kwargs = {k: self._resolve_for_ship(v)
                      for k, v in spec.kwargs.items()}
            args_blob, contained = _dumps_collect_refs((args, kwargs))
        fn_blob = spec.serialized_func
        fn_id = spec.func_id
        if fn_blob is None:
            fn_blob = cloudpickle.dumps(spec.func)
            fn_id = fn_id_of(fn_blob)
        elif fn_id is None:
            # specs built from retained lease records (failover / node
            # loss resubmits) carry the original blob but no cached id;
            # a None id would collide every such fn in the per-worker
            # fn_cache and the sent_fns dedupe, executing the WRONG
            # function body under this task's name
            fn_id = fn_id_of(fn_blob)
        payload = dict(
            task_id=spec.task_id.binary(),
            name=spec.name,
            fn_id=fn_id,
            fn_blob=fn_blob,
            args_blob=args_blob,
            num_returns=spec.num_returns,
            return_ids=[o.binary() for o in return_ids],
            # attempt token: daemons echo it in rejoin reports so a head
            # restarted mid-run can tell a live lease from a stale replay
            # of an attempt it already resubmitted (failover exactly-once)
            attempt=spec.attempt_number,
        )
        tctx = getattr(spec, "trace_ctx", None)
        if tctx is not None and tctx[3]:
            # trace context rides the payload dict (no new wire tag);
            # the worker restores it around exec so nested submissions
            # inherit parentage
            payload["trace"] = tctx
            if GLOBAL_CONFIG.trace_log_markers:
                payload["trace_mark"] = True
        fault = self._chaos.poll("task", node=self.node_index,
                                 task=spec.name)
        if fault is not None:
            payload["inject_fault"] = fault["kind"]
            if fault["kind"] == "hang":
                payload["inject_hang_s"] = fault.get("hang_s", 0.2)
        if spec.placement_group_id is not None \
                and spec.placement_group_capture_child_tasks:
            # capture context crosses the process boundary so nested
            # .remote() calls inherit the group (thread mode uses a
            # contextvar in Worker._execute_task)
            payload["pg"] = spec.placement_group_id.binary()
        env_vars = (spec.runtime_env or {}).get("env_vars") or {}
        if env_vars:
            payload["env_vars"] = dict(env_vars)
        renv = spec.runtime_env or {}
        if renv.get("working_dir_pkg"):
            payload["working_dir_pkg"] = renv["working_dir_pkg"]
        if renv.get("pip"):
            payload["pip"] = list(renv["pip"])
        payload["_contained"] = [r.object_id() for r in contained]
        return payload, contained

    def _resolve_for_ship(self, v: Any) -> Any:
        """Top-level ObjectRef -> value (small) or _ShmValue (large)."""
        if not isinstance(v, ObjectRef):
            return v
        oid = v.object_id()
        loc = self._shm.locate(oid)
        if loc is not None:
            return _ShmValue(*loc)
        entry = self._worker.memory_store.get_entry(oid)
        if entry is None:
            # lost since scheduling: reconstruct from lineage; the task
            # re-queues behind the recovery instead of failing
            if self._worker.object_recovery.maybe_recover(oid):
                raise _RequeueDeps([oid])
            entry = self._worker.memory_store.get_entry(oid)
        if entry is None:
            raise _DepError(rex.ObjectLostError(oid.hex()))
        if entry.is_exception:
            raise _DepError(entry.value)
        if isinstance(entry.value, (ShmPlaceholder, RemotePlaceholder)):
            # not in this node's arena: SPILLED to disk (restore) or
            # resident on a remote node (head-mediated fetch) — either
            # way _entry_value materializes it to ship by value
            return self._worker._entry_value(oid, entry)
        return entry.value

    def _chaos_assign(self, h: _Handle, spec: TaskSpec) -> bool:
        """Chaos sites on the lease path: ``worker`` (SIGKILL the
        assigned worker; everything inflight on it fails retriably) and
        ``link`` (delay or drop the dispatch message). True = the
        message must not be sent."""
        fault = self._chaos.poll("worker", node=self.node_index,
                                 task=spec.name)
        if fault is not None:
            h.chaos_kill = True
            self._kill_handle(h)
            return True
        fault = self._chaos.poll("link", node=self.node_index,
                                 task=spec.name)
        if fault is not None:
            if fault["kind"] == "drop":
                # message lost on the wire: the lease hangs until a
                # deadline or node-death path recovers it
                return True
            time.sleep(fault.get("delay_s", 0.05))
        return False

    def _assign(self, h: _Handle, pending: PendingTask, payload: dict) -> None:
        if self._ring_on:
            # singles ride the same envelope/ring path as batches: one
            # transport, one set of dedupe caches, one wire schema
            self._assign_many_ring(h, [(pending, payload)])
            return
        spec = pending.spec
        contained = payload.pop("_contained")
        inf = _InFlight(pending, [ObjectID(b) for b in payload["return_ids"]])
        h.oom_kill = False   # stale flag must not mislabel later deaths
        # register borrows for refs crossing into the worker BEFORE the
        # task can observe them
        for oid in contained:
            self._worker.reference_counter.add_borrower(oid, h.worker_id)
            inf.borrows.add(oid)
        with self._lock:
            h.inflight[spec.task_id] = inf
            self._by_task[spec.task_id] = h
        self._worker.events.record(spec.task_id, spec.name, "started",
                                   self.node_index)
        if self._chaos_assign(h, spec):
            return
        try:
            # fn-blob strip decided under the SEND lock: sends to one
            # handle serialize here, so check-then-strip cannot race a
            # concurrent sender into shipping fn_blob=None first
            with h.send_lock:
                if payload["fn_id"] in h.sent_fns:
                    payload = dict(payload, fn_blob=None)
                else:
                    h.sent_fns.add(payload["fn_id"])
                h.conn.send(("task", payload))
        except (OSError, ValueError) as e:
            self._on_worker_failure(h, e)

    # ------------------------------------------------------------------
    # reader: completions + worker-initiated RPC
    # ------------------------------------------------------------------
    def _demux_loop(self) -> None:
        """Single reader over all worker pipes. Completions found in one
        wait cycle batch into one result-store pass + one scheduler
        wakeup. Blocking worker RPCs (get/wait) jump to their own
        thread — a worker issuing one is itself blocked, so per-worker
        ordering holds; everything else is handled inline."""
        from multiprocessing.connection import wait as _conn_wait

        while not self._shutdown:
            conns = list(self._demux_conns)
            try:
                ready = _conn_wait([self._wake_r] + conns, timeout=0.5)
            except OSError:
                ready = []  # a conn died under wait; next pass drops it
            dones: List[tuple] = []
            for c in ready:
                if c is self._wake_r:
                    try:
                        self._wake_r.recv(4096)
                    except (BlockingIOError, OSError):
                        pass
                    continue
                h = self._demux_conns.get(c)
                if h is None:
                    continue
                while True:
                    try:
                        msg = c.recv()
                    except (EOFError, OSError):
                        self._demux_conns.pop(c, None)
                        self._on_worker_failure(h, None)
                        break
                    runtime_sanitizer.check_wire("worker_to_owner", msg)
                    kind = msg[0]
                    if kind == "many":
                        # a worker's buffered batch completions; the
                        # dominant shape is all-"done" 4-tuples, which
                        # extracts in ONE batched pass (the former
                        # per-sub tail probe with its repeated length
                        # guards was measurable at high completion
                        # rates) — anything mixed takes the slow path
                        subs = msg[1]
                        if h.actor_rt is None and all(
                                s[0] == "done" and len(s) == 4
                                for s in subs):
                            dones.extend(
                                (h, TaskID(s[1]), s[2], s[3])
                                for s in subs)
                        else:
                            for sub in subs:
                                if sub[0] == "done" \
                                        and h.actor_rt is None:
                                    dones.append(
                                        (h, TaskID(sub[1]), sub[2],
                                         sub[3] if len(sub) > 3
                                         else None))
                                else:
                                    dones = self._flush_dones_safe(dones)
                                    self._handle_worker_msg(h, sub)
                    elif kind == "done" and h.actor_rt is None:
                        dones.append((h, TaskID(msg[1]), msg[2],
                                      msg[3] if len(msg) > 3 else None))
                    elif kind == "cring":
                        # completion-ring doorbell: drain the worker's
                        # shm ring (envelopes decode outside any lock)
                        dones = self._drain_comp_ring(h, dones)
                    else:
                        # per-worker message order is a protocol
                        # invariant (e.g. an rpc_put's borrow attaches
                        # to the OLDEST inflight lease): flush buffered
                        # completions before any other message
                        dones = self._flush_dones_safe(dones)
                        if kind == "rpc" and msg[2] in ("get", "wait"):
                            threading.Thread(
                                target=self._handle_worker_msg,
                                args=(h, msg), daemon=True,
                                name=f"ray_tpu_pool_rpc_w{h.worker_num}"
                            ).start()
                        else:
                            self._handle_worker_msg(h, msg)
                    try:
                        if not c.poll(0):
                            break
                    except (OSError, ValueError):
                        break
            self._flush_dones_safe(dones)

    def _flush_dones_safe(self, dones: List[tuple]) -> List[tuple]:
        """Process buffered completions; the demux thread must survive
        any single bad completion (a dead demux hangs the whole pool)."""
        if dones:
            try:
                self._on_done_batch(dones)
            except Exception:
                logger.exception("batched completion handling failed")
        return []

    def _drain_comp_ring(self, h: _Handle,
                         dones: List[tuple]) -> List[tuple]:
        """Pop every envelope off one worker's completion ring. The
        byte copies happen under the handle's send lock (so _free_rings
        can never pull the region out from under us); decode and
        completion handling run unlocked."""
        with h.send_lock:
            ring = h.ring_out
            msgs = ring.drain() if ring is not None else ()
        if msgs:
            stats = self.ring_stats
            stats["msgs"] += len(msgs)
            stats["bytes"] += sum(len(m) for m in msgs)
        for data in msgs:
            tag = _RING_TAGS.get(data[0])
            if tag is None:
                logger.error("unknown ring tag %d from worker %d",
                             data[0], h.worker_num)
                continue
            msg = (tag, bytes(memoryview(data)[1:]))
            runtime_sanitizer.check_wire("worker_to_owner", msg)
            dones = self._handle_ring_msg(h, msg, dones)
        return dones

    def _handle_ring_msg(self, h: _Handle, msg: tuple,
                         dones: List[tuple]) -> List[tuple]:
        """Dispatch one reconstructed ring message (same tag/arity
        discipline as the pipe: raylint's wire pass checks this handler
        against the ring send sites)."""
        kind = msg[0]
        if kind == "cenv":
            for item in decode_completion_envelope(msg[1]):
                if item[0] == "done" and h.actor_rt is None:
                    dones.append((h, TaskID(item[1]), item[2], item[3]))
                else:
                    # errors keep the completions-before-anything-else
                    # ordering invariant, exactly like the pipe path
                    dones = self._flush_dones_safe(dones)
                    self._handle_worker_msg(h, item)
        return dones

    def _handle_worker_msg(self, h: _Handle, msg: tuple) -> None:
        """One worker->owner message (shared by the local per-worker
        reader threads and the remote node demux)."""
        kind = msg[0]
        try:
            if kind == "ready":
                h.pid = msg[1]
                h.ready = True
                if h.actor_rt is not None:
                    h.actor_rt._on_worker_ready(h)
                else:
                    self._mark_idle(h)
            elif kind == "done":
                if h.actor_rt is not None:
                    h.actor_rt._on_remote_done(
                        TaskID(msg[1]), msg[2],
                        msg[3] if len(msg) > 3 else None)
                else:
                    self._on_done(h, TaskID(msg[1]), msg[2],
                                  msg[3] if len(msg) > 3 else None)
            elif kind == "err":
                if h.actor_rt is not None:
                    h.actor_rt._on_remote_err(TaskID(msg[1]), msg[2],
                                              msg[3])
                else:
                    self._on_err(h, TaskID(msg[1]), msg[2], msg[3],
                                 msg[4] if len(msg) > 4 else None)
            elif kind == "rpc":
                self._on_rpc(h, msg[1], msg[2], msg[3])
            elif kind == "prof":
                # folded-stack batch from the worker's profile sampler;
                # shared branch covers local pipes AND daemon-forwarded
                # ("w", ...) reports from remote workers
                pp = getattr(self._worker, "profile_plane", None)
                if pp is not None:
                    pp.record_batch(self.node_index, msg[1])
        except Exception:
            logger.exception("pool reader failed handling %s", kind)

    def _mark_idle(self, h: _Handle) -> None:
        """Worker has pipe room: feed it from the queue or park it."""
        nxt = None
        with self._lock:
            if self._shutdown or h.dead:
                return
            if self._queue:
                nxt = self._queue.popleft()
            elif not h.inflight and h not in self._idle:
                self._idle.append(h)
        if nxt is not None:
            self._assign(h, *nxt)

    def _lease_done(self, task_id: TaskID) -> None:
        """Hook: a leased attempt reached a terminal state on this
        pool. RemoteNodePool journals it for failover reconciliation;
        local pools have nothing to reconcile."""

    def _take_inflight(self, h: _Handle, task_id: TaskID):
        """Claim a completion/error: pop the inflight entry AND the
        task index under the pool lock, so a concurrent
        _on_worker_failure (monitor/tick threads) can never
        double-handle the task as both completed and crashed. Returns
        None when someone else (force-cancel, failure path) already
        claimed it."""
        with self._lock:
            inf = h.inflight.pop(task_id, None)
            self._by_task.pop(task_id, None)
        return inf

    def _release_taken(self, h: _Handle, inf) -> None:
        """Post-claim half of _release for entries already popped by
        _take_inflight."""
        for oid in inf.borrows:
            self._worker.reference_counter.remove_borrower(
                oid, h.worker_id)
        self._mark_idle(h)

    def _store_entries(self, return_ids: List[ObjectID],
                       entries: list) -> List[ObjectID]:
        """Seal + register worker-produced result locations under the
        owner's ids (shm entries resolve lazily; inline deserialized).
        Returns the stored oids; the CALLER notifies the scheduler."""
        for oid, entry in zip(return_ids, entries):
            if entry[0] == "shm":
                self._shm.seal(oid)
                self._worker.memory_store.put(oid, _PLACEHOLDER)
            else:
                data = entry[1]
                if data == NONE_FRAMED:
                    # precomputed no-result frame: skip the pickler
                    self._worker.memory_store.put(oid, None)
                else:
                    value = deserialize(
                        SerializedObject.from_bytes(data))
                    self._worker.memory_store.put(oid, value)
        return return_ids

    def store_result_entries(self, return_ids: List[ObjectID],
                             entries: list) -> None:
        for oid in self._store_entries(return_ids, entries):
            self._worker.scheduler.notify_object_ready(oid)

    def _on_done(self, h: _Handle, task_id: TaskID, entries: list,
                 timing=None) -> None:
        inf = self._take_inflight(h, task_id)
        if inf is None:
            # force-cancel/worker-failure claimed the task first — or,
            # on a FENCED pool (node rejoined after being declared
            # dead), this is a dead-era lease's late completion: the
            # reconciler already resubmitted it, so the stale result is
            # dropped, never double-resolved
            if getattr(self, "_fenced", False):
                self._worker.note_two_level("orphan_fenced")
            return
        if inf.pending is None:
            # adopted lease (failover re-attach or node-local
            # dispatch): resolve the refs, free the worker. The trace
            # plane may hold a live record for it (local-dispatch
            # lane); unknown ids are a no-op pop there. Pin release
            # keeps the record as lineage — this is the REMOTE node's
            # completion path, and the returns may be the sole copy in
            # that node's arena
            self._worker.release_local_lease_pins(task_id.binary(),
                                                  keep_lineage=True)
            self.store_result_entries(inf.return_ids, entries)
            tp = self._worker.trace_plane
            if tp is not None:
                tp.record_finished_batch(
                    ((task_id, timing, h.worker_id.hex(),
                      self.node_index),), offset=self.clock_offset)
            self._lease_done(task_id)
            self._release_taken(h, inf)
            return
        pending, spec = inf.pending, inf.pending.spec
        self.store_result_entries(inf.return_ids, entries)
        self._worker.task_manager.complete(spec.task_id)
        te = self._worker.task_events
        if te is not None:
            te.record_finished_batch(
                ((task_id, timing, h.worker_id.hex(), self.node_index),),
                offset=self.clock_offset)
        tp = self._worker.trace_plane
        if tp is not None:
            tp.record_finished_batch(
                ((task_id, timing, h.worker_id.hex(), self.node_index),),
                offset=self.clock_offset)
        self._finish_task(pending, task_id, None)
        self._release_taken(h, inf)

    def _on_done_batch(self, dones: List[tuple]) -> None:
        """N completions -> one store pass, release/requeue per worker,
        then ONE scheduler wakeup (object-ready and task-finished
        events delivered together via notify_batch). The
        inflight entry is POPPED under the pool lock up front so a
        concurrent _on_worker_failure (monitor/tick threads) can never
        double-handle a task as both completed and crashed."""
        from ray_tpu_torch._private.worker import _top_level_deps

        ready_oids: List[ObjectID] = []
        finished: List[tuple] = []
        taken: List[tuple] = []
        events = self._worker.events
        te = self._worker.task_events
        tp = self._worker.trace_plane
        te_rows: List[tuple] = []
        with self._lock:
            for h, task_id, entries, timing in dones:
                inf = h.inflight.pop(task_id, None)
                if inf is None:
                    continue  # force-cancel/failure raced the completion
                self._by_task.pop(task_id, None)
                taken.append((h, task_id, entries, timing, inf))
        for h, task_id, entries, timing, inf in taken:
            self._lease_done(task_id)
            if inf.pending is None:
                # adopted lease (failover re-attach or node-local
                # dispatch): store results only (no spec, no
                # scheduler/task-manager state for this task here).
                # keep_lineage: the record becomes the lineage entry
                # that reconstructs sole-copy returns after node death
                self._worker.release_local_lease_pins(task_id.binary(),
                                                      keep_lineage=True)
                try:
                    ready_oids.extend(
                        self._store_entries(inf.return_ids, entries))
                    if tp is not None:
                        tp.record_finished_batch(
                            ((task_id, timing, h.worker_id.hex(),
                              self.node_index),),
                            offset=self.clock_offset)
                except Exception:
                    logger.exception("adopted-lease completion failed")
                continue
            spec = inf.pending.spec
            try:
                ready_oids.extend(
                    self._store_entries(inf.return_ids, entries))
                self._worker.task_manager.complete(spec.task_id)
                events.record(task_id, spec.name, "finished",
                              self.node_index)
                if te is not None or tp is not None:
                    te_rows.append((task_id, timing, h.worker_id.hex(),
                                    self.node_index))
                deps = _top_level_deps(spec.args, spec.kwargs)
                if deps:
                    self._worker.reference_counter \
                        .remove_submitted_task_references(deps)
            except Exception:
                logger.exception("completion handling failed for %s",
                                 spec.name)
            finished.append((task_id, inf.pending.node_index,
                             spec.resources))
        if te_rows:
            if te is not None:
                te.record_finished_batch(te_rows,
                                         offset=self.clock_offset)
            if tp is not None:
                tp.record_finished_batch(te_rows,
                                         offset=self.clock_offset)
        # park/refeed the workers BEFORE waking the scheduler: a driver
        # blocked in get() resumes the moment notify_batch lands, and if
        # it submits immediately the picker must already see these
        # workers as idle (the ring coalesces a whole burst into one
        # batch, so with notify first NO worker would be parked yet and
        # the next burst would pile onto a single handle)
        for h, task_id, _entries, _timing, inf in taken:
            for oid in inf.borrows:
                self._worker.reference_counter.remove_borrower(
                    oid, h.worker_id)
            self._mark_idle(h)
        self._worker.scheduler.notify_batch(ready_oids, finished)

    def _on_err(self, h: _Handle, task_id: TaskID, exc_blob: bytes,
                tb: str, timing=None) -> None:
        inf = self._take_inflight(h, task_id)
        if inf is None:
            # force-cancel/worker-failure claimed it first — or a
            # fenced pool dropping a dead-era lease's late error (see
            # _on_done)
            if getattr(self, "_fenced", False):
                self._worker.note_two_level("orphan_fenced")
            return
        if inf.pending is None:
            # adopted failover lease: no spec survives the restart, so
            # fail the refs terminally instead of consulting retry policy
            self._worker.release_local_lease_pins(task_id.binary())
            try:
                exc = cloudpickle.loads(exc_blob)
            except Exception:
                exc = RuntimeError(
                    "worker error (exception undeserializable)")
            exc._ray_tpu_traceback = tb
            for oid in inf.return_ids:
                self._worker.memory_store.put(oid, exc, is_exception=True)
                self._worker.scheduler.notify_object_ready(oid)
            tp = self._worker.trace_plane
            if tp is not None:
                tp.record_failed(task_id, type(exc).__name__)
            self._lease_done(task_id)
            self._release_taken(h, inf)
            return
        pending, spec = inf.pending, inf.pending.spec
        try:
            exc = cloudpickle.loads(exc_blob)
        except Exception:
            exc = RuntimeError("worker error (exception undeserializable)")
        exc._ray_tpu_traceback = tb
        te = self._worker.task_events
        if te is not None:
            # attach the execution window before the failure hooks
            # finalize (retry or terminal) this attempt's record
            te.record_exec(task_id, timing, node=self.node_index,
                           worker=h.worker_id.hex(),
                           offset=self.clock_offset)
        tp = self._worker.trace_plane
        if tp is not None:
            tp.record_exec(task_id, timing, node=self.node_index,
                           worker=h.worker_id.hex(),
                           offset=self.clock_offset)
        retry = self._worker._handle_task_failure(spec, inf.return_ids, exc)
        self._finish_task(pending, task_id, retry)
        self._release_taken(h, inf)

    def _finish_task(self, pending: PendingTask, exec_task_id: TaskID,
                     retry: Optional[PendingTask]) -> None:
        from ray_tpu_torch._private.worker import _top_level_deps

        spec = pending.spec
        self._worker.events.record(exec_task_id, spec.name, "finished",
                                   self.node_index)
        deps = _top_level_deps(spec.args, spec.kwargs)
        self._worker.reference_counter.remove_submitted_task_references(deps)
        self._worker.scheduler.notify_task_finished(
            exec_task_id, pending.node_index, spec.resources)
        if retry is not None:
            self._worker._submit_retry(retry)

    def _on_worker_failure(self, h: _Handle, cause) -> None:
        with self._lock:
            if h.dead:
                if h.actor_rt is not None:
                    pass  # released actor workers still notify their rt
                else:
                    return
            was_dead = h.dead
            h.dead = True
            self._by_num.pop(h.worker_num, None)
            try:
                self._idle.remove(h)
            except ValueError:
                pass
            shutting_down = self._shutdown
        if h.actor_rt is not None:
            self._free_rings(h)
            if not shutting_down and not was_dead:
                h.actor_rt._on_process_died(h, self._death_cause(h, cause))
            return
        with self._lock:
            inflight = list(h.inflight.items())
            h.inflight.clear()
        if inflight and not shutting_down:
            # every task leased onto this worker's pipe dies with it;
            # only the force-cancel TARGET gets the cancellation error,
            # innocent pipelined neighbors fail retriably
            for exec_id, inf in inflight:
                if inf.pending is None:
                    # adopted lease (locally dispatched or re-attached
                    # across head failover) with no spec to retry from.
                    # A LIVE daemon re-leases anything with attempts
                    # left itself (its local_retry report moved the
                    # entry off this handle first); whatever reaches
                    # here goes through the head-side orphan-lease
                    # reconciler, which resubmits under the original
                    # return oids when a retained record still carries
                    # attempts (whole-node death, no sibling slot) and
                    # fails the refs terminally otherwise
                    err = rex.WorkerCrashedError(
                        f"worker process {h.pid} died while running an "
                        f"adopted lease (locally dispatched with retries "
                        f"exhausted, or re-attached across head "
                        f"failover): {cause}" + self._err_tail(h))
                    self._worker.reconcile_orphan_lease(
                        exec_id.binary(),
                        [oid.binary() for oid in inf.return_ids], err)
                    self._lease_done(exec_id)
                    with self._lock:
                        self._by_task.pop(exec_id, None)
                    continue
                spec = inf.pending.spec
                if h.force_cancel_id == exec_id:
                    exc: BaseException = rex.TaskCancelledError(exec_id)
                elif h.timeout_cancel_id == exec_id:
                    exc = rex.TaskTimeoutError(
                        f"task {spec.name} exceeded its {spec.timeout_s}s "
                        f"deadline (worker {h.pid} killed)",
                        task_id=exec_id, timeout_s=spec.timeout_s)
                elif h.preempt_cancel_id == exec_id:
                    # synthetic worker death: retriable, so the victim
                    # re-queues with a bumped attempt under its original
                    # return ids — the QoS preemption contract
                    exc = rex.WorkerCrashedError(
                        f"task {spec.name} preempted by higher-tier work "
                        f"(worker {h.pid} killed); attempt will retry")
                elif h.oom_kill:
                    exc = rex.OutOfMemoryError(
                        f"worker killed by the memory monitor while "
                        f"running {spec.name} (host memory pressure)")
                elif self._node_dead:
                    exc = rex.NodeDiedError(
                        f"node died while running {spec.name}")
                elif h.chaos_kill:
                    exc = rex.WorkerCrashedError(
                        f"worker process {h.pid} killed while running "
                        f"{spec.name} (chaos worker kill)"
                        + self._err_tail(h))
                else:
                    exc = rex.WorkerCrashedError(
                        f"worker process {h.pid} died while running "
                        f"{spec.name}: {cause}" + self._err_tail(h))
                retry = self._worker._handle_task_failure(
                    spec, inf.return_ids, exc)
                self._finish_task(inf.pending, exec_id, retry)
                for oid in inf.borrows:
                    self._worker.reference_counter.remove_borrower(
                        oid, h.worker_id)
                with self._lock:
                    self._by_task.pop(exec_id, None)
        self._free_rings(h)
        if not shutting_down and not self._node_dead \
                and not self._respawn_disabled:
            # replacement worker keeps the pool at capacity (with its
            # own fresh rings — _spawn re-initializes the geometry)
            replacement = self._spawn()
            with self._lock:
                try:
                    self._handles[self._handles.index(h)] = replacement
                except ValueError:
                    self._handles.append(replacement)

    # ------------------------------------------------------------------
    # worker-initiated RPC (get/put/submit/create/wait from inside tasks)
    # ------------------------------------------------------------------
    def _on_rpc(self, h: _Handle, req_id: int, op: str, args: tuple) -> None:
        try:
            data = getattr(self, f"_rpc_{op}")(h, *args)
            ok = True
        except BaseException as e:  # noqa: BLE001
            ok, data = False, cloudpickle.dumps(e)
        with h.send_lock:
            h.conn.send(("reply", req_id, ok, data))

    def _rpc_create(self, h: _Handle, oid_bin: bytes, nbytes: int) -> int:
        return self._shm.create(ObjectID(oid_bin), nbytes)

    def _rpc_env_pkg(self, h: _Handle, pkg_hash: str) -> Optional[bytes]:
        """Content-addressed runtime_env package fetch (working_dir
        zips live in the GCS KV; workers cache extractions per node)."""
        from ray_tpu_torch._private import runtime_envs as rte

        return self._worker.gcs.kv_get(rte.kv_key(pkg_hash))

    def _task_borrows(self, h: _Handle) -> Set[ObjectID]:
        """Borrow set of the task EXECUTING on h right now (= oldest
        inflight lease; a worker only issues RPCs mid-execution). Falls
        back to the handle set (dedicated actor workers)."""
        with self._lock:
            if h.inflight:
                return next(iter(h.inflight.values())).borrows
        return h.borrows

    def _rpc_put(self, h: _Handle, oid_bin: bytes, loc: tuple) -> bool:
        oid = ObjectID(oid_bin)
        self._worker.reference_counter.add_owned_object(oid)
        # the worker holds the only handle: track it as a borrower until
        # the task completes (driver-side refs appear if the ref is
        # returned, which deserializes and registers locally first)
        self._worker.reference_counter.add_borrower(oid, h.worker_id)
        self._task_borrows(h).add(oid)
        if loc[0] == "shm":
            self._shm.seal(oid)
            self._worker.memory_store.put(oid, _PLACEHOLDER)
        else:
            value = deserialize(SerializedObject.from_bytes(loc[1]))
            self._worker.memory_store.put(oid, value)
        self._worker.scheduler.notify_object_ready(oid)
        return True

    def _rpc_get(self, h: _Handle, oid_bins: list,
                 timeout: Optional[float]) -> list:
        oids = [ObjectID(b) for b in oid_bins]
        try:
            entries = self._worker.memory_store.wait_and_get(oids, timeout)
        except TimeoutError as e:
            raise rex.GetTimeoutError(str(e)) from None
        out = []
        for oid, entry in zip(oids, entries):
            if entry.is_exception:
                out.append(("exc", cloudpickle.dumps(entry.value)))
                continue
            if isinstance(entry.value, RemotePlaceholder):
                # produced on a remote node: head-mediated pull, shipped
                # inline to this (local) worker
                data = self._worker.fetch_object_bytes(
                    oid, entry.value.node_index)
                if data is None:
                    out.append(("exc", cloudpickle.dumps(
                        rex.ObjectLostError(oid.hex()))))
                else:
                    out.append(("inline", data))
                continue
            loc = self._shm.locate(oid)
            if loc is not None:
                out.append(("shm", loc[0], loc[1]))
            elif isinstance(entry.value, ShmPlaceholder):
                # spilled: the file bytes ARE a framed SerializedObject —
                # ship them as-is instead of deserializing into driver
                # heap (pinning the value) and re-serializing
                sobj = self._shm.get_serialized(oid)
                if sobj is None:
                    out.append(("exc", cloudpickle.dumps(
                        rex.ObjectLostError(oid.hex()))))
                else:
                    out.append(("inline", sobj.to_bytes()))
            else:
                out.append(("inline", serialize(entry.value).to_bytes()))
        return out

    def _rpc_wait(self, h: _Handle, oid_bins: list, num_returns: int,
                  timeout: Optional[float]) -> list:
        oids = [ObjectID(b) for b in oid_bins]
        ready = self._worker.memory_store.wait(oids, num_returns, timeout)
        return [o.binary() for o in oids if o in ready]

    def _rpc_submit(self, h: _Handle, blob: bytes,
                    spilled=False) -> list:
        from ray_tpu_torch._private.ids import PlacementGroupID

        if spilled:
            # the node's LocalScheduler declined this nested submission:
            # upward spillback — the head stays placement authority.
            # `spilled` carries the daemon's reason string (queue_full /
            # pg / resources / refs / no_slot); per-reason counters ride
            # lazily-created "spillback:<reason>" keys so the base
            # stats schema is unchanged with reasons at zero
            reason = spilled if isinstance(spilled, str) else "other"
            self._worker.note_two_level("spillback")
            self._worker.note_two_level("spillback:" + reason)
            self.spill_reasons[reason] = \
                self.spill_reasons.get(reason, 0) + 1
            note = getattr(self._worker.scheduler, "note_spillback", None)
            if note is not None:
                note()
        d = cloudpickle.loads(blob)
        func = cloudpickle.loads(d["func_blob"])
        args, kwargs = cloudpickle.loads(d["args_blob"])
        spec = TaskSpec(
            task_id=self._worker.next_task_id(),
            name=d["name"],
            func=func,
            func_descriptor=d["func_descriptor"],
            args=args,
            kwargs=kwargs,
            num_returns=d["num_returns"],
            resources=d["resources"],
            max_retries=d["max_retries"],
            retry_exceptions=d["retry_exceptions"],
            placement_group_id=(PlacementGroupID(d["pg_id"])
                                if d.get("pg_id") is not None else None),
            placement_group_bundle_index=d.get("pg_bundle_index", -1),
            placement_group_capture_child_tasks=d.get("pg_capture", False),
            priority=int(d.get("priority") or 0),
            tenant=d.get("tenant") or "default",
        )
        # the submitting task's trace context rides the RPC blob: the
        # nested submission becomes its child via the ambient parent
        with trace_plane.parent_scope(d.get("trace")):
            refs = self._worker.submit_task(spec)
        borrows = self._task_borrows(h)
        for r in refs:
            self._worker.reference_counter.add_borrower(
                r.object_id(), h.worker_id)
            borrows.add(r.object_id())
        return [r.object_id().binary() for r in refs]

    def _rpc_actor_call(self, h: _Handle, blob: bytes,
                        meta: Optional[tuple] = None) -> list:
        """Actor method submitted from INSIDE a worker-process task
        (reference: core-worker actor task submission from any worker).
        Runs the normal head-side submission path; the caller's task
        borrows the return refs until it completes. ``meta`` is the
        p2p routing hint the node daemon intercepts — by the time the
        call reaches the head it has already chosen the head path, so
        the hint is ignored here."""
        from ray_tpu_torch._private.ids import ActorID
        from ray_tpu_torch.actor import ActorHandle

        t = cloudpickle.loads(blob)
        aid_bin, method, args, kwargs, num_returns = t[:5]
        tctx = t[5] if len(t) > 5 else None
        handle = ActorHandle(ActorID(aid_bin))
        with trace_plane.parent_scope(tctx):
            out = getattr(handle, method).options(
                num_returns=num_returns).remote(*args, **kwargs)
        refs = out if isinstance(out, list) else [out]
        borrows = self._task_borrows(h)
        for r in refs:
            self._worker.reference_counter.add_borrower(
                r.object_id(), h.worker_id)
            borrows.add(r.object_id())
        return [r.object_id().binary() for r in refs]

    # ------------------------------------------------------------------
    # cancellation
    # ------------------------------------------------------------------
    def cancel(self, task_id: TaskID, force: bool) -> bool:
        # not yet leased to a worker: drop it from the pool queue and
        # resolve its return refs with the cancellation error
        with self._lock:
            for item in self._queue:
                if item[0].spec.task_id == task_id:
                    self._queue.remove(item)
                    queued = item[0]
                    break
            else:
                queued = None
        if queued is not None:
            spec = queued.spec
            err = rex.TaskCancelledError(task_id)
            return_ids = (getattr(spec, "_retry_return_ids", None)
                          or spec.return_ids())
            self._worker._store_error(spec, return_ids, err)
            self._finish_task(queued, task_id, None)
            return True
        with self._lock:
            h = self._by_task.get(task_id)
        if h is None:
            return False
        if force:
            h.force_cancel_id = task_id
            self._kill_handle(h)
        elif h.ctrl is not None:
            try:
                h.ctrl.send(("cancel", task_id.binary()))
            except (OSError, ValueError):
                pass
        return True

    def cancel_for_timeout(self, task_id: TaskID) -> bool:
        """Deadline enforcement: fail the attempt with a retriable
        TaskTimeoutError — cancel()'s force path with a different
        classification (the timeout counts against max_retries instead
        of resolving the refs as cancelled)."""
        with self._lock:
            for item in self._queue:
                if item[0].spec.task_id == task_id:
                    self._queue.remove(item)
                    queued = item[0]
                    break
            else:
                queued = None
        if queued is not None:
            spec = queued.spec
            return_ids = (getattr(spec, "_retry_return_ids", None)
                          or spec.return_ids())
            err = rex.TaskTimeoutError(
                f"task {spec.name} timed out after {spec.timeout_s}s "
                f"queued on node {self.node_index}",
                task_id=task_id, timeout_s=spec.timeout_s)
            retry = self._worker._handle_task_failure(spec, return_ids, err)
            self._finish_task(queued, task_id, retry)
            return True
        with self._lock:
            h = self._by_task.get(task_id)
        if h is None:
            return False
        h.timeout_cancel_id = task_id
        self._kill_handle(h)
        return True

    def cancel_for_preemption(self, task_id: TaskID) -> bool:
        """QoS preemption (config.qos): fail the attempt as a synthetic
        worker death — cancel_for_timeout's shape with a retriable
        WorkerCrashedError classification, so the victim re-queues with
        a bumped attempt under its original return ids and the
        journaled-lease dedup guarantees exactly-once effects."""
        with self._lock:
            for item in self._queue:
                if item[0].spec.task_id == task_id:
                    self._queue.remove(item)
                    queued = item[0]
                    break
            else:
                queued = None
        if queued is not None:
            spec = queued.spec
            return_ids = (getattr(spec, "_retry_return_ids", None)
                          or spec.return_ids())
            err = rex.WorkerCrashedError(
                f"task {spec.name} preempted by higher-tier work while "
                f"queued on node {self.node_index}; attempt will retry")
            retry = self._worker._handle_task_failure(spec, return_ids, err)
            self._finish_task(queued, task_id, retry)
            return True
        with self._lock:
            h = self._by_task.get(task_id)
        if h is None:
            return False
        h.preempt_cancel_id = task_id
        self._kill_handle(h)
        return True

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            handles = list(self._handles) + list(self._actor_handles)
            self._queue.clear()
            self._idle.clear()
        for h in handles:
            if h.conn is not None:
                try:
                    with h.send_lock:
                        h.conn.send(("exit",))
                except (OSError, ValueError):
                    pass
        for h in handles:
            if h.proc is not None:
                try:
                    h.proc.wait(timeout=1.0)
                except subprocess.TimeoutExpired:
                    h.proc.kill()
                    try:
                        h.proc.wait(timeout=JOIN_TIMEOUT_S)
                    except subprocess.TimeoutExpired:
                        pass
        for h in handles:
            self._free_rings(h)
            for c in (h.conn, h.ctrl):
                if c is not None:
                    try:
                        c.close()
                    except Exception:
                        pass
        close_listener(self._listener, self._accept_thread)
        try:
            self._wake_w.send(b"q")  # unblock the demux wait promptly
        except OSError:
            pass
        # the demux loop sees _shutdown at its wake, and each monitor
        # returns once its process is reaped: no pool thread outlives
        # shutdown()
        me = threading.current_thread()
        with self._lock:
            threads = [self._demux_thread, *self._monitors]
        for t in threads:
            if t is not me:
                t.join(JOIN_TIMEOUT_S)
        try:
            os.rmdir(self._sock_dir)
        except OSError:
            pass


class _DepError(Exception):
    def __init__(self, error: BaseException):
        self.error = error


class _RequeueDeps(Exception):
    """Deps lost but reconstructing: re-queue the task behind them."""

    def __init__(self, oids):
        self.oids = oids

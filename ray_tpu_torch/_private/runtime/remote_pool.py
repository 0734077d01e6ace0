"""Head-side runtime for remote (off-head) nodes.

Reference surfaces: the head's view of a remote raylet — ray
src/ray/raylet_client/ (lease/cancel RPCs to a node), the object
manager's cross-node half (src/ray/object_manager/: Pull/Push of object
chunks between nodes), and the GCS object directory
(src/ray/object_manager/ownership_object_directory.cc) that maps objects
to the nodes holding their primary copy.

``RemoteNodePool`` subclasses ProcessWorkerPool so every owner-side
protocol (lease grants, retries, borrower bookkeeping, the whole actor
message protocol) is byte-identical for local and remote nodes; only
the transport differs. Worker pipes become proxy sends over the single
head<->daemon connection; a demux thread fans incoming daemon traffic
out to per-worker queues (preserving per-worker message order, exactly
like the local per-worker reader threads). Object movement:

  - task results stay in the PRODUCING node's arena; the head stores a
    ``RemotePlaceholder`` and records the location in the GCS object
    directory (bytes cross the wire only on first cross-node use);
  - a dep already resident on the target node ships as a ``_PullValue``
    marker the worker resolves from its local arena zero-copy;
  - a dep living on the head (or a third node) is embedded in the task
    payload — fetched head-side first if needed (head-mediated
    transfer; the reference does node-to-node pushes, which this
    protocol admits later by handing the daemon a peer address instead
    of inline bytes);
  - daemon connection loss IS node-failure detection (the DCN story:
    a dead TCP link marks the node dead, like the reference's
    health-check RPC timeouts).
"""

from __future__ import annotations

import logging
import os
import queue
import subprocess
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from multiprocessing.connection import Listener
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private.analysis import runtime_sanitizer
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.runtime.listener import close_listener
from ray_tpu_torch._private.runtime.process_pool import (_DepError, _Handle,
                                                   _InFlight, _RequeueDeps,
                                                   ProcessWorkerPool,
                                                   RemotePlaceholder)
from ray_tpu_torch._private.runtime.worker_process import _PullValue
from ray_tpu_torch._private.serialization import serialize

logger = logging.getLogger(__name__)


class _ProxyConn:
    """Send-only facade standing in for a worker pipe: routes through
    the daemon link tagged with the worker number."""

    __slots__ = ("_pool", "_num", "_channel")

    def __init__(self, pool: "RemoteNodePool", num: int, channel: str):
        self._pool = pool
        self._num = num
        self._channel = channel

    def send(self, msg) -> None:
        self._pool._send_daemon((self._channel, self._num, msg))

    def close(self) -> None:
        pass


class RemoteNodePool(ProcessWorkerPool):
    is_remote = True

    def __init__(self, worker, num_workers: int, node_index: int, conn,
                 node_id, daemon_proc: Optional[subprocess.Popen] = None,
                 arena_name: Optional[str] = None,
                 peer_address: Optional[tuple] = None,
                 fenced: bool = False, adopting: bool = False):
        self._arena_name = arena_name
        # adopting (a daemon rejoining a restarted head): the demux
        # reads nothing until open_dispatch(), once the head has adopted
        # the daemon's workers and leases, so that the outbox replay
        # sent right behind the hello finds them
        self._dispatch_open = threading.Event()
        if not adopting:
            self._dispatch_open.set()
        # epoch fence (node-death FT): a daemon that rejoins AFTER the
        # head declared its node dead gets a fenced pool — outbox
        # REPLAY envelopes (receipts stranded from the dead era) are
        # acked but never dispatched, because the head already failed
        # or resubmitted everything that era produced; processing a
        # stale lease/completion replay would double-resolve it. Fresh
        # (non-replay) traffic flows normally.
        self._fenced = fenced
        # daemon's direct-transfer endpoint (object manager peer plane):
        # other nodes pull object bytes straight from it, head-free
        self.peer_address = tuple(peer_address) if peer_address else None
        self._conn = conn
        self._conn_lock = threading.Lock()
        self._conn_dead = False
        # head->daemon messages that failed (or arrived while the link
        # was down) wait here and flush in order on re-attach; an
        # escalated node death discards them (their tasks retry through
        # the normal inflight bookkeeping)
        self._pending_sends: List[tuple] = []
        # outbox bookkeeping (daemon->head exactly-once): highest
        # sequence number processed, re-attach generation (stale
        # link-loss callbacks and grace timers check it), and the
        # failover observability counters metrics.py exports
        self._seq_lock = threading.Lock()
        self._last_seen_seq = 0
        self._attach_gen = 0
        self.outbox_depth = 0
        self.outbox_replayed = 0
        self.node_id = node_id
        self._daemon_proc = daemon_proc
        # two-level dispatch observability: task-id binaries of leases
        # the node's LocalScheduler admitted that are still in flight
        # (their completions resolve through the adopted-lease path),
        # and a lifetime counter — both surfaced by state.list_nodes
        self._local_tids: set = set()
        self.local_dispatched = 0
        # monotonic timestamp of the last resview push to this node's
        # daemon (state.list_nodes surfaces it as resview_age_s)
        self._resview_t: Optional[float] = None
        self._hqueues: Dict[int, queue.Queue] = {}
        self._fetches: Dict[int, Tuple[threading.Event, list]] = {}
        self._pings: Dict[int, Tuple[threading.Event, list]] = {}
        self._logreqs: Dict[int, Tuple[threading.Event, list]] = {}
        self._req_seq = 0
        self._req_lock = threading.Lock()
        # blocking worker RPCs (get/wait) must not stall the demux
        # thread; per-worker ordering is preserved by the handle queues,
        # and rpc replies are request-id-matched worker-side
        self._rpc_pool = ThreadPoolExecutor(
            max_workers=max(num_workers + 2, 4),
            thread_name_prefix="ray_tpu_remote_rpc")
        super().__init__(worker, num_workers, None, node_index=node_index)

    # -- transport -----------------------------------------------------
    def _start_transport(self) -> None:
        threading.Thread(target=self._demux_loop, daemon=True,
                         name=f"ray_tpu_remote_demux_{self.node_index}"
                         ).start()

    def _send_daemon(self, msg: tuple) -> None:
        with self._conn_lock:
            if not self._conn_dead:
                try:
                    self._conn.send(msg)
                    return
                except (OSError, ValueError):
                    pass  # demux EOF handles the failure; buffer below
            # a send() that raises never delivered a complete frame
            # (the daemon drops truncated frames with the connection),
            # so re-sending after re-attach cannot double-deliver
            self._pending_sends.append(msg)

    def _next_req(self) -> int:
        with self._req_lock:
            self._req_seq += 1
            return self._req_seq

    def open_dispatch(self) -> None:
        """Let the demux read the daemon's messages (see ``adopting``)."""
        self._dispatch_open.set()

    def _demux_loop(self) -> None:
        opened = getattr(self, "_dispatch_open", None)
        if opened is not None:
            opened.wait()
        conn = self._conn
        with self._seq_lock:
            gen = self._attach_gen
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError, TypeError, ValueError):
                # TypeError/ValueError: conn closed under a blocked recv
                self._on_daemon_lost(gen)
                return
            runtime_sanitizer.check_wire("daemon_to_head", msg)
            if msg[0] == "seq":
                # outbox envelope: dedup by per-node sequence number
                # (a replay after a transient flap re-delivers entries
                # this head already processed), then ack the high-water
                # mark so the daemon trims its buffer
                _, seq, depth, is_replay, inner = msg
                with self._seq_lock:
                    duplicate = seq <= self._last_seen_seq
                    if not duplicate:
                        self._last_seen_seq = seq
                    high_water = self._last_seen_seq
                    self.outbox_depth = depth
                    if is_replay:
                        self.outbox_replayed += 1
                self._send_daemon(("ack", high_water))
                if duplicate:
                    continue
                if is_replay and getattr(self, "_fenced", False):
                    # stale-era replay into a fenced (rejoined-after-
                    # declared-dead) pool: ack'd above so the daemon
                    # trims its outbox, but never dispatched — the
                    # node-death reconciler already settled this era
                    self._worker.note_two_level("orphan_fenced")
                    continue
                runtime_sanitizer.check_wire("daemon_to_head", inner)
                msg = inner
            self._dispatch_daemon_msg(msg)

    def _dispatch_daemon_msg(self, msg: tuple) -> None:
        kind = msg[0]
        if kind == "w":
            num, wmsg = msg[1], msg[2]
            with self._lock:
                h = self._by_num.get(num)
            q = self._hqueues.get(num)
            if h is not None and q is not None:
                q.put(wmsg)
        elif kind == "worker_died":
            q = self._hqueues.get(msg[1])
            if q is not None:
                # msg may carry the worker's .err tail (the remote
                # crash traceback) — fold it into the cause so
                # WorkerCrashedError surfaces the real reason
                cause = f"exit code {msg[2]}"
                if len(msg) > 3 and msg[3]:
                    cause += msg[3]
                q.put(("__died__", cause))
        elif kind == "fetched":
            slot = self._fetches.pop(msg[1], None)
            if slot is not None:
                slot[1][:] = [msg[2], msg[3]]
                slot[0].set()
        elif kind == "pong":
            slot = self._pings.pop(msg[1], None)
            if slot is not None:
                slot[1][:] = [msg[2]]
                slot[0].set()
        elif kind == "log":
            # appended capture lines shipped by the daemon's tailer
            lm = getattr(self._worker, "log_monitor", None)
            if lm is not None:
                lm.on_remote_lines(self, msg[1], msg[2])
        elif kind in ("log_listed", "log_data", "store_stats"):
            slot = self._logreqs.pop(msg[1], None)
            if slot is not None:
                slot[1][:] = list(msg[2:])
                slot[0].set()
        elif kind == "pulled":
            # a staged (or localization) peer pull completed: this
            # node now holds a COPY — register it as a secondary
            # location so later leases can score/stage against it,
            # and count the cross-node bytes moved
            oid = ObjectID(msg[1])
            self._worker.gcs.object_location_add_secondary(
                oid, self.node_index)
            e = self._worker.memory_store.get_entry(oid)
            if e is not None and e.size:
                self._worker.note_transfer("bytes_pulled", e.size)
        elif kind == "clock":
            # clock handshake sample sent right after the daemon's
            # hello (and after every rejoin): maps daemon wall-clock
            # timestamps onto the head's axis. Error ~ one-way link
            # latency, far below task-span granularity.
            self.clock_offset = time.time() - msg[1]
        elif kind == "util":
            # outbox-riding resource sample from the daemon's sampler;
            # the payload's "ts" is daemon wall clock — align it onto
            # the head axis with the same offset the event planes use
            pp = getattr(self._worker, "profile_plane", None)
            if pp is not None:
                pp.record_util(self.node_index, msg[1],
                               offset=self.clock_offset)
        elif kind == "local_lease":
            # the node's LocalScheduler admitted a worker-submitted
            # task without a head round-trip: journal + adopt it so
            # failover reconciliation and ref bookkeeping see it as if
            # the head had placed it (outbox FIFO guarantees this
            # arrives before the lease's own done/err)
            with self._seq_lock:
                self._local_tids.add(msg[1])
                self.local_dispatched += 1
            self._worker.on_local_lease(self, msg[1], msg[2])
        elif kind == "local_retry":
            # the daemon re-leased a locally-dispatched task's failed
            # attempt to a sibling worker (per-attempt accounting, no
            # head round-trip): move the adopted inflight entry to the
            # new worker and re-journal the bumped attempt token. FIFO
            # puts this BEFORE the worker_died report, which then no
            # longer finds the lease on the dead handle
            self._worker.on_local_retry(self, msg[1], msg[2])
        elif kind == "p2p_done":
            # sequenced completion receipt for a peer-to-peer actor
            # call: results already flowed peer→peer; the head only
            # stores lineage/ownership (exactly-once vs any fallback)
            self._worker.on_p2p_done(self, msg[1], msg[2])
        elif kind == "p2p_fallback":
            # a peer lane died/dropped/timed out mid-call: re-execute
            # through the head path with the same attempt token; the
            # worker-side dedup cache makes the retry exactly-once
            self._worker.on_p2p_fallback(self, msg[1], msg[2])
        elif kind == "aresolve":
            # daemon asks where an actor lives (first p2p call to it)
            route = self._worker.resolve_actor_address(msg[1])
            self._send_daemon(("aroute", msg[1], route))
        elif kind == "fault":
            # a chaos injection fired on the daemon (peer_link site):
            # merge into the head controller's log and counters
            from ray_tpu_torch._private.chaos import get_controller
            get_controller().note_remote(msg[1])
        else:
            # exhaustive dispatch: an unknown daemon tag means the
            # wire protocol drifted (raylint pass 3 checks this
            # statically; this guard catches version skew at runtime)
            logger.error(
                "head: unknown daemon message tag %r from node %d "
                "(protocol drift?)", kind, self.node_index)

    def _on_daemon_lost(self, gen: Optional[int] = None) -> None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        with self._seq_lock:
            if gen is not None and gen != self._attach_gen:
                return  # a re-attach superseded this link already
            self._conn_dead = True
        # unblock fetch/ping/log waiters: their replies died with the
        # link regardless of whether the node comes back
        for table in (self._fetches, self._pings, self._logreqs):
            for ev, _slot in list(table.values()):
                ev.set()
            table.clear()
        grace = GLOBAL_CONFIG.daemon_rejoin_grace_s
        proc = self._daemon_proc
        if proc is not None and proc.poll() is None \
                and getattr(self, "_respawn_disabled", False):
            # machine-death chaos killpg'd the tree: the socket EOF can
            # beat the zombie transition by a scheduler tick, and
            # poll() alone would misread a corpse as a live daemon
            # worth a full rejoin grace window
            try:
                proc.wait(timeout=0.5)
            except Exception:
                pass
        daemon_known_dead = proc is not None and proc.poll() is not None
        if (grace > 0 and not daemon_known_dead and not self._shutdown
                and not self._node_dead
                and self._worker.gcs.mark_node_rejoining(self.node_id)):
            # REJOINING grace window: keep worker handles and in-flight
            # leases alive — a daemon that re-dials within the window
            # re-attaches (outbox replay + send-buffer flush) and the
            # blackout is invisible. A head-spawned daemon whose process
            # already exited can never re-dial: skip straight to death.
            logger.warning(
                "node %s: daemon link lost; REJOINING grace %.1fs",
                self.node_id.hex()[:16], grace)
            threading.Thread(
                target=self._grace_timer, args=(gen, grace), daemon=True,
                name=f"ray_tpu_rejoin_grace_{self.node_index}").start()
            return
        self._fail_lost_daemon()

    def _grace_timer(self, gen: Optional[int], grace: float) -> None:
        time.sleep(grace)
        with self._seq_lock:
            if gen is not None and gen != self._attach_gen:
                return  # the daemon re-attached in time
            if not self._conn_dead:
                return
        logger.warning("node %s: rejoin grace expired; marking dead",
                       self.node_id.hex()[:16])
        self._fail_lost_daemon()

    def _fail_lost_daemon(self) -> None:
        with self._conn_lock:
            self._pending_sends.clear()
        # declare the node dead BEFORE waking the per-worker queue
        # loops: their __died__ handling restarts actors, and a
        # restart that races the _node_dead flag re-spawns onto this
        # very corpse (burning a restart attempt on a worker that can
        # never register)
        if not self._shutdown and not self._node_dead:
            logger.warning("node %s: daemon connection lost; marking dead",
                           self.node_id.hex()[:16])
            try:
                self._worker.on_node_failure(
                    self.node_id, reason="daemon connection lost")
            except Exception:
                logger.exception("on_node_failure failed")
        # snapshot: _queue_loop threads pop _hqueues as they die
        for q in list(self._hqueues.values()):
            q.put(("__died__", "daemon connection lost"))
        self._unlink_dead_arena()

    def reattach(self, conn) -> None:
        """The daemon re-dialed after a transient link loss (the head
        never died): swap in the fresh connection, flush the buffered
        head->daemon sends in order, and restart the demux. The
        daemon's outbox replay arrives next and the sequence dedup in
        _demux_loop drops everything this head already processed."""
        with self._seq_lock:
            self._attach_gen += 1  # invalidates stale loss callbacks
        with self._conn_lock:
            old = self._conn
            self._conn = conn
            self._conn_dead = False
            pending, self._pending_sends = self._pending_sends, []
        try:
            old.close()
        except Exception:
            pass
        for msg in pending:
            self._send_daemon(msg)
        self._start_transport()
        self._worker.gcs.mark_node_rejoined(self.node_id)
        logger.warning("node %s: daemon re-attached (%d buffered sends "
                       "flushed)", self.node_id.hex()[:16], len(pending))

    def sever_link(self) -> None:
        """Chaos (``head`` site, kind ``flap``): close the daemon link
        without telling anyone. Both sides see EOF — the daemon enters
        its rejoin loop, this pool enters the REJOINING grace window,
        and the reunion exercises outbox replay + dedup end to end."""
        with self._conn_lock:
            try:
                self._conn.close()
            except Exception:
                pass

    def _unlink_dead_arena(self) -> None:
        """A SIGKILLed daemon can't unlink its own arena; reap it once
        the daemon is confirmed gone. Head-spawned daemons: wait on the
        child process. Adopted (CLI-joined) daemons: the severed
        connection is the death signal; a joined daemon on ANOTHER host
        leaves no segment here, so the by-name reap is a no-op there."""
        if self._arena_name is None:
            return
        if self._daemon_proc is not None:
            try:
                self._daemon_proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                return
        elif not self._conn_dead:
            return
        from multiprocessing import shared_memory
        try:
            seg = shared_memory.SharedMemory(name=self._arena_name)
            seg.close()
            seg.unlink()
        except FileNotFoundError:
            pass
        except Exception:
            logger.debug("arena reap failed", exc_info=True)
        self._arena_name = None

    # -- worker lifecycle ----------------------------------------------
    def _spawn(self) -> _Handle:
        with self._lock:
            self._worker_seq += 1
            num = self._worker_seq
        h = _Handle(num)
        h.conn = _ProxyConn(self, num, "to_w")
        h.ctrl = _ProxyConn(self, num, "to_ctrl")
        q: queue.Queue = queue.Queue()
        self._hqueues[num] = q
        with self._lock:
            self._by_num[num] = h
        threading.Thread(target=self._queue_loop, args=(h, q), daemon=True,
                         name=f"ray_tpu_remote_w{num}").start()
        # the wid names the worker's capture files daemon-side, so log
        # filenames look identical on local and remote nodes
        self._send_daemon(("spawn", num, h.worker_id.hex()[:12]))
        return h

    def adopt_worker(self, num: int, pid: Optional[int],
                     is_actor: bool, busy: bool = False) -> _Handle:
        """Attach a handle to a worker process that ALREADY RUNS on the
        rejoining daemon (head-restart re-adoption): same plumbing as
        _spawn minus the spawn message — the process is alive, so it is
        ready by construction. ``busy`` marks workers the daemon
        reported with leases still executing: they are adopted into the
        handle set but NOT parked idle (adopt_inflight re-attaches
        their leases next; completion releases them normally)."""
        with self._lock:
            self._worker_seq = max(self._worker_seq, num)
        h = _Handle(num)
        h.conn = _ProxyConn(self, num, "to_w")
        h.ctrl = _ProxyConn(self, num, "to_ctrl")
        h.pid = pid
        h.ready = True
        q: queue.Queue = queue.Queue()
        self._hqueues[num] = q
        with self._lock:
            self._by_num[num] = h
        threading.Thread(target=self._queue_loop, args=(h, q), daemon=True,
                         name=f"ray_tpu_remote_w{num}").start()
        if not is_actor:
            with self._lock:
                self._handles.append(h)
            if not busy:
                self._mark_idle(h)
        return h

    def adopt_inflight(self, h: _Handle, task_id_bin: bytes,
                       return_bins: List[bytes], attempt: int) -> None:
        """Re-attach a lease a rejoining daemon reported still running:
        a SYNTHETIC inflight entry (pending=None, see _InFlight) keyed
        under the ORIGINAL return oids, so the daemon's eventual
        done/err (possibly arriving via outbox replay) resolves the
        exact refs a resumed ray:// client is blocked on."""
        task_id = TaskID(task_id_bin)
        inf = _InFlight(None, [ObjectID(b) for b in return_bins])
        with self._lock:
            h.inflight[task_id] = inf
            self._by_task[task_id] = h

    def send_resview(self, view: dict) -> None:
        """Push the head's resource/knob view to the node daemon: the
        LocalScheduler admits against this (accept gate, queue cap,
        p2p flag, job binary, residency digest, peer list, mirrored
        chaos plan). Sent only while a two-level knob is on — both off
        means zero wire delta. The push timestamp feeds
        state.list_nodes' resview_age_s freshness column."""
        self._send_daemon(("resview", view))
        self._resview_t = time.monotonic()

    def local_queue_depth(self) -> int:
        with self._seq_lock:
            return len(self._local_tids)

    # -- failover lease journal ----------------------------------------
    def _journal_lease(self, spec, payload: dict) -> None:
        """Mirror this dispatch into the GCS WAL so a restarted head
        can resubmit it if no surviving daemon claims it. Args are
        re-pickled from the RAW spec (the payload's args_blob embeds
        arena markers that die with this head); tasks whose args can't
        be pickled journal a record without a resubmit body — their
        adoption bookkeeping still works, resubmission fails the refs."""
        import cloudpickle as _cp

        try:
            args_blob = _cp.dumps((spec.args, spec.kwargs))
        except Exception:
            args_blob = None
        self._worker.gcs.journal_lease(spec.task_id.binary(), {
            "name": spec.name,
            "fn_blob": payload.get("fn_blob"),
            "args_blob": args_blob,
            "num_returns": spec.num_returns,
            "returns": list(payload["return_ids"]),
            "resources": dict(spec.resources or {}),
            "attempt": spec.attempt_number,
            "max_retries": spec.max_retries,
            "node_index": self.node_index,
        })

    def _assign(self, h: _Handle, pending, payload: dict) -> None:
        if self._worker.gcs.journal_enabled:
            self._journal_lease(pending.spec, payload)
        super()._assign(h, pending, payload)

    def _assign_many(self, h: _Handle, items: List[tuple]) -> None:
        if self._worker.gcs.journal_enabled:
            for pending, payload in items:
                self._journal_lease(pending.spec, payload)
        if self._envelope_on():
            # tentpole (c): the PR-11 batched lease envelope extends to
            # remote pools — one ("env", blob) frame rides the daemon
            # link with the same invariant-header/fn-blob trims as the
            # local shm ring. _assign_many_ring's pipe fallback is the
            # sender (remote handles have no ring), the daemon decodes
            # a bookkeeping copy and forwards the blob verbatim to the
            # worker's existing "env" pipe branch
            self._assign_many_ring(h, items)
            return
        super()._assign_many(h, items)

    def _envelope_on(self) -> bool:
        # rides the local_dispatch escape hatch: knobs off keeps the
        # head->daemon wire byte-for-byte pre-two-level ("tasks" lists)
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        return bool(GLOBAL_CONFIG.local_dispatch
                    and GLOBAL_CONFIG.control_ring)

    def _finish_task(self, pending, exec_task_id: TaskID, retry) -> None:
        # terminal for THIS remote attempt (a retry re-journals at its
        # own dispatch): drop it from the reconciliation set so a later
        # failover can never resubmit an attempt that already resolved
        self._lease_done(exec_task_id)
        super()._finish_task(pending, exec_task_id, retry)

    def _lease_done(self, task_id: TaskID) -> None:
        with self._seq_lock:
            self._local_tids.discard(task_id.binary())
        self._worker.gcs.journal_lease_done(task_id.binary())

    def _queue_loop(self, h: _Handle, q: queue.Queue) -> None:
        """Per-worker message pump — the remote analog of the local
        per-worker reader thread (same ordering guarantees)."""
        while True:
            msg = q.get()
            if msg[0] == "__died__":
                self._hqueues.pop(h.worker_num, None)
                self._on_worker_failure(h, msg[1])
                return
            if msg[0] == "rpc":
                # blocking get/wait must not stall this worker's pump
                # either: an actor's kill/exit travels h.conn, but
                # completions for OTHER workers (which a get may await)
                # come through other queues — only same-worker ordering
                # matters, and a worker blocks in its rpc anyway.
                # Indefinitely-blocking ops get a dedicated thread (like
                # ClientServer._serve): dedicated actor workers spawn
                # beyond num_workers, so a bounded pool could fill with
                # blocked get/wait calls and deadlock the put/submit
                # that would unblock them.
                if msg[2] in ("get", "wait"):
                    threading.Thread(
                        target=self._handle_worker_msg, args=(h, msg),
                        daemon=True,
                        name=f"ray_tpu_remote_rpc_w{h.worker_num}").start()
                else:
                    self._rpc_pool.submit(self._handle_worker_msg, h, msg)
            else:
                self._handle_worker_msg(h, msg)

    def _kill_handle(self, h: _Handle) -> None:
        self._send_daemon(("kill", h.worker_num))

    def pids(self) -> List[int]:
        pids = self._ping()
        return sorted(pids.values()) if pids else []

    def live_process_count(self) -> int:
        pids = self._ping()
        return len(pids) if pids else 0

    def _ping(self, timeout: float = 2.0) -> Optional[Dict[int, int]]:
        if self._conn_dead:
            return None
        pid_ = self._next_req()
        ev: threading.Event = threading.Event()
        slot: list = []
        self._pings[pid_] = (ev, slot)
        if self._conn_dead:
            # registered after _on_daemon_lost swept the table: bail now
            # instead of waiting out the timeout
            self._pings.pop(pid_, None)
            return None
        self._send_daemon(("ping", pid_))
        if not ev.wait(timeout) or not slot:
            self._pings.pop(pid_, None)
            return None
        return slot[0]

    def simulate_machine_death(self) -> None:
        """Chaos: SIGKILL the node daemon AND its whole worker tree
        (the daemon runs in its own session — see the
        start_new_session spawn flag — so killpg takes out every
        process on the 'machine' at once; nothing survives to flush an
        outbox or report a death). The control plane is NOT told; the
        severed connection / health checks must notice."""
        import signal

        self._respawn_disabled = True
        if self._daemon_proc is not None:
            pid = self._daemon_proc.pid
            killed = False
            try:
                # only a daemon in its OWN process group is tree-
                # killable; a same-group daemon (legacy spawn) falls
                # back to killing just the daemon process
                if os.getpgid(pid) != os.getpgid(0):
                    os.killpg(os.getpgid(pid), signal.SIGKILL)
                    killed = True
            except (OSError, ProcessLookupError):
                pass
            if not killed:
                try:
                    self._daemon_proc.kill()
                except Exception:
                    pass
        else:
            self._send_daemon(("exit",))

    def take_local_tids(self) -> set:
        """Node-death reconciliation: claim (snapshot + clear) the
        locally-admitted in-flight lease set, so the reconciler — not
        the worker-failure sweep — decides each lease's fate exactly
        once."""
        with self._seq_lock:
            tids, self._local_tids = self._local_tids, set()
        return tids

    # -- object movement ----------------------------------------------
    def fetch_object(self, oid: ObjectID,
                     timeout: Optional[float] = None) -> Optional[bytes]:
        """Pull an object's framed bytes out of the node's arena/spill
        tier (the PullManager request). The timeout guards against a
        hung daemon, not a slow transfer — default is config-driven so
        multi-GB objects don't misreport as lost."""
        if self._conn_dead:
            return None
        if timeout is None:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            timeout = GLOBAL_CONFIG.object_transfer_timeout_s
        fid = self._next_req()
        ev: threading.Event = threading.Event()
        slot: list = []
        self._fetches[fid] = (ev, slot)
        if self._conn_dead:
            # registered after _on_daemon_lost swept the table: bail now
            # instead of waiting out the transfer timeout
            self._fetches.pop(fid, None)
            return None
        self._send_daemon(("fetch", fid, oid.binary()))
        if not ev.wait(timeout) or not slot or not slot[0]:
            self._fetches.pop(fid, None)
            return None
        data = slot[1]
        # the chaos transfer fault mutates the RAW received bytes HERE,
        # before any consumer sees them — the frame-completeness check
        # (worker.fetch_object_bytes) must observe the injected
        # truncation, never a pristine buffer with the fault applied
        # downstream of the check
        fault = self._chaos.poll("transfer", node=self.node_index,
                                 object=oid.hex()[:16])
        if fault is not None and data:
            keep = max(1, int(len(data) * fault.get("keep_fraction", 0.5)))
            data = data[:keep]
        if data:
            # head-mediated fetches are cross-node traffic too: count
            # them so bytes-saved accounting reconciles against the
            # total arg bytes moved
            self._worker.note_transfer("bytes_pulled", len(data))
        return data

    def free_remote(self, oids: List[ObjectID]) -> None:
        self._send_daemon(("free", [o.binary() for o in oids]))

    def stage_args(self, entries: List[tuple]) -> None:
        """Dispatch-time staging: (oid_bin, peer_address, nbytes)
        triples the daemon's pull manager starts fetching NOW, while
        the lease waits in the worker queue. Fire-and-forget — a lost
        or failed pull just means the exec-time localization path pays
        the transfer as before."""
        self._send_daemon(("stage", entries))

    # -- log plane queries ---------------------------------------------
    def _log_request(self, msg_tail: tuple,
                     timeout: float) -> Optional[list]:
        """One request/reply round-trip on the daemon link (same slot
        idiom as fetch_object/_ping)."""
        if self._conn_dead:
            return None
        rid = self._next_req()
        ev: threading.Event = threading.Event()
        slot: list = []
        self._logreqs[rid] = (ev, slot)
        if self._conn_dead:
            self._logreqs.pop(rid, None)
            return None
        self._send_daemon((msg_tail[0], rid) + msg_tail[1:])
        if not ev.wait(timeout) or not slot:
            self._logreqs.pop(rid, None)
            return None
        return slot

    def list_logs_remote(self, timeout: float = 5.0) -> List[dict]:
        """{filename, size_bytes, mtime} rows from the node's log dir."""
        slot = self._log_request(("log_list",), timeout)
        return slot[0] if slot else []

    def store_stats(self, timeout: float = 5.0) -> Optional[dict]:
        """{used_bytes, objects, spilled_objects} of the node's arena,
        read by its daemon; None when the daemon does not answer."""
        slot = self._log_request(("store_stats",), timeout)
        return slot[0] if slot else None

    def fetch_log_remote(self, filename: str, tail: Optional[int] = None,
                         timeout: float = 5.0) -> str:
        """Read a capture file off the node. Raises on daemon-side
        errors (bad filename, missing file) and unreachable daemons."""
        slot = self._log_request(("log_read", filename, tail), timeout)
        if slot is None:
            raise rex.NodeDiedError(
                f"node {self.node_id.hex()[:16]} unreachable for log read")
        ok, text = slot
        if not ok:
            raise FileNotFoundError(text)
        return text

    def _resolve_for_ship(self, v: Any) -> Any:
        if not isinstance(v, ObjectRef):
            return v
        oid = v.object_id()
        locs = self._worker.gcs.object_locations(oid)
        if self.node_index in locs:
            # already resident in the target node's arena (primary OR a
            # staged secondary copy): the worker reads it zero-copy
            # through its daemon (no wire bytes)
            return _PullValue(oid.binary())
        if any(self._worker.peer_address_of(n) is not None
               for n in locs):
            # resident on a THIRD node with a peer endpoint: ship the
            # pull marker — the worker's get flows daemon -> head,
            # whose reply directs a direct peer pull (bytes travel
            # producer node -> consumer node, never through the head)
            return _PullValue(oid.binary())
        entry = self._worker.memory_store.get_entry(oid)
        if entry is None:
            if self._worker.object_recovery.maybe_recover(oid):
                raise _RequeueDeps([oid])
            entry = self._worker.memory_store.get_entry(oid)
        if entry is None:
            raise _DepError(rex.ObjectLostError(oid.hex()))
        if entry.is_exception:
            raise _DepError(entry.value)
        # resolves head-arena placeholders, spilled restores, AND
        # third-node RemotePlaceholders (head-mediated fetch), then
        # embeds the value in the payload — the actual DCN transfer
        return self._worker._entry_value(oid, entry)

    def store_result_entries(self, return_ids: List[ObjectID],
                             entries: list) -> None:
        for oid, entry in zip(return_ids, entries):
            if entry[0] == "remote_shm":
                # size recorded so locality scoring / staging know the
                # arg bytes without a cross-node round trip
                self._worker.memory_store.put(
                    oid, RemotePlaceholder(self.node_index),
                    size=int(entry[1] or 0))
                self._worker.gcs.object_location_add(oid, self.node_index)
            else:
                from ray_tpu_torch._private.serialization import (SerializedObject,
                                                            deserialize)
                value = deserialize(SerializedObject.from_bytes(entry[1]))
                self._worker.memory_store.put(oid, value)
            self._worker.scheduler.notify_object_ready(oid)

    # -- worker-initiated RPC overrides --------------------------------
    def _rpc_put(self, h: _Handle, oid_bin: bytes, loc: tuple) -> bool:
        if loc[0] != "remote_shm":
            return super()._rpc_put(h, oid_bin, loc)
        oid = ObjectID(oid_bin)
        self._worker.reference_counter.add_owned_object(oid)
        self._worker.reference_counter.add_borrower(oid, h.worker_id)
        self._task_borrows(h).add(oid)
        self._worker.memory_store.put(oid, RemotePlaceholder(self.node_index),
                                      size=int(loc[1] or 0))
        self._worker.gcs.object_location_add(oid, self.node_index)
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
            value = entry.value
            if isinstance(value, RemotePlaceholder):
                locs = self._worker.gcs.object_locations(oid)
                if value.node_index not in locs:
                    locs.append(value.node_index)
                if self.node_index in locs:
                    # resident on the REQUESTING node (primary or a
                    # staged secondary): daemon rewrites this to a
                    # zero-copy arena location
                    out.append(("node_shm", oid.binary()))
                    continue
                peer = next(
                    (p for p in (self._worker.peer_address_of(n)
                                 for n in locs) if p is not None), None)
                if peer is not None:
                    # DIRECT node-to-node pull: reply with the
                    # producer's peer endpoint; the consuming daemon
                    # fetches the bytes itself — they never cross the
                    # head (reference: ObjectManager pull protocol)
                    out.append(("peer", oid.binary(), peer))
                    continue
                data = self._worker.fetch_object_bytes(oid,
                                                       value.node_index)
                if data is None:
                    out.append(("exc", cloudpickle.dumps(
                        rex.ObjectLostError(oid.hex()))))
                else:
                    out.append(("inline", data))
                continue
            from ray_tpu_torch._private.runtime.process_pool import ShmPlaceholder
            if isinstance(value, ShmPlaceholder):
                sobj = self._worker.shm_store.get_serialized(oid)
                if sobj is None:
                    out.append(("exc", cloudpickle.dumps(
                        rex.ObjectLostError(oid.hex()))))
                else:
                    out.append(("inline", sobj.to_bytes()))
            else:
                out.append(("inline", serialize(value).to_bytes()))
        return out

    def fail_node(self, reason: str) -> None:
        super().fail_node(reason)
        self._send_daemon(("exit",))

    # -- shutdown ------------------------------------------------------
    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._queue.clear()
            self._idle.clear()
        self._send_daemon(("exit",))
        try:
            with self._conn_lock:
                self._conn.close()
        except Exception:
            pass
        if self._daemon_proc is not None:
            try:
                self._daemon_proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                self._daemon_proc.kill()
        self._unlink_dead_arena()
        self._rpc_pool.shutdown(wait=False)


class HeadServer:
    """The head's TCP registration endpoint: node daemons (and later
    remote clients) dial in with an HMAC handshake and a token issued
    at spawn time (reference: the GCS server's listening port that
    raylets register against)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 authkey: Optional[bytes] = None):
        self.authkey = authkey or os.urandom(16)
        self._listener = Listener((host, port), authkey=self.authkey)
        self.address: Tuple[str, int] = self._listener.address
        self._pending: Dict[str, Tuple[threading.Event, list]] = {}
        self._lock = threading.Lock()
        self._closed = False
        self.on_unsolicited = None  # hook for client/CLI registrations
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="ray_tpu_head_accept")
        self._accept_thread.start()

    def expect(self, token: str) -> Tuple[threading.Event, list]:
        slot: Tuple[threading.Event, list] = (threading.Event(), [])
        with self._lock:
            self._pending[token] = slot
        return slot

    def issue_token(self) -> str:
        return uuid.uuid4().hex

    def _accept_loop(self) -> None:
        from multiprocessing import AuthenticationError

        while not self._closed:
            try:
                conn = self._listener.accept()
            except AuthenticationError:
                continue  # port-scan / bad-key dial must not kill accepts
            except (OSError, EOFError):
                # mid-handshake death of ONE dialer (peer hung up inside
                # deliver_challenge) must not kill the accept loop — that
                # would leave the whole cluster unreachable (later dials
                # complete TCP against the backlog, then hang in auth
                # forever). Only a closed listener ends the loop.
                if self._closed:
                    return
                time.sleep(0.01)  # if the LISTENER broke, don't spin hot
                continue
            try:
                # bound the hello wait: the accept loop is single-threaded,
                # so one authenticated-but-silent peer would block every
                # later registration behind it
                if not conn.poll(10.0):
                    conn.close()
                    continue
                hello = conn.recv()
            except (EOFError, OSError):
                conn.close()
                continue
            from ray_tpu_torch._private import protocol

            ver, fields = protocol.split_any_hello(hello)
            if not fields:
                conn.close()
                continue
            if ver != protocol.PROTOCOL_VERSION:
                # version skew: reject LOUDLY so the dialer sees why,
                # instead of dying later on a message-shape mismatch
                try:
                    conn.send(protocol.mismatch_error("head", ver))
                except (OSError, ValueError):
                    pass
                conn.close()
                continue
            # downstream parsers see the unversioned layout
            hello = ("hello",) + fields
            token = hello[1]
            with self._lock:
                slot = self._pending.pop(token, None)
            if slot is not None:
                slot[1][:] = [conn, hello]
                slot[0].set()
            elif self.on_unsolicited is not None:
                try:
                    self.on_unsolicited(conn, hello)
                except Exception:
                    logger.exception("unsolicited registration failed")
                    conn.close()
            else:
                conn.close()

    def close(self) -> None:
        self._closed = True
        close_listener(self._listener, self._accept_thread)

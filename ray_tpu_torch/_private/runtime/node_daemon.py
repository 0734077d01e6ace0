"""Node daemon — the raylet-process analog for remote (off-head) nodes.

Reference surfaces: ray src/ray/raylet/ (the per-node raylet binary:
owns the node's plasma store and worker pool, talks to the GCS/head over
the network) and src/ray/object_manager/ (the node-local half of object
transfer). The reference speaks gRPC over the DCN; here the head link is
one authenticated (HMAC) framed-message TCP connection
(multiprocessing.connection over AF_INET) — localhost stands in for the
DCN in tests, and the protocol is transport-agnostic: every message is a
small picklable tuple, object BYTES ride the same link only when they
actually cross nodes.

The daemon is a *multiplexer with a local object store*:

  - it execs and monitors this node's worker processes (the same
    worker_process.py used on the head's local nodes), each attached to
    the DAEMON's own shm arena — per-node object planes, like one
    plasma store per node;
  - worker messages are forwarded to the head tagged with the worker
    number, and head messages are routed to the right worker pipe, so
    the head-side pool logic (leases, retries, borrows, actor protocol)
    is identical for local and remote nodes;
  - it INTERCEPTS the object-plane RPCs it can serve node-locally:
    `create` allocates in the local arena, `get` is answered with
    zero-copy arena locations when every requested object is already
    sealed here, and sealed task returns are rewritten to compact
    ``("remote_shm", nbytes)`` markers so result bytes never cross the
    wire until someone actually needs them (locality: results stay
    where they were produced, as in the reference's object manager);
  - it serves the head's transfer ops: ``fetch`` (read object bytes out
    of the arena/spill tier for a cross-node consumer) and ``free``.

Head -> daemon messages:
  ("spawn", num[, wid_hex])   exec a worker process numbered `num`
                              (wid_hex names its log capture files)
  ("to_w", num, msg)          deliver msg on worker num's task pipe
  ("to_ctrl", num, msg)       deliver msg on worker num's control pipe
  ("kill", num)               SIGKILL worker num (force-cancel path)
  ("fetch", fid, oid_bin)     -> ("fetched", fid, ok, bytes)
  ("stage", [(oid_bin, peer_address, nbytes), ...])
                              dispatch-time arg staging: start peer
                              pulls of these objects NOW (task-arg
                              priority) so the transfer overlaps the
                              lease's queue wait
  ("free", [oid_bin, ...])    drop objects from the local store
  ("ping", pid_)              -> ("pong", pid_, {num: pid})
  ("store_stats", rid)        -> ("store_stats", rid, {used_bytes,
                              objects, spilled_objects}) of this node's
                              arena (the port's addition: the head
                              reads a remote arena's occupancy)
  ("log_list", rid)           -> ("log_listed", rid, rows)
  ("log_read", rid, filename, tail)
                              -> ("log_data", rid, ok, text_or_error)
  ("resview", view)           two-level dispatch push: {accept, p2p,
                              cap, job, chaos, v, peers, resident} —
                              refreshed view gating the daemon's LOCAL
                              submission queue and advertising the p2p
                              actor lane (plus a mirror of the head's
                              armed chaos plan). `v` is a monotonic
                              version for peer gossip tiebreaks,
                              `peers` the other nodes' peer addresses,
                              `resident` a digest (8-byte oid
                              prefixes) of this node's object-
                              directory residency so ref-carrying
                              submissions can admit locally
  ("aroute", aid_bin, route)  actor-route reply for an ("aresolve",
                              aid_bin) request: (node_index, address,
                              worker_num) or None
  ("node_dead", info)         route invalidation: a PEER node died
                              (info: {index, peer}); evict its gossip
                              view, drop cached p2p actor routes to
                              its address and sweep in-flight lane
                              calls to the head path NOW instead of
                              waiting out the p2p result timeout
  ("fence", epoch)            this daemon rejoined AFTER the head
                              declared its node dead: clear dead-era
                              local-lease / in-flight-p2p / outbox
                              state — the head already resubmitted or
                              failed everything that era produced, so
                              a zombie re-lease or stale fallback
                              would double-execute
  ("exit",)                   kill workers and exit

Daemon -> head messages:
  ("w", num, msg)             message from worker num (maybe rewritten)
  ("worker_died", num, code[, err_tail])
                              worker process exited (err_tail: last
                              lines of its .err capture, or "")
  ("fetched", fid, ok, data)  fetch reply
  ("pong", pid_, pids)        ping reply
  ("store_stats", rid, stats) store_stats reply
  ("log", fname, lines)       appended log lines from a capture file
                              (unsolicited; the head's LogMonitor
                              re-emits them on the driver)
  ("pulled", oid_bin)         a peer pull (staged or exec-time) landed
                              the object in this node's store; the
                              head registers a SECONDARY copy in the
                              object directory
  ("log_listed", rid, rows)   log_list reply
  ("log_data", rid, ok, text) log_read reply
  ("local_lease", tid, info)  the LocalScheduler admitted a worker
                              submission against the head-pushed
                              resource view and leased it to a sibling
                              worker; info carries everything the head
                              needs to journal the lease (fn/args
                              blobs, return ids, attempt, max_retries)
  ("local_retry", tid, info)  a locally-dispatched lease's worker died
                              and the daemon re-leased the SAME task
                              (same return oids, attempt+1) to a
                              sibling worker without a head
                              round-trip; the head moves its adopted
                              in-flight entry to the new worker and
                              re-journals the bumped attempt token
                              (FIFO-ordered before the worker_died
                              report, which then skips the moved
                              lease)
  ("p2p_done", tid, info)     completion receipt for a peer-dispatched
                              actor call EXECUTED on this node: result
                              entries + timing for lineage/ref-counts
                              (the only head traffic a p2p call costs)
  ("p2p_fallback", tid, info) a p2p call this node ORIGINATED could
                              not complete over the peer lane; the
                              head re-runs it with the same task id +
                              attempt token (worker-side dedup makes
                              the retry exactly-once)
  ("aresolve", aid_bin)       actor-route request -> ("aroute", ...)
  ("fault", entry)            a mirrored chaos injection fired on this
                              daemon (e.g. peer_link); joins the
                              head's injection log/counters

Report-class messages (w / worker_died / pulled / log / local_lease /
p2p_done / p2p_fallback / fault — anything the
head must not lose across a blackout) don't travel bare: they ride a
sequence-numbered outbox envelope ("seq", n, depth, is_replay, inner)
and are buffered until the head acknowledges them with ("ack", n)
(high-water mark; the daemon trims its outbox prefix). After a link
drop the daemon replays every unacked entry on rejoin; the head dedups
by per-node sequence number, so a transient flap delivers each report
exactly once. Request/reply tags (fetched/pong/log_listed/log_data)
and the clock handshake stay bare — their requester died with the old
link, so replaying them is meaningless.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time
from multiprocessing.connection import Client, Listener
from typing import Any, Dict, Optional

from ray_tpu_torch._private.analysis import runtime_sanitizer
from ray_tpu_torch._private.analysis.runtime_checks import assert_holds
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch._private.runtime.listener import close_listener

# the cluster secret reaches a spawned daemon in this variable
HEAD_AUTHKEY_ENV = "RAY_TPU_TORCH_HEAD_AUTHKEY"


class _Outbox:
    """Sequence-numbered buffer of report-class daemon->head messages.

    Every message appended gets the next sequence number and stays
    buffered until the head acks a high-water mark at or past it
    (``ack`` trims the prefix). While the head link is down nothing is
    lost — ``pending()`` snapshots the unacked tail for replay after a
    rejoin. Depth is bounded in practice by the rejoin timeout times
    the node's report rate; an explicit cap would silently violate the
    exactly-once contract, so there isn't one.

    An entry may carry ``meta``, a note that stays on this side of the
    link and leaves with the entry's ack: a completion's lease (worker,
    task, returns, attempt), which the rejoin hello reports until the
    head has processed the completion itself.
    """

    def __init__(self):
        import collections

        # (seq, msg, meta), seq ascending
        self._entries = collections.deque()
        self._next_seq = 1
        self._lock = threading.Lock()

    def append(self, msg: tuple, meta=None):
        """Buffer ``msg``; returns (assigned seq, depth after append)."""
        with self._lock:
            seq = self._next_seq
            self._next_seq = seq + 1
            self._entries.append((seq, msg, meta))
            return seq, len(self._entries)

    def ack(self, seq: int) -> int:
        """Trim every entry with sequence <= ``seq`` (the head processed
        them). Returns how many entries were trimmed. Stale/duplicate
        acks (already-trimmed prefixes) are no-ops."""
        trimmed = 0
        with self._lock:
            while self._entries and self._entries[0][0] <= seq:
                self._entries.popleft()
                trimmed += 1
        return trimmed

    def pending(self):
        """Snapshot of unacked (seq, msg) entries, oldest first."""
        with self._lock:
            return [(seq, msg) for seq, msg, _ in self._entries]

    def unacked_meta(self) -> list:
        """The ``meta`` of every unacked entry that has one, oldest
        first."""
        with self._lock:
            return [meta for _, _, meta in self._entries
                    if meta is not None]

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._next_seq - 1


# daemon->head tags that ride the outbox (report-class: the head must
# not lose them across a blackout); everything else is sent bare.
# "util" = resource samples for the utilization ring; "w"-wrapped
# worker "prof" batches are covered by "w" itself. The two-level
# dispatch reports (local leases, p2p completion receipts, fallbacks,
# mirrored chaos injections) are report-class BY CONSTRUCTION: the
# exactly-once story for decentralized dispatch is the outbox replay +
# head-side sequence dedup, nothing new
_OUTBOX_TAGS = frozenset((
    "w", "worker_died", "pulled", "log", "util",
    "local_lease", "local_retry", "p2p_done", "p2p_fallback", "fault"))


class _WorkerSlot:
    __slots__ = ("num", "proc", "conn", "ctrl", "pid", "returns",
                 "attempts", "gets", "actor_bin", "send_lock", "err_path",
                 "hdr_cache", "reader_done", "early")

    def __init__(self, num: int):
        self.num = num
        # serializes writes to conn: the run loop and deferred
        # peer-pull reply threads both send here, and interleaved
        # Connection frames corrupt the worker's stream
        self.send_lock = threading.Lock()
        self.proc: Optional[subprocess.Popen] = None
        self.conn = None
        # messages for a worker that has not dialed in yet (a local
        # lease given to a starting sibling); sent in order on attach
        self.early: list = []
        self.ctrl = None
        self.pid: Optional[int] = None
        # task_id binary -> [return oid binaries] for in-flight payloads,
        # so sealed shm returns can be rewritten on "done"
        self.returns: Dict[bytes, list] = {}
        # task_id binary -> attempt token (stamped by the head at
        # dispatch); rides the rejoin in-flight report so a restarted
        # head can discard stale-attempt replays after a resubmission
        self.attempts: Dict[bytes, int] = {}
        # req_id -> purpose ("get" | "arg") of get RPCs forwarded to
        # the head, whose replies may carry ("node_shm", oid) markers
        # to rewrite as arena locations / peer pulls (purpose sets the
        # pull priority: a blocking get outranks task-arg prefetch)
        self.gets: Dict[int, str] = {}
        # dedicated actor workers record their actor id (from the
        # actor_create payload) so a RESTARTED head can re-adopt them
        self.actor_bin: Optional[bytes] = None
        # path of this worker's .err capture file (log plane), so a
        # crash tail can ride the worker_died report to the head
        self.err_path: Optional[str] = None
        # lease-envelope header cache: the daemon decodes ("env", ...)
        # payloads for its own returns/attempts bookkeeping while
        # forwarding the blob verbatim — both caches evolve in
        # lockstep because both sides decode the same ordered stream
        self.hdr_cache: Dict[int, tuple] = {}
        # set when the worker-reader thread hits EOF with its buffered
        # messages drained; _monitor waits on it so a completion the
        # worker emitted just before dying is never retried
        self.reader_done = threading.Event()


PEER_CHUNK = 1 << 20  # ~1 MB frames (reference: ObjectBufferPool)


def _drain_frames(conn, total: int, timeout: float, sink_view=None,
                  sink_write=None) -> None:
    """The ONE chunk-protocol receive loop (exact ~1 MB frames until
    `total`): into a buffer view (recv_bytes_into, no copy) or through
    a write callback (spill files). Raises OSError on timeout/short
    frames — both fetch modes share this, so protocol changes can't
    desynchronize them."""
    pos = 0
    while pos < total:
        n = min(PEER_CHUNK, total - pos)
        if not conn.poll(timeout):
            raise OSError("peer chunk timed out")
        if sink_view is not None:
            got = conn.recv_bytes_into(sink_view[pos:pos + n])
        else:
            chunk = conn.recv_bytes(PEER_CHUNK)
            got = len(chunk)
            sink_write(chunk)
        if got != n:
            raise OSError(f"short peer chunk: {got} != {n} at {pos}")
        pos += n


def recv_object_into_store(conn, store, oid: ObjectID, total: int,
                           timeout: float) -> bool:
    """Drain the chunk frames into the given store: straight into a
    pre-created arena range (recv_bytes_into — no intermediate buffer)
    or appended to a spill file when the arena can't hold it.
    Per-transfer transient memory is ONE chunk. Shared by daemons AND
    the head (both adopt peer streams into their own ShmObjectStore)."""
    kind, target = store.begin_adopt(oid, total)
    view = target if kind == "arena" else None
    try:
        _drain_frames(conn, total, timeout, sink_view=view,
                      sink_write=None if view is not None
                      else target.write)
    except BaseException:
        if view is not None:
            view.release()
        store.abort_adopt(oid, kind,
                          None if kind == "arena" else target)
        raise
    if view is not None:
        view.release()
    store.finish_adopt(oid, total, kind,
                       None if kind == "arena" else target)
    return True


def _peer_dial(address, authkey: bytes, oid: ObjectID, timeout: float):
    """Dial a daemon's peer listener, handshake, request oid; returns
    (conn, total_bytes) or None on any failure/miss (incl. a stale
    authkey after a head restart — AuthenticationError is ProcessError,
    NOT OSError). Caller closes."""
    from multiprocessing import AuthenticationError

    from ray_tpu_torch._private import protocol

    try:
        conn = Client(tuple(address), authkey=authkey)
    except (OSError, EOFError, ValueError, AuthenticationError):
        return None
    try:
        conn.send(protocol.make_wire_hello("peer"))
        if conn.recv() != ("ok",):
            conn.close()
            return None
        conn.send(("get", oid.binary()))
        if not conn.poll(timeout):
            conn.close()
            return None
        reply = conn.recv()
        if reply[0] == "miss":
            conn.close()
            return None
        return conn, reply[1]
    except (OSError, EOFError, ValueError, AuthenticationError):
        try:
            conn.close()
        except Exception:
            pass
        return None


def peer_pull_once(address, authkey: bytes, store, oid: ObjectID,
                   timeout: float) -> bool:
    """One-shot chunked pull of an object from a node daemon's peer
    listener into `store` (the HEAD's fetch path — daemons keep cached
    per-peer connections instead, see NodeDaemon.pull_from_peer).
    Returns True when the object is locally resident afterwards."""
    if store.contains(oid):
        return True
    dialed = _peer_dial(address, authkey, oid, timeout)
    if dialed is None:
        return False
    conn, total = dialed
    try:
        return recv_object_into_store(conn, store, oid, total, timeout)
    except (OSError, EOFError, ValueError):
        return False
    finally:
        try:
            conn.close()
        except Exception:
            pass


def peer_pull_bytes(address, authkey: bytes, oid: ObjectID,
                    timeout: float) -> Optional[bytearray]:
    """Chunked pull into ONE preallocated buffer (for heads with no
    shm arena — thread mode): the frames land via recv_bytes_into, so
    neither side ever materializes the object as a single pickled
    message and the daemon's control link stays untouched."""
    dialed = _peer_dial(address, authkey, oid, timeout)
    if dialed is None:
        return None
    conn, total = dialed
    try:
        buf = bytearray(total)
        _drain_frames(conn, total, timeout, sink_view=memoryview(buf))
        return buf
    except (OSError, EOFError, ValueError):
        return None
    finally:
        try:
            conn.close()
        except Exception:
            pass


class PullManager:
    """Priority-ordered peer pulls (reference: the object manager's
    PullManager, src/ray/object_manager/pull_manager.cc — get > wait >
    task-arg request priority, bounded concurrent transfers).

    Every peer pull enqueues here; a fixed pool of puller threads
    drains the heap strictly by (priority, arrival). A blocking user
    get therefore jumps ahead of queued task-argument prefetches, and
    per-link memory stays bounded by num_threads transfers x one
    chunk."""

    PRIO_GET, PRIO_WAIT, PRIO_ARG = 0, 1, 2

    def __init__(self, transfer, num_threads: int = 2, on_pulled=None):
        import collections

        self._transfer = transfer      # (address, oid_bin) -> bool
        # invoked with oid_bin after every SUCCESSFUL transfer (staged
        # prefetches and blocking pulls alike) — the daemon reports the
        # new local copy to the head's object directory through it
        self._on_pulled = on_pulled
        self._heap: list = []
        self._cv = threading.Condition()
        self._seq = 0
        self._stop = False
        # duplicate pulls of one object COALESCE: only the first
        # enqueues a transfer, later callers wait on its outcome — two
        # threads racing begin_adopt for the same oid would otherwise
        # corrupt a shared spill temp file or misreport "lost"
        self._inflight: Dict[bytes, list] = {}
        # bounded observability ring (a daemon lives for days)
        self.serviced: Any = collections.deque(maxlen=1024)
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"ray_tpu_pull_{i}")
            for i in range(num_threads)]
        for t in self._threads:
            t.start()

    def _enqueue_locked(self, priority: int, address, oid_bin: bytes,
                        done, slot) -> None:
        """Push a transfer onto the heap and wake a puller. Caller
        holds self._cv (the heap, _seq, and _inflight move together) —
        checked dynamically under RAY_TPU_TORCH_DEBUG_LOCKS=1."""
        import heapq

        assert_holds(self._cv, "PullManager heap")
        self._inflight[oid_bin] = []
        self._seq += 1
        heapq.heappush(self._heap, (priority, self._seq,
                                    tuple(address), oid_bin, done, slot))
        self._cv.notify()

    def pull(self, address, oid_bin: bytes, priority: int) -> bool:
        """Blocking: enqueue (or join the in-flight pull of the same
        object) and wait for the outcome."""
        done = threading.Event()
        slot = [False]
        with self._cv:
            waiters = self._inflight.get(oid_bin)
            if waiters is not None:
                waiters.append((done, slot))
            else:
                self._enqueue_locked(priority, address, oid_bin, done,
                                     slot)
        done.wait()
        return slot[0]

    def prefetch(self, address, oid_bin: bytes, priority: int) -> None:
        """Fire-and-forget: enqueue a pull without waiting for it
        (dispatch-time arg staging). A pull of the same object already
        in flight coalesces to a no-op; a later blocking pull() of the
        object joins this transfer's waiters as usual."""
        with self._cv:
            if oid_bin in self._inflight:
                return
            self._enqueue_locked(priority, address, oid_bin,
                                 threading.Event(), [False])

    def _run(self) -> None:
        import heapq

        while True:
            with self._cv:
                while not self._heap and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                prio, _seq, address, oid_bin, done, slot = heapq.heappop(
                    self._heap)
                self.serviced.append((prio, oid_bin))
            try:
                ok = bool(self._transfer(address, oid_bin))
            except BaseException:
                ok = False
            with self._cv:
                waiters = self._inflight.pop(oid_bin, [])
            slot[0] = ok
            done.set()
            for d, s in waiters:
                s[0] = ok
                d.set()
            if ok and self._on_pulled is not None:
                try:
                    self._on_pulled(oid_bin)
                except Exception:
                    pass  # reporting must never kill a puller thread

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()


class NodeDaemon:
    def __init__(self, head_address, head_authkey: bytes,
                 node_token: str, object_store_memory: int,
                 inline_max: int, spill_dir: Optional[str] = None,
                 join_info: Optional[dict] = None,
                 rejoin_timeout_s: float = 20.0):
        from ray_tpu_torch._private.runtime.shm_store import ShmObjectStore

        self.store = ShmObjectStore(object_store_memory,
                                    spill_dir=spill_dir)
        self.inline_max = inline_max
        self._slots: Dict[int, _WorkerSlot] = {}
        self._lock = threading.Lock()
        self._shutdown = False
        self._head_address = tuple(head_address)
        self._head_authkey = head_authkey
        self._node_info = dict(join_info or {})
        # whether this node's workers see the card travels with the node
        # info: the head offers the node's GPUs only then
        self._node_info["gpu_access"] = _workers_see_card(self._node_info)
        # control-plane FT: a lost head connection WITHOUT an explicit
        # exit leaves this node orphaned-but-alive; it re-dials the head
        # address (same cluster secret, persisted beside the head's GCS
        # journal) for this long before giving up. Workers — and actor
        # STATE living in their processes — survive the head restart.
        self._rejoin_timeout_s = rejoin_timeout_s

        # log plane: this node's capture directory. The head points it
        # somewhere meaningful via RAY_TPU_TORCH_LOG_DIR when it spawns us
        # (same-host clusters nest it under the head's session dir);
        # self-started daemons get their own session dir. Workers'
        # stdout/stderr land here, a tailer ships appended lines to
        # the head, and log_list/log_read queries read from here.
        from ray_tpu_torch._private import log_plane

        env_dir = os.environ.get("RAY_TPU_TORCH_LOG_DIR", "")
        self.log_dir = log_plane.resolve_session_log_dir(env_dir)
        try:
            self._log_rotate = int(os.environ.get(
                log_plane.ENV_LOG_ROTATE_BYTES, "0") or 0)
            self._log_backups = int(os.environ.get(
                log_plane.ENV_LOG_ROTATE_BACKUPS, "0") or 0)
        except ValueError:
            self._log_rotate, self._log_backups = 0, 0
        if not self._log_rotate:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            self._log_rotate = GLOBAL_CONFIG.log_rotation_bytes
            self._log_backups = GLOBAL_CONFIG.log_rotation_backups
        self._log_offsets: Dict[str, int] = {}

        # workers dial this daemon, never the head (they may share no
        # filesystem/host with it)
        self._authkey = os.urandom(16)
        self._sock_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_node_")
        # a deep backlog, as the head's pools have: every worker dials
        # twice, and a burst of workers overflows a backlog of 1
        from ray_tpu_torch._private.runtime.process_pool import DIAL_BACKLOG

        self._listener = Listener(
            address=os.path.join(self._sock_dir, "node.sock"),
            family="AF_UNIX", authkey=self._authkey, backlog=DIAL_BACKLOG)

        # peer transfer plane (reference: the object manager's
        # node-to-node Pull/Push protocol, ray: src/ray/object_manager/
        # — bytes move DIRECTLY between the producing and consuming
        # nodes; the head only answers "who has it"). The cluster
        # secret (head authkey) guards peer connections too.
        import socket

        self._peer_authkey = head_authkey
        self._peer_listener = Listener(("0.0.0.0", 0),
                                       authkey=head_authkey)
        # advertise the address peers can reach: the local IP of our
        # route to the head (localhost clusters advertise 127.0.0.1).
        # UDP connect: routes without sending a packet — a TCP probe
        # would hit the head's authenticated listener and poison its
        # accept loop with a failed HMAC challenge
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect(tuple(head_address))
            local_ip = probe.getsockname()[0]
        except OSError:
            local_ip = "127.0.0.1"
        finally:
            probe.close()
        self.peer_address = (local_ip, self._peer_listener.address[1])
        self._peer_conns: Dict[tuple, Any] = {}
        self._peer_lock = threading.Lock()
        self.pulls = PullManager(self.pull_from_peer,
                                 on_pulled=self._report_pulled)
        self._peer_accept_thread = threading.Thread(
            target=self._peer_accept_loop, daemon=True,
            name="ray_tpu_node_peer_accept")
        self._peer_accept_thread.start()
        self._accept_thread: Optional[threading.Thread] = None

        # two-level dispatch state (bottom-up scheduler + p2p actors).
        # Everything defaults OFF: until the head pushes a resview the
        # daemon is a pure forwarder, byte-for-byte pre-two-level.
        self._resview: Dict[str, Any] = {}
        self._resview_lock = threading.Lock()
        self._resview_v = 0                # adopted view version
        self._resident_digest: frozenset = frozenset()
        self._chaos_snapshot: Optional[dict] = None
        self._local_tids: set = set()      # locally-admitted, in flight
        self._local_dispatched = 0
        # locally-admitted lease bodies retained for LOCAL retries:
        # tid -> {payload, info, attempt, max_retries, arg_refs}. A
        # worker death re-leases an unfinished entry to a sibling
        # worker (attempt+1) up to max_retries; the entry dies with
        # the task's done/err
        self._local_leases: Dict[bytes, dict] = {}
        # p2p actor plane: head-resolved routes, per-actor task-id
        # minting salts, A-side in-flight calls, per-peer actor lanes,
        # and B-side pending executions awaiting their result send
        self._actor_routes: Dict[bytes, tuple] = {}
        self._aresolve_last: Dict[bytes, float] = {}
        # peer addresses the head declared DEAD (("node_dead", info)
        # broadcast): their gossiped views are ghosts — never adopt
        # one, never gossip to them. Entries clear when a head-pushed
        # view re-lists the address (the node rejoined).
        self._dead_peers: set = set()
        self._actor_salts: Dict[bytes, list] = {}
        self._p2p_calls: Dict[bytes, dict] = {}
        self._p2p_lanes: Dict[tuple, dict] = {}
        self._p2p_pending: Dict[bytes, tuple] = {}
        self._p2p_lock = threading.Lock()

        # report-class messages are sequenced through the outbox so a
        # head blackout loses nothing (see module docstring)
        self._outbox = _Outbox()
        # a completion's lease leaves the worker's in-flight set and
        # enters the outbox under this lock, and the rejoin hello reads
        # both under it: a lease is always in one of the two
        self._completion_lock = threading.Lock()
        self._head = Client(head_address, authkey=head_authkey)
        self._head_lock = threading.Lock()
        # arena name travels in the hello so the head can reap the
        # segment if this daemon is SIGKILLed (machine-death chaos).
        # token "join" = self-started daemon (_main with token "join"):
        # declared resources travel too and the head ADOPTS the node.
        # The peer transfer address rides at the tuple tail.
        from ray_tpu_torch._private.protocol import make_wire_hello

        if node_token == "join":
            self._head.send(make_wire_hello(
                "join", os.getpid(), self.store.arena.name,
                dict(self._node_info), tuple(self.peer_address)))
        else:
            self._head.send(make_wire_hello(
                node_token, os.getpid(), self.store.arena.name,
                tuple(self.peer_address)))
        # clock handshake: one wall/perf sample right after the hello;
        # the head derives clock_offset = head_wall - daemon_wall so
        # worker-side execution windows land on the head's time axis
        self._head.send(("clock", time.time(), time.perf_counter()))

    # ------------------------------------------------------------------
    def _report_pulled(self, oid_bin: bytes) -> None:
        """A peer pull landed locally: tell the head so the object
        directory gains this node as a SECONDARY location (runs on
        puller threads; _send_head serializes under _head_lock)."""
        self._send_head(("pulled", oid_bin))

    def _send_head(self, msg: tuple, meta=None) -> None:
        """``meta``: the outbox entry's note (see _Outbox)."""
        if msg[0] in _OUTBOX_TAGS:
            # report-class: buffer first, THEN try to send — a failed
            # send just leaves the entry in the outbox for the rejoin
            # replay (exactly-once: the head dedups by sequence). The
            # sequence number and the send share one hold of the link's
            # lock: the head drops any seq at or below the highest it
            # has seen, so two threads that took seq n and n+1 must not
            # put them on the wire as n+1, n (n would be lost)
            with self._head_lock:
                seq, depth = self._outbox.append(msg, meta)
                self._send_locked(("seq", seq, depth, False, msg))
        else:
            self._send_head_raw(msg)

    def _send_head_raw(self, msg: tuple) -> None:
        with self._head_lock:
            self._send_locked(msg)

    def _send_locked(self, msg: tuple) -> None:
        """Send on the head link; the caller holds _head_lock."""
        try:
            self._head.send(msg)
        except (OSError, ValueError):
            # head gone: outbox entries replay on rejoin; bare
            # request/reply traffic is moot (its requester died with
            # the link) and the main loop handles reconnecting
            pass

    def _replay_outbox_locked(self) -> None:
        """Re-send every unacked report to the (re)joined head, flagged
        as replay; the caller holds _head_lock, so no fresh report goes
        out ahead of the replay. The head processes entries it has
        never seen and drops duplicates by sequence number — a flap
        mid-replay just triggers another (still deduped) replay on the
        next rejoin."""
        pending = self._outbox.pending()
        for i, (seq, msg) in enumerate(pending):
            self._send_locked(("seq", seq, len(pending) - i, True, msg))

    # ------------------------------------------------------------------
    # worker lifecycle
    # ------------------------------------------------------------------
    def _spawn(self, num: int, wid_hex: Optional[str] = None) -> None:
        slot = _WorkerSlot(num)
        with self._lock:
            self._slots[num] = slot
        # workers see the card only on a node that declared GPUs under
        # worker_gpu_access (_workers_see_card); the daemon itself never
        # touches it
        from ray_tpu_torch._private import log_plane, spawn_env
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.runtime.worker_process import (
            AUTHKEY_ENV, PROFILE_HZ_ENV)
        extra = {AUTHKEY_ENV: self._authkey.hex()}
        if GLOBAL_CONFIG.profile_hz > 0:
            # propagate the head's profile knob (this daemon got it the
            # same way, via its own spawn env) so remote workers sample
            extra[PROFILE_HZ_ENV] = str(GLOBAL_CONFIG.profile_hz)
        stem = (f"worker-{wid_hex}" if wid_hex
                else f"worker-{num}-{os.getpid()}")
        log_env = log_plane.child_log_env(
            self.log_dir, stem, self._log_rotate, self._log_backups)
        slot.err_path = log_env.get(log_plane.ENV_LOG_ERR)
        extra.update(log_env)
        env = spawn_env.child_env(
            use_accelerator=_workers_see_card(self._node_info),
            extra=extra)
        slot.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.runtime.worker_process",
             self._listener.address, self.store.arena.name,
             str(self.inline_max), str(num)],
            env=env, close_fds=True)
        slot.pid = slot.proc.pid
        threading.Thread(target=self._monitor, args=(slot,), daemon=True,
                         name=f"ray_tpu_node_monitor_{num}").start()

    def _monitor(self, slot: _WorkerSlot) -> None:
        slot.proc.wait()
        if slot.conn is not None:
            # completions the worker emitted just before dying may
            # still sit buffered on its pipe: wait for the reader to
            # drain to EOF so a finished task is never retried
            slot.reader_done.wait(1.0)
        with self._lock:
            gone = self._slots.pop(slot.num, None)
        if gone is not None and not self._shutdown:
            from ray_tpu_torch._private import log_plane

            # local retries FIRST: the outbox FIFO lands each
            # ("local_retry", ...) before the worker_died report, so
            # the head re-homes those adopted leases instead of
            # failing them with the rest of the dead worker's inflight
            self._retry_local_leases(slot)
            tail = log_plane.err_tail_message(slot.err_path)
            self._send_head(("worker_died", slot.num,
                             slot.proc.returncode, tail))

    def _retry_local_leases(self, slot: _WorkerSlot) -> None:
        """Per-attempt accounting for locally-dispatched leases
        (tentpole: retry-carrying tasks dispatch locally): every
        unfinished local lease on a dead worker re-leases to a sibling
        worker with attempt+1, as long as admission still holds
        (attempts left, arg bytes still resident, a live slot exists).
        Anything else falls through to the head's worker_died handling
        — the head owns terminal failure and lineage reconstruction."""
        with self._resview_lock:
            accept = bool(self._resview.get("accept"))
        for tid_bin in list(slot.returns):
            lease = self._local_leases.get(tid_bin)
            if lease is None:
                continue  # head-placed: the head's retry policy runs
            slot.returns.pop(tid_bin, None)
            slot.attempts.pop(tid_bin, None)
            attempt = int(lease.get("attempt", 0)) + 1
            target = None
            if (accept and attempt <= int(lease.get("max_retries", 0))
                    and self._refs_resident(lease.get("arg_refs"))):
                target = self._pick_local_slot(slot)
            if target is None:
                # exhausted / args gone / no slot: release the lease;
                # the worker_died report reaches the head with this
                # tid still adopted and the head fails or rebuilds it
                self._local_leases.pop(tid_bin, None)
                with self._resview_lock:
                    self._local_tids.discard(tid_bin)
                continue
            lease["attempt"] = attempt
            payload = dict(lease["payload"], attempt=attempt)
            info = dict(lease["info"], worker_num=target.num,
                        attempt=attempt, t=time.time())
            lease["info"] = info
            target.returns[tid_bin] = list(payload["return_ids"])
            target.attempts[tid_bin] = attempt
            self._send_head(("local_retry", tid_bin, info))
            self._to_worker(target, ("task", payload))

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
                    conn.send(protocol.mismatch_error("node daemon", ver))
                except (OSError, ValueError):
                    pass
                conn.close()
                continue
            num, kind = fields
            with self._lock:
                slot = self._slots.get(num)
            if slot is None:
                conn.close()
                continue
            if kind == "task":
                with slot.send_lock:
                    slot.conn = conn
                    early, slot.early = slot.early, []
                    for m in early:
                        try:
                            conn.send(m)
                        except (OSError, ValueError):
                            break
                threading.Thread(target=self._worker_reader,
                                 args=(slot,), daemon=True,
                                 name=f"ray_tpu_node_reader_{num}").start()
            else:
                slot.ctrl = conn

    # ------------------------------------------------------------------
    # worker -> head forwarding, with node-local interception
    # ------------------------------------------------------------------
    def _worker_reader(self, slot: _WorkerSlot) -> None:
        try:
            while True:
                try:
                    msg = slot.conn.recv()
                except (EOFError, OSError):
                    return  # _monitor reports the death
                if msg[0] in ("done", "err"):
                    self._forward_completion(slot, msg)
                    continue
                out = self._intercept(slot, msg)
                if out is not None:
                    self._send_head(("w", slot.num, out))
        finally:
            slot.reader_done.set()  # buffered completions all drained

    def _forward_completion(self, slot: _WorkerSlot, msg: tuple) -> None:
        """A worker's done/err to the head. Its lease leaves the slot's
        in-flight set (``_intercept``) and enters the outbox with the
        report under one hold of _completion_lock, noted with the lease
        until the head acks the report: a head restarted before then
        learns of the lease from the rejoin hello, adopts it, and the
        replayed report resolves it (without the note the lease would
        be in neither, and the new head would run the task again)."""
        tid = msg[1]
        with self._completion_lock:
            rbins = slot.returns.get(tid)
            meta = None if rbins is None else {
                "num": slot.num, "tid": tid, "returns": list(rbins),
                "attempt": slot.attempts.get(tid, 0)}
            out = self._intercept(slot, msg)
            if out is not None:
                self._send_head(("w", slot.num, out), meta)

    def _intercept(self, slot: _WorkerSlot, msg: tuple) -> Optional[tuple]:
        """Serve node-local object-plane ops; rewrite sealed returns.
        Returns the message to forward to the head, or None if fully
        handled here."""
        kind = msg[0]
        if kind == "rpc":
            _, req_id, op, args = msg
            if op == "create":
                oid_bin, nbytes = args
                try:
                    offset = self.store.create(ObjectID(oid_bin), nbytes)
                    reply = ("reply", req_id, True, offset)
                except BaseException as e:  # noqa: BLE001
                    import cloudpickle
                    reply = ("reply", req_id, False, cloudpickle.dumps(e))
                self._to_worker(slot, reply)
                return None
            if op == "put":
                oid_bin, loc = args
                if loc[0] == "shm":
                    # seal here; the head records the location only
                    self.store.seal(ObjectID(oid_bin))
                    return ("rpc", req_id, "put",
                            (oid_bin, ("remote_shm", loc[2])))
                return msg
            if op == "get":
                oid_bins, timeout = args[0], args[1]
                purpose = args[2] if len(args) > 2 else "get"
                locs = []
                for b in oid_bins:
                    loc = self.store.locate(ObjectID(b))
                    if loc is None:
                        # something not arena-resident (unsealed, spilled,
                        # exception, or remote): the head decides; its
                        # reply may point back here via node_shm markers
                        slot.gets[req_id] = purpose
                        return ("rpc", req_id, "get",
                                (oid_bins, timeout))
                    locs.append(("shm", loc[0], loc[1]))
                self._to_worker(slot, ("reply", req_id, True, locs))
                return None
            if op == "submit":
                return self._maybe_local_submit(slot, req_id, args)
            if op == "actor_call":
                return self._maybe_p2p_call(slot, req_id, args)
            return msg
        if kind == "ready":
            # late-attaching worker: advertise the currently-enabled
            # two-level lanes (workers alive at resview time get the
            # advert through _apply_resview's broadcast instead)
            with self._resview_lock:
                accept = bool(self._resview.get("accept"))
                p2p = bool(self._resview.get("p2p"))
            if accept or p2p:
                self._to_worker(slot, ("p2p", accept, p2p))
            return msg
        if kind in ("done",):
            task_id_bin, entries = msg[1], msg[2]
            with self._p2p_lock:
                p2p = self._p2p_pending.pop(task_id_bin, None)
            if p2p is not None:
                self._finish_p2p_exec(slot, task_id_bin, p2p, msg)
                return None
            return_bins = slot.returns.pop(task_id_bin, [])
            slot.attempts.pop(task_id_bin, None)
            out = []
            for i, entry in enumerate(entries):
                if entry[0] == "shm" and i < len(return_bins):
                    rid = ObjectID(return_bins[i])
                    if self.store.locate(rid) is None:
                        # a dedup re-emission (p2p attempt already ran
                        # here) replays already-sealed entries; sealing
                        # twice would corrupt the arena accounting
                        self.store.seal(rid)
                    out.append(("remote_shm", entry[2]))
                else:
                    out.append(entry)
            with self._resview_lock:
                self._local_tids.discard(task_id_bin)
            self._local_leases.pop(task_id_bin, None)
            # preserve any trailing fields (e.g. the execution-window
            # timing tuple the task event plane rides on)
            return (msg[0], task_id_bin, out) + tuple(msg[3:])
        if kind == "err":
            with self._p2p_lock:
                p2p = self._p2p_pending.pop(msg[1], None)
            if p2p is not None:
                self._finish_p2p_exec(slot, msg[1], p2p, msg)
                return None
            slot.returns.pop(msg[1], None)
            slot.attempts.pop(msg[1], None)
            with self._resview_lock:
                self._local_tids.discard(msg[1])
            self._local_leases.pop(msg[1], None)
        return msg

    def _serve_fetch(self, fid: int, oid_bin: bytes) -> None:
        sobj = self.store.get_serialized(ObjectID(oid_bin))
        if sobj is None:
            self._send_head(("fetched", fid, False, None))
        else:
            self._send_head(("fetched", fid, True, sobj.to_bytes()))

    # ------------------------------------------------------------------
    # log plane: queries + tailer (ship appended lines to the head)
    # ------------------------------------------------------------------
    def _serve_log_list(self, rid: int) -> None:
        from ray_tpu_torch._private import log_plane

        self._send_head(("log_listed", rid,
                         log_plane.list_log_files(self.log_dir)))

    def _serve_log_read(self, rid: int, filename: str,
                        tail: Optional[int]) -> None:
        from ray_tpu_torch._private import log_plane

        try:
            text = log_plane.read_log(self.log_dir, filename, tail)
            self._send_head(("log_data", rid, True, text))
        except (OSError, ValueError) as e:
            self._send_head(("log_data", rid, False, str(e)))

    def _log_tail_loop(self) -> None:
        """Ship appended capture-file lines to the head every ~0.3s.

        Reads bytes past the last shipped offset per file, splits
        complete lines and batches them as ("log", fname, lines). The
        head's LogMonitor attributes and re-emits them; when log
        streaming is off the head just drops them. Partial trailing
        lines stay unshipped until their newline arrives (and a
        bounded per-tick read keeps one spamming worker from wedging
        the daemon's send lock)."""
        import time as _time

        while not self._shutdown:
            _time.sleep(0.3)
            try:
                names = sorted(os.listdir(self.log_dir))
            except OSError:
                continue
            for n in names:
                if not (n.endswith(".out") or n.endswith(".err")):
                    continue
                path = os.path.join(self.log_dir, n)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    continue
                pos = self._log_offsets.get(n, 0)
                if size < pos:  # rotated underneath us
                    pos = 0
                if size == pos:
                    continue
                try:
                    with open(path, "rb") as f:
                        f.seek(pos)
                        data = f.read(1 << 20)
                except OSError:
                    continue
                last_nl = data.rfind(b"\n")
                if last_nl < 0:
                    self._log_offsets[n] = pos
                    continue
                self._log_offsets[n] = pos + last_nl + 1
                lines = data[:last_nl].decode(
                    "utf-8", "replace").split("\n")
                if lines:
                    self._send_head(("log", n, lines))

    # utilization sampling (profile plane, profile_hz > 0 only)
    # ------------------------------------------------------------------
    def _ship_util(self, payload: dict) -> None:
        """One resource sample for the head's utilization ring. "util"
        is report-class (rides the outbox), so samples taken during a
        head blackout land, deduped and in order, after rejoin."""
        self._send_head(("util", payload))

    def _start_util_sampler(self) -> None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        if GLOBAL_CONFIG.profile_hz <= 0 \
                or GLOBAL_CONFIG.utilization_interval_s <= 0:
            return
        from ray_tpu_torch._private import profile_plane

        store = self.store

        def _arena_used() -> int:
            return max(store.arena.size - store.arena.free_bytes(), 0)

        self._util_sampler = profile_plane.ResourceSampler(
            GLOBAL_CONFIG.utilization_interval_s, self._ship_util,
            gauges={"arena_used_bytes": _arena_used},
            name="ray_tpu_node_util").start()

    # ------------------------------------------------------------------
    # peer transfer plane (direct node-to-node pulls)
    # ------------------------------------------------------------------
    def _peer_accept_loop(self) -> None:
        from multiprocessing import AuthenticationError

        while not self._shutdown:
            try:
                conn = self._peer_listener.accept()
            except AuthenticationError:
                continue  # bad-key dial must not kill the peer plane
            except (OSError, EOFError):
                return
            threading.Thread(target=self._peer_serve, args=(conn,),
                             daemon=True,
                             name="ray_tpu_node_peer_serve").start()

    def _peer_serve(self, conn) -> None:  # noqa: D401
        """One persistent connection per consuming peer: a versioned
        hello first, then get requests served out of the local
        arena/spill tier in ~1 MB frames — a multi-GB object never
        materializes as one message on either side (reference:
        src/ray/object_manager/ chunked push via ObjectBufferPool)."""
        from ray_tpu_torch._private import protocol

        try:
            try:
                hello = conn.recv()
            except (EOFError, OSError):
                return
            # the peer plane speaks the proto3 envelope (wire.proto);
            # legacy tuple hellos still parse so skew fails cleanly
            ver, _fields = protocol.split_any_hello(hello)
            if ver != protocol.PROTOCOL_VERSION:
                try:
                    # schema'd rejection: the Reject envelope is what a
                    # cross-language dialer can actually parse
                    conn.send(protocol.proto_reject(
                        protocol.mismatch_error("peer plane", ver)[1]))
                except (OSError, ValueError):
                    pass
                return
            try:
                conn.send(("ok",))
            except (OSError, ValueError):
                return
            # one send lock per serving connection: chunked object
            # streams (this thread) and async ("ares", ...) result
            # frames (worker-reader threads, p2p exec) share the pipe,
            # and interleaved frames would desynchronize the protocol
            send_lock = threading.Lock()
            hdr_cache: Dict[int, tuple] = {}
            while not self._shutdown:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                if not (isinstance(msg, tuple) and msg):
                    return
                if msg[0] == "get":
                    with send_lock:
                        ok = self._peer_send_object(conn, ObjectID(msg[1]))
                    if not ok:
                        return
                elif msg[0] == "acall":
                    # p2p actor-call frame: lease-envelope encoded
                    # payloads dispatched straight to the resident
                    # actor worker; results return on THIS connection
                    self._serve_acall(conn, send_lock, hdr_cache, msg[1])
                elif msg[0] == "rview":
                    # peer-gossiped resource view: adopt if strictly
                    # fresher (same head epoch) so local admission
                    # stays current through a slow/rejoining head
                    self._apply_resview(msg[1], from_peer=True)
                else:
                    return
        finally:
            try:
                conn.close()
            except Exception:
                pass

    def _peer_send_object(self, conn, oid: ObjectID) -> bool:
        """("meta", total) + raw ~1 MB frames; arena objects stream
        zero-copy from the pinned range, spilled objects stream from
        their file. Returns False on a dead connection."""
        CH = PEER_CHUNK
        view = self.store.acquire_raw(oid)
        if view is not None:
            try:
                total = len(view)
                conn.send(("meta", total))
                for off in range(0, total, CH):
                    conn.send_bytes(view[off:off + CH])
                return True
            except (OSError, ValueError):
                return False
            finally:
                view.release()
                self.store.release_raw(oid)
        spilled = self.store.spilled_path(oid)
        if spilled is not None:
            path, total = spilled
            try:
                f = open(path, "rb")
            except OSError as e:
                # nothing streamed yet: a miss reply keeps the
                # connection usable
                try:
                    conn.send(("miss", str(e)))
                    return True
                except (OSError, ValueError):
                    return False
            try:
                conn.send(("meta", total))
                while True:
                    chunk = f.read(CH)
                    if not chunk:
                        break
                    conn.send_bytes(chunk)
                return True
            except OSError:
                # MID-STREAM failure: the chunk protocol is now
                # desynchronized — kill the connection deliberately
                # (injecting a control frame would reach the receiver
                # as a corrupt chunk); the puller redials fresh
                return False
            finally:
                f.close()
        try:
            conn.send(("miss", None))
            return True
        except (OSError, ValueError):
            return False

    def pull_from_peer(self, address: tuple,
                       oid_bin: bytes) -> bool:
        """Pull an object from the producing node's daemon into THIS
        node's store, ~1 MB frames at a time: arena-resident when it
        fits, streamed straight to the spill tier when it doesn't — a
        >arena-sized object transfers without either side holding it
        whole (reference: PullManager + ObjectBufferPool chunking).
        Returns True when the object is locally resident afterwards.

        Connections cache per peer with a per-peer lock
        (a stalled peer must not wedge pulls from OTHER peers), replies
        are awaited under the transfer timeout, and a dead cached
        connection gets ONE fresh redial — after that the producer is
        treated as unreachable (the head-relay path would be talking to
        the same dead daemon)."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        address = tuple(address)
        timeout = GLOBAL_CONFIG.object_transfer_timeout_s
        with self._peer_lock:
            entry = self._peer_conns.get(address)
            if entry is None:
                entry = [None, threading.Lock()]
                self._peer_conns[address] = entry
        from ray_tpu_torch._private import protocol

        oid = ObjectID(oid_bin)
        if self.store.contains(oid):
            return True  # a concurrent pull already landed it
        for _attempt in (0, 1):
            with entry[1]:
                try:
                    if entry[0] is None:
                        c = Client(address, authkey=self._peer_authkey)
                        c.send(protocol.make_wire_hello("peer"))
                        ack = c.recv()
                        if ack != ("ok",):
                            # version rejection: log the peer's reason
                            import logging
                            logging.getLogger(__name__).error(
                                "peer %s rejected us: %s", address, ack)
                            c.close()
                            return False
                    entry[0] = c if entry[0] is None else entry[0]
                    conn = entry[0]
                    conn.send(("get", oid_bin))
                    if not conn.poll(timeout):
                        raise OSError("peer reply timed out")
                    reply = conn.recv()
                    if reply[0] == "miss":
                        return False
                    total = reply[1]
                    return self._recv_object(conn, oid, total, timeout)
                except (OSError, EOFError, ValueError):
                    # drop the (possibly dead) connection; the second
                    # attempt dials fresh
                    try:
                        if entry[0] is not None:
                            entry[0].close()
                    except Exception:
                        pass
                    entry[0] = None
        return False

    def _recv_object(self, conn, oid: ObjectID, total: int,
                     timeout: float) -> bool:
        return recv_object_into_store(conn, self.store, oid, total,
                                      timeout)

    def _localize(self, loc: tuple, priority: int = 0) -> tuple:
        """Rewrite a head get-reply entry: ("node_shm", oid) points at
        THIS node's store (zero-copy arena location / spill restore);
        ("peer", oid, address) directs a DIRECT pull from the producing
        node's daemon — the bytes never touch the head. Peer pulls go
        through the priority pull manager (get > wait > task-arg) and
        land in the LOCAL store, so the worker reads the result
        zero-copy from the arena (or from the spill file for objects
        bigger than the arena)."""
        if not (isinstance(loc, tuple) and loc):
            return loc
        if loc[0] == "peer":
            oid = ObjectID(loc[1])
            if self.pulls.pull(loc[2], loc[1], priority):
                return self._local_loc(oid)
            return self._lost(oid)
        if loc[0] != "node_shm":
            return loc
        return self._local_loc(ObjectID(loc[1]))

    def _local_loc(self, oid: ObjectID) -> tuple:
        """A worker-readable location for a locally-resident object."""
        arena_loc = self.store.locate(oid)
        if arena_loc is not None:
            return ("shm", arena_loc[0], arena_loc[1])
        spilled = self.store.spilled_path(oid)
        if spilled is not None:
            # same host: the worker reads the spill file itself — a
            # >arena-sized object never rides the pipe as one message
            return ("spill_file", spilled[0], spilled[1])
        sobj = self.store.get_serialized(oid)
        if sobj is not None:
            return ("inline", sobj.to_bytes())
        return self._lost(oid)

    def _localize_reply(self, slot, req_id, locs, priority: int) -> None:
        self._to_worker(slot, ("reply", req_id, True,
                               [self._localize(lc, priority)
                                for lc in locs]))

    def _lost(self, oid: ObjectID) -> tuple:
        import cloudpickle

        from ray_tpu_torch import exceptions as rex
        return ("exc", cloudpickle.dumps(
            rex.ObjectLostError(oid.hex())))

    def _to_worker(self, slot: _WorkerSlot, msg: tuple) -> None:
        try:
            with slot.send_lock:
                if slot.conn is None:
                    slot.early.append(msg)  # sent when it dials in
                    return
                slot.conn.send(msg)
        except (OSError, ValueError):
            pass

    # ------------------------------------------------------------------
    # two-level dispatch: node-local submission queue (tentpole a)
    # ------------------------------------------------------------------
    def _apply_resview(self, view: dict, from_peer: bool = False) -> None:
        """Head-pushed (or peer-gossiped) resource view: gates local
        admission (accept/cap), records the residency digest for
        ref-arg admission, advertises the p2p actor lane to this
        node's workers, and mirrors the head's armed chaos plan so
        daemon-hosted sites (peer_link) fire at their seeded arrivals
        on the process that actually owns them.

        Gossiped views adopt only on a STRICTLY newer version — the
        head's direct push stays the authoritative tiebreaker — and
        keep this node's own node-scoped fields (node index, residency
        digest): a peer's digest describes the peer's arena."""
        if from_peer:
            # ghost-view eviction: the head declared the gossiping
            # node dead — a view it shipped pre-death (arriving late
            # over a still-draining lane) must never gate admission
            origin = view.get("from")
            with self._p2p_lock:
                if origin is not None \
                        and tuple(origin) in self._dead_peers:
                    return
        else:
            # a head-pushed peers list re-listing an address clears
            # its death mark (the node rejoined under a fresh daemon)
            listed = {tuple(p) for p in view.get("peers") or ()}
            if listed:
                with self._p2p_lock:
                    self._dead_peers -= listed
        with self._resview_lock:
            if from_peer:
                # same head instance (epoch) and strictly newer only:
                # a restarted head's fresh v=1 push must never lose to
                # a peer still gossiping the dead head's high-v view
                if (view.get("e") != self._resview.get("e")
                        or int(view.get("v") or 0) <= self._resview_v):
                    return
                view = dict(view,
                            node=self._resview.get("node"),
                            resident=self._resview.get("resident"))
            prev = (bool(self._resview.get("accept")),
                    bool(self._resview.get("p2p")))
            self._resview = dict(view)
            self._resview_v = int(view.get("v") or 0)
            digest = view.get("resident")
            self._resident_digest = (frozenset(digest) if digest
                                     else frozenset())
            snap = view.get("chaos")
            chaos_changed = snap != self._chaos_snapshot
            if chaos_changed:
                self._chaos_snapshot = snap
        if chaos_changed:
            from ray_tpu_torch._private.chaos import get_controller
            try:
                get_controller().arm_snapshot(snap)
            except Exception:
                pass
        cur = (bool(view.get("accept")), bool(view.get("p2p")))
        if cur != prev:
            with self._lock:
                slots = [s for s in self._slots.values()
                         if s.conn is not None]
            for s in slots:
                self._to_worker(s, ("p2p", cur[0], cur[1]))

    def _pick_local_slot(self, submitter: _WorkerSlot):
        """Least-loaded live non-actor worker; then a sibling still
        starting (its lease waits in slot.early until it dials in); the
        submitter itself only as a last resort (it is busy running the
        submitting task, though its nested-execution loop would still
        make progress). Preferring a starting sibling keeps a nested
        task out of its submitter's process on a node whose workers are
        still coming up: run nested there, a crash of that task kills
        the submitter too, whose own retry then submits it again while
        the head resubmits the orphaned lease (run twice)."""
        with self._lock:
            cands = [s for s in self._slots.values()
                     if s.actor_bin is None
                     and s.proc is not None and s.proc.poll() is None
                     and (s.conn is not None or s.num != submitter.num)]
        if not cands:
            return None
        cands.sort(key=lambda s: (s.num == submitter.num,
                                  s.conn is None, len(s.returns)))
        return cands[0]

    def _refs_resident(self, refs) -> bool:
        """Every arg ObjectRef's bytes provably on this node: sealed
        in the local arena, or listed in the head-pushed object-
        directory residency digest (8-byte oid prefixes; a prefix
        false-positive just costs one head-served get at exec time)."""
        if not refs:
            return True
        with self._resview_lock:
            digest = self._resident_digest
        for b in refs:
            if self.store.contains(ObjectID(b)):
                continue
            if digest and bytes(b)[:8] in digest:
                continue
            return False
        return True

    def _maybe_local_submit(self, slot: _WorkerSlot, req_id: int,
                            args: tuple) -> Optional[tuple]:
        """LocalScheduler admission: a worker-originated nested
        submission whose demand fits this node is leased HERE — ids
        minted locally, the lease journaled at the head through the
        report-class outbox (so head-restart reconciliation and
        exactly-once dedup come for free), the payload dispatched to a
        sibling worker without any head round-trip. Retry-carrying
        tasks admit (the daemon re-leases failed attempts locally, see
        _retry_local_leases) and ref-carrying args admit when the
        bytes are provably on-node. Everything else spills upward,
        flagged with the REASON so the head counts per-reason
        spillback: the head scheduler stays the single placement
        authority for cross-node balancing, placement groups and
        non-resident deps."""
        import cloudpickle

        fwd = ("rpc", req_id, "submit", args)
        with self._resview_lock:
            view = self._resview
            accept = bool(view.get("accept"))
            cap = int(view.get("cap") or 0)
            job_bin = view.get("job")
            watermark = view.get("wm")
            depth = len(self._local_tids)
        if not accept or job_bin is None:
            return fwd

        def spill(reason: str) -> tuple:
            return ("rpc", req_id, "submit", (args[0], reason))

        if depth >= cap:
            # bounded local queue: overflow goes upward
            return spill("queue_full")
        try:
            d = cloudpickle.loads(args[0])
        except Exception:
            return fwd
        if watermark is not None \
                and int(d.get("priority") or 0) < int(watermark):
            # QoS top-spilled-tier watermark (config.qos): work at a
            # higher tier is still queued at the head, so locally
            # admitting this lower-tier task would let it jump the
            # line — spill upward and let the head's fair-share order
            # decide (the plane off pushes no "wm" key at all)
            return spill("tier")
        res = d.get("resources") or {}
        if d.get("pg_id") is not None:      # placement is the head's
            return spill("pg")
        if res and res != {"CPU": 1} and res != {"CPU": 1.0}:
            return spill("resources")
        arg_refs = list(d.get("arg_refs") or ())
        if d.get("has_refs") is not False:
            # ref-carrying args admit only when every dep's bytes are
            # provably resident (a pre-digest submitter advertises
            # has_refs without the ref list: spill, owner resolves)
            if not arg_refs or not self._refs_resident(arg_refs):
                return spill("refs")
        target = self._pick_local_slot(slot)
        if target is None:
            return spill("no_slot")
        from ray_tpu_torch._private.runtime.worker_process import fn_id_of

        tid = TaskID.of(JobID(job_bin))
        tid_bin = tid.binary()
        rids = [ObjectID.for_task_return(tid, i).binary()
                for i in range(d["num_returns"])]
        fn_blob = d["func_blob"]
        max_retries = int(d.get("max_retries") or 0)
        payload = {
            "task_id": tid_bin, "name": d.get("name"),
            "fn_id": fn_id_of(fn_blob), "fn_blob": fn_blob,
            "args_blob": d["args_blob"],
            "num_returns": d["num_returns"],
            "return_ids": rids, "attempt": 0,
        }
        parent = d.get("trace")
        if parent is not None and parent[3]:
            payload["trace"] = (parent[0], os.urandom(8).hex(),
                                parent[1], True)
        info = {
            "name": d.get("name"), "fn_blob": fn_blob,
            "args_blob": d["args_blob"],
            "num_returns": d["num_returns"], "returns": rids,
            "resources": dict(res), "worker_num": target.num,
            "submitter": slot.num, "trace": payload.get("trace"),
            "attempt": 0, "max_retries": max_retries,
            "arg_refs": arg_refs, "t": time.time(),
        }
        with self._resview_lock:
            self._local_tids.add(tid_bin)
            self._local_dispatched += 1
        if max_retries > 0:
            # retain the lease body so a worker death can re-lease the
            # attempt locally instead of consulting the head
            self._local_leases[tid_bin] = {
                "payload": payload, "info": info, "attempt": 0,
                "max_retries": max_retries, "arg_refs": arg_refs,
            }
        target.returns[tid_bin] = list(rids)
        target.attempts[tid_bin] = 0
        # lease report FIRST: outbox FIFO means the head always sees
        # the lease before the completion the target worker produces
        self._send_head(("local_lease", tid_bin, info))
        self._to_worker(target, ("task", payload))
        self._to_worker(slot, ("reply", req_id, True, rids))
        return None

    # ------------------------------------------------------------------
    # two-level dispatch: p2p actor plane (tentpole b)
    # ------------------------------------------------------------------
    def _poll_peer_link(self, **ctx):
        """Chaos hook for the daemon-hosted peer_link site; fired
        injections are reported upward (report-class) so the head's
        injection log and counters stay cluster-wide."""
        from ray_tpu_torch._private.chaos import get_controller

        ctrl = get_controller()
        if not ctrl.armed():
            return None
        fault = ctrl.poll("peer_link", **ctx)
        if fault is not None:
            log = ctrl.list_faults()
            entry = dict(log[-1]) if log else {
                "site": "peer_link", "kind": fault.get("kind")}
            self._send_head(("fault", entry))
        return fault

    def _request_route(self, aid_bin: bytes) -> None:
        now = time.monotonic()
        with self._p2p_lock:
            if now - self._aresolve_last.get(aid_bin, 0.0) < 0.5:
                return
            self._aresolve_last[aid_bin] = now
        self._send_head(("aresolve", aid_bin))

    def _on_aroute(self, aid_bin: bytes, route) -> None:
        with self._p2p_lock:
            if route is None:
                self._actor_routes.pop(aid_bin, None)
            else:
                self._actor_routes[aid_bin] = (
                    route[0], tuple(route[1]), route[2])

    def _mint_actor_task(self, aid_bin: bytes, num_returns: int):
        """Mint a p2p actor-call task id with the ActorHandle
        discipline (actor-id prefix + salted sequence) under a
        per-daemon random salt, so ids minted here collide with
        neither the head's handles nor another caller daemon's."""
        with self._p2p_lock:
            st = self._actor_salts.get(aid_bin)
            if st is None:
                st = self._actor_salts[aid_bin] = [
                    int.from_bytes(os.urandom(2), "big"), 0]
            st[1] += 1
            if st[1] > 0xFFFF:
                st[0] = int.from_bytes(os.urandom(2), "big")
                st[1] = 1
            seq = st[0] * 65536 + st[1]
        tid = TaskID.for_actor_task(ActorID(aid_bin), seq)
        rids = [ObjectID.for_task_return(tid, i).binary()
                for i in range(num_returns)]
        return tid.binary(), rids

    def _maybe_p2p_call(self, slot: _WorkerSlot, req_id: int,
                        args: tuple) -> Optional[tuple]:
        """P2P actor plane, caller side: a worker's actor call whose
        handle the head resolved to a peer (node, worker) address
        ships the call envelope DIRECTLY to that node's daemon over
        the peer link; the head sees only a sequenced completion
        receipt. No route yet / refs in the args / lane trouble — the
        unchanged head path."""
        fwd = ("rpc", req_id, "actor_call", args)
        if len(args) < 2 or args[1] is None:
            return fwd
        blob, meta = args[0], args[1]
        aid_bin, method, num_returns, trace, p2p_ok = meta
        with self._resview_lock:
            enabled = bool(self._resview.get("p2p"))
        if not enabled or not p2p_ok:
            return fwd
        with self._p2p_lock:
            route = self._actor_routes.get(aid_bin)
        if route is None:
            self._request_route(aid_bin)
            return fwd
        tid_bin, rids = self._mint_actor_task(aid_bin, num_returns)
        ctx = None
        if trace is not None and trace[3]:
            ctx = (trace[0], os.urandom(8).hex(), trace[1], True)
        with self._resview_lock:
            caller_node = self._resview.get("node")
        info = {"actor": aid_bin, "method": method, "blob": blob,
                "num_returns": num_returns, "returns": rids,
                "caller": slot.num, "caller_node": caller_node,
                "trace": ctx, "route": route,
                "t": time.monotonic(), "attempt": 0}
        with self._p2p_lock:
            self._p2p_calls[tid_bin] = info
        # the caller gets its return ids NOW: from here the call is
        # committed to the p2p lane or its exactly-once head fallback
        self._to_worker(slot, ("reply", req_id, True, rids))
        fault = self._poll_peer_link(actor=aid_bin.hex())
        if fault is not None:
            k = fault.get("kind")
            if k == "drop":
                self._fallback_call(tid_bin, "chaos: dropped call frame")
                return None
            if k == "sever":
                self._sever_lane(tuple(route[1]),
                                 "chaos: severed peer lane")
                return None
            time.sleep(fault.get("delay_s", 0.05))
        self._p2p_dispatch(tid_bin, info)
        return None

    def _p2p_dispatch(self, tid_bin: bytes, info: dict) -> None:
        from ray_tpu_torch._private.task_spec import (EMPTY_ARGS_BLOB,
                                                encode_task_envelope)

        lane = self._actor_lane(tuple(info["route"][1]))
        if lane is None:
            self._fallback_call(tid_bin, "peer lane dial failed")
            return
        payload = {
            "task_id": tid_bin, "name": info["method"], "fn_id": None,
            "fn_blob": None, "args_blob": EMPTY_ARGS_BLOB,
            "num_returns": info["num_returns"],
            "return_ids": info["returns"],
            "attempt": info.get("attempt", 0),
            # extras: the executing worker unpickles the CALLER's blob
            # itself (only it has the user's modules); dedup marks the
            # completion cacheable for the exactly-once fallback
            "method": info["method"], "p2p_blob": info["blob"],
            "actor": info["actor"], "caller": info["caller"],
            "caller_node": info.get("caller_node"),
            "dedup": True,
        }
        if info.get("trace") is not None:
            payload["trace"] = info["trace"]
        key = (None, info["method"], info["num_returns"])
        with lane["lock"]:  # RLock: encode mutates the lane's caches
            env = encode_task_envelope(
                [(key, [payload])], lane["sent_fns"],
                lane["sent_hdrs"], lane["hdr_blobs"])
            if not self._lane_send(("acall", env), lane["conn"],
                                   lane["lock"]):
                self._drop_lane(lane, "peer lane send failed")

    def _lane_send(self, msg: tuple, conn, lock) -> bool:
        """The ONE send point for peer actor-lane frames (acall out,
        ares back) — wire-lint collects the channel's send set here."""
        try:
            with lock:
                conn.send(msg)
            return True
        except (OSError, ValueError):
            return False

    def _actor_lane(self, address) -> Optional[dict]:
        """Dial (or reuse) the dedicated actor-call lane to a peer
        daemon. Deliberately separate from the cached pull
        connections: chunked object streams and async call/result
        frames must not interleave on one pipe."""
        from multiprocessing import AuthenticationError

        from ray_tpu_torch._private import protocol

        address = tuple(address)
        with self._p2p_lock:
            lane = self._p2p_lanes.get(address)
        if lane is not None:
            return lane
        try:
            conn = Client(address, authkey=self._peer_authkey)
            conn.send(protocol.make_wire_hello("peer"))
            if conn.recv() != ("ok",):
                conn.close()
                return None
        except (OSError, EOFError, ValueError, AuthenticationError):
            return None
        lane = {"conn": conn, "lock": threading.RLock(),
                "addr": address, "sent_fns": set(), "sent_hdrs": {},
                "hdr_blobs": {}}
        with self._p2p_lock:
            ex = self._p2p_lanes.get(address)
            if ex is not None:
                try:
                    conn.close()
                except Exception:
                    pass
                return ex
            self._p2p_lanes[address] = lane
        threading.Thread(target=self._lane_reader, args=(lane,),
                         daemon=True,
                         name="ray_tpu_actor_lane").start()
        return lane

    def _lane_reader(self, lane: dict) -> None:
        """Drain ("ares", ...) result frames off an actor lane; EOF
        (peer died, chaos sever) sweeps every in-flight call routed
        over it into the head-path fallback — same ids, exactly-once."""
        conn = lane["conn"]
        try:
            while not self._shutdown:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    break
                if not (isinstance(msg, tuple) and msg
                        and msg[0] == "ares"):
                    break
                self._on_ares(msg)
        finally:
            # a raise out of _on_ares (short frame, prefetch error) must
            # still tear the lane down — a reader-less lane would leave
            # every later call on this route to the slow timeout sweep
            self._drop_lane(lane, "peer lane lost")

    def _drop_lane(self, lane: dict, reason: str) -> None:
        addr = lane["addr"]
        with self._p2p_lock:
            if self._p2p_lanes.get(addr) is lane:
                del self._p2p_lanes[addr]
        try:
            lane["conn"].close()
        except Exception:
            pass
        self._sweep_route(addr, reason)

    def _sever_lane(self, address: tuple, reason: str) -> None:
        with self._p2p_lock:
            lane = self._p2p_lanes.get(tuple(address))
        if lane is not None:
            self._drop_lane(lane, reason)
        else:
            self._sweep_route(tuple(address), reason)

    def _sweep_route(self, address: tuple, reason: str) -> None:
        with self._p2p_lock:
            tids = [t for t, i in self._p2p_calls.items()
                    if tuple(i["route"][1]) == address]
        for t in tids:
            self._fallback_call(t, reason)

    def _on_ares(self, msg: tuple) -> None:
        _, tid_bin, status, data, _timing = msg
        with self._p2p_lock:
            info = self._p2p_calls.pop(tid_bin, None)
        if info is None:
            return  # already fell back (sweep won the race) — ignore
        if status == "miss":
            # stale route: the actor moved or its worker died there
            with self._p2p_lock:
                self._actor_routes.pop(info["actor"], None)
            self._fallback_call(tid_bin, "peer reported no such actor",
                                info)
            return
        if status == "done":
            peer = tuple(info["route"][1])
            for i, entry in enumerate(data or []):
                if not (isinstance(entry, tuple) and entry):
                    continue
                if (entry[0] == "remote_shm"
                        and i < len(info["returns"])):
                    # results return on the same link: pull the bytes
                    # from the executing peer at task-arg priority
                    self.pulls.prefetch(peer, info["returns"][i],
                                        PullManager.PRIO_ARG)
                elif entry[0] == "inline" and i < len(info["returns"]):
                    self._adopt_inline(info["returns"][i], entry[1])
        # err: nothing to localize — the head stores the exception
        # from the completion receipt and the caller's get resolves it

    def _adopt_inline(self, rid_bin: bytes, data: bytes) -> None:
        """Adopt an inline result into the local store so the caller's
        get is answered node-locally instead of via the head."""
        oid = ObjectID(rid_bin)
        if self.store.contains(oid):
            return
        try:
            kind, target = self.store.begin_adopt(oid, len(data))
        except Exception:
            return
        try:
            if kind == "arena":
                target[:len(data)] = data
            else:
                target.write(data)
        except Exception:
            if kind == "arena":
                target.release()
            self.store.abort_adopt(oid, kind,
                                   None if kind == "arena" else target)
            return
        if kind == "arena":
            target.release()
        self.store.finish_adopt(oid, len(data), kind,
                                None if kind == "arena" else target)

    def _fallback_call(self, tid_bin: bytes, reason: str,
                       info: Optional[dict] = None) -> None:
        """Re-route an in-flight p2p call through the head with the
        SAME task id / return ids / attempt token. The executing
        worker's dedup cache (p2p payloads carry dedup=True) re-emits
        the recorded completion if the peer actually ran the first
        attempt — bit-correct exactly-once, whichever half of the
        lane died."""
        if info is None:
            with self._p2p_lock:
                info = self._p2p_calls.pop(tid_bin, None)
        if info is None:
            return
        self._send_head(("p2p_fallback", tid_bin, {
            "actor": info["actor"], "method": info["method"],
            "blob": info["blob"], "num_returns": info["num_returns"],
            "returns": info["returns"], "caller": info["caller"],
            "trace": info["trace"], "attempt": info.get("attempt", 0),
            "reason": reason,
        }))

    def _on_peer_dead(self, info: dict) -> None:
        """Head broadcast: a peer node died. Evict every trace of it
        NOW — its gossip view (local admission must never trust a
        ghost node's resource/residency claims), cached p2p actor
        routes to its address, the lane itself, and every in-flight
        call routed over it (swept straight to the head-path fallback
        instead of waiting out the 15s p2p result timeout)."""
        addr = info.get("peer")
        addr = tuple(addr) if addr else None
        dead_index = info.get("index")
        if addr is not None:
            with self._p2p_lock:
                self._dead_peers.add(addr)
            with self._resview_lock:
                peers = self._resview.get("peers")
                if peers:
                    self._resview["peers"] = [
                        p for p in peers if tuple(p) != addr]
        with self._p2p_lock:
            stale = [aid for aid, route in self._actor_routes.items()
                     if (addr is not None and tuple(route[1]) == addr)
                     or (dead_index is not None
                         and route[0] == dead_index)]
            for aid in stale:
                del self._actor_routes[aid]
        if addr is not None:
            self._sever_lane(addr, "peer node died")

    def _on_fence(self, epoch) -> None:
        """The head re-adopted this daemon AFTER declaring its node
        dead: everything from the dead era was already resubmitted or
        failed head-side, so clear the local-lease bodies (no zombie
        re-lease), the in-flight p2p call table (no stale head
        fallback re-executing a settled call), and the outbox (its
        replays were acked-and-dropped by the fenced pool anyway)."""
        import logging

        # _local_leases is GIL-atomic like its other mutation sites
        # (worker reader threads pop, admission assigns — none hold a
        # lock); only the _local_tids admission set is _resview_lock'd
        n_leases = len(self._local_leases)
        self._local_leases.clear()
        with self._resview_lock:
            self._local_tids.clear()
        with self._p2p_lock:
            n_calls = len(self._p2p_calls)
            self._p2p_calls.clear()
        self._outbox.ack(self._outbox.last_seq)
        logging.getLogger(__name__).warning(
            "fenced by head (epoch %s): cleared %d dead-era local "
            "leases and %d in-flight p2p calls", epoch, n_leases,
            n_calls)

    def _gossip_loop(self) -> None:
        """Tentpole (d): re-share the freshest resource view this
        daemon holds with its peers over the existing actor lanes, so
        every node's local admission stays current when the head is
        slow, blacked out, or mid-rejoin. Versioned adoption (epoch +
        strictly-newer v, see _apply_resview) keeps the head the
        authoritative tiebreaker."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        while not self._shutdown:
            period = float(GLOBAL_CONFIG.resview_gossip_s)
            time.sleep(period if period > 0 else 1.0)
            if period <= 0:
                continue
            with self._resview_lock:
                view = dict(self._resview)
            if not (view.get("accept") or view.get("p2p")):
                continue  # knobs off: the peer wire stays silent
            # origin stamp: receivers drop views gossiped FROM a node
            # the head has since declared dead (ghost-view eviction)
            view["from"] = tuple(self.peer_address)
            for addr in view.get("peers") or ():
                with self._p2p_lock:
                    if tuple(addr) in self._dead_peers:
                        continue
                # the gossip frames ride the same peer lanes as p2p
                # calls, so the peer_link chaos site covers them too:
                # a severed/dropped lane must cost only freshness (the
                # next tick redials), never correctness
                fault = self._poll_peer_link(frame="rview")
                if fault is not None:
                    k = fault.get("kind")
                    if k == "sever":
                        self._sever_lane(tuple(addr),
                                         "chaos: severed gossip lane")
                        continue
                    if k == "drop":
                        continue
                    time.sleep(fault.get("delay_s", 0.05))
                lane = self._actor_lane(addr)
                if lane is None:
                    continue
                if not self._lane_send(("rview", view), lane["conn"],
                                       lane["lock"]):
                    self._drop_lane(lane, "peer lane send failed")

    def _p2p_sweep_loop(self) -> None:
        """Safety net under the lane-EOF sweep: a call whose result
        frame never arrives (peer wedged, frame lost to a half-dead
        socket) falls back through the head after a generous timeout."""
        while not self._shutdown:
            time.sleep(1.0)
            now = time.monotonic()
            with self._p2p_lock:
                stale = [t for t, i in self._p2p_calls.items()
                         if now - i["t"] > 15.0]
            for t in stale:
                self._fallback_call(t, "p2p result timed out")

    def _serve_acall(self, conn, send_lock, hdr_cache: Dict[int, tuple],
                     env_blob: bytes) -> None:
        """Executing side of the p2p lane: decode the lease envelope,
        dispatch each call to the resident dedicated actor worker, and
        remember the lane so the completion goes back on it. A call
        for an actor that does not live here (stale route) answers
        ("ares", tid, "miss", ...) so the caller re-resolves."""
        from ray_tpu_torch._private.task_spec import decode_task_envelope

        try:
            payloads = decode_task_envelope(env_blob, hdr_cache)
        except Exception:
            return
        for p in payloads:
            tid_bin = p["task_id"]
            aid_bin = p.get("actor")
            with self._lock:
                slot = next(
                    (s for s in self._slots.values()
                     if aid_bin is not None and s.actor_bin == aid_bin
                     and s.conn is not None), None)
            if slot is None or (slot.proc is not None
                                and slot.proc.poll() is not None):
                self._lane_send(("ares", tid_bin, "miss", None, None),
                                conn, send_lock)
                continue
            info = {"actor": aid_bin, "caller": p.get("caller"),
                    "caller_node": p.get("caller_node"),
                    "method": p.get("method"), "name": p.get("name"),
                    "trace": p.get("trace")}
            slot.returns[tid_bin] = list(p["return_ids"])
            slot.attempts[tid_bin] = p.get("attempt", 0)
            with self._p2p_lock:
                self._p2p_pending[tid_bin] = (conn, send_lock, info)
            self._to_worker(slot, ("actor_call", p))

    def _finish_p2p_exec(self, slot: _WorkerSlot, tid_bin: bytes,
                         p2p: tuple, msg: tuple) -> None:
        """A peer-dispatched call finished on THIS node: the head gets
        its (report-class) completion receipt, then the result frames
        go back over the lane the call arrived on. Receipt first and
        always — a dead lane just means the caller's daemon falls
        back, and the worker-side dedup cache keeps that retry
        exactly-once."""
        conn, send_lock, info = p2p
        return_bins = slot.returns.pop(tid_bin, [])
        slot.attempts.pop(tid_bin, None)
        receipt = {"actor": info.get("actor"),
                   "method": info.get("method"),
                   "name": info.get("name"),
                   "caller": info.get("caller"),
                   "caller_node": info.get("caller_node"),
                   "trace": info.get("trace"),
                   "worker_num": slot.num, "returns": return_bins}
        if msg[0] == "done":
            out = []
            for i, entry in enumerate(msg[2]):
                if entry[0] == "shm" and i < len(return_bins):
                    rid = ObjectID(return_bins[i])
                    if self.store.locate(rid) is None:
                        self.store.seal(rid)
                    out.append(("remote_shm", entry[2]))
                else:
                    out.append(entry)
            timing = msg[3] if len(msg) > 3 else None
            receipt["entries"] = out
            receipt["timing"] = timing
            self._send_head(("p2p_done", tid_bin, receipt))
            self._lane_send(("ares", tid_bin, "done", out, timing),
                            conn, send_lock)
        else:
            timing = msg[4] if len(msg) > 4 else None
            receipt["err"] = (msg[2], msg[3])
            receipt["timing"] = timing
            self._send_head(("p2p_done", tid_bin, receipt))
            self._lane_send(("ares", tid_bin, "err",
                             (msg[2], msg[3]), timing),
                            conn, send_lock)

    def _register_lease_msg(self, slot: _WorkerSlot, msg: tuple) -> None:
        """Bookkeeping copy of a head->worker lease in transit: record
        return ids + attempt tokens per worker so a rejoin hello can
        report exactly what is still running here. Registered as an
        extra recv of the raylint owner_to_worker channel — the daemon
        decodes the SAME frames the worker does, including the remote
        lease envelope (tentpole c), so schema drift on the relayed
        channel is caught here too."""
        if msg[0] in ("task", "actor_create", "actor_call"):
            p = msg[1]
            rids = p.get("return_ids")
            if rids:
                slot.returns[p["task_id"]] = list(rids)
                slot.attempts[p["task_id"]] = p.get("attempt", 0)
            if msg[0] == "actor_create":
                slot.actor_bin = p.get("actor_bin")
        elif msg[0] == "tasks":
            for p in msg[1]:
                rids = p.get("return_ids")
                if rids:
                    slot.returns[p["task_id"]] = list(rids)
                    slot.attempts[p["task_id"]] = p.get("attempt", 0)
        elif msg[0] == "env":
            # remote lease envelope: decode a copy for the per-worker
            # bookkeeping, forward the blob verbatim — the worker's own
            # header cache evolves in lockstep off the same stream
            from ray_tpu_torch._private.task_spec import decode_task_envelope

            for p in decode_task_envelope(msg[1], slot.hdr_cache):
                rids = p.get("return_ids")
                if rids:
                    slot.returns[p["task_id"]] = list(rids)
                    slot.attempts[p["task_id"]] = p.get("attempt", 0)

    # ------------------------------------------------------------------
    # head -> daemon main loop
    # ------------------------------------------------------------------
    def run(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="ray_tpu_node_accept")
        self._accept_thread.start()
        threading.Thread(target=self._log_tail_loop, daemon=True,
                         name="ray_tpu_node_log_tail").start()
        threading.Thread(target=self._p2p_sweep_loop, daemon=True,
                         name="ray_tpu_node_p2p_sweep").start()
        threading.Thread(target=self._gossip_loop, daemon=True,
                         name="ray_tpu_node_resview_gossip").start()
        self._start_util_sampler()
        while not self._shutdown:
            try:
                msg = self._head.recv()
            except (EOFError, OSError):
                # head gone WITHOUT an exit: orphaned. Try to rejoin a
                # restarted head at the same address; workers (and the
                # actor state inside them) stay alive meanwhile.
                import logging
                logging.getLogger(__name__).warning(
                    "head connection lost; trying to rejoin %s for %.0fs",
                    self._head_address, self._rejoin_timeout_s)
                if self._rejoin_timeout_s > 0 and self._try_rejoin():
                    logging.getLogger(__name__).warning(
                        "rejoined head at %s; workers survived",
                        self._head_address)
                    continue
                break  # no head came back: the node dies
            runtime_sanitizer.check_wire("head_to_daemon", msg)
            kind = msg[0]
            if kind == "error":
                # e.g. protocol-version rejection of our hello: the
                # head told us WHY — log it and die instead of retrying
                import logging
                logging.getLogger(__name__).error(
                    "head rejected this node: %s", msg[1])
                break
            if kind == "spawn":
                self._spawn(msg[1], msg[2] if len(msg) > 2 else None)
            elif kind == "to_w":
                num, payload = msg[1], msg[2]
                with self._lock:
                    slot = self._slots.get(num)
                if slot is not None and slot.conn is not None:
                    self._register_lease_msg(slot, payload)
                    if (payload[0] == "reply"
                            and payload[1] in slot.gets):
                        purpose = slot.gets.pop(payload[1])
                        if payload[2]:
                            prio = (PullManager.PRIO_ARG
                                    if purpose == "arg"
                                    else PullManager.PRIO_GET)
                            locs = payload[3]
                            if any(isinstance(lc, tuple) and lc
                                   and lc[0] == "peer" for lc in locs):
                                # peer pulls can take seconds: NEVER on
                                # the head-message run loop (it carries
                                # task dispatch + pings for the node)
                                threading.Thread(
                                    target=self._localize_reply,
                                    args=(slot, payload[1], locs, prio),
                                    daemon=True).start()
                                continue
                            payload = ("reply", payload[1], True,
                                       [self._localize(lc, prio)
                                        for lc in locs])
                    self._to_worker(slot, payload)
            elif kind == "to_ctrl":
                with self._lock:
                    slot = self._slots.get(msg[1])
                if slot is not None and slot.ctrl is not None:
                    try:
                        slot.ctrl.send(msg[2])
                    except (OSError, ValueError):
                        pass
            elif kind == "kill":
                with self._lock:
                    slot = self._slots.get(msg[1])
                if slot is not None and slot.proc is not None:
                    try:
                        slot.proc.kill()
                    except Exception:
                        pass
            elif kind == "fetch":
                # off the run loop: serializing + sending a large object
                # must not stall task dispatch / pings for the node
                # (sends are serialized by _head_lock)
                threading.Thread(
                    target=self._serve_fetch, args=(msg[1], msg[2]),
                    daemon=True, name="ray_tpu_node_fetch").start()
            elif kind == "log_list":
                # off the run loop, like fetch: disk reads must not
                # stall task dispatch for the node
                threading.Thread(
                    target=self._serve_log_list, args=(msg[1],),
                    daemon=True, name="ray_tpu_node_log_list").start()
            elif kind == "log_read":
                threading.Thread(
                    target=self._serve_log_read,
                    args=(msg[1], msg[2], msg[3]),
                    daemon=True, name="ray_tpu_node_log_read").start()
            elif kind == "stage":
                # dispatch-time arg staging: enqueue peer pulls NOW at
                # task-arg priority so transfers overlap the lease's
                # queue wait; completions report ("pulled", oid) and
                # the exec-time localization finds the bytes resident
                for oid_bin, address, _nbytes in msg[1]:
                    self.pulls.prefetch(address, oid_bin,
                                        PullManager.PRIO_ARG)
            elif kind == "resview":
                self._apply_resview(msg[1])
            elif kind == "aroute":
                self._on_aroute(msg[1], msg[2])
            elif kind == "node_dead":
                self._on_peer_dead(msg[1])
            elif kind == "fence":
                self._on_fence(msg[1])
            elif kind == "free":
                for b in msg[1]:
                    self.store.free_object(ObjectID(b))
            elif kind == "ping":
                with self._lock:
                    pids = {s.num: s.pid for s in self._slots.values()
                            if s.proc is not None and s.proc.poll() is None}
                self._send_head(("pong", msg[1], pids))
            elif kind == "store_stats":
                self._send_head(("store_stats", msg[1], {
                    "used_bytes": self.store.used_bytes(),
                    "objects": self.store.num_objects(),
                    "spilled_objects": self.store.num_spilled_objects()}))
            elif kind == "ack":
                # outbox high-water acknowledgment: the head processed
                # (or deduped) every report up to this sequence number
                self._outbox.ack(msg[1])
            elif kind == "exit":
                break
            else:
                # exhaustive dispatch: a tag this daemon doesn't know
                # means head/daemon version (or protocol) drift — fail
                # loudly instead of silently dropping control messages
                import logging
                logging.getLogger(__name__).error(
                    "node daemon: unknown head message tag %r "
                    "(protocol drift? head and node running different "
                    "versions)", kind)
        self.shutdown()

    def _try_rejoin(self) -> bool:
        """Re-dial the head address until a (restarted) head accepts
        this node back. The rejoin hello reports the live workers —
        numbers, pids, which actor each dedicated worker hosts, and
        every task still IN FLIGHT (task id -> return oids + attempt
        token) — so the new head re-adopts them, re-attaches the live
        leases to their waiting ObjectRefs, and resubmits only what no
        surviving node claims. Work is never pre-killed here: whether
        an in-flight lease is still wanted is the HEAD's call (lease
        reconciliation), not this daemon's."""
        import time

        deadline = time.monotonic() + self._rejoin_timeout_s
        while not self._shutdown and time.monotonic() < deadline:
            try:
                head = Client(self._head_address,
                              authkey=self._head_authkey)
            except Exception:  # conn refused / auth failure / reset
                time.sleep(0.5)
                continue
            # p2p-pending executions are excluded from the in-flight
            # report: their completion reaches the head as a
            # self-contained ("p2p_done", ...) receipt, so the new head
            # must not also adopt a lease it would wait on forever
            # a task that finished during the blackout is reported too
            # (its completion waits in the outbox), so the head adopts
            # its lease and the replayed completion resolves it
            with self._completion_lock:
                with self._p2p_lock:
                    p2p_tids = set(self._p2p_pending)
                with self._lock:
                    workers = {
                        s.num: {"pid": s.pid,
                                "actor": (s.actor_bin.hex()
                                          if s.actor_bin else None),
                                "inflight": {
                                    tid.hex(): {
                                        "returns": [b.hex()
                                                    for b in rbins],
                                        "attempt": s.attempts.get(tid, 0),
                                    }
                                    for tid, rbins in s.returns.items()
                                    if tid not in p2p_tids}}
                        for s in self._slots.values()
                        if s.proc is not None and s.proc.poll() is None}
                for done in self._outbox.unacked_meta():
                    w = workers.get(done["num"])
                    if w is not None and w["actor"] is None:
                        w["inflight"].setdefault(done["tid"].hex(), {
                            "returns": [b.hex() for b in done["returns"]],
                            "attempt": done["attempt"]})
            from ray_tpu_torch._private.protocol import make_wire_hello

            try:
                head.send(make_wire_hello(
                    "rejoin", os.getpid(), self.store.arena.name,
                    dict(self._node_info), tuple(self.peer_address),
                    workers))
            except (OSError, ValueError):
                try:
                    head.close()
                except Exception:
                    pass
                time.sleep(0.5)
                continue
            with self._head_lock:
                self._head = head
                # re-run the clock handshake: the new head computes a
                # fresh clock_offset for this link
                self._send_locked(("clock", time.time(),
                                   time.perf_counter()))
                # replay every unacked report: completions/pulls/logs
                # that happened during the blackout reach the new head
                # now, ahead of any fresh report (one hold of the lock);
                # the head's per-node sequence dedup makes this
                # exactly-once even when the old head never actually
                # died (link flap)
                self._replay_outbox_locked()
            return True
        return False

    def shutdown(self) -> None:
        self._shutdown = True
        sampler = getattr(self, "_util_sampler", None)
        if sampler is not None:
            sampler.stop()
        with self._lock:
            slots = list(self._slots.values())
        for s in slots:
            if s.conn is not None:
                try:
                    s.conn.send(("exit",))
                except (OSError, ValueError):
                    pass
        for s in slots:
            if s.proc is not None:
                try:
                    s.proc.wait(timeout=1.0)
                except subprocess.TimeoutExpired:
                    s.proc.kill()
        close_listener(self._listener, self._accept_thread)
        close_listener(self._peer_listener, self._peer_accept_thread)
        with self._peer_lock:
            entries, self._peer_conns = list(self._peer_conns.values()), {}
        for entry in entries:
            try:
                if entry[0] is not None:
                    entry[0].close()
            except Exception:
                pass
        with self._p2p_lock:
            lanes, self._p2p_lanes = list(self._p2p_lanes.values()), {}
        for lane in lanes:
            try:
                lane["conn"].close()
            except Exception:
                pass
        try:
            os.rmdir(self._sock_dir)
        except OSError:
            pass
        self.store.shutdown()


def _workers_see_card(node_info: dict) -> bool:
    """Whether this node's workers get the card: only a node that
    declared GPUs, and only under worker_gpu_access (the head's knob,
    passed in the node info as ``gpu_access``; a daemon that joins on
    its own reads its own). Otherwise they start with
    CUDA_VISIBLE_DEVICES="" and the node advertises no GPU."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if float(node_info.get("num_gpus", 0) or 0) <= 0:
        return False
    return bool(node_info.get("gpu_access",
                              GLOBAL_CONFIG.worker_gpu_access))


def _main(argv) -> None:
    """``python -m ray_tpu_torch._private.runtime.node_daemon <host> <port>
    <token> <object_store_memory> <inline_max> [join_info_json]
    [rejoin_timeout_s]`` with the head authkey in
    RAY_TPU_TORCH_HEAD_AUTHKEY. Exec'd by the head's Cluster harness, or
    self-started with token "join" by hand
    on another machine."""
    import json

    # capture this daemon's own stdout/stderr first (dup2) when the
    # spawner asked for it — import/startup failures land in the file
    from ray_tpu_torch._private import log_plane

    log_plane.redirect_stdio_from_env()

    host, port, token = argv[0], int(argv[1]), argv[2]
    mem, inline_max = int(argv[3]), int(argv[4])
    join_info = (json.loads(argv[5])
                 if len(argv) > 5 and argv[5] else None)
    rejoin = float(argv[6]) if len(argv) > 6 else 20.0
    authkey = bytes.fromhex(os.environ[HEAD_AUTHKEY_ENV])
    daemon = NodeDaemon((host, port), authkey, token, mem, inline_max,
                        join_info=join_info, rejoin_timeout_s=rejoin)
    daemon.run()


if __name__ == "__main__":
    # canonical-import re-entry (same reason as worker_process.py)
    from ray_tpu_torch._private.runtime import node_daemon as _canonical

    _canonical._main(sys.argv[1:])

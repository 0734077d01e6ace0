"""Ray-client analog: a remote driver talking to a running head.

Reference surfaces: ray's client mode (python/ray/util/client/ — a gRPC
proxy where `ray.init(address="ray://host:port")` makes the local
process a THIN CLIENT of a remote cluster: tasks/actors/objects live on
the server; the client holds proxy refs) and the dataserver's
per-session reference pinning.

Transport: the same authenticated framed-tuple TCP connection the node
daemons use (HeadServer, runtime/remote_pool.py). One connection per
client session; requests are (op, req_id, payload) with req-id-matched
replies so a blocking `get` does not serialize unrelated calls (each
request runs on its own server thread).

Ownership: every ObjectRef handed to a client is PINNED server-side
under the client's session (a local reference held on the ref's
behalf); the client counts its local refs and releases each id once its
last local ref dies; a dropped connection releases the whole session.

Surface: init/put/get/wait/remote tasks/actors (create, method calls,
named lookup, kill)/cancel/cluster state verbs. Driver-side-only APIs
(timeline, snapshot, placement group creation) raise in client mode.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private.analysis import runtime_sanitizer
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# server side (runs in the head process)
# ----------------------------------------------------------------------

class ClientSession:
    __slots__ = ("client_id", "conn", "send_lock", "pinned")

    def __init__(self, client_id: str, conn):
        self.client_id = client_id
        self.conn = conn
        self.send_lock = threading.Lock()
        self.pinned: set = set()  # ObjectIDs held on the client's behalf


# the state-observability verbs of util/state.py a client may call
_STATE_VERBS = frozenset({
    "list_tasks", "list_actors", "list_objects", "list_nodes",
    "list_placement_groups", "summarize_tasks", "list_data_streams",
    "list_faults", "list_logs", "get_log", "task_timeline",
    "list_traces", "get_trace", "profile_stacks", "list_utilization",
    "list_tenants", "list_serve_deployments",
})


class ClientServer:
    """Serves client sessions registered through the HeadServer."""

    def __init__(self, worker):
        self._worker = worker
        self._sessions: Dict[str, ClientSession] = {}
        self._lock = threading.Lock()

    # -- session lifecycle --------------------------------------------
    def attach(self, conn, hello: tuple) -> None:
        """HeadServer on_unsolicited hook for ('hello', 'client', id)."""
        client_id = hello[2] if len(hello) > 2 else uuid.uuid4().hex
        session = ClientSession(client_id, conn)
        with self._lock:
            old = self._sessions.get(client_id)
            if old is not None:
                # the same client_id reconnecting is a RESUMED session
                # (link flap, or a rebind that beat the old serve
                # thread's EOF): the new link inherits the pins so the
                # old thread's _drop cannot free objects the client
                # still points at
                session.pinned = old.pinned
                old.pinned = set()
            self._sessions[client_id] = session
        threading.Thread(target=self._serve, args=(session,), daemon=True,
                         name=f"ray_tpu_client_{client_id[:8]}").start()

    def _serve(self, s: ClientSession) -> None:
        try:
            s.conn.send(("ready",))
        except (OSError, ValueError):
            return
        while True:
            try:
                msg = s.conn.recv()
            except (EOFError, OSError, TypeError, ValueError):
                break
            if not (isinstance(msg, tuple) and len(msg) == 3):
                break
            op, req_id, payload = msg
            if op in ("release", "pin"):
                # inline, not a thread: these never block, and a
                # release followed by a re-pin of the same oid must be
                # applied in wire order or the pin could land first
                self._handle(s, op, req_id, payload)
                continue
            # a THREAD per request (not a bounded pool): blocking
            # gets/waits with no timeout must never starve the
            # puts/submits that would unblock them
            threading.Thread(target=self._handle,
                             args=(s, op, req_id, payload), daemon=True,
                             name="ray_tpu_client_req").start()
        self._drop(s)

    def _drop(self, s: ClientSession) -> None:
        with self._lock:
            # identity check: if the client already re-attached under
            # the same client_id, the registry row belongs to the NEW
            # session — popping it would orphan the resumed link
            if self._sessions.get(s.client_id) is s:
                self._sessions.pop(s.client_id, None)
        # the session's pins die with it
        for oid in list(s.pinned):
            try:
                self._worker.reference_counter.remove_local_reference(oid)
            except Exception:
                pass
        s.pinned.clear()
        # close under the send lock: a late reply thread that already
        # passed Connection's closed-check must finish its write before
        # the fd is freed, or the write can land on a recycled fd (a
        # brand-new client's socket, corrupting its auth handshake)
        with s.send_lock:
            try:
                s.conn.close()
            except Exception:
                pass

    def _handle(self, s: ClientSession, op: str, req_id: int,
                payload: tuple) -> None:
        try:
            result = getattr(self, f"_op_{op}")(s, *payload)
            ok = True
        except BaseException as e:  # noqa: BLE001
            ok = False
            try:
                result = cloudpickle.dumps(e)
            except Exception:
                # unpicklable exception (open handle, lock, ...): the
                # client must still get A reply, not hang forever
                result = cloudpickle.dumps(
                    RuntimeError(f"[unpicklable {type(e).__name__}] {e}"))
        try:
            with s.send_lock:
                s.conn.send((req_id, ok, result))
        except (OSError, ValueError):
            pass

    def _pin(self, s: ClientSession, oid: ObjectID) -> None:
        if oid not in s.pinned:
            self._worker.reference_counter.add_local_reference(oid)
            s.pinned.add(oid)
            # a client-held pin has no local ObjectRef instance: tell
            # the sanitizer's ref census the holder is external
            runtime_sanitizer.note_external_ref(oid)

    # -- ops -----------------------------------------------------------
    def _op_put(self, s, blob: bytes) -> bytes:
        ref = self._worker.put(cloudpickle.loads(blob))
        self._pin(s, ref.object_id())
        return ref.object_id().binary()

    def _op_get(self, s, oid_bins: list, timeout) -> list:
        from ray_tpu_torch._private.runtime.process_pool import _dumps_collect_refs

        refs = [ObjectRef(ObjectID(b), None, _register=False)
                for b in oid_bins]
        # worker.get already raises driver-semantics exceptions (incl.
        # TaskError cause conversion); _handle ships them to the client
        out = []
        for v in self._worker.get(refs, timeout):
            # ObjectRefs NESTED in fetched values become client-held
            # refs too: pin them or the server may free the objects
            # while the client still points at them
            blob, contained = _dumps_collect_refs(v)
            for r in contained:
                self._pin(s, r.object_id())
            out.append(blob)
        return out

    def _op_wait(self, s, oid_bins: list, num_returns: int, timeout) -> list:
        refs = [ObjectRef(ObjectID(b), None, _register=False)
                for b in oid_bins]
        ready, _ = self._worker.wait(refs, num_returns, timeout)
        return [r.object_id().binary() for r in ready]

    def _op_submit(self, s, blob: bytes) -> list:
        from ray_tpu_torch._private.task_spec import TaskSpec
        d = cloudpickle.loads(blob)
        func = cloudpickle.loads(d["func_blob"])
        args, kwargs = cloudpickle.loads(d["args_blob"])
        from ray_tpu_torch._private.ids import PlacementGroupID
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
            scheduling_strategy=cloudpickle.loads(d["strategy_blob"])
            if d.get("strategy_blob") else None,
            placement_group_id=(PlacementGroupID(d["pg_id"])
                                if d.get("pg_id") is not None else None),
            placement_group_bundle_index=d.get("pg_bundle_index", -1),
            placement_group_capture_child_tasks=d.get("pg_capture", False),
            runtime_env=d.get("runtime_env"),
            generator=d.get("generator", False),
            priority=int(d.get("priority") or 0),
            tenant=d.get("tenant") or "default",
        )
        with self._traced("submit"):
            refs = self._worker.submit_task(spec)
        for r in refs:
            self._pin(s, r.object_id())
        return [r.object_id().binary() for r in refs]

    def _op_cancel(self, s, oid_bin: bytes, force: bool) -> bool:
        self._worker.cancel_task(
            ObjectRef(ObjectID(oid_bin), None, _register=False), force)
        return True

    def _op_create_actor(self, s, cls_blob: bytes, opts_blob: bytes,
                         args_blob: bytes) -> tuple:
        from ray_tpu_torch.actor import ActorClass
        cls = cloudpickle.loads(cls_blob)
        opts = cloudpickle.loads(opts_blob)
        args, kwargs = cloudpickle.loads(args_blob)
        with self._traced("create_actor"):
            handle = ActorClass(cls, opts).remote(*args, **kwargs)
        return (handle.actor_id.binary(), cls.__name__)

    def _op_actor_call(self, s, actor_bin: bytes, method: str,
                       args_blob: bytes, num_returns: int) -> list:
        from ray_tpu_torch.actor import ActorHandle
        handle = ActorHandle(ActorID(actor_bin))
        args, kwargs = cloudpickle.loads(args_blob)
        with self._traced(f"actor_call:{method}"):
            refs = handle._submit_method(method, args, kwargs,
                                         num_returns)
        refs = refs if isinstance(refs, list) else [refs]
        for r in refs:
            self._pin(s, r.object_id())
        return [r.object_id().binary() for r in refs]

    def _op_get_actor(self, s, name: str, namespace: str) -> tuple:
        from ray_tpu_torch.actor import get_actor
        handle = get_actor(name, namespace)
        return (handle.actor_id.binary(), handle._class_name)

    def _op_kill_actor(self, s, actor_bin: bytes, no_restart: bool) -> bool:
        from ray_tpu_torch.actor import ActorHandle, kill
        kill(ActorHandle(ActorID(actor_bin)), no_restart=no_restart)
        return True

    def _op_release(self, s, oid_bins: list) -> bool:
        for b in oid_bins:
            oid = ObjectID(b)
            if oid in s.pinned:
                s.pinned.discard(oid)
                self._worker.reference_counter.remove_local_reference(oid)
                runtime_sanitizer.drop_external_ref(oid)
        return True

    def _op_pin(self, s, oid_bins: list) -> bool:
        """Re-pin after a release raced with a client-side re-add."""
        for b in oid_bins:
            self._pin(s, ObjectID(b))
        return True

    def _traced(self, op: str):
        """Root a client span around a submission-bearing op: the
        head-side submission it triggers becomes the span's child via
        the ambient parent (per-request threads, so no cross-talk)."""
        tp = getattr(self._worker, "trace_plane", None)
        if tp is None:
            from contextlib import nullcontext
            return nullcontext()
        return tp.client_span(op)

    def _op_state(self, s, verb: str, *args) -> Any:
        import ray_tpu_torch
        from ray_tpu_torch.util import state as state_api
        if verb == "cluster_resources":
            return ray_tpu_torch.cluster_resources()
        if verb == "available_resources":
            return ray_tpu_torch.available_resources()
        if verb == "nodes":
            return ray_tpu_torch.nodes()
        # full state-observability verbs (reference: the GCS client
        # accessors backing `ray list ...` from any process); allowlist,
        # not bare getattr — the verb string comes off the wire (args
        # too: parameterized verbs like get_log ship positionals)
        if verb in _STATE_VERBS:
            return getattr(state_api, verb)(*args)
        raise ValueError(f"unknown state verb {verb!r}")

    def _op_kv(self, s, op: str, namespace: str, key: bytes,
               value: Optional[bytes]) -> Any:
        """Cluster KV through the client (reference: the GCS client's
        internal_kv accessors)."""
        gcs = self._worker.gcs
        if op == "get":
            return gcs.kv_get(key, namespace)
        if op == "put":
            gcs.kv_put(key, value, namespace)
            return True
        if op == "del":
            return gcs.kv_del(key, namespace)
        if op == "keys":
            return gcs.kv_keys(key, namespace)
        raise ValueError(f"unknown kv op {op!r}")

    def _op_ping(self, s) -> str:
        return "pong"

    def shutdown(self) -> None:
        with self._lock:
            sessions = list(self._sessions.values())
        for s in sessions:
            self._drop(s)


# ----------------------------------------------------------------------
# client side (the remote driver process)
# ----------------------------------------------------------------------

class _ClientRC:
    """Client-local refcounts; the server holds one pin per id until the
    client's last local ref dies (then a release is sent).

    Race guarded here: a thread deserializing another ref to an oid
    whose release was just sent would otherwise re-create the local
    count with no server pin behind it. Releases are sent UNDER the
    lock and recently released oids are remembered; a 0->1 re-add of a
    released oid sends a re-pin, and the lock orders the two sends on
    the wire (the server handles release/pin inline, in arrival
    order). Best-effort: if the server drops its LAST reference in the
    release..pin window the object is gone and a later get() raises
    ObjectLostError — the same outcome as losing the race without the
    guard, never silent corruption. The released-set is a bounded LRU
    (the race window is milliseconds; remembering the recent tail is
    enough, and an unbounded set would leak an entry per dead oid)."""

    _RELEASED_CAP = 4096

    def __init__(self, cw: "ClientWorker"):
        self._cw = cw
        self._counts: Dict[ObjectID, int] = {}
        self._released: "collections.OrderedDict[ObjectID, None]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def add_local_reference(self, oid: ObjectID) -> None:
        with self._lock:
            n = self._counts.get(oid, 0) + 1
            self._counts[oid] = n
            if n == 1 and self._released.pop(oid, False) is None:
                self._cw._pin(oid)

    def remove_local_reference(self, oid: ObjectID) -> None:
        with self._lock:
            n = self._counts.get(oid, 0) - 1
            if n > 0:
                self._counts[oid] = n
                return
            self._counts.pop(oid, None)
            self._released[oid] = None
            self._released.move_to_end(oid)
            while len(self._released) > self._RELEASED_CAP:
                self._released.popitem(last=False)
            self._cw._release(oid)

    def add_owned_object(self, oid, **kw) -> None:  # client owns nothing
        pass

    def pin(self, oid) -> None:
        pass

    def live_oids(self) -> List[ObjectID]:
        """Every oid the client still holds refs to — what a resumed
        session must re-pin on the (possibly restarted) head."""
        with self._lock:
            return list(self._counts)


class ClientWorker:
    """Installed as the global worker when init(address='ray://...')."""

    is_client = True
    needs_serialized_funcs = True  # funcs ship to the server by value

    # ops safe to transparently re-issue on a resumed session: reads
    # and at-least-once-safe mutations. Anything that CREATES (put,
    # submit, create_actor, actor_call) must instead fail its caller —
    # re-sending could execute the side effect twice.
    _RESUMABLE_OPS = frozenset({
        "get", "wait", "state", "kv", "ping", "release", "pin",
        "cancel", "get_actor", "kill_actor",
    })

    def __init__(self, host: str, port: int, authkey: bytes):
        self.worker_id = WorkerID.from_random()
        self.job_id = JobID.from_random()  # provisional ids only
        self.alive = True
        self.client_id = uuid.uuid4().hex
        # the client_id doubles as the SESSION TOKEN: reconnecting with
        # the same id resumes the server-side session (pin inheritance)
        # instead of opening a fresh one
        self._endpoint = (host, port, authkey)
        self._closing = False
        self._send_lock = threading.Lock()
        self._replies: Dict[int, list] = {}  # req_id -> [ev, slot, op, payload, sent]
        self._req_seq = 0
        self._seq_lock = threading.Lock()
        self.reference_counter = _ClientRC(self)
        self._task_seq_lock = threading.Lock()
        self._task_seq = 0
        # multiplexed ready-callback waiter (futures / await on refs)
        self._waiting: Dict[ObjectID, list] = {}
        self._waiter_lock = threading.Lock()
        self._waiter_wake = threading.Event()
        self._waiter_thread: Optional[threading.Thread] = None
        self._conn = self._dial()
        self._reader_thread = threading.Thread(
            target=self._reader, daemon=True, name="ray_tpu_client_reader")
        self._reader_thread.start()
        if not self.ping():
            raise ConnectionError("head accepted the session but its "
                                  "serve thread is not answering")

    # -- transport ----------------------------------------------------
    def _dial(self):
        """Connect + hello + ready handshake; returns the live conn."""
        from multiprocessing.connection import Client as _Connect
        from ray_tpu_torch._private.protocol import make_wire_hello

        host, port, authkey = self._endpoint
        conn = _Connect((host, port), authkey=authkey)
        try:
            conn.send(make_wire_hello("client", self.client_id))
            ready = conn.recv()
        except BaseException:
            try:
                conn.close()
            except Exception:
                pass
            raise
        if isinstance(ready, tuple) and ready[:1] == ("error",):
            # e.g. protocol-version rejection: surface the head's reason
            conn.close()
            raise ConnectionError(str(ready[1]))
        if ready != ("ready",):
            conn.close()
            raise ConnectionError("head did not acknowledge the client "
                                  f"session (got {ready!r})")
        return conn

    def _reader(self) -> None:
        while True:
            try:
                msg = self._conn.recv()
                # a malformed reply must kill the session loudly (alive
                # False + waiters woken), not this thread silently —
                # otherwise every pending and future _rpc hangs forever
                req_id, ok, data = msg
            except (EOFError, OSError, TypeError, ValueError):
                if not self._closing and self._try_reconnect():
                    continue
                self.alive = False
                for ent in list(self._replies.values()):
                    ent[0].set()
                return
            ent = self._replies.pop(req_id, None)
            if ent is not None:
                ent[1][:] = [ok, data]
                ent[0].set()

    def _try_reconnect(self) -> bool:
        """The link to the head died mid-session: keep re-dialing with
        the SAME client_id until `client_reconnect_timeout_s` runs out.
        On rebind the server resumes the session (or, after a head
        restart, opens a new one under the old token); live refs are
        re-pinned and in-flight idempotent ops are re-issued so a
        driver blocked in get() resolves once failover reconciliation
        re-completes its objects. In-flight CREATING ops (put/submit/
        actor calls) are failed with ConnectionError instead — replay
        could run their side effects twice."""
        timeout = GLOBAL_CONFIG.client_reconnect_timeout_s
        if timeout <= 0:
            return False
        deadline = time.monotonic() + timeout
        delay = 0.1
        logger.warning("client session %s lost its head connection; "
                       "reconnecting for up to %.0fs",
                       self.client_id[:8], timeout)
        while not self._closing and time.monotonic() < deadline:
            try:
                conn = self._dial()
            except Exception:
                time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
                delay = min(delay * 2, 2.0)
                continue
            unsafe: list = []
            with self._send_lock:
                try:
                    self._conn.close()
                except Exception:
                    pass
                self._conn = conn
                try:
                    live = self.reference_counter.live_oids()
                    if live:
                        with self._seq_lock:
                            self._req_seq += 1
                            rid = self._req_seq
                        conn.send(("pin", rid,
                                   ([o.binary() for o in live],)))
                    replayed = 0
                    for req_id, ent in list(self._replies.items()):
                        _ev, _slot, op, payload, sent = ent
                        if not sent:
                            # its _rpc has not sent yet; it will go out
                            # on the new conn by itself
                            continue
                        if op in self._RESUMABLE_OPS:
                            conn.send((op, req_id, payload))
                            replayed += 1
                        else:
                            unsafe.append((req_id, ent))
                except (OSError, ValueError):
                    continue  # new link died during replay: dial again
            # fail the non-replayable ops outside the send lock (no
            # reply can race in for them: they were never re-sent)
            for req_id, ent in unsafe:
                self._replies.pop(req_id, None)
                ent[1][:] = [False, cloudpickle.dumps(
                    ConnectionError(
                        f"client op {ent[2]!r} was in flight when the "
                        "head connection dropped; it cannot be "
                        "replayed safely"))]
                ent[0].set()
            logger.warning("client session %s rebound to the head "
                           "(%d in-flight ops replayed)",
                           self.client_id[:8], replayed)
            return True
        return False

    def _rpc(self, op: str, *payload, timeout: Optional[float] = None):
        if not self.alive:
            raise ConnectionError("client session disconnected")
        with self._seq_lock:
            self._req_seq += 1
            req_id = self._req_seq
        ev: threading.Event = threading.Event()
        slot: list = []
        ent = [ev, slot, op, payload, False]
        self._replies[req_id] = ent
        if not self.alive:
            # registered after the reader's disconnect sweep: bail now
            # instead of waiting forever on a reply that cannot come
            self._replies.pop(req_id, None)
            raise ConnectionError("client session disconnected")
        try:
            with self._send_lock:
                self._conn.send((op, req_id, payload))
                ent[4] = True  # sent: a reconnect must replay or fail it
        except (OSError, ValueError):
            # link down mid-send. The reader is (or will be) in its
            # reconnect loop; a rebind replays sent ops only, so mark
            # this one sent too — the frame may have partially left —
            # and fall through to the wait. If reconnection fails the
            # reader's sweep wakes us below.
            ent[4] = True
            if self._closing or GLOBAL_CONFIG.client_reconnect_timeout_s <= 0:
                self._replies.pop(req_id, None)
                raise ConnectionError("client session disconnected")
        if not ev.wait(timeout) or not slot:
            self._replies.pop(req_id, None)
            if not self.alive:
                raise ConnectionError("client session disconnected")
            raise rex.GetTimeoutError(f"client rpc {op} timed out")
        ok, data = slot
        if not ok:
            raise cloudpickle.loads(data)
        return data

    def _send_oneway(self, op: str, oid: ObjectID) -> None:
        """Fire-and-forget op: no reply wait (reader drops unmatched)."""
        if not self.alive:
            return
        try:
            with self._seq_lock:
                self._req_seq += 1
                req_id = self._req_seq
            with self._send_lock:
                self._conn.send((op, req_id, ([oid.binary()],)))
        except (OSError, ValueError):
            pass

    def _release(self, oid: ObjectID) -> None:
        self._send_oneway("release", oid)

    def _pin(self, oid: ObjectID) -> None:
        """Re-pin of a released oid being re-added (see _ClientRC)."""
        self._send_oneway("pin", oid)

    # -- context helpers (provisional; the server re-keys) -------------
    def next_task_id(self) -> TaskID:
        with self._task_seq_lock:
            self._task_seq += 1
            return TaskID.of(self.job_id, seq=self._task_seq)

    @property
    def current_task_id(self) -> TaskID:
        return TaskID.of(self.job_id)

    def was_current_task_cancelled(self) -> bool:
        return False

    def defer_unref(self, oid: ObjectID) -> None:
        self.reference_counter.remove_local_reference(oid)

    def run_callback_when_ready(self, oid, cb) -> None:
        """Async/future support in client mode (`await ref`,
        ref.future()): ONE multiplexed waiter thread cycles a server-
        side wait over every pending oid and fires callbacks as they
        land — thread-per-ref would explode under fan-out awaits
        (reference: the client dataserver's async get)."""
        with self._waiter_lock:
            self._waiting.setdefault(oid, []).append(cb)
            if self._waiter_thread is None \
                    or not self._waiter_thread.is_alive():
                self._waiter_thread = threading.Thread(
                    target=self._waiter_loop, daemon=True,
                    name="ray_tpu_client_waiter")
                self._waiter_thread.start()
        self._waiter_wake.set()

    def _waiter_loop(self) -> None:
        while self.alive:
            with self._waiter_lock:
                oids = list(self._waiting)
            if not oids:
                self._waiter_wake.wait(timeout=5.0)
                self._waiter_wake.clear()
                continue
            refs = [ObjectRef(o, None, _register=False) for o in oids]
            try:
                ready, _ = self.wait(refs, 1, 2.0)
            except Exception:
                if not self.alive:
                    ready = refs  # fire everything: gets surface errors
                else:
                    continue
            fired = []
            with self._waiter_lock:
                for r in ready:
                    fired.extend(self._waiting.pop(r.object_id(), ()))
            for cb in fired:
                try:
                    cb()
                except Exception:
                    logger.exception("ready callback failed")

    # -- object plane ---------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed")
        oid_bin = self._rpc("put", cloudpickle.dumps(value, protocol=5))
        return ObjectRef(ObjectID(oid_bin), None)

    def get(self, refs: Sequence[ObjectRef],
            timeout: Optional[float]) -> List[Any]:
        blobs = self._rpc("get", [r.object_id().binary() for r in refs],
                          timeout)
        return [cloudpickle.loads(b) for b in blobs]

    def wait(self, refs: Sequence[ObjectRef], num_returns: int,
             timeout: Optional[float]):
        ready_bins = set(self._rpc(
            "wait", [r.object_id().binary() for r in refs], num_returns,
            timeout))
        ready, not_ready = [], []
        for r in refs:
            (ready if r.object_id().binary() in ready_bins
             and len(ready) < num_returns else not_ready).append(r)
        return ready, not_ready

    # -- task plane -----------------------------------------------------
    def submit_task(self, spec) -> List[ObjectRef]:
        d = dict(
            name=spec.name,
            func_blob=spec.serialized_func or cloudpickle.dumps(spec.func),
            func_descriptor=spec.func_descriptor,
            args_blob=cloudpickle.dumps((spec.args, spec.kwargs), protocol=5),
            num_returns=spec.num_returns,
            resources=spec.resources,
            max_retries=spec.max_retries,
            retry_exceptions=spec.retry_exceptions,
            runtime_env=spec.runtime_env,
            generator=spec.generator,
        )
        if spec.scheduling_strategy is not None:
            d["strategy_blob"] = cloudpickle.dumps(spec.scheduling_strategy)
        if spec.placement_group_id is not None:
            d["pg_id"] = spec.placement_group_id.binary()
            d["pg_bundle_index"] = spec.placement_group_bundle_index
            d["pg_capture"] = spec.placement_group_capture_child_tasks
        # QoS tier/tenant ride only when non-default (qos=False blobs
        # stay byte-for-byte pre-QoS)
        if getattr(spec, "priority", 0):
            d["priority"] = spec.priority
        if getattr(spec, "tenant", "default") != "default":
            d["tenant"] = spec.tenant
        return_bins = self._rpc("submit", cloudpickle.dumps(d))
        return [ObjectRef(ObjectID(b), None) for b in return_bins]

    def cancel_task(self, ref: ObjectRef, force: bool = False) -> None:
        self._rpc("cancel", ref.object_id().binary(), force)

    # -- actors ---------------------------------------------------------
    def create_actor(self, cls: type, opts: dict, args, kwargs):
        from ray_tpu_torch.actor import ActorHandle
        actor_bin, class_name = self._rpc(
            "create_actor", cloudpickle.dumps(cls), cloudpickle.dumps(opts),
            cloudpickle.dumps((args, kwargs), protocol=5))
        return ActorHandle(ActorID(actor_bin), class_name)

    def actor_call(self, actor_id: ActorID, method: str, args, kwargs,
                   num_returns: int):
        bins = self._rpc("actor_call", actor_id.binary(), method,
                         cloudpickle.dumps((args, kwargs), protocol=5),
                         num_returns)
        refs = [ObjectRef(ObjectID(b), None) for b in bins]
        return refs[0] if num_returns == 1 else refs

    def get_actor(self, name: str, namespace: str):
        from ray_tpu_torch.actor import ActorHandle
        actor_bin, class_name = self._rpc("get_actor", name, namespace)
        return ActorHandle(ActorID(actor_bin), class_name)

    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        self._rpc("kill_actor", actor_id.binary(), no_restart)

    # -- state ----------------------------------------------------------
    def state(self, verb: str, *args):
        return self._rpc("state", verb, *args)

    # -- cluster KV (GCS client accessor analog) -------------------------
    def kv_get(self, key: bytes, namespace: str = ""):
        return self._rpc("kv", "get", namespace, bytes(key), None)

    def kv_put(self, key: bytes, value: bytes,
               namespace: str = "") -> None:
        self._rpc("kv", "put", namespace, bytes(key), bytes(value))

    def kv_del(self, key: bytes, namespace: str = "") -> bool:
        return self._rpc("kv", "del", namespace, bytes(key), None)

    def kv_keys(self, prefix: bytes = b"", namespace: str = ""):
        return self._rpc("kv", "keys", namespace, bytes(prefix), None)

    # -- lifecycle -------------------------------------------------------
    def ping(self, timeout: Optional[float] = 10.0) -> bool:
        """Round-trip liveness probe through the request/reply plane.

        The hello/ready handshake only proves the accept thread ran;
        this proves the per-session serve thread is dispatching ops."""
        return self._rpc("ping", timeout=timeout) == "pong"

    def shutdown(self) -> None:
        self._closing = True  # a deliberate close must not reconnect
        self.alive = False
        # close() alone cannot interrupt a reader blocked in recv: the
        # blocked syscall pins the open file description, so the socket
        # never sends FIN (the head's serve thread lingers forever) while
        # the freed fd NUMBER gets recycled to the next init()'s socket —
        # where the stale reader then steals handshake bytes ("bad
        # message length" / wrong-digest auth failures). A socket-level
        # SHUT_RDWR acts on the shared description and DOES wake the
        # reader with EOF; join it before closing so the fd cannot be
        # recycled under a thread that still references it.
        try:
            import os as _os
            import socket as _socket
            dup = _socket.socket(fileno=_os.dup(self._conn.fileno()))
            try:
                dup.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            finally:
                dup.close()
        except Exception:
            pass
        r = getattr(self, "_reader_thread", None)
        if r is not None and r is not threading.current_thread():
            r.join(timeout=2.0)
        with self._send_lock:
            try:
                self._conn.close()
            except Exception:
                pass


def parse_client_address(address: str) -> Tuple[str, int, Optional[bytes]]:
    """ray://host:port?key=<hex> -> (host, port, authkey|None)."""
    if not address.startswith("ray://"):
        raise ValueError(
            f"bad client address {address!r}: must start with ray:// "
            "(the head's connect string: ray://host:port?key=<hex> of "
            "Worker.enable_head_endpoint's address and authkey)")
    rest = address[len("ray://"):]
    key: Optional[bytes] = None
    if "?" in rest:
        rest, _, query = rest.partition("?")
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if k == "key":
                key = bytes.fromhex(v)
    host, _, port = rest.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"bad client address {address!r}: expected "
            "ray://host:port[?key=hex]")
    return host, int(port), key

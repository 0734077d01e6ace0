"""Worker process main loop — the core-worker analog for process mode.

Reference surfaces: ray src/ray/core_worker/core_worker.cc (task receiver
+ execute loop in every worker process) and python/ray/_private/worker.py
(the worker-side of execute_task). Each worker process:

  - attaches the node's shm arena (zero-copy object data plane),
  - receives task messages over its private pipe from the node owner
    (the driver), executes, and ships results back (inline if small,
    via create/seal into the arena if large),
  - installs a lightweight worker context so `ray_tpu_torch.get/put/remote`
    called INSIDE tasks route through owner RPC over the same pipe,
  - runs a control thread for cooperative cancellation.

A worker spawned by a remote node's daemon talks to that daemon over
the same pipe (pipe only: no shared-memory rings), resolves
``_PullValue`` args and spilled objects through it, and honours the
daemon's two-level and p2p advertisements. Under ``profile_hz > 0`` a
sampler thread ships the worker's folded stacks as ``("prof", ...)``
frames on the same pipe.

Protocol invariant that makes the single pipe safe: the owner sends at
most one task to a worker at a time, and while that task runs the only
owner->worker traffic on the task pipe is RPC replies — so the executing
thread can issue a blocking send/recv RPC without racing the main loop.
Cancellation travels on a separate control pipe.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import traceback
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private.ids import ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.runtime.shm_store import (
    RING_TAG_BYTE as _RING_TAG_BYTE, RING_TAGS as _RING_TAGS,
    ControlRing, ShmArena)
from ray_tpu_torch._private.serialization import (
    NONE_FRAMED, SerializedObject, deserialize,
    encode_completion_envelope, serialize)
from ray_tpu_torch._private.task_spec import decode_task_envelope

INLINE_MAX_DEFAULT = 100 * 1024
AUTHKEY_ENV = "RAY_TPU_TORCH_AUTHKEY"
# the profile_hz knob through the config registry's environment override,
# for an owner configured by _system_config
PROFILE_HZ_ENV = "RAY_TPU_TORCH_PROFILE_HZ"


class _ShmValue:
    """Placeholder for a resolved arg whose bytes live in the arena."""

    __slots__ = ("offset", "nbytes")

    def __init__(self, offset: int, nbytes: int):
        self.offset = offset
        self.nbytes = nbytes


class _PullValue:
    """Placeholder for an arg resident in the WORKER's node arena (or
    pullable through it): resolved by a get RPC, which the node daemon
    answers with a zero-copy arena location when the object is already
    local (remote-node locality path — the head ships this marker
    instead of bytes when the dep lives where the task runs)."""

    __slots__ = ("oid_bin",)

    def __init__(self, oid_bin: bytes):
        self.oid_bin = oid_bin


def fn_id_of(blob: bytes) -> bytes:
    return hashlib.sha1(blob).digest()


class ProcessWorkerContext:
    """Installed as ray_tpu_torch._private.worker.global_worker inside
    the worker process, so user code in tasks can call the public API.
    Routes get/put/submit to the owner over the pipe RPC."""

    needs_serialized_funcs = True  # nested submits ship funcs by value

    def __init__(self, runner: "_WorkerRunner"):
        self._runner = runner
        self.alive = True
        self.worker_id = WorkerID.from_random()
        self.job_id = None  # set per task from the spec's task id

    # -- context -----------------------------------------------------------
    @property
    def current_task_id(self) -> Optional[TaskID]:
        return self._runner.current_task_id

    def next_put_id(self) -> ObjectID:
        self._runner.put_counter += 1
        return ObjectID.for_put(self._runner.current_task_id,
                                self._runner.put_counter)

    def was_current_task_cancelled(self) -> bool:
        tid = self._runner.current_task_id
        return tid is not None and tid.binary() in self._runner.cancelled

    # -- object plane ------------------------------------------------------
    def put(self, value: Any):
        from ray_tpu_torch._private.object_ref import ObjectRef

        if isinstance(value, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed")
        oid = self.next_put_id()
        loc = self._runner.store_value(oid, value)
        self._runner.rpc("put", (oid.binary(), loc))
        return ObjectRef(oid, None)

    def get(self, refs, timeout: Optional[float]) -> List[Any]:
        from ray_tpu_torch import exceptions as rex

        oid_bins = [r.object_id().binary() for r in refs]
        locs = self._runner.rpc("get", (oid_bins, timeout))
        out = []
        for loc in locs:
            kind = loc[0]
            if kind == "timeout":
                raise rex.GetTimeoutError(loc[1])
            if kind == "exc":
                exc = cloudpickle.loads(loc[1])
                if isinstance(exc, rex.TaskError):
                    raise exc.as_instanceof_cause()
                raise exc
            out.append(self._runner.load_location(loc))
        return out

    def wait(self, refs, num_returns: int, timeout: Optional[float]):
        oid_bins = [r.object_id().binary() for r in refs]
        ready_bins = set(self._runner.rpc(
            "wait", (oid_bins, num_returns, timeout)))
        ready, not_ready = [], []
        for r in refs:
            (ready if r.object_id().binary() in ready_bins
             and len(ready) < num_returns else not_ready).append(r)
        return ready, not_ready

    # -- task plane --------------------------------------------------------
    def submit_task(self, spec) -> list:
        from ray_tpu_torch._private.object_ref import ObjectRef

        # mark_refs only when the node daemon advertised local dispatch:
        # the extra has_refs key changes the submit blob, and with the
        # knob off the wire must stay byte-for-byte pre-two-level
        blob = _dump_spec(spec, trace=self._runner.current_trace,
                          mark_refs=self._runner.two_level[0])
        return_bins = self._runner.rpc("submit", (blob,))
        return [ObjectRef(ObjectID(b), None) for b in return_bins]

    def next_task_id(self) -> TaskID:
        # ids for nested submissions are assigned by the owner; this is a
        # provisional id replaced at owner admission
        return TaskID.of(self._runner.current_task_id.job_id())

    def actor_call(self, actor_id, method_name: str, args, kwargs,
                   num_returns: int = 1):
        """Actor method invoked from inside a worker-process task:
        route the submission to the owner (which holds the actor
        runtime tables) over the pipe RPC."""
        from ray_tpu_torch._private.object_ref import ObjectRef

        if self._runner.two_level[1]:
            # p2p lane advertised by the node daemon: ship routing meta
            # alongside the (unchanged) call blob so the daemon can
            # dispatch straight to the actor's peer without unpickling
            # user args. Ref-carrying calls stay head-routed (the owner
            # resolves/borrow-tracks refs).
            blob, refs = _dumps_mark_refs(
                (actor_id.binary(), method_name, args, kwargs,
                 num_returns, self._runner.current_trace))
            meta = (actor_id.binary(), method_name, num_returns,
                    self._runner.current_trace, not refs)
            ret_bins = self._runner.rpc("actor_call", (blob, meta))
        else:
            blob = cloudpickle.dumps(
                (actor_id.binary(), method_name, args, kwargs, num_returns,
                 self._runner.current_trace),
                protocol=5)
            ret_bins = self._runner.rpc("actor_call", (blob,))
        refs = [ObjectRef(ObjectID(b), None) for b in ret_bins]
        return refs[0] if num_returns == 1 else refs

    # -- no-op surfaces (single-owner model: the driver owns refcounts) ----
    class _NoopRC:
        def add_local_reference(self, oid):  # borrows tracked owner-side
            pass

        def remove_local_reference(self, oid):
            pass

    reference_counter = _NoopRC()

    def defer_unref(self, oid) -> None:
        pass

    def run_callback_when_ready(self, oid, cb) -> None:
        raise NotImplementedError(
            "futures/await on refs are driver-side APIs")


def _dumps_mark_refs(value) -> Tuple[bytes, list]:
    """cloudpickle.dumps plus "which ObjectRefs rode inside" — one
    pass, same bytes. The two-level dispatch paths need the answer
    (ref-carrying payloads only admit locally when every arg is
    provably node-resident, so the daemon needs the ids to check its
    residency digest), and a second scan pass over large args would
    double serialization cost on the hot path."""
    import io

    from ray_tpu_torch._private.object_ref import ObjectRef

    seen: list = []

    class _P(cloudpickle.Pickler):
        def reducer_override(self, obj):
            if isinstance(obj, ObjectRef):
                seen.append(obj)
            # chain to cloudpickle's reducer (lambdas, closures,
            # __main__ classes pickle by value) — see _RefCollectPickler
            return super().reducer_override(obj)

    buf = io.BytesIO()
    _P(buf, protocol=5).dump(value)
    return buf.getvalue(), seen


def _dump_spec(spec, trace=None, mark_refs=False) -> bytes:
    """Ship a TaskSpec for owner-side admission (func by value).
    ``trace`` is the SUBMITTING task's trace context: the owner restores
    it as the ambient parent around admission so the nested task's own
    context is stamped as its child. ``mark_refs`` adds has_refs / arg_refs
    keys (for the daemon's local-dispatch eligibility and residency
    checks) — only set when the daemon advertised two-level dispatch,
    so the knobs-off blob is unchanged."""
    arg_refs: Optional[list] = None
    if mark_refs:
        args_blob, refs = _dumps_mark_refs((spec.args, spec.kwargs))
        has_refs = bool(refs)
        if refs:
            arg_refs = [r.object_id().binary() for r in refs]
    else:
        args_blob = cloudpickle.dumps((spec.args, spec.kwargs))
        has_refs = None
    d = dict(
        name=spec.name,
        func_blob=spec.serialized_func or cloudpickle.dumps(spec.func),
        func_descriptor=spec.func_descriptor,
        args_blob=args_blob,
        num_returns=spec.num_returns,
        resources=spec.resources,
        max_retries=spec.max_retries,
        retry_exceptions=spec.retry_exceptions,
    )
    if has_refs is not None:
        d["has_refs"] = has_refs
    if arg_refs:
        d["arg_refs"] = arg_refs
    if trace is not None:
        d["trace"] = trace
    if spec.placement_group_id is not None:
        d["pg_id"] = spec.placement_group_id.binary()
        d["pg_bundle_index"] = spec.placement_group_bundle_index
        d["pg_capture"] = spec.placement_group_capture_child_tasks
    # QoS tier/tenant ride only when non-default, so qos=False (where
    # they are always default) keeps the submit blob byte-for-byte
    priority = getattr(spec, "priority", 0)
    if priority:
        d["priority"] = priority
    tenant = getattr(spec, "tenant", "default")
    if tenant != "default":
        d["tenant"] = tenant
    return cloudpickle.dumps(d)


class _WorkerRunner:
    def __init__(self, conn, ctrl_conn, arena_name: str, inline_max: int,
                 ring_spec: Optional[Tuple[int, int, int, int]] = None):
        self.conn = conn
        self.ctrl_conn = ctrl_conn
        self.arena = ShmArena.attach(arena_name) if arena_name else None
        self.inline_max = inline_max
        # shm control rings (local pools, control_ring on): the owner
        # carved (task-ring offset, completion-ring offset, nslots,
        # slot_bytes) out of the arena and passed the geometry on argv;
        # daemon-spawned remote workers stay pipe-only (no ring_spec)
        self.task_ring: Optional[ControlRing] = None
        self.comp_ring: Optional[ControlRing] = None
        if ring_spec is not None and self.arena is not None:
            off_in, off_out, nslots, sbytes = ring_spec
            self.task_ring = ControlRing(self.arena, off_in, nslots, sbytes)
            self.comp_ring = ControlRing(self.arena, off_out, nslots, sbytes)
        # lease-envelope invariant headers, keyed by the small int id
        # the owner assigned (see task_spec.decode_task_envelope)
        self.hdr_cache: Dict[int, tuple] = {}
        self.fn_cache: Dict[bytes, Any] = {}
        self.actor_instance: Any = None  # set by actor_create (dedicated)
        self.current_task_id: Optional[TaskID] = None
        # the running task's user-facing name: the profile sampler tags
        # folded stacks "name:taskid" so flamegraphs read in task terms
        self.current_task_name: Optional[str] = None
        # the running task's TraceContext (from the payload's "trace"
        # key), re-shipped with nested submissions / actor calls so
        # parentage crosses the process boundary
        self.current_trace = None
        self.put_counter = 0
        # (local_dispatch, actor_p2p) as advertised by the spawning node
        # daemon's ("p2p", local, p2p) broadcast; both stay False under
        # head-spawned workers and when the knobs are off, keeping the
        # submit/actor-call wire bytes identical to pre-two-level
        self.two_level: Tuple[bool, bool] = (False, False)
        # exactly-once guard for p2p->head fallback retries: payloads
        # marked dedup=True cache their completion message by task id so
        # a re-delivered attempt re-emits the SAME result bytes instead
        # of re-executing the method (bounded; fallbacks are rare)
        self._dedup_done: "OrderedDict[bytes, tuple]" = OrderedDict()
        self.cancelled: set = set()  # task_id binaries
        self._rpc_seq = 0
        self._rpc_lock = threading.RLock()
        self._inbox: list = []  # tasks that arrived during a blocking rpc
        self._done_buf: Optional[list] = None  # batch-mode completion buffer
        # replies that arrived out of order: an OUTER task's get-reply
        # can land while a NESTED task's rpc is waiting (see _run_nested)
        self._pending_replies: Dict[int, tuple] = {}
        self._stop = False

    def _emit(self, msg: tuple) -> None:
        """Completion message: buffered during a leased batch (one pipe
        write per batch, one owner wakeup), immediate otherwise.

        Pipe writes here and below take _rpc_lock: the profile sampler
        thread shares this pipe for its ("prof", ...) batches, and
        interleaved frames would corrupt the stream. Uncontended (the
        sampler does not exist) when profile_hz=0."""
        if self._done_buf is not None:
            self._done_buf.append(msg)
        else:
            with self._rpc_lock:
                self.conn.send(msg)

    def _flush_dones(self) -> None:
        buf = self._done_buf
        if not buf:
            return
        self._done_buf = []
        if self.comp_ring is not None:
            blob = encode_completion_envelope(buf)
            if blob is not None and self._ring_emit(("cenv", blob)):
                return
        # pipe path: no ring, envelope-ineligible items, oversize, or
        # ring full — exactly the pre-ring framed messages
        with self._rpc_lock:
            if len(buf) == 1:
                self.conn.send(buf[0])
            else:
                self.conn.send(("many", buf))

    def _ring_emit(self, msg: tuple) -> bool:
        """Publish one completion envelope on the shm ring + pipe
        doorbell; False = caller falls back to the pipe. Only the main
        thread produces (nested executions flush per-completion over
        the pipe), so the SPSC contract holds without a lock."""
        ring = self.comp_ring
        if ring is None:
            return False
        data = _RING_TAG_BYTE[msg[0]] + msg[1]
        if len(data) > ring.max_msg or not ring.try_put(data):
            return False
        with self._rpc_lock:
            self.conn.send(("cring",))
        return True

    # -- RPC to the owner --------------------------------------------------
    def rpc(self, op: str, args: tuple):
        blocking = op in ("get", "wait")
        with self._rpc_lock:
            if blocking:
                # tasks dispatched to THIS slot mid-rpc (the daemon's
                # local scheduler may pick the submitter as a last
                # resort) queue in the inbox; the outer task is about
                # to block — possibly on those very results — so run
                # them now, same reasoning as the pipelined-pipe case
                # below
                while True:
                    m = next((x for x in self._inbox
                              if x[0] in ("task", "tasks", "env",
                                          "ring")), None)
                    if m is None:
                        break
                    self._inbox.remove(m)
                    self._run_nested(m)
            # owner-side borrow bookkeeping attributes this rpc to the
            # OLDEST unfinished lease: completions buffered for batch
            # send must reach the owner first
            self._flush_dones()
            self._rpc_seq += 1
            req_id = self._rpc_seq
            self.conn.send(("rpc", req_id, op, args))
            while True:
                if req_id in self._pending_replies:
                    msg = self._pending_replies.pop(req_id)
                else:
                    msg = self.conn.recv()
                if msg[0] == "reply":
                    if msg[1] != req_id:
                        self._pending_replies[msg[1]] = msg
                        continue
                    ok, data = msg[2], msg[3]
                    if not ok:
                        raise cloudpickle.loads(data)
                    return data
                if msg[0] in ("task", "tasks", "env", "ring"):
                    if blocking:
                        # a pipelined task queued BEHIND a task that is
                        # blocked waiting (possibly on that very task's
                        # result) would deadlock the pipe — execute it
                        # NOW, nested, like the reference's blocked-get
                        # worker reuse (ray: CPU release during ray.get)
                        self._run_nested(msg)
                    else:
                        self._inbox.append(msg)
                    continue
                if msg[0] in ("actor_create", "actor_call", "exit"):
                    # queue for the main loop (arrival order preserved)
                    self._inbox.append(msg)
                    continue
                if msg[0] == "p2p":
                    # daemon two-level advertisement — may land mid-rpc
                    self.two_level = (bool(msg[1]), bool(msg[2]))
                    continue
                # protocol violation — only replies may arrive mid-task
                raise RuntimeError(f"unexpected message during rpc: {msg[0]}")

    def _run_nested(self, msg: tuple) -> None:
        """Execute task(s) while an outer task blocks in get/wait.
        Completions ship immediately (the outer task may be waiting on
        them); task context saves/restores around each execution."""
        buf, self._done_buf = self._done_buf, None
        try:
            kind = msg[0]
            if kind == "task":
                self.execute(msg[1])
            elif kind == "env":
                for p in decode_task_envelope(msg[1], self.hdr_cache):
                    self.execute(p)
            elif kind == "ring":
                for p in self._drain_ring_payloads():
                    self.execute(p)
            else:
                for p in msg[1]:
                    self.execute(p)
        finally:
            self._done_buf = buf

    # -- value movement ----------------------------------------------------
    def store_value(self, oid: ObjectID, value: Any) -> tuple:
        """Serialize; small -> inline tuple, large -> create/seal in arena."""
        if value is None:
            # no-return tasks dominate high-rate fan-outs; reuse the
            # precomputed frame (the owner recognizes it by bytes and
            # skips deserialization too)
            return ("inline", NONE_FRAMED)
        sobj = serialize(value)
        nbytes = sobj.framed_nbytes()
        if self.arena is None or nbytes <= self.inline_max:
            return ("inline", sobj.to_bytes())
        try:
            offset = self.rpc("create", (oid.binary(), nbytes))
        except Exception:
            # arena full/fragmented: ship inline rather than fail the task
            return ("inline", sobj.to_bytes())
        sobj.write_into(self.arena.view(offset, nbytes))
        return ("shm", offset, nbytes)

    def load_location(self, loc: tuple) -> Any:
        if loc[0] == "inline":
            return deserialize(SerializedObject.from_bytes(loc[1]))
        if loc[0] == "shm":
            _, offset, nbytes = loc
            view = self.arena.view(offset, nbytes)
            return deserialize(SerializedObject.from_bytes(view))
        if loc[0] == "spill_file":
            # same-host spill tier: objects bigger than the arena are
            # read straight off their file (mmap — the page cache
            # backs the buffers; nothing rides the daemon pipe)
            import mmap

            _, path, nbytes = loc
            with open(path, "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            try:
                return deserialize(
                    SerializedObject.from_bytes(memoryview(mm)))
            finally:
                # deserialize COPIES out-of-band buffers it keeps?
                # No — views may reference mm; keep mm alive by NOT
                # closing when buffers escaped. CPython: closing a
                # mapped mmap with exported views raises BufferError —
                # treat that as "value borrowed the pages" and leak the
                # mapping to the GC instead.
                try:
                    mm.close()
                except BufferError:
                    pass
        raise ValueError(f"bad location {loc[0]!r}")

    # -- control thread ----------------------------------------------------
    def _ctrl_loop(self):
        while not self._stop:
            try:
                msg = self.ctrl_conn.recv()
            except (EOFError, OSError):
                return
            if msg[0] == "cancel":
                self.cancelled.add(msg[1])

    # -- task / actor execution --------------------------------------------
    def execute(self, payload: dict) -> None:
        from ray_tpu_torch import exceptions as rex

        def run(args, kwargs):
            fn_id = payload["fn_id"]
            fn = self.fn_cache.get(fn_id)
            if fn is None:
                fn = cloudpickle.loads(payload["fn_blob"])
                self.fn_cache[fn_id] = fn
            return fn(*args, **kwargs)

        # cache the fn on ARRIVAL, not first successful run: the owner's
        # sent_fns dedupe marks the blob delivered at send time, so a
        # task that dies before run() (chaos injection, cancel) would
        # otherwise leave this worker receiving fn_blob=None payloads
        # for a fn it never cached
        try:
            if payload.get("fn_blob") is not None \
                    and payload["fn_id"] not in self.fn_cache:
                self.fn_cache[payload["fn_id"]] = \
                    cloudpickle.loads(payload["fn_blob"])
        except Exception:
            pass  # run() retries the load and reports the real error
        self._run_payload(payload, run)

    def actor_create(self, payload: dict) -> None:
        def run(args, kwargs):
            # per-actor runtime_env: this process is DEDICATED to the
            # actor, so env_vars/working_dir/pip apply for its whole
            # lifetime (no restore — the reference builds the actor's
            # env around its worker process the same way)
            actor_env = payload.get("actor_env_vars")
            if actor_env:
                import os as _os

                _os.environ.update(actor_env)
            if payload.get("actor_working_dir_pkg") or \
                    payload.get("actor_pip"):
                from ray_tpu_torch._private import runtime_envs as rte

                mgr = rte.get_manager()
                wd_path = None
                pkg = payload.get("actor_working_dir_pkg")
                if pkg:
                    wd_path = mgr.ensure_working_dir(
                        pkg, lambda: self.rpc("env_pkg", (pkg,)))
                sp = None
                if payload.get("actor_pip"):
                    sp = mgr.ensure_pip(list(payload["actor_pip"]))
                # entered, never exited: lifetime env
                rte.applied_env(wd_path, sp, use_cwd=True).__enter__()
            cls = cloudpickle.loads(payload["cls_blob"])
            self.actor_instance = cls(*args, **kwargs)
            return "ALIVE"

        self._run_payload(payload, run)

    def actor_call(self, payload: dict) -> None:
        # peer-dispatched calls carry the CALLER's pickled call tuple
        # (the daemon lane never unpickles user args — only this
        # dedicated actor process has the user's modules); eligibility
        # guaranteed it holds no ObjectRefs, so no _resolve pass needed
        pb = payload.get("p2p_blob")

        def run(args, kwargs):
            import inspect
            if pb is not None:
                # decode inside the guarded path: a blob that fails to
                # unpickle (caller-only module, corrupt frame) must error
                # THIS call, not crash the dedicated actor process
                t = cloudpickle.loads(pb)
                args, kwargs = t[2], t[3]
            method = getattr(self.actor_instance, payload["method"])
            result = method(*args, **kwargs)
            if inspect.isgenerator(result):
                result = list(result)
            return result

        self._run_payload(payload, run)

    def _run_payload(self, payload: dict, run) -> None:
        from ray_tpu_torch import exceptions as rex

        task_id = TaskID(payload["task_id"])
        if payload.get("dedup"):
            cached = self._dedup_done.get(payload["task_id"])
            if cached is not None:
                # a p2p attempt of this call already completed here and
                # the head is retrying after a severed peer lane: re-emit
                # the recorded result, bit for bit, without re-executing
                self._emit(cached)
                return
        # save/restore: a task may execute NESTED inside another task's
        # blocking get (see _run_nested)
        prev_task_id = self.current_task_id
        prev_put_counter = self.put_counter
        prev_trace = self.current_trace
        prev_task_name = self.current_task_name
        self.current_task_id = task_id
        self.current_trace = payload.get("trace")
        self.current_task_name = payload.get("name")
        self.put_counter = 0
        if self.current_trace is not None and payload.get("trace_mark"):
            # correlation marker for the log plane (trace_log_markers
            # knob): lands in this worker's capture file so get_log
            # output lines up with the trace's exec spans
            print(f"== trace {self.current_trace[0]} span "
                  f"{self.current_trace[1]} task {task_id.hex()} ==",
                  flush=True)
        pg_token = None
        if payload.get("pg") is not None:
            # placement-group capture context shipped from the owner
            from ray_tpu_torch._private.ids import PlacementGroupID
            from ray_tpu_torch.util.placement_group import _current_pg

            pg_token = _current_pg.set(PlacementGroupID(payload["pg"]))
        env_saved = None
        env_vars = payload.get("env_vars") or {}
        if env_vars:
            import os as _os

            env_saved = {k: _os.environ.get(k) for k in env_vars}
            _os.environ.update(env_vars)
        env_ctx = None
        # execution window (wall clock)
        t0 = t1 = time.time()
        try:
            if payload.get("working_dir_pkg") or payload.get("pip"):
                # runtime env agent, worker half: extract/build into
                # the per-node cache (fetching package bytes over the
                # owner RPC once per node), then sys.path + cwd for
                # this task. INSIDE the try: a build failure (e.g. a
                # non-local pip requirement in this egress-less
                # environment) must fail the TASK, not the worker.
                from ray_tpu_torch._private import runtime_envs as rte

                mgr = rte.get_manager()
                wd_path = None
                pkg = payload.get("working_dir_pkg")
                if pkg:
                    wd_path = mgr.ensure_working_dir(
                        pkg, lambda: self.rpc("env_pkg", (pkg,)))
                sp = None
                if payload.get("pip"):
                    sp = mgr.ensure_pip(list(payload["pip"]))
                env_ctx = rte.applied_env(wd_path, sp, use_cwd=True)
                env_ctx.__enter__()
            ab = payload["args_blob"]
            if ab is None:
                # the lease envelope elides the empty-args blob
                args, kwargs = (), {}
            else:
                args, kwargs = cloudpickle.loads(ab)
                args = tuple(self._resolve(a) for a in args)
                kwargs = {k: self._resolve(v) for k, v in kwargs.items()}
            # the owner's seeded FaultController decided per task at
            # payload build; the worker only enacts the chosen kind
            inject = payload.get("inject_fault")
            if inject == "hang":
                time.sleep(payload.get("inject_hang_s", 0.2))
            elif inject is not None:
                raise rex.WorkerCrashedError("injected failure (chaos)")
            if task_id.binary() in self.cancelled:
                raise rex.TaskCancelledError(task_id)
            result = run(args, kwargs)
            t1 = time.time()
            num_returns = payload["num_returns"]
            if num_returns == 1:
                values = [result]
            else:
                values = list(result) if result is not None else []
                if len(values) != num_returns:
                    raise ValueError(
                        f"task {payload['name']} declared "
                        f"num_returns={num_returns} but returned "
                        f"{len(values)} values")
            return_ids = [ObjectID(b) for b in payload["return_ids"]]
            entries = [self.store_value(oid, v)
                       for oid, v in zip(return_ids, values)]
            # record BEFORE emit (a retry after an emit-then-crash must
            # replay, not re-execute); the completion frame itself stays
            # a literal tuple at the _emit site for the wire-lint pass
            if payload.get("dedup"):
                self._dedup_record(payload["task_id"],
                                   ("done", payload["task_id"], entries,
                                    (t0, t1)))
            self._emit(("done", payload["task_id"], entries, (t0, t1)))
        except BaseException as e:  # noqa: BLE001
            tb = traceback.format_exc()
            try:
                blob = cloudpickle.dumps(e)
            except Exception:
                blob = cloudpickle.dumps(
                    RuntimeError(f"[unpicklable {type(e).__name__}] {e}"))
            t_err = time.time()
            if payload.get("dedup"):
                self._dedup_record(payload["task_id"],
                                   ("err", payload["task_id"], blob, tb,
                                    (t0, t_err)))
            self._emit(("err", payload["task_id"], blob, tb, (t0, t_err)))
        finally:
            if env_ctx is not None:
                env_ctx.__exit__(None, None, None)
            if env_saved is not None:
                import os as _os

                for k, old in env_saved.items():
                    if old is None:
                        _os.environ.pop(k, None)
                    else:
                        _os.environ[k] = old
            if pg_token is not None:
                from ray_tpu_torch.util.placement_group import _current_pg

                _current_pg.reset(pg_token)
            self.cancelled.discard(task_id.binary())
            self.current_task_id = prev_task_id
            self.current_trace = prev_trace
            self.current_task_name = prev_task_name
            self.put_counter = prev_put_counter

    def _dedup_record(self, tid_bin: bytes, msg: tuple) -> None:
        self._dedup_done[tid_bin] = msg
        while len(self._dedup_done) > 256:
            self._dedup_done.popitem(last=False)

    def _resolve(self, v: Any) -> Any:
        from ray_tpu_torch._private.object_ref import ObjectRef

        if isinstance(v, _ShmValue):
            view = self.arena.view(v.offset, v.nbytes)
            return deserialize(SerializedObject.from_bytes(view))
        if isinstance(v, _PullValue):
            return self._fetch_arg(v.oid_bin)
        if isinstance(v, ObjectRef):
            # a locally-dispatched lease ships its args blob verbatim,
            # so top-level refs arrive unresolved; the daemon serves the
            # get from its arena when resident (the admission check
            # proved residency, so this normally never reaches the head)
            return self._fetch_arg(v.object_id().binary())
        return v

    def _fetch_arg(self, oid_bin: bytes) -> Any:
        from ray_tpu_torch import exceptions as rex

        # purpose "arg": a task-argument prefetch — the daemon's
        # pull manager ranks it below blocking user gets
        locs = self.rpc("get", ([oid_bin], None, "arg"))
        loc = locs[0]
        if loc[0] == "exc":
            exc = cloudpickle.loads(loc[1])
            if isinstance(exc, rex.TaskError):
                raise exc.as_instanceof_cause()
            raise exc
        return self.load_location(loc)

    def _run_batch(self, payloads) -> None:
        """A leased batch: execute in order, completions buffered and
        shipped in chunks (an rpc from any task flushes early to keep
        owner-side ordering). Chunked — not end-of-batch — flushing
        lets the owner process completions and refill this worker while
        the rest of the batch is still executing."""
        self._done_buf = []
        try:
            for p in payloads:
                self.execute(p)
                if len(self._done_buf) >= 16:
                    self._flush_dones()
        finally:
            self._flush_dones()
            self._done_buf = None

    def _drain_ring_payloads(self) -> list:
        """Every task payload currently published on the task ring —
        the nested (blocked-rpc) twin of the idle loop's doorbell
        branch, where completions must ship immediately instead of
        buffering."""
        out: list = []
        ring = self.task_ring
        if ring is None:
            return out
        data = ring.try_get()
        while data is not None:
            if _RING_TAGS.get(data[0]) == "env":
                out.extend(decode_task_envelope(
                    memoryview(data)[1:], self.hdr_cache))
            data = ring.try_get()
        return out

    # -- main loop ---------------------------------------------------------
    def run(self) -> None:
        threading.Thread(target=self._ctrl_loop, daemon=True,
                         name="ray_tpu_worker_ctrl").start()
        with self._rpc_lock:
            self.conn.send(("ready", os.getpid()))
        while not self._stop:
            if self._inbox:
                msg = self._inbox.pop(0)
            else:
                try:
                    msg = self.conn.recv()
                except (EOFError, OSError):
                    return
            kind = msg[0]
            if kind == "task":
                self.execute(msg[1])
            elif kind == "tasks":
                self._run_batch(msg[1])
            elif kind == "env":
                # a lease envelope that overflowed the ring rode the
                # pipe whole; same decode, same batch semantics
                self._run_batch(
                    decode_task_envelope(msg[1], self.hdr_cache))
            elif kind == "ring":
                # task-ring doorbell: drain every envelope currently
                # published (later doorbells for these find it empty)
                data = self.task_ring.try_get() \
                    if self.task_ring is not None else None
                while data is not None:
                    if _RING_TAGS.get(data[0]) == "env":
                        self._run_batch(decode_task_envelope(
                            memoryview(data)[1:], self.hdr_cache))
                    data = self.task_ring.try_get()
            elif kind == "actor_create":
                self.actor_create(msg[1])
            elif kind == "actor_call":
                self.actor_call(msg[1])
            elif kind == "p2p":
                # same guard as the mid-rpc arrival path: the advert is
                # an atomic tuple rebind, but readers sit on rpc threads
                with self._rpc_lock:
                    self.two_level = (bool(msg[1]), bool(msg[2]))
            elif kind == "exit":
                self._stop = True
            else:
                raise RuntimeError(f"unexpected message {kind!r} in idle loop")


def worker_main(conn, ctrl_conn, arena_name: str, inline_max: int,
                ring_spec: Optional[Tuple[int, int, int, int]] = None
                ) -> None:
    """Worker entry once both pipes are connected."""
    runner = _WorkerRunner(conn, ctrl_conn, arena_name, inline_max,
                           ring_spec)
    # install the API shim so user code inside tasks can call ray_tpu_torch.*
    from ray_tpu_torch._private import worker as worker_mod

    worker_mod.global_worker = ProcessWorkerContext(runner)  # type: ignore
    sampler = None
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if GLOBAL_CONFIG.profile_hz > 0:
        # continuous profiler: folded main-thread stacks tagged with
        # the running task, batched over the owner pipe (daemon-spawned
        # workers: the daemon forwards them as outbox-covered ("w", ...)
        # reports, so samples survive a head blackout + rejoin)
        from ray_tpu_torch._private import profile_plane

        def _label() -> Optional[str]:
            tid = runner.current_task_id
            if tid is None:
                return None
            return f"{runner.current_task_name or 'task'}:{tid.hex()[:8]}"

        def _ship(payload: dict) -> bool:
            # non-blocking: never stall sampling behind a task blocked
            # inside a get/wait rpc (which holds _rpc_lock throughout)
            if not runner._rpc_lock.acquire(blocking=False):
                return False
            try:
                runner.conn.send(("prof", payload))
            finally:
                runner._rpc_lock.release()
            return True

        sampler = profile_plane.StackSampler(
            GLOBAL_CONFIG.profile_hz, _ship, label_fn=_label,
            name="ray_tpu_profile_worker").start()
    try:
        runner.run()
    finally:
        if sampler is not None:
            sampler.stop()
        if runner.arena is not None:
            runner.arena.close()


def _dial(address: str, authkey: bytes, timeout: float = 30.0):
    """Connect to the pool's socket, retrying a refused dial (a full
    accept backlog) until timeout; a missing socket means the pool shut
    down and raises at once."""
    from multiprocessing.connection import Client

    deadline = time.monotonic() + timeout
    while True:
        try:
            return Client(address, authkey=authkey)
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _main(argv: List[str]) -> None:
    """``python -m ray_tpu_torch._private.runtime.worker_process <address>
    <arena_name> <inline_max> <worker_num>``

    Exec'd as a fresh interpreter by the pool (reference: the raylet
    execs python -m ray._private.workers.default_worker) — NOT forked or
    multiprocessing-spawned, so the parent's __main__ is never re-run and
    fork-unsafe parent state (the scheduler's CUDA context, threads) is
    never inherited. Connects back over AF_UNIX with an HMAC authkey handshake.
    """
    # Capture stdout/stderr FIRST (dup2 onto fds 1/2) so every later
    # byte — prints, import errors, interpreter crash tracebacks —
    # lands in the session log files the pool named for us.
    from ray_tpu_torch._private import log_plane

    log_plane.redirect_stdio_from_env()

    address, arena_name, inline_max, worker_num = (
        argv[0], argv[1], int(argv[2]), int(argv[3]))
    # optional 5th arg: control-ring geometry "off_in:off_out:slots:
    # slot_bytes" ("-" or absent = pipe-only; daemon-spawned remote
    # workers never pass it)
    ring_spec = None
    if len(argv) > 4 and argv[4] != "-":
        a, b, c, d = argv[4].split(":")
        ring_spec = (int(a), int(b), int(c), int(d))
    authkey = bytes.fromhex(os.environ[AUTHKEY_ENV])
    from ray_tpu_torch._private.protocol import make_wire_hello

    try:
        conn = _dial(address, authkey)
        conn.send(make_wire_hello("worker", worker_num, "task"))
        ctrl = _dial(address, authkey)
        ctrl.send(make_wire_hello("worker", worker_num, "ctrl"))
    except (FileNotFoundError, ConnectionError, OSError):
        return  # pool already shut down while we were starting
    worker_main(conn, ctrl, arena_name, inline_max, ring_spec)


if __name__ == "__main__":
    import sys

    # re-enter through the canonical import so every class in this module
    # has ONE identity: under `python -m` this file runs as `__main__`,
    # and unpickled _ShmValue instances (imported canonically) would fail
    # isinstance checks against __main__'s copies
    from ray_tpu_torch._private.runtime import worker_process as _canonical

    _canonical._main(sys.argv[1:])

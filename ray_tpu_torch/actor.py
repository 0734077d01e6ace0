"""Actors: stateful workers with ordered method execution.

Reference surfaces: python/ray/actor.py (ActorClass/ActorHandle/
ActorMethod), src/ray/core_worker/transport/actor_task_submitter (per-
actor ordered queues, seq numbers), src/ray/gcs/gcs_server/
gcs_actor_manager.cc (lifecycle FSM: PENDING_CREATION → ALIVE →
[RESTARTING →] DEAD).

Semantics kept:
  - creation is scheduled like a task (resources honored); method calls
    go DIRECTLY to the actor's ordered inbox, bypassing the scheduler —
    the reference's actor-task fast path.
  - per-caller FIFO ordering (single inbox thread); max_concurrency > 1
    relaxes ordering like threaded actors; async def methods run on an
    asyncio loop (async actors).
  - method exceptions do NOT kill the actor; __init__ failure marks the
    actor DEAD; ray_tpu_torch.kill() → ActorDiedError for pending calls;
    max_restarts recreates state via lineage (re-running __init__).
  - default resource behavior: actors take 1 CPU for *creation* then hold
    0 while alive, unless resources were explicitly requested, in which
    case they are held for the actor's lifetime.
"""

from __future__ import annotations

import asyncio
import enum
import functools
import inspect
import queue
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.task_spec import TaskSpec, TaskType, resources_to_vector
from ray_tpu_torch._private import trace_plane
from ray_tpu_torch.remote_function import _DEFAULT_OPTIONS, _build_resources

def _effective_max_restarts(opts: dict) -> int:
    """Per-actor option wins; unset (None) falls back to the
    ``actor_max_restarts`` knob."""
    mr = opts.get("max_restarts")
    if mr is None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        mr = GLOBAL_CONFIG.actor_max_restarts
    return int(mr)


_ACTOR_OPTIONS = dict(_DEFAULT_OPTIONS)
_ACTOR_OPTIONS.update(dict(
    max_restarts=None,  # None = GLOBAL_CONFIG.actor_max_restarts
    max_task_retries=0,
    max_concurrency=1,
    max_pending_calls=-1,
    lifetime=None,  # None | "detached"
    namespace="default",
    # named thread pools with independent queues (reference:
    # concurrency_groups={"io": 2}); methods route with
    # @ray_tpu_torch.method(concurrency_group="io")
    concurrency_groups=None,
))


class ActorState(enum.Enum):
    DEPENDENCIES_UNREADY = 0
    PENDING_CREATION = 1
    ALIVE = 2
    RESTARTING = 3
    DEAD = 4


class _Call:
    __slots__ = ("method_name", "args", "kwargs", "return_ids", "num_returns",
                 "task_id", "trace_ctx", "dedup")

    def __init__(self, method_name, args, kwargs, return_ids, num_returns,
                 task_id, trace_ctx=None, dedup=False):
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs
        self.return_ids = return_ids
        self.num_returns = num_returns
        self.task_id = task_id
        self.trace_ctx = trace_ctx
        # p2p head-fallback retries carry preset ids and dedup=True:
        # the worker's completion cache makes the re-run exactly-once
        self.dedup = dedup


class _ActorRuntime:
    """Host-side actor executor: ordered inbox + worker thread(s)."""

    def __init__(self, worker, actor_id: ActorID, cls, init_args, init_kwargs,
                 opts: Dict[str, Any], creation_spec: TaskSpec,
                 creation_node_index: int):
        self.worker = worker
        self.actor_id = actor_id
        self.cls = cls
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.opts = opts
        self.state = ActorState.PENDING_CREATION
        self.instance = None
        self.inbox: "queue.Queue[Optional[_Call]]" = queue.Queue()
        # named concurrency groups: each group gets its OWN queue and
        # thread pool — a saturated "compute" group never blocks "io"
        # methods (reference: core_worker concurrency groups)
        groups = dict(opts.get("concurrency_groups") or {})
        self._group_inboxes: Dict[str, "queue.Queue[Optional[_Call]]"] = {
            g: queue.Queue() for g in groups}
        self._group_sizes: Dict[str, int] = {
            g: max(1, int(n)) for g, n in groups.items()}
        # method -> target inbox (or the unknown-group ValueError),
        # resolved ONCE: submit() sits on the actor-call hot path and
        # routing is static at class+options time
        self._route: Dict[str, Any] = {}
        for mname, m in inspect.getmembers(cls, callable):
            g = getattr(m, "__ray_tpu_concurrency_group__", None)
            if g is None:
                continue
            target = self._group_inboxes.get(g)
            self._route[mname] = target if target is not None else \
                ValueError(
                    f"method {mname!r} routes to unknown concurrency "
                    f"group {g!r}; declared: {sorted(groups)}")
        self.init_done = threading.Event()
        self.death_cause: Optional[BaseException] = None
        self.num_restarts = 0
        self.num_executed = 0
        self.name: Optional[str] = opts.get("name")
        self.namespace: str = opts.get("namespace") or "default"
        self.detached = opts.get("lifetime") == "detached"
        self._creation_spec = creation_spec
        self._creation_node_index = creation_node_index
        # the row currently charged for the actor's lifetime resources;
        # restart-elsewhere moves the charge (and release at death)
        self._current_node_index = creation_node_index
        self._explicit_resources = bool(
            opts.get("resources") or opts.get("num_gpus")
            or (opts.get("num_cpus") not in (None, 1.0, 1)))
        self._is_async = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(cls, inspect.isfunction))
        self._concurrency = max(1, int(opts.get("max_concurrency", 1)))
        self._threads: List[threading.Thread] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stopped = threading.Event()
        # True when re-attached to an already-initialized worker after a
        # head restart: the inbox loop starts, __init__ does NOT re-run
        self._adopted = False

    # -- runtime_env (thread-mode actors share the driver process: env
    # vars save/restore around init and each call, same documented
    # caveat as thread-mode tasks; process actors apply them for their
    # dedicated process's lifetime) --------------------------------------
    def _env_apply(self):
        env_vars = (self._creation_spec.runtime_env or {}).get("env_vars")
        if not env_vars:
            return None
        from ray_tpu_torch._private.worker import env_vars_push

        env_vars_push(env_vars)
        return env_vars

    @staticmethod
    def _env_restore(env_vars) -> None:
        if env_vars is None:
            return
        from ray_tpu_torch._private.worker import env_vars_pop

        env_vars_pop(env_vars)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._is_async:
            t = threading.Thread(target=self._async_main, daemon=True,
                                 name=f"actor-{self.actor_id.hex()[:8]}")
            t.start()
            self._threads = [t]
        else:
            for i in range(self._concurrency):
                t = threading.Thread(target=self._sync_main, args=(i,),
                                     daemon=True,
                                     name=f"actor-{self.actor_id.hex()[:8]}-{i}")
                t.start()
                self._threads.append(t)
            for group, n in self._group_sizes.items():
                inbox = self._group_inboxes[group]
                for i in range(n):
                    t = threading.Thread(
                        target=self._group_main, args=(inbox,),
                        daemon=True,
                        name=(f"actor-{self.actor_id.hex()[:8]}"
                              f"-{group}-{i}"))
                    t.start()
                    self._threads.append(t)

    def _run_init(self) -> bool:
        env_saved = self._env_apply()
        try:
            self.instance = self.cls(*self.init_args, **self.init_kwargs)
            self.state = ActorState.ALIVE
            self.worker.memory_store.put(
                _creation_object_id(self.actor_id), "ALIVE")
            return True
        except BaseException as e:  # noqa: BLE001
            tb = "".join(traceback.format_exception(type(e), e, e.__traceback__))
            err = rex.TaskError(f"{self.cls.__name__}.__init__", e, tb)
            self.death_cause = err
            self.state = ActorState.DEAD
            self.worker.memory_store.put(
                _creation_object_id(self.actor_id), err, is_exception=True)
            return False
        finally:
            self._env_restore(env_saved)
            self.init_done.set()
            # default actors release their creation CPU once alive
            if not self._explicit_resources:
                self.worker.scheduler.notify_task_finished(
                    self._creation_spec.task_id, self._current_node_index,
                    self._creation_spec.resources)

    def _sync_main(self, thread_index: int):
        if thread_index == 0:
            if self._adopted:
                self.init_done.set()  # worker already holds the instance
            else:
                ok = self._run_init()
                if not ok:
                    self._drain_with_error()
                    return
        else:
            self.init_done.wait()
            if self.state == ActorState.DEAD:
                return
        while not self._stopped.is_set():
            call = self.inbox.get()
            if call is None:
                break
            self._execute_call(call)

    def _group_main(self, inbox: "queue.Queue[Optional[_Call]]"):
        self.init_done.wait()
        if self.state == ActorState.DEAD:
            return
        while not self._stopped.is_set():
            call = inbox.get()
            if call is None:
                break
            self._execute_call(call)

    def _async_main(self):
        ok = self._run_init()
        if not ok:
            self._drain_with_error()
            return
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        # async actors default to high concurrency (reference: 1000)
        limit = (self._concurrency if self.opts.get("max_concurrency", 1) > 1
                 else 1000)
        sem = asyncio.Semaphore(limit)

        async def run_one(call):
            async with sem:
                await self._execute_call_async(call)

        def pump():
            # daemon thread: blocking inbox reads posted into the loop
            while True:
                call = self.inbox.get()
                if call is None:
                    loop.call_soon_threadsafe(loop.stop)
                    return
                loop.call_soon_threadsafe(
                    lambda c=call: loop.create_task(run_one(c)))

        pump_thread = threading.Thread(
            target=pump, daemon=True,
            name=f"actor-pump-{self.actor_id.hex()[:8]}")
        pump_thread.start()
        try:
            loop.run_forever()
        finally:
            for p in asyncio.all_tasks(loop):
                p.cancel()
            loop.close()

    # -- execution ---------------------------------------------------------
    def _capture_pg_token(self):
        """Actors created with placement_group_capture_child_tasks=True
        propagate their group to tasks submitted from method bodies
        (mirrors Worker._execute_task for normal tasks)."""
        spec = self._creation_spec
        if spec.placement_group_id is not None \
                and spec.placement_group_capture_child_tasks:
            from ray_tpu_torch.util.placement_group import _current_pg
            return _current_pg.set(spec.placement_group_id)
        return None

    def _reset_pg_token(self, token) -> None:
        if token is not None:
            from ray_tpu_torch.util.placement_group import _current_pg
            _current_pg.reset(token)

    def _trace_done(self, call: _Call, timing, offset: float = 0.0,
                    worker_key=None) -> None:
        tp = getattr(self.worker, "trace_plane", None)
        if tp is None or call.trace_ctx is None:
            return
        tp.record_finished_batch(
            ((call.task_id, timing,
              worker_key if worker_key is not None
              else threading.get_ident(),
              self._current_node_index),), offset=offset)

    def _trace_failed(self, call: _Call, exc: BaseException) -> None:
        tp = getattr(self.worker, "trace_plane", None)
        if tp is None or call.trace_ctx is None:
            return
        tp.record_failed(call.task_id, type(exc).__name__)

    def _execute_call(self, call: _Call):
        instance = self.instance
        if instance is None:
            # the actor died while this call waited for its thread
            self._store_error(call, self.death_cause or rex.ActorDiedError(
                actor_id=self.actor_id))
            return
        method = getattr(instance, call.method_name)
        pg_token = self._capture_pg_token()
        env_saved = self._env_apply()
        try:
            args, kwargs, dep_err = self._resolve(call.args, call.kwargs)
            if dep_err is not None:
                raise dep_err
            t0 = time.time()
            with trace_plane.parent_scope(call.trace_ctx):
                result = method(*args, **kwargs)
            if inspect.isgenerator(result):
                result = list(result)
            t1 = time.time()
            self._store(call, result)
            self._trace_done(call, (t0, t1))
        except BaseException as e:  # noqa: BLE001
            self._store_error(call, e)
            self._trace_failed(call, e)
        finally:
            self._env_restore(env_saved)
            self._reset_pg_token(pg_token)
            self.num_executed += 1

    async def _execute_call_async(self, call: _Call):
        instance = self.instance
        if instance is None:
            # the actor died while this call waited for its thread
            self._store_error(call, self.death_cause or rex.ActorDiedError(
                actor_id=self.actor_id))
            return
        method = getattr(instance, call.method_name)
        pg_token = self._capture_pg_token()
        env_saved = self._env_apply()
        try:
            args, kwargs, dep_err = self._resolve(call.args, call.kwargs)
            if dep_err is not None:
                raise dep_err
            t0 = time.time()
            with trace_plane.parent_scope(call.trace_ctx):
                result = method(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = await result
            t1 = time.time()
            self._store(call, result)
            self._trace_done(call, (t0, t1))
        except BaseException as e:  # noqa: BLE001
            self._store_error(call, e)
            self._trace_failed(call, e)
        finally:
            self._env_restore(env_saved)
            self._reset_pg_token(pg_token)
            self.num_executed += 1

    def _resolve(self, args, kwargs):
        dep_err = None

        def r(v):
            nonlocal dep_err
            if isinstance(v, ObjectRef):
                entry = self.worker.memory_store.get_entry(v.object_id())
                if entry is None:
                    # actor calls resolve deps by blocking get (direct path)
                    try:
                        return self.worker.get([v], timeout=None)[0]
                    except BaseException as e:  # noqa: BLE001
                        dep_err = e
                        return None
                if entry.is_exception:
                    dep_err = entry.value
                    return None
                return entry.value
            return v

        return (tuple(r(a) for a in args),
                {k: r(v) for k, v in kwargs.items()}, dep_err)

    def _store(self, call: _Call, result):
        if call.num_returns == 1:
            values = [result]
        else:
            values = list(result)
        for oid, v in zip(call.return_ids, values):
            self.worker.memory_store.put(oid, v)
            self.worker.scheduler.notify_object_ready(oid)

    def _store_error(self, call: _Call, exc: BaseException):
        if not isinstance(exc, (rex.TaskError, rex.ActorError)):
            tb = "".join(traceback.format_exception(type(exc), exc,
                                                    exc.__traceback__))
            exc = rex.TaskError(f"{self.cls.__name__}.{call.method_name}",
                                exc, tb)
        for oid in call.return_ids:
            self.worker.memory_store.put(oid, exc, is_exception=True)
            self.worker.scheduler.notify_object_ready(oid)

    def _drain_with_error(self):
        err = self.death_cause or rex.ActorDiedError(actor_id=self.actor_id)
        for inbox in (self.inbox, *self._group_inboxes.values()):
            while True:
                try:
                    call = inbox.get_nowait()
                except queue.Empty:
                    break
                if call is not None:
                    self._store_error(call, err)

    # -- submission (from handles) ----------------------------------------
    def submit(self, call: _Call):
        if self.state == ActorState.DEAD:
            self._store_error(call, self.death_cause
                              or rex.ActorDiedError(actor_id=self.actor_id))
            return
        inbox = self.inbox
        if self._route:
            target = self._route.get(call.method_name)
            if isinstance(target, ValueError):
                # the tag promises isolation: an undeclared group must
                # fail loudly even when NO groups were declared (a
                # silently serialized "io" method is exactly the bug
                # the tag exists to prevent)
                self._store_error(call, target)
                return
            if target is not None:
                inbox = target
        limit = self.opts.get("max_pending_calls", -1)
        if limit > 0 and inbox.qsize() >= limit:
            raise rex.PendingCallsLimitExceeded(
                f"actor has {inbox.qsize()} pending calls (limit {limit})")
        inbox.put(call)

    # -- death / restart ---------------------------------------------------
    def stop(self, no_restart: bool = True,
             cause: Optional[BaseException] = None):
        max_restarts = _effective_max_restarts(self.opts)
        can_restart = (not no_restart
                       and (max_restarts == -1
                            or self.num_restarts < max_restarts))
        if can_restart:
            self.num_restarts += 1
            self.state = ActorState.RESTARTING
            # restart = re-run __init__ (lineage-style state reconstruction)
            try:
                self.instance = self.cls(*self.init_args, **self.init_kwargs)
                self.state = ActorState.ALIVE
                return
            except BaseException as e:  # noqa: BLE001
                self.death_cause = rex.TaskError(
                    f"{self.cls.__name__}.__init__ (restart)", e)
        self.state = ActorState.DEAD
        self.death_cause = self.death_cause or cause or rex.ActorDiedError(
            "actor killed via ray_tpu_torch.kill()", actor_id=self.actor_id)
        self._stopped.set()
        # fail the queued calls first, then wake each thread with its
        # sentinel: draining after the sentinels (as the reference does)
        # swallows them, and the threads then block forever, holding the
        # instance (and whatever it holds on the card). One sentinel for
        # each thread the actor has by its options, not for each thread in
        # self._threads: start() may still be starting them, and a thread
        # started but not yet listed would find no sentinel
        self._drain_with_error()
        for _ in range(1 if self._is_async else self._concurrency):
            self.inbox.put(None)
        for g, n in self._group_sizes.items():
            for _ in range(n):
                self._group_inboxes[g].put(None)
        # and the instance goes now, not with the last reference to this
        # runtime: a call still running keeps it until it returns
        self.instance = None
        # lifetime-held resources released at death
        if self._explicit_resources:
            self.worker.scheduler.notify_task_finished(
                self._creation_spec.task_id, self._current_node_index,
                self._creation_spec.resources)
        with self.worker._actors_lock:
            self.worker.actors.pop(self.actor_id, None)
            self.worker.dead_actors.add(self.actor_id)
        self.worker.gcs.update_actor_state(self.actor_id, "DEAD")


class _ProcessActorRuntime(_ActorRuntime):
    """Actor whose instance lives in a DEDICATED worker process
    (reference: every actor is its own worker process; the GCS actor
    scheduler leases one at creation — src/ray/gcs/gcs_server/
    gcs_actor_scheduler.cc). The driver keeps the FSM + ordered inbox;
    __init__ and method calls ship over the worker's pipe; large
    arguments/results move through the shm arena. Worker-process death
    is detected by the pool monitor and drives restart (max_restarts)
    or DEAD — real crash detection, not only explicit kill()."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pool = (self.worker.pool_for_node(self._creation_node_index)
                      or self.worker.process_pool)
        self._h = None
        self._round_done = threading.Event()
        self._round_result = None
        self._restart_lock = threading.Lock()

    def _select_pool(self):
        """Pool to (re)spawn the actor worker on.

        Same node while it lives (resources stay charged there). On node
        death: a placement-grouped actor follows its (rescheduled) bundle
        rows; a plain actor moves to an alive node that can ACCEPT its
        resource charge (scheduler.try_allocate) so the replacement node
        is never overcommitted. Returns None when nothing qualifies."""
        w = self.worker
        spec = self._creation_spec
        if self._pool is not None and not self._pool._node_dead:
            return self._pool
        if spec.placement_group_id is not None:
            entry = w.placement_groups.get(spec.placement_group_id)
            if entry is None or entry.state != "CREATED":
                return None
            bindex = spec.placement_group_bundle_index
            rows = entry.rows if bindex < 0 else (
                [entry.rows[bindex]] if bindex < len(entry.rows) else [])
            for r in rows:
                ns = w.scheduler.node_state(r)
                if ns is None or ns.defunct:
                    continue
                pool = w.pool_for_node(r)
                if pool is None or pool._node_dead:
                    continue
                if not self._explicit_resources \
                        or w.scheduler.try_allocate(r, spec.resources):
                    self._current_node_index = r
                    return pool
            return None
        for e in w.gcs.alive_process_nodes():
            if e.pool is None or e.pool._node_dead:
                continue
            if not self._explicit_resources \
                    or w.scheduler.try_allocate(e.index, spec.resources):
                self._current_node_index = e.index
                return e.pool
        return None

    def start(self):
        self._h = self._pool.spawn_actor_worker(self)
        super().start()

    # -- pool reader/monitor callbacks -------------------------------------
    def _on_worker_ready(self, h):
        pass  # readiness observed by polling h.ready in _create_remote

    def _on_remote_done(self, task_id, entries, timing=None):
        self._round_result = ("done", entries, timing)
        self._round_done.set()

    def _on_remote_err(self, task_id, blob, tb):
        self._round_result = ("err", blob, tb)
        self._round_done.set()

    def _on_process_died(self, h, cause):
        if h is not self._h:
            return  # an already-replaced worker
        self._round_result = ("died", cause)
        self._round_done.set()
        # crash detection: restart (or die) off the monitor thread
        threading.Thread(
            target=self.stop,
            kwargs=dict(no_restart=False,
                        cause=rex.ActorDiedError(
                            f"actor worker process died: {cause}",
                            actor_id=self.actor_id)),
            daemon=True).start()

    # -- remote rounds ------------------------------------------------------
    def _remote_round(self, kind: str, payload: dict):
        self._round_done.clear()
        self._round_result = None
        h = self._h
        try:
            self._pool.send_to(h, (kind, payload))
        except (OSError, ValueError, AttributeError) as e:
            return ("died", e)
        # poll the handle while waiting: kill() releases the worker
        # without a monitor notification, and the event-set in stop()
        # can race a concurrent clear
        while not self._round_done.wait(timeout=0.25):
            if h.dead and not self._round_done.is_set():
                return ("died", "worker released")
        return self._round_result

    def _build_payload(self, h, task_id, return_ids, args, kwargs,
                       extra: dict):
        import cloudpickle

        from ray_tpu_torch._private.runtime.process_pool import _dumps_collect_refs

        # actor calls BLOCK on not-yet-ready args (the direct-path
        # semantics of the base runtime's _resolve), unlike normal tasks
        # whose readiness the scheduler guarantees
        for v in list(args) + list(kwargs.values()):
            if isinstance(v, ObjectRef) and \
                    self.worker.memory_store.get_entry(v.object_id()) is None:
                self.worker.memory_store.wait_and_get([v.object_id()], None)
        sargs = tuple(self._pool._resolve_for_ship(a) for a in args)
        skw = {k: self._pool._resolve_for_ship(v) for k, v in kwargs.items()}
        args_blob, contained = _dumps_collect_refs((sargs, skw))
        payload = dict(
            task_id=task_id.binary(),
            name=f"{self.cls.__name__}",
            args_blob=args_blob,
            num_returns=max(1, len(return_ids)),
            return_ids=[o.binary() for o in return_ids],
        )
        payload.update(extra)
        # borrows are keyed by the worker registered AT BUILD TIME — a
        # restart swaps self._h, and removal must target the original
        borrows = []
        for r in contained:
            self.worker.reference_counter.add_borrower(
                r.object_id(), h.worker_id)
            borrows.append((r.object_id(), h.worker_id))
        return payload, borrows

    def _remove_borrows(self, h, borrows) -> None:
        for oid, wid in borrows:
            self.worker.reference_counter.remove_borrower(oid, wid)
        # puts issued from inside the actor during this round (tracked on
        # the handle by _rpc_put) are released the same way normal-task
        # workers release them in _release()
        if h is not None:
            for oid in h.borrows:
                self.worker.reference_counter.remove_borrower(
                    oid, h.worker_id)
            h.borrows = set()

    def _create_remote(self):
        """Returns True on success or the causing exception."""
        import cloudpickle
        import time as _time

        deadline = _time.monotonic() + 60
        while self._h is None or not self._h.ready:
            if _time.monotonic() > deadline:
                return TimeoutError("actor worker never registered")
            _time.sleep(0.005)
        creation_oid = _creation_object_id(self.actor_id)
        h = self._h
        # actor_bin lets the node daemon record WHICH actor this
        # dedicated worker hosts (head-restart re-adoption)
        extra = dict(cls_blob=cloudpickle.dumps(self.cls),
                     actor_bin=self.actor_id.binary())
        renv = self._creation_spec.runtime_env or {}
        if renv.get("working_dir_pkg"):
            # the actor OWNS its worker process: the env applies for
            # its whole lifetime (reference: per-actor runtime_env)
            extra["actor_working_dir_pkg"] = renv["working_dir_pkg"]
        if renv.get("pip"):
            extra["actor_pip"] = list(renv["pip"])
        env_vars = (self._creation_spec.runtime_env or {}).get("env_vars")
        if env_vars:
            # the actor OWNS its worker process: env_vars apply for its
            # whole lifetime (reference: per-actor runtime_env).
            # "actor_env_vars", NOT "env_vars": the generic task key is
            # save/restored per payload, which would undo them after
            # __init__
            extra["actor_env_vars"] = dict(env_vars)
        try:
            payload, borrows = self._build_payload(
                h, self._creation_spec.task_id, [creation_oid],
                self.init_args, self.init_kwargs, extra)
        except Exception as e:
            return e
        res = self._remote_round("actor_create", payload)
        self._remove_borrows(h, borrows)
        if res[0] == "done":
            return True
        if res[0] == "err":
            try:
                return cloudpickle.loads(res[1])
            except Exception:
                return RuntimeError("actor __init__ failed (undecodable)")
        return rex.ActorDiedError(
            f"worker died during __init__: {res[1]}",
            actor_id=self.actor_id)

    def _run_init(self) -> bool:
        try:
            res = self._create_remote()
            if res is True:
                self.state = ActorState.ALIVE
                self.worker.memory_store.put(
                    _creation_object_id(self.actor_id), "ALIVE")
                return True
            exc = res if isinstance(res, BaseException) else RuntimeError(res)
            if not isinstance(exc, rex.TaskError):
                exc = rex.TaskError(f"{self.cls.__name__}.__init__", exc, "")
            self.death_cause = exc
            self.state = ActorState.DEAD
            self.worker.memory_store.put(
                _creation_object_id(self.actor_id), exc, is_exception=True)
            # don't leak the dedicated worker of a failed creation
            h, self._h = self._h, None
            if h is not None:
                self._pool.release_actor_worker(h, kill=True)
            return False
        finally:
            self.init_done.set()
            if not self._explicit_resources:
                self.worker.scheduler.notify_task_finished(
                    self._creation_spec.task_id, self._current_node_index,
                    self._creation_spec.resources)

    def _execute_call(self, call: _Call):
        import cloudpickle
        import time as _time

        max_task_retries = int(self.opts.get("max_task_retries", 0))
        attempt = 0
        failed_h = None
        while True:
            # a restart may be in flight; calls queue until it settles.
            # After a died round, ALSO wait for the handle to actually
            # change: the failing send can observe the old handle before
            # stop() swaps it, and instant retries would burn every
            # attempt against the same dead worker.
            deadline = _time.monotonic() + 60
            while (self.state == ActorState.RESTARTING or self._h is None
                   or self._h is failed_h) \
                    and self.state != ActorState.DEAD \
                    and _time.monotonic() < deadline:
                _time.sleep(0.005)
            if self.state == ActorState.DEAD:
                self._store_error(call, self.death_cause
                                  or rex.ActorDiedError(
                                      actor_id=self.actor_id))
                return
            h = self._h
            if h is None:
                self._store_error(call, rex.ActorUnavailableError(
                    f"actor worker unavailable for {call.method_name}"))
                return
            extra = dict(method=call.method_name)
            if call.dedup:
                extra["dedup"] = True
            if call.trace_ctx is not None and call.trace_ctx[3]:
                # same payload-dict carriage as normal task leases
                extra["trace"] = call.trace_ctx
            try:
                payload, borrows = self._build_payload(
                    h, call.task_id, call.return_ids, call.args, call.kwargs,
                    extra)
            except Exception as e:
                self._store_error(call, e)
                return
            res = self._remote_round("actor_call", payload)
            if res[0] == "done":
                self._pool.store_result_entries(call.return_ids, res[1])
                self._trace_done(call,
                                 res[2] if len(res) > 2 else None,
                                 offset=self._pool.clock_offset,
                                 worker_key=h.worker_id.hex())
            elif res[0] == "err":
                try:
                    exc = cloudpickle.loads(res[1])
                except Exception:
                    exc = RuntimeError("actor call failed (undecodable)")
                self._store_error(call, exc)
                self._trace_failed(call, exc)
            elif attempt < max_task_retries:
                # worker died mid-call (restart driven by
                # _on_process_died): retry on the restarted instance
                # (reference: max_task_retries re-runs actor tasks after
                # restart, ray: python/ray/actor.py)
                attempt += 1
                failed_h = h
                self._remove_borrows(h, borrows)
                continue
            else:
                self._store_error(call, rex.ActorDiedError(
                    f"actor worker died during {call.method_name}: "
                    f"{res[1]}", actor_id=self.actor_id))
            # results registered first, THEN borrows dropped (a returned
            # ref gets its driver-side local ref before the borrow goes
            # away)
            self._remove_borrows(h, borrows)
            self.num_executed += 1
            return

    def stop(self, no_restart: bool = True,
             cause: Optional[BaseException] = None):
        with self._restart_lock:
            if self.state == ActorState.DEAD:
                return
            max_restarts = _effective_max_restarts(self.opts)
            can_restart = (not no_restart
                           and (max_restarts == -1
                                or self.num_restarts < max_restarts))
            h, self._h = self._h, None
            if h is not None:
                self._pool.release_actor_worker(h, kill=True)
                # an in-flight call is blocked in _remote_round; the
                # monitor won't notify (we marked the handle released),
                # so unblock it here or its return refs never resolve
                if not self._round_done.is_set():
                    self._round_result = ("died", cause or "killed")
                    self._round_done.set()
            if can_restart:
                pool = self._select_pool()
                if pool is None:
                    cause = cause or rex.ActorDiedError(
                        "no alive node to restart the actor on",
                        actor_id=self.actor_id)
                else:
                    self.num_restarts += 1
                    self.state = ActorState.RESTARTING
                    self._pool = pool
                    self._h = pool.spawn_actor_worker(self)
                    res = self._create_remote()
                    if res is True:
                        self.state = ActorState.ALIVE
                        self.worker.gcs.update_actor_state(
                            self.actor_id, "ALIVE", pool.node_index)
                        return
                    self.death_cause = (
                        res if isinstance(res, BaseException)
                        else rex.TaskError(
                            f"{self.cls.__name__}.__init__ (restart)",
                            res, ""))
            self.state = ActorState.DEAD
            self.death_cause = self.death_cause or cause \
                or rex.ActorDiedError("actor killed via ray_tpu_torch.kill()",
                                      actor_id=self.actor_id)
            self._stopped.set()
            # fail the queued calls first, then wake each thread with its
            # sentinel, one for each thread by the options (see
            # _ActorRuntime.stop)
            self._drain_with_error()
            for _ in range(self._concurrency):
                self.inbox.put(None)
            for g, n in self._group_sizes.items():
                for _ in range(n):
                    self._group_inboxes[g].put(None)
            if self._explicit_resources:
                self.worker.scheduler.notify_task_finished(
                    self._creation_spec.task_id, self._current_node_index,
                    self._creation_spec.resources)
            with self.worker._actors_lock:
                self.worker.actors.pop(self.actor_id, None)
                self.worker.dead_actors.add(self.actor_id)
            self.worker.gcs.update_actor_state(self.actor_id, "DEAD")


def _creation_object_id(actor_id: ActorID) -> ObjectID:
    return ObjectID.for_task_return(TaskID.for_actor_task(actor_id, 0), 0)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, *, num_returns: Optional[int] = None,
                **unknown) -> "ActorMethod":
        if unknown:
            raise TypeError(
                f"ActorMethod.options() got unsupported options "
                f"{sorted(unknown)} (supported: num_returns)")
        return ActorMethod(
            self._handle, self._method_name,
            self._num_returns if num_returns is None else num_returns)

    def bind(self, *args, **kwargs):
        """DAG-building (reference: ray.dag actor-method nodes)."""
        from ray_tpu_torch.dag import ActorMethodNode

        return ActorMethodNode(self, args, kwargs)

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(self._method_name, args, kwargs,
                                           self._num_returns)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name!r} must be invoked with "
            f".remote()")


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str = ""):
        self._actor_id = actor_id
        self._class_name = class_name
        self._seq = 0
        self._seq_lock = threading.Lock()
        # per-handle task-id namespace salt. RANDOM, not id(self): a
        # handle in a RESTARTED head (or one allocated at a recycled
        # address) must not reuse an old handle's task ids — the old
        # results may still sit in a surviving node arena, and a
        # colliding create would reject the new result
        import os as _os
        self._salt = int.from_bytes(_os.urandom(2), "big")

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def _runtime(self) -> _ActorRuntime:
        import time as _time

        worker = worker_mod.get_worker()
        deadline = _time.monotonic() + 60.0
        while True:
            with worker._actors_lock:
                rt = worker.actors.get(self._actor_id)
                dead = self._actor_id in worker.dead_actors
            if rt is not None:
                return rt
            if dead or _time.monotonic() > deadline:
                raise rex.ActorDiedError(
                    f"actor {self._actor_id.hex()} does not exist or is dead",
                    actor_id=self._actor_id)
            # creation may still be queued behind deps/resources
            _time.sleep(0.001)

    def _submit_method(self, method_name, args, kwargs, num_returns):
        worker = worker_mod.get_worker()
        if getattr(worker, "is_client", False):
            return worker.actor_call(self._actor_id, method_name, args,
                                     kwargs, num_returns)
        if not hasattr(worker, "actors"):
            # inside a process worker: the actor runtime tables live
            # with the owner — route the call over the pipe RPC
            return worker.actor_call(self._actor_id, method_name, args,
                                     kwargs, num_returns)
        rt = self._runtime()
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        task_id = TaskID.for_actor_task(self._actor_id,
                                        self._salt * 65536 + seq)
        return_ids = [ObjectID.for_task_return(task_id, i)
                      for i in range(num_returns)]
        for oid in return_ids:
            worker.reference_counter.add_owned_object(oid)
        call = _Call(method_name, args, kwargs, return_ids, num_returns,
                     task_id)
        tp = getattr(worker, "trace_plane", None)
        if tp is not None:
            # child of the ambient parent: a driver call roots a new
            # trace, a call from inside a traced task/client op joins it
            call.trace_ctx = tp.make_context()
            tp.on_actor_call(call,
                             f"{self._class_name}.{method_name}",
                             rt._current_node_index)
        rt.submit(call)
        refs = [ObjectRef(oid, worker.worker_id) for oid in return_ids]
        return refs[0] if num_returns == 1 else refs

    def __reduce__(self):
        return (_rebuild_handle, (self._actor_id.binary(), self._class_name))

    def __repr__(self):
        return (f"ActorHandle({self._class_name}, "
                f"{self._actor_id.hex()[:16]})")


def _rebuild_handle(actor_binary: bytes, class_name: str) -> ActorHandle:
    return ActorHandle(ActorID(actor_binary), class_name)


class ActorClass:
    def __init__(self, cls: type, options: Dict[str, Any]):
        self._cls = cls
        self._options = dict(_ACTOR_OPTIONS)
        if "num_tpus" in options:
            options["num_gpus"] = options.pop("num_tpus")
        # actor default: no CPU option given -> 1 CPU for creation only
        self._options.update(options)
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote()")

    def options(self, **overrides) -> "ActorClass":
        if "num_tpus" in overrides:
            overrides["num_gpus"] = overrides.pop("num_tpus")
        for k in overrides:
            if k not in _ACTOR_OPTIONS and k != "name":
                raise ValueError(f"unknown actor option {k!r}")
        merged = dict(self._options)
        merged.update(overrides)
        new = ActorClass.__new__(ActorClass)
        new._cls = self._cls
        new._options = merged
        return new

    def _validate_concurrency_groups(self) -> None:
        """Fail at CALL time, not deep in actor bootstrap (a bootstrap
        raise would leave the creation object pending forever)."""
        groups = self._options.get("concurrency_groups")
        if not groups:
            return
        if any(inspect.iscoroutinefunction(m) for _, m in
               inspect.getmembers(self._cls, inspect.isfunction)):
            # async actors run one event loop; group-tagged calls would
            # land in queues no loop drains
            raise ValueError(
                "concurrency_groups are not supported on ASYNC actors: "
                "async methods already interleave on one event loop "
                "(use max_concurrency to bound them)")
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        if GLOBAL_CONFIG.worker_mode == "process":
            # process-actor rounds share one reply slot; concurrent
            # group threads would cross-wire results
            raise ValueError(
                "concurrency_groups require thread-mode actors; "
                "process-mode actors execute calls through a single "
                "ordered round-trip")

    def remote(self, *args, **kwargs) -> ActorHandle:
        self._validate_concurrency_groups()
        worker = worker_mod.get_worker()
        if getattr(worker, "is_client", False):
            return worker.create_actor(self._cls, self._options, args,
                                       kwargs)
        opts = self._options
        name = opts.get("name")
        namespace = opts.get("namespace") or "default"
        if name and worker.gcs.get_actor_by_name(name, namespace) is not None:
            raise ValueError(
                f"actor name {name!r} already taken in namespace "
                f"{namespace!r}")

        actor_id = ActorID.of(worker.job_id)
        creation_task_id = TaskID.for_actor_task(actor_id, 0)
        creation_oid = _creation_object_id(actor_id)
        worker.reference_counter.add_owned_object(creation_oid)
        worker.reference_counter.pin(creation_oid)

        spec = TaskSpec(
            task_id=creation_task_id,
            name=f"{self._cls.__name__}.__init__",
            func=None,
            func_descriptor=f"{self._cls.__module__}.{self._cls.__name__}",
            args=args,
            kwargs=kwargs,
            num_returns=1,
            resources=_build_resources(opts),
            task_type=TaskType.ACTOR_CREATION_TASK,
            actor_id=actor_id,
            scheduling_strategy=opts.get("scheduling_strategy"),
            placement_group_id=None,
            runtime_env=opts.get("runtime_env"),
        )
        from ray_tpu_torch.remote_function import _validate_runtime_env
        _validate_runtime_env(spec.runtime_env)
        renv = spec.runtime_env or {}
        if renv.get("working_dir") or renv.get("pip"):
            # working_dir/pip apply for the DEDICATED worker process's
            # lifetime; thread-mode actors share the driver process and
            # cannot isolate them — fail eagerly when no process-backed
            # node could ever host this actor
            if not worker.needs_serialized_funcs:
                raise NotImplementedError(
                    "actor runtime_env working_dir/pip need a process-"
                    "backed node (worker_mode='process' or a cluster "
                    "node); this cluster is thread-only")
            spec.runtime_env = worker.prepare_runtime_env(renv)
        pg = opts.get("placement_group")
        strategy = opts.get("scheduling_strategy")
        if strategy is not None and hasattr(strategy, "placement_group"):
            pg = strategy.placement_group
            spec.placement_group_bundle_index = getattr(
                strategy, "placement_group_bundle_index", -1)
            spec.placement_group_capture_child_tasks = getattr(
                strategy, "placement_group_capture_child_tasks", False)
        if pg is not None:
            spec.placement_group_id = pg.id if hasattr(pg, "id") else pg
            from ray_tpu_torch.remote_function import _validate_bundle_fit
            _validate_bundle_fit(worker, spec.placement_group_id,
                                 spec.placement_group_bundle_index,
                                 spec.resources)

        cls, copts = self._cls, dict(opts)
        is_async = any(inspect.iscoroutinefunction(m) for _, m in
                       inspect.getmembers(cls, inspect.isfunction))
        # actor registry: the GCS actor table is the source of truth
        # (reference: GcsActorManager). DETACHED actors additionally
        # journal a recovery payload: they are meant to outlive their
        # owner, so a restarted head can re-attach them to their still-
        # running worker process (the reference keeps the serialized
        # creation spec in the actor table for the same reason).
        recovery = None
        if copts.get("lifetime") == "detached":
            import cloudpickle
            try:
                # init args ride along: a re-adopted actor that later
                # crashes restarts through the normal max_restarts path,
                # which re-runs __init__ with these
                recovery = cloudpickle.dumps((cls, copts, args, kwargs))
            except Exception:
                recovery = None  # unpicklable class: no head-restart FT
        worker.gcs.register_actor(actor_id, name or "", namespace,
                                  self._cls.__name__, worker.job_id,
                                  recovery=recovery)

        def create(pending, node_index, _worker=worker):
            # process mode: sync single-threaded actors get a dedicated
            # worker process on the ASSIGNED node (reference behavior);
            # async/threaded actors stay host-side (their event loop /
            # thread pool lives with the driver, as in the reference)
            rt_cls = _ActorRuntime
            if (_worker.pool_for_node(node_index) is not None
                    and not is_async
                    and int(copts.get("max_concurrency", 1)) == 1):
                rt_cls = _ProcessActorRuntime
            rt = rt_cls(_worker, actor_id, cls, args, kwargs, copts,
                        spec, node_index)
            with _worker._actors_lock:
                _worker.actors[actor_id] = rt
            rt.start()
            _worker.gcs.update_actor_state(actor_id, "ALIVE", node_index)

        from ray_tpu_torch._private.scheduler.base import PendingTask
        deps = [a.object_id() for a in args if isinstance(a, ObjectRef)]
        deps += [v.object_id() for v in kwargs.values()
                 if isinstance(v, ObjectRef)]
        unresolved = [d for d in deps if not worker.memory_store.contains(d)]
        pending = PendingTask(spec=spec, deps=unresolved, execute=create)
        # route through the scheduler so creation respects resources
        _submit_actor_creation(worker, pending, create)
        handle = ActorHandle(actor_id, self._cls.__name__)
        return handle


def adopt_process_actor(worker, actor_id: ActorID, entry, recovery: bytes,
                        pool, h, node_index: int):
    """Re-attach a journaled detached actor to its STILL-RUNNING worker
    process after a head restart (see Worker.readopt_remote_node). The
    worker holds the live instance; only the head-side runtime (inbox,
    ordered execution, borrow bookkeeping) is rebuilt."""
    import cloudpickle

    from ray_tpu_torch._private.task_spec import TaskSpec, TaskType

    blob = cloudpickle.loads(recovery)
    cls, opts, init_args, init_kwargs = (blob if len(blob) == 4
                                         else (*blob, (), {}))
    spec = TaskSpec(
        task_id=TaskID.for_actor_task(actor_id, 0),
        name=f"{cls.__name__}.__init__",
        func=None,
        func_descriptor=f"{cls.__module__}.{cls.__name__}.__init__",
        args=tuple(init_args),
        kwargs=dict(init_kwargs),
        num_returns=1,
        resources=_build_resources(opts),
        task_type=TaskType.ACTOR_CREATION_TASK,
        actor_id=actor_id,
    )
    rt = _ProcessActorRuntime(worker, actor_id, cls, tuple(init_args),
                              dict(init_kwargs), dict(opts),
                              spec, node_index)
    rt._pool = pool
    rt._h = h
    h.actor_rt = rt
    with pool._lock:
        pool._actor_handles.append(h)
    # lifetime resources re-charge on the rejoined node (best effort:
    # the fresh scheduler row has full capacity)
    if rt._explicit_resources:
        worker.scheduler.try_allocate(node_index, spec.resources)
    rt._adopted = True
    rt.state = ActorState.ALIVE
    rt.init_done.set()
    worker.memory_store.put(_creation_object_id(actor_id), "ALIVE")
    with worker._actors_lock:
        worker.actors[actor_id] = rt
    _ActorRuntime.start(rt)  # inbox loop only; no worker spawn/re-init
    worker.gcs.update_actor_state(actor_id, "ALIVE", node_index)
    return rt


def _submit_actor_creation(worker, pending, create):
    """Actor creation dispatches via the scheduler (so it respects
    resources/placement) but executes the _ActorRuntime bootstrap instead of
    a plain function call; the worker dispatcher recognizes _actor_boot."""
    pending.spec._actor_boot = create  # type: ignore[attr-defined]
    worker.scheduler.submit(pending)


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    worker = worker_mod.get_worker()
    if getattr(worker, "is_client", False):
        return worker.get_actor(name, namespace)
    actor_id = worker.gcs.get_actor_by_name(name, namespace)
    if actor_id is None:
        raise ValueError(f"no actor named {name!r} in namespace "
                         f"{namespace!r}")
    with worker._actors_lock:
        rt = worker.actors.get(actor_id)
    if rt is None:
        raise ValueError(f"actor {name!r} is registered but not running "
                         "(still being created, or dead)")
    return ActorHandle(actor_id, rt.cls.__name__)


def kill(handle: ActorHandle, *, no_restart: bool = True) -> None:
    worker = worker_mod.get_worker()
    if getattr(worker, "is_client", False):
        worker.kill_actor(handle.actor_id, no_restart)
        return
    with worker._actors_lock:
        rt = worker.actors.get(handle.actor_id)
    if rt is None:
        return
    rt.init_done.wait(timeout=30)
    rt.stop(no_restart=no_restart)

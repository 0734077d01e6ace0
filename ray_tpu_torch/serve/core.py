"""Serve controller, replicas, router, handles, HTTP ingress.

Reference: ray: python/ray/serve/ — _private/deployment_state.py
(replica lifecycle), _private/router.py (power-of-two-choices),
handle.py (DeploymentHandle), _private/http_proxy.py (ingress).

A copy of ray_tpu's serve core on the port's runtime (thread mode).
Metric families, the gRPC service name and the ingress routes are the
reference's, so clients and scrapes work against either package.
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions as rex

_lock = threading.Lock()
_controller: Optional["_Controller"] = None


# ----------------------------------------------------------------------
# public decorator / graph building
# ----------------------------------------------------------------------

class AutoscalingConfig:
    """Queue-driven replica autoscaling (reference: serve autoscaling
    from ongoing-request metrics).

    ``metric`` selects the pressure signal so disaggregated pools scale
    independently:

    - ``"ongoing"`` (default): in-flight requests per replica, the
      reference signal.
    - ``"ttft"``: the serving plane's recent p95 time-to-first-token
      against ``target_ttft_s`` — the prefill pool's signal (TTFT is
      prefill + one page handoff, so a missed target means the prompt
      pass is the bottleneck). Grows one replica per interval while
      p95 > target; shrinks when p95 < target/2.
    - ``"sessions"``: open sticky streams per replica against
      ``target_ongoing_requests`` — the decode pool's signal (a stream
      occupies a continuous-batching slot between polls, which plain
      ongoing-request counts cannot see).
    """

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 target_ongoing_requests: float = 2.0,
                 interval_s: float = 0.2, metric: str = "ongoing",
                 target_ttft_s: Optional[float] = None):
        if metric not in ("ongoing", "ttft", "sessions"):
            raise ValueError(f"unknown autoscaling metric {metric!r}")
        if metric == "ttft" and not target_ttft_s:
            raise ValueError("metric='ttft' needs target_ttft_s")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.target_ongoing_requests = target_ongoing_requests
        self.interval_s = interval_s
        self.metric = metric
        self.target_ttft_s = target_ttft_s


class Deployment:
    def __init__(self, cls, name: str, num_replicas: int,
                 max_ongoing_requests: int,
                 autoscaling_config: Optional[AutoscalingConfig] = None,
                 version: Optional[str] = None):
        self._cls = cls
        self.name = name
        self.num_replicas = num_replicas
        self.max_ongoing_requests = max_ongoing_requests
        self.autoscaling_config = autoscaling_config
        # user-declared code version (reference: DeploymentVersion):
        # a redeploy with the SAME version only rescales; a different
        # (or absent) version triggers a rolling replica replacement
        self.version = version

    _UNSET = object()

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_ongoing_requests: Optional[int] = None,
                autoscaling_config: Any = _UNSET,
                version: Optional[str] = None) -> "Deployment":
        """autoscaling_config=None explicitly DISABLES autoscaling;
        leaving it unset inherits."""
        return Deployment(
            self._cls, name or self.name,
            num_replicas if num_replicas is not None else
            self.num_replicas,
            max_ongoing_requests if max_ongoing_requests is not None
            else self.max_ongoing_requests,
            self.autoscaling_config if autoscaling_config is
            Deployment._UNSET else autoscaling_config,
            version if version is not None else self.version)

    def bind(self, *args, **kwargs) -> "Application":
        """Build the composition graph node (reference: deployment DAG);
        bound args may themselves be Applications — they resolve to
        handles of the child deployments at run()."""
        return Application(self, args, kwargs)

    def __repr__(self) -> str:
        return f"Deployment({self.name}, replicas={self.num_replicas})"


class Application:
    def __init__(self, deployment: Deployment, args, kwargs):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


def deployment(cls=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 100,
               autoscaling_config: Optional[AutoscalingConfig] = None,
               version: Optional[str] = None):
    """@serve.deployment decorator."""
    def wrap(c):
        return Deployment(c, name or c.__name__, num_replicas,
                          max_ongoing_requests, autoscaling_config,
                          version)

    return wrap(cls) if cls is not None else wrap


# ----------------------------------------------------------------------
# replicas + router
# ----------------------------------------------------------------------

import contextvars

# the model id of the REQUEST being handled (reference:
# serve.get_multiplexed_model_id inside a multiplexed deployment)
_current_model_id: "contextvars.ContextVar" = contextvars.ContextVar(
    "ray_tpu_serve_model_id", default=None)


def get_multiplexed_model_id() -> Optional[str]:
    """Inside a deployment method: the multiplexed_model_id the caller
    set via handle.options(multiplexed_model_id=...), else None."""
    return _current_model_id.get()


def _with_model_id(gen, model_id):
    """Re-enter the multiplexed-model-id contextvar around each step of
    a streaming response, preserving laziness (see _Replica.handle_request)."""
    while True:
        token = _current_model_id.set(model_id)
        try:
            try:
                item = next(gen)
            except StopIteration:
                return
        finally:
            _current_model_id.reset(token)
        yield item


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator for a per-replica model LOADER method (reference:
    @serve.multiplexed): results cache per model id in an LRU bounded
    by max_num_models_per_replica — the replica holds at most that
    many models, evicting least-recently-used."""
    def deco(loader):
        import collections
        import functools

        attr = f"_ray_tpu_mux_{loader.__name__}"
        lock_attr = f"{attr}_lock"

        @functools.wraps(loader)
        def wrapped(self, model_id):
            # replicas serve concurrently (max_concurrency > 1): the
            # cache and its MEMORY-bound eviction serialize under a
            # lock, but the LOAD itself runs outside it (a cold load
            # takes seconds for real models and must not block warm
            # hits). A placeholder event reserves the slot so the cap
            # is never exceeded and duplicate loads coalesce.
            # dict.setdefault is GIL-atomic, so lazy init needs no
            # module-level lock (which would also make the deployment
            # class unpicklable).
            d = self.__dict__
            lock = d.setdefault(lock_attr, threading.Lock())
            while True:
                with lock:
                    cache = d.setdefault(attr, collections.OrderedDict())
                    entry = cache.get(model_id)
                    if entry is not None and not isinstance(
                            entry, threading.Event):
                        cache.move_to_end(model_id)
                        return entry
                    if entry is None:
                        # evict BEFORE loading: the cap is a MEMORY
                        # bound; a cap+1 peak is exactly what OOMs.
                        # In-flight loaders are never evicted (their
                        # waiters hold the event) — oldest LOADED
                        # models go first
                        stalled = None
                        while len(cache) >= max_num_models_per_replica:
                            victim = next(
                                (k for k, v in cache.items()
                                 if not isinstance(v, threading.Event)),
                                None)
                            if victim is None:
                                # EVERY slot is mid-load: the cap must
                                # hold, so wait for one to finish and
                                # re-enter (no placeholder inserted)
                                stalled = next(iter(cache.values()))
                                break
                            cache.pop(victim)
                        if stalled is None:
                            placeholder = threading.Event()
                            cache[model_id] = placeholder
                            break
                    else:
                        stalled = entry
                # a loader is in flight (this model's, or — at cap —
                # someone else's): wait outside the lock, re-check
                stalled.wait(timeout=600)
            try:
                model = loader(self, model_id)
            except BaseException:
                with lock:
                    cache.pop(model_id, None)
                placeholder.set()
                raise
            with lock:
                cache[model_id] = model
            placeholder.set()
            return model

        wrapped.__ray_tpu_multiplexed__ = True
        return wrapped
    return deco


@ray_tpu_torch.remote
class _Replica:
    def __init__(self, cls_blob, init_args, init_kwargs):
        import cloudpickle

        cls = cloudpickle.loads(cls_blob)
        self.instance = cls(*init_args, **init_kwargs)

    def ping(self) -> str:
        """Health gate for rolling updates (reference: replica
        check_health): runs the deployment's own check_health() when
        it defines one — an exception marks the replica unhealthy."""
        check = getattr(self.instance, "check_health", None)
        if callable(check):
            check()
        return "ok"

    def shutdown_replica(self) -> None:
        """Explicit retirement hook: runs the deployment's shutdown()
        when it defines one, BEFORE the actor is killed — engine loops
        and device state release deterministically instead of riding
        __del__ (which a SIGKILLed worker never runs)."""
        hook = getattr(self.instance, "shutdown", None)
        if callable(hook):
            hook()

    def handle_request(self, method: str, args, kwargs,
                       model_id: Optional[str] = None):
        target = (self.instance if method == "__call__"
                  else getattr(self.instance, method))
        if method == "__call__" and not callable(target):
            raise TypeError("deployment is not callable; use "
                            "handle.<method>.remote()")
        fn = target if method != "__call__" else self.instance.__call__
        token = _current_model_id.set(model_id)
        try:
            result = fn(*args, **kwargs)
            import inspect as _inspect
            if _inspect.isgenerator(result):
                # the actor runtime materializes the generator AFTER
                # this finally resets the model-id contextvar, but a
                # generator body reading get_multiplexed_model_id()
                # must see it in scope — re-enter the contextvar around
                # every next(). NOTE the actor runtime still buffers
                # generator results when crossing the actor boundary,
                # so this preserves laziness only for same-process
                # composition; true cross-actor streaming is the
                # streaming-generator path (SSE ingress), not this.
                result = _with_model_id(result, model_id)
            return result
        finally:
            _current_model_id.reset(token)


class _ReplicaState:
    __slots__ = ("actor", "ongoing", "version", "gen")

    def __init__(self, actor, version=None, gen=0):
        self.actor = actor
        self.ongoing = 0
        self.version = version   # user-declared deployment version
        self.gen = gen           # internal code generation (bumps on
        #                          every rolling code replacement, so
        #                          UNVERSIONED redeploys roll too)


class _DeploymentState:
    """Replica set + router for one deployment (reference:
    DeploymentState + Router)."""

    def __init__(self, controller, dep: Deployment, init_args,
                 init_kwargs):
        import cloudpickle

        self._controller = controller
        self.dep = dep
        self._gen = 0
        self._cls_blob = cloudpickle.dumps(dep._cls)
        self._init_args = init_args
        self._init_kwargs = init_kwargs
        self._lock = threading.Lock()
        self._replicas: List[_ReplicaState] = []
        self._sticky: Dict[str, _ReplicaState] = {}  # session -> replica
        # model-multiplex affinity: model id -> replicas that served it
        # (reference: the router prefers replicas with the model warm);
        # bounded LRU over model ids
        import collections as _collections
        self._model_replicas: "_collections.OrderedDict" = \
            _collections.OrderedDict()
        self._stop = threading.Event()
        self._roll_lock = threading.Lock()
        self._autoscale_thread: Optional[threading.Thread] = None
        auto = dep.autoscaling_config
        self._scale_to(auto.min_replicas if auto else dep.num_replicas)
        self._ensure_autoscaler()

    def _ensure_autoscaler(self) -> None:
        """Start the autoscale thread when the CURRENT config wants
        one and none is running — redeploys can add autoscaling, and
        the loop exits on its own when a redeploy removes it."""
        if self.dep.autoscaling_config is None:
            return
        t = self._autoscale_thread
        if t is not None and t.is_alive():
            return
        self._autoscale_thread = threading.Thread(
            target=self._autoscale_loop, daemon=True,
            name=f"ray_tpu_serve_scale_{self.dep.name}")
        self._autoscale_thread.start()

    def _autoscale_loop(self) -> None:
        """Queue-driven scaling (reference: serve autoscaling reads
        ongoing-request metrics per replica). The config re-reads every
        tick: a rolling redeploy may change or remove it."""
        import math

        while True:
            cfg = self.dep.autoscaling_config
            if cfg is None:
                return  # autoscaling removed by a redeploy
            if self._stop.wait(cfg.interval_s):
                return
            cfg = self.dep.autoscaling_config
            if cfg is None:
                return
            with self._lock:
                ongoing = sum(r.ongoing for r in self._replicas)
                sessions = len(self._sticky)
                n = len(self._replicas)
            if cfg.metric == "ttft":
                # latency-driven: one step per interval, damped — TTFT
                # reacts to capacity with a lag (in-flight prefills
                # finish on the old pool size), so proportional jumps
                # would oscillate
                p95 = metrics.ttft_quantile(0.95)
                if p95 is None:
                    desired = n
                elif p95 > cfg.target_ttft_s:
                    desired = min(cfg.max_replicas, n + 1)
                elif p95 < cfg.target_ttft_s / 2:
                    desired = max(cfg.min_replicas, n - 1)
                else:
                    desired = n
            else:
                load = sessions if cfg.metric == "sessions" else ongoing
                desired = max(
                    cfg.min_replicas,
                    min(cfg.max_replicas,
                        math.ceil(load / cfg.target_ongoing_requests)))
            if desired != n:
                try:
                    self._scale_to(desired)
                except rex.RayTpuError:
                    pass  # growth failed its health gate: hold at n

    def _spawn(self) -> _ReplicaState:
        actor = _Replica.options(max_concurrency=8).remote(
            self._cls_blob, self._init_args, self._init_kwargs)
        return _ReplicaState(actor, self.dep.version, self._gen)

    def rolling_update(self, dep: Deployment, init_args, init_kwargs,
                       health_timeout_s: float = 30.0,
                       drain_timeout_s: float = 30.0) -> None:
        """Versioned rolling redeploy (reference: DeploymentState's
        version-diffed rollout): one at a time, a NEW-version replica
        spawns, passes its health gate, joins the router, and only
        then one old replica leaves — retired replicas first DRAIN
        their in-flight requests AND their open sticky streams. Old
        replicas keep serving throughout; a failing health gate aborts
        the roll and RESTORES the previous code/version, so crash
        respawns and retries never see the broken blob. Same declared
        version -> scale-only."""
        import cloudpickle

        with self._roll_lock:  # serialize concurrent rolls by name
            prev = (self.dep, self._cls_blob, self._init_args,
                    self._init_kwargs, self._gen)
            same_version = (dep.version is not None
                            and self.dep.version == dep.version)
            with self._lock:
                self.dep = dep
                self._init_args = init_args
                self._init_kwargs = init_kwargs
                if not same_version:
                    self._cls_blob = cloudpickle.dumps(dep._cls)
                    self._gen += 1
            target = (dep.autoscaling_config.min_replicas
                      if dep.autoscaling_config else dep.num_replicas)
            try:
                if same_version:
                    self._scale_to(target, force=False,
                                   health_timeout_s=health_timeout_s)
                else:
                    self._roll(target, health_timeout_s,
                               drain_timeout_s)
            except Exception:
                # abort: the OLD code must stay authoritative — a
                # crash respawn from the broken blob (or a same-version
                # retry short-circuit) would silently serve it
                with self._lock:
                    (self.dep, self._cls_blob, self._init_args,
                     self._init_kwargs, self._gen) = prev
                raise
            finally:
                self._ensure_autoscaler()

    def _roll(self, target: int, health_timeout_s: float,
              drain_timeout_s: float) -> None:
        while True:
            with self._lock:
                old_n = sum(1 for r in self._replicas
                            if r.gen != self._gen)
                n_total = len(self._replicas)
            if not old_n and n_total == target:
                return
            if not old_n and n_total > target:
                self._scale_to(target, force=False)  # trim extras
                return
            fresh = self._spawn()
            # HEALTH GATE before the router can see it
            self._health_gate([fresh], health_timeout_s)
            with self._lock:
                self._replicas.append(fresh)
                # re-derive the victim under THIS lock hold: the
                # snapshot above is stale across the health gate (a
                # crash respawn or the autoscaler may have removed it)
                victim = next((r for r in self._replicas
                               if r.gen != self._gen), None)
                if victim is not None:
                    self._replicas.remove(victim)
                    self._prune_affinity_locked()
                    # the victim deliberately STAYS in self._sticky:
                    # open streaming sessions keep routing to it while
                    # it drains; only new sessions see the new set
            self._drain_and_kill(victim, drain_timeout_s)

    def _health_gate(self, fresh: List[_ReplicaState],
                     timeout_s: float) -> None:
        """check_health gate shared by EVERY spawn path (initial
        deploy, autoscaler growth, crash respawn, rolling update)."""
        try:
            ray_tpu_torch.get([f.actor.ping.remote() for f in fresh],
                              timeout=timeout_s)
        except Exception as e:
            for f in fresh:
                try:
                    ray_tpu_torch.kill(f.actor)
                except Exception:
                    pass
            raise rex.RayTpuError(
                f"replica health check failed for "
                f"{self.dep.name!r}: {e}") from e

    def _drain_and_kill(self, state: Optional[_ReplicaState],
                        timeout_s: float) -> None:
        """Retired replica: wait for its in-flight requests AND open
        sticky streams to finish (it no longer receives new sessions —
        it left the router under the lock), then kill."""
        if state is None:
            return
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                pinned = any(r is state
                             for r in self._sticky.values())
            if state.ongoing == 0 and not pinned:
                break
            time.sleep(0.02)
        with self._lock:
            # a stream that outlived the drain timeout loses its
            # replica (documented limit of the timeout)
            self._sticky = {sid: r for sid, r in self._sticky.items()
                            if r is not state}
        self._retire_actor(state)

    def _retire_actor(self, state: _ReplicaState) -> None:
        """Graceful retirement: run the replica's explicit shutdown
        hook (best-effort, bounded) before the kill — retired replicas
        are HEALTHY, so relying on __del__ inside a killed worker would
        leak engine threads until process exit."""
        try:
            ray_tpu_torch.get(state.actor.shutdown_replica.remote(),
                              timeout=5.0)
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(state.actor)
        except Exception:
            pass

    def _scale_to(self, n: int, force: bool = False,
                  health_timeout_s: float = 30.0) -> None:
        """force=False (autoscaler): never grow after shutdown, and only
        retire IDLE replicas — killing one mid-request would fail its
        callers' pending refs. force=True (shutdown/redeploy) tears down
        unconditionally. Growth happens OUTSIDE the router lock and
        behind the health gate: actor boot must not stall request
        routing, and an unhealthy replica must never join the set."""
        while not force:
            with self._lock:
                if self._stop.is_set():
                    return  # shutdown won the race; do not respawn
                need = n - len(self._replicas)
            if need <= 0:
                break
            fresh = [self._spawn() for _ in range(need)]
            self._health_gate(fresh, health_timeout_s)
            extras: List[_ReplicaState] = []
            with self._lock:
                if self._stop.is_set():
                    extras = fresh
                else:
                    room = max(0, n - len(self._replicas))
                    self._replicas.extend(fresh[:room])
                    extras = fresh[room:]
            for f in extras:
                try:
                    ray_tpu_torch.kill(f.actor)
                except Exception:
                    pass
            if extras:
                break
        with self._lock:
            if force:
                while len(self._replicas) < n:
                    self._replicas.append(self._spawn())
            victims = []
            if force:
                while len(self._replicas) > n:
                    victims.append(self._replicas.pop())
            else:
                # a replica holding sticky sessions is NOT idle even
                # with no request in flight: a stream between polls
                # would lose its replica-local state
                pinned = set(map(id, self._sticky.values()))
                idle = [r for r in self._replicas
                        if r.ongoing == 0 and id(r) not in pinned]
                while len(self._replicas) > n and idle:
                    victim = idle.pop()
                    self._replicas.remove(victim)
                    victims.append(victim)
            if victims:
                self._prune_affinity_locked()
        for state in victims:
            self._retire_actor(state)

    def _pick(self, model_id: Optional[str] = None,
              prefer: Optional[_ReplicaState] = None) -> _ReplicaState:
        """Power-of-two-choices on tracked ongoing requests. RESERVES
        the chosen replica (ongoing += 1) under the same lock hold —
        otherwise the autoscaler could classify it idle and kill it in
        the window before the caller's increment. A multiplexed
        model_id prefers the least-loaded replica that served that
        model before (warm cache), falling back to P2C. ``prefer``
        (cache-affinity routing: the replica already holding a
        session's KV pages) wins over both, under the same
        yield-when-saturated rule — affinity must not pin a hot
        session to an overloaded replica while the pool idles."""
        with self._lock:
            if not self._replicas:
                raise rex.RayTpuError(
                    f"deployment {self.dep.name} has no replicas")
            chosen = None
            if prefer is not None and prefer in self._replicas:
                idlest = min(r.ongoing for r in self._replicas)
                if prefer.ongoing <= idlest + 2:
                    chosen = prefer
            if chosen is None and model_id is not None:
                warm = [r for r in self._model_replicas.get(model_id, ())
                        if r in self._replicas]
                if warm:
                    cand = min(warm, key=lambda r: r.ongoing)
                    # affinity yields under load: a saturated warm
                    # replica must not cap one model's throughput at a
                    # single replica while others idle — fall back to
                    # P2C (the pick below records the new replica warm)
                    idlest = min(r.ongoing for r in self._replicas)
                    if cand.ongoing <= idlest + 2:
                        chosen = cand
            if chosen is None:
                if len(self._replicas) == 1:
                    chosen = self._replicas[0]
                else:
                    a, b = random.sample(self._replicas, 2)
                    chosen = a if a.ongoing <= b.ongoing else b
            if model_id is not None:
                served = self._model_replicas.setdefault(model_id, [])
                if chosen not in served:
                    served.append(chosen)
                self._model_replicas.move_to_end(model_id)
                while len(self._model_replicas) > 1024:
                    self._model_replicas.popitem(last=False)
            chosen.ongoing += 1
            return chosen

    def _track_until_resolved(self, state: _ReplicaState, ref) -> None:
        """Queue-length bookkeeping decays when the result resolves
        (or immediately when tracking cannot be registered)."""
        def _dec():
            with self._lock:
                state.ongoing = max(0, state.ongoing - 1)

        try:
            from ray_tpu_torch._private import worker as worker_mod

            worker_mod.get_worker().run_callback_when_ready(
                ref.object_id(), _dec)
        except Exception:
            _dec()

    def submit(self, method: str, args, kwargs, _retry: bool = True,
               model_id: Optional[str] = None):
        state = self._pick(model_id)
        try:
            ref = state.actor.handle_request.remote(method, args, kwargs,
                                                    model_id)
        except rex.ActorError:
            # replica died: release the reservation, replace it, retry
            # once on another
            with self._lock:
                state.ongoing = max(0, state.ongoing - 1)
            self._replace(state)
            if _retry:
                return self.submit(method, args, kwargs, _retry=False,
                                   model_id=model_id)
            raise
        except BaseException:
            # any other failure (e.g. argument serialization): the call
            # never reached the replica, so the reservation must decay
            # here or P2C routing skews away from it forever
            with self._lock:
                state.ongoing = max(0, state.ongoing - 1)
            raise
        self._track_until_resolved(state, ref)
        return ref

    def submit_sticky(self, method: str, args, kwargs,
                      session: Optional[str] = None,
                      _retry: bool = True,
                      prefer: Optional[_ReplicaState] = None):
        """Replica-PINNED call: session=None picks a replica and opens
        a sticky session (returned token routes later calls to the
        same replica — replica-local state like token streams must not
        be load-balanced away). A dead PINNED replica raises (its
        session state died with it); opening a session retries once on
        another replica, like submit. ``prefer`` biases the opening
        pick (cache-affinity routing). Returns (ref, token)."""
        import uuid as _uuid

        if session is None:
            state = self._pick(prefer=prefer)  # reserves (ongoing += 1)
            token = _uuid.uuid4().hex
            with self._lock:
                self._sticky[token] = state
        else:
            token = session
            with self._lock:
                state = self._sticky.get(token)
                if state is None or state not in self._replicas:
                    self._sticky.pop(token, None)
                    raise rex.RayTpuError(
                        "sticky session's replica is gone")
                state.ongoing += 1
        try:
            ref = state.actor.handle_request.remote(method, args, kwargs)
        except rex.ActorError:
            with self._lock:
                state.ongoing = max(0, state.ongoing - 1)
                self._sticky.pop(token, None)
            self._replace(state)
            if session is None and _retry:
                # nothing was pinned yet: retry once on a replacement
                return self.submit_sticky(method, args, kwargs,
                                          session=None, _retry=False)
            raise
        except BaseException:
            # non-ActorError failure: release the reservation; an
            # existing session stays pinned (the replica is healthy) but
            # a just-opened token was never returned to the caller, so
            # drop it
            with self._lock:
                state.ongoing = max(0, state.ongoing - 1)
                if session is None:
                    self._sticky.pop(token, None)
            raise
        self._track_until_resolved(state, ref)
        return ref, token

    def end_sticky(self, token: str) -> None:
        with self._lock:
            self._sticky.pop(token, None)

    def sticky_replica(self, token: str) -> Optional[_ReplicaState]:
        """The replica a sticky session is pinned to (None when the
        session ended or its replica left) — cache-affinity routing
        records this as the session's KV-page holder."""
        with self._lock:
            return self._sticky.get(token)

    def _replace(self, dead: _ReplicaState) -> None:
        with self._lock:
            try:
                self._replicas.remove(dead)
            except ValueError:
                return  # already replaced
            self._prune_affinity_locked()
        fresh = self._spawn()
        try:
            self._health_gate([fresh], 30.0)
        except rex.RayTpuError:
            return  # current blob won't boot healthy: don't publish
        with self._lock:
            if self._stop.is_set():
                pass  # shutdown raced the respawn
            else:
                self._replicas.append(fresh)
                return
        try:
            ray_tpu_torch.kill(fresh.actor)
        except Exception:
            pass

    def _prune_affinity_locked(self) -> None:
        """Drop dead replicas from the model-affinity lists (they are
        filtered on read, but replica churn would otherwise grow them
        — and their actor handles — without bound)."""
        live = set(map(id, self._replicas))
        for m, lst in list(self._model_replicas.items()):
            kept = [r for r in lst if id(r) in live]
            if kept:
                self._model_replicas[m] = kept
            else:
                del self._model_replicas[m]

    def shutdown(self) -> None:
        self._stop.set()
        self._scale_to(0, force=True)


class DeploymentHandle:
    """Calls route through the controller's router (reference:
    serve.handle.DeploymentHandle). handle.remote(...) calls __call__;
    handle.method.remote(...) calls a method. Results are ObjectRefs —
    ray_tpu_torch.get() them (the reference returns DeploymentResponse;
    .result() ≙ get)."""

    def __init__(self, name: str, model_id: Optional[str] = None):
        self.deployment_name = name
        self._model_id = model_id

    def options(self, *, multiplexed_model_id: Optional[str] = None
                ) -> "DeploymentHandle":
        """A handle whose calls carry a multiplexed model id: the
        router prefers replicas with that model warm, and the replica
        reads it via serve.get_multiplexed_model_id() (reference:
        handle.options(multiplexed_model_id=...))."""
        return DeploymentHandle(self.deployment_name,
                                model_id=multiplexed_model_id)

    def _state(self) -> _DeploymentState:
        c = _controller
        if c is None or name_missing(c, self.deployment_name):
            raise rex.RayTpuError(
                f"deployment {self.deployment_name!r} is not running")
        return c.deployments[self.deployment_name]

    def remote(self, *args, **kwargs):
        return self._state().submit("__call__", args, kwargs,
                                    model_id=self._model_id)

    def result_of(self, *args, timeout: Optional[float] = 30.0, **kwargs):
        return ray_tpu_torch.get(self.remote(*args, **kwargs),
                                 timeout=timeout)

    def __getattr__(self, method: str) -> "_MethodCaller":
        if method.startswith("_"):
            raise AttributeError(method)
        return _MethodCaller(self, method)

    def __reduce__(self):
        return (DeploymentHandle, (self.deployment_name, self._model_id))


def name_missing(c: "_Controller", name: str) -> bool:
    return name not in c.deployments


class _MethodCaller:
    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle._state().submit(
            self._method, args, kwargs,
            model_id=self._handle._model_id)


# ----------------------------------------------------------------------
# controller
# ----------------------------------------------------------------------

class _Controller:
    def __init__(self):
        self.deployments: Dict[str, _DeploymentState] = {}
        self._deploy_lock = threading.RLock()
        self.ingress_name: Optional[str] = None
        self.http_server = None
        self.grpc_server = None

    def deploy_app(self, app: Application) -> DeploymentHandle:
        handle = self._deploy_node(app)
        self.ingress_name = app.deployment.name
        return handle

    def _deploy_node(self, app: Application) -> DeploymentHandle:
        # depth-first: children bind first, their handles become args
        args = tuple(self._deploy_node(a) if isinstance(a, Application)
                     else a for a in app.args)
        kwargs = {k: (self._deploy_node(v) if isinstance(v, Application)
                      else v) for k, v in app.kwargs.items()}
        name = app.deployment.name
        with self._deploy_lock:
            existing = self.deployments.get(name)
            if existing is None:
                self.deployments[name] = _DeploymentState(
                    self, app.deployment, args, kwargs)
                return DeploymentHandle(name)
        # versioned rolling redeploy runs OUTSIDE the controller lock
        # (health gates + drains can take minutes and must not block
        # unrelated deployments); the per-deployment _roll_lock
        # serializes concurrent rolls of the same name
        existing.rolling_update(app.deployment, args, kwargs)
        return DeploymentHandle(name)

    def shutdown(self) -> None:
        for state in self.deployments.values():
            state.shutdown()
        self.deployments.clear()
        if self.http_server is not None:
            self.http_server.shutdown()
            self.http_server.server_close()  # release the listen socket
            self.http_server = None
        if self.grpc_server is not None:
            self.grpc_server.stop(grace=None)
            self.grpc_server = None


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------

def run(app: Application) -> DeploymentHandle:
    """Deploy the application graph; returns the ingress handle."""
    global _controller
    with _lock:
        if _controller is None:
            _controller = _Controller()
        controller = _controller
    # deploy outside the module lock: a long rolling update must not
    # block status()/shutdown()/other apps
    return controller.deploy_app(app)


def get_app_handle(name: Optional[str] = None) -> DeploymentHandle:
    """Handle for a deployment by name, or for the APP INGRESS (the
    deployment run() was last called with) when name is omitted."""
    if name is None:
        if _controller is None or _controller.ingress_name is None:
            raise rex.RayTpuError("no application is running")
        name = _controller.ingress_name
    if _controller is None or name not in _controller.deployments:
        raise rex.RayTpuError(f"no deployment named {name!r}")
    return DeploymentHandle(name)


def status() -> Dict[str, Dict[str, Any]]:
    if _controller is None:
        return {}
    out = {}
    for name, st in _controller.deployments.items():
        with st._lock:
            out[name] = {"replicas": len(st._replicas),
                         "ongoing": sum(r.ongoing for r in st._replicas),
                         "version": st.dep.version,
                         "replica_versions": [r.version
                                              for r in st._replicas]}
    return out


def shutdown() -> None:
    global _controller
    with _lock:
        if _controller is not None:
            _controller.shutdown()
            _controller = None
    metrics.reset()
    kv_directory.reset()
    _stream_drivers.clear()


# ----------------------------------------------------------------------
# serving-at-scale plane: TTFT window + counters, SLO admission, and
# the KV-page directory behind cache-affinity routing
# ----------------------------------------------------------------------

class AdmissionShedError(rex.RayTpuError):
    """New stream shed at ingress: recent p95 TTFT is over the
    serve_slo_ttft_p95_s target while streams are in flight. Callers
    should back off; the HTTP ingress maps this to 503."""


# prometheus-convention boundaries for the TTFT histogram
_TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                 5.0, 10.0)


class _ServeMetrics:
    """Process-wide serving counters + the TTFT sliding window the
    admission gate and the ttft-mode autoscaler read. Counters are
    cumulative (prometheus semantics, rendered by metrics.py); the
    window is bounded by serve_ttft_window and resets with the
    controller so tests see a clean plane per serve lifecycle."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        import collections

        with self._lock:
            self._window = collections.deque(maxlen=1024)
            self.ttft_count = 0
            self.ttft_sum = 0.0
            self.ttft_buckets = [0] * len(_TTFT_BUCKETS)
            self.affinity_hit = 0
            self.affinity_miss = 0
            self.admission_shed = 0
            self.kv_bytes = 0
            self.streams = 0
            self.resumed = 0

    def record_ttft(self, seconds: float) -> None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        try:
            win = int(GLOBAL_CONFIG.serve_ttft_window)
        except Exception:
            win = 256
        with self._lock:
            self._window.append(seconds)
            while len(self._window) > max(1, win):
                self._window.popleft()
            self.ttft_count += 1
            self.ttft_sum += seconds
            for i, b in enumerate(_TTFT_BUCKETS):
                if seconds <= b:
                    self.ttft_buckets[i] += 1

    def ttft_quantile(self, q: float) -> Optional[float]:
        with self._lock:
            if not self._window:
                return None
            xs = sorted(self._window)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def count(self, name: str, delta: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + delta)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._window)
            xs = sorted(self._window)
            quant = (lambda q: xs[min(n - 1, int(q * n))]) if n else \
                (lambda q: None)
            return {
                "ttft_count": self.ttft_count,
                "ttft_sum": self.ttft_sum,
                "ttft_buckets": list(self.ttft_buckets),
                "ttft_p50": quant(0.50),
                "ttft_p95": quant(0.95),
                "ttft_p99": quant(0.99),
                "affinity_hit": self.affinity_hit,
                "affinity_miss": self.affinity_miss,
                "admission_shed": self.admission_shed,
                "kv_bytes": self.kv_bytes,
                "streams": self.streams,
                "resumed": self.resumed,
            }


metrics = _ServeMetrics()


class _KVDirectory:
    """session id -> (deployment, replica, KV handoff object) — the
    KV-page directory behind cache-affinity routing. It is a THIN
    overlay on the multi-location object directory (gcs): the gcs rows
    stay authoritative for WHERE the exported pages physically live
    (primary + secondaries; node death drops locations), while this
    map remembers WHICH replica imported them for a session.

    lookup() resolves three ways:
    - ``hit``: the holding replica is still in the pool — route there.
    - ``promoted``: the replica is gone but the object directory still
      knows a live location for the handoff bytes (a secondary copy
      survived the node) — any replica can re-import without paying a
      prefill; the entry re-pins on the next record().
    - ``gone``: no live location remains (sole copy died with its
      node) — the entry drops and the caller re-prefills.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, tuple] = {}  # sid -> (dep, replica, ref)
        self._seen: set = set()  # sessions ever recorded (survives drop:
        #                          distinguishes a follow-up turn whose
        #                          entry was invalidated — an affinity
        #                          MISS — from a first-ever turn, which
        #                          cannot hit and counts as neither)

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._seen.clear()

    def known(self, session: str) -> bool:
        with self._lock:
            return session in self._seen

    def record(self, session: str, dep_name: str, replica, kv_ref) -> None:
        with self._lock:
            self._entries[session] = (dep_name, replica, kv_ref)
            self._seen.add(session)
            while len(self._seen) > 65536:
                self._seen.pop()
            while len(self._entries) > 4096:
                self._entries.pop(next(iter(self._entries)))

    def drop(self, session: str) -> None:
        with self._lock:
            self._entries.pop(session, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _locations_alive(self, kv_ref) -> bool:
        if kv_ref is None:
            return False
        try:
            from ray_tpu_torch._private import worker as worker_mod

            w = worker_mod.get_worker()
            return bool(w.gcs.object_locations(kv_ref.object_id()))
        except Exception:
            return False

    def lookup(self, session: Optional[str],
               dep_state: "_DeploymentState"):
        """Returns (status, replica_or_None, kv_ref_or_None); status in
        {"hit", "promoted", "gone", "none"}."""
        if session is None:
            return "none", None, None
        with self._lock:
            entry = self._entries.get(session)
        if entry is None:
            return "none", None, None
        dep_name, replica, kv_ref = entry
        with dep_state._lock:
            alive = replica in dep_state._replicas
        if alive:
            return "hit", replica, kv_ref
        if self._locations_alive(kv_ref):
            return "promoted", None, kv_ref
        self.drop(session)
        return "gone", None, None


kv_directory = _KVDirectory()


def check_admission(state: Optional[_DeploymentState] = None) -> None:
    """SLO-aware ingress gate: raise AdmissionShedError for a NEW
    stream when the recent p95 TTFT is over target while load is in
    flight. Sheds stop as soon as in-flight work drains (no load means
    the next admit cannot be queue-bound) or fresh samples come back
    under target — the gate reads the live window, so it self-heals
    instead of latching shut on stale samples."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    try:
        target = float(GLOBAL_CONFIG.serve_slo_ttft_p95_s)
    except Exception:
        return
    if target <= 0:
        return
    p95 = metrics.ttft_quantile(0.95)
    if p95 is None or p95 <= target:
        return
    if state is not None:
        with state._lock:
            busy = (sum(r.ongoing for r in state._replicas)
                    + len(state._sticky))
        if busy == 0:
            return
    metrics.count("admission_shed")
    raise AdmissionShedError(
        f"shedding at ingress: recent p95 TTFT {p95:.3f}s over the "
        f"{target:.3f}s SLO target")


def serving_stats() -> Dict[str, Any]:
    """One snapshot for metrics/state/dashboard: plane counters plus
    per-deployment rows (pool role is the deployment's declared
    autoscaling metric when present)."""
    snap = metrics.snapshot()
    snap["kv_sessions"] = len(kv_directory)
    deployments = []
    c = _controller
    if c is not None:
        for name, st in list(c.deployments.items()):
            auto = st.dep.autoscaling_config
            with st._lock:
                deployments.append({
                    "name": name,
                    "replicas": len(st._replicas),
                    "ongoing": sum(r.ongoing for r in st._replicas),
                    "sessions": len(st._sticky),
                    "version": st.dep.version,
                    "autoscaling_metric": auto.metric if auto else None,
                })
    snap["deployments"] = deployments
    return snap


# apps with a custom streaming topology (the disaggregated LLM app)
# register a frames-driver under their public name; the HTTP SSE and
# gRPC PredictStream routes consult this before falling back to the
# single-deployment sticky protocol
_stream_drivers: Dict[str, Callable] = {}


def register_stream_driver(name: str, driver: Callable) -> None:
    _stream_drivers[name] = driver


def _frames_for(name: str, prompt, max_new_tokens):
    driver = _stream_drivers.get(name)
    if driver is not None:
        return driver(prompt, max_new_tokens)
    return _sticky_stream_frames(get_app_handle(name)._state(), prompt,
                                 max_new_tokens)


def _sticky_stream_frames(state: _DeploymentState, prompt,
                          max_new_tokens, start_timeout: float = 60.0,
                          poll_timeout: float = 120.0):
    """Token-burst frames of the replica-sticky streaming protocol
    (start_stream / next_tokens until done) — the ONE driver both the
    HTTP SSE route and the gRPC PredictStream wrap. Sticky: every poll
    must hit the replica holding the stream; the session releases on
    EVERY exit path, including a consumer that stops iterating.

    This is also an ADMISSION POINT: new streams shed against the
    p95-TTFT SLO before touching a replica, and the wait for the first
    token burst is the TTFT sample the gate and the ttft autoscaler
    read."""
    check_admission(state)
    metrics.count("streams")
    t0 = time.monotonic()
    first_seen = False
    ref, token = state.submit_sticky(
        "start_stream", (prompt, max_new_tokens), {})
    try:
        sid = ray_tpu_torch.get(ref, timeout=start_timeout)
        while True:
            ref, _ = state.submit_sticky("next_tokens", (sid,), {},
                                         session=token)
            r = ray_tpu_torch.get(ref, timeout=poll_timeout)
            if not first_seen and r.get("tokens"):
                first_seen = True
                metrics.record_ttft(time.monotonic() - t0)
            yield r
            if r.get("done"):
                return
    finally:
        state.end_sticky(token)


# ----------------------------------------------------------------------
# HTTP ingress (reference: HTTPProxy; minimal JSON POST)
# ----------------------------------------------------------------------

def start_http(port: int = 0) -> int:
    """POST /{deployment} with a JSON body calls the deployment's
    __call__ with the decoded payload; responds JSON.

    POST /{deployment}/stream drives the deployment's streaming poll
    protocol (start_stream/next_tokens — see serve/llm.py) and emits
    Server-Sent Events: one ``data: {"tokens": [...], "done": ...}``
    event per burst, connection closed after the done event (the SSE
    emission shape of the reference's serve.llm streaming ingress).
    Returns the bound port."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def _json_response(self, code: int, obj) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):  # noqa: N802
            name = self.path.strip("/")
            if name.endswith("/stream"):
                return self._do_stream(name[:-len("/stream")])
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b"null"
            try:
                payload = json.loads(body)
                handle = get_app_handle(name)
                result = ray_tpu_torch.get(handle.remote(payload),
                                           timeout=30)
                self._json_response(200, {"result": result})
            except Exception as e:  # noqa: BLE001
                self._json_response(500, {"error": str(e)})

        def _do_stream(self, name: str) -> None:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b"null"
            try:
                payload = json.loads(body) or {}
                frames = _frames_for(name, payload.get("prompt"),
                                     payload.get("max_new_tokens"))
                # pull the FIRST burst before committing to SSE: a
                # failed stream start must answer 500 JSON, not a
                # half-open event stream
                first = next(frames, None)
            except AdmissionShedError as e:
                # SLO shed is a load signal, not a server fault:
                # 503 + Retry-After so well-behaved clients back off
                data = json.dumps({"error": str(e), "shed": True}).encode()
                self.send_response(503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Retry-After", "1")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            except Exception as e:  # noqa: BLE001
                self._json_response(500, {"error": str(e)})
                return
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()  # no Content-Length: stream to close

                def emit(r) -> None:
                    self.wfile.write(
                        f"data: {json.dumps(r)}\n\n".encode())
                    self.wfile.flush()

                if first is not None:
                    emit(first)
                for r in frames:
                    emit(r)
            except Exception as e:  # noqa: BLE001
                # a final error event: the client must be able to tell
                # a server-side failure from a complete stream or a
                # network drop (best effort; the socket may be gone)
                frames.close()  # releases the sticky session
                try:
                    self.wfile.write(
                        f"data: {json.dumps({'error': str(e), 'done': True})}"
                        "\n\n".encode())
                    self.wfile.flush()
                except Exception:
                    pass
                return

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="ray_tpu_serve_http").start()
    with _lock:
        global _controller
        if _controller is None:
            _controller = _Controller()
        if _controller.http_server is not None:
            # a second start must not orphan a live listener that
            # shutdown() could never reach
            _controller.http_server.shutdown()
            _controller.http_server.server_close()
        _controller.http_server = httpd
    return httpd.server_port


# ----------------------------------------------------------------------
# gRPC ingress (reference: serve's gRPC proxy — grpc_util/
# grpcServiceProxy; here a generic-handler service speaking JSON
# payloads, so no codegen toolchain is required: the wire contract is
# the method names below + JSON bytes, and a .proto schema could land
# behind the same names without touching callers of start_grpc)
# ----------------------------------------------------------------------

GRPC_SERVICE = "ray_tpu.serve.Ingress"


def start_grpc(port: int = 0, max_workers: int = 8) -> int:
    """gRPC ingress on 127.0.0.1:

    /ray_tpu.serve.Ingress/Predict (unary): request bytes = JSON
    {"deployment"?: name, "input": payload, "multiplexed_model_id"?:
    id} -> reply JSON {"result": ...} (the app ingress serves when
    deployment is omitted).

    /ray_tpu.serve.Ingress/PredictStream (server-streaming): request
    JSON {"deployment"?, "prompt", "max_new_tokens"?} -> one JSON
    frame per token burst, same replica-sticky poll protocol as the
    HTTP SSE route. Returns the bound port."""
    from concurrent import futures as _futures

    import grpc

    def _handle_of(payload):
        name = (payload or {}).get("deployment")
        return get_app_handle(name) if name else get_app_handle()

    def predict(request: bytes, context) -> bytes:
        try:
            payload = json.loads(request or b"null") or {}
            handle = _handle_of(payload)
            mid = payload.get("multiplexed_model_id")
            if mid is not None:
                handle = handle.options(multiplexed_model_id=mid)
            result = ray_tpu_torch.get(
                handle.remote(payload.get("input")), timeout=30)
            return json.dumps({"result": result}).encode()
        except Exception as e:  # noqa: BLE001
            context.abort(grpc.StatusCode.INTERNAL, str(e))

    def predict_stream(request: bytes, context):
        try:
            payload = json.loads(request or b"null") or {}
            name = payload.get("deployment") or _controller.ingress_name
            for r in _frames_for(name, payload.get("prompt"),
                                 payload.get("max_new_tokens")):
                yield json.dumps(r).encode()
        except AdmissionShedError as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except Exception as e:  # noqa: BLE001
            context.abort(grpc.StatusCode.INTERNAL, str(e))

    handler = grpc.method_handlers_generic_handler(GRPC_SERVICE, {
        "Predict": grpc.unary_unary_rpc_method_handler(predict),
        "PredictStream": grpc.unary_stream_rpc_method_handler(
            predict_stream),
    })
    server = grpc.server(_futures.ThreadPoolExecutor(
        max_workers=max_workers))
    server.add_generic_rpc_handlers((handler,))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    with _lock:
        global _controller
        if _controller is None:
            _controller = _Controller()
        if _controller.grpc_server is not None:
            _controller.grpc_server.stop(grace=None)
        _controller.grpc_server = server
    return bound

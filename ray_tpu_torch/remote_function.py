"""@remote function decorator and submission options.

Reference surface: python/ray/remote_function.py (RemoteFunction,
._remote(), .options()) — same semantics: free functions become task
factories; `.remote(*args)` returns ObjectRef(s); `.options()` overrides
resources/retries/strategy per call site.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.task_spec import TaskSpec, TaskType

_DEFAULT_OPTIONS = dict(
    num_cpus=1.0,
    num_gpus=0.0,
    memory=0.0,
    resources=None,
    num_returns=1,
    max_retries=None,
    retry_exceptions=False,
    timeout_s=None,
    name=None,
    scheduling_strategy=None,
    placement_group=None,
    placement_group_bundle_index=-1,
    runtime_env=None,
    # QoS plane (config.qos): strict priority tier (higher wins; may
    # preempt) and owning tenant for weighted fair-share. Inert when
    # the plane is off.
    priority=0,
    tenant=None,
)


def _build_resources(opts: Dict[str, Any]) -> Dict[str, float]:
    res = {"CPU": float(opts["num_cpus"])}
    if opts["num_gpus"]:
        res["GPU"] = float(opts["num_gpus"])
    if opts["memory"]:
        res["memory"] = float(opts["memory"])
    if opts["resources"]:
        res.update(opts["resources"])
    return res


class RemoteFunction:
    def __init__(self, func: Callable, options: Optional[Dict[str, Any]] = None):
        self._function = func
        self._name = getattr(func, "__qualname__", getattr(func, "__name__", "fn"))
        self._module = getattr(func, "__module__", "")
        self._options = dict(_DEFAULT_OPTIONS)
        if options:
            self._options.update(options)
        self._is_generator = inspect.isgeneratorfunction(func)
        # function blob pickled ONCE per RemoteFunction, like the
        # reference's pickled_function export (ray:
        # python/ray/remote_function.py) — per-call cloudpickle of the
        # same function was the single largest task-submission cost.
        # NOTE closure values are captured at first .remote(), matching
        # the reference's freeze-at-export semantics.
        self._fn_blob: Optional[bytes] = None
        self._fn_id: Optional[bytes] = None
        self._exec_func: Optional[Callable] = None
        # default-placement scheduling class, computed once per
        # RemoteFunction: scheduling_class() on the admission hot path
        # re-sorted the resources dict per task otherwise
        res = _build_resources(self._options)
        strat = self._options["scheduling_strategy"]
        place = ("spread",) if strat == "SPREAD" else ("default",)
        self._class_key = (
            (f"{self._module}.{self._name}",
             tuple(sorted(res.items())), place)
            if (self._options["placement_group"] is None
                and (strat is None or isinstance(strat, str)))
            else None)
        # submission fast path: everything per-call-invariant is decided
        # here once, so `.remote()` with plain options is a TaskSpec
        # construction + submit and nothing else. The resources dict is
        # SHARED across this function's specs (read-only downstream).
        self._resources = res
        self._descriptor = f"{self._module}.{self._name}"
        self._fast = (strat is None
                      and self._options["placement_group"] is None
                      and not self._options["runtime_env"]
                      and not self._is_generator
                      and isinstance(self._options["num_returns"], int))
        functools.update_wrapper(self, func)

    def bind(self, *args, **kwargs):
        """DAG-building (reference: ray.dag): returns a node; compose
        with other .bind() results and experimental_compile()."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._name} cannot be called directly; use "
            f"{self._name}.remote() or access the original via "
            f"{self._name}.func")

    @property
    def func(self) -> Callable:
        """The undecorated function (upstream: .__wrapped__ / _function)."""
        return self._function

    def options(self, **overrides) -> "RemoteFunction":
        for k in overrides:
            if k not in _DEFAULT_OPTIONS and k != "num_tpus":
                raise ValueError(f"unknown option {k!r}")
        if "num_tpus" in overrides:  # portability alias
            overrides["num_gpus"] = overrides.pop("num_tpus")
        merged = dict(self._options)
        merged.update(overrides)
        return RemoteFunction(self._function, merged)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def _fast_setup(self, worker, opts):
        """Shared per-CALL setup of the fast submission lane (used by
        both _remote's fast path and map_remote): resolved exec func,
        cached serialized blob, effective max_retries."""
        func = self._exec_func
        if func is None:
            func = self._exec_func = self._function
        if self._fn_blob is None and worker.needs_serialized_funcs:
            import hashlib

            import cloudpickle
            self._fn_blob = cloudpickle.dumps(func)
            self._fn_id = hashlib.sha1(self._fn_blob).digest()
        max_retries = opts["max_retries"]
        if max_retries is None:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            max_retries = GLOBAL_CONFIG.task_max_retries
        return func, max_retries

    def map_remote(self, args_list) -> list:
        """Vectorized submission: one task per args tuple, returning a
        ref per task (num_returns==1 shape). Equivalent to
        ``[f.remote(*a) for a in args_list]`` with the per-task
        submit bookkeeping amortized into per-batch lock holds and a
        single scheduler wakeup — the task-path analog of the
        scheduler's batched lease grants. Falls back to the one-at-a-
        time path for options the fast path doesn't cover (placement
        groups, runtime envs, generators, num_returns != 1)."""
        worker = worker_mod.get_worker()
        opts = self._options
        fast = (self._fast and opts["num_returns"] == 1
                and not self._is_generator
                and getattr(worker, "submit_task_batch", None) is not None)
        if fast:
            from ray_tpu_torch.util.placement_group import _current_pg
            fast = _current_pg.get() is None
        if not fast:
            return [self._remote(tuple(a), {}, opts) for a in args_list]
        func, max_retries = self._fast_setup(worker, opts)
        name = opts["name"] or self._name
        retry_exceptions = opts["retry_exceptions"]
        next_task_id = worker.next_task_id
        specs = [TaskSpec(
            task_id=next_task_id(),
            name=name,
            func=func,
            func_descriptor=self._descriptor,
            args=tuple(a),
            kwargs={},
            num_returns=1,
            resources=self._resources,
            max_retries=max_retries,
            retry_exceptions=retry_exceptions,
            timeout_s=opts["timeout_s"],
            serialized_func=self._fn_blob,
            func_id=self._fn_id,
            class_key=self._class_key,
            priority=opts["priority"],
            tenant=opts["tenant"] or "default",
        ) for a in args_list]
        return [refs[0] for refs in worker.submit_task_batch(specs)]

    def _remote(self, args, kwargs, opts):
        worker = worker_mod.get_worker()
        if opts is self._options and self._fast:
            from ray_tpu_torch.util.placement_group import _current_pg
            if _current_pg.get() is None:
                func, max_retries = self._fast_setup(worker, opts)
                num_returns = opts["num_returns"]
                spec = TaskSpec(
                    task_id=worker.next_task_id(),
                    name=opts["name"] or self._name,
                    func=func,
                    func_descriptor=self._descriptor,
                    args=args,
                    kwargs=kwargs,
                    num_returns=num_returns,
                    resources=self._resources,
                    max_retries=max_retries,
                    retry_exceptions=opts["retry_exceptions"],
                    timeout_s=opts["timeout_s"],
                    serialized_func=self._fn_blob,
                    func_id=self._fn_id,
                    class_key=self._class_key,
                    priority=opts["priority"],
                    tenant=opts["tenant"] or "default",
                )
                refs = worker.submit_task(spec)
                return refs[0] if num_returns == 1 else refs
        num_returns = opts["num_returns"]
        generator = self._is_generator or num_returns in ("dynamic", "streaming")
        if generator and isinstance(num_returns, str):
            num_returns = 1
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        max_retries = opts["max_retries"]
        if max_retries is None:
            max_retries = GLOBAL_CONFIG.task_max_retries

        pg = opts["placement_group"]
        pg_id = None
        bundle_index = opts["placement_group_bundle_index"]
        strategy = opts["scheduling_strategy"]
        capture = False
        if strategy is not None and hasattr(strategy, "placement_group"):
            pg = strategy.placement_group
            bundle_index = getattr(strategy, "placement_group_bundle_index", -1)
            capture = getattr(strategy,
                              "placement_group_capture_child_tasks", False)
        if pg is None and strategy is None:
            # inside a capture_child_tasks task: children inherit the group
            from ray_tpu_torch.util.placement_group import _current_pg
            inherited = _current_pg.get()
            if inherited is not None:
                pg, capture = inherited, True
        if pg is not None:
            pg_id = pg.id if hasattr(pg, "id") else pg
            _validate_bundle_fit(worker, pg_id, bundle_index,
                                 _build_resources(opts))
        _validate_runtime_env(opts["runtime_env"])

        func = self._exec_func
        if func is None:
            func = self._function
            if generator:
                func = _collect_generator(func)
            self._exec_func = func
        if self._fn_blob is None and worker.needs_serialized_funcs:
            import hashlib

            import cloudpickle
            self._fn_blob = cloudpickle.dumps(func)
            self._fn_id = hashlib.sha1(self._fn_blob).digest()

        spec = TaskSpec(
            task_id=worker.next_task_id(),
            name=opts["name"] or self._name,
            func=func,
            func_descriptor=f"{self._module}.{self._name}",
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
            resources=_build_resources(opts),
            max_retries=max_retries,
            retry_exceptions=opts["retry_exceptions"],
            timeout_s=opts["timeout_s"],
            task_type=TaskType.NORMAL_TASK,
            scheduling_strategy=strategy,
            placement_group_id=pg_id,
            placement_group_bundle_index=bundle_index,
            placement_group_capture_child_tasks=capture,
            runtime_env=opts["runtime_env"],
            serialized_func=self._fn_blob,
            func_id=self._fn_id,
            generator=generator,
            # the precomputed key only describes the no-group case; an
            # inherited/explicit placement group changes the class
            class_key=self._class_key if pg_id is None else None,
            priority=opts["priority"],
            tenant=opts["tenant"] or "default",
        )
        refs = worker.submit_task(spec)
        return refs[0] if spec.num_returns == 1 else refs


def _validate_runtime_env(runtime_env) -> None:
    """Supported: env_vars (both worker modes), working_dir (zipped,
    content-addressed per-node cache), pip (venv per spec; LOCAL
    wheel/dir requirements only — this environment has no network
    egress). Reference: the per-node runtime env agent,
    ray: python/ray/_private/runtime_env/. Unsupported keys raise
    instead of being silently dropped."""
    if not runtime_env:
        return
    supported = {"env_vars", "working_dir", "pip", "working_dir_pkg"}
    extra = set(runtime_env) - supported
    if extra:
        raise NotImplementedError(
            f"runtime_env keys {sorted(extra)} are not supported "
            f"(supported: {sorted(supported - {'working_dir_pkg'})})")
    env_vars = runtime_env.get("env_vars") or {}
    if not isinstance(env_vars, dict) or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in env_vars.items()):
        raise TypeError("runtime_env['env_vars'] must be a "
                        "str -> str dict")
    wd = runtime_env.get("working_dir")
    if wd is not None and not isinstance(wd, str):
        raise TypeError("runtime_env['working_dir'] must be a path str")
    pip = runtime_env.get("pip")
    if pip is not None and not (isinstance(pip, list) and all(
            isinstance(p, str) for p in pip)):
        raise TypeError("runtime_env['pip'] must be a list of "
                        "requirement strings (local paths here)")


def _validate_bundle_fit(worker, pg_id, bundle_index, resources) -> None:
    """Reject tasks whose demand can never fit their target bundle(s) —
    otherwise they would wait forever (reference raises the same way,
    ray: python/ray/util/placement_group.py check_placement_group_index +
    resource validation)."""
    manager = getattr(worker, "placement_groups", None)
    if manager is None:
        return  # worker-process shim: the owner validates at admission
    entry = manager.get(pg_id)
    if entry is None:
        return
    if entry.state in ("REMOVED", "INFEASIBLE"):
        raise ValueError(
            f"placement group {pg_id.hex()[:16]} is {entry.state} and "
            "cannot accept tasks")
    import numpy as np

    from ray_tpu_torch._private.task_spec import resources_to_vector

    demand = np.asarray(resources_to_vector(resources), dtype=np.float32)
    bundles = entry.demands
    if bundle_index >= 0:
        if bundle_index >= len(bundles):
            raise ValueError(
                f"bundle index {bundle_index} out of range: placement "
                f"group has {len(bundles)} bundles")
        ok = bool((bundles[bundle_index] >= demand).all())
    else:
        ok = bool((bundles >= demand[None, :]).all(axis=1).any())
    if not ok:
        raise ValueError(
            f"task demand {resources} cannot fit "
            f"{'bundle %d' % bundle_index if bundle_index >= 0 else 'any bundle'}"
            f" of placement group {pg_id.hex()[:16]} "
            f"(bundles: {entry.bundles})")


def _collect_generator(func):
    @functools.wraps(func)
    def wrapper(*a, **k):
        return list(func(*a, **k))
    return wrapper


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=2)`` for functions and classes."""
    from ray_tpu_torch.actor import ActorClass

    def decorate(obj, options=None):
        if inspect.isclass(obj):
            return ActorClass(obj, options or {})
        if not callable(obj):
            raise TypeError("@remote requires a function or class")
        return RemoteFunction(obj, options)

    if len(args) == 1 and not kwargs and callable(args[0]):
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. "
                        "@remote(num_cpus=2)")
    if "num_tpus" in kwargs:
        kwargs["num_gpus"] = kwargs.pop("num_tpus")
    return lambda obj: decorate(obj, kwargs)

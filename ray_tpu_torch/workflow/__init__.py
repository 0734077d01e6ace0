"""ray_tpu_torch.workflow — durable workflows with journaled steps.

Counterpart of ``ray_tpu/workflow/__init__.py``, copied onto the port's
task layer (steps are ``ray_tpu_torch`` tasks; retries ride its
``max_retries``). Reference surface: Ray Workflow (ray: python/ray/workflow/ — a DAG of
steps whose results are journaled to storage per step; re-running a
workflow id resumes from the journal, re-executing only what never
completed). API kept in the classic step shape:

    @workflow.step
    def add(a, b): return a + b

    out = add.step(add.step(1, 2), 4).run(workflow_id="w1")

Steps execute as framework tasks; every step result is pickled to
<storage>/<workflow_id>/<step_key>. Step keys are deterministic
positions in the DAG (function name + path), so resume matches steps
structurally.

Beyond the core (reference parity):
- ``.options(max_retries=, catch_exceptions=)`` per step — retries ride
  the task layer's retry machinery; catch_exceptions makes the step
  yield ``(result, None)`` / ``(None, exception)``.
- CONTINUATIONS: a step may RETURN another step node, which executes
  in its place (reference: workflow.continuation — dynamic workflows).
- The DAG itself is journaled at run start, so
  ``workflow.resume(workflow_id)`` needs no node object and
  ``workflow.resume_all()`` restarts every non-succeeded workflow
  after a crash. ``get_status``/``list_all``/``get_output`` read the
  journal; failures are journaled as FAILED with the error.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import ray_tpu_torch

_storage_lock = threading.Lock()
_storage_root: Optional[str] = None


def init(storage: Optional[str] = None) -> None:
    """Set the journal root (default: a temp dir per process)."""
    global _storage_root
    with _storage_lock:
        _storage_root = storage or tempfile.mkdtemp(
            prefix="ray_tpu_torch_workflow_")
        os.makedirs(_storage_root, exist_ok=True)


def storage_root() -> str:
    with _storage_lock:
        if _storage_root is None:
            init()
        return _storage_root  # type: ignore[return-value]


class _StepNode:
    """One node of the workflow DAG (unexecuted)."""

    def __init__(self, fn: Callable, args, kwargs,
                 max_retries: Optional[int] = None,
                 catch_exceptions: bool = False):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        # None = the task layer's default; 0 explicitly DISABLES
        # retries (a non-idempotent step must be able to opt out)
        self.max_retries = max_retries
        self.catch_exceptions = catch_exceptions

    def options(self, *, max_retries: Optional[int] = None,
                catch_exceptions: Optional[bool] = None) -> "_StepNode":
        """Per-step execution options (reference: step .options())."""
        return _StepNode(
            self.fn, self.args, self.kwargs,
            self.max_retries if max_retries is None else max_retries,
            self.catch_exceptions if catch_exceptions is None
            else catch_exceptions)

    # -- execution ----------------------------------------------------
    def run(self, workflow_id: str,
            storage: Optional[str] = None) -> Any:
        """Execute (or resume) the workflow rooted at this step."""
        import cloudpickle

        root = storage or storage_root()
        wf_dir = os.path.join(root, workflow_id)
        os.makedirs(wf_dir, exist_ok=True)
        # journal the DAG itself so resume()/resume_all() can re-run
        # this workflow without the caller re-building the node —
        # refreshed when it changes, so a re-run with a corrected node
        # replaces the stale (possibly broken) one. An unpicklable arg
        # degrades to no-resume-by-id, never to a failed run.
        try:
            blob = cloudpickle.dumps(self)
        except Exception:  # noqa: BLE001
            blob = None
        if blob is not None:
            prior = _journal_read(wf_dir, "__dag__")
            if prior is None or prior.get("node") != blob:
                _journal_write(wf_dir, "__dag__", {"node": blob})
        _journal_write(wf_dir, "__status__", {"status": "RUNNING"})
        # a stale output from a PREVIOUS successful run must not
        # masquerade as this run's result if this run fails
        try:
            os.remove(os.path.join(wf_dir, "__output__.step"))
        except FileNotFoundError:
            pass
        executed: Dict[str, int] = {"fresh": 0, "cached": 0}
        try:
            result = self._execute(wf_dir, "root", executed)
        except BaseException as e:
            _journal_write(wf_dir, "__status__",
                           {"status": "FAILED", "error": repr(e),
                            "fresh_steps": executed["fresh"],
                            "cached_steps": executed["cached"]})
            raise
        _journal_write(wf_dir, "__output__", {"result": result})
        _journal_write(wf_dir, "__status__",
                       {"status": "SUCCEEDED",
                        "fresh_steps": executed["fresh"],
                        "cached_steps": executed["cached"]})
        return result

    def _execute(self, wf_dir: str, path: str, executed) -> Any:
        key = f"{path}.{self.fn.__name__}"
        cached = _journal_read(wf_dir, key)
        if cached is not None:
            executed["cached"] += 1
            return cached["result"]
        # resolve child steps first (post-order DAG walk)
        args = [a._execute(wf_dir, f"{path}.{i}", executed)
                if isinstance(a, _StepNode) else a
                for i, a in enumerate(self.args)]
        kwargs = {k: (v._execute(wf_dir, f"{path}.{k}", executed)
                      if isinstance(v, _StepNode) else v)
                  for k, v in self.kwargs.items()}
        # a journaled step BODY (the fn ran but its continuation
        # didn't finish before a crash) must not re-run — its side
        # effects already happened
        body = _journal_read(wf_dir, f"{key}#body")
        if body is not None:
            import cloudpickle

            result: Any = cloudpickle.loads(body["node"])
        else:
            remote_fn = ray_tpu_torch.remote(self.fn)
            if self.max_retries is not None:
                remote_fn = remote_fn.options(
                    max_retries=self.max_retries,
                    retry_exceptions=self.max_retries > 0)
            try:
                result = ray_tpu_torch.get(remote_fn.remote(*args, **kwargs))
            except Exception as e:  # noqa: BLE001
                if not self.catch_exceptions:
                    raise
                value: Tuple[Any, Any] = (None, e)
                _journal_write(wf_dir, key, {"result": value})
                executed["fresh"] += 1
                return value
            executed["fresh"] += 1
            if isinstance(result, _StepNode):
                # journal the body's outcome (the continuation node)
                # BEFORE descending: a crash inside the continuation
                # must not re-run THIS step's side effects on resume
                import cloudpickle

                _journal_write(wf_dir, f"{key}#body",
                               {"node": cloudpickle.dumps(result)})
        # CONTINUATION: a step that returns a step node hands the
        # workflow off to it (dynamic workflows). The continuation's
        # sub-steps journal under this step's path, and the RESOLVED
        # value is journaled as this step's result — a resume replays
        # the final value without re-descending. Errors inside the
        # continuation belong to ITS steps' options, not this one's.
        # (one hop suffices: _execute returns fully resolved values,
        # so a chain of continuations drains inside the recursion)
        if isinstance(result, _StepNode):
            result = result._execute(wf_dir, f"{path}.cont1", executed)
        if self.catch_exceptions:
            result = (result, None)
        _journal_write(wf_dir, key, {"result": result})
        return result


class _Step:
    """@workflow.step wrapper: .step(...) builds a DAG node."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def step(self, *args, **kwargs) -> _StepNode:
        return _StepNode(self.fn, args, kwargs)

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def step(fn: Callable) -> _Step:
    return _Step(fn)


def resume(workflow_id: str, node: Optional[_StepNode] = None,
           storage: Optional[str] = None) -> Any:
    """Resume a workflow. With ``node=None`` the journaled DAG is
    loaded (reference: workflow.resume(workflow_id)); passing the node
    explicitly also works (the journal makes it idempotent)."""
    if node is None:
        import cloudpickle

        wf_dir = os.path.join(storage or storage_root(), workflow_id)
        rec = _journal_read(wf_dir, "__dag__")
        if rec is None:
            raise ValueError(
                f"no journaled DAG for workflow {workflow_id!r}")
        node = cloudpickle.loads(rec["node"])
    return node.run(workflow_id, storage)


def resume_all(storage: Optional[str] = None) -> Dict[str, Any]:
    """Re-run every workflow whose journal is not SUCCEEDED
    (reference: workflow.resume_all after a crash). Returns
    {workflow_id: result} for the ones that now succeed; one still-
    broken workflow must not gate the rest — it stays FAILED in the
    journal (query get_status) and the loop continues."""
    out: Dict[str, Any] = {}
    for wf_id, status in list_all(storage):
        if status == "SUCCEEDED":
            continue
        try:
            out[wf_id] = resume(wf_id, storage=storage)
        except Exception:  # noqa: BLE001
            continue  # journaled as FAILED (or has no DAG to replay)
    return out


def list_all(storage: Optional[str] = None) -> List[Tuple[str, str]]:
    """[(workflow_id, status)] for every journaled workflow."""
    root = storage or storage_root()
    out: List[Tuple[str, str]] = []
    if not os.path.isdir(root):
        return out
    for wf_id in sorted(os.listdir(root)):
        wf_dir = os.path.join(root, wf_id)
        if not os.path.isdir(wf_dir):
            continue
        rec = _journal_read(wf_dir, "__status__")
        out.append((wf_id, rec["status"] if rec else "UNKNOWN"))
    return out


def get_output(workflow_id: str,
               storage: Optional[str] = None) -> Any:
    """The finished workflow's root result, from the journal (only
    meaningful once the status is SUCCEEDED — run() clears any prior
    output when a new run starts)."""
    wf_dir = os.path.join(storage or storage_root(), workflow_id)
    rec = _journal_read(wf_dir, "__output__")
    if rec is None:
        raise ValueError(
            f"workflow {workflow_id!r} has no journaled output "
            "(not run here, not finished, or its latest run failed)")
    return rec["result"]


def get_status(workflow_id: str,
               storage: Optional[str] = None) -> Optional[dict]:
    wf_dir = os.path.join(storage or storage_root(), workflow_id)
    return _journal_read(wf_dir, "__status__")


def list_steps(workflow_id: str,
               storage: Optional[str] = None) -> List[str]:
    wf_dir = os.path.join(storage or storage_root(), workflow_id)
    if not os.path.isdir(wf_dir):
        return []
    return sorted(
        f[:-len(".step")] for f in os.listdir(wf_dir)
        if f.endswith(".step")
        and not f.startswith("__")      # internal records
        and "#body" not in f)           # continuation bodies


# -- journal ------------------------------------------------------------

def _journal_write(wf_dir: str, key: str, value: dict) -> None:
    path = os.path.join(wf_dir, f"{key}.step")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(value, f)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn journal


def _journal_read(wf_dir: str, key: str) -> Optional[dict]:
    path = os.path.join(wf_dir, f"{key}.step")
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (FileNotFoundError, EOFError, pickle.UnpicklingError):
        return None

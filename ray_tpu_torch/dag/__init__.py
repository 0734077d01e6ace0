"""ray_tpu_torch.dag — compiled graphs (the aDAG analog).

Counterpart of ``ray_tpu/dag/__init__.py`` (reference surface: Ray compiled
graphs, python/ray/dag/ — ``recv.bind(inp)`` DAG nodes and
``experimental_compile()``). ``dag.execute(x)`` runs the graph through the
normal task and actor path, one ``.remote`` a node with refs between them.
A compiled graph runs the node chain with VALUES passed directly between
stages: no per-call scheduling and no object-store round trips. Actor
method nodes run on their actor's call path, their results forwarded by
value.

What "fused" means here. The reference fuses an all-function graph into one
``jax.jit`` program, so activations stay in the device's memory between
stages. The port captures the composed function chain in one
``torch.cuda.CUDAGraph`` per input signature (shapes, dtypes, device) and
replays it: one launch of the whole recorded kernel sequence, static
buffers between the stages. ``experimental_compile(fuse_jit=...)`` keeps
the reference's knob:

  - ``"auto"``: fuse when every node is a function node and every input
    of this ``execute`` is a CUDA tensor. It decides before anything runs;
    a CPU input or an actor node takes the direct path.
  - ``"always"``: the same rule, but a graph or an input that cannot fuse
    raises ``ValueError``.
  - ``"never"``: the direct path.

The first execute of a signature runs the chain once eagerly on a side
stream (the warm-up builds cuBLAS handles and loads kernel libraries, which
must not happen inside a capture), captures it with
``capture_error_mode="thread_local"`` (other threads keep launching), then
replays it; later executes of the signature copy their inputs into the
static input buffers and replay. Each execute returns clones of the static
outputs, which must all be CUDA tensors. A node that cannot be captured
(one that syncs the host, for instance ``.item()``) raises
``DAGCaptureError`` naming the node; the reference falls back to the direct
path silently there, the port does not. Work another thread launches on
the legacy default stream while a capture is in progress invalidates that
capture (CUDA orders the legacy stream against every blocking stream), and
it then fails with ``DAGCaptureError``.

Replays launch no kernel through a wrapper: the kernels' ``launches``
counters count the warm-up and the capture of a signature, and nothing for
its replays.

    with InputNode() as inp:
        dag = postprocess.bind(forward.bind(preprocess.bind(inp)))
    compiled = dag.experimental_compile()
    out = compiled.execute(x)      # a CUDA-graph replay for CUDA x
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

import torch
from torch.utils import _pytree as pytree

import ray_tpu_torch

FUSE_MODES = ("auto", "always", "never")


class DAGCaptureError(RuntimeError):
    """A node of a fused graph could not be captured in a CUDA graph."""


class DAGNode:
    def __init__(self):
        self._args: tuple = ()
        self._kwargs: dict = {}

    # -- interpreted execution (refs through the normal task path) ----
    def execute(self, *input_values) -> Any:
        """Run the graph through the NORMAL task/actor path (one
        .remote per node; refs flow between nodes)."""
        ref = self._execute_remote(_bind_input(self, input_values))
        return ray_tpu_torch.get(ref)

    def experimental_compile(self, fuse_jit: str = "auto"
                             ) -> "CompiledDAG":
        """Build the fast path. fuse_jit: 'auto' captures an all-function
        graph over CUDA inputs in a CUDA graph, 'always' requires it,
        'never' skips it (the module docstring has the rule)."""
        return CompiledDAG(self, fuse_jit)

    @property
    def name(self) -> str:
        return type(self).__name__

    # internals ---------------------------------------------------------
    def _execute_remote(self, bindings) -> Any:
        raise NotImplementedError

    def _call_direct(self, bindings) -> Any:
        raise NotImplementedError

    def _resolve_args(self, bindings, via: str):
        """Diamond-safe: a node consumed by several downstream nodes
        executes ONCE per graph execution (results memoized in the
        bindings map, keyed by node identity)."""
        args = []
        for a in self._args:
            if isinstance(a, DAGNode):
                key = id(a)
                if key not in bindings:
                    bindings[key] = (a._execute_remote(bindings)
                                     if via == "remote"
                                     else a._call_direct(bindings))
                args.append(bindings[key])
            else:
                args.append(a)
        return args


class InputNode(DAGNode):
    """Placeholder for the graph input (context-manager form mirrors
    the reference API; plain construction works too)."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def _execute_remote(self, bindings):
        return bindings[id(self)]

    def _call_direct(self, bindings):
        return bindings[id(self)]


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__()
        self._remote_fn = remote_fn
        self._args = args
        self._kwargs = kwargs

    @property
    def func(self):
        return self._remote_fn._function

    @property
    def name(self) -> str:
        return getattr(self.func, "__qualname__", repr(self.func))

    def _execute_remote(self, bindings):
        args = self._resolve_args(bindings, "remote")
        return self._remote_fn.remote(*args, **self._kwargs)

    def _call_direct(self, bindings):
        args = self._resolve_args(bindings, "direct")
        return self.func(*args, **self._kwargs)


class ActorMethodNode(DAGNode):
    def __init__(self, actor_method, args, kwargs):
        super().__init__()
        self._method = actor_method
        self._args = args
        self._kwargs = kwargs

    @property
    def name(self) -> str:
        return self._method._method_name

    def _execute_remote(self, bindings):
        args = self._resolve_args(bindings, "remote")
        return self._method.remote(*args, **self._kwargs)

    def _call_direct(self, bindings):
        # direct path: resolve args by value, ONE actor call, get by
        # value (the channel analog — no intermediate store entries)
        args = self._resolve_args(bindings, "direct")
        return ray_tpu_torch.get(self._method.remote(*args, **self._kwargs))


class MultiOutputNode(DAGNode):
    """Multiple graph outputs (reference: ray.dag.MultiOutputNode):
    execute() returns a list, one value per bound output node."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__()
        self._args = tuple(outputs)

    def _execute_remote(self, bindings):
        return self._resolve_args(bindings, "remote")

    def _call_direct(self, bindings):
        return self._resolve_args(bindings, "direct")

    # interpreted path: resolve each output ref
    def execute(self, *input_values) -> List[Any]:
        refs = self._execute_remote(_bind_input(self, input_values))
        return [ray_tpu_torch.get(r) if _is_ref(r) else r for r in refs]


def _is_ref(x) -> bool:
    from ray_tpu_torch import ObjectRef

    return isinstance(x, ObjectRef)


def _post_order(root: DAGNode) -> List[DAGNode]:
    """Every node once, each after the nodes it reads."""
    order: List[DAGNode] = []
    seen = set()

    def walk(node: DAGNode):
        if id(node) in seen:
            return
        seen.add(id(node))
        for a in node._args:
            if isinstance(a, DAGNode):
                walk(a)
        order.append(node)

    walk(root)
    return order


def _bind_input(root: DAGNode, input_values) -> Dict[int, Any]:
    inputs = [n for n in _post_order(root) if isinstance(n, InputNode)]
    if len(inputs) != len(input_values):
        raise ValueError(f"graph has {len(inputs)} InputNode(s), got "
                         f"{len(input_values)} values")
    return {id(n): v for n, v in zip(inputs, input_values)}


class _Captured:
    """One input signature's CUDA graph and its static buffers."""

    def __init__(self, graph, static_in, static_out, done):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.done = done   # recorded after each execute's output clones


class CompiledDAG:
    """The fast path: values flow directly between nodes; an all-function
    graph over CUDA inputs replays one CUDA graph per input signature."""

    def __init__(self, root: DAGNode, fuse_jit: str):
        if fuse_jit not in FUSE_MODES:
            raise ValueError(f"fuse_jit must be one of {FUSE_MODES}, got "
                             f"{fuse_jit!r}")
        self._root = root
        self._mode = fuse_jit
        self._lock = threading.Lock()
        self._graphs: Dict[tuple, _Captured] = {}
        self._order = _post_order(root)
        self._pure = not any(isinstance(n, ActorMethodNode)
                             for n in self._order)
        if fuse_jit == "always" and not self._pure:
            raise ValueError(
                "fuse_jit='always' needs an all-function graph "
                "(actor methods cannot fuse into one CUDA graph)")

    def fuses(self, input_values) -> bool:
        """Whether ``execute(*input_values)`` replays a CUDA graph, decided
        from the graph and the inputs alone, before anything runs."""
        if self._mode == "never" or not self._pure:
            return False
        on_card = bool(input_values) and all(
            isinstance(v, torch.Tensor) and v.is_cuda for v in input_values)
        if not on_card and self._mode == "always":
            got = [str(v.device) if isinstance(v, torch.Tensor)
                   else type(v).__name__ for v in input_values]
            raise ValueError("fuse_jit='always' needs every input to be a "
                             f"CUDA tensor (got {got})")
        return on_card

    def execute(self, *input_values) -> Any:
        if self.fuses(input_values):
            return self._execute_fused(input_values)
        return self._root._call_direct(_bind_input(self._root, input_values))

    # -- the fused path ----------------------------------------------------
    def _run(self, inputs, capturing: bool):
        bindings = _bind_input(self._root, inputs)
        for node in self._order:
            if id(node) in bindings:
                continue
            try:
                bindings[id(node)] = node._call_direct(bindings)
            except Exception as e:  # noqa: BLE001 - re-raised with the node
                if not capturing:
                    raise
                raise DAGCaptureError(
                    f"node {node.name!r} cannot be captured in a CUDA graph "
                    f"({type(e).__name__}: {e}); a fused node must launch "
                    "its work on the current stream without syncing the "
                    "host. Compile with fuse_jit='never' to run it "
                    "directly") from e
        return bindings[id(self._root)]

    def _capture(self, inputs) -> _Captured:
        dev = inputs[0].device
        caller = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            static_in = [v.clone() for v in inputs]
            # warm-up: first uses (cuBLAS handles, kernel libraries) must
            # not happen inside the capture
            self._run(static_in, capturing=False)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                static_out = self._run(static_in, capturing=True)
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:  # noqa: BLE001 - the capture is void
                    pass
                raise
            graph.capture_end()
        caller.wait_stream(side)
        leaves = pytree.tree_leaves(static_out)
        bad = [type(x).__name__ for x in leaves
               if not (isinstance(x, torch.Tensor) and x.is_cuda)]
        if bad or not leaves:
            raise DAGCaptureError(
                f"node {self._root.name!r}: a fused graph's outputs must be "
                f"CUDA tensors (got {bad or 'none'}); compile with "
                "fuse_jit='never' for other outputs")
        return _Captured(graph, static_in, static_out, torch.cuda.Event())

    def _execute_fused(self, inputs) -> Any:
        key = tuple((tuple(v.shape), v.dtype, v.device) for v in inputs)
        with self._lock:
            cap = self._graphs.get(key)
            if cap is None:
                cap = self._graphs[key] = self._capture(inputs)
            stream = torch.cuda.current_stream(inputs[0].device)
            # the previous execute's clones were made on its own stream
            stream.wait_event(cap.done)
            for buf, v in zip(cap.static_in, inputs):
                buf.copy_(v)
            cap.graph.replay()
            out = pytree.tree_map(lambda t: t.clone(), cap.static_out)
            cap.done.record(stream)
            return out


def bind_function(remote_fn, *args, **kwargs) -> FunctionNode:
    """``remote_fn.bind(*args, **kwargs)`` as a function."""
    return FunctionNode(remote_fn, args, kwargs)


def bind_method(actor_method, *args, **kwargs) -> ActorMethodNode:
    """``actor_method.bind(*args, **kwargs)`` as a function."""
    return ActorMethodNode(actor_method, args, kwargs)


__all__ = ["InputNode", "FunctionNode", "ActorMethodNode", "MultiOutputNode",
           "CompiledDAG", "DAGCaptureError", "DAGNode", "bind_function",
           "bind_method"]

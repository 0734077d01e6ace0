"""Pass 7 — closure-capture hygiene for remote task definitions.

Everything a ``@remote`` function closes over crosses
serialization.py BY VALUE on every submission (cloudpickle walks the
closure cells). Four capture shapes are flagged, all on remote defs
NESTED inside another function/method (top-level remote functions only
close over module globals, which pickle by reference):

- **self-capture**: the task body references ``self`` from an
  enclosing method — the whole instance (locks, sockets, caches and
  all) ships with every submission, and usually fails to pickle only
  in production, not in the unit test.
- **resource-capture**: a free variable bound in the enclosing scope
  to a lock/condition, ``open(...)`` handle, socket, or thread —
  process-local kernel state that is meaningless (or unpicklable) on
  the other side.
- **array-capture**: a free variable bound to a numpy/jax array
  constructor in the enclosing scope — the array is re-serialized into
  every task instead of being ``put()`` once and passed as a ref.
- **module-capture**: a free variable bound by a function-local
  ``import`` in the enclosing scope — cloudpickle serializes the
  module object itself rather than a by-reference stub.

A remote def is one decorated ``@remote`` / ``@ray_tpu_torch.remote`` (with
or without options), or a nested def later passed to ``remote(...)``.
Free variables are loads not bound by the def's own params,
assignments, or imports.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.analysis._astutil import (
    iter_py_files, module_name, parse_file)

PASS = "closure_capture"

#: constructor attrs whose result is kernel/process-local state
_RESOURCE_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                       "BoundedSemaphore", "Event", "Thread", "socket",
                       "open", "Popen"}
#: attrs that build a (potentially large) array value
_ARRAY_FACTORIES = {"zeros", "ones", "empty", "full", "arange",
                    "linspace", "eye", "array", "asarray", "rand",
                    "randn", "random", "normal", "uniform"}


def _walk_local(fn: ast.AST):
    """ast.walk constrained to ``fn``'s own scope — nested defs are
    separate scopes (and are visited via _scopes on their own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _call_name(node: ast.AST) -> Optional[str]:
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _is_remote_decorated(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        d = dec.func if isinstance(dec, ast.Call) else dec
        name = d.attr if isinstance(d, ast.Attribute) else (
            d.id if isinstance(d, ast.Name) else None)
        if name == "remote":
            return True
    return False


def _bound_names(fn: ast.FunctionDef) -> Set[str]:
    """Names the function binds itself: params, assignments, imports,
    comprehension targets, nested defs, for-targets, with-as."""
    bound: Set[str] = set()
    a = fn.args
    for arg in (list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)):
        bound.add(arg.arg)
    if a.vararg:
        bound.add(a.vararg.arg)
    if a.kwarg:
        bound.add(a.kwarg.arg)
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
            bound.add(sub.id)
        elif isinstance(sub, (ast.Import, ast.ImportFrom)):
            for alias in sub.names:
                bound.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and sub is not fn:
            bound.add(sub.name)
    return bound


def _free_vars(fn: ast.FunctionDef) -> Dict[str, int]:
    """Loaded names not bound by the def itself: name -> first line.

    Only the BODY is walked: decorators, annotations and defaults
    evaluate in the enclosing scope at def time — ``@ray_tpu_torch.remote``
    itself is not a closure capture."""
    bound = _bound_names(fn)
    free: Dict[str, int] = {}
    for stmt in fn.body:
        for sub in ast.walk(stmt):
            if (isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load)
                    and sub.id not in bound):
                free.setdefault(sub.id, sub.lineno)
    return free


class _EnclosingScope:
    """What the enclosing function binds each local name to."""

    def __init__(self, fn: ast.FunctionDef, is_method: bool):
        self.is_method = is_method
        #: name -> "resource" | "array" | "module"
        self.kinds: Dict[str, str] = {}
        for sub in _walk_local(fn):
            if isinstance(sub, ast.Assign):
                kind = self._value_kind(sub.value)
                if kind:
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Name):
                            self.kinds[tgt.id] = kind
            elif isinstance(sub, (ast.Import, ast.ImportFrom)):
                if isinstance(sub, ast.Import):
                    for alias in sub.names:
                        self.kinds[(alias.asname
                                    or alias.name).split(".")[0]] = "module"

    @staticmethod
    def _value_kind(value: ast.AST) -> Optional[str]:
        name = _call_name(value)
        if name in _RESOURCE_FACTORIES:
            return "resource"
        if name in _ARRAY_FACTORIES:
            return "array"
        return None


def _remote_defs_in(fn: ast.FunctionDef) -> List[ast.FunctionDef]:
    """Nested defs submitted remotely: decorated, or passed to remote()."""
    nested = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested.append(node)
            continue  # deeper defs belong to THIS nested def's scope
        if isinstance(node, ast.ClassDef):
            continue
        stack.extend(ast.iter_child_nodes(node))
    out = [n for n in nested if _is_remote_decorated(n)]
    wrapped: Set[str] = set()
    for sub in _walk_local(fn):
        if isinstance(sub, ast.Call) and _call_name(sub) == "remote":
            for a in sub.args:
                if isinstance(a, ast.Name):
                    wrapped.add(a.id)
    out.extend(n for n in nested
               if n.name in wrapped and not _is_remote_decorated(n))
    return out


def _scopes(tree: ast.Module):
    """Yield (qualname, fn, is_method) for every function with nesting
    context, so a remote def's ENCLOSING scope is known."""
    def walk(node, prefix, in_class):
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}.{sub.name}" if prefix else sub.name
                yield q, sub, in_class
                yield from walk(sub, q, False)
            elif isinstance(sub, ast.ClassDef):
                q = f"{prefix}.{sub.name}" if prefix else sub.name
                yield from walk(sub, q, True)
            else:
                yield from walk(sub, prefix, in_class)
    yield from walk(tree, "", False)


def analyze(root: str, make_finding) -> List:
    findings = []
    for rel, ap in iter_py_files(root):
        tree = parse_file(ap)
        if tree is None:
            continue
        mod = module_name(rel)
        for qual, fn, is_method in _scopes(tree):
            remote_defs = _remote_defs_in(fn)
            if not remote_defs:
                continue
            scope = _EnclosingScope(fn, is_method)
            for rdef in remote_defs:
                findings.extend(_check_remote_def(
                    mod, qual, rdef, scope, rel, make_finding))
    return findings


def _check_remote_def(mod: str, encl_qual: str, rdef: ast.FunctionDef,
                      scope: _EnclosingScope, rel: str,
                      make_finding) -> List:
    out = []
    free = _free_vars(rdef)
    subject = f"{mod}.{encl_qual}.{rdef.name}"
    if scope.is_method and "self" in free:
        out.append(make_finding(
            f"{PASS}:self-capture:{subject}",
            f"remote task {subject} captures 'self' from the enclosing "
            f"method — the whole instance is serialized into every "
            f"submission", rel, free["self"]))
    # defaults cross serialization exactly like closure cells do
    for default in rdef.args.defaults + [
            d for d in rdef.args.kw_defaults if d is not None]:
        for n in ast.walk(default):
            if isinstance(n, ast.Name):
                free.setdefault(n.id, n.lineno)
    for name, line in sorted(free.items()):
        kind = scope.kinds.get(name)
        if kind is None:
            continue
        noun = {"resource": "a process-local resource (lock/file/"
                            "socket/thread)",
                "array": "an array built in the enclosing scope",
                "module": "a function-locally imported module"}[kind]
        out.append(make_finding(
            f"{PASS}:{kind}-capture:{subject}:{name}",
            f"remote task {subject} captures '{name}' — {noun} — "
            f"which is serialized by value on every submission",
            rel, line))
    return out

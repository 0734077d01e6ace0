"""Pass 8 — blocking calls in no-block contexts.

Two kinds of code in this repo must never block indefinitely:

- **event-loop zones** — the single-threaded receive/dispatch loops
  that everything else is waiting BEHIND (``_ZONES`` below: the node
  daemon's command loop, both pool demux loops, the scheduler tick
  thread). A blocking get/result/acquire there wedges the whole plane,
  not one task.
- **actor methods** — methods of ``@remote`` classes. A blocking
  ``ray_tpu_torch.get`` inside an actor is the textbook distributed
  deadlock: the actor waits on a task that needs the actor's own slot
  (or its caller's) to run. Ray's own docs forbid it; async actors
  ``await`` instead.

Flagged shapes:

- **blocking-get**: ``ray_tpu_torch.get(...)`` / ``worker.get(...)`` /
  ``self._worker.get(...)`` with no ``timeout=`` argument.
- **blocking-result**: ``fut.result()`` with no timeout.
- **bare-acquire**: ``<lock-ish>.acquire()`` with neither
  ``timeout=`` nor ``blocking=False`` — invisible to the with-based
  lock-order pass and undiagnosable when it deadlocks.

``allow`` suppresses reviewed sites by finding key (deliberate
blocking with an out-of-band watchdog). ``with lock:`` statements are
NOT flagged — they are the lock_order pass's territory and most
zone bodies legitimately take their own short-hold locks.
"""

from __future__ import annotations

import ast
from typing import FrozenSet, List, Optional, Tuple

from ray_tpu_torch._private.analysis._astutil import (
    GET_RECEIVERS, find_function, iter_py_files, module_name, parse_file)

PASS = "blocking_calls"

#: (module, "Class.method") bodies that run on an event/demux loop
_ZONES: Tuple[Tuple[str, str], ...] = (
    ("_private.runtime.node_daemon", "NodeDaemon.run"),
    ("_private.runtime.remote_pool", "RemoteNodePool._demux_loop"),
    ("_private.runtime.process_pool", "ProcessWorkerPool._demux_loop"),
    ("_private.scheduler.tensor", "TensorScheduler._tick_loop"),
)

#: reviewed sites where blocking is deliberate (watchdogged elsewhere)
DEFAULT_ALLOW: FrozenSet[str] = frozenset()


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _base_chain(node: ast.AST) -> str:
    """'self._worker.get' -> 'self._worker' tail name for matching."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _blocking_get(call: ast.Call) -> bool:
    """A worker/driver get with no timeout: positional timeout counts
    as a timeout only when it is not the literal None."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "get"):
        return False
    if _base_chain(f.value) not in GET_RECEIVERS:
        return False
    to = _kw(call, "timeout")
    if to is None and len(call.args) >= 2:
        to = call.args[1]
    if to is None:
        return True
    return isinstance(to, ast.Constant) and to.value is None


def _blocking_result(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "result"
            and not call.args and _kw(call, "timeout") is None)


def _bare_acquire(call: ast.Call) -> Optional[str]:
    """Lock-ish name if the call is an unbounded ``.acquire()``."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "acquire"):
        return None
    base = _base_chain(f.value).lower()
    if not ("lock" in base or "cv" in base or "cond" in base
            or "sem" in base):
        return None
    if _kw(call, "timeout") is not None:
        return None
    b = _kw(call, "blocking")
    if b is not None and isinstance(b, ast.Constant) and b.value is False:
        return None
    if call.args:  # positional blocking=False
        a0 = call.args[0]
        if isinstance(a0, ast.Constant) and a0.value is False:
            return None
    return _base_chain(f.value)


def _scan_body(fn: ast.FunctionDef, subject: str, rel: str,
               make_finding, allow: FrozenSet[str]) -> List:
    out = []
    seen = set()
    for sub in ast.walk(fn):
        if not isinstance(sub, ast.Call):
            continue
        if _blocking_get(sub):
            key = f"{PASS}:blocking-get:{subject}"
        elif _blocking_result(sub):
            key = f"{PASS}:blocking-result:{subject}"
        else:
            lock = _bare_acquire(sub)
            if lock is None:
                continue
            key = f"{PASS}:bare-acquire:{subject}:{lock}"
        if key in allow or key in seen:
            continue
        seen.add(key)
        shape = key.split(":")[1]
        out.append(make_finding(
            key,
            f"{subject} makes a {shape.replace('-', ' ')} call with no "
            f"timeout in a no-block context (event-loop zone or actor "
            f"method)", rel, sub.lineno))
    return out


def _remote_classes(tree: ast.Module) -> List[ast.ClassDef]:
    out = []
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        for dec in node.decorator_list:
            d = dec.func if isinstance(dec, ast.Call) else dec
            name = d.attr if isinstance(d, ast.Attribute) else (
                d.id if isinstance(d, ast.Name) else None)
            if name == "remote":
                out.append(node)
                break
    return out


def analyze(root: str, make_finding,
            allow: FrozenSet[str] = DEFAULT_ALLOW) -> List:
    findings = []
    zones = {mod: [] for mod, _ in _ZONES}
    for mod, qual in _ZONES:
        zones[mod].append(qual)
    for rel, ap in iter_py_files(root):
        tree = parse_file(ap)
        if tree is None:
            continue
        mod = module_name(rel)
        # event-loop zones
        for qual in zones.get(mod, ()):
            for fn in find_function(tree, qual):
                findings.extend(_scan_body(
                    fn, f"{mod}.{qual}", rel, make_finding, allow))
        # actor methods
        for cls in _remote_classes(tree):
            for stmt in cls.body:
                if not isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                findings.extend(_scan_body(
                    stmt, f"{mod}.{cls.name}.{stmt.name}",
                    rel, make_finding, allow))
    return findings

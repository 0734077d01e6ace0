"""Shared AST plumbing for the raylint passes.

Everything here is deliberately std-lib only (``ast`` + ``os``): the
analyzer runs inside the tier-1 gate, so it must import in milliseconds
and carry zero dependency risk. Resolution is heuristic but HONEST —
when a lock expression can't be bound to a unique definition it is
skipped, never guessed, so the passes under-approximate rather than
invent cross-module edges.
"""

from __future__ import annotations

import ast
import contextlib
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

#: attribute/constructor names that create a lock-ish object
LOCK_FACTORIES = {"Lock": "Lock", "RLock": "RLock",
                  "Condition": "Condition", "Semaphore": "Semaphore",
                  "BoundedSemaphore": "Semaphore"}

#: names whose ``.get(...)`` is a blocking object-store get (the
#: blocking-call and ref-lifecycle passes): the port's package, its
#: usual ``ray`` alias, and the worker handles
GET_RECEIVERS = frozenset({"ray_tpu_torch", "ray", "worker", "_worker"})

#: container methods that mutate in place (shared-state pass)
MUTATING_METHODS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "discard", "add", "clear", "update",
    "setdefault", "sort", "reverse",
}


def iter_py_files(root: str) -> Iterator[Tuple[str, str]]:
    """Yield (relpath, abspath) for every .py under ``root``, skipping
    caches and the analyzer's own fixtures."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git",
                                          "fixtures"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                ap = os.path.join(dirpath, fn)
                yield os.path.relpath(ap, root), ap


#: normalised path -> tree (None: unreadable) while parse_cache() is open
_PARSE_CACHE: Optional[Dict[str, Optional[ast.Module]]] = None


@contextlib.contextmanager
def parse_cache():
    """Parse each file once for the passes run inside (``run_all``): the
    passes read the trees and never change them, and parsing was a
    quarter of a run. The trees are dropped when the outermost block
    ends, so files written between two runs are read afresh."""
    global _PARSE_CACHE
    outer = _PARSE_CACHE
    if outer is None:
        _PARSE_CACHE = {}
    try:
        yield
    finally:
        _PARSE_CACHE = outer


def parse_file(path: str) -> Optional[ast.Module]:
    cache = _PARSE_CACHE
    key = os.path.normpath(path)
    if cache is not None and key in cache:
        return cache[key]
    try:
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        tree = None
    if cache is not None:
        cache[key] = tree
    return tree


def module_name(relpath: str) -> str:
    return relpath[:-3].replace(os.sep, ".")


def _is_lock_factory(call: ast.AST) -> Optional[str]:
    """'Lock' / 'RLock' / 'Condition' if ``call`` constructs one.

    Sees through the runtime sanitizer's witness wrapper —
    ``wrap_lock(threading.Lock(), "id")`` still DEFINES a Lock, and
    losing that binding would silently drop the lock (and every edge
    through it) from all static passes."""
    if not isinstance(call, ast.Call):
        return None
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    if name == "wrap_lock" and call.args:
        return _is_lock_factory(call.args[0])
    if name in LOCK_FACTORIES:
        return LOCK_FACTORIES[name]
    return None


@dataclass
class ClassInfo:
    module: str
    name: str
    node: ast.ClassDef
    #: self-attribute name -> lock kind ("Lock" | "RLock" | "Condition")
    locks: Dict[str, str] = field(default_factory=dict)
    spawns_threads: bool = False

    @property
    def qualname(self) -> str:
        return f"{self.module}.{self.name}"

    def lock_id(self, attr: str) -> str:
        return f"{self.qualname}.{attr}"

    def methods(self) -> Iterator[ast.FunctionDef]:
        for stmt in self.node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield stmt


def collect_classes(tree: ast.Module, module: str) -> List[ClassInfo]:
    """Top-level classes with their lock attributes and whether they
    spawn threads (``threading.Thread(...)`` anywhere in a method)."""
    out = []
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        info = ClassInfo(module, node.name, node)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                kind = _is_lock_factory(sub.value)
                if kind:
                    for tgt in sub.targets:
                        if (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            info.locks[tgt.attr] = kind
            elif isinstance(sub, ast.Call):
                f = sub.func
                if ((isinstance(f, ast.Attribute) and f.attr == "Thread")
                        or (isinstance(f, ast.Name) and f.id == "Thread")):
                    info.spawns_threads = True
        out.append(info)
    return out


def collect_module_locks(tree: ast.Module, module: str) -> Dict[str, str]:
    """Module-level ``X = threading.Lock()`` globals: name -> kind."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            kind = _is_lock_factory(node.value)
            if kind:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = kind
    return out


@dataclass
class LockRef:
    id: str     # "module.Class.attr" or "module.global"
    kind: str   # Lock | RLock | Condition | Semaphore

    def reentrant(self) -> bool:
        return self.kind == "RLock"


class LockIndex:
    """Repo-wide lock registry: resolves a ``with <expr>:`` expression
    to a unique lock definition, or to None when ambiguous."""

    def __init__(self) -> None:
        #: attr name -> [(lock_id, kind)] across every class
        self.by_attr: Dict[str, List[Tuple[str, str]]] = {}
        #: module -> {global name -> kind}
        self.module_globals: Dict[str, Dict[str, str]] = {}

    def add_class(self, info: ClassInfo) -> None:
        for attr, kind in info.locks.items():
            self.by_attr.setdefault(attr, []).append(
                (info.lock_id(attr), kind))

    def add_module_globals(self, module: str,
                           locks: Dict[str, str]) -> None:
        self.module_globals[module] = locks

    def resolve(self, expr: ast.AST, cls: Optional[ClassInfo],
                module: str) -> Optional[LockRef]:
        """Bind a with-item expression to a lock definition.

        self.X        -> this class's lock X (exact)
        bare NAME     -> this module's global lock (exact)
        other.X       -> the unique class defining lock attr X, if ONE
                         class in the repo does (else unresolvable)
        """
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            if (isinstance(expr.value, ast.Name)
                    and expr.value.id == "self" and cls is not None
                    and attr in cls.locks):
                return LockRef(cls.lock_id(attr), cls.locks[attr])
            defs = self.by_attr.get(attr, [])
            if len(defs) == 1:
                return LockRef(defs[0][0], defs[0][1])
            return None
        if isinstance(expr, ast.Name):
            kind = self.module_globals.get(module, {}).get(expr.id)
            if kind:
                return LockRef(f"{module}.{expr.id}", kind)
        return None


def with_lock_exprs(node: ast.With) -> List[ast.AST]:
    """The context expressions of a with-statement that LOOK lock-like
    (named *lock*, *_cv*, *cond*, or a bare attribute); non-lock
    context managers (open(), suppress()...) are never candidates."""
    out = []
    for item in node.items:
        e = item.context_expr
        name = None
        if isinstance(e, ast.Attribute):
            name = e.attr
        elif isinstance(e, ast.Name):
            name = e.id
        if name is None:
            continue
        low = name.lower()
        if "lock" in low or "cv" in low or "cond" in low:
            out.append(e)
    return out


def functions_in(node: ast.AST) -> Iterator[ast.FunctionDef]:
    for sub in ast.walk(node):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield sub


def find_function(tree: ast.Module,
                  qualname: str) -> List[ast.FunctionDef]:
    """'Class.method' or 'func' -> matching FunctionDef nodes."""
    parts = qualname.split(".")
    if len(parts) == 1:
        return [n for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and n.name == parts[0]]
    out = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == parts[0]:
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)) \
                        and sub.name == parts[1]:
                    out.append(sub)
    return out


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None

"""Pass 2 — unguarded-shared-state detection.

For every class that spawns threads AND designates at least one lock,
classify each mutation of a ``self.X`` attribute as *guarded* (lexically
inside ``with self.<lock>:``, or in a method whose name ends in
``_locked`` — the repo's caller-holds-the-lock convention) or
*unguarded*, then flag:

- **mixed-guard**: an attribute mutated both under the lock and outside
  it (the classic "forgot the lock on one path" race), and
- **unguarded read-modify-write**: ``self.x += 1`` / ``self.d[k] += v``
  style AugAssign outside any lock, when the attribute is touched from
  ≥2 distinct methods (single-method counters are usually confined to
  one thread).

``__init__`` / ``__enter__`` style setup runs before threads exist and
is exempt, as are the lock attributes themselves.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.analysis._astutil import (
    MUTATING_METHODS, ClassInfo, collect_classes, iter_py_files,
    module_name, parse_file)

PASS = "shared_state"

#: methods that run before any thread is spawned (or tear everything
#: down after joins) — mutations there are single-threaded by contract
_EXEMPT_METHODS = {"__init__", "__new__", "__enter__", "__post_init__"}


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _base_self_attr(node: ast.AST) -> Optional[str]:
    """self.X, self.X[k], self.X.y ... -> "X" (outermost self attr)."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        a = _self_attr(node)
        if a is not None:
            return a
        node = node.value
    return None


class _MethodScan(ast.NodeVisitor):
    """Collect per-attribute mutations with their guard state."""

    def __init__(self, cls: ClassInfo, always_guarded: bool):
        self.cls = cls
        self.always_guarded = always_guarded
        self.depth = 0  # with self.<lock>: nesting depth
        #: attr -> [(guarded, line, is_rmw)]
        self.mutations: Dict[str, List[Tuple[bool, int, bool]]] = {}
        #: attrs read or written at all (for the >=2-methods heuristic)
        self.touched: Set[str] = set()

    def _guarded(self) -> bool:
        return self.always_guarded or self.depth > 0

    def _note(self, attr: Optional[str], line: int,
              rmw: bool = False) -> None:
        if attr is None or attr in self.cls.locks:
            return
        self.mutations.setdefault(attr, []).append(
            (self._guarded(), line, rmw))
        self.touched.add(attr)

    def visit_With(self, node: ast.With) -> None:
        holds = False
        for item in node.items:
            a = _self_attr(item.context_expr)
            if a is not None and a in self.cls.locks:
                holds = True
        if holds:
            self.depth += 1
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        if holds:
            self.depth -= 1

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript):
                self._note(_base_self_attr(tgt), node.lineno)
            else:
                self._note(_self_attr(tgt), node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._note(_base_self_attr(node.target), node.lineno, rmw=True)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._note(_self_attr(node.target), node.lineno)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript):
                self._note(_base_self_attr(tgt), node.lineno)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in MUTATING_METHODS:
            self._note(_base_self_attr(f.value), node.lineno)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        a = _self_attr(node)
        if a is not None:
            self.touched.add(a)
        self.generic_visit(node)

    # thread targets defined inline run concurrently, but scanning them
    # with the same guard state is wrong only when they capture the
    # with-block's lock scope — conservatively treat nested defs as
    # separate unguarded scopes
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        inner = _MethodScan(self.cls, always_guarded=False)
        for stmt in node.body:
            inner.visit(stmt)
        for attr, muts in inner.mutations.items():
            self.mutations.setdefault(attr, []).extend(muts)
        self.touched |= inner.touched

    visit_AsyncFunctionDef = visit_FunctionDef


def analyze(root: str, make_finding) -> List:
    findings = []
    for rel, ap in iter_py_files(root):
        tree = parse_file(ap)
        if tree is None:
            continue
        mod = module_name(rel)
        for cls in collect_classes(tree, mod):
            if not cls.spawns_threads or not cls.locks:
                continue
            findings.extend(_check_class(cls, rel, make_finding))
    return findings


def _check_class(cls: ClassInfo, rel: str, make_finding) -> List:
    #: attr -> [(guarded, line, rmw)] across non-exempt methods
    all_muts: Dict[str, List[Tuple[bool, int, bool]]] = {}
    #: attr -> set of method names touching it
    methods_touching: Dict[str, Set[str]] = {}
    for meth in cls.methods():
        if meth.name in _EXEMPT_METHODS:
            continue
        scan = _MethodScan(cls, always_guarded=meth.name.endswith(
            "_locked"))
        for stmt in meth.body:
            scan.visit(stmt)
        for attr, muts in scan.mutations.items():
            all_muts.setdefault(attr, []).extend(muts)
        for attr in scan.touched:
            methods_touching.setdefault(attr, set()).add(meth.name)

    out = []
    for attr, muts in sorted(all_muts.items()):
        guarded = [m for m in muts if m[0]]
        unguarded = [m for m in muts if not m[0]]
        if guarded and unguarded:
            out.append(make_finding(
                f"{PASS}:mixed-guard:{cls.qualname}.{attr}",
                f"{cls.qualname}.{attr} is mutated under "
                f"{sorted(cls.locks)} AND outside it "
                f"(unguarded at line {unguarded[0][1]})",
                rel, unguarded[0][1]))
            continue
        rmw_unguarded = [m for m in unguarded if m[2]]
        if rmw_unguarded and len(methods_touching.get(attr, ())) >= 2:
            out.append(make_finding(
                f"{PASS}:unguarded-rmw:{cls.qualname}.{attr}",
                f"{cls.qualname}.{attr} has read-modify-write "
                f"mutations with no lock held, and is accessed from "
                f"{len(methods_touching[attr])} methods of a "
                f"thread-spawning class", rel, rmw_unguarded[0][1]))
    return out

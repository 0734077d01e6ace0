"""Pass 1 — lock-order analysis.

Extracts every ``with <lock>:`` nesting across the package, builds the
cross-module lock-acquisition graph (edges: lock A held while lock B is
acquired, including one level of same-class method-call expansion), and
reports

- **cycles** in the graph (two code paths acquiring the same pair of
  locks in opposite order can deadlock), and
- **re-acquisition of a non-reentrant** ``threading.Lock`` — directly
  nested, or via a same-class method call made while the lock is held
  (a guaranteed self-deadlock on the path).

Resolution is conservative: a lock expression that can't be bound to a
unique definition (e.g. ``other._lock`` where many classes define
``_lock``) contributes no edges rather than speculative ones.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.analysis._astutil import (
    ClassInfo, LockIndex, LockRef, collect_classes, collect_module_locks,
    functions_in, iter_py_files, module_name, parse_file, with_lock_exprs)

PASS = "lock_order"


class _FuncScan(ast.NodeVisitor):
    """Per-function walk tracking the stack of held locks."""

    def __init__(self, index: LockIndex, cls: Optional[ClassInfo],
                 module: str, relpath: str):
        self.index = index
        self.cls = cls
        self.module = module
        self.relpath = relpath
        self.held: List[LockRef] = []
        #: (outer_id, inner_id) -> (file, line)
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        #: direct lock ids this function acquires
        self.acquired: Dict[str, str] = {}
        #: self-method calls made while holding locks:
        #: (callee_name, tuple(held ids), line)
        self.calls_held: List[Tuple[str, Tuple[str, ...], int]] = []
        self.reacquires: List[Tuple[str, int]] = []

    def visit_With(self, node: ast.With) -> None:
        refs = []
        for expr in with_lock_exprs(node):
            ref = self.index.resolve(expr, self.cls, self.module)
            if ref is None:
                continue
            refs.append(ref)
            self.acquired.setdefault(ref.id, ref.kind)
            for outer in self.held:
                if outer.id != ref.id:
                    self.edges.setdefault(
                        (outer.id, ref.id), (self.relpath, node.lineno))
            if any(h.id == ref.id for h in self.held) \
                    and not ref.reentrant():
                self.reacquires.append((ref.id, node.lineno))
        self.held.extend(refs)
        for stmt in node.body:
            self.visit(stmt)
        del self.held[len(self.held) - len(refs):len(self.held)]

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if (self.held and isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"):
            self.calls_held.append(
                (f.attr, tuple(h.id for h in self.held), node.lineno))
        self.generic_visit(node)

    # nested defs (thread targets, closures) run on other stacks — the
    # enclosing function's held set must not leak into them
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _scan_function(fn: ast.FunctionDef, index: LockIndex,
                   cls: Optional[ClassInfo], module: str,
                   relpath: str) -> _FuncScan:
    scan = _FuncScan(index, cls, module, relpath)
    for stmt in fn.body:
        scan.visit(stmt)
    return scan


def collect_edges(root: str) -> Set[Tuple[str, str]]:
    """The static acquisition-order edge set (outer_id, inner_id) —
    the same graph ``analyze`` reports cycles on, exposed so the
    runtime sanitizer's lock witness can diff observed orders against
    it at shutdown."""
    index = LockIndex()
    parsed = []
    for rel, ap in iter_py_files(root):
        tree = parse_file(ap)
        if tree is None:
            continue
        mod = module_name(rel)
        cl = collect_classes(tree, mod)
        parsed.append((rel, mod, tree, cl))
        for c in cl:
            index.add_class(c)
        index.add_module_globals(mod, collect_module_locks(tree, mod))
    edges: Set[Tuple[str, str]] = set()
    for rel, mod, tree, cl in parsed:
        for cls in cl:
            scans = {m.name: _scan_function(m, index, cls, mod, rel)
                     for m in cls.methods()}
            for scan in scans.values():
                edges.update(scan.edges)
            for scan in scans.values():
                for callee, held_ids, _line in scan.calls_held:
                    target = scans.get(callee)
                    if target is None:
                        continue
                    for inner_id in target.acquired:
                        for outer_id in held_ids:
                            if outer_id != inner_id:
                                edges.add((outer_id, inner_id))
        for fn in (n for n in tree.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))):
            edges.update(_scan_function(fn, index, None, mod, rel).edges)
    return edges


def analyze(root: str, make_finding) -> List:
    """Run the pass over every .py under ``root``. ``make_finding`` is
    the orchestrator's Finding factory: (key, message, file, line)."""
    files = [(rel, ap) for rel, ap in iter_py_files(root)]
    trees: Dict[str, ast.Module] = {}
    classes: Dict[str, List[ClassInfo]] = {}
    index = LockIndex()
    for rel, ap in files:
        tree = parse_file(ap)
        if tree is None:
            continue
        mod = module_name(rel)
        trees[rel] = tree
        cl = collect_classes(tree, mod)
        classes[rel] = cl
        for c in cl:
            index.add_class(c)
        index.add_module_globals(mod, collect_module_locks(tree, mod))

    findings = []
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    #: per class: method name -> scan (for one-level call expansion)
    for rel, tree in trees.items():
        mod = module_name(rel)
        for cls in classes[rel]:
            scans: Dict[str, _FuncScan] = {}
            for meth in cls.methods():
                scan = _scan_function(meth, index, cls, mod, rel)
                scans[meth.name] = scan
                edges.update(scan.edges)
                for lock_id, line in scan.reacquires:
                    findings.append(make_finding(
                        f"{PASS}:reacquire:{lock_id}:{cls.name}."
                        f"{meth.name}",
                        f"non-reentrant lock {lock_id} re-acquired "
                        f"inside its own with-block in "
                        f"{cls.qualname}.{meth.name}", rel, line))
            # one level of same-class call expansion: m holds L and
            # calls self.n(); n acquires M -> edge L->M (and L==M on a
            # plain Lock is a self-deadlock)
            for mname, scan in scans.items():
                for callee, held_ids, line in scan.calls_held:
                    target = scans.get(callee)
                    if target is None:
                        continue
                    for inner_id, inner_kind in target.acquired.items():
                        for outer_id in held_ids:
                            if outer_id == inner_id:
                                if inner_kind == "Lock":
                                    findings.append(make_finding(
                                        f"{PASS}:reacquire-via-call:"
                                        f"{inner_id}:{cls.name}."
                                        f"{mname}->{callee}",
                                        f"{cls.qualname}.{mname} holds "
                                        f"{inner_id} and calls self."
                                        f"{callee}() which re-acquires "
                                        f"it (non-reentrant: "
                                        f"self-deadlock)", rel, line))
                            else:
                                edges.setdefault(
                                    (outer_id, inner_id), (rel, line))
            # module-level functions get edge extraction too
        for fn in (n for n in tree.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))):
            scan = _scan_function(fn, index, None, mod, rel)
            edges.update(scan.edges)
            for lock_id, line in scan.reacquires:
                findings.append(make_finding(
                    f"{PASS}:reacquire:{lock_id}:{fn.name}",
                    f"non-reentrant lock {lock_id} re-acquired inside "
                    f"its own with-block in {mod}.{fn.name}",
                    rel, line))

    findings.extend(_cycle_findings(edges, make_finding))
    return findings


def _cycle_findings(edges: Dict[Tuple[str, str], Tuple[str, int]],
                    make_finding) -> List:
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    sccs = _tarjan(graph)
    out = []
    for scc in sccs:
        if len(scc) < 2:
            continue
        cyc = sorted(scc)
        # anchor the finding at one edge inside the cycle
        loc = next((edges[(a, b)] for a in cyc for b in cyc
                    if (a, b) in edges), ("", 0))
        out.append(make_finding(
            "lock_order:cycle:" + "+".join(cyc),
            "lock acquisition cycle (potential deadlock): "
            + " -> ".join(cyc), loc[0], loc[1]))
    return out


def _tarjan(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Iterative Tarjan SCC (the graph is tiny, but recursion limits
    are not worth risking inside a test gate)."""
    idx: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    for start in graph:
        if start in idx:
            continue
        work = [(start, iter(sorted(graph[start])))]
        idx[start] = low[start] = counter[0]
        counter[0] += 1
        stack.append(start)
        on_stack.add(start)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in idx:
                    idx[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], idx[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == idx[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(scc)
    return sccs

"""Pass 6 — ObjectRef lifecycle conformance.

``ObjectRef.__init__`` self-registers a local reference unless built
with ``_register=False`` — a WEAK ref that holds no refcount and whose
object can be freed underneath it. The repo's contract (see
object_ref.py / ref_counting.py) is that weak refs stay ephemeral:
built, handed to one call, dropped. Three drift patterns are flagged:

- **weak-escape**: a weak ref (or a container it was put in) is
  returned from the function or stored on ``self`` without
  re-registration. The escapee looks like a live handle but the store
  may already have reclaimed the object. Re-registration is signalled
  the way ``Worker.submit_task_batch`` does it — a ``X._weak = False``
  assignment anywhere in the function exempts it (the counting happened
  out-of-band, e.g. via ``register_submit_batch``).
- **double-release**: the same name released twice on one straight-line
  path (``remove_local_reference`` / ``defer_unref``) with no
  rebinding in between — the second call decrements someone else's
  refcount.
- **get-after-free**: a released name handed to a blocking
  ``worker.get(...)`` later on the same path — the classic
  use-after-free shape, one rename away from returning garbage.

Straight-line means SAME statement list: branches are separate paths
and loops rebind their targets, so both are skipped — the pass
under-approximates rather than guessing control flow.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ray_tpu_torch._private.analysis._astutil import (
    GET_RECEIVERS, iter_py_files, module_name, parse_file)

PASS = "ref_lifecycle"

#: call attrs that release a ref held for NAME
_RELEASE_ATTRS = {"remove_local_reference", "defer_unref"}


def _is_weak_ref_call(node: ast.AST) -> bool:
    """``ObjectRef(..., _register=False)``."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    if name != "ObjectRef":
        return False
    for kw in node.keywords:
        if (kw.arg == "_register"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is False):
            return True
    return False


def _contains_weak_call(node: ast.AST) -> bool:
    """The expression builds weak refs somewhere inside (covers list
    comprehensions and literal lists of ``ObjectRef(..)`` calls)."""
    return any(_is_weak_ref_call(sub) for sub in ast.walk(node))


def _names_in(node: ast.AST) -> Set[str]:
    return {sub.id for sub in ast.walk(node) if isinstance(sub, ast.Name)}


def _direct_names(expr: ast.AST) -> Set[str]:
    """Names the expression hands over AS VALUES: a bare name or a
    container literal of names. A name appearing as a call ARGUMENT is
    consumption inside this scope (``return worker.wait(refs, ...)``),
    not an escape of the ref itself."""
    if isinstance(expr, ast.Name):
        return {expr.id}
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        out: Set[str] = set()
        for e in expr.elts:
            out |= _direct_names(e)
        return out
    return set()


def _walk_local(fn: ast.AST):
    """ast.walk that stays in ``fn``'s own scope — nested defs are
    separate scopes and are analyzed on their own."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _qualname_functions(tree: ast.Module):
    """Yield (qualname, FunctionDef) for every function, nested included."""
    def walk(node, prefix):
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}.{sub.name}" if prefix else sub.name
                yield q, sub
                yield from walk(sub, q)
            elif isinstance(sub, ast.ClassDef):
                q = f"{prefix}.{sub.name}" if prefix else sub.name
                yield from walk(sub, q)
            else:
                yield from walk(sub, prefix)
    yield from walk(tree, "")


def _check_weak_escape(qual: str, fn: ast.FunctionDef, mod: str,
                       rel: str, make_finding) -> List:
    # names bound (directly or by alias) to weak refs / containers of them
    weak: Dict[str, int] = {}
    reregistered = False
    for sub in _walk_local(fn):
        if isinstance(sub, ast.Assign):
            # X._weak = False anywhere = counting happened out-of-band
            for tgt in sub.targets:
                if (isinstance(tgt, ast.Attribute) and tgt.attr == "_weak"
                        and isinstance(sub.value, ast.Constant)
                        and sub.value.value is False):
                    reregistered = True
            if _contains_weak_call(sub.value):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        weak.setdefault(tgt.id, sub.lineno)
            elif (isinstance(sub.value, ast.Name)
                    and sub.value.id in weak):            # alias: Y = X
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        weak.setdefault(tgt.id, sub.lineno)
    if reregistered or not weak:
        return []

    # one-level containment: Y.append(X) / Y.extend([X...]) taints Y
    for sub in _walk_local(fn):
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in ("append", "extend", "add")
                and isinstance(sub.func.value, ast.Name)):
            if any(n in weak for a in sub.args for n in _names_in(a)):
                weak.setdefault(sub.func.value.id, sub.lineno)

    out = []
    flagged: Set[str] = set()
    for sub in _walk_local(fn):
        escaped: Set[str] = set()
        line = getattr(sub, "lineno", fn.lineno)
        if isinstance(sub, ast.Return) and sub.value is not None:
            escaped = _direct_names(sub.value) & set(weak)
        elif isinstance(sub, ast.Assign):
            # self.attr = <a weak name or a container literal of them>
            if any(isinstance(t, ast.Attribute)
                   and isinstance(t.value, ast.Name)
                   and t.value.id == "self" for t in sub.targets):
                escaped = _direct_names(sub.value) & set(weak)
        for name in sorted(escaped - flagged):
            flagged.add(name)
            out.append(make_finding(
                f"{PASS}:weak-escape:{mod}.{qual}:{name}",
                f"{mod}.{qual} lets weak ObjectRef '{name}' "
                f"(_register=False, line {weak[name]}) escape the "
                f"function without re-registration — the object can be "
                f"freed under the escaped handle", rel, line))
    return out


def _release_target(stmt: ast.stmt) -> Optional[str]:
    """NAME if ``stmt`` is ``...remove_local_reference(NAME)`` etc."""
    if not (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)):
        return None
    call = stmt.value
    if (isinstance(call.func, ast.Attribute)
            and call.func.attr in _RELEASE_ATTRS
            and len(call.args) >= 1 and isinstance(call.args[0], ast.Name)):
        return call.args[0].id
    return None


def _get_call_args(stmt: ast.stmt) -> Set[str]:
    """Names passed to a worker-style blocking ``get`` in ``stmt``."""
    out: Set[str] = set()
    for sub in ast.walk(stmt):
        if not (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "get"):
            continue
        base = sub.func.value
        base_name = base.id if isinstance(base, ast.Name) else (
            base.attr if isinstance(base, ast.Attribute) else None)
        if base_name not in GET_RECEIVERS:
            continue
        for a in sub.args:
            out |= _names_in(a)
    return out


def _check_release_paths(qual: str, fn: ast.FunctionDef, mod: str,
                         rel: str, make_finding) -> List:
    out = []

    def scan_block(stmts: List[ast.stmt]) -> None:
        released: Dict[str, int] = {}
        for stmt in stmts:
            # a rebinding makes the name a fresh ref again
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                tgts = (stmt.targets
                        if isinstance(stmt, ast.Assign) else [stmt.target])
                for t in tgts:
                    if isinstance(t, ast.Name):
                        released.pop(t.id, None)
            name = _release_target(stmt)
            if name is not None:
                if name in released:
                    out.append(make_finding(
                        f"{PASS}:double-release:{mod}.{qual}:{name}",
                        f"{mod}.{qual} releases ref '{name}' twice on "
                        f"the same path (first at line "
                        f"{released[name]}) — the second call "
                        f"decrements another holder's count",
                        rel, stmt.lineno))
                else:
                    released[name] = stmt.lineno
                continue
            for name in sorted(_get_call_args(stmt) & set(released)):
                out.append(make_finding(
                    f"{PASS}:get-after-free:{mod}.{qual}:{name}",
                    f"{mod}.{qual} passes '{name}' to a blocking get "
                    f"after releasing it at line {released[name]} — "
                    f"the object may already be reclaimed",
                    rel, stmt.lineno))
            # loop/branch bodies are separate paths: recurse with a
            # fresh released-set, don't thread state through them
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list) and sub:
                    scan_block(sub)
            for h in getattr(stmt, "handlers", ()):
                scan_block(h.body)

    scan_block(fn.body)
    return out


def analyze(root: str, make_finding) -> List:
    findings = []
    for rel, ap in iter_py_files(root):
        tree = parse_file(ap)
        if tree is None:
            continue
        mod = module_name(rel)
        for qual, fn in _qualname_functions(tree):
            findings.extend(
                _check_weak_escape(qual, fn, mod, rel, make_finding))
            findings.extend(
                _check_release_paths(qual, fn, mod, rel, make_finding))
    return findings

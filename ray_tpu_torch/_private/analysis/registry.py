"""Pass 5 — registry drift.

Two registries pair a STRING namespace with code that must stay in
lockstep:

- **state verbs**: the ray:// server only forwards verbs allowlisted in
  ``client.py``'s ``_STATE_VERBS`` frozenset, and ``util/state.py``
  defines the implementations (``@_client_dispatch``). A verb defined
  but not allowlisted silently 403s over ray://; a verb allowlisted but
  not defined AttributeErrors at dispatch.
- **Prometheus metrics**: names emitted by ``_private/metrics.py`` (and
  the task-event histograms it inlines from ``task_events.py``) form
  the de-facto registry; every emitted name must be documented in
  README.md, and every documented name must still be emitted (stale
  docs were how the retired ``ray_tpu_log_bytes_written_total`` alias
  lingered). README tokens support ``{a,b}`` brace alternation.
- **chaos fault sites**: ``chaos.py``'s ``_SITE_KINDS`` dict is the
  injection-site registry; README's chaos section documents each site
  as a backticked name followed by a parenthesized kinds note. A site
  added to the code but not the docs is invisible to users writing
  fault plans; a documented site the controller rejects fails their
  plan at arm() (this is how the ``sched`` vs ``sched_tick`` naming
  drift and the missing ``head`` site were caught).

Emitted names are collected from ``emit("name", ...)`` first args,
``ray_tpu_*`` strings inside tuple/list literals (the counter tables),
and ``# HELP``/``# TYPE`` lines inside string constants — thread names
and other stray strings never match those shapes.
"""

from __future__ import annotations

import ast
import itertools
import os
import re
from typing import Dict, List, Optional, Sequence, Set

from ray_tpu_torch._private.analysis._astutil import (
    const_str, find_function, parse_file)

PASS = "registry"

_METRIC_RE = re.compile(r"^ray_tpu_[a-z0-9_]+$")
_HELP_TYPE_RE = re.compile(r"#\s*(?:HELP|TYPE)\s+(ray_tpu_[a-z0-9_]+)")
_DOC_TOKEN_RE = re.compile(r"ray_tpu_[a-z0-9_{},]+")


# ---------------------------------------------------------------------------
# state verbs
# ---------------------------------------------------------------------------

def collect_allowlist(tree: ast.Module,
                      var: str = "_STATE_VERBS") -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == var
                   for t in node.targets):
            continue
        for sub in ast.walk(node.value):
            s = const_str(sub)
            if s:
                out.add(s)
    return out


def collect_dispatch_defs(tree: ast.Module,
                          decorator: str = "_client_dispatch"
                          ) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            name = dec.attr if isinstance(dec, ast.Attribute) else (
                dec.id if isinstance(dec, ast.Name) else None)
            if name == decorator:
                out[node.name] = node.lineno
    return out


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def collect_emitted_metrics(tree: ast.Module, source: str) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "emit" and node.args):
            s = const_str(node.args[0])
            if s and _METRIC_RE.match(s):
                out.add(s)
        elif isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                s = const_str(e)
                if s and _METRIC_RE.match(s):
                    out.add(s)
    out.update(_HELP_TYPE_RE.findall(source))
    return out


def expand_doc_token(token: str) -> List[str]:
    """``ray_tpu_sched_locality_{hit,miss}_total`` -> both names."""
    parts: List[List[str]] = []
    for frag in re.split(r"(\{[^}]*\})", token):
        if frag.startswith("{") and frag.endswith("}"):
            parts.append(frag[1:-1].split(","))
        elif frag:
            parts.append([frag])
    return ["".join(p) for p in itertools.product(*parts)] if parts \
        else []


def collect_documented_metrics(readme: str) -> Dict[str, str]:
    """expanded metric name -> the doc token it came from."""
    out: Dict[str, str] = {}
    for token in _DOC_TOKEN_RE.findall(readme):
        for name in expand_doc_token(token):
            if _METRIC_RE.match(name):
                out[name] = token
    return out


# ---------------------------------------------------------------------------
# chaos fault sites
# ---------------------------------------------------------------------------

# a documented site row reads like:  `worker` (SIGKILL),  — a backticked
# bare name immediately followed by a parenthesized kinds note. Tokens
# with dots (`ray_tpu.chaos`) or without the "(" never match.
_CHAOS_SITE_DOC_RE = re.compile(r"`([a-z][a-z0-9_]*)`\s*\(")
_CHAOS_HEADING_RE = re.compile(r"^#+\s.*chaos", re.IGNORECASE | re.MULTILINE)


def collect_chaos_sites(tree: ast.Module,
                        var: str = "_SITE_KINDS") -> Dict[str, int]:
    """site name -> lineno, from the ``_SITE_KINDS`` dict literal.
    Matches both plain and annotated assignments — the real registry
    is annotated (``_SITE_KINDS: Dict[...] = {...}``), and an
    Assign-only walk silently disabled this whole check."""
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == var
                   for t in targets):
            continue
        if isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                s = const_str(k)
                if s:
                    out[s] = k.lineno
    return out


def collect_documented_sites(readme: str) -> Set[str]:
    """Backticked site names from README's chaos section (heading
    containing 'chaos' up to the next heading)."""
    m = _CHAOS_HEADING_RE.search(readme)
    if m is None:
        return set()
    section = readme[m.end():]
    nxt = re.search(r"^#+\s", section, re.MULTILINE)
    if nxt is not None:
        section = section[:nxt.start()]
    return set(_CHAOS_SITE_DOC_RE.findall(section))


# ---------------------------------------------------------------------------
# pass entry point
# ---------------------------------------------------------------------------

def analyze(root: str, make_finding,
            client_relpath: str = "_private/client.py",
            state_relpath: str = "util/state.py",
            metrics_relpaths: Sequence[str] = ("_private/metrics.py",
                                               "_private/task_events.py"),
            readme_path: Optional[str] = None,
            dispatch_exempt: Sequence[str] = (),
            chaos_relpath: str = "_private/chaos.py") -> List:
    findings: List = []

    client_tree = parse_file(os.path.normpath(
        os.path.join(root, client_relpath)))
    state_tree = parse_file(os.path.normpath(
        os.path.join(root, state_relpath)))
    if client_tree is not None and state_tree is not None:
        allow = collect_allowlist(client_tree)
        defs = collect_dispatch_defs(state_tree)
        for verb in sorted(set(defs) - allow - set(dispatch_exempt)):
            findings.append(make_finding(
                f"{PASS}:verb-unlisted:{verb}",
                f"state verb {verb!r} is defined in {state_relpath} but "
                f"missing from the ray:// allowlist in "
                f"{client_relpath}", state_relpath, defs[verb]))
        for verb in sorted(allow - set(defs)):
            findings.append(make_finding(
                f"{PASS}:verb-undefined:{verb}",
                f"state verb {verb!r} is allowlisted over ray:// but "
                f"{state_relpath} defines no such function",
                client_relpath, 0))

    emitted: Set[str] = set()
    for rel in metrics_relpaths:
        ap = os.path.normpath(os.path.join(root, rel))
        try:
            with open(ap, "r", encoding="utf-8") as f:
                source = f.read()
        except OSError:
            continue
        tree = parse_file(ap)
        if tree is None:
            continue
        emitted |= collect_emitted_metrics(tree, source)

    if readme_path is None:
        readme_path = os.path.normpath(
            os.path.join(root, "..", "README.md"))
    try:
        with open(readme_path, "r", encoding="utf-8") as f:
            readme = f.read()
    except OSError:
        readme = ""
    if readme:
        documented = collect_documented_metrics(readme)
        for name in sorted(emitted - set(documented)):
            findings.append(make_finding(
                f"{PASS}:metric-undocumented:{name}",
                f"metric {name!r} is emitted but not documented in "
                f"README.md", metrics_relpaths[0], 0))
        stale_tokens = {tok for name, tok in documented.items()
                        if name not in emitted}
        live_tokens = {tok for name, tok in documented.items()
                       if name in emitted}
        for tok in sorted(stale_tokens - live_tokens):
            findings.append(make_finding(
                f"{PASS}:metric-phantom:{tok}",
                f"README documents metric {tok!r} but nothing emits "
                f"it", "README.md", 0))

    chaos_tree = parse_file(os.path.normpath(
        os.path.join(root, chaos_relpath)))
    if chaos_tree is not None and readme:
        sites = collect_chaos_sites(chaos_tree)
        documented_sites = collect_documented_sites(readme)
        if sites and documented_sites:
            for site in sorted(set(sites) - documented_sites):
                findings.append(make_finding(
                    f"{PASS}:chaos-site-undocumented:{site}",
                    f"chaos fault site {site!r} is registered in "
                    f"{chaos_relpath} (_SITE_KINDS) but README's chaos "
                    f"section does not document it",
                    chaos_relpath, sites[site]))
            for site in sorted(documented_sites - set(sites)):
                findings.append(make_finding(
                    f"{PASS}:chaos-site-phantom:{site}",
                    f"README's chaos section documents fault site "
                    f"{site!r} but {chaos_relpath} (_SITE_KINDS) does "
                    f"not register it — a fault plan naming it fails "
                    f"at arm()", "README.md", 0))
    return findings

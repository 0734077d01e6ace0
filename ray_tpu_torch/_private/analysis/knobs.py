"""Pass 4 — knob consistency.

Every knob registered in ``_private/config.py`` must be

- **overridable from the environment** — satisfied by construction:
  ``ConfigRegistry.define`` applies ``RAY_TPU_TORCH_<NAME>`` itself, so a
  knob cannot lack an override. The pass still verifies the knob name
  is a valid env-suffix identifier (lowercase, no dashes) so the
  override actually resolves.
- **read somewhere** — at least one site in the package (outside
  config.py itself) reads it, via attribute access
  (``GLOBAL_CONFIG.task_events_max``), ``.get("name")`` /
  ``.entry("name")`` / ``set(...)`` string use, or an
  ``RAY_TPU_TORCH_<NAME>`` env literal. A knob nobody reads is dead — the
  ``log_dir`` class of bug.
- **documented** — mentioned in README.md as an exact token. Plain
  substring matching had a false-negative class: an undocumented knob
  whose name is a SUBSTRING of a documented one (``tick_interval_s``
  riding on ``sched_tick_interval_s``) passed silently. The README is
  tokenized instead, with two conveniences: ``RAY_TPU_TORCH_<NAME>``
  env spellings count as documenting ``<name>``, and brace-expanded
  doc shorthand (``sched_max_{edges,nodes}``) counts for every
  expansion — same grammar registry.expand_doc_token uses.
"""

from __future__ import annotations

import ast
import itertools
import os
import re
from typing import Dict, List, Optional, Set

from ray_tpu_torch._private.analysis._astutil import (
    const_str, iter_py_files, parse_file)

PASS = "knob"

#: the port's environment spelling of a knob (``_private/config.py``)
ENV_PREFIX = "RAY_TPU_TORCH_"

_DEFINE_CALLEES = {"_d", "define"}


def collect_knobs(config_tree: ast.Module) -> Dict[str, int]:
    """knob name -> definition line, from ``_d("name", ...)`` /
    ``REG.define("name", ...)`` calls."""
    out: Dict[str, int] = {}
    for node in ast.walk(config_tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if name not in _DEFINE_CALLEES:
            continue
        knob = const_str(node.args[0])
        if knob:
            out[knob] = node.lineno
    return out


def collect_reads(root: str, config_relpath: str,
                  knobs: Set[str]) -> Dict[str, int]:
    """knob -> count of read sites across the package."""
    env_names = {f"{ENV_PREFIX}{k.upper()}": k for k in knobs}
    reads: Dict[str, int] = {k: 0 for k in knobs}
    for rel, ap in iter_py_files(root):
        if rel == config_relpath:
            continue
        tree = parse_file(ap)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in knobs:
                reads[node.attr] += 1
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                if node.value in knobs:
                    reads[node.value] += 1
                elif node.value in env_names:
                    reads[env_names[node.value]] += 1
    return reads


def _expand_braces(tok: str) -> List[str]:
    """``a_{b,c}_d`` -> [``a_b_d``, ``a_c_d``] (no nesting)."""
    parts = re.split(r"(\{[^{}]*\})", tok)
    if len(parts) == 1:
        return [tok]
    pools = [p[1:-1].split(",") if p.startswith("{") else [p]
             for p in parts if p]
    return ["".join(combo) for combo in itertools.product(*pools)]


def readme_knob_tokens(readme: str) -> Set[str]:
    """Every exact name the README documents: word-ish tokens (the
    charset includes ``{},`` so brace shorthand survives markdown
    splitting, and spans table-cell line wraps since the regex runs
    over the whole text), brace-expanded, with ``RAY_TPU_TORCH_X`` env
    spellings lowered to the knob name ``x``."""
    out: Set[str] = set()
    for raw in re.findall(r"[A-Za-z0-9_{},]+", readme):
        for tok in _expand_braces(raw):
            tok = tok.strip(",")
            if not tok:
                continue
            out.add(tok)
            if tok.startswith(ENV_PREFIX):
                out.add(tok[len(ENV_PREFIX):].lower())
    return out


def analyze(root: str, make_finding,
            config_relpath: str = "_private/config.py",
            readme_path: Optional[str] = None) -> List:
    findings: List = []
    config_path = os.path.normpath(os.path.join(root, config_relpath))
    tree = parse_file(config_path)
    if tree is None:
        return findings
    knobs = collect_knobs(tree)
    if readme_path is None:
        readme_path = os.path.normpath(
            os.path.join(root, "..", "README.md"))
    try:
        with open(readme_path, "r", encoding="utf-8") as f:
            readme = f.read()
    except OSError:
        readme = ""

    reads = collect_reads(root, config_relpath, set(knobs))
    documented = readme_knob_tokens(readme) if readme else set()
    for name, line in sorted(knobs.items()):
        if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
            findings.append(make_finding(
                f"{PASS}:bad-name:{name}",
                f"knob {name!r} is not a lowercase identifier, so its "
                f"{ENV_PREFIX} env override cannot resolve",
                config_relpath, line))
        if reads.get(name, 0) == 0:
            findings.append(make_finding(
                f"{PASS}:dead:{name}",
                f"knob {name!r} is defined but never read anywhere in "
                f"the package", config_relpath, line))
        if readme and name not in documented:
            findings.append(make_finding(
                f"{PASS}:undocumented:{name}",
                f"knob {name!r} is not mentioned in README.md",
                config_relpath, line))
    return findings

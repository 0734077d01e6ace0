"""raylint + raysan — ray_tpu_torch's framework-invariant analysis plane.

Eight AST passes over the whole package, each encoding an invariant the
repo's history shows drifts silently (see the per-pass module
docstrings): lock ordering, unguarded shared state, wire-protocol
conformance, knob consistency, registry drift, ObjectRef lifecycle,
closure-capture hygiene, and blocking calls in no-block contexts.

The static plane has a runtime mirror (``runtime_sanitizer``, armed by
``RAY_TPU_TORCH_SANITIZE=1``): a lock-witness recorder diffed against
lock_order's static graph, a shm/ref leak ledger reported at shutdown,
and wire-message schema assertions compiled from wire_protocol's
channel table.

Findings carry **stable, line-free keys** (``pass:category:subject``)
so a checked-in ``baseline.json`` can suppress pre-existing violations
without going stale on every reformat; the tier-1 gate fails only on
findings whose key is not baselined. Run it:

    python -m ray_tpu_torch lint            # human text, exit 1 on NEW findings
    python -m ray_tpu_torch lint --json     # machine output
    python -m ray_tpu_torch lint --update-baseline   # re-baseline the rest
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch._private.analysis import (
    _astutil, blocking_calls, closure_capture, knobs, lock_order,
    ref_lifecycle, registry, shared_state, wire_protocol)

#: the package root the passes scan (ray_tpu_torch/), resolved from
#: this file
PACKAGE_ROOT = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")

PASSES = (("lock_order", lock_order.analyze),
          ("shared_state", shared_state.analyze),
          ("wire_protocol", wire_protocol.analyze),
          ("knobs", knobs.analyze),
          ("registry", registry.analyze),
          ("ref_lifecycle", ref_lifecycle.analyze),
          ("closure_capture", closure_capture.analyze),
          ("blocking_calls", blocking_calls.analyze))


@dataclass
class Finding:
    key: str        # stable, line-free: "pass:category:subject"
    message: str
    file: str
    line: int
    pass_id: str = ""


@dataclass
class Report:
    findings: List[Finding]
    new: List[Finding]
    baselined: List[Finding]
    stale_suppressions: List[str]
    durations: Dict[str, float] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.new

    def to_json(self) -> dict:
        def row(f: Finding) -> dict:
            return {"key": f.key, "message": f.message, "file": f.file,
                    "line": f.line, "pass": f.pass_id}
        return {
            "ok": self.ok,
            "new": [row(f) for f in self.new],
            "baselined": [row(f) for f in self.baselined],
            "stale_suppressions": list(self.stale_suppressions),
            "durations_s": {k: round(v, 4)
                            for k, v in self.durations.items()},
        }

    def render_text(self) -> str:
        lines = []
        for f in self.new:
            loc = f"{f.file}:{f.line}" if f.file else "<package>"
            lines.append(f"NEW  [{f.pass_id}] {loc}: {f.message}")
            lines.append(f"     key: {f.key}")
        if self.baselined:
            lines.append(f"{len(self.baselined)} baselined finding(s) "
                         f"suppressed (analysis/baseline.json)")
        for key in self.stale_suppressions:
            lines.append(f"STALE suppression (no longer fires): {key}")
        total = sum(self.durations.values())
        lines.append(
            f"raylint: {len(self.new)} new, {len(self.baselined)} "
            f"baselined, {len(self.stale_suppressions)} stale "
            f"suppression(s) in {total:.2f}s")
        return "\n".join(lines)


def load_baseline(path: Optional[str] = None) -> List[str]:
    try:
        with open(path or BASELINE_PATH, "r", encoding="utf-8") as f:
            data = json.load(f)
        return list(data.get("suppress", []))
    except (OSError, ValueError):
        return []


def save_baseline(keys: List[str], path: Optional[str] = None) -> None:
    with open(path or BASELINE_PATH, "w", encoding="utf-8") as f:
        json.dump({"comment": "raylint suppressions: stable finding "
                              "keys for pre-existing, reviewed "
                              "violations. Remove entries as the code "
                              "they cover is fixed.",
                   "suppress": sorted(keys)}, f, indent=2)
        f.write("\n")


def run_all(root: Optional[str] = None,
            baseline_path: Optional[str] = None,
            passes=PASSES) -> Report:
    root = root or PACKAGE_ROOT
    findings: List[Finding] = []
    durations: Dict[str, float] = {}
    # one parse a file for all the passes: the first pass to read a file
    # pays for its parse
    with _astutil.parse_cache():
        for pass_id, fn in passes:
            def make_finding(key, message, file, line, _p=pass_id):
                return Finding(key=key, message=message, file=file,
                               line=line, pass_id=_p)
            t0 = time.perf_counter()
            findings.extend(fn(root, make_finding))
            durations[pass_id] = time.perf_counter() - t0

    suppress = set(load_baseline(baseline_path))
    seen_keys = {f.key for f in findings}
    new = [f for f in findings if f.key not in suppress]
    baselined = [f for f in findings if f.key in suppress]
    stale = sorted(suppress - seen_keys)
    new.sort(key=lambda f: (f.pass_id, f.file, f.key))
    return Report(findings=findings, new=new, baselined=baselined,
                  stale_suppressions=stale, durations=durations)

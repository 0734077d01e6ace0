"""Task profile events + chrome-trace timeline export.

Reference: core worker profile events -> GCS -> `ray timeline` chrome
tracing JSON (ray: src/ray/core_worker/profile-event area +
python/ray/_private/state.py timeline). Events live in a bounded ring
per worker (config event_buffer_size); the timeline pairs
started/finished into duration events keyed by (task_id, attempt).
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import GLOBAL_CONFIG


class EventBuffer:
    """Bounded ring of (ts, task_id_hex, task_name, event, node,
    attempt)."""

    def __init__(self, maxlen: Optional[int] = None):
        self._buf: collections.deque = collections.deque(
            maxlen=maxlen or GLOBAL_CONFIG.event_buffer_size)

    def record(self, task_id, name: str, event: str,
               node: int = -1, attempt: int = 0) -> None:
        # lock-free: deque.append with maxlen is atomic under the GIL,
        # and record() sits on the per-task hot path (4 calls/task) —
        # the id is stored raw and hexed lazily at snapshot time
        self._buf.append((time.perf_counter(), task_id, name,
                          event, node, attempt))

    def record_batch(self, id_names, event: str, node: int = -1,
                     attempt: int = 0) -> None:
        """One timestamp + one extend for a whole submit batch;
        ``id_names`` yields (task_id, task_name) pairs."""
        now = time.perf_counter()
        self._buf.extend((now, tid, name, event, node, attempt)
                         for tid, name in id_names)

    def snapshot(self) -> List[tuple]:
        return [(ts, tid if isinstance(tid, str) else tid.hex(),
                 name, event, node, attempt)
                for ts, tid, name, event, node, attempt
                in list(self._buf)]

    def timeline(self) -> List[Dict[str, Any]]:
        """Chrome-trace events: one complete ("X") span per
        started->finished pair; unpaired events become instants.

        Open starts are keyed by (task_id, attempt) — a retry of the
        same task id on another node must not overwrite (or adopt) its
        first attempt's start entry — and the attempt number is emitted
        in ``args`` so trace consumers can tell attempts apart.

        A "finished" that misses its exact (task_id, attempt) key falls
        back to the oldest open start for the same task id: producers
        that lose attempt context when a richer plane is disabled
        mid-run (events recorded with attempt, completion without)
        still pair into a span instead of degrading into two dangling
        instants."""
        events = self.snapshot()
        spans: List[Dict[str, Any]] = []
        open_start: Dict[Tuple[str, int], tuple] = {}
        for ts, tid, name, event, node, attempt in events:
            key = (tid, attempt)
            if event == "started":
                open_start[key] = (ts, name, node)
                continue
            if event == "finished":
                if key not in open_start:
                    # pair by task id alone (insertion order = oldest)
                    key = next((k for k in open_start if k[0] == tid),
                               key)
                if key in open_start:
                    t0, name0, node0 = open_start.pop(key)
                    spans.append({
                        "name": name0, "ph": "X", "pid": 0,
                        "tid": max(node0, node, 0),
                        "ts": t0 * 1e6, "dur": (ts - t0) * 1e6,
                        "args": {"task_id": tid, "attempt": key[1]},
                    })
                    continue
            spans.append({
                "name": f"{name}:{event}", "ph": "i", "pid": 0,
                "tid": max(node, 0), "ts": ts * 1e6, "s": "t",
                "args": {"task_id": tid, "attempt": attempt},
            })
        # still-running (or crashed-mid-run) tasks: emit their start as
        # an instant so the trace records them instead of dropping them
        for (tid, attempt), (t0, name0, node0) in open_start.items():
            spans.append({
                "name": f"{name0}:started", "ph": "i", "pid": 0,
                "tid": max(node0, 0), "ts": t0 * 1e6, "s": "t",
                "args": {"task_id": tid, "attempt": attempt,
                         "unfinished": True},
            })
        return spans

    def dump_timeline(self, filename: str) -> str:
        with open(filename, "w") as f:
            json.dump(self.timeline(), f)
        return filename


def plane_disabled_timeline(worker) -> List[Dict[str, Any]]:
    """The ONE degradation path for every disabled observability plane:
    ``state.task_timeline()`` with task events off and
    ``state.get_trace()`` with the trace plane off both fall back to
    the driver-local EventBuffer here, so consumers get the same
    best-effort chrome-trace shape regardless of which plane was
    disabled."""
    events = getattr(worker, "events", None)
    if events is None:
        return []
    return events.timeline()

"""Head-side log monitor: tail capture files, re-emit on the driver.

Reference: ray python/ray/_private/log_monitor.py — a per-head process
that tails every worker's capture files and republishes appended lines
to the driver, prefixed with the producing worker's identity. Here the
monitor is a thread inside the driver Worker:

- LOCAL worker files (head process pools) are tailed straight off the
  session log directory;
- OFF-HEAD lines arrive pre-tailed from each node daemon over the
  existing TCP link (``("log", fname, lines)``) and flow through the
  same emit path;
- every line re-emits prefixed ``(name, wid=, node=)`` — the task or
  actor currently leased on that worker — with ANSI coloring by node
  index, gated by ``init(log_to_driver=True)``;
- a token-bucket rate limiter (``log_to_driver_rate`` lines/s) keeps a
  print-spamming task from melting the head; dropped lines surface as
  an explicit periodic notice, never silently.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, Optional, Tuple

# node index -> ANSI color (cycled): cyan, yellow, green, magenta,
# blue, red — matches the reference's per-pid coloring idea
_COLORS = (36, 33, 32, 35, 34, 31)


def _is_worker_file(fname: str) -> bool:
    return fname.startswith("worker-") and (fname.endswith(".out")
                                            or fname.endswith(".err"))


def _wid_of(fname: str) -> str:
    return fname.rsplit(".", 1)[0][len("worker-"):]


class LogMonitor:
    """Tail local capture files + fan in daemon-shipped lines."""

    def __init__(self, worker, log_dir: Optional[str],
                 rate_limit: Optional[int] = None,
                 interval: float = 0.2, color: Optional[bool] = None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self._worker = worker
        self._log_dir = log_dir
        self._interval = interval
        self._offsets: Dict[str, int] = {}
        self._stop = threading.Event()
        self._emit_lock = threading.Lock()
        rate = (GLOBAL_CONFIG.log_to_driver_rate
                if rate_limit is None else rate_limit)
        self._rate = max(1, int(rate))
        self._tokens = float(self._rate)
        self._tokens_t = time.monotonic()
        self._color = (sys.stderr.isatty() if color is None else color)
        self.lines_emitted = 0
        self.lines_dropped = 0
        self._dropped_unreported = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ray_tpu_log_monitor")
        self._thread.start()

    # ------------------------------------------------------------------
    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def flush(self) -> None:
        """One synchronous local scan (tests; shutdown final sweep)."""
        self._scan_local()
        self._report_drops()

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self._scan_local()
            except Exception:
                pass  # a scan hiccup must not kill the monitor
            self._report_drops()
        # final sweep so short-lived runs don't lose trailing output
        try:
            self._scan_local()
        except Exception:
            pass

    def _scan_local(self) -> None:
        if not self._log_dir:
            return
        try:
            names = sorted(os.listdir(self._log_dir))
        except OSError:
            return
        for n in names:
            if not _is_worker_file(n):
                continue
            path = os.path.join(self._log_dir, n)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            pos = self._offsets.get(n, 0)
            if size < pos:  # rotated underneath us
                pos = 0
            if size == pos:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(pos)
                    data = f.read(1 << 20)
            except OSError:
                continue
            last_nl = data.rfind(b"\n")
            if last_nl < 0:
                self._offsets[n] = pos
                continue
            self._offsets[n] = pos + last_nl + 1
            lines = data[:last_nl].decode("utf-8", "replace").split("\n")
            self._emit(n, lines, node_index=0, pool=None)

    # ------------------------------------------------------------------
    def on_remote_lines(self, pool, fname: str, lines) -> None:
        """Entry point for daemon-shipped lines (remote_pool demux)."""
        if not _is_worker_file(fname):
            return
        try:
            self._emit(fname, list(lines), node_index=pool.node_index,
                       pool=pool)
        except Exception:
            pass

    # ------------------------------------------------------------------
    def _emit(self, fname: str, lines, node_index: int, pool) -> None:
        name, task, trace = self._attribute(_wid_of(fname), pool)
        stream = sys.stderr if fname.endswith(".err") else sys.stdout
        prefix = f"({name}, wid={_wid_of(fname)}, node={node_index}"
        # task/trace fields are best-effort attribution like the name:
        # they identify what is leased on that worker NOW, which for a
        # fast task may already be the next one. Short prefixes keep
        # the line greppable against state/trace output.
        if task:
            prefix += f", task={task}"
        if trace:
            prefix += f", trace={trace}"
        prefix += ")"
        if self._color:
            c = _COLORS[node_index % len(_COLORS)]
            prefix = f"\x1b[{c}m{prefix}\x1b[0m"
        out = []
        with self._emit_lock:
            for ln in lines:
                if not self._take_token():
                    self.lines_dropped += 1
                    self._dropped_unreported += 1
                    continue
                self.lines_emitted += 1
                out.append(f"{prefix} {ln}")
        if out:
            try:
                stream.write("\n".join(out) + "\n")
                stream.flush()
            except (OSError, ValueError):
                pass

    def _take_token(self) -> bool:
        now = time.monotonic()
        self._tokens = min(float(self._rate),
                           self._tokens + (now - self._tokens_t)
                           * self._rate)
        self._tokens_t = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def _report_drops(self) -> None:
        with self._emit_lock:
            n, self._dropped_unreported = self._dropped_unreported, 0
        if n:
            try:
                sys.stderr.write(
                    f"(log monitor) dropped {n} lines: output exceeded "
                    f"log_to_driver_rate={self._rate} lines/s\n")
                sys.stderr.flush()
            except (OSError, ValueError):
                pass

    # ------------------------------------------------------------------
    def _attribute(self, wid: str, pool) -> Tuple[str, str, str]:
        """(name, task_id prefix, trace_id prefix) for whatever is
        currently leased on the worker whose id prefix is ``wid`` —
        best-effort: ('worker', '', '') when nothing (or nothing
        anymore) is running there. The trace field only appears for
        sampled tasks, so grep 'trace=<id>' lines line up 1:1 with
        ``ray_tpu_torch.trace()`` span output."""
        h = self._find_handle(wid, pool)
        if h is None:
            return "worker", "", ""
        rt = h.actor_rt
        if rt is not None:
            name = (getattr(rt, "name", None)
                    or getattr(getattr(rt, "cls", None), "__name__", None)
                    or "actor")
            return name, "", ""
        try:
            for inf in h.inflight.values():
                spec = inf.pending.spec
                tctx = getattr(spec, "trace_ctx", None)
                return (spec.name, spec.task_id.hex()[:8],
                        tctx[0][:8] if tctx is not None and tctx[3]
                        else "")
        except (RuntimeError, AttributeError):
            pass  # dict mutated mid-iteration: attribution is advisory
        return "worker", "", ""

    def _find_handle(self, wid: str, pool):
        pools = [pool] if pool is not None else self._pools()
        for p in pools:
            if p is None:
                continue
            with p._lock:
                handles = list(p._by_num.values())
            for h in handles:
                if h.worker_id.hex().startswith(wid):
                    return h
        return None

    def _pools(self):
        w = self._worker
        out = []
        p = getattr(w, "_pool", None)
        if p is not None and hasattr(p, "_by_num"):
            out.append(p)
        for p in list(getattr(w, "_node_pools", {}).values()):
            if hasattr(p, "_by_num"):
                out.append(p)
        return out

"""Log plane: per-process capture files + helpers shared by every layer.

The reference framework treats worker logs as a first-class subsystem
(`python/ray/_private/log_monitor.py`, `ray logs`): every worker
redirects stdout/stderr into per-session files, a monitor tails them
and re-emits on the driver, and the state API / CLI / dashboard read
the same files. This module is the shared substrate for all of that:

- session log directory resolution (`$TMPDIR/ray_tpu_torch/session_*/logs`,
  honoring the ``log_dir`` config knob — erroring loudly if the knob
  is set but the directory cannot be created);
- fd-level stdout/stderr redirection for exec'd processes (``dup2``,
  line-buffered, size-rotated) so ordinary prints AND interpreter
  crash tracebacks land in the files;
- safe file enumeration / tail reads used by ``util.state.list_logs``
  / ``get_log``, the ``python -m ray_tpu_torch logs`` CLI and the dashboard
  (filenames are validated so a query can never escape the log dir).

Everything here is stdlib-only and import-light: worker processes and
node daemons import it before the heavy runtime comes up.
"""

from __future__ import annotations

import io
import os
import re
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

# Env vars the spawners set for exec'd children (worker processes and
# node daemons). Paths are full file paths; rotation knobs ride along
# so children honor the head's config without importing it pre-init.
ENV_LOG_OUT = "RAY_TPU_TORCH_LOG_OUT"
ENV_LOG_ERR = "RAY_TPU_TORCH_LOG_ERR"
ENV_LOG_ROTATE_BYTES = "RAY_TPU_TORCH_LOG_ROTATE_BYTES"
ENV_LOG_ROTATE_BACKUPS = "RAY_TPU_TORCH_LOG_ROTATE_BACKUPS"

_SESSION_DIR_RE = re.compile(r"^session_\d+_\d+$")
_FILENAME_RE = re.compile(r"^[A-Za-z0-9._-]+$")

# The driver-side session log dir for this process, once resolved.
_session_log_dir: Optional[str] = None
_session_lock = threading.Lock()


# ---------------------------------------------------------------------------
# session directory
# ---------------------------------------------------------------------------
def default_root() -> str:
    """The port's session root under the process's temp directory
    (``TMPDIR``); the reference hard-codes ``/tmp/ray_tpu``."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch")


def resolve_session_log_dir(log_dir: str = "",
                            root: Optional[str] = None) -> str:
    """Create and return the session log directory.

    ``log_dir`` (the config knob) wins when non-empty; otherwise a
    fresh ``<root>/session_<epoch_ms>_<pid>/logs`` is created. A knob
    that is set but uncreatable raises RuntimeError instead of
    silently falling back — a configured log dir that quietly ends up
    elsewhere is worse than a crash at init.
    """
    if log_dir:
        try:
            os.makedirs(log_dir, exist_ok=True)
            probe = os.path.join(log_dir, ".probe")
            with open(probe, "w"):
                pass
            os.unlink(probe)
        except OSError as e:
            raise RuntimeError(
                f"log_dir={log_dir!r} is set but not creatable/writable: "
                f"{e}") from e
        return os.path.abspath(log_dir)
    path = os.path.join(root or default_root(),
                        f"session_{int(time.time() * 1000)}_"
                              f"{os.getpid()}", "logs")
    os.makedirs(path, exist_ok=True)
    return os.path.abspath(path)


def set_session_log_dir(path: Optional[str]) -> None:
    global _session_log_dir
    with _session_lock:
        _session_log_dir = path


def get_session_log_dir() -> Optional[str]:
    with _session_lock:
        return _session_log_dir


def latest_session_log_dir(root: Optional[str] = None) -> Optional[str]:
    """Newest ``session_*/logs`` dir under ``root`` (postmortem CLI)."""
    root = root or default_root()
    try:
        names = [n for n in os.listdir(root) if _SESSION_DIR_RE.match(n)]
    except OSError:
        return None
    best = None
    best_mtime = -1.0
    for n in names:
        d = os.path.join(root, n, "logs")
        try:
            m = os.stat(d).st_mtime
        except OSError:
            continue
        if m > best_mtime:
            best, best_mtime = d, m
    return best


# ---------------------------------------------------------------------------
# fd redirection with size rotation (exec'd children)
# ---------------------------------------------------------------------------
class _RotatingFdStream(io.TextIOBase):
    """Line-buffered text stream over a real fd, rotated by size.

    The fd is also ``dup2``'d over the std fd (1 or 2), so writes that
    bypass Python — C extensions, the interpreter's own crash
    traceback — land in the same file. Rotation renames the file
    chain (``f`` -> ``f.1`` -> ... -> ``f.N``), reopens ``f`` and
    re-``dup2``s so the std fd follows the fresh file too.
    """

    def __init__(self, path: str, std_fd: int, rotate_bytes: int,
                 backups: int):
        self._path = path
        self._std_fd = std_fd
        self._rotate_bytes = max(0, int(rotate_bytes))
        self._backups = max(0, int(backups))
        self._lock = threading.Lock()
        self._fd = self._open()
        os.dup2(self._fd, std_fd)

    def _open(self) -> int:
        return os.open(self._path,
                       os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)

    def _maybe_rotate(self) -> None:
        if not self._rotate_bytes:
            return
        try:
            size = os.fstat(self._fd).st_size
        except OSError:
            return
        if size < self._rotate_bytes:
            return
        try:
            if self._backups:
                for i in range(self._backups - 1, 0, -1):
                    src = f"{self._path}.{i}"
                    if os.path.exists(src):
                        os.replace(src, f"{self._path}.{i + 1}")
                os.replace(self._path, f"{self._path}.1")
            else:
                os.unlink(self._path)
        except OSError:
            return
        old = self._fd
        self._fd = self._open()
        os.dup2(self._fd, self._std_fd)
        try:
            os.close(old)
        except OSError:
            pass

    # -- TextIOBase interface ------------------------------------------
    def writable(self) -> bool:  # pragma: no cover - trivial
        return True

    def write(self, s: str) -> int:
        if not isinstance(s, str):
            s = str(s)
        data = s.encode("utf-8", "replace")
        with self._lock:
            self._maybe_rotate()
            os.write(self._fd, data)
        return len(s)

    def flush(self) -> None:
        pass  # os.write is unbuffered

    def fileno(self) -> int:
        return self._fd

    @property
    def name(self) -> str:  # pragma: no cover - introspection only
        return self._path


def redirect_stdio(out_path: str, err_path: str, rotate_bytes: int = 0,
                   backups: int = 0) -> None:
    """Redirect this process's stdout/stderr into capture files.

    Installs ``_RotatingFdStream`` objects as ``sys.stdout`` /
    ``sys.stderr`` and ``dup2``s the file fds over 1 and 2, so both
    Python-level prints and raw-fd writes (including the interpreter's
    fatal tracebacks) are captured, line-buffered.
    """
    sys.stdout = _RotatingFdStream(out_path, 1, rotate_bytes, backups)
    sys.stderr = _RotatingFdStream(err_path, 2, rotate_bytes, backups)


def redirect_stdio_from_env(environ=os.environ) -> bool:
    """Install redirection if the spawner requested it via env vars.

    Returns True if redirection was installed. Called at the very top
    of exec'd entrypoints (worker_process, node_daemon) so every later
    byte — including import-time failures — is captured.
    """
    out = environ.get(ENV_LOG_OUT)
    err = environ.get(ENV_LOG_ERR)
    if not out or not err:
        return False
    try:
        rotate = int(environ.get(ENV_LOG_ROTATE_BYTES, "0") or 0)
        backups = int(environ.get(ENV_LOG_ROTATE_BACKUPS, "0") or 0)
    except ValueError:
        rotate, backups = 0, 0
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    redirect_stdio(out, err, rotate, backups)
    return True


def child_log_env(log_dir: Optional[str], stem: str, rotate_bytes: int,
                  backups: int) -> Dict[str, str]:
    """Env-var block a spawner merges into a child's environment."""
    if not log_dir:
        return {}
    return {
        ENV_LOG_OUT: os.path.join(log_dir, f"{stem}.out"),
        ENV_LOG_ERR: os.path.join(log_dir, f"{stem}.err"),
        ENV_LOG_ROTATE_BYTES: str(int(rotate_bytes)),
        ENV_LOG_ROTATE_BACKUPS: str(int(backups)),
    }


# ---------------------------------------------------------------------------
# file enumeration / reads (state verbs, CLI, dashboard)
# ---------------------------------------------------------------------------
def validate_filename(filename: str) -> str:
    """Reject anything that could escape the log directory."""
    if not filename or not _FILENAME_RE.match(filename) \
            or filename in (".", ".."):
        raise ValueError(f"invalid log filename: {filename!r}")
    return filename


def list_log_files(log_dir: str) -> List[Dict[str, object]]:
    """Enumerate capture files as {filename, size_bytes, mtime} rows."""
    rows: List[Dict[str, object]] = []
    try:
        names = sorted(os.listdir(log_dir))
    except OSError:
        return rows
    for n in names:
        p = os.path.join(log_dir, n)
        try:
            st = os.stat(p)
        except OSError:
            continue
        if not os.path.isfile(p):
            continue
        rows.append({"filename": n, "size_bytes": st.st_size,
                     "mtime": st.st_mtime})
    return rows


def read_log(log_dir: str, filename: str,
             tail: Optional[int] = None) -> str:
    """Read a capture file (optionally only its last ``tail`` lines).

    ``filename`` is validated and the resolved path must stay inside
    ``log_dir`` — state verbs and the dashboard call this with
    user-supplied names.
    """
    validate_filename(filename)
    base = os.path.realpath(log_dir)
    path = os.path.realpath(os.path.join(base, filename))
    if os.path.dirname(path) != base:
        raise ValueError(f"log filename escapes log dir: {filename!r}")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no such log file: {filename!r} in {log_dir}")
    if tail is None:
        with open(path, "r", errors="replace") as f:
            return f.read()
    return "\n".join(tail_file(path, int(tail)))


def tail_file(path: str, n: int, max_bytes: int = 1 << 20) -> List[str]:
    """Last ``n`` lines of ``path`` (reads at most ``max_bytes``)."""
    if n <= 0:
        return []
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            data = f.read()
    except OSError:
        return []
    text = data.decode("utf-8", "replace")
    lines = text.splitlines()
    return lines[-n:]


def err_tail_message(err_path: Optional[str], n: int = 20) -> str:
    """Formatted ``.err`` tail appended to WorkerCrashedError messages.

    Empty string when there is nothing useful to show — callers append
    unconditionally.
    """
    if not err_path:
        return ""
    lines = tail_file(err_path, n)
    if not lines:
        return ""
    body = "\n".join(f"  {ln}" for ln in lines)
    return (f"\n--- last {len(lines)} lines of "
            f"{os.path.basename(err_path)} ---\n{body}")

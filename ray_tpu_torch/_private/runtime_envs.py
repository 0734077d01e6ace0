"""Runtime environments: working_dir + pip, built on demand per node.

Reference surface: the per-node runtime env agent (ray:
python/ray/_private/runtime_env/ — working_dir packages upload once as
content-addressed zips to GCS storage and extract into a per-node
cache; pip environments build per spec and are shared by workers using
the same env).

Here:
  - ``working_dir``: the driver zips the directory (deterministic
    walk), content-addresses it (sha1), and stores the zip in the GCS
    KV under ``env_pkg:<hash>``. Workers fetch the bytes ONCE per node
    (owner RPC for process workers, direct KV for thread mode),
    extract into a per-node cache directory, and put the extracted
    root on sys.path (process workers also chdir for the task's
    duration — thread mode shares one process cwd and only gets the
    sys.path half, same caveat as thread-mode env_vars).
  - ``pip``: a venv per spec hash (``--system-site-packages`` so the
    baked scientific stack stays importable), built on first use per
    node with ``pip install --no-index --no-deps
    --no-build-isolation`` — this environment has NO network egress,
    so requirement strings must be local paths (a wheel or source
    directory); anything else fails with pip's own resolver error.
    The venv's site-packages prepends to sys.path around execution.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import zipfile
from typing import Dict, List, Optional, Tuple

_PKG_PREFIX = b"env_pkg:"
_pack_cache: Dict[str, Tuple[tuple, Tuple[str, bytes]]] = {}
_pack_lock = threading.Lock()

# build artifacts excluded from fingerprints AND packages: pip install
# of a source dir writes egg-info/build into it — fingerprinting those
# would rebuild the venv after every install, forever
_SKIP_DIRS = {"__pycache__", ".git", "build", "dist", ".eggs"}


def _skip(name: str) -> bool:
    return name in _SKIP_DIRS or name.endswith(".egg-info")


def _fingerprint(path: str) -> tuple:
    """(latest mtime, entry count) over a tree, excluding build
    artifacts; tolerant of files vanishing mid-walk."""
    try:
        latest = os.path.getmtime(path)
    except OSError:
        return (0.0, 0)
    count = 0
    for root, dirs, files in os.walk(path):
        dirs[:] = [d for d in dirs if not _skip(d)]
        for name in list(dirs) + list(files):
            count += 1
            try:
                latest = max(latest,
                             os.path.getmtime(os.path.join(root, name)))
            except OSError:
                pass
    return (latest, count)


def package_working_dir(path: str) -> Tuple[str, bytes]:
    """(content hash, zip bytes) for a directory; cached by
    (abspath, latest mtime) so repeat submissions do not re-zip."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env working_dir {path!r} is not a "
                         "directory")
    # deleting sub/old.py bumps only sub's mtime, so the fingerprint
    # counts directory mtimes + entries too
    key = _fingerprint(path)
    with _pack_lock:
        cached = _pack_cache.get(path)
        # one entry PER PATH (validated by fingerprint): per-version
        # caching would retain every edit's zip for the process lifetime
        hit = cached[1] if cached is not None and cached[0] == key \
            else None
    if hit is not None:
        return hit
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if not _skip(d))
            for f in sorted(files):
                full = os.path.join(root, f)
                rel = os.path.relpath(full, path)
                # fixed date: identical content -> identical hash
                info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
                with open(full, "rb") as fh:
                    z.writestr(info, fh.read())
    data = buf.getvalue()
    digest = hashlib.sha1(data).hexdigest()
    with _pack_lock:
        _pack_cache[path] = (key, (digest, data))
    return digest, data


def pip_spec_hash(pip: List[str]) -> str:
    """Spec hash INCLUDING the content fingerprint of local-path
    requirements: editing a local package must build a fresh venv, not
    silently reuse the stale install."""
    parts: List[str] = []
    for req in sorted(pip):
        entry = req
        if os.path.exists(req):
            if os.path.isdir(req):
                latest, count = _fingerprint(req)
            else:
                try:
                    latest, count = os.path.getmtime(req), 1
                except OSError:
                    latest, count = 0.0, 0
            entry = f"{req}@{latest}:{count}"
        parts.append(entry)
    return hashlib.sha1(json.dumps(parts).encode()).hexdigest()


class EnvManager:
    """Per-process environment cache (one per worker process / driver).
    The cache DIRECTORY is per-node shared (tempdir namespaced by uid)
    so sibling workers reuse extractions and venvs."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir or os.path.join(
            tempfile.gettempdir(), f"ray_tpu_envs_{os.getuid()}")
        os.makedirs(os.path.join(self.cache_dir, "locks"), exist_ok=True)
        self._lock = threading.Lock()

    class _file_lock:
        """fcntl lock: the cache directory is shared by every worker
        PROCESS on the node, so builds/extractions need OS-level mutual
        exclusion, not just an in-process lock."""

        def __init__(self, cache_dir: str, name: str):
            self._path = os.path.join(cache_dir, "locks", name + ".lock")

        def __enter__(self):
            import fcntl

            self._f = open(self._path, "a")
            fcntl.flock(self._f.fileno(), fcntl.LOCK_EX)
            return self

        def __exit__(self, *exc):
            import fcntl

            fcntl.flock(self._f.fileno(), fcntl.LOCK_UN)
            self._f.close()
            return False

    # -- working_dir ----------------------------------------------------
    def ensure_working_dir(self, pkg_hash: str, fetch) -> str:
        """Extracted directory for a package hash; ``fetch()`` returns
        the zip bytes when not cached locally."""
        dest = os.path.join(self.cache_dir, f"wd_{pkg_hash}")
        marker = os.path.join(dest, ".ready")
        with self._lock, self._file_lock(self.cache_dir,
                                         f"wd_{pkg_hash}"):
            if os.path.exists(marker):
                return dest
            data = fetch()
            if data is None:
                raise RuntimeError(
                    f"runtime_env package {pkg_hash} not found in the "
                    "cluster KV store")
            import shutil

            tmp = f"{dest}.tmp.{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            with zipfile.ZipFile(io.BytesIO(data)) as z:
                z.extractall(tmp)
            # a partial dest (crashed extraction: no .ready) is replaced
            shutil.rmtree(dest, ignore_errors=True)
            os.replace(tmp, dest)
            open(marker, "w").close()
        return dest

    # -- pip ------------------------------------------------------------
    def ensure_pip(self, pip: List[str]) -> str:
        """site-packages path of the venv for this spec, building it on
        first use (local-path requirements only: no network egress)."""
        spec_hash = pip_spec_hash(pip)
        env_dir = os.path.join(self.cache_dir, f"pip_{spec_hash}")
        marker = os.path.join(env_dir, ".ready")
        with self._lock, self._file_lock(self.cache_dir,
                                         f"pip_{spec_hash}"):
            if not os.path.exists(marker):
                log_path = env_dir + ".log"
                with open(log_path, "ab") as log:
                    if not os.path.exists(
                            os.path.join(env_dir, "bin", "python")):
                        subprocess.run(
                            [sys.executable, "-m", "venv",
                             "--system-site-packages", env_dir],
                            check=True, stdout=log, stderr=log)
                    env_python = os.path.join(env_dir, "bin", "python")
                    r = subprocess.run(
                        [env_python, "-m", "pip", "install",
                         "--no-index", "--no-deps",
                         "--no-build-isolation", *pip],
                        stdout=log, stderr=log)
                if r.returncode != 0:
                    tail = open(log_path, "rb").read()[-2000:]
                    raise RuntimeError(
                        "runtime_env pip install failed (no network "
                        "egress: requirements must be local wheel/dir "
                        f"paths):\n{tail.decode(errors='replace')}")
                open(marker, "w").close()
        vi = sys.version_info
        return os.path.join(env_dir, "lib",
                            f"python{vi.major}.{vi.minor}",
                            "site-packages")


_manager: Optional[EnvManager] = None
_manager_lock = threading.Lock()


def get_manager() -> EnvManager:
    global _manager
    with _manager_lock:
        if _manager is None:
            _manager = EnvManager()
        return _manager


class applied_env:
    """Context manager applying working_dir/pip around one execution:
    sys.path entries prepend (and pop after); process workers also
    chdir (``use_cwd=True`` — thread mode shares the process cwd and
    must not)."""

    def __init__(self, working_path: Optional[str],
                 site_packages: Optional[str], use_cwd: bool):
        self._wd = working_path
        self._sp = site_packages
        self._use_cwd = use_cwd
        self._prev_cwd: Optional[str] = None
        self._added: List[str] = []

    def __enter__(self):
        for p in (self._sp, self._wd):
            if p is not None:
                sys.path.insert(0, p)
                self._added.append(p)
        if self._wd is not None and self._use_cwd:
            self._prev_cwd = os.getcwd()
            os.chdir(self._wd)
        return self

    def __exit__(self, *exc):
        if self._prev_cwd is not None:
            try:
                os.chdir(self._prev_cwd)
            except OSError:
                pass
        for p in self._added:
            try:
                sys.path.remove(p)
            except ValueError:
                pass
        # purge modules imported FROM the env: workers are reused
        # across tasks with different (or no) runtime_envs, and
        # sys.modules caching would leak this env's imports into them
        # (the reference isolates by keying worker processes on the
        # env; module purge gives the same import-visibility contract)
        if self._added:
            prefixes = tuple(os.path.abspath(p) + os.sep
                             for p in self._added)
            for name, mod in list(sys.modules.items()):
                f = getattr(mod, "__file__", None)
                if f and os.path.abspath(f).startswith(prefixes):
                    del sys.modules[name]
        return False


def kv_key(pkg_hash: str) -> bytes:
    return _PKG_PREFIX + pkg_hash.encode()

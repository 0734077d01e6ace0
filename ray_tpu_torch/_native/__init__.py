"""Native (C++) host components of the runtime, loaded through ctypes.

The reference's hot runtime paths are C++ (plasma allocator, raylet);
here the shm arena's allocator core (``allocator.cc``) and Data's
shuffle gathers (``exchange.cc``) are C++ too, each
compiled with ``g++`` at first use into ``ray_tpu_torch/_build/``
(listed in .gitignore), cached by a hash of its source and flags, and
installed with a per-pid temporary and ``os.replace`` so concurrent
builders never load each other's half-written output. A missing compiler
degrades to ``shm_store.PyFreeList``, whose first-fit semantics are
identical (tests hold the two to the same offsets), and to the numpy
PRP of ``data/_shuffle.py``, which gives the same permutation.

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_libs: dict = {}
_lib_lock = threading.Lock()
_load_failed: set = set()


def target(name: str) -> Path:
    """The library path for ``<name>.cc`` at the current source."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((SRC_DIR / f"{name}.cc").read_bytes())
    return BUILD_DIR / f"native_{name}-{h.hexdigest()[:16]}.so"


def _build(name: str) -> Optional[Path]:
    """g++ <name>.cc into the build dir unless built; None on failure."""
    so = target(name)
    if so.exists():
        return so
    tmp = so.with_suffix(f".so.tmp{os.getpid()}")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, str(SRC_DIR / f"{name}.cc"),
                        "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError) as e:
        detail = ""
        stderr = getattr(e, "stderr", None)
        if stderr:
            detail = ": " + stderr.decode(errors="replace").strip()[:500]
        logger.warning("native %s build failed (%s%s); using the "
                       "Python version", name, e, detail)
        return None
    finally:
        if tmp.exists():
            tmp.unlink()


def load_native_lib(name: str) -> Optional[ctypes.CDLL]:
    """Build-and-load a native component by name, or None."""
    with _lib_lock:
        if name in _libs:
            return _libs[name]
        if name in _load_failed:
            return None
        so = _build(name)
        if so is None:
            _load_failed.add(name)
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            logger.warning("native %s load failed (%s)", name, e)
            _load_failed.add(name)
            return None
        _libs[name] = lib
        return lib


def load_exchange_lib() -> Optional[ctypes.CDLL]:
    """The PRP shuffle kernels (``exchange.cc``), or None (the numpy
    PRP in ``data/_shuffle.py`` then does the same work)."""
    lib = load_native_lib("exchange")
    if lib is not None and not getattr(lib, "_sigs_set", False):
        u64, u32 = ctypes.c_uint64, ctypes.c_uint32
        vp = ctypes.c_void_p
        lib.prp_gather.restype = None
        lib.prp_gather.argtypes = [vp, vp, u32, u64, u64, u64, vp]
        lib.prp_indices.restype = None
        lib.prp_indices.argtypes = [vp, u64, u64, u64, vp]
        lib._sigs_set = True  # AFTER signatures: other threads race here
    return lib


def load_allocator_lib() -> Optional[ctypes.CDLL]:
    """The compiled allocator library, or None."""
    lib = load_native_lib("allocator")
    if lib is None or getattr(lib, "_sigs_set", False):
        return lib
    lib.arena_create.restype = ctypes.c_void_p
    lib.arena_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.arena_destroy.restype = None
    lib.arena_destroy.argtypes = [ctypes.c_void_p]
    lib.arena_alloc.restype = ctypes.c_int64
    lib.arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.arena_free.restype = ctypes.c_int
    lib.arena_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                               ctypes.c_uint64]
    lib.arena_free_bytes.restype = ctypes.c_uint64
    lib.arena_free_bytes.argtypes = [ctypes.c_void_p]
    lib.arena_num_holes.restype = ctypes.c_uint64
    lib.arena_num_holes.argtypes = [ctypes.c_void_p]
    lib._sigs_set = True  # AFTER signatures: other threads race here
    return lib


class NativeFreeList:
    """ctypes wrapper over the C++ arena allocator. Raises ImportError
    at construction if the native library is unavailable."""

    def __init__(self, size: int, align: int = 64):
        lib = load_allocator_lib()
        if lib is None:
            raise ImportError("native allocator unavailable")
        self._lib = lib
        self._handle = lib.arena_create(size, align)

    def allocate(self, nbytes: int) -> int:
        """Offset, or -1 when no hole fits."""
        return self._lib.arena_alloc(self._handle, nbytes)

    def free(self, offset: int, nbytes: int) -> None:
        rc = self._lib.arena_free(self._handle, offset, nbytes)
        if rc != 0:
            raise ValueError(
                f"invalid free: [{offset}, {offset + nbytes}) overlaps "
                "an existing hole (double free?)")

    def free_bytes(self) -> int:
        return self._lib.arena_free_bytes(self._handle)

    def num_holes(self) -> int:
        return self._lib.arena_num_holes(self._handle)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.arena_destroy(self._handle)
                self._handle = None
        except Exception:
            pass

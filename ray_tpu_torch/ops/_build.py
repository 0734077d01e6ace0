"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
under ``ray_tpu_torch/_build/`` (listed in .gitignore) at first use, with a
plain C interface loaded through ``ctypes``: every pointer and the stream
pass as ``c_void_p``, sizes as ``c_int``. No source includes PyTorch's
headers, so a build takes seconds rather than minutes. A library is cached
by a hash of its source, the shared ``csrc/*.cuh`` headers and the
flags; ``build_all`` starts one ``nvcc`` per stale library, all at once.
The attention kernels build one library a head width: ``<name>.cu``
compiled with ``head_dims.defines(D)`` for each width of
``head_dims.SOURCES``, named ``head_dims.library(name, D)``, so the widths
compile in parallel. A failed
build raises with nvcc's stderr. ptxas's register and shared-memory report
(``-Xptxas -v``) is kept beside each library as ``<lib>.log``.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ray_tpu_torch.ops import head_dims

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def count_launch(fn, counter: str = "launches") -> None:
    """Add one to ``fn.launches`` (or another counter of the wrapper's).
    Under a lock: ``+=`` on an attribute is a read and then a write, and
    the wrappers launch from several threads at once (Tune's trials,
    Serve's replicas)."""
    with _count_lock:
        setattr(fn, counter, getattr(fn, counter) + 1)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of ray_tpu_torch "
                       "build on a machine with the CUDA toolkit")


def sources() -> Dict[str, Tuple[Path, Tuple[str, ...]]]:
    """{library name: (its csrc ``.cu``, its -D flags)}: one library a
    width of ``head_dims.SOURCES`` for the attention kernels, one for each
    other source."""
    out = {}
    for p in sorted(CSRC.glob("*.cu")):
        if p.stem in head_dims.SOURCES:
            for D in head_dims.SOURCES[p.stem]:
                out[head_dims.library(p.stem, D)] = (p, head_dims.defines(D))
        else:
            out[p.stem] = (p, ())
    return out


def target(name: str) -> Path:
    """The library path of ``name`` (a key of ``sources()``) at the
    current sources."""
    src, defines = sources()[name]
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every named kernel library (default: all of ``sources()``)
    that is not built yet, one nvcc per library, concurrently. Returns
    {name: library path}."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    out = {n: target(n) for n in names}
    stale = [n for n in names if not out[n].exists()]
    if not stale:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in stale:
        tmp = out[n].with_suffix(f".so.tmp{os.getpid()}")
        src, defines = srcs[n]
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for n, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n} (csrc/{srcs[n][0].name} "
                          f"{' '.join(srcs[n][1])}, rc {proc.returncode})"
                          f":\n{stderr}{stdout}")
            continue
        out[n].with_suffix(".so.log").write_text(stderr + stdout)
        os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_log(name: str) -> str:
    """ptxas's report for the built library ``name``."""
    return target(name).with_suffix(".so.log").read_text()


def _drop_arguments(signature: str) -> str:
    """'void (anonymous namespace)::k<float, (anonymous namespace)::E>(float
    const*, int)' -> 'k<float, (anonymous namespace)::E>': the name without
    return type, namespaces or the trailing argument list."""
    depth = 0
    for i in range(len(signature) - 1, -1, -1):
        if signature[i] == ")":
            depth += 1
        elif signature[i] == "(":
            depth -= 1
            if depth == 0:
                signature = signature[:i]
                break
    # the last '::' outside template arguments
    depth, cut = 0, 0
    for i, ch in enumerate(signature):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0 and signature.startswith("::", i):
            cut = i + 2
    return signature[cut:].removeprefix("void ")


def register_report(name: str) -> Dict[str, str]:
    """{kernel instance: its registers, barriers and spills} from the
    ptxas report of library ``name``. The names are demangled by one
    ``c++filt`` for the whole report (one process a name took seconds
    a library on the H100 host)."""
    lines = build_log(name).splitlines()
    mangled = [m.group(1) for line in lines for m in
               [re.search(r"Compiling entry function '([^']+)'", line)]
               if m]
    names = dict(zip(mangled, mangled))
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and mangled:
        out = subprocess.run([cxxfilt, *mangled], capture_output=True,
                             text=True).stdout.splitlines()
        if len(out) == len(mangled):
            names = {m: _drop_arguments(d.strip()) or m
                     for m, d in zip(mangled, out)}
    report: Dict[str, str] = {}
    fn = None
    for line in lines:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = names[m.group(1)]
        elif fn and ("registers" in line or "spill" in line):
            info = line.split(":")[-1].strip()
            report[fn] = f"{report[fn]}; {info}" if fn in report else info
    return report


def library(name: str,
            signatures: Dict[str, Tuple[object, Sequence[object]]]
            ) -> ctypes.CDLL:
    """Load library ``name`` (building it first if needed)
    and declare ``{function: (restype, argtypes)}`` on it."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            lib.error_string.restype = ctypes.c_char_p
            lib.error_string.argtypes = [ctypes.c_int]
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = list(argtypes)
            _libs[name] = lib
        return lib


def error_string(lib: ctypes.CDLL, code: int) -> str:
    return f"{lib.error_string(code).decode()} (cudaError {code})"

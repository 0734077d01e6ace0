"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
under ``ray_tpu_torch/_build/`` (listed in .gitignore) at first use, with a
plain C interface loaded through ``ctypes``: every pointer and the stream
pass as ``c_void_p``, sizes as ``c_int``. No source includes PyTorch's
headers, so a build takes seconds rather than minutes. A library is cached
by a hash of its source, the shared ``csrc/*.cuh`` headers and the flags;
``build_all`` starts one ``nvcc`` per stale source, all at once. A failed
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of ray_tpu_torch "
                       "build on a machine with the CUDA toolkit")


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu`` at the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [sources()[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every named kernel library (default: all of csrc/) that is
    not built yet, one nvcc per source, concurrently. Returns
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
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(srcs[n])]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for n, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{n}.cu "
                          f"(rc {proc.returncode}):\n{stderr}{stdout}")
            continue
        out[n].with_suffix(".so.log").write_text(stderr + stdout)
        os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_log(name: str) -> str:
    """ptxas's report for the built ``csrc/<name>.cu``."""
    return target(name).with_suffix(".so.log").read_text()


def _drop_arguments(signature: str) -> str:
    """'void (anonymous namespace)::k<float, 128>(float const*, int)' ->
    'k<float, 128>': the name without return type, namespace or the
    trailing argument list."""
    depth = 0
    for i in range(len(signature) - 1, -1, -1):
        if signature[i] == ")":
            depth += 1
        elif signature[i] == "(":
            depth -= 1
            if depth == 0:
                signature = signature[:i]
                break
    return signature.split("::")[-1].removeprefix("void ")


def register_report(name: str) -> Dict[str, str]:
    """{kernel instance: its registers, barriers and spills} from the
    ptxas report of ``csrc/<name>.cu``."""
    cxxfilt = shutil.which("c++filt")
    report: Dict[str, str] = {}
    fn = None
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            if cxxfilt:
                fn = _drop_arguments(subprocess.run(
                    [cxxfilt, fn], capture_output=True,
                    text=True).stdout.strip() or fn)
        elif fn and ("registers" in line or "spill" in line):
            info = line.split(":")[-1].strip()
            report[fn] = f"{report[fn]}; {info}" if fn in report else info
    return report


def library(name: str,
            signatures: Dict[str, Tuple[object, Sequence[object]]]
            ) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library (building it first if needed)
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

"""Build the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc
into its own shared library, ``csrc/_build/lib<name>-<digest>.so``, where
the digest hashes the source and the flags (the content-hashed cache of
the JAX package's native/build.py). The library is loaded with ``ctypes``;
the wrappers declare every pointer and the stream as ``c_void_p``, and
every C entry point returns ``cudaGetLastError()``.

``build_all`` starts one nvcc per source at once and waits for all, so a
cold start costs the slowest build, not their sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")

# Hopper only: sm_90a admits wgmma/setmaxnreg for the kernels that come
# to need them. -Xptxas=-v puts registers, shared memory and spills of
# every kernel into the build log (lib<name>-<digest>.log).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = os.path.join(root, "bin", "nvcc") if root else ""
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def lib_path(name: str) -> str:
    with open(source(name), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def log_path(name: str) -> str:
    return lib_path(name)[:-3] + ".log"


def _start(name: str):
    out = lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-pid tmp: concurrent processes each publish atomically
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = [nvcc(), *NVCC_FLAGS, source(name), "-o", tmp]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    text, _ = proc.communicate()
    with open(log_path(name), "w") as f:
        f.write(text)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{text[-4000:]}")
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> List[str]:
    """Compile every named source that is not built yet, all at once;
    return the library paths."""
    names = list(names)
    with _LOCK:
        started = {n: _start(n) for n in names}
        errors = []
        for n, s in started.items():
            if s is not None:
                try:
                    _finish(n, s)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return [lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[0]
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(path)
                # every source exports bps_error_string(cudaError_t)
                lib.bps_error_string.argtypes = [ctypes.c_int]
                lib.bps_error_string.restype = ctypes.c_char_p
                _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.bps_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

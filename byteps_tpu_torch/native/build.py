"""Build the port's native code at first use: the CUDA kernels of
``csrc/`` with nvcc, and the parameter server ``native/ps.cc`` with g++.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc
into its own shared library, ``csrc/_build/lib<name>-<digest>.so``, where
the digest hashes the source and the flags (the content-hashed cache of
the JAX package's native/build.py). The library is loaded with ``ctypes``;
the wrappers declare every pointer and the stream as ``c_void_p``, and
every C entry point returns ``cudaGetLastError()``.

``build_all`` starts one nvcc per source at once and waits for all, so a
cold start costs the slowest build, not their sum.

``ps.cc`` is host C++ and builds apart from the kernels (``build_ps``),
with the flags and the content-hashed cache of the JAX package's
native/build.py, into ``native/_build/``. The port's ``ps.cc`` is a
byte-identical copy of the JAX package's, so both packages speak one wire.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_DIR)
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
PS_SOURCE = os.path.join(_DIR, "ps.cc")
PS_BUILD_DIR = os.path.join(_DIR, "_build")

# ps.cc builds warning-clean by contract (-Wextra -Werror), with one
# exception: GCC 12 reports (maybe-)uninitialized inside its own AVX-512
# headers (the ``__Y = __Y`` of _mm512_undefined_*), which fails any
# -Werror build of ps.cc's fold kernels there; those two stay warnings. The
# flags are part of the cache hash. -lrt: shm_open on glibc < 2.34; -lz:
# the lossless wire tier's entropy stage.
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall",
            "-Wextra", "-Werror", "-Wno-error=uninitialized",
            "-Wno-error=maybe-uninitialized"]
LDFLAGS = ["-lrt", "-lz"]

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


@contextlib.contextmanager
def on_device(device):
    """The raw handle of ``device``'s current stream, with ``device`` the
    calling thread's current CUDA device for the block. A kernel launches
    on its thread's current device, whatever its stream's; a thread that
    never set one is on device 0, so a wrapper called from it (a Python
    thread of a rank on card 1) would launch for card 1's memory on card
    0. Inside the block the launch goes to the card of the tensors."""
    import torch
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.bps_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _cpu_tag() -> str:
    """The build host's CPU: a -march=native library that moves to
    another host is rebuilt instead of faulting on a smaller ISA."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "Model")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform
    return platform.processor() or platform.machine()


def ps_lib_path() -> str:
    with open(PS_SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(_cpu_tag().encode())
    return os.path.join(PS_BUILD_DIR,
                        f"libbyteps_ps-{h.hexdigest()[:16]}.so")


_PS_LOCK = threading.Lock()


def build_ps() -> str:
    """Compile ``native/ps.cc`` with g++ if it is not built yet; return
    the shared library's path."""
    out = ps_lib_path()
    with _PS_LOCK:
        if os.path.exists(out):
            return out
        os.makedirs(PS_BUILD_DIR, exist_ok=True)
        # per-pid tmp: a server and its workers may build at once
        tmp = f"{out}.tmp.{os.getpid()}"
        try:
            # the host's full ISA first, then baseline, then no librt
            attempts = (
                [*CXXFLAGS, "-march=native", PS_SOURCE, "-o", tmp, *LDFLAGS],
                [*CXXFLAGS, PS_SOURCE, "-o", tmp, *LDFLAGS],
                [*CXXFLAGS, PS_SOURCE, "-o", tmp, "-lz"],
            )
            proc = None
            for args in attempts:
                proc = subprocess.run(["g++", *args], capture_output=True,
                                      text=True)
                if proc.returncode == 0:
                    break
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed for native/ps.cc:\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return out

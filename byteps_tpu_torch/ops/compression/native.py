"""The C++ wire codec of ``native/ps.cc`` (CompressorCfg) on the worker.

Port of byteps_tpu/ops/compression/native.py. The server mirrors every
host codec in C++; the worker's host tier runs the same implementation
through ctypes (``bps_codec_create``/``_wire_bound``/``_compress``/
``_decompress``/``_destroy``, ps.cc:7137-7169) instead of the numpy
pack loops, so the worker and the server agree by construction. The
library is the one the port builds for its PS client
(``native.build.build_ps``).

``make_host_codec`` routes onebit, topk and randomk through it, and
dithering in its default configuration (``partition_type=linear``,
``normalize_type=max``), dense or varint: the max norm is exact in both
tiers and the level arithmetic follows the numpy op order, so the
stochastic draws are bit for bit the numpy tier's. l2's norm (a double
sum in C++ against numpy's f32 pairwise sum) and natural's exp2f/log2f
can differ by an ulp, which can flip a level, so those stay numpy.
BYTEPS_NATIVE_CODEC=0 takes the numpy tier for every codec.

The contract against the numpy tier holds for finite inputs: the
signs, indices, values and levels are the same bytes, and the onebit
scale (a mean, summed in another order) is within an ulp. On NaN
gradients dithering differs (numpy's max propagates a NaN into the norm;
C++ ``std::max`` skips it), as the server's mirror always has.

Unlike the JAX package's loader, a library that does not build or load
raises instead of falling back to numpy.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    """The shared library (built first if needed), with the codec API's
    signatures."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from ...native.build import build_ps
            lib = ctypes.CDLL(build_ps())
            vp = ctypes.c_void_p
            lib.bps_codec_create.restype = vp
            lib.bps_codec_create.argtypes = [ctypes.c_char_p]
            lib.bps_codec_wire_bound.restype = ctypes.c_uint32
            lib.bps_codec_wire_bound.argtypes = [vp]
            lib.bps_codec_compress.restype = ctypes.c_int64
            lib.bps_codec_compress.argtypes = [vp, vp, vp, ctypes.c_uint64]
            lib.bps_codec_decompress.restype = ctypes.c_int
            lib.bps_codec_decompress.argtypes = [vp, vp, ctypes.c_uint32, vp]
            lib.bps_codec_destroy.restype = None
            lib.bps_codec_destroy.argtypes = [vp]
            _lib = lib
        return _lib


class NativeCodec:
    """The ``HostCodec`` surface over one C++ CompressorCfg."""

    def __init__(self, kwargs_wire: str, n: int):
        self._lib = _load()
        self.n = n
        self._kwargs_wire = kwargs_wire
        self._h = self._lib.bps_codec_create(kwargs_wire.encode())
        if not self._h:
            raise ValueError(f"native codec rejected {kwargs_wire!r}")
        self._bound = int(self._lib.bps_codec_wire_bound(self._h))
        # varint dithering's wire is shorter than its bound
        self.variable_wire = "index_coding=varint" in kwargs_wire

    def compress(self, x: np.ndarray, step: int = 0) -> np.ndarray:
        """The wire as a uint8 array (a buffer, like the numpy tier's
        bytes wherever the wire is read)."""
        x = np.ascontiguousarray(x, np.float32)
        if x.size != self.n:
            raise ValueError(f"expected {self.n} elements, got {x.size}")
        out = np.empty(self._bound, np.uint8)
        wl = self._lib.bps_codec_compress(self._h, x.ctypes.data,
                                          out.ctypes.data, step)
        if wl < 0:
            raise RuntimeError("native compress failed")
        return out[:wl]

    def decompress(self, buf) -> np.ndarray:
        raw = np.ascontiguousarray(np.frombuffer(buf, np.uint8))
        out = np.empty(self.n, np.float32)
        if self._lib.bps_codec_decompress(self._h, raw.ctypes.data,
                                          len(raw), out.ctypes.data) != 0:
            raise ValueError("native decompress: bad wire payload")
        return out

    def wire_bytes(self) -> int:
        return self._bound

    def kwargs_wire(self) -> str:
        return self._kwargs_wire

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._h = None
            self._lib.bps_codec_destroy(h)


_NATIVE_OK = ("onebit", "topk", "randomk")


def eligible(kwargs: Dict[str, str]) -> bool:
    """The configurations the C++ codec computes bit for bit as the
    numpy tier does (byteps_tpu/ops/compression/native.py:135)."""
    name = kwargs.get("compressor")
    if name in _NATIVE_OK:
        return True
    if name == "dithering":
        return (kwargs.get("partition_type", "linear") == "linear"
                and kwargs.get("normalize_type", "max") == "max")
    return False


def maybe_native(kwargs: Dict[str, str], kwargs_wire: str,
                 n: int) -> Optional[NativeCodec]:
    """A ``NativeCodec`` for an eligible configuration when
    BYTEPS_NATIVE_CODEC is on (the default), else None."""
    from ...config import native_codec_on
    if not native_codec_on() or not eligible(kwargs):
        return None
    return NativeCodec(kwargs_wire, n)

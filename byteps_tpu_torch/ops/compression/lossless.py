"""Lossless byte-plane wire codec: a plane split, then zlib.

Port of byteps_tpu/ops/compression/lossless.py. A float tensor's bytes
are transposed into planes (plane j holds byte j of every element), so
the sign and exponent bytes, which cluster for gradients, sit together
and deflate well, while the mantissa planes cost little more than their
raw size. The entropy stage is zlib level 1. The stream describes
itself: the producers (this tier and the C++ server's recompress,
native/ps.cc CompressorCfg LOSSLESS) need only write decodable bytes,
and the reconstruction is bitwise exact by construction (NaN payloads,
-0.0, subnormals and inf come back as they went).

Wire layout (little-endian, ps.cc kLosslessHdr):

    [u32 n_elems][u8 mode][u8 nplanes][u16 reserved]
    [u32 plane_len[nplanes]][plane bytes ...]

mode 1: deflated planes; mode 0: the raw planes, when deflate does not
pay, so ``wire_bytes()`` (header + raw bytes) bounds every wire.

The PS tier (``HostLossless``) is f32 like every host codec; the byte
transform itself takes any element width (bf16 has 2 planes).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# [u32 n][u8 mode][u8 nplanes][u16 rsvd], then a u32 length per plane
_HDR = struct.Struct("<IBBH")
# zlib level 1, as the server's recompress
_LEVEL = 1


def plane_split(raw: np.ndarray, itemsize: int) -> list:
    """The byte planes of a flat uint8 buffer of ``itemsize``-byte
    elements: plane j is byte j of every element, each contiguous."""
    if raw.size % itemsize:
        raise ValueError(f"buffer of {raw.size} bytes is not a whole "
                         f"number of {itemsize}-byte elements")
    mat = raw.reshape(-1, itemsize)
    return [np.ascontiguousarray(mat[:, j]) for j in range(itemsize)]


def plane_join(planes: list, itemsize: int) -> np.ndarray:
    """The inverse of :func:`plane_split`: the element bytes (uint8)."""
    out = np.empty((len(planes[0]), itemsize), np.uint8)
    for j, p in enumerate(planes):
        out[:, j] = p
    return out.reshape(-1)


def encode_planes(raw: np.ndarray, itemsize: int) -> bytes:
    """A flat uint8 view of the element bytes -> the wire."""
    planes = plane_split(np.ascontiguousarray(raw, np.uint8), itemsize)
    n = len(planes[0]) if planes else 0
    packed = [zlib.compress(p.tobytes(), _LEVEL) for p in planes]
    mode = 1 if sum(len(b) for b in packed) < raw.size else 0
    if mode == 0:
        packed = [p.tobytes() for p in planes]
    head = _HDR.pack(n, mode, itemsize, 0)
    lens = struct.pack(f"<{itemsize}I", *[len(b) for b in packed])
    return head + lens + b"".join(packed)


def decode_planes(buf, itemsize: int) -> np.ndarray:
    """The wire -> the flat uint8 element bytes. A header, plane table or
    plane length that does not parse raises ``ValueError``, a corrupt
    deflate stream ``zlib.error``."""
    buf = bytes(buf)
    if len(buf) < _HDR.size:
        raise ValueError("lossless wire: truncated header")
    n, mode, nplanes, _rsvd = _HDR.unpack_from(buf)
    if nplanes != itemsize or mode > 1:
        raise ValueError(
            f"lossless wire: bad header (mode={mode} nplanes={nplanes}, "
            f"expected {itemsize} planes)")
    off = _HDR.size + 4 * nplanes
    if len(buf) < off:
        raise ValueError("lossless wire: truncated plane table")
    lens = struct.unpack_from(f"<{nplanes}I", buf, _HDR.size)
    if off + sum(lens) != len(buf):
        raise ValueError("lossless wire: plane lengths disagree with "
                         "payload size")
    planes = []
    for ln in lens:
        chunk = buf[off:off + ln]
        if mode:
            chunk = zlib.decompress(chunk)      # zlib.error if corrupt
        if len(chunk) != n:
            raise ValueError("lossless wire: plane inflated to "
                             f"{len(chunk)} bytes, expected {n}")
        planes.append(np.frombuffer(chunk, np.uint8))
        off += ln
    if n == 0:
        return np.zeros(0, np.uint8)
    return plane_join(planes, itemsize)


class HostLossless:
    """The PS wire tier over f32 partitions, with the ``HostCodec``
    surface (``compress(x, step) -> bytes``, ``decompress(buf) ->
    f32[n]``)."""

    # the compressed planes are shorter than the bound, the raw mode 0
    variable_wire = True

    def __init__(self, n: int):
        self.n = n

    def compress(self, x: np.ndarray, step: int = 0) -> bytes:
        x = np.ascontiguousarray(x, np.float32)
        if x.size != self.n:
            raise ValueError(f"lossless codec sized for {self.n} elems, "
                             f"got {x.size}")
        return encode_planes(x.view(np.uint8).reshape(-1), 4)

    def decompress(self, buf) -> np.ndarray:
        out = decode_planes(buf, 4).view(np.float32)
        if out.size != self.n:
            raise ValueError(f"lossless wire decoded {out.size} elems, "
                             f"expected {self.n}")
        return out

    def wire_bytes(self) -> int:
        # the bound (the raw mode 0), ps.cc's WireLen(): header, plane
        # table and 4n raw bytes
        return _HDR.size + 4 * 4 + 4 * self.n

    def kwargs_wire(self) -> str:
        return f"compressor=lossless;n={self.n}"

"""Host-side wire codecs: the wire format of the PS path.

Port of byteps_tpu/ops/compression/host.py: ``make_host_codec`` for
onebit, topk, randomk, dithering (dense or varint index coding) and
lossless, with the error-feedback and Nesterov momentum wrappers
(``HostErrorFeedback``, ``HostNesterovMomentum``). The host-codec tier
(``server/compressed.py``, ``device_compress=False``) compresses with
them in the scheduler's COMPRESS and DECOMPRESS stages, through the C++
codec of ``native/ps.cc`` where it computes the same bytes
(``native.py``; BYTEPS_NATIVE_CODEC=0 keeps numpy). The device tier
(``training/device_compression.py``) compresses on the card; it reads a
host codec only for ``kwargs_wire()`` (the codec configuration sent
in-band to the server, operations.cc:396-408) and ``wire_bytes()`` (the
size of a reply). The numpy ``compress``/``decompress`` are also the
golden model the tests hold the other tiers against. They round each f32
operation as written, as the JAX package's numpy codecs and the C++
server do.

Wire layouts (little-endian), shared with the JAX package and the C++
server (native/ps.cc CompressorCfg):

- onebit:    uint32 bits[ceil(n/32)], then f32 scale
- topk:      int32 idx[k] ascending, then f32 val[k] (``HostTopk.select``)
- randomk:   int32 idx[k], then f32 val[k] (``rng.np_index_parallel``)
- dithering: int8 levels[n], then f32 norm; with ``index_coding=varint``
             u32 nnz, the LEB128 gaps between the nonzero indices, their
             int8 levels, then f32 norm (a wire of variable length,
             ``wire_bytes()`` its bound)
- lossless:  ``lossless.py``
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .codecs import resolve_k
from .rng import np_index_parallel, np_uniform_parallel


class HostCodec:
    """Base: compress(x, step) -> bytes; decompress(buf) -> f32[n]."""

    n: int
    # a wire that may be shorter than ``wire_bytes()``, its bound
    variable_wire = False

    def compress(self, x: np.ndarray, step: int = 0) -> bytes:
        raise NotImplementedError

    def decompress(self, buf) -> np.ndarray:
        raise NotImplementedError

    def wire_bytes(self) -> int:
        raise NotImplementedError

    def kwargs_wire(self) -> str:
        """Serialized config for the server (parsed by ps.cc)."""
        raise NotImplementedError


@dataclasses.dataclass
class HostOnebit(HostCodec):
    n: int
    scaled: bool = True

    def compress(self, x: np.ndarray, step: int = 0) -> bytes:
        x = np.ascontiguousarray(x, np.float32)
        scale = np.float32(np.mean(np.abs(x))) if self.scaled \
            else np.float32(1.0)
        signs = np.ones(self.n + (-self.n) % 32, np.uint8)  # pad packs as 1
        np.greater_equal(x, 0, out=signs[: self.n])
        # little-endian bit order is the u32-LE "bit i of word w =
        # element 32w + i" layout, byte for byte
        return np.packbits(signs, bitorder="little").tobytes() \
            + scale.tobytes()

    def decompress(self, buf) -> np.ndarray:
        raw = np.frombuffer(buf, np.uint8)
        scale = raw[-4:].view(np.float32)[0]
        signs = np.unpackbits(raw[:-4], bitorder="little", count=self.n)
        return np.array([-scale, scale], np.float32)[signs]

    def wire_bytes(self) -> int:
        return ((self.n + 31) // 32) * 4 + 4

    def kwargs_wire(self) -> str:
        return (f"compressor=onebit;n={self.n};"
                f"scaling={1 if self.scaled else 0}")


@dataclasses.dataclass
class HostTopk(HostCodec):
    n: int
    k: int

    @staticmethod
    def select(x: np.ndarray, k: int) -> np.ndarray:
        """int32 [k], ascending: the top k by (|x| descending, index
        ascending), the comparator of the JAX package's ``HostTopk`` and
        of the C++ server (a NaN ranks below every number). It takes the
        k-th largest |x| by a partition, every |x| above it, then the
        elements equal to it in index order: the same set as a full
        lexsort, in O(n)."""
        a = np.abs(np.asarray(x, np.float32))
        a[np.isnan(a)] = -1.0
        n = a.shape[0]
        if k >= n:
            return np.arange(n, dtype=np.int32)
        t = np.partition(a, n - k)[n - k]
        above = np.flatnonzero(a > t)
        ties = np.flatnonzero(a == t)[: k - above.size]
        return np.sort(np.concatenate([above, ties])).astype(np.int32)

    def compress(self, x: np.ndarray, step: int = 0) -> bytes:
        x = np.ascontiguousarray(x, np.float32)
        idx = self.select(x, self.k)
        return idx.tobytes() + x[idx].astype(np.float32).tobytes()

    def decompress(self, buf) -> np.ndarray:
        raw = np.frombuffer(buf, np.uint8)
        out = np.zeros(self.n, np.float32)
        out[raw[: 4 * self.k].view(np.int32)] = raw[4 * self.k:].view(
            np.float32)
        return out

    def wire_bytes(self) -> int:
        return self.k * 8

    def kwargs_wire(self) -> str:
        return f"compressor=topk;n={self.n};k={self.k}"


@dataclasses.dataclass
class HostRandomk(HostCodec):
    n: int
    k: int
    seed: int = 0

    def indices(self, step: int) -> np.ndarray:
        return np_index_parallel(self.seed, self.k, self.n, mix=step)

    def compress(self, x: np.ndarray, step: int = 0) -> bytes:
        x = np.ascontiguousarray(x, np.float32)
        idx = self.indices(step)
        return idx.tobytes() + x[idx].astype(np.float32).tobytes()

    def decompress(self, buf) -> np.ndarray:
        raw = np.frombuffer(buf, np.uint8)
        out = np.zeros(self.n, np.float32)
        out[raw[: 4 * self.k].view(np.int32)] = raw[4 * self.k:].view(
            np.float32)
        return out

    def wire_bytes(self) -> int:
        return self.k * 8

    def kwargs_wire(self) -> str:
        return f"compressor=randomk;n={self.n};k={self.k};seed={self.seed}"


def _varint_encode(vals: np.ndarray) -> np.ndarray:
    """LEB128 bytes of nonnegative int64 values, one numpy pass per byte
    position (at most 5 for a gap below 2^35)."""
    vals = np.asarray(vals, np.int64)
    if vals.size == 0:
        return np.zeros(0, np.uint8)
    nb = np.ones(vals.shape, np.int64)
    v = vals >> 7
    while v.any():
        nb += v > 0
        v >>= 7
    ends = np.cumsum(nb)
    out = np.zeros(int(ends[-1]), np.uint8)
    starts = ends - nb
    for j in range(int(nb.max())):
        sel = nb > j
        byte = (vals[sel] >> (7 * j)) & 0x7F
        cont = np.where(j < nb[sel] - 1, 0x80, 0)
        out[starts[sel] + j] = (byte | cont).astype(np.uint8)
    return out


def _varint_decode(buf_u8: np.ndarray, count: int):
    """(int64 values[count], bytes read): the first ``count`` LEB128
    values of ``buf_u8``. A stream with fewer raises, as does a value
    of more than 6 bytes (the C++ decoder's cap: values stay below 2^42,
    so their cumulative sum cannot wrap an index negative)."""
    if count == 0:
        return np.zeros(0, np.int64), 0
    ends = np.flatnonzero((buf_u8 & 0x80) == 0)
    if len(ends) < count:
        raise ValueError("truncated varint stream")
    last = int(ends[count - 1])
    b = buf_u8[: last + 1].astype(np.int64)
    starts = np.concatenate(([0], ends[:count - 1] + 1))
    gid = np.zeros(last + 1, np.int64)
    gid[starts[1:]] = 1
    gid = np.cumsum(gid)
    shift = (np.arange(last + 1) - starts[gid]) * 7
    if int(shift.max(initial=0)) > 35:
        raise ValueError("varint too long")
    vals = np.zeros(count, np.int64)
    np.add.at(vals, gid, (b & 0x7F) << shift)
    return vals, last + 1


@dataclasses.dataclass
class HostDithering(HostCodec):
    n: int
    s: int = 127
    partition: str = "linear"
    normalize: str = "max"
    seed: int = 0
    # "varint": the nonzero levels alone on the wire, their indices
    # delta + LEB128 coded (the reference's coded sparse dithering,
    # impl/dithering.cc:25-80, byte-aligned): about 2 x nnz bytes instead
    # of n. Host and C++ tiers only; the device payload stays dense.
    index_coding: str = "dense"

    def __post_init__(self):
        # the bound of DitheringCodec and of the C++ parser: a level must
        # fit signed int8
        if not 1 <= self.s <= 127:
            raise ValueError(
                f"dithering levels s={self.s} out of range [1, 127] "
                f"(levels ship as signed int8 on the wire)")

    def compress(self, x: np.ndarray, step: int = 0) -> bytes:
        x = np.ascontiguousarray(x, np.float32)
        absx = np.abs(x)
        m = absx.max(initial=np.float32(0))
        if self.normalize == "max":
            norm = m
        else:
            safe_m = np.float32(max(m, 1e-30))   # scale-invariant two-pass
            norm = safe_m * np.float32(
                np.sqrt(np.sum(np.square(absx / safe_m))))
        norm = np.float32(max(norm, 1e-30))
        u = np_uniform_parallel(self.seed, self.n, step)
        scaled = (absx / norm).astype(np.float32)
        if self.partition == "linear":
            # the op order of the device codec, for equal rounding
            pos = scaled * np.float32(self.s)
            floor = np.floor(pos)
            level = floor + (u < (pos - floor)).astype(np.float32)
            level = np.minimum(level, np.float32(self.s))
        else:
            safe = np.maximum(scaled, np.float32(1e-30))
            j = np.clip(np.floor(-np.log2(safe)), 0, 30).astype(np.float32)
            low = np.exp2(-j - 1).astype(np.float32)
            high = np.exp2(-j).astype(np.float32)
            frac = (scaled - low) / (high - low)
            exp = np.where(u < frac, j, j + 1)
            level = np.where(scaled < np.exp2(np.float32(-31.0)),
                             np.float32(0.0), exp + 1.0)
            level = np.clip(level, 0, 126)
        levels = (np.sign(x) * level).astype(np.int8)
        if self.index_coding == "varint":
            nz = np.flatnonzero(levels)
            gaps = np.empty(len(nz), np.int64)
            if len(nz):
                gaps[0] = nz[0] + 1          # from an implicit index -1
                gaps[1:] = np.diff(nz)
            return (np.uint32(len(nz)).tobytes()
                    + _varint_encode(gaps).tobytes()
                    + levels[nz].tobytes() + np.float32(norm).tobytes())
        return levels.tobytes() + np.float32(norm).tobytes()

    def _dense_levels(self, buf) -> tuple:
        """(int8 levels[n], norm) of either wire; a varint wire that does
        not parse raises ``ValueError``."""
        raw = np.frombuffer(buf, np.uint8)
        if self.index_coding != "varint":
            return (raw[: self.n].view(np.int8),
                    raw[self.n: self.n + 4].view(np.float32)[0])
        nnz = int(raw[:4].copy().view(np.uint32)[0])
        if nnz > self.n:
            raise ValueError(f"varint dithering wire: nnz {nnz} > n")
        gaps, used = _varint_decode(raw[4: len(raw) - 4 - nnz], nnz)
        if used != len(raw) - 8 - nnz:
            raise ValueError("varint dithering wire: trailing bytes")
        idx = np.cumsum(gaps) - 1
        if len(idx) and (gaps.min() < 1 or gaps.max() > self.n
                         or idx[-1] >= self.n):
            raise ValueError("varint dithering wire: bad indices")
        lv = np.zeros(self.n, np.int8)
        lv[idx] = raw[4 + used: 4 + used + nnz].view(np.int8)
        return lv, raw[-4:].copy().view(np.float32)[0]

    def decompress(self, buf) -> np.ndarray:
        lv, norm = self._dense_levels(buf)
        lv = lv.astype(np.float32)
        if self.partition == "linear":
            mag = np.abs(lv) / np.float32(self.s)
        else:
            mag = np.where(lv == 0, np.float32(0.0),
                           np.exp2(-(np.abs(lv) - 1.0)).astype(np.float32))
        return (np.sign(lv) * mag * norm).astype(np.float32)

    @property
    def variable_wire(self) -> bool:
        return self.index_coding == "varint"

    def wire_bytes(self) -> int:
        if self.index_coding == "varint":
            # the bound (every level nonzero, gaps of several bytes), as
            # ps.cc's WireLen(); a wire is shorter
            return 2 * self.n + self.n // 64 + 16
        return self.n + 4

    def kwargs_wire(self) -> str:
        extra = ";index_coding=varint" if self.index_coding == "varint" \
            else ""
        return (f"compressor=dithering;n={self.n};s={self.s};"
                f"partition_type={self.partition};"
                f"normalize_type={self.normalize};seed={self.seed}{extra}")


class HostErrorFeedback:
    """Vanilla error feedback (error_feedback.cc:22-43): corrected = grad
    + error; payload = compress(corrected); error = corrected -
    decompress(payload). The state persists across steps per partition."""

    def __init__(self, codec: HostCodec):
        self.codec = codec
        self.error = np.zeros(codec.n, np.float32)

    def compress(self, x: np.ndarray, step: int = 0) -> bytes:
        corrected = x.astype(np.float32) + self.error
        buf = self.codec.compress(corrected, step)
        self.error = corrected - self.codec.decompress(
            np.frombuffer(buf, np.uint8))
        return buf

    def decompress(self, buf) -> np.ndarray:
        return self.codec.decompress(buf)

    @property
    def variable_wire(self) -> bool:
        return self.codec.variable_wire

    def wire_bytes(self) -> int:
        return self.codec.wire_bytes()

    def kwargs_wire(self) -> str:
        return self.codec.kwargs_wire()


class HostNesterovMomentum:
    """Nesterov momentum before error feedback (momentum.h:25-45): m =
    mu * m + g; compress(g + mu * m). It replaces the framework's
    momentum."""

    def __init__(self, inner: HostErrorFeedback, mu: float = 0.9):
        self.inner = inner
        self.mu = np.float32(mu)
        self.m = np.zeros(inner.codec.n, np.float32)

    def compress(self, x: np.ndarray, step: int = 0) -> bytes:
        self.m = self.mu * self.m + x.astype(np.float32)
        return self.inner.compress(x + self.mu * self.m, step)

    def decompress(self, buf) -> np.ndarray:
        return self.inner.decompress(buf)

    @property
    def variable_wire(self) -> bool:
        return self.inner.variable_wire

    def wire_bytes(self) -> int:
        return self.inner.wire_bytes()

    def kwargs_wire(self) -> str:
        return self.inner.kwargs_wire()


def make_host_codec(kwargs: Dict[str, str], n: int):
    """kwargs -> (momentum ->) (EF ->) base codec, in the reference's
    stacking order (compressor_registry.cc:39-56) and with the parameter
    names of ``make_compressor``; the base codec is the C++ one where
    ``native.maybe_native`` gives it. The device tier strips ``ef`` and
    ``momentum`` first: it runs both on the card and asks only for the
    base codec the server mirrors."""
    from . import parse_bool_kwarg, parse_ef_kwarg, parse_momentum_kwarg
    from .native import maybe_native

    name = kwargs.get("compressor")
    if name == "lossless":
        # bitwise round trip: an EF or momentum stack around it is
        # harmless (its error stays 0); the zlib tier is the host's only
        # one, the wire describing itself
        from .lossless import HostLossless
        codec: HostCodec = HostLossless(n=n)
    elif name == "onebit":
        codec = HostOnebit(
            n=n, scaled=parse_bool_kwarg(kwargs, "scaling", "true"))
    elif name == "topk":
        # ``approx`` is the TPU's ApproxTopK in the JAX package; the
        # host tier selects exactly there too
        codec = HostTopk(n=n, k=resolve_k(float(kwargs.get("k", 0.01)), n))
    elif name == "randomk":
        codec = HostRandomk(n=n, k=resolve_k(float(kwargs.get("k", 0.01)), n),
                            seed=int(kwargs.get("seed", 0)))
    elif name == "dithering":
        coding = kwargs.get("index_coding", "dense")
        if coding not in ("dense", "varint"):
            raise ValueError(f"unknown index_coding {coding!r}")
        codec = HostDithering(
            n=n, s=int(kwargs.get("s", kwargs.get("k", 127))),
            partition=kwargs.get("partition_type", "linear"),
            normalize=kwargs.get("normalize_type", "max"),
            seed=int(kwargs.get("seed", 0)), index_coding=coding)
    else:
        raise ValueError(f"unknown compressor {name!r}")
    codec = maybe_native(kwargs, codec.kwargs_wire(), n) or codec
    stack = codec
    if parse_ef_kwarg(kwargs):
        stack = HostErrorFeedback(codec)
    if parse_momentum_kwarg(kwargs):
        if not isinstance(stack, HostErrorFeedback):
            raise ValueError("momentum requires ef=vanilla (reference "
                             "stacking order, compressor.h:28-52)")
        stack = HostNesterovMomentum(
            stack, mu=float(kwargs.get("momentum_mu", 0.9)))
    return stack

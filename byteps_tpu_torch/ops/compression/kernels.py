"""The device codec kernels and their plain PyTorch twins.

- Onebit pack/unpack (``csrc/onebit.cu``) replace the Pallas kernels
  ``onebit_pack``/``onebit_unpack`` of
  byteps_tpu/ops/compression/pallas_kernels.py (B2 and B3 in PERF.md), but
  in the portable word layout: word w, bit j = sign of element 32w + j,
  tail elements counted as 0 (bit 1). Words are int32, a bit-identical
  view of uint32 (torch has little uint32 support, and gloo refuses it).
- ``dithering_levels`` and ``randomk_indices`` (``csrc/counter_rng.cu``)
  replace the Pallas kernels of the same names (B4 and B5): stochastic
  quantization to int8 levels, and randomk's indices, both drawn from the
  counter stream of ``rng.py``. Each kernel runs over a whole round of
  partitions in one launch (``dithering_levels_round``,
  ``randomk_indices_round``, driven by a ``RoundTable``); the
  one-partition wrappers are rounds of one. The ``base`` (the uint32
  stream base of ``rng.uniform_base``) goes by value, or, as an int64
  tensor of one element, is read by the kernel from device memory, as
  are the norms.
- ``fma_scalar`` and ``xla_sum`` (``csrc/counter_rng.cu``) stand for XLA
  fusions of the JAX compressor stacks: the momentum's and the EF LR
  rescale's FMAs, and the tree order of XLA's CPU sum (the onebit scale,
  the dithering L2 norm), rounded as XLA on the CPU rounds them.
- ``dithering_dequantize`` and ``dithering_dequantize_round``
  (``csrc/counter_rng.cu``) turn a dithering round's levels back into f32:
  the aggregate (dec * norm) and, in place, the error-feedback residual
  (x - dec * norm as one FMA), rounded as the JAX package's jitted codec
  rounds them (|lv| * (1/s) for |lv| / s). No TPU kernel stands behind
  them (XLA fuses that code); their twin's FMA is exact
  (``fma_f32_plain``).

Each wrapper takes the plain twin for a tensor on the CPU, launches the
kernel for a CUDA tensor, and raises for anything else; there is no
fallback from one to the other. ``<wrapper>.launches`` counts kernel
launches (for B4, B5 and the dequantization, round launches, whichever
wrapper made them).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import numpy as np
import torch

from ...native import build
from . import rng

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong


def _lib():
    lib = build.load("onebit")
    if not getattr(lib, "_bps_typed", False):
        lib.bps_onebit_pack.argtypes = [_VP, _VP, _LL, _LL, _VP]
        lib.bps_onebit_pack.restype = ctypes.c_int
        lib.bps_onebit_unpack.argtypes = [_VP, _VP, _VP, _LL, _LL, _LL, _VP]
        lib.bps_onebit_unpack.restype = ctypes.c_int
        lib._bps_typed = True
    return lib


def n_words(n: int) -> int:
    return (n + 31) // 32


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def onebit_pack_plain(x: torch.Tensor) -> torch.Tensor:
    """f32 [n] -> int32 words [ceil(n/32)], bit j of word w = (x[32w+j] >= 0)."""
    n = x.shape[0]
    pad = n_words(n) * 32 - n
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    signs = (xp >= 0).to(torch.int64).reshape(-1, 32)
    words = (signs << _shifts(x.device)).sum(dim=1)        # [0, 2^32)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def onebit_unpack_plain(words: torch.Tensor, scale: torch.Tensor,
                        n: int) -> torch.Tensor:
    """int32 words [..., nw] and scale [...] -> f32 [..., n] of +-scale,
    the operations of OnebitCodec.decompress (codecs.py:99-108)."""
    bits = (words.to(torch.int64).unsqueeze(-1) >> _shifts(words.device)) & 1
    signs = bits.to(torch.float32)
    flat = (signs * 2.0 - 1.0).reshape(*words.shape[:-1], -1)[..., :n]
    return flat * scale.unsqueeze(-1)


def _check_cuda(t: torch.Tensor, name: str, dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain twin (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{what}: unsupported device {t.device}")


def onebit_pack(x: torch.Tensor) -> torch.Tensor:
    """Pack the signs of flat f32 ``x`` into int32 words (portable layout)."""
    if x.dim() != 1:
        raise ValueError(f"onebit_pack: expected a flat tensor, got "
                         f"shape {tuple(x.shape)}")
    if not _route(x, "onebit_pack"):
        return onebit_pack_plain(x)
    _check_cuda(x, "onebit_pack", torch.float32)
    n = x.shape[0]
    words = torch.empty(n_words(n), dtype=torch.int32, device=x.device)
    lib = _lib()
    with build.on_device(x.device) as stream:
        onebit_pack.launches += 1
        build.check(lib, lib.bps_onebit_pack(
            x.data_ptr(), words.data_ptr(), n, words.shape[0], stream),
            "onebit_pack")
    return words


onebit_pack.launches = 0


def onebit_unpack(words: torch.Tensor, scale: torch.Tensor,
                  n: int) -> torch.Tensor:
    """int32 words [..., ceil(n/32)] and f32 scale [...] -> f32 [..., n]
    of +-scale (one launch for every row of a gathered batch)."""
    if words.shape[-1] != n_words(n):
        raise ValueError(f"onebit_unpack: {words.shape[-1]} words cannot "
                         f"hold n={n}")
    if tuple(scale.shape) != tuple(words.shape[:-1]):
        raise ValueError(f"onebit_unpack: scale shape {tuple(scale.shape)} "
                         f"!= words batch shape {tuple(words.shape[:-1])}")
    if not _route(words, "onebit_unpack"):
        return onebit_unpack_plain(words, scale, n)
    _check_cuda(words, "onebit_unpack words", torch.int32)
    _check_cuda(scale, "onebit_unpack scale", torch.float32)
    if scale.device != words.device:
        raise ValueError("onebit_unpack: words and scale on different "
                         "devices")
    rows = words.numel() // max(words.shape[-1], 1)
    out = torch.empty(*words.shape[:-1], n, dtype=torch.float32,
                      device=words.device)
    lib = _lib()
    with build.on_device(words.device) as stream:
        onebit_unpack.launches += 1
        build.check(lib, lib.bps_onebit_unpack(
            words.data_ptr(), scale.data_ptr(), out.data_ptr(), n,
            words.shape[-1], rows, stream), "onebit_unpack")
    return out


onebit_unpack.launches = 0


# ------------------------------------------------------------------ #
# the counter stream: dithering levels (B4) and randomk indices (B5)
# ------------------------------------------------------------------ #

PARTITIONS = ("linear", "natural")
# work of one block: kDitherTile and kIndexTile of counter_rng.cu
DITHER_TILE = 4096      # elements: 256 threads x 16
INDEX_TILE = 1024       # indices: 256 threads x 4


def _rng_lib():
    lib = build.load("counter_rng")
    if not getattr(lib, "_bps_typed", False):
        lib.bps_dithering_levels.argtypes = [
            _VP, _VP, _VP, _VP, ctypes.c_int, _LL, _LL, _VP, ctypes.c_uint,
            ctypes.c_float, ctypes.c_int, _VP, _VP]
        lib.bps_dithering_levels.restype = ctypes.c_int
        lib.bps_randomk_indices.argtypes = [
            _VP, _VP, ctypes.c_int, _LL, _LL, _LL, _VP, ctypes.c_uint, _VP,
            _VP]
        lib.bps_randomk_indices.restype = ctypes.c_int
        lib.bps_dithering_dequantize.argtypes = [
            _VP, _VP, _VP, _VP, ctypes.c_int, _LL, _LL, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, _VP, _VP]
        lib.bps_dithering_dequantize.restype = ctypes.c_int
        lib.bps_fma_scalar.argtypes = [_VP, _VP, _VP, _LL, _VP,
                                       ctypes.c_float, _VP]
        lib.bps_fma_scalar.restype = ctypes.c_int
        lib.bps_xla_sum.argtypes = [_VP, _LL, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float, _VP, _LL, _VP, _VP]
        lib.bps_xla_sum.restype = ctypes.c_int
        lib.bps_xla_sum_workspace.argtypes = [_LL]
        lib.bps_xla_sum_workspace.restype = _LL
        lib.bps_capture_id.argtypes = [_VP]
        lib.bps_capture_id.restype = ctypes.c_ulonglong
        lib._bps_typed = True
    return lib


class RoundTable:
    """The descriptor table of one B4 or B5 round: a row of four int64
    per partition, and the prefix sums of the rows' tiles. B4 rows are
    (x offset, n, out offset, norm index), B5 rows (size, k, out offset,
    0). Built on the host once; ``on(device)`` uploads it once per
    device."""

    def __init__(self, rows, tile: int, x_extent: int = 0):
        self.rows = np.asarray(rows, np.int64).reshape(-1, 4)
        if (self.rows < 0).any():
            raise ValueError("round table: negative offset or length")
        work = self.rows[:, 1]
        self.tile_start = np.concatenate(
            [[0], np.cumsum(-(-work // tile))]).astype(np.int64)
        self.out_extent = int((self.rows[:, 2] + work).max(initial=0))
        self.x_extent = x_extent        # elements of x the rows read
        self._dev: Dict[torch.device, tuple] = {}

    def __len__(self) -> int:
        return len(self.rows)

    @property
    def n_tiles(self) -> int:
        return int(self.tile_start[-1])

    def on(self, device) -> tuple:
        """(rows, tile_start) as int64 tensors on ``device``."""
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            t = self._dev[device] = (
                torch.from_numpy(self.rows).to(device),
                torch.from_numpy(self.tile_start).to(device))
        return t


def dithering_table(x_offs, ns, out_offs) -> RoundTable:
    """B4 rows: partition i reads x[x_offs[i]:][:ns[i]] with norms[i] and
    writes its levels at out_offs[i]."""
    x_offs, ns = np.asarray(x_offs, np.int64), np.asarray(ns, np.int64)
    return RoundTable(np.stack([x_offs, ns, np.asarray(out_offs, np.int64),
                                np.arange(len(ns))], axis=1), DITHER_TILE,
                      x_extent=int((x_offs + ns).max(initial=0)))


def randomk_table(sizes, ks, out_offs) -> RoundTable:
    """B5 rows: partition i draws ks[i] indices in [0, sizes[i]) and
    writes them at out_offs[i]."""
    sizes = np.asarray(sizes, np.int64)
    if ((sizes < 1) | (sizes >= 2 ** 32)).any():
        raise ValueError("randomk_indices: a size outside [1, 2^32)")
    return RoundTable(np.stack([sizes, np.asarray(ks, np.int64),
                                np.asarray(out_offs, np.int64),
                                np.zeros_like(sizes)], axis=1), INDEX_TILE)


def _base_arg(base, device) -> tuple:
    """The stream base as (int64 scalar on ``device`` or None, value): a
    one-element tensor is read by the kernel (no host copy, no wait), an
    int goes by value. The caller holds the tensor until it has
    launched."""
    if isinstance(base, torch.Tensor):
        if base.numel() != 1 or base.device != device:
            raise ValueError(f"base: expected one element on {device}, got "
                             f"{tuple(base.shape)} on {base.device}")
        return base.reshape(()).to(torch.int64), 0
    return None, int(base) & rng.M32


def _launch_dithering(x, norms, table, base, s, partition, out,
                      one_n: int = 0) -> None:
    """One B4 launch over ``table``'s rows, or (table None) over one
    partition of ``one_n`` elements with norms[0]."""
    if table is None:
        parts = tile_start = None
        n_parts, n_tiles = 1, -(-one_n // DITHER_TILE)
    else:
        rows, ts = table.on(x.device)
        parts, tile_start = rows.data_ptr(), ts.data_ptr()
        n_parts, n_tiles = len(table), table.n_tiles
    if n_tiles == 0:
        return
    base_t, base_v = _base_arg(base, x.device)
    base_p = None if base_t is None else base_t.data_ptr()
    lib = _rng_lib()
    with build.on_device(x.device) as stream:
        dithering_levels.launches += 1
        build.check(lib, lib.bps_dithering_levels(
            x.data_ptr(), norms.data_ptr(), parts, tile_start, n_parts,
            n_tiles, one_n, base_p, base_v, float(s),
            int(partition == "natural"), out.data_ptr(), stream),
            "dithering_levels")


def _launch_randomk(table, base, out, one_size: int = 0,
                    one_k: int = 0) -> None:
    """One B5 launch over ``table``'s rows, or (table None) over one
    partition of ``one_k`` indices in [0, one_size)."""
    if table is None:
        parts = tile_start = None
        n_parts, n_tiles = 1, -(-one_k // INDEX_TILE)
    else:
        rows, ts = table.on(out.device)
        parts, tile_start = rows.data_ptr(), ts.data_ptr()
        n_parts, n_tiles = len(table), table.n_tiles
    if n_tiles == 0:
        return
    base_t, base_v = _base_arg(base, out.device)
    base_p = None if base_t is None else base_t.data_ptr()
    lib = _rng_lib()
    with build.on_device(out.device) as stream:
        randomk_indices.launches += 1
        build.check(lib, lib.bps_randomk_indices(
            parts, tile_start, n_parts, n_tiles, one_size, one_k, base_p,
            base_v, out.data_ptr(), stream), "randomk_indices")


def dithering_levels_plain(x: torch.Tensor, norm, base, s: int,
                           partition: str = "linear") -> torch.Tensor:
    """f32 [n] -> int8 signed levels [n], with the operations and their
    order of DitheringCodec.compress (byteps_tpu codecs.py:248-275), each
    a rounded f32 step."""
    n = x.shape[0]
    u = rng.uniform_from_hash(rng.counter_hash(
        base if isinstance(base, torch.Tensor) else int(base), n, x.device))
    scaled = x.abs() / norm
    if partition == "linear":
        pos = scaled * float(s)
        floor = torch.floor(pos)
        level = floor + (u < (pos - floor)).to(torch.float32)
        level = torch.clamp_max(level, float(s))
    else:
        safe = torch.clamp_min(scaled, 1e-30)
        j = torch.clamp(torch.floor(-torch.log2(safe)), 0.0, 30.0)
        low = torch.exp2(-j - 1.0)
        high = torch.exp2(-j)
        frac = (scaled - low) / (high - low)
        exp = torch.where(u < frac, j, j + 1.0)
        level = torch.where(scaled < 2.0 ** -31, torch.zeros_like(exp),
                            exp + 1.0)
        level = torch.clamp(level, 0.0, 126.0)
    return (torch.sign(x) * level).to(torch.int8)


def _check_partition(partition: str) -> None:
    if partition not in PARTITIONS:
        raise ValueError(f"dithering_levels: unknown partition "
                         f"{partition!r}")


def dithering_levels(x: torch.Tensor, norm: torch.Tensor, base, s: int,
                     partition: str = "linear") -> torch.Tensor:
    """Fused counter uniform + stochastic quantization: flat f32 ``x``
    [n] -> int8 levels [n]; a round of one partition. ``norm``: f32
    scalar tensor (max or L2 of |x|, computed by the caller); ``s``: the
    level count (linear)."""
    if x.dim() != 1:
        raise ValueError(f"dithering_levels: expected a flat tensor, got "
                         f"shape {tuple(x.shape)}")
    _check_partition(partition)
    if not _route(x, "dithering_levels"):
        return dithering_levels_plain(x, norm, base, s, partition)
    _check_cuda(x, "dithering_levels x", torch.float32)
    if not isinstance(norm, torch.Tensor) or norm.numel() != 1 \
            or norm.device != x.device:
        raise ValueError("dithering_levels: norm must be a one-element "
                         "tensor on x's device")
    norm = norm.reshape(()).to(torch.float32)
    out = torch.empty(x.shape[0], dtype=torch.int8, device=x.device)
    _launch_dithering(x, norm, None, base, s, partition, out,
                      one_n=x.shape[0])
    return out


dithering_levels.launches = 0


def dithering_levels_round_plain(x: torch.Tensor, norms: torch.Tensor,
                                 table: RoundTable, base, s: int,
                                 partition: str,
                                 out: torch.Tensor) -> torch.Tensor:
    """The plain twin of a B4 round: ``dithering_levels_plain`` row by
    row, each partition's levels into its slot of ``out``."""
    for x_off, n, out_off, ni in table.rows.tolist():
        out[out_off: out_off + n] = dithering_levels_plain(
            x[x_off: x_off + n], norms[ni], base, s, partition)
    return out


def dithering_levels_round(x: torch.Tensor, norms: torch.Tensor,
                           table: RoundTable, base, s: int, partition: str,
                           out: torch.Tensor) -> torch.Tensor:
    """B4 over a round in one launch: for every row of ``table`` (see
    ``dithering_table``), the levels of its slice of flat f32 ``x`` under
    its norm in f32 ``norms``, written into its slot of flat int8
    ``out``. The stream base is the round's; each partition counts its
    elements from 0. Returns ``out``."""
    _check_partition(partition)
    for t, name, dt in ((x, "x", torch.float32), (norms, "norms",
                                                  torch.float32),
                        (out, "out", torch.int8)):
        if t.dim() != 1 or t.dtype != dt:
            raise ValueError(f"dithering_levels_round: {name} must be a "
                             f"flat {dt} tensor")
    if x.numel() < table.x_extent or out.numel() < table.out_extent or \
            norms.numel() < len(table):
        raise ValueError("dithering_levels_round: x, out or norms is "
                         "smaller than the table's rows")
    if not _route(x, "dithering_levels_round"):
        return dithering_levels_round_plain(x, norms, table, base, s,
                                            partition, out)
    for t, name in ((x, "x"), (norms, "norms"), (out, "out")):
        _check_cuda(t, f"dithering_levels_round {name}", t.dtype)
        if t.device != x.device:
            raise ValueError("dithering_levels_round: x, norms and out on "
                             "different devices")
    _launch_dithering(x, norms, table, base, s, partition, out)
    return out


# ------------------------------------------------------------------ #
# the dequantization of dithering levels: the aggregate, and the EF
# residual, rounded as the JAX package's jitted codec rounds them
# ------------------------------------------------------------------ #

def dithering_recip(s: int) -> float:
    """1/s rounded to f32 once: XLA folds the codec's |lv| / s into
    |lv| * (1/s). The float is exact in f32, so a product with an f32
    tensor rounds once."""
    return float(np.float32(1) / np.float32(s))


def dithering_dec_plain(levels: torch.Tensor, s: int,
                        partition: str) -> torch.Tensor:
    """int8 levels -> f32 sign(lv) * mag: mag = |lv| * (1/s) (linear) or
    2^-(|lv| - 1) from its exponent bits (natural, exact), 0 for level 0."""
    a = levels.to(torch.int32).abs()
    if partition == "linear":
        mag = a.to(torch.float32) * dithering_recip(s)
    else:
        bits = torch.bitwise_left_shift(128 - a, 23)
        mag = torch.where(a == 0, torch.zeros((), device=a.device),
                          bits.view(torch.float32))
    return torch.sign(levels.to(torch.float32)) * mag


def fma_f32_plain(a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    """a * b + c in one f32 rounding, as a fused multiply-add gives it,
    for f32 tensors. The product of two f32 is exact in f64. The f64 sum
    can round a second time where the exact sum needs more than 53 bits:
    it is made round-to-odd (an inexact sum with an even last bit moves
    one f64 ulp towards the exact value, whose side TwoSum's error
    gives), and a round-to-odd f64 rounds to the nearest f32 exactly,
    since 53 >= 24 + 2."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def dithering_dequantize_plain(levels: torch.Tensor, norm: torch.Tensor,
                               s: int, partition: str,
                               x: torch.Tensor = None) -> torch.Tensor:
    """dec * norm, or with ``x`` the residual fma(-dec, norm, x), as a new
    tensor."""
    dec = dithering_dec_plain(levels, s, partition)
    if x is None:
        return dec * norm
    return fma_f32_plain(-dec, norm, x)


def dithering_dequantize_round_plain(levels: torch.Tensor,
                                     norms: torch.Tensor, table: RoundTable,
                                     s: int, partition: str, x: torch.Tensor,
                                     residual: bool = False) -> torch.Tensor:
    """The plain twin of a dequantization round, row by row."""
    for x_off, n, lv_off, ni in table.rows.tolist():
        xs = x[x_off: x_off + n]
        xs.copy_(dithering_dequantize_plain(
            levels[lv_off: lv_off + n], norms[ni], s, partition,
            xs if residual else None))
    return x


def _launch_dequantize(levels, norms, table, s, partition, x, residual,
                       one_n: int = 0) -> None:
    if table is None:
        parts = tile_start = None
        n_parts, n_tiles = 1, -(-one_n // DITHER_TILE)
    else:
        rows, ts = table.on(x.device)
        parts, tile_start = rows.data_ptr(), ts.data_ptr()
        n_parts, n_tiles = len(table), table.n_tiles
    if n_tiles == 0:
        return
    lib = _rng_lib()
    with build.on_device(x.device) as stream:
        dithering_dequantize.launches += 1
        build.check(lib, lib.bps_dithering_dequantize(
            levels.data_ptr(), norms.data_ptr(), parts, tile_start, n_parts,
            n_tiles, one_n, dithering_recip(s), int(partition == "natural"),
            int(residual), x.data_ptr(), stream), "dithering_dequantize")


def _check_dequantize(levels, norms, x, what: str) -> None:
    for t, name, dt in ((levels, "levels", torch.int8),
                        (norms, "norms", torch.float32),
                        (x, "x", torch.float32)):
        if t.dim() > 1 or t.dtype != dt:
            raise ValueError(f"{what}: {name} must be a flat {dt} tensor")
        if t.device != levels.device:
            raise ValueError(f"{what}: levels, norms and x on different "
                             f"devices")


def dithering_dequantize(levels: torch.Tensor, norm: torch.Tensor, s: int,
                         partition: str = "linear",
                         residual_of: torch.Tensor = None) -> torch.Tensor:
    """Flat int8 ``levels`` [n] and their f32 ``norm`` (one element) ->
    f32 [n], sign(lv) * mag * norm (the codec's decompress); with
    ``residual_of=x`` (flat f32 [n]), x - dec * norm in one rounding,
    written into ``x`` (the error-feedback residual). A round of one
    partition."""
    _check_partition(partition)
    n = levels.shape[0] if levels.dim() == 1 else -1
    if n < 0 or (residual_of is not None and residual_of.shape != (n,)):
        raise ValueError("dithering_dequantize: expected flat levels and "
                         "an x of their length")
    if not isinstance(norm, torch.Tensor) or norm.numel() != 1:
        raise ValueError("dithering_dequantize: norm must be a one-element "
                         "tensor")
    norm = norm.reshape(()).to(torch.float32)
    x = residual_of
    if not _route(levels, "dithering_dequantize"):
        out = dithering_dequantize_plain(levels, norm, s, partition, x)
        return out if x is None else x.copy_(out)
    if x is None:
        x = torch.empty(n, dtype=torch.float32, device=levels.device)
    norm = norm.reshape(1)
    _check_dequantize(levels, norm, x, "dithering_dequantize")
    for t in (levels, x):
        _check_cuda(t, "dithering_dequantize", t.dtype)
    _launch_dequantize(levels, norm, None, s, partition, x,
                       residual_of is not None, one_n=n)
    return x


dithering_dequantize.launches = 0


def dithering_dequantize_round(levels: torch.Tensor, norms: torch.Tensor,
                               table: RoundTable, s: int, partition: str,
                               x: torch.Tensor,
                               residual: bool = False) -> torch.Tensor:
    """The dequantization over a round in one launch: for every row of
    ``table`` (see ``dithering_table``), x[x_off:][:n] = dec * norm, or
    with ``residual`` fma(-dec, norm, x[x_off:][:n]) in place, where dec
    comes from levels[out_off:][:n] and norm is norms[norm index].
    Returns ``x``."""
    _check_partition(partition)
    _check_dequantize(levels, norms, x, "dithering_dequantize_round")
    if x.numel() < table.x_extent or levels.numel() < table.out_extent or \
            norms.numel() < len(table):
        raise ValueError("dithering_dequantize_round: levels, norms or x "
                         "is smaller than the table's rows")
    if not _route(levels, "dithering_dequantize_round"):
        return dithering_dequantize_round_plain(levels, norms, table, s,
                                                partition, x, residual)
    for t in (levels, norms, x):
        _check_cuda(t, "dithering_dequantize_round", t.dtype)
    _launch_dequantize(levels, norms, table, s, partition, x, residual)
    return x


# ------------------------------------------------------------------ #
# the rounding of the compressor stacks' XLA fusions: one-scalar FMAs
# (momentum, the EF LR rescale) and XLA's tree order of a 1-D f32 sum
# ------------------------------------------------------------------ #

def fma_scalar(a, b: torch.Tensor, c: torch.Tensor,
               out: torch.Tensor = None) -> torch.Tensor:
    """fma(a, b, c) = a * b + c in one rounding, elementwise over flat f32
    ``b`` and ``c``; ``a`` a float (rounded to f32) or a one-element f32
    tensor on their device (read there, never on the host). Written into
    ``out`` (which may be ``b`` or ``c``) or a new tensor; returned."""
    if b.dim() != 1 or b.shape != c.shape or b.dtype != torch.float32 or \
            c.dtype != torch.float32 or b.device != c.device:
        raise ValueError("fma_scalar: b and c must be flat f32 tensors of "
                         "one shape on one device")
    if out is None:
        out = torch.empty_like(b)
    a_t = a.reshape(()).to(torch.float32) if isinstance(a, torch.Tensor) \
        else None
    if not _route(b, "fma_scalar"):
        av = a_t if a_t is not None else torch.tensor(float(np.float32(a)))
        return out.copy_(fma_f32_plain(av, b, c))
    for t, name in ((b, "b"), (c, "c"), (out, "out")):
        _check_cuda(t, f"fma_scalar {name}", torch.float32)
    if out.shape != b.shape or out.device != b.device:
        raise ValueError("fma_scalar: out must match b")
    a_p, a_v = None, 0.0
    if a_t is not None:
        if a_t.device != b.device:
            raise ValueError("fma_scalar: a on another device than b")
        a_t = a_t.contiguous()
        a_p = a_t.data_ptr()
    else:
        a_v = float(a)
    lib = _rng_lib()
    with build.on_device(b.device) as stream:
        fma_scalar.launches += 1
        build.check(lib, lib.bps_fma_scalar(
            b.data_ptr(), c.data_ptr(), out.data_ptr(), b.shape[0], a_p, a_v,
            stream), "fma_scalar")
    return out


fma_scalar.launches = 0

# XLA's CPU backend reduces a 1-D sum of more than this many elements in
# windows of this many (its tree-reduction rewrite)
SUM_WINDOW = 32


def _sum_levels(n: int):
    """(elements in, windows out, left padding) of each reduce-window
    level of a sum of ``n``, then the last reduce as one window."""
    levels = []
    while n > SUM_WINDOW:
        m = -(-n // SUM_WINDOW)
        levels.append((n, m, (m * SUM_WINDOW - n) // 2))
        n = m
    levels.append((n, 1, 0))
    return levels


def xla_sum_plain(x: torch.Tensor, square: bool = False,
                  absolute: bool = False) -> torch.Tensor:
    """The plain twin of ``xla_sum``: |x| or x * x first, then each level's
    windows summed column by column, every addition its own f32
    rounding."""
    fused = square and x.numel() <= SUM_WINDOW
    if absolute:
        x = x.abs()
    if square and not fused:
        x = torch.square(x)
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for n, m, lo in _sum_levels(x.numel()):
        xp = torch.nn.functional.pad(x, (lo, m * SUM_WINDOW - n - lo))
        cols = xp.reshape(m, SUM_WINDOW)
        acc = torch.zeros(m, dtype=torch.float32, device=x.device)
        for j in range(SUM_WINDOW):
            if fused:
                acc = fma_f32_plain(cols[:, j], cols[:, j], acc)
            else:
                acc = acc + cols[:, j]
        x = acc
    return acc.reshape(())


# one workspace of xla_sum per (card, stream, graph capture id or 0): the
# stream orders the calls that share one, and the kernel leaves its ticket
# at 0; a capture's own is zeroed by a node of its graph. Kept for the
# process (a graph may replay as long as it lives).
_SUM_WS: Dict[tuple, torch.Tensor] = {}
_SUM_WS_LOCK = threading.Lock()


def _sum_workspace(lib, device, stream: int, n: int) -> torch.Tensor:
    need = lib.bps_xla_sum_workspace(n)
    capture = lib.bps_capture_id(stream) \
        if torch.cuda.is_current_stream_capturing() else 0
    key = (device.index, stream, capture)
    with _SUM_WS_LOCK:
        ws = _SUM_WS.get(key)
        if ws is None or ws.numel() < need:
            ws = _SUM_WS[key] = torch.zeros(max(need, 1024),
                                            dtype=torch.float32,
                                            device=device)
    return ws


def _xla_sum(x: torch.Tensor, square: bool, absolute: bool,
             scale=None) -> torch.Tensor:
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError("xla_sum: expected a flat f32 tensor")
    if not _route(x, "xla_sum") or x.numel() == 0:
        total = xla_sum_plain(x, square, absolute)
        return total if scale is None else total * scale
    x = x.contiguous()
    out = torch.empty((), dtype=torch.float32, device=x.device)
    mode = 2 if square else int(absolute)
    lib = _rng_lib()
    with build.on_device(x.device) as stream:
        ws = _sum_workspace(lib, x.device, stream, x.numel())
        xla_sum.launches += 1
        build.check(lib, lib.bps_xla_sum(
            x.data_ptr(), x.numel(), mode, int(scale is not None),
            0.0 if scale is None else scale, ws.data_ptr(), ws.numel(),
            out.data_ptr(), stream), "xla_sum")
    return out


def xla_sum(x: torch.Tensor, square: bool = False,
            absolute: bool = False) -> torch.Tensor:
    """The sum of flat f32 ``x`` in the order and rounding of XLA's CPU
    backend (``jnp.sum`` under jit): windows of 32 padded around, level by
    level, each window added in order from 0; one launch of
    ``xla_sum_kernel``. ``absolute``: the sum of |x| (the onebit scale's
    ``jnp.abs``, taken at load). ``square``: the sum of ``x * x``, as the
    L2 norm takes it (for at most 32 elements XLA fuses the square into the
    sum's FMAs). A 0-dim f32 tensor on ``x``'s device."""
    return _xla_sum(x, square, absolute)


xla_sum.launches = 0


def xla_mean(x: torch.Tensor, absolute: bool = False) -> torch.Tensor:
    """``jnp.mean`` of flat f32 ``x`` (of |x| with ``absolute``) under jit
    on the CPU: ``xla_sum`` times 1/n, which XLA folds to an f32 constant;
    the kernel takes the product in the same launch."""
    # the float is an f32 value, so the product rounds once in f32
    return _xla_sum(x, False, absolute,
                    scale=float(np.float32(1) / np.float32(x.numel())))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of f32 ``x``, as XLA and the
    card give it (the f64 root rounds to the nearest f32 exactly, since
    53 >= 2 * 24 + 2). PyTorch's vectorized CPU sqrt is not correctly
    rounded."""
    return torch.sqrt(x.double()).float()


def randomk_indices_plain(base, size: int, k: int,
                          device=None) -> torch.Tensor:
    """int32 [k] in [0, size): the counter hash modulo ``size``."""
    h = rng.counter_hash(base if isinstance(base, torch.Tensor)
                         else int(base), k, device)
    return (h % size).to(torch.int32)


def randomk_indices(base, size: int, k: int, device) -> torch.Tensor:
    """k pseudo-random indices in [0, size) on ``device``, bit-identical
    to ``rng.np_index_parallel`` and to the server's re-draw; a round of
    one partition."""
    if not 0 < size < 2 ** 32:
        raise ValueError(f"randomk_indices: size {size} outside "
                         f"[1, 2^32)")
    probe = torch.empty(0, device=device)
    device = probe.device                             # cuda -> cuda:<n>
    if not _route(probe, "randomk_indices"):
        return randomk_indices_plain(base, size, k, device)
    out = torch.empty(k, dtype=torch.int32, device=device)
    _launch_randomk(None, base, out, one_size=size, one_k=k)
    return out


randomk_indices.launches = 0


def randomk_indices_round_plain(table: RoundTable, base,
                                out: torch.Tensor) -> torch.Tensor:
    """The plain twin of a B5 round: ``randomk_indices_plain`` row by
    row, each partition's indices into its slot of ``out``."""
    for size, k, out_off, _ in table.rows.tolist():
        out[out_off: out_off + k] = randomk_indices_plain(base, size, k,
                                                          out.device)
    return out


def randomk_indices_round(table: RoundTable, base,
                          out: torch.Tensor) -> torch.Tensor:
    """B5 over a round in one launch: for every row of ``table`` (see
    ``randomk_table``), its k indices in [0, size) written into its slot
    of flat int32 ``out``. Partitions of equal size draw equal indices
    (they share the round's base). Returns ``out``."""
    if out.dim() != 1 or out.dtype != torch.int32:
        raise ValueError("randomk_indices_round: out must be a flat int32 "
                         "tensor")
    if out.numel() < table.out_extent:
        raise ValueError("randomk_indices_round: out is smaller than the "
                         "table's rows")
    if not _route(out, "randomk_indices_round"):
        return randomk_indices_round_plain(table, base, out)
    _check_cuda(out, "randomk_indices_round out", torch.int32)
    _launch_randomk(table, base, out)
    return out

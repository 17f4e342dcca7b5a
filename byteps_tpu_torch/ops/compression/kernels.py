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
  counter stream of ``rng.py``. Their ``base`` (the uint32 stream base of
  ``rng.uniform_base``) may be an int or an int64 tensor of one element;
  the kernels read it, and ``norm``, from device memory.

Each wrapper takes the plain twin for a tensor on the CPU, launches the
kernel for a CUDA tensor, and raises for anything else; there is no
fallback from one to the other. ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    onebit_pack.launches += 1
    build.check(lib, lib.bps_onebit_pack(x.data_ptr(), words.data_ptr(), n,
                                         words.shape[0], stream),
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
    stream = torch.cuda.current_stream(words.device).cuda_stream
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


def _rng_lib():
    lib = build.load("counter_rng")
    if not getattr(lib, "_bps_typed", False):
        lib.bps_dithering_levels.argtypes = [_VP, _VP, _VP, ctypes.c_float,
                                             ctypes.c_int, _VP, _LL, _VP]
        lib.bps_dithering_levels.restype = ctypes.c_int
        lib.bps_randomk_indices.argtypes = [_VP, ctypes.c_uint, _VP, _LL,
                                            _VP]
        lib.bps_randomk_indices.restype = ctypes.c_int
        lib._bps_typed = True
    return lib


def _base_on(base, device) -> torch.Tensor:
    """The stream base as an int64 scalar on ``device``: a tensor stays
    where it is, an int is written by a fill kernel (no host copy, no
    wait)."""
    if isinstance(base, torch.Tensor):
        if base.numel() != 1 or base.device != device:
            raise ValueError(f"base: expected one element on {device}, got "
                             f"{tuple(base.shape)} on {base.device}")
        return base.reshape(()).to(torch.int64)
    return torch.full((), int(base) & rng.M32, dtype=torch.int64,
                      device=device)


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


def dithering_levels(x: torch.Tensor, norm: torch.Tensor, base, s: int,
                     partition: str = "linear") -> torch.Tensor:
    """Fused counter uniform + stochastic quantization: flat f32 ``x``
    [n] -> int8 levels [n]. ``norm``: f32 scalar tensor (max or L2 of
    |x|, computed by the caller); ``s``: the level count (linear)."""
    if x.dim() != 1:
        raise ValueError(f"dithering_levels: expected a flat tensor, got "
                         f"shape {tuple(x.shape)}")
    if partition not in PARTITIONS:
        raise ValueError(f"dithering_levels: unknown partition "
                         f"{partition!r}")
    if not _route(x, "dithering_levels"):
        return dithering_levels_plain(x, norm, base, s, partition)
    _check_cuda(x, "dithering_levels x", torch.float32)
    if not isinstance(norm, torch.Tensor) or norm.numel() != 1 \
            or norm.device != x.device:
        raise ValueError("dithering_levels: norm must be a one-element "
                         "tensor on x's device")
    norm = norm.reshape(()).to(torch.float32)
    base_t = _base_on(base, x.device)
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.int8, device=x.device)
    lib = _rng_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dithering_levels.launches += 1
    build.check(lib, lib.bps_dithering_levels(
        x.data_ptr(), norm.data_ptr(), base_t.data_ptr(), float(s),
        int(partition == "natural"), out.data_ptr(), n, stream),
        "dithering_levels")
    return out


dithering_levels.launches = 0


def randomk_indices_plain(base, size: int, k: int,
                          device=None) -> torch.Tensor:
    """int32 [k] in [0, size): the counter hash modulo ``size``."""
    h = rng.counter_hash(base if isinstance(base, torch.Tensor)
                         else int(base), k, device)
    return (h % size).to(torch.int32)


def randomk_indices(base, size: int, k: int, device) -> torch.Tensor:
    """k pseudo-random indices in [0, size) on ``device``, bit-identical
    to ``rng.np_index_parallel`` and to the server's re-draw."""
    if not 0 < size < 2 ** 32:
        raise ValueError(f"randomk_indices: size {size} outside "
                         f"[1, 2^32)")
    probe = torch.empty(0, device=device)
    device = probe.device                             # cuda -> cuda:<n>
    if not _route(probe, "randomk_indices"):
        return randomk_indices_plain(base, size, k, device)
    base_t = _base_on(base, device)
    out = torch.empty(k, dtype=torch.int32, device=device)
    lib = _rng_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    randomk_indices.launches += 1
    build.check(lib, lib.bps_randomk_indices(
        base_t.data_ptr(), size, out.data_ptr(), k, stream),
        "randomk_indices")
    return out


randomk_indices.launches = 0

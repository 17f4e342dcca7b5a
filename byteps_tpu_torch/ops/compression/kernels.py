"""Onebit pack/unpack: the CUDA kernels of ``csrc/onebit.cu`` and their
plain PyTorch twins.

They replace the Pallas kernels ``onebit_pack``/``onebit_unpack`` of
byteps_tpu/ops/compression/pallas_kernels.py (B2 and B3 in PERF.md), but
in the portable word layout: word w, bit j = sign of element 32w + j,
tail elements counted as 0 (bit 1). Words are int32, a bit-identical view
of uint32 (torch has little uint32 support, and gloo refuses it).

Each wrapper takes the plain twin for a tensor on the CPU, launches the
kernel for a CUDA tensor, and raises for anything else; there is no
fallback from one to the other. ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...native import build

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

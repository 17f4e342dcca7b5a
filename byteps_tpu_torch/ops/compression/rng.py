"""Counter-based random streams shared by the worker and the C++ server.

Port of byteps_tpu/ops/compression/rng.py, the parallel half: a murmur3
finalizer over the counter ``i * 0x9E3779B1 + base``, where ``base`` is
the low word of the seed's splitmix64 state XOR the round number. The
server (native/ps.cc) draws the same stream to re-derive randomk's
indices, so every implementation here must stay bit-identical to the
numpy goldens ``np_uniform_parallel`` and ``np_index_parallel``.

Torch has almost no uint32 arithmetic, so the torch twins hold each
32-bit value in int64 and mask with 0xFFFFFFFF. A product of two 32-bit
values can reach 2^64 and leave int64's range; ``_mul32`` therefore
multiplies in 16-bit halves, whose partial products stay below 2^49.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF
GOLDEN = 0x9E3779B1          # the counter's stride
MM3_C1 = 0x85EBCA6B          # murmur3 finalizer constants
MM3_C2 = 0xC2B2AE35


def seed_state(seed: int) -> Tuple[int, int]:
    """The 128-bit xorshift state of a seed: splitmix64 twice."""
    state = []
    z = seed & M64
    for _ in range(2):
        z = (z + 0x9E3779B97F4A7C15) & M64
        x = z
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
        state.append(x ^ (x >> 31))
    return state[0], state[1]


def uniform_base(seed: int, mix: int = 0) -> int:
    """The uint32 counter base: the seed state's low word XOR ``mix``
    (the round number)."""
    return (seed_state(seed)[0] & M32) ^ (mix & M32)


# ------------------------------------------------------------------ #
# numpy goldens
# ------------------------------------------------------------------ #

def _np_mm3(h: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint32(16))
        h = (h * np.uint32(MM3_C1)) & np.uint32(M32)
        h = h ^ (h >> np.uint32(13))
        h = (h * np.uint32(MM3_C2)) & np.uint32(M32)
        h = h ^ (h >> np.uint32(16))
    return h


def _np_hash(seed: int, n: int, mix: int) -> np.ndarray:
    base = np.uint32(uniform_base(seed, mix))
    with np.errstate(over="ignore"):
        h = (np.arange(n, dtype=np.uint32) * np.uint32(GOLDEN) + base) \
            & np.uint32(M32)
    return _np_mm3(h)


def np_uniform_parallel(seed: int, n: int, mix: int = 0,
                        dtype=np.float32) -> np.ndarray:
    """n uniforms in [0, 1): the top 24 bits of each hash over 2^24."""
    h = _np_hash(seed, n, mix)
    return ((h >> np.uint32(8)).astype(np.float64)
            / float(1 << 24)).astype(dtype)


def np_index_parallel(seed: int, k: int, size: int,
                      mix: int = 0) -> np.ndarray:
    """k indices in [0, size): the full 32-bit hash modulo size."""
    h = _np_hash(seed, k, mix)
    return (h % np.uint32(size)).astype(np.int32)


# ------------------------------------------------------------------ #
# torch twins (int64 holding uint32)
# ------------------------------------------------------------------ #

def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32) and a 32-bit
    constant ``c``, without leaving int64's range."""
    lo = (h & 0xFFFF) * c                      # < 2^48
    hi = ((h >> 16) * c) & 0xFFFF              # low 16 bits of the top half
    return (lo + (hi << 16)) & M32


def mm3_finalize(h: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer over int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, MM3_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, MM3_C2)
    return h ^ (h >> 16)


Base = Union[int, torch.Tensor]


def counter_hash(base: Base, n: int, device=None) -> torch.Tensor:
    """int64 [n] of hashes of the counters ``i * GOLDEN + base``.
    ``base`` is an int or an int64 tensor of one element (on the device:
    no host read)."""
    if isinstance(base, torch.Tensor):
        device = base.device
        base = base.reshape(()).to(torch.int64) & M32
    else:
        base = int(base) & M32
    i = torch.arange(n, dtype=torch.int64, device=device)
    return mm3_finalize((_mul32(i, GOLDEN) + base) & M32)


def uniform_parallel(seed: int, n: int, mix: int = 0,
                     device=None) -> torch.Tensor:
    """f32 [n], bit-identical to ``np_uniform_parallel``."""
    return uniform_from_hash(counter_hash(uniform_base(seed, mix), n, device))


def uniform_from_hash(h: torch.Tensor) -> torch.Tensor:
    # the top 24 bits are exact in f32, and so is their quotient by 2^24
    return (h >> 8).to(torch.float32) / float(1 << 24)


def index_parallel(seed: int, k: int, size: int, mix: int = 0,
                   device=None) -> torch.Tensor:
    """int32 [k], bit-identical to ``np_index_parallel``."""
    h = counter_hash(uniform_base(seed, mix), k, device)
    return (h % size).to(torch.int32)

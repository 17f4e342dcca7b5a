"""Environment configuration read by the PyTorch port.

Only the knobs the port reads live here, with the same names and defaults
as the JAX package's config (BytePS's global.cc:43 for the compression
threshold). ``BYTEPS_LOG_LEVEL`` is read by ``utils/logging.py``.
"""

from __future__ import annotations

import dataclasses
import os

# Minimum tensor size eligible for compression, in bytes (global.cc:43).
DEFAULT_MIN_COMPRESS_BYTES = 1024000


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


@dataclasses.dataclass(frozen=True)
class Config:
    min_compress_bytes: int = DEFAULT_MIN_COMPRESS_BYTES  # BYTEPS_MIN_COMPRESS_BYTES

    @staticmethod
    def from_env() -> "Config":
        return Config(
            min_compress_bytes=_env_int("BYTEPS_MIN_COMPRESS_BYTES",
                                        DEFAULT_MIN_COMPRESS_BYTES))

"""Shared types of the PS path.

Port of byteps_tpu/core/types.py, trimmed to what the PS train step
reads: the wire dtypes and request types, their Cantor-paired command
word, and the per-tensor and per-partition records. The values are wire
contract with the C++ server (native/ps.cc) and with workers of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np


class DataType(enum.IntEnum):
    """Wire dtypes, in the reference's (mshadow) order (common.h:59-72)."""

    FLOAT32 = 0
    FLOAT64 = 1
    FLOAT16 = 2
    UINT8 = 3
    INT32 = 4
    INT8 = 5
    INT64 = 6
    BFLOAT16 = 7
    UINT16 = 8

    @staticmethod
    def of_torch(dtype) -> "DataType":
        """The wire dtype of a torch dtype; bfloat16 is BFLOAT16 (its bits
        travel as uint16, the server sums through f32)."""
        import torch
        if dtype == torch.bfloat16:
            return DataType.BFLOAT16
        return DataType.from_np(torch.empty((), dtype=dtype).numpy().dtype)

    @staticmethod
    def from_np(dtype) -> "DataType":
        for dt, npd in _NP_DTYPES.items():
            # bfloat16 has no numpy dtype and travels as uint16
            if npd == np.dtype(dtype) and dt != DataType.BFLOAT16:
                return dt
        raise ValueError(f"unsupported dtype {dtype}")


_NP_DTYPES = {
    DataType.FLOAT32: np.dtype(np.float32),
    DataType.FLOAT64: np.dtype(np.float64),
    DataType.FLOAT16: np.dtype(np.float16),
    DataType.UINT8: np.dtype(np.uint8),
    DataType.INT32: np.dtype(np.int32),
    DataType.INT8: np.dtype(np.int8),
    DataType.INT64: np.dtype(np.int64),
    DataType.BFLOAT16: np.dtype(np.uint16),
    DataType.UINT16: np.dtype(np.uint16),
}


class RequestType(enum.IntEnum):
    """PS request types (reference: common.h:267-271)."""

    DEFAULT_PUSH_PULL = 0
    ROW_SPARSE_PUSH_PULL = 1
    COMPRESSED_PUSH_PULL = 2


def get_command_type(req: RequestType, dtype: DataType) -> int:
    """Cantor pairing of (request type, dtype) into one wire int
    (reference: common.cc:98-101)."""
    a, b = int(req), int(dtype)
    return (a + b) * (a + b + 1) // 2 + b


@dataclasses.dataclass
class Partition:
    """One <= partition_bytes slice of a declared tensor: the (key,
    offset, len) triple of TensorTableEntry (common.h:221-264)."""

    key: int          # full PS key: declared_key << 16 | index
    index: int        # partition index within the tensor
    offset: int       # byte offset into the flat tensor
    length: int       # byte length
    server: int = 0   # assigned PS shard


@dataclasses.dataclass
class TensorContext:
    """Per-declared-tensor state (reference BPSContext, common.h:177-205)."""

    name: str
    declared_key: int
    dtype: DataType
    nbytes: int = 0
    partitions: List[Partition] = dataclasses.field(default_factory=list)
    initialized: bool = False
    align_bytes: Optional[int] = None   # row-sparse: whole rows a partition


def host_array(t) -> Tuple[np.ndarray, DataType]:
    """(numpy array, wire dtype) of tensor ``t`` on the host, in its
    shape (a CPU tensor's own memory); bfloat16, which numpy lacks, as its
    bits in uint16 (DataType.BFLOAT16), with no f32 round trip."""
    import torch
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return (t.contiguous().cpu().view(torch.int16).numpy()
                .view(np.uint16), DataType.BFLOAT16)
    host = t.cpu().numpy()
    return host, DataType.from_np(host.dtype)


def host_tensor(a: np.ndarray, dtype: DataType):
    """The inverse of ``host_array``: a CPU tensor over ``a``'s memory."""
    import torch
    a = np.ascontiguousarray(a)
    if dtype == DataType.BFLOAT16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def trunc_divide_inplace(out: np.ndarray, n: int) -> None:
    """``out //= n`` truncating toward zero, the reference's ``div_(size)``
    for integer averaging, exact for every int including the minimum
    (byteps_tpu/core/types.py). Requires n > 0."""
    rem = np.remainder(out, n)
    np.floor_divide(out, n, out=out)
    # trunc = floor + 1 where the division was inexact and negative
    np.add(out, (rem != 0) & (out < 0), out=out, casting="unsafe")

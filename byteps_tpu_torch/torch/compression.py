"""Wire compression of the PyTorch adapter.

Port of byteps_tpu/torch/compression.py (BytePS's
byteps/torch/compression.py:47-76): a ``Compressor`` compresses a
gradient before its push_pull and decompresses the aggregate;
``Compression.fp16`` halves the bytes on the PS wire. The codec stack of
``ops.compression`` is the train steps' path; this is the adapter's knob.
"""

from __future__ import annotations

import torch


class Compressor:
    @staticmethod
    def compress(tensor: torch.Tensor):
        """(compressed tensor, ctx): ctx is what ``decompress`` needs."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """Floating tensors travel as fp16 and come back in their dtype
    (compression.py:47-64)."""

    @staticmethod
    def compress(tensor):
        if tensor.dtype.is_floating_point and tensor.dtype != torch.float16:
            return tensor.to(torch.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is not None:
            return tensor.to(ctx)
        return tensor


class Compression:
    """``compression=Compression.fp16``, as in BytePS."""

    none = NoneCompressor
    fp16 = FP16Compressor

"""byteps_tpu_torch — the PyTorch and CUDA port of byteps_tpu.

It runs the same training steps as the JAX package on an NVIDIA H100:
the Llama model (``models.llama``), a ``DistributedOptimizer`` that
push_pulls gradients, with optional onebit compression and error
feedback, over the ``dp`` process group (``training``), flash attention
(``ops.flash_attention``), and the parameter-server step
(``training.make_ps_train_step``), whose gradients are compressed on the
card (onebit, randomk, dithering) and summed by the C++ server
(``server``, ``native/ps.cc``). The Pallas kernels of the JAX package are
CUDA kernels here (``csrc/``), built with nvcc at first use.

    import byteps_tpu_torch as bps
    bps.init()                       # cuda:<BYTEPS_LOCAL_RANK>, NCCL group;
                                     # PS client too if DMLC_NUM_SERVER > 0
    out = bps.push_pull(grad)        # mean across the dp group
    bps.shutdown()

The package imports ``torch`` and numpy and nothing of JAX.
"""

from __future__ import annotations

from typing import Optional

from .core.state import get_state
from .ops.push_pull import broadcast, push_pull

__all__ = ["init", "shutdown", "rank", "size", "local_rank", "local_size",
           "push_pull", "broadcast"]


def init(device=None, store=None, rank: Optional[int] = None,
         world_size: Optional[int] = None) -> None:
    """Set up the device and the ``dp`` group. ``device`` defaults to
    ``cuda:<local_rank>`` and must be given as ``"cpu"`` to run without a
    card. ``store``/``rank``/``world_size`` override the loopback
    rendezvous and the BYTEPS_LOCAL_* topology (tests pass a FileStore)."""
    get_state().init(device, store=store, rank=rank, world_size=world_size)


def shutdown() -> None:
    get_state().shutdown()


def rank() -> int:
    return get_state().require().local_rank


def size() -> int:
    return get_state().require().local_size


def local_rank() -> int:
    return get_state().require().local_rank


def local_size() -> int:
    return get_state().require().local_size

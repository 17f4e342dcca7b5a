"""A rank of a two-process gloo group for the port's collective tests.

Spawned by tests/test_torch_port_compression.py; it imports only torch,
numpy and byteps_tpu_torch, so a child starts without JAX.
"""

import numpy as np


def grads_for(rank: int):
    rng = np.random.RandomState(100 + rank)
    return (rng.randn(40, 30).astype(np.float32),
            rng.randn(7).astype(np.float32),
            np.array([-3 - rank, 3 + rank, 5], np.int32))


def run_rank(rank: int, world: int, store_path: str, out_path: str) -> None:
    import torch
    import torch.distributed as dist

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.ops.compression import (compressed_psum_tree,
                                                  default_stacks)
    from byteps_tpu_torch.ops.push_pull import psum_tree
    from byteps_tpu_torch.training import broadcast_parameters

    bps.init(device="cpu", store=dist.FileStore(store_path, world),
             rank=rank, world_size=world)
    try:
        a, b, ints = (torch.from_numpy(x) for x in grads_for(rank))
        kw = {"compressor": "onebit", "ef": "vanilla"}
        stacks = default_stacks([a, b], kw, min_compress_bytes=1024)
        states = [s.init_state(g.numel()) if s else {}
                  for g, s in zip((a, b), stacks)]
        out, new_states = compressed_psum_tree(
            [a, b], states, stacks, bps.get_state().group)
        summed = psum_tree({"ints": ints}, average=True)
        mean = bps.push_pull(torch.tensor([float(rank)]))
        params = [torch.full((3,), float(rank))]
        broadcast_parameters(params, root_rank=1)
        np.savez(out_path, a=out[0].numpy(), b=out[1].numpy(),
                 error=new_states[0]["error"].numpy(),
                 ints=summed["ints"].numpy(), mean=mean.numpy(),
                 bcast=params[0].numpy())
    finally:
        bps.shutdown()

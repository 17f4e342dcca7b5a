"""Flash attention: the CUDA forward kernel, its plain twin and the
blockwise backward.

Port of byteps_tpu/ops/flash_attention.py. Interface of the Llama model's
``attn_impl``: q [B,S,H,D], k/v [B,S,Hkv,D] (GQA), scale 1/sqrt(D).

- ``blockwise_attention``: exact attention streaming over KV blocks with
  the streaming-softmax fold (parallel/ring_attention.py). It is the plain
  twin of the kernel and the path the backward differentiates.
- ``flash_attention``: a ``torch.autograd.Function`` whose forward is the
  kernel of ``csrc/flash_attn_fwd.cu`` (B1 in PERF.md, replacing the
  Pallas ``_flash_fwd_kernel``) on a CUDA tensor, or the blockwise path on
  a CPU tensor; the backward recomputes through ``blockwise_attention``,
  the ``custom_vjp`` of the JAX package (flash_attention.py:211-237).
  bf16 runs on the tensor cores (wgmma; 128-row query tiles, 64-key KV
  tiles brought in by TMA, which needs every row of q, k and v to start
  16-byte aligned); f32 runs a CUDA-core kernel.
- ``make_flash_attn``: binds it as the model's ``attn_impl``.

The forward reports its FLOPs (``attention_flops``) to the ledger's count
(``utils/flops.py``): on the card ``FlopCounterMode`` cannot see the
ctypes launch, and on the CPU the blockwise twin's own products count as
the kernel's FLOPs instead. The backward's products are PyTorch's and
count themselves.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..native import build
from ..parallel.ring_attention import NEG_INF, block_attn_accum
from ..utils import flops

TILE = 64   # the kernels' KV tile (and f32 query tile); S must be a multiple
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, block_k: int = 512,
                        remat: bool = True) -> torch.Tensor:
    """Exact attention over KV blocks, computed in fp32, out in q's dtype.
    ``remat`` recomputes each block's fold in the backward instead of
    keeping its [B,H,S,block_k] scores (jax.checkpoint in the JAX
    package)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    groups = H // Hkv
    block_k = min(block_k, S)
    if S % block_k:
        raise ValueError(f"S={S} not divisible by block_k={block_k}")
    scale = 1.0 / np.sqrt(D)
    dev = q.device
    q32 = q.to(torch.float32)
    qpos = torch.arange(S, device=dev)
    kpos_blk = torch.arange(block_k, device=dev)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    o = torch.zeros((B, S, H, D), dtype=torch.float32, device=dev)
    use_ckpt = remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for j in range(S // block_k):
        sl = slice(j * block_k, (j + 1) * block_k)
        # KV stay in compact Hkv heads until the per-block expansion
        kb = k[:, sl].to(torch.float32)
        vb = v[:, sl].to(torch.float32)
        if groups > 1:
            kb = kb.repeat_interleave(groups, dim=2)
            vb = vb.repeat_interleave(groups, dim=2)
        mask = (qpos[:, None] >= (j * block_k + kpos_blk)[None, :]) \
            if causal else None
        if use_ckpt:
            m, l, o = checkpoint(block_attn_accum, q32, kb, vb, mask, m, l,
                                 o, scale, use_reentrant=False)
        else:
            m, l, o = block_attn_accum(q32, kb, vb, mask, m, l, o, scale)
    l = torch.clamp_min(l, 1e-30)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def attention_flops(B: int, S: int, H: int, D: int,
                    causal: bool = True) -> float:
    """The forward's FLOPs: QK^T and PV, 2 * 2 * B * H * S^2 * D, over
    the lower triangle alone when ``causal`` (the kernel skips the tiles
    above it)."""
    full = 4.0 * B * H * S * S * D
    return full / 2 if causal else full


def _lib():
    lib = build.load("flash_attn_fwd")
    if not getattr(lib, "_bps_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.bps_flash_fwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i,
                                      ctypes.POINTER(ctypes.c_longlong),
                                      ctypes.c_float, i, vp]
        lib.bps_flash_fwd.restype = ctypes.c_int
        lib._bps_typed = True
    return lib


def _strides(t: torch.Tensor) -> list:
    """(batch, seq, head) element strides; a dim of size 1 takes the
    stride a contiguous tensor would give it (its own is never used)."""
    st = [t.stride(0), t.stride(1), t.stride(2), 1]
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            st[i] = st[i + 1] * t.shape[i + 1]
    return st[:3]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, block_k: int = 512
                        ) -> torch.Tensor:
    """Attention forward: the kernel for CUDA tensors, the blockwise twin
    for CPU tensors (``block_k`` sizes the twin's blocks; the kernel's
    tiles are fixed)."""
    if q.device.type == "cpu":
        B, S, H, D = q.shape
        with flops.counted_as(attention_flops(B, S, H, D, causal)):
            return blockwise_attention(q, k, v, causal=causal,
                                       block_k=block_k)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B,S,H,D]")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if tuple(k.shape) != (B, S, Hkv, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: H={H} not a multiple of "
                         f"Hkv={Hkv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes bf16 or f32, all alike")
    if D not in (64, 128):
        raise ValueError(f"flash_attention: head dim {D} (kernel: 64, 128)")
    if S % TILE:
        raise ValueError(f"flash_attention: S={S} not a multiple of {TILE}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    strides = [_strides(t) for t in (q, k, v)]
    if q.dtype == torch.bfloat16 and not all(
            t.data_ptr() % 16 == 0 and all(x % 8 == 0 for x in st)
            for t, st in zip((q, k, v), strides)):
        raise ValueError("flash_attention: bf16 q, k, v rows must start "
                         "16-byte aligned (the kernel's TMA copies need it)")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = _lib()
    flops.report(attention_flops(B, S, H, D, causal))
    with build.on_device(q.device) as stream:
        flash_attention_fwd.launches += 1
        build.check(lib, lib.bps_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, S, H, Hkv, D,
            (ctypes.c_longlong * 9)(*(x for st in strides for x in st)),
            float(np.float32(1.0 / np.sqrt(D))), int(causal), stream),
            "flash_attention")
    return out


flash_attention_fwd.launches = 0


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.block_k = causal, block_k
        return flash_attention_fwd(q, k, v, causal, block_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # recompute through the differentiable blockwise path: the same
        # fold, so the gradient is exact for the same function
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = blockwise_attention(*leaves, causal=ctx.causal,
                                      block_k=ctx.block_k)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_k: int = 512) -> torch.Tensor:
    """Flash forward (kernel on the card), blockwise-recompute backward."""
    return _FlashAttention.apply(q, k, v, causal, block_k)


def make_flash_attn(causal: bool = True, block_k: int = 512):
    """Bind ``flash_attention`` as a models.llama ``attn_impl``."""

    def impl(q, k, v):
        return flash_attention(q, k, v, causal, block_k)

    return impl

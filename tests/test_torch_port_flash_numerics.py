"""The bf16 flash kernel's rounding, emulated in plain torch on the CPU,
against the JAX package's ``blockwise_attention``.

The kernel (``byteps_tpu_torch/csrc/flash_attn_fwd.cu``) multiplies bf16
q, k and v on the tensor cores: scores in fp32, the online softmax in fp32
over 64-key tiles (exp2 with the scale folded into log2 e, one FFMA), and
P split into three bf16 terms (hi = p's top 16 bits, mid = bf16(p - hi),
lo = bf16(p - hi - mid)) so that P.V keeps P to 2^-25. The card gate
(chip_smoke.py, tests/test_torch_port_cuda.py) is one bf16 step of the
fp32 result: |got - ref| <= 2^-7 |ref| + 1e-6. This file shows on the
CPU that the design keeps that gate, and that one or two terms would not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops import flash_attention as jfa

KV_TILE = 64
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _top16(x: torch.Tensor) -> torch.Tensor:
    """x's top 16 bits, a bf16 value (the kernel's byte permute)."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def kernel_emulation(q, k, v, causal: bool = True,
                     terms: int = 3) -> torch.Tensor:
    """The kernel's arithmetic on bf16 q [B,S,H,D], k/v [B,S,Hkv,D]; out
    in bf16. P.V sums ``terms`` bf16 products (the kernel: 3; the first
    term keeps p's top 16 bits, the others round what is left)."""
    B, S, H, D = q.shape
    groups = H // k.shape[2]
    q32 = q.float().transpose(1, 2)                               # [B,H,S,D]
    k32 = k.float().repeat_interleave(groups, 2).transpose(1, 2)
    v32 = v.float().repeat_interleave(groups, 2).transpose(1, 2)
    scale_log2 = np.float32(np.float32(1.0 / np.sqrt(D)) * np.float32(LOG2E))
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    for k0 in range(0, S, KV_TILE):
        kt, vt = k32[:, :, k0:k0 + KV_TILE], v32[:, :, k0:k0 + KV_TILE]
        s = q32 @ kt.transpose(-1, -2)                  # raw fp32 scores
        if causal:
            cols = k0 + torch.arange(KV_TILE)[None, :]
            s = torch.where(cols > rows, torch.tensor(NEG_INF), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * float(scale_log2))
        corr = torch.where(m_new == m, torch.ones(()), torch.exp2(m - m_new))
        # one FFMA: s * scale_log2 - m, rounded once
        p = torch.exp2((s.double() * float(scale_log2) - m_new.double())
                       .float())
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr
        rest = p
        for t in range(terms):
            part = _top16(rest) if t == 0 else _bf16(rest)
            acc = acc + part @ vt
            rest = rest - part
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).to(torch.bfloat16)


def _inputs(B, S, H, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, S, h, D).astype(np.float32))
            .to(torch.bfloat16) for h in (H, Hkv, Hkv)]


def _jax_reference(q, k, v, causal):
    as_jnp = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    with jax.default_matmul_precision("float32"):
        out = jfa.blockwise_attention(*as_jnp, causal=causal, block_k=512)
    return torch.from_numpy(np.asarray(out.astype(jnp.float32)))


def _above_one_bf16_step(got, ref):
    return int(((got.float() - ref).abs() > 2.0 ** -7 * ref.abs() + 1e-6)
               .sum())


# (B, S, H, Hkv, D), causal. "short": 128 keys at most, so rows hold few
# keys, outputs cancel towards zero, and P's rounding shows the most.
CASES = {"long": (1, 1024, 2, 1, 128), "short": (16, 128, 8, 1, 128)}


@functools.lru_cache(maxsize=None)
def _case(name):
    q, k, v = _inputs(*CASES[name], seed=0)
    return q, k, v, _jax_reference(q, k, v, True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_term_split_keeps_one_bf16_step_of_jax(name):
    q, k, v, ref = _case(name)
    got = kernel_emulation(q, k, v, causal=True, terms=3)
    assert _above_one_bf16_step(got, ref) == 0


@pytest.mark.parametrize("terms", [1, 2])
def test_fewer_terms_break_the_gate(terms):
    """Why the kernel takes three terms: P cut to one bf16, or to two (16
    bits of its mantissa), lands outputs near zero more than one bf16 step
    from the fp32 result."""
    q, k, v, ref = _case("short")
    got = kernel_emulation(q, k, v, causal=True, terms=terms)
    assert _above_one_bf16_step(got, ref) > 0

"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each wrapper runs its plain twin, so these tests hold the
twins' arithmetic (what the CUDA kernels must reproduce, which
chip_smoke.py and tests/test_torch_port_cuda.py check on the card) against
the JAX codec and the JAX flash attention, including the Pallas kernels
run in interpret mode. Inputs come from numpy with fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops import flash_attention as jfa
from byteps_tpu.ops.compression.codecs import OnebitCodec as JOnebit
from byteps_tpu.ops.compression.pallas_kernels import (
    onebit_pack as j_pallas_pack, onebit_unpack as j_pallas_unpack,
)
from byteps_tpu_torch.ops import flash_attention as tfa
from byteps_tpu_torch.ops.compression import kernels as K
from byteps_tpu_torch.ops.compression.codecs import OnebitCodec


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _signed(n, seed):
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    x[::7] = 0.0                      # zero packs as bit 1
    x[1::11] = -0.0                   # -0.0 >= 0 as well
    return x


@pytest.mark.parametrize("n", [1, 31, 32, 33, 5000, 40000])
def test_onebit_pack_bit_identical_to_jax_portable(n):
    """The port's words are the JAX codec's portable payload bit for bit
    (int32 here, uint32 there), scale included."""
    x = _signed(n, n)
    want = JOnebit(size=n, use_pallas=False).compress(jnp.asarray(x))
    got = OnebitCodec(size=n).compress(torch.from_numpy(x))
    np.testing.assert_array_equal(got["bits"].numpy().view(np.uint32),
                                  np.asarray(want["bits"]))
    # L1 mean: XLA and torch may sum in other orders; one f32 ulp
    np.testing.assert_allclose(got["scale"].numpy(),
                               np.asarray(want["scale"]), rtol=2e-7)
    assert OnebitCodec(size=n).wire_bytes() == \
        JOnebit(size=n, use_pallas=False).wire_bytes()


@pytest.mark.parametrize("n", [100, 40000])
def test_onebit_roundtrip_equals_jax_pallas_interpret(n):
    """Decompressed values equal the JAX Pallas pack/unpack (interpret
    mode): the layouts differ, the signs and scale do not."""
    x = _signed(n, 3 + n)
    scale = np.float32(0.37)
    bits = j_pallas_pack(jnp.asarray(x), True)
    want = np.asarray(j_pallas_unpack(bits, jnp.float32(1.0), n, True)) \
        * scale
    words = K.onebit_pack(torch.from_numpy(x))
    got = K.onebit_unpack(words, torch.tensor(scale), n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_onebit_unpack_gathered_rows():
    """A gathered payload [R, words] with one scale per row unpacks row
    by row, as the JAX vmap over replicas does."""
    n = 1000
    xs = [_signed(n, s) for s in (1, 2, 3)]
    words = torch.stack([K.onebit_pack(torch.from_numpy(x)) for x in xs])
    scales = torch.tensor([0.5, 1.5, 2.0])
    got = K.onebit_unpack(words, scales, n)
    for r, x in enumerate(xs):
        codec = JOnebit(size=n, use_pallas=False)
        payload = codec.compress(jnp.asarray(x))
        payload["scale"] = jnp.float32(scales[r].item())
        np.testing.assert_array_equal(got[r].numpy(),
                                      np.asarray(codec.decompress(payload)))


def test_wrappers_refuse_devices_without_a_kernel_or_twin():
    """CPU -> twin, CUDA -> kernel, anything else raises; no fallback."""
    x = torch.empty(64, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        K.onebit_pack(x)
    with pytest.raises(RuntimeError, match="unsupported device"):
        K.onebit_unpack(torch.empty(2, dtype=torch.int32, device="meta"),
                        torch.empty((), device="meta"), 64)
    q = torch.empty(1, 64, 2, 64, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tfa.flash_attention_fwd(q, q, q)


def test_flash_strides_of_views_and_unit_dims():
    """The strides the kernel is given: a view's own, except that a dim of
    size 1 takes a contiguous tensor's (its own may be anything)."""
    fused = torch.zeros(2, 128, 10, 64)
    assert tfa._strides(fused[:, :, 6:8]) == [128 * 640, 640, 64]
    one = torch.zeros(1, 128, 1, 64).transpose(0, 2)          # [1,128,1,64]
    assert one.stride(0) != 128 * 64
    assert tfa._strides(one) == [128 * 64, 64, 64]


def _qkv(B, S, H, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, S, Hkv, D).astype(np.float32),
            rng.randn(B, S, Hkv, D).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_matches_jax_blockwise(causal):
    q, k, v = _qkv(2, 256, 4, 2, 64, 0)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jfa.blockwise_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_k=128))
    got = tfa.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, block_k=128)
    # fp32 both sides; the einsums sum in other orders
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flash_forward_matches_jax_pallas_interpret():
    """The TPU kernel's math through the Pallas interpreter (S=256,
    blocks of 128, D=64) against the port's CPU forward."""
    q, k, v = _qkv(1, 256, 4, 2, 64, 3)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jfa._flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
            block_q=128, block_k=128, interpret=True))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), True, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flash_gradients_match_jax():
    """The autograd Function's backward (blockwise recompute) against
    jax.grad through the JAX custom_vjp."""
    q, k, v = _qkv(2, 128, 4, 2, 32, 5)
    w = np.random.RandomState(6).randn(2, 128, 4, 32).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, True, 64, 64) * w)

    with jax.default_matmul_precision("float32"):
        want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tfa.flash_attention(*ts, True, 64) * torch.from_numpy(w)).sum() \
        .backward()
    for t, wg in zip(ts, want):
        # fp32 gradients through two autodiff systems: reordered sums
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg),
                                   rtol=1e-4, atol=1e-5)

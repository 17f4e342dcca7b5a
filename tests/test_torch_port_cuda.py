"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the fixture, never at import). On a machine with an H100:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda -q
"""

import pytest
import torch

from byteps_tpu_torch.ops import flash_attention as FA
from byteps_tpu_torch.ops.compression import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100_003, 32000 * 768])
def test_onebit_kernels_bit_exact(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, generator=g, device=dev)
    x[::5] = 0.0
    before = K.onebit_pack.launches
    words = K.onebit_pack(x)
    assert K.onebit_pack.launches == before + 1
    assert torch.equal(words, K.onebit_pack_plain(x))
    scale = x.abs().mean()
    assert torch.equal(K.onebit_unpack(words, scale, n),
                       K.onebit_unpack_plain(words, scale, n))
    rows = torch.stack([words, ~words])
    scales = torch.stack([scale, 2 * scale])
    assert torch.equal(K.onebit_unpack(rows, scales, n),
                       K.onebit_unpack_plain(rows, scales, n))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_matches_blockwise(dev, dtype, causal, D):
    g = torch.Generator(device=dev).manual_seed(D)
    B, S, H, Hkv = 2, 512, 4, 2
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(dtype)
    with torch.no_grad():
        got = FA.flash_attention_fwd(q, k, v, causal).float()
        ref = FA.blockwise_attention(q, k, v, causal=causal).float()
    if dtype == torch.float32:
        # fp32 both sides, sums in other orders
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        # one bf16 step of the fp32 result
        assert bool(((got - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-6)
                    .all())


def test_flash_kernel_reads_strided_inputs(dev):
    """q/k/v as views of a fused [B,S,H+2Hkv,D] projection, no copy."""
    g = torch.Generator(device=dev).manual_seed(0)
    fused = torch.randn(1, 128, 8, 64, generator=g, device=dev)
    q, k, v = fused[:, :, :4], fused[:, :, 4:6], fused[:, :, 6:8]
    with torch.no_grad():
        torch.testing.assert_close(
            FA.flash_attention_fwd(q, k, v, True),
            FA.blockwise_attention(q, k, v, causal=True),
            rtol=1e-5, atol=1e-5)


def test_flash_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 100, 2, 64, device=dev)
    with pytest.raises(ValueError, match="multiple of 64"):
        FA.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 64, 2, 32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_fwd(q, q, q)

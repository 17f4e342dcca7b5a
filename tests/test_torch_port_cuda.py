"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the fixture, never at import). On a machine with an H100:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from _torch_port_ps_util import (
    ROUND_KWS, ROUND_MEMBERS, bounded, partition_path_wires,
    path_round_lengths, port_rounds, tie_input,
)
from byteps_tpu_torch.ops import flash_attention as FA
from byteps_tpu_torch.ops.compression import kernels as K
from byteps_tpu_torch.ops.compression import rng

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


@pytest.mark.parametrize("causal", [True, False])
def test_flash_reports_its_flops_to_the_ledger_count(dev, causal):
    """The ctypes launch dispatches nothing FlopCounterMode sees: the
    wrapper reports the forward's FLOPs, the same count as its CPU twin
    gives, and the backward's products count themselves alike."""
    from byteps_tpu_torch.core.ledger import count_flops
    counts = {}
    for d in (dev, torch.device("cpu")):
        g = torch.Generator(device=d).manual_seed(1)
        q, k, v = (torch.randn(2, 256, h, 64, generator=g, device=d,
                               dtype=torch.float32, requires_grad=True)
                   for h in (4, 2, 2))

        def run():
            out = FA.flash_attention(q, k, v, causal, 128)
            out.sum().backward()
            return out

        counts[d.type] = count_flops(run)[1]
    # in causal forwards: the forward 1 (2 without the mask), its
    # backward 7 (the blockwise recompute 2, its checkpoint's scores 1,
    # the gradients 4)
    unit = FA.attention_flops(2, 256, 4, 64, causal=True)
    assert counts["cuda"] == counts["cpu"] == (8 if causal else 9) * unit


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


def _one_bf16_step(got, ref):
    """|got - ref| <= one bf16 step of the fp32 result, everywhere."""
    got, ref = got.float(), ref.float()
    return bool(torch.isfinite(got).all()) and bool(
        ((got - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-6).all())


@pytest.mark.parametrize("B,S,H,Hkv,D,causal", [
    (4, 2048, 6, 2, 128, True),     # the training path's shape
    (2, 192, 4, 2, 128, True),      # S % 128 == 64: a half query tile
    (2, 192, 4, 2, 64, False),
    (1, 384, 4, 2, 64, False),      # D = 64, non-causal
    (2, 256, 6, 6, 128, True),      # GQA groups of 1
    (2, 256, 6, 1, 128, True),      # GQA groups of 6
    (4, 2048, 3, 3, 128, True),     # Ulysses' local attention over sp = 2
    (4, 2048, 3, 1, 128, True),     # the tp-local heads over tp = 2
], ids=["path", "S192-causal", "S192-D64", "D64-noncausal", "groups1",
        "groups6", "ulysses", "tp"])
def test_flash_bf16_kernel_within_one_step(dev, B, S, H, Hkv, D, causal):
    g = torch.Generator(device=dev).manual_seed(S + H + Hkv + D)
    q = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).bfloat16()
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev).bfloat16()
    before = FA.flash_attention_fwd.launches
    with torch.no_grad():
        got = FA.flash_attention_fwd(q, k, v, causal)
        ref = FA.blockwise_attention(q, k, v, causal=causal)
    assert FA.flash_attention_fwd.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert _one_bf16_step(got, ref)


def test_flash_bf16_kernel_reads_the_fused_projection(dev):
    """bf16 q/k/v as views of a fused [B,S,H+2Hkv,D] projection."""
    g = torch.Generator(device=dev).manual_seed(1)
    fused = torch.randn(2, 256, 10, 128, generator=g, device=dev).bfloat16()
    q, k, v = fused[:, :, :6], fused[:, :, 6:8], fused[:, :, 8:10]
    with torch.no_grad():
        assert _one_bf16_step(FA.flash_attention_fwd(q, k, v, True),
                              FA.blockwise_attention(q, k, v, causal=True))


def test_flash_bf16_kernel_refuses_unaligned_rows(dev):
    """TMA reads rows that start 16-byte aligned: a view whose base is off
    that boundary raises instead of being copied or sent elsewhere."""
    flat = torch.zeros(1 + 128 * 2 * 64, dtype=torch.bfloat16, device=dev)
    q = flat[1:].view(1, 128, 2, 64)
    before = FA.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_attention_fwd(q, q, q)
    assert FA.flash_attention_fwd.launches == before


def test_flash_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 100, 2, 64, device=dev)
    with pytest.raises(ValueError, match="multiple of 64"):
        FA.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 64, 2, 32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_fwd(q, q, q)


def _dither_input(dev, n, seed):
    """Normal values; exact powers of two and their neighbours one ulp
    either side at the front; zeros."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, generator=g, device=dev)
    p2 = 2.0 ** -torch.arange(32, dtype=torch.float32, device=dev)
    p2 = p2 * torch.where(torch.arange(32, device=dev) % 2 == 1, 1.0, -1.0)
    x[:32] = p2
    x[32:64] = torch.nextafter(p2, torch.zeros_like(p2))
    x[64:96] = torch.nextafter(p2, p2 * 2)
    x[96:104] = 0.0
    return x


@pytest.mark.parametrize("n", [104, 4099, 1_024_000])
@pytest.mark.parametrize("partition", ["linear", "natural"])
def test_dithering_kernel_bit_exact(dev, n, partition):
    x = _dither_input(dev, n, n)
    norm = x.abs().max()
    base = 0x9E3779B1 ^ n
    before = K.dithering_levels.launches
    got = K.dithering_levels(x, norm, base, 127, partition)
    assert K.dithering_levels.launches == before + 1
    want = K.dithering_levels_plain(x, norm, base, 127, partition)
    assert torch.equal(got, want), int((got != want).sum())
    # an L2 norm above max|x|, and the base as a device tensor
    l2 = x.norm()
    base_t = torch.full((), base, dtype=torch.int64, device=dev)
    assert torch.equal(K.dithering_levels(x, l2, base_t, 15, partition),
                       K.dithering_levels_plain(x, l2, base_t, 15,
                                                partition))


@pytest.mark.parametrize("size,k", [(1000, 10), (1_024_000, 10_240),
                                    (3 * 2 ** 24 + 7, 1 << 20)])
def test_randomk_kernel_bit_exact(dev, size, k):
    base = rng.uniform_base(7, 3)
    before = K.randomk_indices.launches
    got = K.randomk_indices(base, size, k, dev)
    assert K.randomk_indices.launches == before + 1
    assert torch.equal(got, K.randomk_indices_plain(base, size, k, dev))
    assert torch.equal(got.cpu(), rng.index_parallel(7, k, size, 3))


# --------------------------------------------------------------------- #
# B4 and B5 over a round: one launch for every partition
# --------------------------------------------------------------------- #

# (lengths, gap): each slot behind ``gap`` unused elements in x and one
# more in out, so that with a gap no slot after the first starts on 16
# bytes
ROUNDS = {
    "ragged": lambda: ([1, 15, 16, 17, 4099, 8192], 0),
    "empty-and-one": lambda: ([0, 1, 4096, 0, 33, 0], 0),
    "unaligned": lambda: ([1, 15, 16, 17, 4099, 8192], 3),
    "path": lambda: (path_round_lengths(), 0),
}


def _layout(ns, gap):
    x_offs, out_offs, xe, oe = [], [], 0, 0
    for n in ns:
        xe, oe = xe + gap, oe + (gap + 1 if gap else 0)
        x_offs.append(xe)
        out_offs.append(oe)
        xe, oe = xe + n, oe + n
    return x_offs, out_offs, xe, oe


@pytest.mark.parametrize("partition", ["linear", "natural"])
@pytest.mark.parametrize("case", list(ROUNDS))
def test_dithering_round_kernel_matches_twin(dev, case, partition):
    ns, gap = ROUNDS[case]()
    x_offs, out_offs, n_x, n_out = _layout(ns, gap)
    x = _dither_input(dev, max(n_x, 104), len(ns) + gap)[:n_x]
    norms = torch.stack([x[a: a + n].abs().max() if n else x.new_ones(())
                         for a, n in zip(x_offs, ns)]).clamp_min(1e-30)
    table = K.dithering_table(x_offs, ns, out_offs)
    base = rng.uniform_base(3, len(ns))
    before = K.dithering_levels.launches
    got = K.dithering_levels_round(
        x, norms, table, base, 127, partition,
        torch.full((n_out,), 99, dtype=torch.int8, device=dev))
    assert K.dithering_levels.launches == before + 1
    want = K.dithering_levels_round_plain(
        x, norms, table, base, 127, partition,
        torch.full((n_out,), 99, dtype=torch.int8, device=dev))
    if partition == "linear":
        assert torch.equal(got, want), int((got != want).sum())
        return
    # natural: off by one at most, where log2 rounds at a power of two,
    # in at most n/100,000 levels of a partition
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs().cpu().numpy()
    assert diff.max(initial=0) <= 1
    for o, n in zip(out_offs, ns):
        assert (diff[o: o + n] > 0).sum() <= max(1, n // 100_000)


@pytest.mark.parametrize("case", list(ROUNDS))
def test_randomk_round_kernel_matches_twin_and_golden(dev, case):
    from byteps_tpu_torch.ops.compression.codecs import resolve_k
    ns, gap = ROUNDS[case]()
    if case == "path":
        sizes, ks = ns, [resolve_k(0.01, n) for n in ns]
    else:
        sizes, ks = [n + 1000 for n in ns], ns
    _, out_offs, _, n_out = _layout(ks, gap)
    table = K.randomk_table(sizes, ks, out_offs)
    seed, step = 7, len(ns)
    base = rng.uniform_base(seed, step)
    before = K.randomk_indices.launches
    got = K.randomk_indices_round(table, base, torch.full(
        (n_out,), -1, dtype=torch.int32, device=dev))
    assert K.randomk_indices.launches == before + 1
    want = K.randomk_indices_round_plain(table, base, torch.full(
        (n_out,), -1, dtype=torch.int32, device=dev))
    assert torch.equal(got, want)
    got = got.cpu().numpy()
    for o, size, k in zip(out_offs, sizes, ks):
        np.testing.assert_array_equal(
            got[o: o + k], rng.np_index_parallel(seed, k, size, step))


def test_one_partition_wrappers_are_rounds_of_one(dev):
    x = _dither_input(dev, 4099, 11)
    norm, base = x.abs().max(), rng.uniform_base(2, 9)
    for view in (x, x[3:]):       # the second off 16 bytes: scalar loads
        n = view.numel()
        one = K.dithering_levels(view, norm, base, 127, "linear")
        assert torch.equal(one, K.dithering_levels_plain(view, norm, base,
                                                         127, "linear"))
        rnd = K.dithering_levels_round(
            view, norm.reshape(1), K.dithering_table([0], [n], [0]), base,
            127, "linear", torch.empty(n, dtype=torch.int8, device=dev))
        assert torch.equal(one, rnd)
    idx = K.randomk_indices(base, 5000, 300, dev)
    assert torch.equal(idx, K.randomk_indices_round(
        K.randomk_table([5000], [300], [0]), base,
        torch.empty(300, dtype=torch.int32, device=dev)))


@pytest.mark.parametrize("kw", ROUND_KWS, ids=lambda kw: kw["compressor"])
def test_ps_round_on_the_card_pushes_the_partition_path_wire_bytes(
        dev, kw, monkeypatch):
    """Two PS rounds of leaves split into ragged partitions, through a
    loopback server: one B4 or B5 launch a round, and the wire bytes of
    the partition-by-partition path on the card."""
    from byteps_tpu_torch.native import build
    bounded(build.build_ps, timeout=240)
    counter = K.dithering_levels if kw["compressor"] == "dithering" \
        else K.randomk_indices
    before = counter.launches
    wires, _, _, spec = port_rounds(monkeypatch, kw, device=dev)
    assert counter.launches == before + 2
    assert [m[3] for m in spec.round.members] == ROUND_MEMBERS
    assert wires == partition_path_wires(kw, device=dev)


# --------------------------------------------------------------------- #
# the dithering dequantization (aggregate and EF residual) over a round
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("partition", ["linear", "natural"])
@pytest.mark.parametrize("case", list(ROUNDS))
def test_dequantize_round_kernel_matches_twin(dev, case, partition):
    """The aggregate (dec * norm) and the residual (one FMA) bit for bit
    with the twin, whose FMA is exact, gaps untouched."""
    ns, gap = ROUNDS[case]()
    x_offs, lv_offs, n_x, n_lv = _layout(ns, gap)
    g = torch.Generator(device=dev).manual_seed(len(ns) + gap)
    hi = 127 if partition == "linear" else 126
    levels = torch.randint(-hi, hi + 1, (n_lv,), generator=g, device=dev,
                           dtype=torch.int8)
    norms = torch.rand(len(ns), generator=g, device=dev) + 0.5
    x = _dither_input(dev, max(n_x, 104), len(ns) + gap)[:n_x]
    table = K.dithering_table(x_offs, ns, lv_offs)
    before = K.dithering_dequantize.launches
    out = K.dithering_dequantize_round(
        levels, norms, table, 127, partition,
        torch.full((n_x,), 7.0, device=dev))
    res = K.dithering_dequantize_round(levels, norms, table, 127, partition,
                                       x.clone(), residual=True)
    assert K.dithering_dequantize.launches == before + 2
    want = K.dithering_dequantize_round_plain(
        levels, norms, table, 127, partition,
        torch.full((n_x,), 7.0, device=dev))
    want_res = K.dithering_dequantize_round_plain(
        levels, norms, table, 127, partition, x.clone(), residual=True)
    assert torch.equal(out, want), int((out != want).sum())
    assert torch.equal(res, want_res), int((res != want_res).sum())


# --------------------------------------------------------------------- #
# the compressor stacks' FMAs (momentum, the EF LR rescale) and XLA's sum
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("case", ["path", "ragged"])
def test_fma_kernel_bit_exact_with_twin(dev, case):
    """fma(mu, m, x), then fma(mu, m', x) (the round's momentum) and
    fma(scale, error, x) with a device scalar (the EF rescale), over the
    path's round and a ragged one, bit for bit with the twin's exact
    FMA."""
    ns, _ = ROUNDS[case]()
    n = sum(ns)
    g = torch.Generator(device=dev).manual_seed(n)
    m, x, e = (torch.randn(n, generator=g, device=dev) for _ in range(3))
    scale = torch.tensor(0.05, device=dev) / torch.tensor(0.03, device=dev)
    before = K.fma_scalar.launches
    m1 = K.fma_scalar(0.9, m, x)
    x1 = K.fma_scalar(0.9, m1, x)
    ex = K.fma_scalar(scale, e, x)
    assert K.fma_scalar.launches == before + 3
    mu = torch.tensor(0.9, device=dev)
    for got, want in ((m1, K.fma_f32_plain(mu, m, x)),
                      (x1, K.fma_f32_plain(mu, m1, x)),
                      (ex, K.fma_f32_plain(scale, e, x))):
        assert torch.equal(got, want), int((got != want).sum())
    # written in place into c, as the round's momentum writes x, and
    # into b
    y = x.clone()
    assert K.fma_scalar(0.9, m1, y, out=y) is y and torch.equal(y, x1)
    y = m.clone()
    assert K.fma_scalar(0.9, y, x, out=y) is y and torch.equal(y, m1)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1000, 1_000_003])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (3, 3, 3),
                                     (0, 1, 2), (2, 0, 0)])
@pytest.mark.parametrize("alias", ["none", "b", "c"])
def test_fma_kernel_any_offset_length_and_aliasing(dev, n, offsets, alias):
    """Views that start off 16 bytes (the same phase: a scalar head and the
    vector body; other phases: every element scalar), ragged lengths (the
    scalar tail), and out = b or out = c, bit for bit with the twin."""
    ob, oc, oo = offsets
    g = torch.Generator(device=dev).manual_seed(n + 7 * ob + oc)
    bb, cc, oo_buf = (torch.randn(n + 4, generator=g, device=dev)
                      for _ in range(3))
    b, c = bb[ob: ob + n], cc[oc: oc + n]
    want = K.fma_f32_plain(torch.tensor(-1.75, device=dev), b, c)
    out = {"none": oo_buf[oo: oo + n], "b": b, "c": c}[alias]
    before = K.fma_scalar.launches
    got = K.fma_scalar(-1.75, b, c, out=out)
    assert K.fma_scalar.launches == before + 1 and got is out
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


def test_wrappers_launch_on_their_tensors_card_from_any_thread(dev):
    """A thread whose current card is 0 (a new Python thread's, until it
    sets one) calls the wrappers with tensors on card 1: each launches on
    card 1 and agrees with its twin. A launch on the thread's card with
    card 1's memory is what faulted on rank 1 of a dp group over NCCL."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    d1 = torch.device("cuda", 1)
    g = torch.Generator(device=d1).manual_seed(11)
    q, k, v = (torch.randn(2, 192, 4, 64, generator=g, device=d1).bfloat16()
               for _ in range(3))
    x = torch.randn(100_003, generator=g, device=d1)

    def run():
        torch.cuda.set_device(0)
        with torch.no_grad():
            out = (FA.flash_attention_fwd(q, k, v), K.onebit_pack(x),
                   K.xla_sum(x), K.fma_scalar(0.9, x, x))
        torch.cuda.synchronize(d1)
        assert torch.cuda.current_device() == 0
        return out

    flash, words, total, fma = bounded(run)
    with torch.no_grad():
        assert _one_bf16_step(flash, FA.blockwise_attention(q, k, v))
    assert torch.equal(words, K.onebit_pack_plain(x))
    assert torch.equal(total, K.xla_sum_plain(x))
    assert torch.equal(fma, K.fma_f32_plain(torch.tensor(0.9, device=d1),
                                            x, x))


# 33, 32,769, 100,003 and 1,000,003 pad level 1 on the left (and all but
# 33 level 2), 32,000 pads level 2 alone, 32,758 level 1 alone; the
# embedding pads level 3
XLA_SUM_MODES = [{}, {"absolute": True}, {"square": True}]


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1025, 32_000, 32_758, 32_769,
                               100_003, 1_000_003, 32000 * 768])
def test_xla_sum_kernel_bit_exact_with_twin(dev, n):
    """Every mode, on x and on views of it that start 1, 2 and 3 floats
    past a 16-byte boundary, bit for bit with the twin, one launch a
    call; the mean with |x| too."""
    g = torch.Generator(device=dev).manual_seed(n)
    base = torch.randn(n + 3, generator=g, device=dev)
    for off in range(4):
        x = base[off: off + n]
        for kw in XLA_SUM_MODES:
            before = K.xla_sum.launches
            got = K.xla_sum(x, **kw)
            assert K.xla_sum.launches == before + 1
            want = K.xla_sum_plain(x, **kw)
            assert torch.equal(got, want), (n, off, kw, got.item(),
                                            want.item())
        got = K.xla_mean(x, absolute=True)
        want = K.xla_sum_plain(x, absolute=True) * float(
            np.float32(1) / np.float32(n))
        assert torch.equal(got, want), (n, off, got.item(), want.item())


def test_xla_sum_graph_replays_give_the_same_bits(dev):
    """Two replays of one captured graph of sums (the ticket is back at 0
    after each) give the eager results, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(3)
    xs = [torch.randn(n, generator=g, device=dev)
          for n in (33, 100_003, 32000 * 768)]
    want = [K.xla_sum(x, absolute=True) for x in xs]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [K.xla_sum(x, absolute=True) for x in xs]
    for _ in range(2):
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            assert torch.equal(o, w), (o.item(), w.item())
    assert all(torch.equal(K.xla_sum(x, absolute=True), w)
               for x, w in zip(xs, want))


def test_xla_sum_on_two_streams_at_once(dev):
    """Two threads, each on a stream of its own, sum at once, many times:
    each stream has its own workspace and ticket, so every result is the
    twin's."""
    g = torch.Generator(device=dev).manual_seed(9)
    xs = [torch.randn(n, generator=g, device=dev)
          for n in (32000 * 768, 1_000_003)]
    want = [K.xla_sum_plain(x) for x in xs]
    torch.cuda.synchronize()

    def run(x):
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            outs = [K.xla_sum(x) for _ in range(50)]
        stream.synchronize()
        return outs

    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(2) as pool:
        results = list(pool.map(run, xs))
    for outs, w in zip(results, want):
        assert all(torch.equal(o, w) for o in outs)


def test_dequantize_one_partition_is_a_round_of_one(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    levels = torch.randint(-127, 128, (4099,), generator=g, device=dev,
                           dtype=torch.int8)
    norm = torch.rand((), generator=g, device=dev) + 0.5
    x = _dither_input(dev, 4102, 5)
    for xs, lv in ((x[:4099], levels), (x[3:], levels)):  # off 16 bytes
        want = K.dithering_dequantize_plain(lv, norm, 127, "linear")
        assert torch.equal(K.dithering_dequantize(lv, norm, 127, "linear"),
                           want)
        res = K.dithering_dequantize(lv, norm, 127, "linear",
                                     residual_of=xs.clone())
        assert torch.equal(res, K.dithering_dequantize_plain(
            lv, norm, 127, "linear", xs))


# --------------------------------------------------------------------- #
# the dense PS step on the card against plain local steps
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("stream", [True, False])
def test_dense_ps_steps_equal_local_steps(dev, stream, monkeypatch):
    """Two dense PS steps of a small fp32 Llama through a loopback server
    (one worker: the aggregate is the pushed gradient) give bit for bit
    the parameters of two plain steps with the same Adam (foreach on
    both sides): streamed export through the side stream and the pinned
    slots, or the post-backward copies, a fused bucket, the H2D copy
    stream and the per-leaf step."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.native import build
    from byteps_tpu_torch.training import make_ps_train_step
    from _torch_port_ps_util import _ps_env, ps_server

    bounded(build.build_ps, timeout=240)
    cfg = llama.LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, hidden_dim=256, max_seq_len=64,
                            dtype=torch.float32, remat=True)
    models = [llama.Llama(cfg, device=dev, params=llama.init_params(
        cfg, torch.Generator().manual_seed(2), "cpu")) for _ in range(2)]
    tokens = torch.randint(0, cfg.vocab_size, (2, 65),
                           generator=torch.Generator().manual_seed(3)).to(dev)
    opts = [torch.optim.Adam(m.parameters(), lr=1e-3, foreach=True)
            for m in models]
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        monkeypatch.setenv("BYTEPS_FUSION_BYTES", "65536")
        bps.init(device=dev)
        try:
            step = make_ps_train_step(
                lambda b: llama.loss_fn(models[0].params(), b, cfg),
                opts[0], models[0].params(), stream_export=stream)
            ps_losses = bounded(lambda: [
                float(step({"tokens": tokens})) for _ in range(2)])
            counters = dict(step.counters)
            step.close()
        finally:
            bps.shutdown()
    assert (counters["leaves_streamed"] > 0) == stream
    assert counters["fused_buckets"] == 1
    losses = []
    for _ in range(2):
        opts[1].zero_grad(set_to_none=True)
        loss = llama.loss_fn(models[1].params(), {"tokens": tokens}, cfg)
        loss.backward()
        opts[1].step()
        losses.append(float(loss.detach()))
    assert ps_losses == losses
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["levels", "pairs"])
@pytest.mark.parametrize("n,k", [(7, 3), (4099, 400), (1_024_000, 10_240),
                                 (32000 * 768, 245_760)])
def test_topk_selection_on_the_card_equals_the_cpu_path(dev, kind, n, k):
    """``torch.topk`` on the card promises no order among ties either: the
    selection (threshold, ties in index order, stable sort) gives the
    CPU's indices and values on inputs full of ties."""
    from byteps_tpu_torch.ops.compression.codecs import TopkCodec
    x = torch.from_numpy(tie_input(kind, n, seed=n + k))
    codec = TopkCodec(size=n, k=k)
    got = codec.compress(x.to(dev))
    want = codec.compress(x)
    for key in ("indices", "values"):
        assert torch.equal(got[key].cpu(), want[key]), key
    assert torch.equal(codec.decompress(got).cpu(), codec.decompress(want))


@pytest.mark.parametrize("kw", [
    {"compressor": "dithering", "ef": "vanilla", "seed": "3"},
    {"compressor": "randomk", "k": "0.01", "ef": "vanilla", "seed": "5"},
], ids=["dithering", "randomk"])
def test_collective_step_on_the_card_equals_its_cpu_twin(dev, kw):
    """Two steps of the collective compressed push_pull
    (``compressed_psum_tree``, a group of one) on the card, through B4
    and the dequantization or B5, equal the same steps on the CPU, where
    every wrapper takes its plain twin: outputs and EF residuals bit for
    bit."""
    import torch.distributed as dist

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.ops.compression import (
        compressed_psum_tree, default_stacks,
    )

    g = torch.Generator().manual_seed(7)
    grads = [torch.randn(1024, 768, generator=g), torch.randn(768,
                                                              generator=g)]
    stacks = default_stacks(grads, kw, min_compress_bytes=4096)
    assert stacks[0] is not None and stacks[1] is None
    bps.init(device=dev)
    try:
        cpu_group = dist.new_group(backend="gloo")
        launches = (K.dithering_levels.launches + K.randomk_indices.launches
                    + K.dithering_dequantize.launches)
        out = {}
        for where, group in ((dev, bps.get_state().group),
                             (torch.device("cpu"), cpu_group)):
            states = [s.init_state(x.numel(), where) if s else {}
                      for x, s in zip(grads, stacks)]
            res = []
            for step in range(2):
                xs = [(x * (step + 1)).to(where) for x in grads]
                red, states = compressed_psum_tree(xs, states, stacks, group,
                                                   step, lr=1e-3)
                res.append([r.cpu() for r in red]
                           + [states[0]["error"].cpu()])
            out[where.type] = res
        assert K.dithering_levels.launches + K.randomk_indices.launches + \
            K.dithering_dequantize.launches > launches
    finally:
        bps.shutdown()
    for a_step, b_step in zip(out["cuda"], out["cpu"]):
        for a, b in zip(a_step, b_step):
            assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the PyTorch adapter on the card
# --------------------------------------------------------------------- #

class _Exact(torch.nn.Module):
    """Two dense leaves and a sparse embedding whose gradients are exact
    on any device: (p * c).sum() has gradient c."""

    def __init__(self, dtype, device):
        super().__init__()
        rs = np.random.RandomState(0)
        self.a = torch.nn.Parameter(torch.from_numpy(
            rs.randn(257).astype(np.float32)).to(device, dtype))
        self.b = torch.nn.Parameter(torch.from_numpy(
            rs.randn(33, 65).astype(np.float32)).to(device, dtype))
        self.emb = torch.nn.Embedding(40, 24, sparse=True, device=device)
        self.ca = torch.from_numpy(rs.randn(257).astype(np.float32)).to(
            device, dtype)
        self.cb = torch.from_numpy(rs.randn(33, 65).astype(np.float32)).to(
            device, dtype)
        self.idx = torch.from_numpy(rs.randint(0, 40, 9)).to(device)

    def forward(self):
        return (self.a * self.ca).sum() + (self.b * self.cb).sum() + \
            self.emb(self.idx).float().sum()


def _adapter_grads(device, dtype, monkeypatch):
    """The gradients ``DistributedOptimizer.synchronize()`` writes, one
    worker against a loopback server, on ``device``."""
    import byteps_tpu_torch.torch as bpt
    from byteps_tpu_torch.native import build
    from _torch_port_ps_util import _ps_env, ps_server

    bounded(build.build_ps, timeout=240)
    model = _Exact(dtype, device)
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bpt.init(device=device)
        try:
            opt = bpt.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.5),
                named_parameters=model.named_parameters())

            def run():
                opt.zero_grad()
                model().float().backward()
                opt.synchronize()

            bounded(run)
        finally:
            bpt.shutdown()
    return {n: p.grad.cpu() for n, p in model.named_parameters()}, model


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adapter_hook_on_card_gradients_equals_the_cpu(dev, dtype,
                                                       monkeypatch):
    """The hook's side-stream copy into a pinned buffer, the export
    thread's submission and the aggregate's copy back into ``p.grad``
    give on the card what they give on the CPU, bf16 as its bits."""
    card, m = _adapter_grads(dev, dtype, monkeypatch)
    cpu, _ = _adapter_grads(torch.device("cpu"), dtype, monkeypatch)
    for name in cpu:
        assert card[name].dtype == cpu[name].dtype, name
        assert torch.equal(card[name], cpu[name]), name
    assert torch.equal(card["a"], m.ca.cpu())
    assert torch.equal(card["b"], m.cb.cpu())


def _cross_barrier_run(device, monkeypatch, build_on=None, steps=3):
    """``steps`` CrossBarrier SGD steps of a bias-free linear layer whose
    gradient is an exact quarter-integer matrix (lr 0.25: every update is
    exact); the CrossBarrier built on a thread whose current card is
    ``build_on``."""
    import threading

    import byteps_tpu_torch.torch as bpt
    from byteps_tpu_torch.native import build
    from byteps_tpu_torch.torch.cross_barrier import CrossBarrier
    from _torch_port_ps_util import _ps_env, ps_server

    bounded(build.build_ps, timeout=240)
    rs = np.random.RandomState(1)
    lin = torch.nn.Linear(16, 8, bias=False, device=device)
    w0 = torch.from_numpy(rs.randn(8, 16).astype(np.float32))
    c = torch.from_numpy(rs.randint(-8, 9, (8, 16)).astype(np.float32) / 4)
    with torch.no_grad():
        lin.weight.copy_(w0)
    eye = torch.eye(16, device=device)
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bpt.init(device=device)
        try:
            opt = bpt.DistributedOptimizer(
                torch.optim.SGD(lin.parameters(), lr=0.25),
                named_parameters=lin.named_parameters())
            box = {}

            def make():
                if build_on is not None:
                    torch.cuda.set_device(build_on)
                box["cb"] = CrossBarrier(lin, opt, num_steps=steps)

            t = threading.Thread(target=make)
            t.start()
            t.join()
            cb = box["cb"]
            cb.step()

            def run():
                for _ in range(steps):
                    cb.zero_grad()
                    (lin(eye) * c.to(device).T).sum().backward()
                    cb.step()

            bounded(run)
        finally:
            bpt.shutdown()
    want = w0.clone()
    for _ in range(steps):
        want -= 0.25 * c
    return lin.weight.detach().cpu(), want


def test_cross_barrier_updates_on_the_card(dev, monkeypatch):
    got, want = _cross_barrier_run(dev, monkeypatch)
    assert torch.equal(got, want)


def test_cross_barrier_poller_updates_on_the_params_card(dev, monkeypatch):
    """Parameters on card 1, the CrossBarrier (and so its poller thread)
    started from a thread on card 0: the updates land on card 1."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    got, want = _cross_barrier_run(torch.device("cuda", 1), monkeypatch,
                                   build_on=0)
    assert torch.equal(got, want)


# --------------------------------------------------------------------- #
# cross-barrier staleness in the PS step on the card
# --------------------------------------------------------------------- #

def test_a_leaf_carried_and_landed_in_the_next_step_on_the_card(
        dev, monkeypatch):
    """Staleness 1 on the card, a slowed and throttled server, the keys
    submitted after the backward: the weights (the carry-eligible back
    half) are carried out of every odd step, and every even step waits
    for its replies before its drain, so there they land twice: the
    carried round, then their own, two copies into one ``p.grad``, each
    followed by the leaf's optimizer step. A spin on the compute stream
    before each carried optimizer step keeps its read of ``p.grad``
    pending while the second copy is issued: a copy that did not wait
    for it would overwrite the gradient under it. The parameters equal,
    bit for bit, plain local Adam steps that apply each carried leaf's
    update one step late, as recorded."""
    import time

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import mlp
    from byteps_tpu_torch.native import build
    from byteps_tpu_torch.training import make_ps_train_step
    from byteps_tpu_torch.training.optim import make_leaf_apply
    from _torch_port_ps_util import _ps_env, ps_server

    bounded(build.build_ps, timeout=240)
    cfg = mlp.MLPConfig(in_dim=64, hidden=(256, 256, 256), n_classes=10)
    init = mlp.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rs = np.random.RandomState(0)
    batch = {"x": torch.from_numpy(rs.rand(32, 64).astype(np.float32)).to(
        dev), "y": torch.from_numpy(rs.randint(0, 10, 32)).to(dev)}

    def fresh():
        model = mlp.MLP(cfg, dev, params={k: v.to(dev).clone()
                                          for k, v in init.items()})
        return model, torch.optim.Adam(model.parameters(), lr=1e-2)

    for k, v in {"BYTEPS_FUSION_BYTES": "256", "BYTEPS_CROSS_BARRIER": "1",
                 "BYTEPS_STALENESS": "1", "BYTEPS_CHAOS_SLOW_SERVER": "10",
                 "BYTEPS_SERVER_THROTTLE_MBPS": "100",
                 "BYTEPS_STREAM_EXPORT": "0"}.items():
        monkeypatch.setenv(k, v)
    model, opt = fresh()
    at = {"step": 0, "carry": False}
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bps.init(device=dev)
        try:
            step = make_ps_train_step(
                lambda b: mlp.loss_fn(model.params(), b, cfg), opt,
                model.params())
            apply, apply_carry = step._leaf_apply.step, step._apply_carry
            drain = step._drain

            def held_back(p):
                if at["carry"]:
                    torch.cuda._sleep(1_000_000_000)    # ~0.5 s
                apply(p)

            def carried(*a):
                at["carry"] = True
                try:
                    return apply_carry(*a)
                finally:
                    at["carry"] = False

            def drain_after_the_replies(*a):
                if at["step"] % 2 == 0:
                    time.sleep(0.3)
                return drain(*a)

            step._leaf_apply.step = held_back
            step._apply_carry = carried
            step._drain = drain_after_the_replies

            def run():
                out = []
                for i in range(8):
                    at["step"] = i
                    step(batch)
                    out.append(step.counters["carried"])
                step.flush()
                return out

            schedule = bounded(run)
            step.close()
        finally:
            bps.shutdown()
    again = [set(a) - set(b) for a, b in zip(schedule, schedule[1:])]
    assert any(again), schedule     # a leaf carried, then landed twice
    ref, ref_opt = fresh()
    leaf = make_leaf_apply(ref_opt)
    params = dict(ref.named_parameters())
    late = {}
    for names in schedule:
        ref.zero_grad(set_to_none=True)
        mlp.loss_fn(ref.params(), batch, cfg).backward()
        grads = {n: p.grad.clone() for n, p in params.items()}
        for n, g in late.items():
            params[n].grad = g
            leaf.step(params[n])
        late = {}
        for n, p in params.items():
            if "grad/" + n in names:
                late[n] = grads[n]
            else:
                p.grad = grads[n]
                leaf.step(p)
    for n, g in late.items():
        params[n].grad = g
        leaf.step(params[n])
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n]), (n, schedule)


# --------------------------------------------------------------------- #
# the model zoo on the card
# --------------------------------------------------------------------- #

def _zoo_case(name, dev):
    """(model on ``dev``, loss of it) of a zoo model's tiny() in f32,
    from one seeded init and one seeded batch."""
    import dataclasses

    from byteps_tpu_torch.models import bert, mlp, moe, resnet, vgg

    gen = torch.Generator().manual_seed(9)
    B = 4
    if name == "mlp":
        cfg = mlp.MLPConfig()
        params = mlp.init_params(cfg, gen, "cpu")
        batch = {"x": torch.rand(B, 784, generator=gen),
                 "y": torch.randint(0, 10, (B,), generator=gen)}
        model = mlp.MLP(cfg, dev, params=params)
        return model, lambda m, b: mlp.loss_fn(m.params(), b, cfg), batch
    if name in ("vgg", "resnet"):
        mod = {"vgg": vgg, "resnet": resnet}[name]
        cfg = dataclasses.replace(
            vgg.VGGConfig.tiny() if name == "vgg"
            else resnet.ResNetConfig.tiny(), dtype=torch.float32)
        batch = {"x": torch.rand(B, 32, 32, 3, generator=gen),
                 "y": torch.randint(0, 10, (B,), generator=gen)}
        if name == "vgg":
            model = vgg.VGG(cfg, dev, params=vgg.init_params(cfg, gen, "cpu"))
            return model, lambda m, b: vgg.loss_fn(m.params(), b, cfg), batch
        params, state = mod.init_params(cfg, gen, "cpu")
        model = resnet.ResNet(cfg, dev, params=params, state=state)
        return model, lambda m, b: resnet.loss_fn(
            m.params(), m.state(), b, cfg)[0], batch
    if name == "bert":
        cfg = dataclasses.replace(bert.BertConfig.tiny(seq=32),
                                  dtype=torch.float32)
        toks = torch.randint(0, cfg.vocab_size, (B, 32), generator=gen)
        labels = torch.where(torch.rand(B, 32, generator=gen) < 0.3, toks, -1)
        model = bert.Bert(cfg, dev, params=bert.init_params(cfg, gen, "cpu"))
        return model, lambda m, b: bert.loss_fn(m.params(), b, cfg), {
            "tokens": toks, "labels": labels}
    cfg = dataclasses.replace(moe.MoEConfig.tiny(seq=32), dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (B, 33), generator=gen)
    model = moe.MoE(cfg, dev, params=moe.init_params(cfg, gen, "cpu"))
    return model, lambda m, b: moe.loss_fn(m.params(), b, cfg), {
        "tokens": toks}


@pytest.mark.parametrize("name", ["mlp", "vgg", "resnet", "bert", "moe"])
def test_zoo_model_on_the_card_equals_the_cpu(dev, name):
    """Each zoo model's tiny() in f32 (no TF32): loss to 1e-5 and every
    gradient to 1e-3 of its leaf's max, card against CPU."""
    out = {}
    for where in ("cpu", dev):
        model, loss_of, batch = _zoo_case(name, where)
        loss = loss_of(model, {k: v.to(where) for k, v in batch.items()})
        loss.backward()
        out[str(where)] = (float(loss.detach()), {
            n: p.grad.detach().cpu() for n, p in model.named_parameters()
            if p.grad is not None})
    (l_cpu, g_cpu), (l_dev, g_dev) = out["cpu"], out[str(dev)]
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu), (l_dev, l_cpu)
    assert set(g_dev) == set(g_cpu)
    if name == "bert":
        # the key bias's gradient is 0 in exact arithmetic (a constant
        # added to all of a query's logits): f32 noise on both devices,
        # held to 0 against the largest gradient, not to each other
        top = max(float(g.abs().max()) for g in g_cpu.values())
        for g in (g_cpu.pop("blocks.bk"), g_dev.pop("blocks.bk")):
            assert float(g.abs().max()) <= 1e-6 * top
    for n, g in g_cpu.items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((g_dev[n] - g).abs().max()) <= 1e-3 * scale, n


def test_moe_route_on_the_card_equals_the_cpu(dev):
    """The stable top-k on the card keeps ties in index order: the route
    of tied, over-capacity tokens equals the CPU's bit for bit."""
    from byteps_tpu_torch.models import moe

    cfg = moe.MoEConfig.tiny()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4096, cfg.dim, generator=gen)
    w = torch.randn(cfg.dim, cfg.n_experts, generator=gen) * 0.02
    w[:, 1] = w[:, 0]
    x[::3] = 0.0
    cap = moe.capacity(cfg, x.shape[0]) // 2
    probs = moe.router_probs(x, w)
    want = moe.route_probs(probs, cfg, cap)
    got = moe.route_probs(probs.to(dev), cfg, cap)
    for a, b in zip(got[:2], want[:2]):           # dispatch, combine
        assert torch.equal(a.cpu(), b)
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [1, 7, 4099, 32000 * 768])
def test_fused_adam_kernel_bit_exact_with_twin(dev, n):
    """One launch a leaf, bit for bit the twin at an odd length, lengths
    that are not a multiple of the 4-element vector and the embedding's,
    over 3 updates with growing counts; and on views one element in,
    which take the scalar path."""
    from byteps_tpu_torch.ops import fused_adam as FA

    g0 = torch.Generator(device=dev).manual_seed(n)
    p = torch.randn(n + 1, generator=g0, device=dev) * 0.1
    m = (torch.randn(n + 1, generator=g0, device=dev) * 1e-3).to(
        torch.bfloat16)
    v = torch.rand(n + 1, generator=g0, device=dev) * 1e-6
    for view in (slice(0, n), slice(1, n + 1)):
        got = [t[view].clone() for t in (p, m, v)]
        want = [t[view].clone() for t in (p, m, v)]
        for count in (1, 2, 1000):
            g = torch.randn(n, generator=g0, device=dev) * 1e-2
            bc1, bc2 = FA.bias_corrections(count, 0.9, 0.999)
            before = FA.fused_adam_leaf.launches
            FA.fused_adam_leaf(got[0], g, got[1], got[2], 1e-3, 0.9, 0.999,
                               1e-8, bc1, bc2)
            assert FA.fused_adam_leaf.launches == before + 1
            FA.fused_adam_leaf_plain(want[0], g, want[1], want[2], 1e-3,
                                     0.9, 0.999, 1e-8, bc1, bc2)
            torch.cuda.synchronize()
            for a, b, name in zip(got, want, "pmv"):
                assert torch.equal(a, b), (name, count, view,
                                           int((a != b).sum()))


def test_fused_adam_step_on_the_card_equals_its_twin(dev):
    """``fused_adam_step`` on Llama ``tiny()`` in f32 on the card: one
    launch a leaf a step, and the weights where the twin leaves them on
    the gradients the step computed (caught by hooks on the leaves)."""
    import dataclasses

    from byteps_tpu_torch.models import llama as tl
    from byteps_tpu_torch.ops import fused_adam as FA
    from byteps_tpu_torch.training import fused_adam_step

    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=64, seq=64),
                              dtype=torch.float32)
    model = tl.Llama(cfg, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, 64, (2, 65), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    params = model.params()
    leaves = list(model.parameters())
    twin = [p.detach().clone() for p in leaves]
    moments = [(torch.zeros_like(p, dtype=torch.bfloat16),
                torch.zeros_like(p)) for p in leaves]
    grads = {}
    hooks = [p.register_hook(lambda g, i=i: grads.__setitem__(i, g.clone()))
             for i, p in enumerate(leaves)]
    init, step = fused_adam_step(lambda p, b: tl.loss_fn(p, b, cfg))
    state = init(params)
    before = FA.fused_adam_leaf.launches
    step(params, state, {"tokens": tokens})
    assert FA.fused_adam_leaf.launches == before + len(leaves)
    for h in hooks:
        h.remove()
    bc1, bc2 = FA.bias_corrections(1, 0.9, 0.999)
    for i, (t, (m, v)) in enumerate(zip(twin, moments)):
        FA.fused_adam_leaf_plain(t, grads[i], m, v, 1e-3, 0.9, 0.999, 1e-8,
                                 bc1, bc2)
    for p, t in zip(leaves, twin):
        assert torch.equal(p.detach(), t)

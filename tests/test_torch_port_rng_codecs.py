"""The port's counter stream, dithering and randomk against the JAX
package, on numpy-seeded inputs.

- the rng twins are bit-exact with ``rng.np_*`` and ``rng.jnp_*``;
- the plain twins of the B4 and B5 kernels are bit-exact with the Pallas
  kernels in interpret mode and with the codecs' jnp paths;
- the codec payloads serialize to the host codecs' wire bytes (scale and
  norm, which come from reductions summed in other orders, to 1e-6;
  every bit, level and index exactly), and the port's host codecs write
  the JAX package's wire.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops.compression import host as jhost
from byteps_tpu.ops.compression import make_compressor as j_make
from byteps_tpu.ops.compression import pallas_kernels as PK
from byteps_tpu.ops.compression import rng as jrng
from byteps_tpu.ops.compression.codecs import DitheringCodec as JDither
from byteps_tpu_torch.ops.compression import host as thost
from byteps_tpu_torch.ops.compression import kernels as K
from byteps_tpu_torch.ops.compression import make_compressor
from byteps_tpu_torch.ops.compression import rng as trng
from byteps_tpu_torch.training.device_compression import (
    payload_to_wire, wire_to_payload,
)

SEEDS = [(0, 0), (7, 3), (123456789012, 2 ** 31 + 5), (2 ** 64 - 1, 2 ** 32 - 1)]


@pytest.fixture(autouse=True)
def numpy_host_codecs(monkeypatch):
    """The JAX host codecs as the numpy golden model, without their
    native (C++) acceleration."""
    monkeypatch.setenv("BYTEPS_NATIVE_CODEC", "0")


@pytest.mark.parametrize("seed,mix", SEEDS)
def test_stream_twins_bit_exact(seed, mix):
    assert trng.seed_state(seed) == jrng.seed_state(seed)
    assert trng.uniform_base(seed, mix) == int(jrng.uniform_base(seed, mix))
    n = 5003
    u = trng.uniform_parallel(seed, n, mix).numpy()
    np.testing.assert_array_equal(u, jrng.np_uniform_parallel(seed, n, mix))
    np.testing.assert_array_equal(
        u, np.asarray(jrng.jnp_uniform_parallel(seed, n, mix)))
    for size in (1, 1000, 3 * 2 ** 24 + 7, 2 ** 31 - 1):
        idx = trng.index_parallel(seed, n, size, mix).numpy()
        np.testing.assert_array_equal(
            idx, jrng.np_index_parallel(seed, n, size, mix))
        np.testing.assert_array_equal(
            idx, np.asarray(jrng.jnp_index_parallel(seed, n, size, mix)))


def test_mul32_keeps_the_low_32_bits():
    """(h * c) mod 2^32 in 16-bit halves, at the extremes of h."""
    h = np.array([0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                  0xFFFFFFFF, 0xDEADBEEF], np.uint32)
    for c in (trng.MM3_C1, trng.MM3_C2, trng.GOLDEN):
        got = trng._mul32(torch.from_numpy(h.astype(np.int64)), c).numpy()
        with np.errstate(over="ignore"):
            want = h * np.uint32(c)
        np.testing.assert_array_equal(got, want.astype(np.int64))


def _dither_input(n, seed):
    """Gaussian values with exact powers of two, and their neighbours one
    ulp either side, at the front; zeros; a ragged n."""
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    p2 = np.float32(2.0) ** -np.arange(32, dtype=np.float32)
    p2 *= np.where(np.arange(32) % 2, 1, -1).astype(np.float32)
    x[:32] = p2
    x[32:64] = np.nextafter(p2, np.float32(0))
    x[64:96] = np.nextafter(p2, np.float32(np.inf) * np.sign(p2))
    x[96:104] = 0.0
    return x


@pytest.mark.parametrize("partition", ["linear", "natural"])
@pytest.mark.parametrize("normalize", ["max", "l2"])
def test_dithering_twin_matches_pallas_and_codec(partition, normalize):
    n, s, seed, step = 4099, 127, 5, 3
    x = _dither_input(n, seed=len(partition) + len(normalize))
    codec = JDither(size=n, s=s, partition=partition, normalize=normalize,
                    seed=seed, use_pallas=False)
    payload = codec.compress(jnp.asarray(x), step=step)
    norm = np.asarray(payload["norm"])
    base = trng.uniform_base(seed, step)
    got = K.dithering_levels(torch.from_numpy(x), torch.tensor(norm), base,
                             s, partition).numpy()
    np.testing.assert_array_equal(got, np.asarray(payload["levels"]))
    pallas = PK.dithering_levels(jnp.asarray(x), jnp.asarray(norm),
                                 jnp.asarray(np.uint32(base)), s, partition,
                                 interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    # the base may also be a one-element tensor (read on the device)
    again = K.dithering_levels(torch.from_numpy(x), torch.tensor(norm),
                               torch.tensor(base), s, partition).numpy()
    np.testing.assert_array_equal(again, got)
    assert (got != 0).any() and (np.abs(got.astype(int)) <= 127).all()


@pytest.mark.parametrize("partition", ["linear", "natural"])
def test_dithering_codec_matches_jax(partition):
    n, seed, step = 1001, 9, 2
    x = _dither_input(n, seed=1)
    kw = {"compressor": "dithering", "s": "15", "seed": str(seed),
          "partition_type": partition}
    tc = make_compressor(kw, n).codec
    jc = j_make(kw, n).codec
    tp = tc.compress(torch.from_numpy(x), step)
    jp = jc.compress(jnp.asarray(x), step)
    np.testing.assert_array_equal(tp["levels"].numpy(),
                                  np.asarray(jp["levels"]))
    assert float(tp["norm"]) == float(jp["norm"])
    # decompressed: under the linear partition bit-exact with the jitted
    # jnp codec (|lv| * (1/s), as XLA folds |lv| / s) and within an ulp
    # of the numpy golden, which divides; under the natural partition
    # bit-exact with the numpy golden (exact powers of two), and XLA's
    # exp2, a few ulp off at integer arguments, within 2e-6
    import jax
    dec = tc.decompress(tp).numpy()
    wire = jhost.make_host_codec(kw, n).compress(x, step)
    host = jhost.make_host_codec(kw, n).decompress(
        np.frombuffer(wire, np.uint8))
    jdec = np.asarray(jax.jit(jc.decompress)(jp))
    if partition == "linear":
        np.testing.assert_array_equal(dec, jdec)
        ulp = np.spacing(np.abs(host)).astype(np.float32)
        assert (np.abs(dec - host) <= ulp).all()
    else:
        np.testing.assert_array_equal(dec, host)
        np.testing.assert_allclose(dec, jdec, rtol=2e-6)
        assert _ulps(dec, jdec).max() <= NATURAL_EXP2_ULPS


# XLA's exp2 on the CPU at the natural partition's levels 1..32 (the
# reachable ones: j <= 30 halvings, stored j + 2 at most) is off the exact
# power of two by at most this many f32 ulp (17 at level 27; levels 1..13
# exact). The port keeps exact powers, as the numpy host codec, the C++
# server's decode and BytePS's dithering.cc do.
NATURAL_EXP2_ULPS = 17


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_natural_dithering_exception_stays_within_its_bound():
    """The recorded exception of the natural partition: against the
    jitted JAX codec over 12 seeds x 2 steps of 4099 elements spread over
    12 binary orders (levels up to 32): XLA's exp2 is at most 17 ulp off
    at the levels, so the decompressed values stay within 17 ulp where
    the levels agree; the levels themselves (whose bounds 2^-j, 2^-j-1
    come from the same exp2) differ in at most 1 element in 10,000, by
    one level. Against the numpy host codec (exact powers) the port is
    bit for bit."""
    import jax
    n = 4099
    jexp2 = np.asarray(jax.jit(lambda a: jnp.exp2(-(a - 1.0)))(
        np.arange(1, 33, dtype=np.float32)))
    exact = np.ldexp(np.float32(1), -np.arange(0, 32)).astype(np.float32)
    assert _ulps(jexp2, exact).max() == NATURAL_EXP2_ULPS
    seen, moved, worst, top = 0, 0, 0, 0
    for seed in range(12):
        kw = {"compressor": "dithering", "s": "127", "seed": str(seed),
              "partition_type": "natural"}
        tc, jc = make_compressor(kw, n).codec, j_make(kw, n).codec
        rs = np.random.default_rng(seed)
        x = (rs.standard_normal(n) * np.exp2(rs.uniform(-12, 0, n))
             ).astype(np.float32)
        for step in range(2):
            tp = tc.compress(torch.from_numpy(x), step)
            jp = jax.jit(lambda v, step=step: jc.compress(v, step))(
                jnp.asarray(x))
            tl, jl = tp["levels"].numpy(), np.asarray(jp["levels"])
            assert float(tp["norm"]) == float(jp["norm"])
            same = tl == jl
            seen += n
            moved += int((~same).sum())
            assert (np.abs(tl[~same].astype(int) - jl[~same]) == 1).all()
            dec = tc.decompress(tp).numpy()
            jdec = np.asarray(jax.jit(jc.decompress)(jp))
            worst = max(worst, int(_ulps(dec, jdec)[same].max()))
            top = max(top, int(np.abs(tl.astype(int)).max()))
            wire = jhost.make_host_codec(kw, n).compress(x, step)
            assert np.frombuffer(wire, np.int8)[:n].tolist() == tl.tolist()
            host = jhost.make_host_codec(kw, n).decompress(
                np.frombuffer(wire, np.uint8))
            np.testing.assert_array_equal(dec, host)
    assert top >= 27 and worst <= NATURAL_EXP2_ULPS
    assert moved * 10_000 <= seen


@pytest.mark.parametrize("size,k", [(1000, 10), (3 * 2 ** 24 + 7, 4099)])
def test_randomk_twin_matches_pallas_and_golden(size, k):
    base = trng.uniform_base(1, 2)
    got = K.randomk_indices(base, size, k, "cpu").numpy()
    np.testing.assert_array_equal(got, jrng.np_index_parallel(1, k, size, 2))
    pallas = PK.randomk_indices(jnp.asarray(np.uint32(base)),
                                jnp.int32(size), k, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() < size


def test_randomk_codec_matches_jax():
    n, kw = 2000, {"compressor": "randomk", "k": "0.05", "seed": "11"}
    x = np.random.RandomState(4).randn(n).astype(np.float32)
    tc, jc = make_compressor(kw, n).codec, j_make(kw, n).codec
    tp, jp = tc.compress(torch.from_numpy(x), 6), jc.compress(
        jnp.asarray(x), 6)
    np.testing.assert_array_equal(tp["indices"].numpy(),
                                  np.asarray(jp["indices"]))
    np.testing.assert_array_equal(tp["values"].numpy(),
                                  np.asarray(jp["values"]))
    np.testing.assert_array_equal(tc.decompress(tp).numpy(),
                                  np.asarray(jc.decompress(jp)))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="flat"):
        K.dithering_levels(torch.zeros(2, 2), torch.tensor(1.0), 0, 7)
    with pytest.raises(ValueError, match="partition"):
        K.dithering_levels(torch.zeros(4), torch.tensor(1.0), 0, 7, "log")
    with pytest.raises(ValueError, match="size"):
        K.randomk_indices(0, 0, 4, "cpu")


KWS = [
    {"compressor": "onebit"},
    {"compressor": "onebit", "scaling": "false"},
    {"compressor": "randomk", "k": "16", "seed": "3"},
    {"compressor": "dithering", "s": "32", "seed": "9"},
    {"compressor": "dithering", "k": "7", "seed": "1",
     "partition_type": "natural"},
]


@pytest.mark.parametrize("kw", KWS, ids=lambda kw: "-".join(kw.values()))
def test_payload_serializes_to_the_host_wire(kw):
    """payload_to_wire of the port's payload is the host codec's wire
    (tests/test_device_compress.py:33-74 for the JAX tier)."""
    n = 300
    x = np.random.RandomState(7).randn(n).astype(np.float32)
    codec = make_compressor(kw, n).codec
    payload = codec.compress(torch.from_numpy(x), step=4)
    wire = payload_to_wire(codec, {k: v.numpy() for k, v in payload.items()})
    hwire = np.frombuffer(jhost.make_host_codec(kw, n).compress(x, step=4),
                          np.uint8)
    assert wire.nbytes == hwire.nbytes == \
        jhost.make_host_codec(kw, n).wire_bytes() == codec.wire_bytes()
    body = slice(None)
    if kw["compressor"] in ("onebit", "dithering"):
        body = slice(0, wire.nbytes - 4)
        np.testing.assert_allclose(wire[-4:].copy().view(np.float32),
                                   hwire[-4:].copy().view(np.float32),
                                   rtol=1e-6)
    np.testing.assert_array_equal(wire[body], hwire[body])
    parsed = wire_to_payload(codec, n, wire)
    dec = codec.decompress({k: torch.from_numpy(np.array(v))
                            for k, v in parsed.items()}).numpy()
    np.testing.assert_allclose(
        dec, jhost.make_host_codec(kw, n).decompress(hwire), rtol=1e-6)


@pytest.mark.parametrize("kw", KWS, ids=lambda kw: "-".join(kw.values()))
def test_port_host_codecs_write_the_jax_wire(kw):
    n = 257
    rs = np.random.RandomState(3)
    t, j = thost.make_host_codec(kw, n), jhost.make_host_codec(kw, n)
    assert (t.kwargs_wire(), t.wire_bytes()) == (j.kwargs_wire(),
                                                 j.wire_bytes())
    for step in range(3):
        x = rs.randn(n).astype(np.float32)
        tw, jw = t.compress(x, step), j.compress(x, step)
        assert tw == jw
        np.testing.assert_array_equal(
            t.decompress(np.frombuffer(tw, np.uint8)),
            j.decompress(np.frombuffer(jw, np.uint8)))


@pytest.mark.parametrize("kw", [
    {"compressor": "onebit", "ef": "vanilla"},
    {"compressor": "randomk", "k": "16", "seed": "3", "ef": "vanilla"},
    {"compressor": "dithering", "s": "32", "seed": "9", "ef": "vanilla"},
    {"compressor": "dithering", "seed": "1", "ef": "vanilla",
     "momentum": "nesterov", "momentum_mu": "0.8"},
], ids=lambda kw: "-".join(kw.values()))
def test_port_host_ef_and_momentum_write_the_jax_wire(kw):
    """The host error feedback and Nesterov momentum stacks carry their
    state across rounds as the JAX package's: the same wire bytes every
    round, the same residual and momentum after the last."""
    n = 257
    rs = np.random.RandomState(6)
    t, j = thost.make_host_codec(kw, n), jhost.make_host_codec(kw, n)
    assert type(t).__name__ == type(j).__name__
    assert (t.kwargs_wire(), t.wire_bytes()) == (j.kwargs_wire(),
                                                 j.wire_bytes())
    for step in range(3):
        x = rs.randn(n).astype(np.float32)
        assert t.compress(x, step) == j.compress(x, step), step
    ef_t, ef_j = (getattr(c, "inner", c) for c in (t, j))
    np.testing.assert_array_equal(ef_t.error, ef_j.error)
    if "momentum" in kw:
        np.testing.assert_array_equal(t.m, j.m)


def test_host_momentum_needs_error_feedback():
    with pytest.raises(ValueError, match="momentum requires ef"):
        thost.make_host_codec({"compressor": "onebit",
                               "momentum": "nesterov"}, 10)

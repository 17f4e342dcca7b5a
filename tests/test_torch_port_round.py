"""The round form of the B4 and B5 kernels against the partition-by-
partition form and the JAX package, on numpy-seeded inputs.

- the plain twins of a dithering round (linear and natural, max and L2
  norms) and of a randomk round equal the one-partition twins bit for
  bit, and the Pallas kernels in interpret mode on each partition, over a
  round of ragged partitions with unaligned slots;
- with ``BYTEPS_PARTITION_BYTES=8192`` for both packages, so that leaves
  split into several partitions with ragged tails (some of them dense),
  two device-compressed PS rounds under dithering + EF and under randomk
  + EF push the wire bytes of the partition-by-partition path and of the
  JAX ``DeviceCompressor``, and get the JAX aggregate back;
- the dithering residual and dequantization round as the JAX package's
  under XLA (a reciprocal and an FMA), and the FMA twin rounds once on
  constructed double-rounding cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops.compression import pallas_kernels as PK
from byteps_tpu.ops.compression import rng as jrng
from byteps_tpu_torch.ops.compression import kernels as K
from byteps_tpu_torch.ops.compression import rng as trng
from byteps_tpu_torch.ops.compression.codecs import DitheringCodec
from _torch_port_ps_util import (
    LEAVES, MIN_BYTES, PARTITION_BYTES, ROUND_KWS, ROUND_MEMBERS, _ps_env,
    bounded, errors, leaves, partition_path_wires, path_round_lengths,
    port_rounds, record_wires, ps_server,
)
from test_torch_port_ps import jax_uses_port_lib, ps_lib  # noqa: F401


SIZES = [1, 15, 16, 17, 4099, 8192]
# slots that start off 16-byte (and, for x, off 4-element) boundaries
GAP = 3


def _round_layout(sizes, gap):
    """x and out offsets of a round with ``gap`` unused elements before
    each partition: offsets 3, 7, 25, 44, 64, 4166 for gap 3."""
    x_offs, out_offs, x, o = [], [], 0, 0
    for n in sizes:
        x, o = x + gap, o + gap + 1
        x_offs.append(x)
        out_offs.append(o)
        x, o = x + n, o + n
    return x_offs, out_offs, x, o


@pytest.mark.parametrize("normalize", ["max", "l2"])
@pytest.mark.parametrize("partition", ["linear", "natural"])
def test_dithering_round_twin_equals_partitions_and_pallas(partition,
                                                           normalize):
    x_offs, out_offs, n_x, n_out = _round_layout(SIZES, GAP)
    rs = np.random.RandomState(len(partition) + len(normalize))
    x = torch.from_numpy(rs.randn(n_x).astype(np.float32))
    x[x_offs[-1]: x_offs[-1] + 8] = 0.0
    s, base = 127, trng.uniform_base(5, 3)
    codec = DitheringCodec(size=1, s=s, partition=partition,
                           normalize=normalize)
    norms = torch.stack([codec.norm(x[a: a + n])
                         for a, n in zip(x_offs, SIZES)])
    table = K.dithering_table(x_offs, SIZES, out_offs)
    out = torch.full((n_out,), 99, dtype=torch.int8)
    got = K.dithering_levels_round(x, norms, table, base, s, partition, out)
    assert got is out
    for a, o, n, norm in zip(x_offs, out_offs, SIZES, norms):
        want = K.dithering_levels(x[a: a + n], norm, base, s, partition)
        np.testing.assert_array_equal(out[o: o + n].numpy(), want.numpy())
        pallas = PK.dithering_levels(
            jnp.asarray(x[a: a + n].numpy()), jnp.asarray(norm.numpy()),
            jnp.asarray(np.uint32(base)), s, partition, interpret=True)
        np.testing.assert_array_equal(want.numpy(), np.asarray(pallas))
    # the gaps between slots stay untouched
    written = np.zeros(n_out, bool)
    for o, n in zip(out_offs, SIZES):
        written[o: o + n] = True
    assert (out.numpy()[~written] == 99).all()


def test_randomk_round_twin_equals_partitions_pallas_and_golden():
    ks = [1, 15, 16, 17, 4099, 40]
    sizes = [n + 1000 for n in SIZES]
    _, out_offs, _, n_out = _round_layout(ks, GAP)
    seed, step = 3, 7
    base = trng.uniform_base(seed, step)
    table = K.randomk_table(sizes, ks, out_offs)
    out = torch.full((n_out,), -1, dtype=torch.int32)
    K.randomk_indices_round(table, base, out)
    for o, size, k in zip(out_offs, sizes, ks):
        got = out[o: o + k].numpy()
        np.testing.assert_array_equal(
            got, K.randomk_indices(base, size, k, "cpu").numpy())
        np.testing.assert_array_equal(
            got, jrng.np_index_parallel(seed, k, size, step))
        pallas = PK.randomk_indices(jnp.asarray(np.uint32(base)),
                                    jnp.int32(size), k, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(pallas))
    assert (out.numpy()[np.isin(np.arange(n_out), np.concatenate(
        [np.arange(o, o + k) for o, k in zip(out_offs, ks)]),
        invert=True)] == -1).all()


def test_the_training_paths_round():
    """125 partitions of LlamaConfig.small(), 124,649,472 elements, and
    1,246,489 randomk indices at k = 1%: the round the card runs."""
    from byteps_tpu_torch.ops.compression.codecs import resolve_k
    ns = path_round_lengths()
    assert (len(ns), sum(ns)) == (125, 124_649_472)
    assert sum(resolve_k(0.01, n) for n in ns) == 1_246_489
    table = K.dithering_table(np.cumsum([0] + ns[:-1]), ns,
                              np.cumsum([0] + ns[:-1]))
    assert table.n_tiles == sum(-(-n // K.DITHER_TILE) for n in ns)


def test_round_tables_and_wrappers_refuse_what_they_do_not_take():
    t = K.dithering_table([0, 10], [10, 0], [0, 10])
    assert t.tile_start.tolist() == [0, 1, 1] and t.n_tiles == 1
    assert K.randomk_table([5000, 1], [2049, 1], [0, 2049]) \
        .tile_start.tolist() == [0, 3, 4]
    with pytest.raises(ValueError, match="size"):
        K.randomk_table([0], [1], [0])
    with pytest.raises(ValueError, match="smaller"):
        K.dithering_levels_round(torch.zeros(5), torch.ones(2), t, 0, 7,
                                 "linear", torch.zeros(10, dtype=torch.int8))
    with pytest.raises(ValueError, match="int32"):
        K.randomk_indices_round(K.randomk_table([4], [2], [0]), 0,
                                torch.zeros(2, dtype=torch.int64))


# --------------------------------------------------------------------- #
# PS rounds against the partition-by-partition path and the JAX package
# --------------------------------------------------------------------- #

def _jax_rounds(monkeypatch, kw):
    """The JAX DeviceCompressor's two rounds: wires, aggregates and the
    residuals after the first round."""
    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState, get_state
    from byteps_tpu.jax.device_compression import DeviceCompressor

    wires, outs, errs = [], [], []
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        monkeypatch.setenv("BYTEPS_PARTITION_BYTES", str(PARTITION_BYTES))
        GlobalState._instance = None
        jbps.init()
        try:
            state = get_state()
            record_wires(state, wires)
            dc = DeviceCompressor(state.ps_client, 1, kw, MIN_BYTES)

            def run():
                for step in range(2):
                    out = dc.push_pull_leaves(
                        state, list(LEAVES),
                        [jnp.asarray(x) for x in leaves(step)],
                        average=False)
                    outs.append([np.asarray(o) for o in out])
                    errs.append(errors(dc))

            bounded(run, timeout=120)
        finally:
            jbps.shutdown()
            GlobalState._instance = None
    return wires, outs, errs[0]


# the branches off the training path as well: momentum, natural levels,
# L2 norms, and no error feedback
PATH_KWS = ROUND_KWS + [
    {"compressor": "dithering", "ef": "vanilla", "momentum": "nesterov",
     "partition_type": "natural", "normalize_type": "l2", "seed": "2"},
    {"compressor": "randomk", "k": "0.05", "seed": "8"},
]


@pytest.mark.parametrize("kw", PATH_KWS, ids=["dithering", "randomk",
                                              "dithering-momentum-natural-l2",
                                              "randomk-no-ef"])
def test_ps_round_pushes_the_partition_path_wire_bytes(kw, ps_lib,
                                                       monkeypatch,
                                                       jax_uses_port_lib):
    wires, _, _, spec = port_rounds(monkeypatch, kw)
    # the round took the partitions the layout says, three leaves whole
    assert [m[3] for m in spec.round.members] == ROUND_MEMBERS
    assert set(spec.round.whole) == {0, 1, 2}
    assert wires == partition_path_wires(kw)


# beside the path's rounds: Nesterov momentum (XLA's two FMAs) with the
# L2 norm (XLA's summation order), and the onebit tier (its L1-mean scale)
JAX_WIRE_KWS = ROUND_KWS + [
    {"compressor": "dithering", "ef": "vanilla", "momentum": "nesterov",
     "normalize_type": "l2", "seed": "2"},
    {"compressor": "randomk", "k": "0.05", "ef": "vanilla",
     "momentum": "nesterov", "seed": "8"},
    {"compressor": "onebit", "ef": "vanilla"},
]


@pytest.mark.parametrize("kw", JAX_WIRE_KWS, ids=[
    "dithering", "randomk", "dithering-momentum-l2", "randomk-momentum",
    "onebit"])
def test_ps_rounds_push_the_jax_wire_bytes(kw, ps_lib, monkeypatch,
                                           jax_uses_port_lib):
    """Both rounds push the JAX DeviceCompressor's bytes, carry its
    residuals and momentum bit for bit into the second round and get its
    aggregate bit for bit: the port's dithering residual and
    dequantization round as XLA's (reciprocal and FMA, the test below),
    its momentum as XLA's FMAs, its L2 norm and onebit scale in XLA's
    summation order."""
    j_wires, j_outs, j_errors = _jax_rounds(monkeypatch, kw)
    t_wires, t_outs, t_errors, _ = port_rounds(monkeypatch, kw)
    assert t_errors.keys() == j_errors.keys()
    for key, e in t_errors.items():
        np.testing.assert_array_equal(e, j_errors[key], err_msg=str(key))
    assert len(t_wires) == len(j_wires) == 2 * len(LEAVES)
    for (tn, tw), (jn, jw) in zip(t_wires, j_wires):
        assert tn == jn and len(tw) == len(jw)
        for i, (a, b) in enumerate(zip(tw, jw)):
            assert a == b, f"{tn} partition {i}: wire bytes differ"
    for t_round, j_round in zip(t_outs, j_outs):
        for name, t, j in zip(LEAVES, t_round, j_round):
            np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("normalize", ["max", "l2"])
def test_jax_dithering_residual_rounds_by_reciprocal_and_fma(normalize):
    """XLA on the CPU runs DitheringCodec.decompress's |lv| / s as
    |lv| * (1/s) and contracts the EF residual x - dec * norm into one
    FMA; the port's residual and decompress equal the JAX ones bit for
    bit, and differ from the residual rounded as written."""
    import jax

    from byteps_tpu.ops.compression import make_compressor as j_make
    from byteps_tpu_torch.ops.compression import make_compressor

    n, kw = 4096, {"compressor": "dithering", "ef": "vanilla", "seed": "4",
                   "normalize_type": normalize}
    x = np.random.RandomState(5).randn(n).astype(np.float32)
    jstack, tstack = j_make(kw, n), make_compressor(kw, n)
    jpl, jst = jax.jit(lambda v, st: jstack.compress(v, st, 0))(
        jnp.asarray(x), jstack.init_state(n))
    tpl, tst = tstack.compress(torch.from_numpy(x), tstack.init_state(n), 0)
    lv = tpl["levels"].numpy().astype(np.float32)
    norm = tpl["norm"].numpy()
    np.testing.assert_array_equal(lv, np.asarray(jpl["levels"]))
    assert norm == np.asarray(jpl["norm"])
    np.testing.assert_array_equal(tst["error"].numpy(),
                                  np.asarray(jst["error"]))
    np.testing.assert_array_equal(
        tstack.codec.decompress(tpl).numpy(),
        np.asarray(jax.jit(jstack.codec.decompress)(jpl)))
    s = np.float32(127)
    as_written = x - np.sign(lv) * (np.abs(lv) / s) * norm
    assert (tst["error"].numpy() != as_written).any()


def _f32_fma_exact(a, b, c):
    """The nearest f32 to a * b + c, from exact rational arithmetic (ties
    to the even significand)."""
    from fractions import Fraction
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    cands = [near, np.nextafter(near, np.float32(np.inf)),
             np.nextafter(near, np.float32(-np.inf))]
    best = min(abs(Fraction(float(v)) - exact) for v in cands)
    ties = [v for v in cands if abs(Fraction(float(v)) - exact) == best]
    return min(ties, key=lambda v: int(np.array(v).view(np.uint32)) & 1)


def _double_rounding_cases():
    """f32 (a, b, c) whose exact a * b + c lies 2^-60 of its size away
    from a point halfway between two f32, at several exponents: the f64
    sum rounds onto the midpoint, and f64 -> f32 then rounds the tie to
    even, which is the wrong side for half of them. a * b is the midpoint
    (an odd 25-bit significand split into two 24-bit factors); c tips
    it."""
    rs = np.random.RandomState(0)
    cases = []
    while len(cases) < 48:
        m = (1 << 24) + 2 * int(rs.randint(0, 1 << 23)) + 1
        f = next((d for d in range(3, 4097, 2) if m % d == 0), None)
        if f is None or m // f >= 1 << 24:
            continue
        e = int(rs.randint(-20, 20))
        a = np.float32(np.ldexp(f, e - 12))
        b = np.float32(np.ldexp(m // f, -12 - 24 + 12))
        tip = np.float32(np.ldexp(1.0, e - 12 - 60))
        sign = np.float32(1 if len(cases) % 2 else -1)
        cases.append((a, sign * b, sign * tip))
        cases.append((a, b, -tip))
    return [tuple(np.float32(v) for v in c) for c in cases]


def test_fma_twin_rounds_once_on_double_rounding_cases():
    """The plain twin of the residual's FMA against exact arithmetic, on
    constructed inputs where a sum in f64 rounded again to f32 is wrong,
    and on random ones."""
    cases = _double_rounding_cases()
    rs = np.random.RandomState(1)
    rand = rs.randn(3, 2000).astype(np.float32)
    rand[2] *= np.float32(2.0) ** rs.randint(-30, 30, 2000)
    a, b, c = (np.concatenate([np.array([k[i] for k in cases], np.float32),
                               rand[i]]) for i in range(3))
    got = K.fma_f32_plain(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_f32_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive[: len(cases)] != want[: len(cases)]).sum() >= len(cases) // 4


@pytest.mark.parametrize("partition", ["linear", "natural"])
def test_dequantize_round_twin_equals_partitions(partition):
    """The dequantization round's twin over ragged partitions with
    unaligned slots: each partition's aggregate and residual equal the
    one-partition form's, and the gaps stay untouched."""
    x_offs, lv_offs, n_x, n_lv = _round_layout(SIZES, GAP)
    rs = np.random.RandomState(len(partition))
    lv_hi = 127 if partition == "linear" else 126
    levels = torch.from_numpy(rs.randint(-lv_hi, lv_hi + 1, n_lv)
                              .astype(np.int8))
    norms = torch.from_numpy(rs.rand(len(SIZES)).astype(np.float32) + 0.5)
    x = torch.from_numpy(rs.randn(n_x).astype(np.float32))
    table = K.dithering_table(x_offs, SIZES, lv_offs)
    out = K.dithering_dequantize_round(levels, norms, table, 127, partition,
                                       torch.full((n_x,), 7.0))
    res = K.dithering_dequantize_round(levels, norms, table, 127, partition,
                                       x.clone(), residual=True)
    written = np.zeros(n_x, bool)
    for a, o, n, norm in zip(x_offs, lv_offs, SIZES, norms):
        lv = levels[o: o + n]
        np.testing.assert_array_equal(
            out[a: a + n].numpy(),
            K.dithering_dequantize(lv, norm, 127, partition).numpy())
        np.testing.assert_array_equal(
            res[a: a + n].numpy(),
            K.dithering_dequantize(lv, norm, 127, partition,
                                   residual_of=x[a: a + n].clone()).numpy())
        written[a: a + n] = True
    assert (out.numpy()[~written] == 7.0).all()
    np.testing.assert_array_equal(res.numpy()[~written], x.numpy()[~written])

"""Dithering's varint index coding and the native (C++) codec of the
port's host tier against the JAX package.

- ``_varint_encode``/``_varint_decode`` give the JAX coder's bytes and
  values on gaps that include 0, 127, 128 and values of 2^28 and more,
  and refuse a truncated stream or a value past 35 bits as it does;
- ``HostDithering(index_coding="varint")`` writes the JAX numpy tier's
  wire, byte for byte, with its bound, for linear and natural partitions
  under max and l2 normalization; a truncated wire, trailing bytes and
  bad indices raise as they do in JAX;
- ``native.NativeCodec`` writes the JAX ``NativeCodec``'s wire for onebit,
  topk, randomk, default dithering and varint dithering; against the
  numpy tier its topk, randomk and dithering wires are the same bytes,
  and onebit's signs are with the scale within an ulp;
- ``maybe_native`` takes the configurations the JAX ``_eligible`` takes,
  and BYTEPS_NATIVE_CODEC=0 gives the numpy tier;
- two host-codec PS steps of Llama ``tiny()`` with the native codec on in
  both packages match at the tolerance of the numpy tier's test.
"""

import numpy as np
import pytest

from byteps_tpu.ops.compression import host as jhost
from byteps_tpu_torch.ops.compression import host as thost
from byteps_tpu_torch.ops.compression import native as tnative
from test_torch_port_dense_ps import jax_ps_run, port_ps_run
from test_torch_port_ps import ps_lib  # noqa: F401

GAPS = np.array([1, 0, 127, 128, 129, 16383, 16384, 2 ** 21 - 1, 2 ** 21,
                 2 ** 28 - 1, 2 ** 28, 2 ** 28 + 5, 2 ** 31, 2 ** 35 - 1],
                np.int64)


@pytest.fixture()
def numpy_tier(monkeypatch):
    monkeypatch.setenv("BYTEPS_NATIVE_CODEC", "0")


@pytest.fixture()
def jax_native(ps_lib, monkeypatch):
    """The JAX native codec on the port's build of the same ps.cc, with
    its loader's latches reset."""
    import byteps_tpu.native.build as jbuild
    from byteps_tpu.ops.compression import native as jnative
    from byteps_tpu.server import client as jclient
    for mod in (jbuild, jclient):
        monkeypatch.setattr(mod, "build", lambda *a, **k: ps_lib)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_LOAD_FAILED", False)
    monkeypatch.delenv("BYTEPS_NATIVE_CODEC", raising=False)
    return jnative


def test_varint_coder_matches_jax():
    for gaps in (GAPS, GAPS[:1], GAPS[:0], np.arange(300, dtype=np.int64)):
        tb, jb = thost._varint_encode(gaps), jhost._varint_encode(gaps)
        assert tb.tobytes() == jb.tobytes()
        stream = np.concatenate([tb, np.array([5, 0x81], np.uint8)])
        tv, tn = thost._varint_decode(stream, len(gaps))
        jv, jn = jhost._varint_decode(stream, len(gaps))
        np.testing.assert_array_equal(tv, gaps)
        np.testing.assert_array_equal(tv, jv)
        assert tn == jn == len(tb)


@pytest.mark.parametrize("stream,count", [
    (np.array([0x80, 0x80], np.uint8), 1),                   # truncated
    (np.array([5, 6], np.uint8), 3),                         # too few
    (np.array([0xFF] * 6 + [1], np.uint8), 1),               # > 35 bits
], ids=["truncated", "too-few", "too-long"])
def test_varint_decode_refuses_as_jax(stream, count):
    msgs = []
    for mod in (thost, jhost):
        with pytest.raises(ValueError) as e:
            mod._varint_decode(stream, count)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _sparse_input(n, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n) * rs.rand(n) ** 8).astype(np.float32)
    x[rs.rand(n) < 0.3] = 0.0
    return x


VARINT_KWS = [dict(compressor="dithering", s=s, partition_type=p,
                   normalize_type=m, seed="5", index_coding="varint")
              for s in ("3", "127") for p in ("linear", "natural")
              for m in ("max", "l2")]


@pytest.mark.parametrize("kw", VARINT_KWS, ids=lambda kw: "-".join(
    (kw["s"], kw["partition_type"], kw["normalize_type"])))
def test_varint_dithering_wire_matches_the_jax_numpy_tier(kw, numpy_tier):
    n = 5003
    t, j = thost.make_host_codec(kw, n), jhost.make_host_codec(kw, n)
    assert isinstance(t, thost.HostDithering)
    assert (t.kwargs_wire(), t.wire_bytes()) == (j.kwargs_wire(),
                                                 j.wire_bytes())
    dense = thost.make_host_codec(dict(kw, index_coding="dense"), n)
    for step in range(3):
        x = _sparse_input(n, step)
        tw, jw = t.compress(x, step), j.compress(x, step)
        assert tw == jw
        assert len(tw) <= t.wire_bytes()
        out = t.decompress(np.frombuffer(tw, np.uint8))
        np.testing.assert_array_equal(out, j.decompress(
            np.frombuffer(jw, np.uint8)))
        # the same levels as the dense wire
        np.testing.assert_array_equal(out, dense.decompress(np.frombuffer(
            dense.compress(x, step), np.uint8)))
    if (kw["s"], kw["partition_type"]) == ("3", "linear"):
        assert len(tw) < n // 2       # most levels are 0


def _bad_varint_wires():
    n = 64
    codec = jhost.HostDithering(n=n, s=3, index_coding="varint")
    good = codec.compress(_sparse_input(n, 9), 0)
    nnz = int(np.frombuffer(good[:4], np.uint32)[0])
    norm = good[-4:]
    return n, {
        "truncated": good[:-5],
        "trailing": good[:-4] + b"\x00" + norm,
        "nnz-above-n": np.uint32(n + 1).tobytes() + good[4:],
        "zero-gap": np.uint32(2).tobytes() + bytes([1, 0, 1, 1]) + norm,
        "index-past-n": np.uint32(1).tobytes() + bytes([n + 1, 1]) + norm,
        "gaps-short": good[:4] + good[4:4 + nnz - 1] + good[-4 - nnz:],
    }


@pytest.mark.parametrize("name", sorted(_bad_varint_wires()[1]))
def test_bad_varint_wires_raise_as_in_jax(name):
    n, wires = _bad_varint_wires()
    msgs = []
    for mod in (thost, jhost):
        codec = mod.HostDithering(n=n, s=3, index_coding="varint")
        with pytest.raises(ValueError) as e:
            codec.decompress(wires[name])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


NATIVE_KWS = [
    {"compressor": "onebit"},
    {"compressor": "onebit", "scaling": "false"},
    {"compressor": "topk", "k": "0.01"},
    {"compressor": "randomk", "k": "0.02", "seed": "3"},
    {"compressor": "dithering", "seed": "4"},
    {"compressor": "dithering", "s": "3", "seed": "4",
     "index_coding": "varint"},
]


def _kw_id(kw):
    return "-".join(kw.values())


@pytest.mark.parametrize("kw", NATIVE_KWS, ids=_kw_id)
def test_native_wire_matches_the_jax_native_codec(kw, jax_native):
    n = 10007
    t, j = thost.make_host_codec(kw, n), jhost.make_host_codec(kw, n)
    assert isinstance(t, tnative.NativeCodec)
    assert isinstance(j, jax_native.NativeCodec)
    assert (t.kwargs_wire(), t.wire_bytes()) == (j.kwargs_wire(),
                                                 j.wire_bytes())
    for step in range(3):
        x = _sparse_input(n, 30 + step)
        tw, jw = t.compress(x, step), j.compress(x, step)
        assert tw.tobytes() == jw.tobytes()
        np.testing.assert_array_equal(t.decompress(tw), j.decompress(jw))


@pytest.mark.parametrize("kw", NATIVE_KWS, ids=_kw_id)
def test_native_wire_is_the_numpy_tiers(kw, ps_lib, monkeypatch):
    n = 10007
    monkeypatch.delenv("BYTEPS_NATIVE_CODEC", raising=False)
    native = thost.make_host_codec(kw, n)
    monkeypatch.setenv("BYTEPS_NATIVE_CODEC", "0")
    numpy_tier = thost.make_host_codec(kw, n)
    assert not isinstance(numpy_tier, tnative.NativeCodec)
    for step in range(3):
        x = _sparse_input(n, 40 + step)
        a = native.compress(x, step).tobytes()
        b = numpy_tier.compress(x, step)
        if kw["compressor"] != "onebit":
            assert a == b
            continue
        assert a[:-4] == b[:-4]                      # the signs
        sa, sb = (np.frombuffer(w[-4:], np.float32)[0] for w in (a, b))
        assert abs(int(np.float32(sa).view(np.int32))
                   - int(np.float32(sb).view(np.int32))) <= 1, (sa, sb)


@pytest.mark.parametrize("native", ["1", "0"], ids=["native", "numpy"])
@pytest.mark.parametrize("kw", NATIVE_KWS + [
    {"compressor": "lossless"},
    {"compressor": "dithering", "seed": "4", "ef": "vanilla",
     "index_coding": "varint"},
    {"compressor": "topk", "k": "0.01", "ef": "vanilla",
     "momentum": "nesterov"}], ids=_kw_id)
def test_a_fixed_wire_is_its_bound_and_only_a_variable_one_is_shorter(
        kw, native, ps_lib, monkeypatch):
    """The scheduler takes a reply shorter than ``wire_bytes()`` only
    from a stack whose ``variable_wire`` is set; every other wire is
    exactly its bound."""
    monkeypatch.setenv("BYTEPS_NATIVE_CODEC", native)
    n = 10007
    codec = thost.make_host_codec(kw, n)
    variable = kw["compressor"] == "lossless" or \
        kw.get("index_coding") == "varint"
    assert codec.variable_wire == variable
    for step in range(2):
        x = _sparse_input(n, 50 + step)
        wl = len(codec.compress(x, step))
        if variable:
            assert wl < codec.wire_bytes()
        else:
            assert wl == codec.wire_bytes()


GRID = [dict(compressor=c) for c in ("onebit", "topk", "randomk",
                                     "lossless", "bogus")] + [
    dict(compressor="dithering", **pt, **nt, **ic)
    for pt in ({}, {"partition_type": "linear"},
               {"partition_type": "natural"})
    for nt in ({}, {"normalize_type": "max"}, {"normalize_type": "l2"})
    for ic in ({}, {"index_coding": "varint"})]


def test_eligibility_is_the_jax_packages():
    from byteps_tpu.ops.compression import native as jnative
    for kw in GRID:
        assert tnative.eligible(kw) == jnative._eligible(kw), kw


def test_native_codec_off_gives_the_numpy_tier(ps_lib, monkeypatch):
    kw = {"compressor": "onebit", "ef": "vanilla"}
    monkeypatch.delenv("BYTEPS_NATIVE_CODEC", raising=False)
    assert isinstance(thost.make_host_codec(kw, 100).codec,
                      tnative.NativeCodec)
    assert isinstance(thost.make_host_codec(
        {"compressor": "dithering", "normalize_type": "l2"}, 100),
        thost.HostDithering)
    monkeypatch.setenv("BYTEPS_NATIVE_CODEC", "0")
    assert isinstance(thost.make_host_codec(kw, 100).codec,
                      thost.HostOnebit)


KW_STEP = {"compressor": "onebit", "ef": "vanilla"}
MCB_STEP = 16384      # embed, lm_head and the block matrices compress


def test_native_host_codec_train_steps_match_jax(jax_native, monkeypatch):
    """As ``test_host_codec_train_steps_match_jax``, with both packages'
    host codecs in C++."""
    init, j_losses, j_params, j_names = jax_ps_run(
        monkeypatch, compression=KW_STEP, device_compress=False,
        min_compress_bytes=MCB_STEP)
    losses, model, names, step, _ = port_ps_run(
        monkeypatch, init, compression=KW_STEP, device_compress=False,
        min_compress_bytes=MCB_STEP)
    stacks = [s for ct in step._registry._tensors.values()
              for s in ct.stacks if s is not None]
    assert stacks and all(isinstance(s.codec, tnative.NativeCodec)
                          for s in stacks)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert names == j_names
    compressed = {n for n, p in model.named_parameters()
                  if p.numel() * 4 >= MCB_STEP}
    flipped = total = 0
    for n, p in model.named_parameters():
        got, want = p.detach().numpy(), j_params[n.replace(".", "/")]
        off = np.abs(got - want) > 1e-6
        if n in compressed:
            flipped += int(off.sum())
            total += off.size
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=n)
    assert flipped <= 1e-3 * total, (flipped, total)

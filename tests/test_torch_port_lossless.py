"""The port's lossless byte-plane codec (``ops/compression/lossless.py``)
against the JAX package's.

- the wire of ``HostLossless`` is the JAX codec's byte for byte on odd
  lengths, the empty input, incompressible input (the raw mode 0), NaN
  payloads, -0.0, subnormals and infinities, and each package decodes
  the other's wire bit for bit; the byte transform of 2-byte elements
  too;
- wires that do not parse raise in both packages alike (``ValueError``,
  ``zlib.error`` for a corrupt deflate stream);
- ``make_host_codec`` builds it (with EF around it, whose error stays 0)
  and ``make_compressor`` refuses it as the JAX package does;
- a loopback PS round: one worker's aggregate is its input bit for bit;
  a JAX worker and a port worker both get the f32 sum of their inputs
  exactly.
"""

import concurrent.futures
import struct
import zlib

import numpy as np
import pytest

import byteps_tpu_torch as bps
from byteps_tpu.ops.compression import lossless as jl
from byteps_tpu.ops.compression import make_compressor as j_make_compressor
from byteps_tpu_torch.ops.compression import host as thost
from byteps_tpu_torch.ops.compression import lossless as tl
from byteps_tpu_torch.ops.compression import make_compressor
from byteps_tpu_torch.server.compressed import CompressedRegistry
from _torch_port_ps_util import _ps_env, bounded, ps_server
from test_torch_port_ps import jax_uses_port_lib, ps_lib  # noqa: F401

LOSSLESS = {"compressor": "lossless"}


def _bits(u32) -> np.ndarray:
    return np.asarray(u32, np.uint32).view(np.float32)


def _inputs():
    rs = np.random.RandomState(7)
    grad = (rs.randn(4099) * 1e-3).astype(np.float32)
    special = np.concatenate([
        _bits([0x7FC00000, 0xFFC00001, 0x7F800001, 0x7FBFFFFF]),  # NaNs
        np.array([-0.0, 0.0, np.inf, -np.inf], np.float32),
        _bits([1, 0x007FFFFF, 0x80000001, 0x00400000]),           # subnormal
        rs.randn(5).astype(np.float32)])
    noise = rs.randint(0, 2 ** 32, 3001, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    return {"gradient": grad, "odd-1": grad[:1], "odd-7": grad[:7],
            "empty": grad[:0], "special": special,
            "incompressible": noise}


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_wire_is_the_jax_wire_and_decodes_across(name):
    x = INPUTS[name]
    t, j = tl.HostLossless(x.size), jl.HostLossless(x.size)
    tw, jw = t.compress(x), j.compress(x)
    assert tw == jw
    assert (t.wire_bytes(), t.kwargs_wire()) == (j.wire_bytes(),
                                                 j.kwargs_wire())
    assert len(tw) <= t.wire_bytes()
    mode = tw[4]
    assert mode == (0 if name in ("incompressible", "empty", "odd-1",
                                  "odd-7", "special") else 1)
    for out in (t.decompress(jw), j.decompress(tw)):
        np.testing.assert_array_equal(out.view(np.uint32),
                                      x.view(np.uint32))
    assert all(a.tobytes() == b.tobytes() for a, b in zip(
        tl.plane_split(x.view(np.uint8), 4),
        jl.plane_split(x.view(np.uint8), 4)))


def test_two_byte_planes_match_jax():
    raw = np.random.RandomState(3).randn(1001).astype(np.float16).view(
        np.uint8)
    tw = tl.encode_planes(raw, 2)
    assert tw == jl.LosslessCodec(itemsize=2).compress_bytes(raw)
    np.testing.assert_array_equal(tl.decode_planes(tw, 2), raw)
    with pytest.raises(ValueError):
        tl.plane_split(raw[:7], 2)
    with pytest.raises(ValueError):
        jl.plane_split(raw[:7], 2)


def _corruptions():
    x = INPUTS["gradient"]
    good = jl.HostLossless(x.size).compress(x)
    head, lens = good[:8], good[8:24]
    body = good[24:]
    n_lens = struct.unpack("<4I", lens)
    return {
        "truncated-header": good[:5],
        "bad-mode": head[:4] + b"\x02" + head[5:] + lens + body,
        "bad-nplanes": head[:5] + b"\x03" + head[6:] + lens + body,
        "truncated-table": head + lens[:6],
        "trailing-byte": good + b"\x00",
        "short-payload": good[:-1],
        "plane-lengths": head + struct.pack(
            "<4I", n_lens[0] + 1, n_lens[1] - 1, *n_lens[2:]) + body,
        "corrupt-deflate": head + lens + b"\xff" * 8 + body[8:],
        "wrong-count": struct.pack("<I", x.size + 1) + good[4:],
    }


CORRUPT = _corruptions()


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_corrupt_wires_raise_as_in_jax(name):
    n = INPUTS["gradient"].size
    errors = []
    for codec in (tl.HostLossless(n), jl.HostLossless(n)):
        with pytest.raises((ValueError, zlib.error)) as e:
            codec.decompress(CORRUPT[name])
        errors.append(type(e.value))
    assert errors[0] is errors[1]
    # a plane that does not inflate is zlib's to report
    assert errors[0] is (zlib.error if name in ("corrupt-deflate",
                                                "plane-lengths")
                         else ValueError)


def test_host_codec_builds_it_and_make_compressor_refuses_it():
    # (EF adds its zero error first: -0.0 would come out +0.0)
    x = INPUTS["gradient"]
    stack = thost.make_host_codec({"compressor": "lossless",
                                   "ef": "vanilla"}, x.size)
    assert isinstance(stack.codec, tl.HostLossless)
    wire = stack.compress(x)
    assert wire == jl.HostLossless(x.size).compress(x)
    assert not stack.error.view(np.uint32).any()
    with pytest.raises(ValueError, match="unknown compressor"):
        j_make_compressor(LOSSLESS, 100)
    with pytest.raises(ValueError, match="unknown compressor"):
        make_compressor(LOSSLESS, 100)


# three leaves of 1,000, 2,500 and 3,001 elements, one partition each
ROUND_SIZES = (1000, 2500, 3001)


def _round_inputs(worker):
    rs = np.random.RandomState(20 + worker)
    return [(rs.randn(n) * 1e-2).astype(np.float32) for n in ROUND_SIZES]


def _port_round(state, average):
    reg = CompressedRegistry(state.ps_client, state.config.num_workers,
                             LOSSLESS)
    xs = _round_inputs(state.config.worker_id)
    hids = [reg.push_pull_async(state, f"ll/{i}", x, average)
            for i, x in enumerate(xs)]
    return [np.array(bps.synchronize(h)) for h in hids]


def test_one_worker_round_returns_its_input_bit_for_bit(ps_lib, monkeypatch):
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bps.init(device="cpu")
        try:
            outs = bounded(lambda: _port_round(bps.get_state(), True))
        finally:
            bps.shutdown()
    for got, x in zip(outs, _round_inputs(0)):
        np.testing.assert_array_equal(got.view(np.uint32), x.view(np.uint32))


def test_jax_and_port_workers_get_the_exact_sum(ps_lib, monkeypatch,
                                                jax_uses_port_lib):
    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.server.compressed import CompressedRegistry as JReg

    with ps_server(num_workers=2) as port:
        _ps_env(monkeypatch, port, num_workers=2)
        monkeypatch.setenv("BYTEPS_LEDGER", "0")
        monkeypatch.setenv("DMLC_WORKER_ID", "0")
        GlobalState._instance = None
        jbps.init()
        monkeypatch.setenv("DMLC_WORKER_ID", "1")
        bps.init(device="cpu")
        try:
            for i in range(len(ROUND_SIZES)):   # one key order on both
                jbps.declare_tensor(f"ll/{i}")
                bps.declare_tensor(f"ll/{i}")
            jstate = jbps.get_state()

            def jax_worker():
                reg = JReg(jstate.ps_client, 2, LOSSLESS)
                hids = [reg.push_pull_async(jstate, f"ll/{i}", x, False)
                        for i, x in enumerate(_round_inputs(0))]
                return [np.array(jbps.synchronize(h)) for h in hids]

            def both():
                with concurrent.futures.ThreadPoolExecutor(2) as pool:
                    futs = [pool.submit(jax_worker), pool.submit(
                        _port_round, bps.get_state(), False)]
                    return [f.result() for f in futs]

            j_out, t_out = bounded(both)
        finally:
            bps.shutdown()
            jbps.shutdown()
            GlobalState._instance = None
    for j, t, a, b in zip(j_out, t_out, _round_inputs(0), _round_inputs(1)):
        np.testing.assert_array_equal(t, a + b)
        np.testing.assert_array_equal(j, t)

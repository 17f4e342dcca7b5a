"""topk in the port against the JAX package, on inputs with many ties at
the k-th boundary (values from {-2, -1, 0, 1, 2} * c, and +-x pairs,
which tie on |x|): ``lax.top_k`` takes the lower index first among equal
|x|, and so must the port, whose ``torch.topk`` promises no order.

- ``TopkCodec`` against the jitted JAX ``TopkCodec``: indices and values
  bit for bit;
- ``HostTopk`` bytes against the JAX ``HostTopk`` (the server's
  comparator, NaN below every number);
- the device tier's wire (``payload_to_wire``, indices ascending)
  against the JAX ``payload_to_wire``;
- loopback PS rounds, host tier and device tier: the port pushes the JAX
  worker's bytes and gets its aggregate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_ps_util as U
import test_torch_port_host_tier as HT
import test_torch_port_round as RT
from byteps_tpu.jax import device_compression as jdc
from byteps_tpu.ops.compression.codecs import TopkCodec as JTopk
from byteps_tpu.ops.compression.host import HostTopk as JHostTopk
from byteps_tpu_torch.ops.compression import make_compressor
from byteps_tpu_torch.ops.compression.codecs import TopkCodec, topk_select
from byteps_tpu_torch.ops.compression.host import HostTopk, make_host_codec
from byteps_tpu_torch.training import device_compression as tdc
from _torch_port_ps_util import tie_input
from test_torch_port_ps import jax_uses_port_lib, ps_lib  # noqa: F401


CASES = [(kind, n, k) for kind in ("levels", "pairs")
         for n, k in ((7, 3), (100, 1), (1000, 10), (4099, 400),
                      (5000, 5000))]


@pytest.mark.parametrize("kind,n,k", CASES)
def test_topk_codec_matches_the_jitted_jax_codec_on_ties(kind, n, k):
    x = tie_input(kind, n, seed=n + k)
    jp = jax.jit(lambda v: JTopk(size=n, k=k).compress(v))(jnp.asarray(x))
    codec = TopkCodec(size=n, k=k)
    tp = codec.compress(torch.from_numpy(x))
    np.testing.assert_array_equal(tp["indices"].numpy(),
                                  np.asarray(jp["indices"]))
    np.testing.assert_array_equal(tp["values"].numpy(),
                                  np.asarray(jp["values"]))
    np.testing.assert_array_equal(
        codec.decompress(tp).numpy(),
        np.asarray(JTopk(size=n, k=k).decompress(jp)))
    # the wire of the device tier: indices ascending, as the JAX tier's
    tw = tdc.payload_to_wire(codec, {key: v.numpy() for key, v in
                                     tp.items()})
    jw = jdc.payload_to_wire(JTopk(size=n, k=k),
                             {key: np.asarray(v) for key, v in jp.items()})
    assert tw.tobytes() == jw.tobytes()
    rep = tdc.wire_to_payload(codec, n, tw)
    np.testing.assert_array_equal(
        codec.decompress({key: torch.from_numpy(np.array(v))
                          for key, v in rep.items()}).numpy(),
        codec.decompress(tp).numpy())


@pytest.mark.parametrize("kind,n,k", CASES)
def test_host_topk_bytes_match_the_jax_host_codec(kind, n, k):
    x = tie_input(kind, n, seed=3 * n + k)
    if n > 10:
        x[::97] = np.nan        # the server's rule: below every number
    t, j = HostTopk(n=n, k=k), JHostTopk(n=n, k=k)
    tw, jw = t.compress(x), j.compress(x)
    assert tw == jw
    np.testing.assert_array_equal(
        t.decompress(np.frombuffer(tw, np.uint8)),
        j.decompress(np.frombuffer(jw, np.uint8)))
    assert t.kwargs_wire() == j.kwargs_wire() == \
        f"compressor=topk;n={n};k={k}"
    assert t.wire_bytes() == j.wire_bytes() == 8 * k


def test_topk_registry_and_selection_order(monkeypatch):
    # the numpy host codec (the default is the C++ one, native.py)
    monkeypatch.setenv("BYTEPS_NATIVE_CODEC", "0")
    st = make_compressor({"compressor": "topk", "k": "0.1", "ef": "vanilla",
                          "approx": "1"}, 100)
    assert isinstance(st.codec, TopkCodec)
    assert (st.codec.k, st.codec.approx, st.use_ef) == (10, True, True)
    hs = make_host_codec({"compressor": "topk", "k": "0.1",
                          "ef": "vanilla"}, 100)
    assert isinstance(hs.codec, HostTopk) and hs.codec.k == 10
    x = torch.tensor([1.0, -3.0, 3.0, 0.0, -1.0, 3.0])
    # |x| descending, the lower index first among the three 3s and the
    # two 1s
    assert topk_select(x, 4).tolist() == [1, 2, 5, 0]
    assert topk_select(x, 6).tolist() == [1, 2, 5, 0, 4, 3]


def _tie_leaves(step):
    return [tie_input("levels" if i % 2 else "pairs", n, 50 + 7 * step + i)
            for i, n in enumerate(U.LEAVES.values())]


KW_HOST = {"compressor": "topk", "k": "0.05", "ef": "vanilla"}


def test_host_tier_topk_rounds_push_the_jax_wire_bytes(
        ps_lib, monkeypatch, jax_uses_port_lib):
    """Two host-codec rounds of tie leaves in 8192-byte partitions: each
    key's pushed bytes are the JAX host tier's, and so is every
    aggregate that the server's topk re-compression sends back."""
    monkeypatch.setattr(HT, "leaves", _tie_leaves)
    j_wires, j_outs = HT._jax_host_rounds(monkeypatch, KW_HOST)
    t_wires, t_outs = HT._port_host_rounds(monkeypatch, KW_HOST)
    assert sorted(t_wires) == sorted(j_wires) and len(t_wires) == 10
    for key, ws in t_wires.items():
        assert ws == j_wires[key], f"key {key}: wire bytes differ"
    for t_round, j_round in zip(t_outs, j_outs):
        for name, t, j in zip(U.LEAVES, t_round, j_round):
            np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("kw", [
    {"compressor": "topk", "k": "0.05", "ef": "vanilla"},
    {"compressor": "topk", "k": "0.05", "ef": "vanilla",
     "momentum": "nesterov"},
], ids=["ef", "ef-momentum"])
def test_device_tier_topk_rounds_push_the_jax_wire_bytes(
        kw, ps_lib, monkeypatch, jax_uses_port_lib):
    """Two device-tier rounds of tie leaves: the port's
    ``DeviceCompressor`` pushes the JAX one's wire bytes partition by
    partition, carries its residuals into the second round and gets its
    aggregate, bit for bit."""
    monkeypatch.setattr(U, "leaves", _tie_leaves)
    monkeypatch.setattr(RT, "leaves", _tie_leaves)
    j_wires, j_outs, j_errors = RT._jax_rounds(monkeypatch, kw)
    t_wires, t_outs, t_errors, spec = U.port_rounds(monkeypatch, kw)
    assert spec.round is None       # topk has no round kernel
    assert t_errors.keys() == j_errors.keys()
    for key, e in t_errors.items():
        np.testing.assert_array_equal(e, j_errors[key], err_msg=str(key))
    assert len(t_wires) == len(j_wires) == 2 * len(U.LEAVES)
    for (tn, tw), (jn, jw) in zip(t_wires, j_wires):
        assert tn == jn and tw == jw, f"{tn}: wire bytes differ"
    for t_round, j_round in zip(t_outs, j_outs):
        for name, t, j in zip(U.LEAVES, t_round, j_round):
            np.testing.assert_array_equal(t, j, err_msg=name)

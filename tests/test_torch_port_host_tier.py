"""The port's host-codec tier (``make_ps_train_step(...,
device_compress=False)``, ``server/compressed.py``, the scheduler's
COMPRESS and DECOMPRESS stages) against the JAX package.

- two rounds of leaves split into ragged 8192-byte partitions (their
  tails and a small leaf under the 2048-byte threshold travel dense)
  under onebit, randomk and dithering, each with error feedback,
  lossless, and dithering at s = 3 on the varint wire, push
  the JAX host tier's wire bytes, key by key, bit for bit, and get its
  aggregate;
- two train steps of Llama ``tiny()`` in fp32 under onebit + EF match
  the JAX host-codec step: the losses to 1e-5, the dense leaves to 1e-6,
  and at most a thousandth of the compressed elements apart (a gradient
  element within rounding of zero may take the other sign).
"""

import collections

import numpy as np
import pytest

import byteps_tpu_torch as bps
from byteps_tpu_torch.server.compressed import CompressedRegistry
from _torch_port_ps_util import (
    LEAVES, MIN_BYTES, PARTITION_BYTES, _ps_env, bounded, leaves, ps_server,
)
from test_torch_port_dense_ps import jax_ps_run, port_ps_run
from test_torch_port_ps import jax_uses_port_lib, ps_lib  # noqa: F401

KWS = [{"compressor": "onebit", "ef": "vanilla"},
       {"compressor": "randomk", "k": "0.05", "seed": "6", "ef": "vanilla"},
       {"compressor": "dithering", "seed": "4", "ef": "vanilla"},
       {"compressor": "lossless"},
       {"compressor": "dithering", "s": "3", "seed": "4", "ef": "vanilla",
        "index_coding": "varint"}]


def _record(client, wires):
    """Record every push of ``client``: key -> [payload bytes, ...] in
    round order (two rounds of one key never overlap)."""
    send = client.zpushpull_async

    def recording(server, key, data, *args, **kwargs):
        wires[key].append(bytes(np.asarray(data)))
        return send(server, key, data, *args, **kwargs)

    client.zpushpull_async = recording


def _rounds(state, registry, synchronize):
    outs = []
    for step in range(2):
        hids = [registry.push_pull_async(state, name, x, True)
                for name, x in zip(LEAVES, leaves(step))]
        outs.append([np.array(synchronize(h)) for h in hids])
    return outs


def _jax_host_rounds(monkeypatch, kw):
    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.server.compressed import CompressedRegistry as JReg

    wires = collections.defaultdict(list)
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        monkeypatch.setenv("BYTEPS_PARTITION_BYTES", str(PARTITION_BYTES))
        monkeypatch.setenv("BYTEPS_LEDGER", "0")
        GlobalState._instance = None
        jbps.init()
        try:
            state = jbps.get_state()
            _record(state.ps_client, wires)
            reg = JReg(state.ps_client, 1, kw, MIN_BYTES)
            outs = bounded(lambda: _rounds(state, reg, jbps.synchronize),
                           timeout=120)
        finally:
            jbps.shutdown()
            GlobalState._instance = None
    return wires, outs


def _port_host_rounds(monkeypatch, kw):
    wires = collections.defaultdict(list)
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        monkeypatch.setenv("BYTEPS_PARTITION_BYTES", str(PARTITION_BYTES))
        bps.init(device="cpu")
        try:
            state = bps.get_state()
            _record(state.ps_client, wires)
            reg = CompressedRegistry(state.ps_client, 1, kw, MIN_BYTES)
            outs = bounded(lambda: _rounds(state, reg, bps.synchronize))
        finally:
            bps.shutdown()
    return wires, outs


@pytest.mark.parametrize("kw", KWS, ids=lambda kw: kw["compressor"] + (
    "-varint" if "index_coding" in kw else ""))
def test_host_codec_rounds_push_the_jax_wire_bytes(kw, ps_lib, monkeypatch,
                                                   jax_uses_port_lib):
    j_wires, j_outs = _jax_host_rounds(monkeypatch, kw)
    t_wires, t_outs = _port_host_rounds(monkeypatch, kw)
    # 5 leaves in 3 + 1 + 2 + 3 + 1 partitions, two rounds each
    assert sorted(t_wires) == sorted(j_wires) and len(t_wires) == 10
    for key, ws in t_wires.items():
        assert len(ws) == 2
        assert ws == j_wires[key], f"key {key}: wire bytes differ"
    # the 204-element tail of r/d and the 100-element r/e travel dense
    first = {ws[0] for ws in t_wires.values()}
    x = leaves(0)
    assert x[3][4096:].tobytes() in first and x[4].tobytes() in first
    for t_round, j_round in zip(t_outs, j_outs):
        for name, t, j in zip(LEAVES, t_round, j_round):
            np.testing.assert_array_equal(t, j, err_msg=name)


KW_STEP = {"compressor": "onebit", "ef": "vanilla"}
MCB_STEP = 16384      # embed, lm_head and the block matrices compress


def test_host_codec_train_steps_match_jax(ps_lib, monkeypatch,
                                          jax_uses_port_lib):
    init, j_losses, j_params, j_names = jax_ps_run(
        monkeypatch, compression=KW_STEP, device_compress=False,
        min_compress_bytes=MCB_STEP)
    losses, model, names, step, _ = port_ps_run(
        monkeypatch, init, compression=KW_STEP, device_compress=False,
        min_compress_bytes=MCB_STEP)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert names == j_names
    assert step.counters["leaves_streamed"] == 9
    compressed = {n for n, p in model.named_parameters()
                  if p.numel() * 4 >= MCB_STEP}
    assert {"embed", "lm_head", "blocks.w_down"} <= compressed
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

"""The port's parameter-server path against the JAX package.

- ``native/ps.cc`` is a byte-identical copy, and the wire constants, the
  command words and the registry's keys and partitions are the JAX
  package's;
- a ``DeviceCompressor`` round through a loopback server equals the host
  codecs' golden aggregate, for onebit, dithering and randomk;
- a mixed fleet: a JAX worker and a torch worker push to one server and
  get bit-identical aggregates;
- two ``make_ps_train_step`` steps of Llama ``tiny()`` in fp32 under
  dithering + EF match the JAX ``make_ps_train_step``.

Both packages' clients load the port's build of ``ps.cc`` (the same
bytes): the JAX package's own build runs with -Werror, which GCC 12 fails
on a false positive in its AVX-512 headers. Every test that talks to a
server runs its body in a thread joined with a timeout, so a server that
never answers fails the test instead of hanging the suite.
"""

import dataclasses
import filecmp
import pathlib
import threading

import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
from byteps_tpu.config import Config as JConfig
from byteps_tpu.core import types as jtypes
from byteps_tpu.core.registry import TensorRegistry as JRegistry
from byteps_tpu.ops.compression import host as jhost
from byteps_tpu.server import client as jclient
from byteps_tpu_torch.config import Config
from byteps_tpu_torch.core import arena as tarena
from byteps_tpu_torch.core import types as ttypes
from byteps_tpu_torch.core.registry import TensorRegistry
from byteps_tpu_torch.native import build as tbuild
from byteps_tpu_torch.server import client as tclient
from byteps_tpu_torch.training import device_compression as tdc
from _torch_port_ps_util import (
    TIMEOUT_S, _free_port, _ps_env, bounded, ps_server,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ps_lib():
    return bounded(tbuild.build_ps, timeout=240)


@pytest.fixture()
def jax_uses_port_lib(ps_lib, monkeypatch):
    """The JAX client and codecs load the port's build of the same
    ps.cc; numpy host codecs stay the golden model."""
    import byteps_tpu.native.build as jbuild
    for mod in (jbuild, jclient):
        monkeypatch.setattr(mod, "build", lambda *a, **k: ps_lib)
    monkeypatch.setenv("BYTEPS_NATIVE_CODEC", "0")


def _golden_aggregate(kwargs, xs, n, step=0):
    """The host tier's aggregate (test_device_compress.py:22-30)."""
    payloads = [jhost.make_host_codec(kwargs, n).compress(x, step=step)
                for x in xs]
    dec = jhost.make_host_codec(kwargs, n)
    s = sum(dec.decompress(np.frombuffer(p, np.uint8)) for p in payloads)
    wire = jhost.make_host_codec(kwargs, n).compress(s, step=step)
    return dec.decompress(np.frombuffer(wire, np.uint8))


# --------------------------------------------------------------------- #
# the wire by construction
# --------------------------------------------------------------------- #

def test_ps_cc_is_a_byte_identical_copy():
    assert filecmp.cmp(ROOT / "byteps_tpu/native/ps.cc",
                       ROOT / "byteps_tpu_torch/native/ps.cc", shallow=False)


def test_wire_constants_match_the_jax_client():
    for name in ("WIRE_MAGIC", "WIRE_HEADER_FMT", "WIRE_HEADER_BYTES",
                 "WIRE_CTRL_OPS", "WIRE_CTRL_LIMITS"):
        assert getattr(tclient, name) == getattr(jclient, name), name
    assert {d.name: int(d) for d in ttypes.DataType} == \
        {d.name: int(d) for d in jtypes.DataType}
    for req in jtypes.RequestType:
        for dt in jtypes.DataType:
            assert ttypes.get_command_type(
                ttypes.RequestType(int(req)), ttypes.DataType(int(dt))) == \
                jtypes.get_command_type(req, dt)
    f32 = jtypes.DataType.FLOAT32
    assert (tdc.CMD_F32, tdc.CMD_COMP_F32) == (
        jtypes.get_command_type(jtypes.RequestType.DEFAULT_PUSH_PULL, f32),
        jtypes.get_command_type(jtypes.RequestType.COMPRESSED_PUSH_PULL,
                                f32))


def _llama_grad_names():
    """The JAX step's gradient names of Llama tiny(), and the port's."""
    import jax

    from byteps_tpu.models import llama as jl
    from byteps_tpu_torch.models import llama as tl
    from byteps_tpu_torch.training.train import named_leaves

    cfg = jl.LlamaConfig.tiny(vocab_size=64, seq=32)
    shapes = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    paths, _ = jax.tree_util.tree_flatten_with_path(shapes)
    j_names = ["grad/" + "/".join(str(getattr(k, "key", k)) for k in path)
               for path, _ in paths]
    j_sizes = [int(np.prod(s.shape)) * 4 for _, s in paths]
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=64, seq=32),
                               dtype=torch.float32)
    model = tl.Llama(tcfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    t_named = named_leaves(model.params())
    return j_names, j_sizes, ["grad/" + n for n, _ in t_named], \
        [t.numel() * 4 for _, t in t_named]


@pytest.mark.parametrize("num_servers,hash_fn", [(1, "djb2"), (3, "djb2"),
                                                 (3, "mixed")])
def test_registry_keys_and_partitions_match_jax(num_servers, hash_fn):
    j_names, j_sizes, t_names, t_sizes = _llama_grad_names()
    assert t_names == j_names and t_sizes == j_sizes
    kw = dict(num_servers=num_servers, partition_bytes=8192,
              key_hash_fn=hash_fn)
    jreg, treg = JRegistry(JConfig(**kw)), TensorRegistry(Config(**kw))
    for name, nbytes in zip(j_names, j_sizes):
        jc = jreg.init_tensor(name, nbytes, jtypes.DataType.FLOAT32)
        tc = treg.init_tensor(name, nbytes, ttypes.DataType.FLOAT32)
        assert tc.declared_key == jc.declared_key
        assert [dataclasses.astuple(p) for p in tc.partitions] == \
            [dataclasses.astuple(p) for p in jc.partitions], name
    assert treg.server_loads() == jreg.server_loads()


def test_ps_worker_id_follows_the_dp_group(monkeypatch):
    """The worker id comes from the group ``init`` was given, not from a
    second read of BYTEPS_LOCAL_RANK/BYTEPS_LOCAL_SIZE."""
    _ps_env(monkeypatch, _free_port())
    monkeypatch.setenv("DMLC_WORKER_ID", "3")
    monkeypatch.setenv("BYTEPS_LOCAL_RANK", "1")
    monkeypatch.setenv("BYTEPS_LOCAL_SIZE", "2")
    seen = []

    class Refused(Exception):
        pass

    def fake_client(servers, rank):
        seen.append(rank)
        raise Refused

    monkeypatch.setattr(tclient, "PSClient", fake_client)
    with pytest.raises(Refused):
        bps.init(device="cpu", rank=0, world_size=1)
    assert seen == [3]
    assert not bps.get_state().initialized


def test_ps_mode_refuses_a_dp_group_of_more_than_one(monkeypatch):
    """PS mode takes a dp group of more than one process (the group is one
    PS worker), but refuses one without a rendezvous, and then leaves
    nothing set up: no process group, no PS client."""
    _ps_env(monkeypatch, _free_port())
    monkeypatch.delenv("BYTEPS_COORD_PORT", raising=False)
    with pytest.raises(RuntimeError, match="BYTEPS_COORD_PORT"):
        bps.init(device="cpu", rank=0, world_size=2)
    st = bps.get_state()
    assert not st.initialized and st.ps_client is None
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_arena_checkout_release_abandon():
    a = tarena.StagingArena()
    lease = a.checkout("k", 100)
    assert lease.buf.nbytes == 100 and lease.buf.ctypes.data % 64 == 0
    busy = a.checkout("k", 100)             # slot leased: fresh fallback
    assert busy.fresh and busy.buf is not lease.buf
    lease.release()
    again = a.checkout("k", 100)
    assert again.buf is lease.buf           # reused
    again.abandon()
    assert a.checkout("k", 100).buf is not lease.buf
    st = a.stats()
    assert (st["slot_allocs"], st["allocs_avoided"],
            st["checkout_conflicts"]) == (2, 1, 1)
    assert tarena.usable_staging(np.empty(8, np.uint8), np.uint8, 8)
    assert not tarena.usable_staging(np.empty(8, np.uint8)[::2], np.uint8, 4)


# --------------------------------------------------------------------- #
# through a loopback server
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kw", [
    {"compressor": "onebit"},
    {"compressor": "dithering", "s": "32", "seed": "9"},
    {"compressor": "randomk", "k": "32", "seed": "5"},
], ids=lambda kw: kw["compressor"])
def test_device_compressor_round_matches_golden(kw, ps_lib, monkeypatch,
                                                jax_uses_port_lib):
    n = 4096
    x = np.random.RandomState(0).randn(n).astype(np.float32)
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bps.init(device="cpu")
        try:
            state = bps.get_state()
            dc = tdc.DeviceCompressor(state.ps_client, 1, kw)

            def rounds():
                return [dc.push_pull_leaves(state, ["dt"],
                                            [torch.from_numpy(x)],
                                            average=False)[0]
                        for _ in range(2)]

            out0, out1 = bounded(rounds)
        finally:
            bps.shutdown()
    np.testing.assert_allclose(out0.numpy(), _golden_aggregate(kw, [x], n),
                               rtol=1e-6)
    np.testing.assert_allclose(out1.numpy(),
                               _golden_aggregate(kw, [x], n, step=1),
                               rtol=1e-6)
    assert dc._plans["dt"].step == 2
    assert bps.get_state().ps_client is None


def test_mixed_fleet_gets_one_aggregate(ps_lib, jax_uses_port_lib):
    """A JAX worker (host codecs) and a torch worker (device tier) push
    to one server of two workers: both get the same aggregate bytes."""
    n = 3000
    rs = np.random.RandomState(1)
    xs = [rs.randn(n).astype(np.float32) for _ in range(2)]
    kws = [{"compressor": "dithering", "s": "127", "seed": "4"},
           {"compressor": "randomk", "k": "64", "seed": "2"},
           None]
    names = ["mix/dither", "mix/randomk", "mix/dense"]
    jreg = JRegistry(JConfig(num_servers=1))
    treg = TensorRegistry(Config(num_servers=1))
    with ps_server(num_workers=2) as port:
        addr = [f"127.0.0.1:{port}"]
        clients = bounded(lambda: (jclient.PSClient(addr, 0),
                                   tclient.PSClient(addr, 1)))
        try:
            def worker(w):
                c, x = clients[w], xs[w]
                out = []
                for name, kw in zip(names, kws):
                    reg, types = (jreg, jtypes) if w == 0 else (treg, ttypes)
                    ctx = reg.init_tensor(name, n * 4,
                                          types.DataType.FLOAT32)
                    p = ctx.partitions[0]
                    c.ensure_init(ctx, n * 4)
                    if kw is None:
                        wire, cmd, rl = x.view(np.uint8), tdc.CMD_F32, n * 4
                    elif w == 0:
                        hc = jhost.make_host_codec(kw, n)
                        c.comp_init(p.server, p.key, hc.kwargs_wire())
                        wire = np.frombuffer(hc.compress(x, 0), np.uint8)
                        cmd, rl = tdc.CMD_COMP_F32, hc.wire_bytes()
                    else:
                        from byteps_tpu_torch.ops.compression import (
                            host, make_compressor)
                        hc = host.make_host_codec(kw, n)
                        c.comp_init(p.server, p.key, hc.kwargs_wire())
                        codec = make_compressor(kw, n).codec
                        pl = codec.compress(torch.from_numpy(x), 0)
                        wire = tdc.payload_to_wire(
                            codec, {k: v.numpy() for k, v in pl.items()})
                        cmd, rl = tdc.CMD_COMP_F32, hc.wire_bytes()
                    reply = np.empty(rl, np.uint8)
                    done = threading.Event()
                    errs = []
                    c.zpushpull_async(p.server, p.key, wire, reply, cmd,
                                      lambda got, err: (errs.append(err),
                                                        done.set()),
                                      epoch=1 << 16)
                    assert done.wait(TIMEOUT_S) and errs == [None], errs
                    out.append(reply)
                return out

            results = [None, None]

            def both():
                ts = [threading.Thread(
                    target=lambda w=w: results.__setitem__(w, worker(w)))
                    for w in range(2)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()

            bounded(both)
        finally:
            for c in clients:
                c.close()
    assert results[0] is not None and results[1] is not None
    for name, kw, j, t in zip(names, kws, *results):
        np.testing.assert_array_equal(j, t, err_msg=name)
        got = j.view(np.float32) if kw is None else \
            jhost.make_host_codec(kw, n).decompress(j)
        want = xs[0] + xs[1] if kw is None else \
            _golden_aggregate(kw, xs, n)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


# --------------------------------------------------------------------- #
# two train steps against the JAX make_ps_train_step
# --------------------------------------------------------------------- #

V, S, STEPS = 64, 32, 2
KW = {"compressor": "dithering", "ef": "vanilla"}
MIN_BYTES = 16384     # compresses embed, lm_head and the block matrices


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_ps_run(monkeypatch):
    import jax
    import jax.numpy as jnp
    import optax

    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.jax.train import make_ps_train_step as j_make
    from byteps_tpu.models import llama as jl
    from byteps_tpu.parallel.mesh import make_mesh

    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=V, seq=S),
                              dtype=jnp.float32)
    params = jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), cfg)
    init = jax.tree.map(np.asarray, params)
    tokens = np.random.RandomState(2).randint(0, V, (2, S + 1)) \
        .astype(np.int32)
    tx = optax.adam(1e-3)
    opt = tx.init(params)
    mesh = make_mesh(devices=jax.devices()[:1])
    losses = []
    monkeypatch.setenv("BYTEPS_LEDGER", "0")
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        GlobalState._instance = None
        jbps.init()
        try:
            step = j_make(lambda p, b: jl.loss_fn(p, b, cfg), tx, mesh,
                          compression=KW, min_compress_bytes=MIN_BYTES)

            def run():
                nonlocal params, opt
                with jax.default_matmul_precision("float32"):
                    for _ in range(STEPS):
                        params, opt, loss = step(params, opt,
                                                 {"tokens": tokens})
                        losses.append(float(loss))

            bounded(run, timeout=120)
        finally:
            jbps.shutdown()
            GlobalState._instance = None
    return init, tokens, losses, _flat(jax.tree.map(np.asarray, params))


def test_two_ps_steps_match_jax(ps_lib, monkeypatch, jax_uses_port_lib):
    from byteps_tpu_torch.models import llama as tl
    from byteps_tpu_torch.training import make_ps_train_step

    init, tokens, j_losses, j_params = _jax_ps_run(monkeypatch)
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=V, seq=S),
                              dtype=torch.float32)
    model = tl.Llama(cfg, device="cpu",
                     params=tl.params_from_jax(init, device="cpu"))
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bps.init(device="cpu")
        try:
            opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                                   betas=(0.9, 0.999), eps=1e-8)
            step = make_ps_train_step(
                lambda b: tl.loss_fn(model.params(), b, cfg), opt,
                model.params(), compression=KW, min_compress_bytes=MIN_BYTES)
            losses = bounded(lambda: [
                float(step({"tokens": torch.from_numpy(tokens)}))
                for _ in range(STEPS)])
            compressed = {
                n[len("grad/"):] for n, p in
                step.device_compressor()._plans.items() if any(p.codecs)}
        finally:
            bps.shutdown()
    # step 0 sees identical weights; step 1 weights differ by rounding
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert {"embed", "lm_head", "blocks/w_gate"} <= compressed
    assert "final_norm" not in compressed
    flipped = total = 0
    for n, p in model.named_parameters():
        n = n.replace(".", "/")
        got, want = p.detach().numpy(), j_params[n]
        # Adam moves each element by about lr per step. Outside the
        # dithered leaves only rounding separates the two; inside, a
        # gradient that rounds differently may take the other stochastic
        # level and move its element differently: count those
        off = np.abs(got - want) > 1e-6
        if n in compressed:
            flipped += int(off.sum())
            total += off.size
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=n)
    assert flipped <= 1e-3 * total, (flipped, total)


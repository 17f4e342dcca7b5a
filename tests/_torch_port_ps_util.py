"""Loopback parameter-server helpers for the port's PS tests, and the
round harness that the CPU tests (against the JAX package) and the card
tests share. It imports only torch, numpy and byteps_tpu_torch, so the
card tests, which run without JAX, can use it.

- ``bounded``, ``ps_server``, ``_ps_env``: a server thread on a free
  port, the worker's environment, and a time limit on every body that
  talks to the server;
- ``held_replies`` and ``replies_in_before_drain``: the cross-barrier
  carry's two schedules made certain, whatever the host's load: named
  keys' replies later than the step's drain (carried), or every reply in
  before it (nothing carried);
- ``port_rounds``: two ``DeviceCompressor`` rounds of the leaves in
  ``LEAVES`` through a loopback server, with every wire recorded;
- ``partition_path_wires``: the same two rounds' wires, partition by
  partition through each partition's own ``CompressorStack``;
- ``path_round_lengths``: the partitions of the training path's round.
"""

import contextlib
import socket
import threading

import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.config import Config
from byteps_tpu_torch.core.registry import TensorRegistry
from byteps_tpu_torch.ops.compression import make_compressor
from byteps_tpu_torch.server import run_server
from byteps_tpu_torch.training import device_compression as tdc

TIMEOUT_S = 60


def bounded(fn, timeout=TIMEOUT_S):
    """Run ``fn`` in a thread; fail the test if it has not returned in
    ``timeout`` seconds (a PS round that never completes)."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"no reply from the PS server within {timeout} s")
    if "err" in box:
        raise box["err"]
    return box.get("out")


@contextlib.contextmanager
def held_replies(names):
    """While the block runs, the completion of each fused reply of the
    keys of ``names`` (tensor names in the process's registry) waits until
    the yielded ``release()``: the reply has landed, but the step's drain
    finds the round still out, so a carry-eligible key is carried. Call
    ``release()`` once after each step, the steps submitting one round of
    each key: the k-th call completes the rounds up to k (a reply still
    on its way, or a round still queued, completes on arrival), and
    later rounds are held again. The block's end releases all."""
    from byteps_tpu_torch.server import client as tclient
    orig = tclient.PSClient.zpushpull_async
    mu = threading.Lock()
    st = {"released": 0, "held": []}

    def held_keys():
        reg = bps.get_state().registry
        ctxs = [reg.get(n) for n in names] if reg is not None else []
        return {p.key for c in ctxs if c is not None for p in c.partitions}

    def zpushpull_async(self, server, key, data, out, cmd, on_done,
                        epoch=0, codec=0):
        on = on_done
        if key in held_keys():
            rnd = epoch >> 16          # the round of the key, from 1

            def on(got, err, on_done=on_done, rnd=rnd):
                with mu:
                    hold = rnd > st["released"]
                    if hold:
                        st["held"].append((rnd, on_done, got, err))
                if not hold:
                    on_done(got, err)
        return orig(self, server, key, data, out, cmd, on, epoch=epoch,
                    codec=codec)

    def release(until=None):
        with mu:
            st["released"] = st["released"] + 1 if until is None else until
            items = [h for h in st["held"] if h[0] <= st["released"]]
            st["held"] = [h for h in st["held"] if h[0] > st["released"]]
        for _, cb, got, err in items:
            cb(got, err)

    tclient.PSClient.zpushpull_async = zpushpull_async
    try:
        yield release
    finally:
        tclient.PSClient.zpushpull_async = orig
        release(until=float("inf"))


@contextlib.contextmanager
def replies_in_before_drain():
    """While the block runs, the host tier's drain starts only once every
    reply of the step is in: a carry-eligible round is then never
    carried."""
    from byteps_tpu_torch.training import train as ttrain
    orig = ttrain.HostTierStep._drain

    def _drain(self, state, rnd, ready, *a, **k):
        for item in ready:
            if item[1] is not None:
                item[1]._ev.wait(TIMEOUT_S)
        return orig(self, state, rnd, ready, *a, **k)

    ttrain.HostTierStep._drain = _drain
    try:
        yield
    finally:
        ttrain.HostTierStep._drain = orig


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def ps_server(num_workers=1):
    port = _free_port()
    t = threading.Thread(target=run_server, args=(
        port, Config(num_workers=num_workers, num_servers=1)), daemon=True)
    t.start()
    try:
        yield port
    except BaseException:
        t.join(timeout=10)
        raise
    # every worker sent SHUTDOWN: the server must have exited
    t.join(timeout=10)
    assert not t.is_alive(), "the PS server did not exit"


# the other variables the PS setup reads: an earlier test in this process
# may have left one set (a JAX elastic resume rewrites BYTEPS_SERVER_HOSTS)
_OTHER_PS_VARS = ("BYTEPS_SERVER_HOSTS", "DMLC_ROLE", "DMLC_WORKER_ID",
                  "BYTEPS_GLOBAL_RANK", "BYTEPS_LOCAL_RANK",
                  "BYTEPS_LOCAL_SIZE", "BYTEPS_PARTITION_BYTES",
                  "BYTEPS_SCHEDULING_CREDIT", "BYTEPS_KEY_HASH_FN",
                  "BYTEPS_MIN_COMPRESS_BYTES")


def _ps_env(monkeypatch, port, num_workers=1):
    for name in _OTHER_PS_VARS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DMLC_NUM_WORKER", str(num_workers))
    monkeypatch.setenv("DMLC_NUM_SERVER", "1")
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(port))


# --------------------------------------------------------------------- #
# two rounds of a few leaves split into several partitions
# --------------------------------------------------------------------- #

# with 8192-byte partitions (2048 elements): 2048+2048+904, 2048,
# 2048+952, 2048+2048+204 and 100; below 2048 bytes a partition travels
# dense (the 204 tail and the 100-element leaf)
PARTITION_BYTES = 8192
LEAVES = {"r/a": 5000, "r/b": 2048, "r/c": 3000, "r/d": 4300, "r/e": 100}
MIN_BYTES = 2048
ROUND_MEMBERS = [2048, 2048, 904, 2048, 2048, 952, 2048, 2048]
ROUND_KWS = [{"compressor": "dithering", "ef": "vanilla", "seed": "4"},
             {"compressor": "randomk", "k": "0.05", "ef": "vanilla",
              "seed": "6"}]


def tie_input(kind: str, n: int, seed: int) -> np.ndarray:
    """f32 [n] with many equal |x| at any k-th boundary, for topk:
    ``levels`` draws from {-2, -1, 0, 1, 2} * c, ``pairs`` holds x and -x
    for each of n/2 draws, shuffled."""
    rs = np.random.RandomState(seed)
    if kind == "levels":
        c = np.float32(rs.choice([0.25, 1.0, 3.0]))
        return (rs.randint(-2, 3, n) * c).astype(np.float32)
    base = rs.randn(n // 2 + 1).astype(np.float32)
    x = np.concatenate([base, -base])[:n]
    rs.shuffle(x)
    return x


def leaves(step):
    rs = np.random.RandomState(10 + step)
    return [rs.randn(n).astype(np.float32) for n in LEAVES.values()]


def record_wires(state, wires):
    """Append (leaf name, [wire bytes per partition]) to ``wires`` for
    every leaf that ``state``'s scheduler is given."""
    submit = state.scheduler.submit_wire

    def recording(ctx, wire_list, *args, **kwargs):
        wires.append((ctx.name, [bytes(np.asarray(w)) for w in wire_list]))
        return submit(ctx, wire_list, *args, **kwargs)

    state.scheduler.submit_wire = recording


def errors(dc):
    """{(leaf, partition): EF residual} of a DeviceCompressor's plans
    (the port's or the JAX package's), and {(leaf, partition,
    "momentum"): momentum} where the stack has one, as numpy arrays."""
    out = {}
    for name, p in dc._plans.items():
        for j, st in enumerate(p.states):
            for key, at in (("error", (name, j)),
                            ("momentum", (name, j, "momentum"))):
                if key in st:
                    e = st[key]
                    out[at] = e.cpu().numpy().copy() \
                        if isinstance(e, torch.Tensor) else np.array(e)
    return out


def port_rounds(monkeypatch, kw, device="cpu"):
    """The port's two rounds through a loopback server: wires,
    aggregates (numpy), the residuals after the first round, and the pack
    spec."""
    wires, outs, errs = [], [], []
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        monkeypatch.setenv("BYTEPS_PARTITION_BYTES", str(PARTITION_BYTES))
        bps.init(device=device)
        try:
            state = bps.get_state()
            record_wires(state, wires)
            dc = tdc.DeviceCompressor(state.ps_client, 1, kw, MIN_BYTES)

            def run():
                for step in range(2):
                    out = dc.push_pull_leaves(
                        state, list(LEAVES),
                        [torch.from_numpy(x).to(device)
                         for x in leaves(step)], average=False)
                    outs.append([o.cpu().numpy().copy() for o in out])
                    errs.append(errors(dc))

            bounded(run)
            spec = next(iter(dc._specs.values()))
        finally:
            bps.shutdown()
    return wires, outs, errs[0], spec


def partition_path_wires(kw, device="cpu"):
    """The wires of the same two rounds, partition by partition through
    each partition's own CompressorStack (the form before rounds)."""
    reg = TensorRegistry(Config(num_servers=1,
                                partition_bytes=PARTITION_BYTES))
    parts = {name: reg.init_tensor(name, n * 4).partitions
             for name, n in LEAVES.items()}
    stacks, states, wires = {}, {}, []
    for step in range(2):
        for (name, n), x in zip(LEAVES.items(), leaves(step)):
            ws = []
            for j, q in enumerate(parts[name]):
                xq = torch.from_numpy(
                    x[q.offset // 4: (q.offset + q.length) // 4]).to(device)
                if q.length < MIN_BYTES:
                    ws.append(xq.cpu().numpy().tobytes())
                    continue
                key = (name, j)
                if key not in stacks:
                    stacks[key] = make_compressor(kw, xq.numel())
                    states[key] = stacks[key].init_state(xq.numel(), device)
                pl, states[key] = stacks[key].compress(xq, states[key], step)
                ws.append(tdc.payload_to_wire(
                    stacks[key].codec,
                    {k: v.cpu().numpy() for k, v in pl.items()}).tobytes())
            wires.append((name, ws))
    return wires


def path_round_lengths():
    """The lengths of the compressed partitions of ``LlamaConfig.small()``'s
    gradient leaves at the default partition size and compression
    threshold: the PS training path's round."""
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.training.train import named_leaves

    def meta(node):
        if isinstance(node, dict):
            return {k: meta(v) for k, v in node.items()}
        return torch.empty(node, device="meta")

    cfg = Config(num_servers=1)
    reg = TensorRegistry(cfg)
    named = named_leaves(meta(llama.param_shapes(llama.LlamaConfig.small())))
    return [q.length // 4 for name, t in named
            for q in reg.init_tensor("grad/" + name,
                                     t.numel() * 4).partitions
            if q.length >= cfg.min_compress_bytes]

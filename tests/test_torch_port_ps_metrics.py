"""The measurement plane on the port's PS train step, against the JAX
package's on the CPU (Llama ``tiny()`` in fp32, loopback servers):

- two steps of the dense host tier and two of the host onebit tier give
  the same ``wire/*``, ``compress/*``, ``export/*`` and ``pushpull/*``
  counters as the JAX ``make_ps_train_step`` (exact: the same keys,
  partitions and codec bytes), and a StepReport a step with its verdict;
- the device dithering tier's ``compress/*`` counters are the dense
  bytes and the payloads' (the JAX scheduler counts host stacks alone,
  so these are held to the wire counters instead);
- the ledger's FLOPs (FlopCounterMode plus the flash forward's report)
  equal the analytic count of the step exactly, with remat and the flash
  attention path; the JAX figure (XLA's cost analysis) is printed beside
  it, ungated: the two count differently;
- BYTEPS_HEALTH: a report's ``grad_norm`` is the norm of the pulled
  aggregate (1e-5 relative: numpy's f64 sum against torch's f32 norm),
  and BYTEPS_CHAOS_NAN_LEAF with BYTEPS_NAN_GUARD latches nonfinite at
  the named step, records it, and raises at that step's end;
- SIGTERM to a worker process writes the merged flight dump, with the
  server's event drained over FLIGHT_DRAIN, and the time-series JSONL.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.core.metrics import StepReport, classify_step
from byteps_tpu_torch.models import llama as tl
from byteps_tpu_torch.ops import flash_attention as FA
from byteps_tpu_torch.training import make_ps_train_step
from byteps_tpu_torch.training import train as ttrain
from _torch_port_ps_util import _ps_env, bounded, ps_server
from test_torch_port_ps import ps_lib  # noqa: F401

V, S, STEPS = 64, 32, 2
FUSION = "16384"
ONEBIT = dict(compression={"compressor": "onebit", "ef": "vanilla"},
              device_compress=False, min_compress_bytes=16384)
PREFIXES = ("wire/", "compress/", "export/", "pushpull/")


def _tokens():
    return np.random.RandomState(2).randint(0, V, (2, S + 1)).astype(
        np.int32)


def _counters(snap):
    return {k: v for k, v in snap["counters"].items()
            if k.startswith(PREFIXES)}


def _jax_run(ps_lib, kw, ledger=False):
    """JAX ``make_ps_train_step`` STEPS steps: (initial weights, the
    counters, the reports, the ledger's FLOPs)."""
    import jax
    import jax.numpy as jnp
    import optax

    import byteps_tpu as jbps
    import byteps_tpu.native.build as jbuild
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.jax.train import make_ps_train_step as j_make
    from byteps_tpu.models import llama as jl
    from byteps_tpu.parallel.mesh import make_mesh
    from byteps_tpu.server import client as jclient

    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=V, seq=S),
                              dtype=jnp.float32)
    params = jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), cfg)
    init = jax.tree.map(np.asarray, params)
    tx = optax.sgd(0.05, momentum=0.9)
    opt = tx.init(params)
    tokens = _tokens()
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbuild, jclient):
            mp.setattr(mod, "build", lambda *a, **k: ps_lib)
        mp.setenv("BYTEPS_NATIVE_CODEC", "0")
        mp.setenv("BYTEPS_LEDGER", "1" if ledger else "0")
        mp.setenv("BYTEPS_FUSION_BYTES", FUSION)
        with ps_server() as port:
            _ps_env(mp, port)
            GlobalState._instance = None
            jbps.init()
            try:
                step = j_make(lambda p, b: jl.loss_fn(p, b, cfg), tx,
                              make_mesh(devices=jax.devices()[:1]), **kw)

                def run():
                    nonlocal params, opt
                    with jax.default_matmul_precision("float32"):
                        for _ in range(STEPS):
                            params, opt, _ = step(params, opt,
                                                  {"tokens": tokens})

                bounded(run, timeout=120)
                counters = _counters(jbps.get_metrics())
                reports = jbps.get_step_reports()
                flops = jbps.get_ledger().get("model_flops")
            finally:
                jbps.shutdown()
                GlobalState._instance = None
    return init, counters, reports, flops


@pytest.fixture(scope="module")
def jax_runs(ps_lib):
    return {"dense": _jax_run(ps_lib, {}, ledger=True),
            "onebit": _jax_run(ps_lib, ONEBIT)}


def _cfg(**kw):
    return dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=V, seq=S),
                               dtype=torch.float32, **kw)


def _port_run(monkeypatch, params=None, kw=None, steps=STEPS, env=None,
              attn=None, cfg=None, after_step=None):
    """The port's PS steps on the CPU: (counters, reports, ledger, the
    model, the error a step raised)."""
    cfg = cfg or _cfg()
    if params is None:
        model = tl.Llama(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    else:
        model = tl.Llama(cfg, device="cpu",
                         params=tl.params_from_jax(params, device="cpu"))
    tokens = torch.from_numpy(_tokens())
    monkeypatch.setenv("BYTEPS_FUSION_BYTES", FUSION)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    err = None
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bps.init(device="cpu")
        try:
            step = make_ps_train_step(
                lambda b: tl.loss_fn(model.params(), b, cfg, attn),
                torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
                model.params(), **(kw or {}))

            def run():
                for _ in range(steps):
                    step({"tokens": tokens})
                    if after_step is not None:
                        after_step(model)

            try:
                bounded(run)
            except RuntimeError as e:
                err = e
            bounded(step.close)
            snap = bps.get_metrics()
            reports = bps.get_step_reports()
            ledger = bps.get_ledger()
        finally:
            bps.shutdown()
    return _counters(snap), reports, ledger, model, err


@pytest.mark.parametrize("tier", ["dense", "onebit"])
def test_counters_equal_jax(tier, jax_runs, monkeypatch):
    init, want, j_reports, _ = jax_runs[tier]
    got, reports, _, _, _ = _port_run(
        monkeypatch, init, ONEBIT if tier == "onebit" else None)
    assert got == want
    assert got["wire/push_bytes"] > 0 and got["export/whole_bytes"] > 0
    if tier == "onebit":
        assert 0 < got["compress/bytes_post"] < got["compress/bytes_pre"]
    else:
        assert got["compress/bytes_pre"] == 0
    assert [r["step"] for r in reports] == [r["step"] for r in j_reports]
    for r in reports:
        assert 0 < r["compute_ms"] <= r["wall_ms"]
        assert r["wire_bytes"] == got["wire/push_bytes"] // STEPS * 2
        assert classify_step(StepReport(**r))


def test_device_tier_compress_counters_are_the_payloads(monkeypatch):
    got, reports, _, model, _ = _port_run(
        monkeypatch, kw=dict(compression={"compressor": "dithering",
                                          "ef": "vanilla"},
                             min_compress_bytes=0))
    dense = sum(p.numel() * 4 for p in model.parameters())
    assert got["compress/bytes_pre"] == 2 * dense * STEPS
    assert got["compress/bytes_post"] == got["wire/push_bytes"] + \
        got["wire/pull_bytes"]
    assert got["compress/bytes_post"] < got["compress/bytes_pre"]
    assert "export/whole_bytes" not in got     # as in the JAX device tier
    assert len(reports) == STEPS
    assert all(r["overlap_frac"] is None for r in reports)


def _analytic_flops(cfg, B, S, flash):
    """The step's matrix-product FLOPs: 2 a weight a token forward, 4
    backward, 2 again for the remat's recompute of each block but its
    last product (w_down: the checkpoint stops at the last saved
    tensor); attention in units u of the causal forward's QK^T and PV:
    the flash forward u (again under remat), its backward 7u (the
    blockwise recompute 2u, its checkpoint's scores 1u, the gradients
    4u); the plain path 2u a forward pass and 4u backward."""
    d, h, L, V_ = cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.vocab_size
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = B * S
    n_layer = d * nh * hd + 2 * d * nkv * hd + nh * hd * d + 3 * d * h
    dense = 6 * T * (L * n_layer + d * V_)
    if cfg.remat:
        dense += 2 * T * L * (n_layer - h * d)
    u = 2 * B * nh * S * S * hd
    att = (1 + cfg.remat + 7) * u if flash else (6 + 2 * cfg.remat) * u
    return dense + L * att


def test_ledger_flops_equal_the_analytic_count(jax_runs, monkeypatch):
    cfg = _cfg(remat=True)
    _, reports, ledger, _, _ = _port_run(
        monkeypatch, cfg=cfg, attn=FA.make_flash_attn(block_k=16))
    want = _analytic_flops(cfg, 2, S, flash=True)
    assert ledger["source"] == "flop_counter"
    assert ledger["model_flops"] == want
    assert ledger["peak_source"] == "cpu-nominal"
    for r in reports:
        assert r["achieved_flops"] == pytest.approx(
            want / (r["wall_ms"] / 1e3), rel=1e-12)
    # the JAX cost model, for the record (remat off, plain attention)
    plain = _analytic_flops(_cfg(), 2, S, flash=False)
    print(f"FLOPs a step: port {ledger['model_flops']:.6g} (analytic "
          f"{want:.6g}); JAX XLA cost analysis of its dense plain step "
          f"{jax_runs['dense'][3]} against the analytic {plain:.6g}")


def test_health_grad_norm_is_the_pulled_aggregates_norm(monkeypatch):
    norms = []

    def grab(model):
        norms.append(float(torch.linalg.vector_norm(torch.cat(
            [p.grad.reshape(-1) for p in model.parameters()]))))

    _, reports, _, _, _ = _port_run(
        monkeypatch, env={"BYTEPS_HEALTH": "1"}, after_step=grab)
    assert len(norms) == len(reports) == STEPS
    for r, n in zip(reports, norms):
        assert r["grad_norm"] == pytest.approx(n, rel=1e-5)
        assert r["nonfinite_leaves"] == 0 and r["health_flags"] == ()
        assert r["update_ratio_p95"] > 0


def test_chaos_nan_leaf_latches_and_the_guard_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(ttrain, "_chaos_nan_fired", set())
    _, reports, _, _, err = _port_run(
        monkeypatch, steps=3,
        env={"BYTEPS_HEALTH": "1", "BYTEPS_NAN_GUARD": "1",
             "BYTEPS_CHAOS_NAN_LEAF": "wq@2",
             "BYTEPS_FLIGHT_DIR": str(tmp_path)})
    assert err is not None and "BYTEPS_NAN_GUARD" in str(err)
    assert [r["step"] for r in reports] == [1, 2]
    assert reports[0]["nonfinite_leaves"] == 0
    assert reports[1]["nonfinite_leaves"] == 1
    assert reports[1]["health_flags"] == ("nonfinite",)
    path = str(err).split("flight record dumped to ")[1]
    kinds = [e["kind"] for e in json.load(open(path))["worker"]["events"]]
    assert "chaos_nan_injected" in kinds and "health_nonfinite" in kinds


# the worker process of the SIGTERM test: a server thread, two steps, one
# replayed push (the server's flight ring records its dedup), then wait
CHILD = r"""
import os, sys, threading, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import byteps_tpu_torch as bps
from byteps_tpu_torch.config import Config
from byteps_tpu_torch.core.types import DataType, RequestType, get_command_type
from byteps_tpu_torch.models import mlp
from byteps_tpu_torch.server import run_server
from byteps_tpu_torch.training import make_ps_train_step
port = int(os.environ["DMLC_PS_ROOT_PORT"])
threading.Thread(target=run_server, args=(port, Config(num_workers=1,
                 num_servers=1)), daemon=True).start()
bps.init(device="cpu")
cfg = mlp.MLPConfig(in_dim=16, hidden=(16,), n_classes=4)
model = mlp.MLP(cfg, "cpu", params=mlp.init_params(
    cfg, torch.Generator().manual_seed(0), "cpu"))
step = make_ps_train_step(lambda b: mlp.loss_fn(model.params(), b, cfg),
                          torch.optim.SGD(model.parameters(), lr=0.1),
                          model.params())
batch = {"x": torch.ones(4, 16), "y": torch.zeros(4, dtype=torch.int64)}
for _ in range(2):
    step(batch)
client = bps.get_state().ps_client
cmd = get_command_type(RequestType.DEFAULT_PUSH_PULL, DataType.FLOAT32)
key, data = (1 << 40) + 7, np.ones(8, np.float32)
client.init_key(0, key, data, cmd)
for _ in range(2):          # the second is a replay of round 1
    done = threading.Event()
    client.zpushpull_async(0, key, data, np.empty_like(data), cmd,
                           lambda got, err: done.set(), epoch=1 << 16)
    done.wait(30)
print("READY", flush=True)
time.sleep(120)
"""


def test_sigterm_dumps_the_merged_flight_record_and_timeseries(
        ps_lib, tmp_path):
    from _torch_port_ps_util import _free_port
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DMLC_NUM_WORKER="1", DMLC_NUM_SERVER="1",
               DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(_free_port()),
               BYTEPS_FLIGHT_DIR=str(tmp_path), BYTEPS_FUSION_BYTES="0")
    for k in ("BYTEPS_SERVER_HOSTS", "BYTEPS_LOCAL_SIZE", "DMLC_ROLE",
              "BYTEPS_GLOBAL_RANK"):
        env.pop(k, None)
    proc = subprocess.Popen([sys.executable, "-c", CHILD, root], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stdout.readline()
        assert line.strip() == "READY", proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == -signal.SIGTERM
    doc = json.load(open(tmp_path / f"flight-{proc.pid}.json"))
    assert doc["reason"] == "SIGTERM"
    srv = [e for e in doc["merged"] if e["source"] == "server0"]
    assert any(e["kind"] == "replay_dedup" for e in srv), doc["servers"]
    lines = open(tmp_path / f"timeseries-{proc.pid}.jsonl").read() \
        .splitlines()
    head = json.loads(lines[0])
    assert head["reason"] == "SIGTERM" and head["steps"] == 2
    names = {json.loads(x)["name"] for x in lines[1:]}
    assert "step/wall_ms" in names

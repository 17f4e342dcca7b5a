#!/usr/bin/env python3
"""Time the parameter-server round of the training path, stage by stage.

    python3 scripts/ps_round_spans.py [--root DIR] [--rounds 12] [--seed 0]

Drives ``DeviceCompressor.push_pull_leaves`` of the ``byteps_tpu_torch``
package under ``--root`` (default: this checkout) on one CUDA card
through a loopback server, with the gradient leaves of
``LlamaConfig.small()`` (random f32 from the seed), under dithering + EF
and under randomk (k = 1%) + EF: the two configurations of the PS phase
of chip_smoke.py, without the forward and backward around them. Every
round records its spans (compress, d2h, wire, h2d, decompress: host
clock, the device synced at each border) and its B4/B5 launches. The
script prints the card's name and power limit, then for each
configuration the median and the minimum of each span over the rounds
after the first (which installs the keys), and one more round, without
spans, under ``torch.profiler``: its wall time, the device's busy time
(the union of its kernels' intervals) and the kernels that took most of
it. Pointing ``--root`` at an unpacked parent commit measures another
tree the same way, so two trees can be compared in turns on one card.
"""

from __future__ import annotations

import argparse
import os
import socket
import statistics
import subprocess
import sys
import threading

TIMEOUT_S = 300


def bounded(fn, what: str):
    """``fn()`` on a thread; a PS round that never returns ends the
    process with an error instead of hanging it."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(TIMEOUT_S)
    if t.is_alive():
        print(f"ps_round_spans: FAILED: {what} did not finish within "
              f"{TIMEOUT_S} s", file=sys.stderr, flush=True)
        os._exit(1)
    if "err" in box:
        raise box["err"]
    return box.get("out")


def small_leaves(dev, seed: int):
    """(names, f32 gradients) of LlamaConfig.small(), in the order of the
    PS train step."""
    import torch
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.training.train import named_leaves

    def meta(node):
        if isinstance(node, dict):
            return {k: meta(v) for k, v in node.items()}
        return torch.empty(node, device="meta")

    gen = torch.Generator(device=dev).manual_seed(seed)
    named = named_leaves(meta(llama.param_shapes(llama.LlamaConfig.small())))
    return (["grad/" + n for n, _ in named],
            [torch.randn(t.shape, generator=gen, device=dev) * 1e-3
             for _, t in named])


def run(kw: dict, names, grads, dev, rounds: int) -> None:
    import torch
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.ops.compression import kernels as K
    from byteps_tpu_torch.server import run_server
    from byteps_tpu_torch.training.device_compression import \
        DeviceCompressor
    from byteps_tpu_torch.utils.spans import StepSpans

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    os.environ.update({
        "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
        "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_ROLE": "worker"})
    server = threading.Thread(target=run_server, args=(
        port, Config(num_workers=1, num_servers=1)), daemon=True)
    server.start()
    bps.init(device=dev)
    counter = K.dithering_levels if kw["compressor"] == "dithering" \
        else K.randomk_indices
    per_round, launches = [], []
    try:
        state = bps.get_state()
        dc = DeviceCompressor(state.ps_client, 1, kw,
                              state.config.min_compress_bytes)
        for r in range(rounds):
            spans = StepSpans(enabled=True)
            before = counter.launches
            spans.start(dev)
            bounded(lambda: dc.push_pull_leaves(state, names, grads,
                                                spans=spans),
                    f"round {r} ({kw['compressor']})")
            torch.cuda.synchronize(dev)
            launches.append(counter.launches - before)
            per_round.append(dict(spans.ms))
        profile_round(lambda: dc.push_pull_leaves(state, names, grads), dev,
                      kw["compressor"])
    finally:
        bounded(bps.shutdown, "shutdown")
    server.join(TIMEOUT_S)
    steady = per_round[1:]
    parts = []
    for k in steady[0]:
        vals = [s[k] for s in steady]
        parts.append(f"{k} {statistics.median(vals):.2f} "
                     f"(min {min(vals):.2f})")
    print(f"ps round {kw['compressor']} + EF, median (min) ms over rounds "
          f"1..{rounds - 1}: " + ", ".join(parts) +
          f"; {counter.__name__} launches per round {launches[1:]}",
          flush=True)


def profile_round(fn, dev, label: str, top: int = 8) -> None:
    """One round under torch.profiler: wall ms, device-busy ms and the
    kernels by device time."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bounded(fn, f"profiled round ({label})")
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        if b > end:                        # union: intervals may overlap
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    print(f"profiled round {label}: {wall_ms:.2f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / wall_ms:.4f}), "
          f"{len(kernels)} kernels", flush=True)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        print(f"  {t / 1e3:8.3f} ms x{n:<4d} {name[:90]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ps_round_spans: FAILED: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(TIMEOUT_S))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{card}; tree {os.path.abspath(args.root)}", flush=True)
    dev = torch.device("cuda", 0)
    names, grads = small_leaves(dev, args.seed)
    for kw in ({"compressor": "dithering", "ef": "vanilla"},
               {"compressor": "randomk", "k": "0.01", "ef": "vanilla"}):
        run(kw, names, grads, dev, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())

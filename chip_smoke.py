#!/usr/bin/env python3
"""Drive the PyTorch port's training path on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 4] [--seed 0]

Phases, each of which must pass or the script exits non-zero without a
result line:

1. the card's name and power limit (``nvidia-smi``);
2. the build of every CUDA kernel of the paths from
   ``byteps_tpu_torch/csrc`` (one nvcc per source, all at once) and, beside
   them, the g++ build of the parameter server ``native/ps.cc``;
3. each kernel against its plain PyTorch twin on the card, at the shapes of
   the training paths, with its time, the twin's time, the time of one
   PyTorch library call for the same function where there is one, and the
   least time the card could take (bound);
4. a small fp32 Llama on the card (kernels) against the same model on the
   CPU (plain twins): loss and every gradient;
5. the collective training path: ``init`` -> ``LlamaConfig.small()`` at
   full width with flash attention -> ``DistributedOptimizer(Adam, onebit
   + EF)`` -> ``make_train_step`` for ``--steps`` steps on seeded tokens;
6. the parameter-server training path: a loopback server thread
   (``run_server``, one worker) -> ``init`` in PS mode -> the same model ->
   ``make_ps_train_step`` with Adam, under dithering + EF for ``--steps``
   steps, then under randomk (k = 1%) + EF for 3; gradients are
   compressed on the card, summed by the C++ server, decompressed on the
   card. One more dithering step records where a step's time goes.

Before each path runs, the kernel launch counters are zeroed; they are
read just after. It prints a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# the vocab x dim embedding, the training path's largest compressed leaf
EMBED_N = 32000 * 768
RAGGED_N = 1_000_003           # not a multiple of 32: the tail word
FLASH_SHAPE = dict(B=4, S=2048, H=6, Hkv=2, D=128)
RANDOMK_BIG_K = 1 << 20
# a PS step, or the server's exit, that takes longer fails the run
PS_TIMEOUT_S = 300


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events. Small kernels
    launched eagerly from Python are bound by the host's issue rate, which
    this leaves out (``cuda_ms`` keeps it in)."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi rc={out.returncode}: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build() -> None:
    from byteps_tpu_torch.native import build
    names = ["onebit", "flash_attn_fwd", "counter_rng"]
    ps = {}

    def build_ps():
        t0 = time.perf_counter()
        try:
            build.build_ps()
        except Exception as e:  # noqa: BLE001 - reported below
            ps["err"] = e
        ps["s"] = time.perf_counter() - t0

    gxx = threading.Thread(target=build_ps)
    gxx.start()                       # g++ alongside the nvcc builds
    t0 = time.perf_counter()
    build.build_all(names)
    print(f"build: {time.perf_counter() - t0:.3f} s for "
          f"{', '.join(n + '.cu' for n in names)}", flush=True)
    gxx.join()
    if "err" in ps:
        fail(f"g++ build of native/ps.cc: {ps['err']}")
    print(f"build: {ps['s']:.3f} s for native/ps.cc (g++)", flush=True)
    for n in names:
        with open(build.log_path(n)) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {n}: {line.strip()}", file=sys.stderr)


def phase_onebit(dev, gen) -> list:
    import torch
    from byteps_tpu_torch.ops.compression import kernels as K

    res = {}
    for n in (EMBED_N, RAGGED_N):
        x = torch.randn(n, generator=gen, device=dev)
        x[::97] = 0.0                       # zeros pack as bit 1
        words = K.onebit_pack(x)
        want = K.onebit_pack_plain(x)
        if not torch.equal(words, want):
            fail(f"onebit_pack differs from its plain twin at n={n}: "
                 f"{int((words != want).sum())} words")
        scale = x.abs().mean()
        got = K.onebit_unpack(words, scale, n)
        ref = K.onebit_unpack_plain(want, scale, n)
        batched = K.onebit_unpack(words[None], scale.reshape(1), n)
        if not (torch.equal(got, ref) and torch.equal(batched[0], ref)):
            fail(f"onebit_unpack differs from its plain twin at n={n}")
        print(f"onebit n={n}: pack and unpack bit-exact", flush=True)
        if n == EMBED_N:
            res = dict(x=x, words=words, scale=scale)

    n, x, words, scale = EMBED_N, res["x"], res["words"], res["scale"]
    nw = words.numel()
    pack = dict(
        name="onebit_pack", route="cuda",
        source="byteps_tpu_torch/csrc/onebit.cu",
        replaces="byteps_tpu/ops/compression/pallas_kernels.py:36",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: K.onebit_pack(x), 50),
        plain_ms=cuda_ms(lambda: K.onebit_pack_plain(x), 10),
        bound_ms=(4 * n + 4 * nw) / PEAK_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None)
    unpack = dict(
        name="onebit_unpack", route="cuda",
        source="byteps_tpu_torch/csrc/onebit.cu",
        replaces="byteps_tpu/ops/compression/pallas_kernels.py:48",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: K.onebit_unpack(words, scale, n), 50),
        plain_ms=cuda_ms(lambda: K.onebit_unpack_plain(words, scale, n), 10),
        bound_ms=(4 * nw + 4 + 4 * n) / PEAK_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None)
    for e in (pack, unpack):
        print(f"{e['name']} n={n}: {e['ms']:.4f} ms (plain "
              f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms)",
              flush=True)
    return [pack, unpack]


def _flash_inputs(gen, dev, D):
    import torch
    B, S, H, Hkv = (FLASH_SHAPE[k] for k in ("B", "S", "H", "Hkv"))
    bf = torch.bfloat16
    return (torch.randn(B, S, H, D, generator=gen, device=dev).to(bf),
            torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(bf),
            torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(bf))


def _flash_check(q, k, v) -> float:
    """The kernel against its blockwise twin under one bf16 step of the
    fp32 result; returns the max abs error."""
    import torch
    from byteps_tpu_torch.ops import flash_attention as FA
    with torch.no_grad():
        got = FA.flash_attention_fwd(q, k, v, True)
        torch.cuda.synchronize()
        ref = FA.blockwise_attention(q, k, v, causal=True)
    diff = (got.float() - ref.float()).abs()
    # both round an fp32 result to bf16; the fp32 results differ only by
    # summation order (~1e-6 relative), so an element may land one bf16
    # step apart: at most 2^-7 of its magnitude
    tol = 2.0 ** -7 * ref.float().abs() + 1e-6
    err = float(diff.max())
    if not bool(torch.isfinite(got.float()).all()) or bool((diff > tol).any()):
        fail(f"flash_attention kernel vs blockwise at {tuple(q.shape)}: max "
             f"abs err {err}, {int((diff > tol).sum())} elements above one "
             f"bf16 step")
    return err


def _flash_times(q, k, v, plain: bool) -> tuple:
    """(kernel ms, plain twin ms or None, scaled_dot_product_attention ms,
    bound ms, bound_by) at q's shape, causal."""
    import torch
    import torch.nn.functional as F
    from byteps_tpu_torch.ops import flash_attention as FA
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kt = kt.repeat_interleave(H // Hkv, 1)
    vt = vt.repeat_interleave(H // Hkv, 1)
    with torch.no_grad():
        ms = cuda_ms(lambda: FA.flash_attention_fwd(q, k, v, True), 50)
        plain_ms = cuda_ms(lambda: FA.blockwise_attention(q, k, v, True), 3) \
            if plain else None
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 50)
    t_flops = _flash_flops(B, S, H, D) / PEAK_BF16_FLOPS * 1e3
    t_bytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D) \
        / PEAK_BYTES_PER_S * 1e3
    bound_by = "operations" if t_flops >= t_bytes else "bytes"
    return ms, plain_ms, lib_ms, max(t_flops, t_bytes), bound_by


def _flash_flops(B: int, S: int, H: int, D: int) -> float:
    """QK^T and PV over the causal half."""
    return 2.0 * B * H * S * S * D


def phase_flash(dev, gen) -> dict:
    """B1 at the training path's shape (D = 128) and at D = 64 (the card
    tests' second width): the gate against the blockwise twin, the time,
    the twin's time, scaled_dot_product_attention's and the bound."""
    B, S, H, Hkv, D = (FLASH_SHAPE[k] for k in ("B", "S", "H", "Hkv", "D"))
    q, k, v = _flash_inputs(gen, dev, D)
    err = _flash_check(q, k, v)
    print(f"flash_attention B={B} S={S} H={H} Hkv={Hkv} D={D} bf16 causal: "
          f"max abs err {err} (tolerance: one bf16 step)", flush=True)
    ms, plain_ms, lib_ms, bound_ms, bound_by = _flash_times(q, k, v, True)
    e = dict(name="flash_attn_fwd", route="cuda",
             source="byteps_tpu_torch/csrc/flash_attn_fwd.cu",
             replaces="byteps_tpu/ops/flash_attention.py:102",
             max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
             bound_by=bound_by, library_ms=lib_ms)
    print(f"flash_attention: {ms:.4f} ms, "
          f"{_flash_flops(B, S, H, D) / ms / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / ms:.3f} of its bound ({bound_ms:.4f} ms, "
          f"{bound_by}); {ms / lib_ms:.2f}x scaled_dot_product_attention's "
          f"{lib_ms:.4f} ms; plain twin {plain_ms:.4f} ms", flush=True)
    q, k, v = _flash_inputs(gen, dev, 64)
    err64 = _flash_check(q, k, v)
    ms, _, lib_ms, bound_ms, _ = _flash_times(q, k, v, False)
    print(f"flash_attention D=64: {ms:.4f} ms, "
          f"{_flash_flops(B, S, H, 64) / ms / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / ms:.3f} of its bound ({bound_ms:.4f} ms); "
          f"{ms / lib_ms:.2f}x scaled_dot_product_attention's {lib_ms:.4f} "
          f"ms; max abs err {err64}", flush=True)
    return e


def path_partition_n() -> int:
    """Elements in one partition of the PS path: the registry's
    partition length for a leaf as large as the embedding."""
    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.core.registry import TensorRegistry
    ctx = TensorRegistry(Config(num_servers=1)).init_tensor("probe",
                                                            EMBED_N * 4)
    return ctx.partitions[0].length // 4


def _power_of_two_front(x):
    """Exact powers of two, and their neighbours one ulp either side, at
    the front of ``x`` (where floor(-log2) turns)."""
    import torch
    p2 = 2.0 ** -torch.arange(32, dtype=torch.float32, device=x.device)
    p2 = p2 * torch.where(torch.arange(32, device=x.device) % 2 == 1,
                          1.0, -1.0)
    x[:32] = p2
    x[32:64] = torch.nextafter(p2, torch.zeros_like(p2))
    x[64:96] = torch.nextafter(p2, p2 * 2)
    x[96:104] = 0.0
    return x


def phase_dither(dev, gen, seed: int) -> dict:
    """B4 at one partition of the path and at a ragged n: linear and
    natural, max and L2, against the plain twin on the card and (max
    norms) against the numpy golden of the host codec."""
    import numpy as np
    import torch
    from byteps_tpu_torch.ops.compression import kernels as K
    from byteps_tpu_torch.ops.compression import rng
    from byteps_tpu_torch.ops.compression.codecs import DitheringCodec
    from byteps_tpu_torch.ops.compression.host import HostDithering

    part_n = path_partition_n()
    step = 3
    base = rng.uniform_base(seed, step)
    worst, timed = 0, None
    for n in (part_n, RAGGED_N):
        x = _power_of_two_front(torch.randn(n, generator=gen, device=dev))
        for partition in ("linear", "natural"):
            for normalize in ("max", "l2"):
                codec = DitheringCodec(size=n, s=127, partition=partition,
                                       normalize=normalize, seed=seed)
                norm = codec.norm(x)
                got = K.dithering_levels(x, norm, base, 127, partition)
                want = K.dithering_levels_plain(x, norm, base, 127,
                                                partition)
                diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
                n_diff, err = int((diff > 0).sum()), int(diff.max())
                worst = max(worst, err)
                what = f"dithering_levels {partition}/{normalize} n={n}"
                # linear must be bit-exact; natural may differ only where
                # log2 rounds at a power of two: off by one, rarely
                if partition == "linear" and n_diff:
                    fail(f"{what}: {n_diff} levels differ from the twin")
                if n_diff > max(1, n // 100_000) or err > 1:
                    fail(f"{what}: {n_diff} levels differ, by up to {err}")
                gold = ""
                if normalize == "max":
                    host = HostDithering(n=n, s=127, partition=partition,
                                         seed=seed)
                    wire = np.frombuffer(host.compress(x.cpu().numpy(),
                                                       step), np.int8)
                    g_diff = int((wire[:n] != got.cpu().numpy()).sum())
                    if g_diff > max(1, n // 100_000) or \
                            (partition == "linear" and g_diff):
                        fail(f"{what}: {g_diff} levels differ from the "
                             f"numpy golden")
                    gold = f", {g_diff} from the numpy golden"
                call = lambda: K.dithering_levels(  # noqa: E731
                    x, norm, base, 127, partition)
                ms, call_ms = cuda_graph_ms(call), cuda_ms(call, 50)
                print(f"{what}: {n_diff} levels differ from the twin"
                      f"{gold}; {ms:.4f} ms on the device, {call_ms:.4f} "
                      f"ms a call from Python (bound "
                      f"{5 * n / PEAK_BYTES_PER_S * 1e3:.4f} ms)",
                      flush=True)
                if (n, partition, normalize) == (part_n, "linear", "max"):
                    timed = dict(x=x, norm=norm, ms=ms)
    x, norm = timed["x"], timed["norm"]
    plain = lambda: K.dithering_levels_plain(  # noqa: E731
        x, norm, base, 127, "linear")
    plain_ms = cuda_graph_ms(plain, reps=5)
    print(f"dithering_levels_plain linear/max n={part_n}: {plain_ms:.4f} ms "
          f"on the device, {cuda_ms(plain, 10):.4f} ms a call", flush=True)
    return dict(
        name="dithering_levels", route="cuda",
        source="byteps_tpu_torch/csrc/counter_rng.cu",
        replaces="byteps_tpu/ops/compression/pallas_kernels.py:157",
        max_abs_err=float(worst), ms=timed["ms"], plain_ms=plain_ms,
        bound_ms=5 * part_n / PEAK_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None)


def phase_randomk(dev, seed: int) -> dict:
    """B5 at the path's k (1% of a partition) and at k = 2^20 over the
    embedding, bit-exact against the twin and the numpy golden."""
    import numpy as np
    import torch
    from byteps_tpu_torch.ops.compression import kernels as K
    from byteps_tpu_torch.ops.compression import rng
    from byteps_tpu_torch.ops.compression.codecs import resolve_k

    part_n = path_partition_n()
    path_k = resolve_k(0.01, part_n)
    step = 5
    base = rng.uniform_base(seed, step)
    out = {}
    for size, k in ((part_n, path_k), (EMBED_N, RANDOMK_BIG_K)):
        got = K.randomk_indices(base, size, k, dev)
        torch.cuda.synchronize()
        if not torch.equal(got, K.randomk_indices_plain(base, size, k, dev)):
            fail(f"randomk_indices k={k} differs from its plain twin")
        if not np.array_equal(got.cpu().numpy(),
                              rng.np_index_parallel(seed, k, size, step)):
            fail(f"randomk_indices k={k} differs from the numpy golden")
        call = lambda: K.randomk_indices(base, size, k, dev)  # noqa: E731
        plain = lambda: K.randomk_indices_plain(  # noqa: E731
            base, size, k, dev)
        ms, plain_ms = cuda_graph_ms(call), cuda_graph_ms(plain, reps=5)
        print(f"randomk_indices size={size} k={k}: bit-exact; {ms:.4f} ms "
              f"on the device, {cuda_ms(call, 50):.4f} ms a call from "
              f"Python (plain {plain_ms:.4f} ms on the device, "
              f"{cuda_ms(plain, 10):.4f} ms a call; bound "
              f"{4 * k / PEAK_BYTES_PER_S * 1e3:.6f} ms)", flush=True)
        out[k] = (ms, plain_ms)
    ms, plain_ms = out[path_k]
    return dict(
        name="randomk_indices", route="cuda",
        source="byteps_tpu_torch/csrc/counter_rng.cu",
        replaces="byteps_tpu/ops/compression/pallas_kernels.py:223",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=4 * path_k / PEAK_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None)


def phase_small_model(dev) -> None:
    """A small fp32 Llama with head dim 64: loss and gradients with the
    kernels on the card against the plain twins on the CPU."""
    import torch
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops.flash_attention import make_flash_attn

    cfg = llama.LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=2,
                            n_kv_heads=1, hidden_dim=256, max_seq_len=256,
                            dtype=torch.float32, remat=True)
    gen = torch.Generator().manual_seed(1)
    params = llama.init_params(cfg, gen, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 257), generator=gen)
    attn = make_flash_attn(block_k=64)
    out = {}
    for where in ("cpu", dev):
        model = llama.Llama(cfg, device=where, params=params)
        loss = llama.loss_fn(model.params(), {"tokens": tokens.to(where)},
                             cfg, attn)
        loss.backward()
        out[str(where)] = (float(loss.detach()), {n: p.grad.detach().cpu()
                                         for n, p in model.named_parameters()})
    (l_cpu, g_cpu), (l_dev, g_dev) = out["cpu"], out[str(dev)]
    # fp32 on both sides (no TF32): only summation order differs
    if not (math.isfinite(l_dev) and abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)):
        fail(f"small model loss on the card {l_dev} vs CPU {l_cpu}")
    worst = 0.0
    for name, gc in g_cpu.items():
        rel = float((g_dev[name] - gc).abs().max()) / \
            max(float(gc.abs().max()), 1e-30)
        worst = max(worst, rel)
        if rel > 1e-3:
            fail(f"small model grad {name}: max err {rel} of its max")
    print(f"small fp32 model: loss card {l_dev} vs CPU {l_cpu}; worst "
          f"gradient error {worst:.3e} of the leaf's max", flush=True)


def phase_train(args, card: str) -> dict:
    import torch
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops.compression import kernels as K
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.training import (DistributedOptimizer,
                                           make_train_step)

    counters = {"flash_attn_fwd": FA.flash_attention_fwd,
                "onebit_pack": K.onebit_pack,
                "onebit_unpack": K.onebit_unpack}
    bps.init()
    try:
        dev = bps.get_state().device
        cfg = llama.LlamaConfig.small()
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        model = llama.Llama(cfg, device=dev, generator=gen)
        opt = DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-3,
                             betas=(0.9, 0.999), eps=1e-8),
            compression={"compressor": "onebit", "ef": "vanilla"})
        attn = FA.make_flash_attn()
        step = make_train_step(
            lambda b: llama.loss_fn(model.params(), b, cfg, attn), opt)
        B, S = 4, 2048
        tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                               device=dev)
        n_params = sum(p.numel() for p in model.parameters())
        n_comp = sum(s is not None for s in opt.compression.stacks)
        print(f"train: LlamaConfig.small() dim {cfg.dim}, {cfg.n_layers} "
              f"layers, vocab {cfg.vocab_size}, {n_params} params, "
              f"{n_comp} of {len(opt.params)} leaves onebit-compressed, "
              f"B={B} S={S}", flush=True)
        torch.cuda.reset_peak_memory_stats(dev)
        for fn in counters.values():
            fn.launches = 0
        losses, times = [], []
        for i in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step({"tokens": tokens})
            loss_v = float(loss)                # waits for the step
            times.append(time.perf_counter() - t0)
            losses.append(loss_v)
            print(f"step {i}: loss {loss_v:.6f} ({times[-1] * 1e3:.1f} ms)",
                  flush=True)
        launches = {k: fn.launches for k, fn in counters.items()}
        if args.profile:
            profile_step(step, {"tokens": tokens}, args.profile)
    finally:
        bps.shutdown()
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if any(v == 0 for v in launches.values()):
        fail(f"a kernel of the path never launched: {launches}")
    steady = times[1:] if len(times) > 1 else times
    tok_s = B * S / (sum(steady) / len(steady))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"train: {tok_s:.1f} tokens/s over steps 1..{len(times) - 1} "
          f"(step 0 has the warm-up) on {card}; peak memory {peak_gb:.2f} "
          f"GB; launches in {args.steps} steps {launches}", flush=True)
    return launches


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def bounded(fn, what: str):
    """Run ``fn`` on a thread; a run that outlives PS_TIMEOUT_S ends the
    process with an error and no result line (a stuck PS round never
    returns, and its pool threads would block a normal exit)."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(PS_TIMEOUT_S)
    if t.is_alive():
        print(f"chip_smoke: FAILED: {what} did not finish within "
              f"{PS_TIMEOUT_S} s", file=sys.stderr, flush=True)
        os._exit(1)
    if "err" in box:
        raise box["err"]
    return box.get("out")


def phase_ps_train(args, card: str, dev=None, cfg=None, B: int = 4,
                   S: int = 2048) -> dict:
    """The PS path: a loopback server, ``init`` in PS mode, Llama small()
    at full width, ``make_ps_train_step`` under dithering + EF and then
    randomk + EF. Returns each run's launch counts. ``dev``/``cfg``/``B``/
    ``S`` exist to rehearse the phase on the CPU at a tiny size."""
    import torch
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.ops.compression import kernels as K
    from byteps_tpu_torch.server import run_server
    from byteps_tpu_torch.training import make_ps_train_step

    # the native client waits this long for a round (the default is 600 s)
    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(PS_TIMEOUT_S))
    counters = {"flash_attn_fwd": FA.flash_attention_fwd,
                "onebit_pack": K.onebit_pack,
                "onebit_unpack": K.onebit_unpack,
                "dithering_levels": K.dithering_levels,
                "randomk_indices": K.randomk_indices}
    dev = torch.device(dev or "cuda:0")
    on_card = dev.type == "cuda"
    cfg = cfg or llama.LlamaConfig.small()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    model = llama.Llama(cfg, device=dev, generator=gen)
    attn = FA.make_flash_attn()
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           device=dev)
    if on_card:
        # forward and backward alone, no server running: the yardstick
        # of the PS steps' forward_backward span
        fb = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            llama.loss_fn(model.params(), {"tokens": tokens}, cfg,
                          attn).backward()
            torch.cuda.synchronize()
            fb.append((time.perf_counter() - t0) * 1e3)
        model.zero_grad(set_to_none=True)
        print(f"ps: forward and backward alone, no server running: "
              f"{['%.1f' % t for t in fb]} ms", flush=True)
    runs = (("dithering", {"compressor": "dithering", "ef": "vanilla"},
             args.steps),
            ("randomk", {"compressor": "randomk", "k": "0.01",
                         "ef": "vanilla"}, 3))
    out = {}
    for label, kw, n_steps in runs:
        port = _free_port()
        os.environ.update({
            "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
            "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
            "DMLC_ROLE": "worker"})
        server = threading.Thread(
            target=run_server, args=(port, Config(num_workers=1,
                                                  num_servers=1)),
            name="ps-server", daemon=True)
        server.start()
        bps.init(device=dev)
        try:
            state = bps.get_state()
            opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                                   betas=(0.9, 0.999), eps=1e-8)
            step = make_ps_train_step(
                lambda b: llama.loss_fn(model.params(), b, cfg, attn), opt,
                model.params(), compression=kw)
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            for fn in counters.values():
                fn.launches = 0
            pushed0 = state.scheduler.bytes_pushed
            losses, times = [], []
            for i in range(n_steps):
                if on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss_v = bounded(lambda: float(step({"tokens": tokens})),
                                 f"PS step {i} ({label})")
                times.append(time.perf_counter() - t0)
                losses.append(loss_v)
                print(f"ps {label} step {i}: loss {loss_v:.6f} "
                      f"({times[-1] * 1e3:.1f} ms)", flush=True)
            launches = {k: fn.launches for k, fn in counters.items()}
            pushed = state.scheduler.bytes_pushed - pushed0
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 \
                if on_card else float("nan")
            plans = step.device_compressor()._plans.values()
            n_parts = sum(len(p.codecs) for p in plans)
            n_comp = sum(c is not None for p in plans for c in p.codecs)
            step.spans.enabled = True
            bounded(lambda: float(step({"tokens": tokens})),
                    f"PS timed step ({label})")
            spans = dict(step.spans.ms)
        finally:
            bounded(bps.shutdown, f"PS shutdown ({label})")
        server.join(PS_TIMEOUT_S)
        if server.is_alive():
            fail(f"the PS server ({label}) did not exit after shutdown")
        if not all(math.isfinite(x) for x in losses):
            fail(f"non-finite PS loss ({label}): {losses}")
        steady = times[1:]
        step_ms = [t * 1e3 for t in steady]
        tok_s = B * S / (sum(steady) / len(steady))
        per_step = {k: v / n_steps for k, v in launches.items()}
        print(f"ps {label}: {tok_s:.1f} tokens/s over steps 1.."
              f"{n_steps - 1} (step 0 has the warm-up and the key "
              f"installs) on {card}; steps {['%.1f' % t for t in step_ms]} "
              f"ms; peak memory {peak_gb:.2f} GB; {n_comp} of {n_parts} "
              f"partitions compressed; {pushed / n_steps / 1e6:.3f} MB "
              f"pushed per step; launches per step {per_step}", flush=True)
        total = sum(spans.values())
        print(f"ps {label} where the time goes (one more step, host clock, "
              f"device synced at each border; {total:.1f} ms in all): " +
              ", ".join(f"{k} {v:.1f} ms ({v / total:.3f})"
                        for k, v in spans.items()), flush=True)
        out[label] = launches
    if out["dithering"]["dithering_levels"] == 0:
        fail(f"dithering_levels never launched on the PS path: {out}")
    if out["randomk"]["randomk_indices"] == 0:
        fail(f"randomk_indices never launched on the PS path: {out}")
    return out


def profile_step(step, batch, out_dir: str) -> None:
    """One more train step under torch.profiler: device time by kernel,
    the device-busy share of the step, and a Chrome trace in out_dir."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(step(batch))
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "train_step_trace.json"))

    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                   # union: streams may overlap
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name, by_class = {}, {}
    for e in kernels:
        for table, key in ((by_name, e.name), (by_class, _kernel_class(e.name))):
            t, n = table.get(key, (0.0, 0))
            table[key] = (t + e.time_range.elapsed_us(), n + 1)
    print(f"profile: step {wall_ms:.1f} ms, device busy {busy_us / 1e3:.1f} "
          f"ms ({busy_us / 1e3 / wall_ms:.3f} of the step), "
          f"{len(kernels)} kernels", flush=True)
    for title, table, rows in (("by class", by_class, 10),
                               ("by kernel", by_name, 25)):
        total = sum(t for t, _ in table.values())
        print(f"profile {title} (device ms, share of kernel time, count):")
        for name, (t, n) in sorted(table.items(),
                                   key=lambda kv: -kv[1][0])[:rows]:
            print(f"  {t / 1e3:9.3f} ms {t / total:6.3f} x{n:<5d} "
                  f"{name[:90]}")


def _kernel_class(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_fwd (B1)"
    if "onebit" in name:
        return "onebit (B2, B3)"
    if "nccl" in name.lower():
        return "nccl"
    if "nvjet" in name or ("gemm" in name and "bf16" in name):
        return "gemm bf16"
    if "sgemm" in name or "f32f32" in name:
        return "gemm f32"
    if "reduce_kernel" in name:
        return "reductions"
    if "elementwise" in name or "copy" in name:
        return "elementwise and copies"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="profile one extra train step; trace into DIR")
    args = ap.parse_args()
    if args.steps < 3:
        fail("--steps must be at least 3")

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(ROOT, "byteps_tpu_torch", "csrc")):
        fail(f"no byteps_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_card()
    phase_build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kernels = phase_onebit(dev, gen)
    kernels.insert(0, phase_flash(dev, gen))
    kernels.append(phase_dither(dev, gen, args.seed))
    kernels.append(phase_randomk(dev, args.seed))
    phase_small_model(dev)
    launches = phase_train(args, card)
    ps = phase_ps_train(args, card)
    # each kernel's count from the path that runs it: the PS dithering run
    # (this slice's main path) for B1 and B4, the PS randomk run for B5,
    # the collective onebit run for B2 and B3
    launches["flash_attn_fwd"] = ps["dithering"]["flash_attn_fwd"]
    launches["dithering_levels"] = ps["dithering"]["dithering_levels"]
    launches["randomk_indices"] = ps["randomk"]["randomk_indices"]
    for e in kernels:
        e["launches"] = launches[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

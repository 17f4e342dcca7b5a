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
   least time the card could take (bound); B4 and B5 over the PS path's
   whole round (one launch for its 125 partitions) and over a ragged
   round, and timed also as one launch per partition; the dequantization
   of a dithering round (aggregate and error-feedback residual) over the
   same rounds;
4. a small fp32 Llama on the card (kernels) against the same model on the
   CPU (plain twins): loss and every gradient;
5. the collective training path: ``init`` -> ``LlamaConfig.small()`` at
   full width with flash attention -> ``DistributedOptimizer(Adam, onebit
   + EF)`` -> ``make_train_step`` for ``--steps`` steps on seeded tokens;
6. the parameter-server path's device tier: a loopback server thread
   (``run_server``, one worker) -> ``init`` in PS mode -> the same model ->
   ``make_ps_train_step`` with Adam, under dithering + EF, then under
   randomk (k = 1%) + EF, 3 steps each; gradients are compressed on the
   card, summed by the C++ server, decompressed on the card, with one B4
   or B5 launch a step (and two of the dequantization under dithering);
7. the parameter-server path's host tier:
   ``make_ps_train_step(loss, Adam, model.params())`` dense for
   ``--steps`` steps (streamed export, the fused bucket of the norm
   leaves, the completion-ordered drain into the per-leaf Adam step),
   held bit for bit to as many plain local steps from the same weights;
   then the same step timed with the per-leaf apply on and off
   (``sharded_apply``, segments on, off, off, on of 4 steps); then the
   host-codec tier (onebit + EF, ``device_compress=False``) for 3 steps;
8. ``ps_dp2``: the same dense step with a ``dp`` group of two processes
   (``phase_ps_dp2``): a rank per card over NCCL where the machine has two
   cards or more, on one card both ranks on it over gloo; the
   locality-shard export on and off over NCCL, off alone over gloo, with
   a line that names what did not run and why;
9. ``collective_codecs``: the collective path of phase 5 under topk 1% +
   EF, randomk 1% + EF and dithering + EF (s = 127), 3 steps each: B5 and
   B4 (and the dequantization) launch on the collective path;
10. ``ps_topk``: the PS step under topk 1% + EF on the device tier and on
    the host tier, 3 steps each;
11. ``ps_failover``, the main path: the dense host-tier step
    against two ``python -m byteps_tpu_torch.server`` processes, fused and
    two-op, 4 steps each; server 1 exits inside step 2 by its chaos knob,
    its keys move to server 0 and the step's rounds replay there; the
    parameters end bit for bit where 4 plain local Adam steps leave them;
    then with server 0 killed too the next step raises within 30 s,
    naming the flight record's dump;
12. ``torch_adapter``, this slice's main path: the PyTorch adapter
    (``byteps_tpu_torch.torch``) with one worker and a loopback server,
    ``DistributedOptimizer(Adam)`` over the same model as an ``nn.Module``
    for ``--steps`` steps, then ``Compression.fp16``,
    ``DistributedDataParallel``, ``CrossBarrier`` and a sparse
    ``nn.Embedding(32000, 768)`` on the row-sparse wire, 3 steps each,
    each held bit for bit to plain local Adam steps (on fp16-rounded
    gradients for fp16, on the densified gradient for the embedding);
13. ``torch_adapter_2w``: two PS workers (two processes on the one card)
    and a server process; the broadcasts make worker 1 equal to worker 0,
    and 3 steps on their own batches leave both bit for bit where local
    Adam on the mean gradient does;
14. ``ps_rowsparse``: the dense host-tier step with
    ``rowsparse_params=("embed",)`` for ``--steps`` steps, bit for bit
    plain local Adam, the embedding's row-sparse bytes against its dense
    ones; then one device-tier dithering + EF step with it;
15. ``zoo``: the rest of the model zoo at full width and depth
    (``phase_zoo``): MLP, ResNet-50 and VGG-16 at 224x224, BERT-large at
    S=128 (BytePS's batch of 64 a GPU), MoE small (8 experts, B=8,
    S=512), with SGD(lr=0.01) on eight paths: the dense host tier for
    each model, the PyTorch adapter's ``DistributedOptimizer`` for
    ResNet-50, the device tier's dithering + EF for VGG-16 and the
    collective onebit + EF for BERT-large, 3 steps each; the dense and
    adapter paths bit for bit where plain local SGD leaves the
    parameters, the codec paths' kernels held to their twins at the
    path's shapes; throughput, parameter bytes, bytes pushed, keys and
    fused buckets and peak memory of each path;
16. ``ps_host_lossless``: the dense host tier's Llama small() step under
    the lossless codec (byte planes + zlib, ``device_compress=False``),
    3 steps, bit for bit where the dense host tier from the same weights
    ends, its bytes pushed against the dense 498,674,688 a step;
17. ``ps_host_varint``: host dithering + EF at s = 2 on the varint wire
    (the nonzero levels, their LEB128 index gaps), 3 steps, bit for bit
    where the dense int8 wire ends, both wires' bytes a step;
18. the native (C++) host codec: on one round of the card's own
    gradients, partition by partition, topk, randomk and dithering write
    the numpy tier's bytes, onebit its signs with the scale within an
    ulp; then the host onebit step with the native codec and with
    BYTEPS_NATIVE_CODEC=0, tokens/s of each;
19. ``ps_cross_barrier``: the dense host tier with BYTEPS_CROSS_BARRIER=1:
    at staleness 0 bit for bit the synchronous step; at staleness 1
    against a server capped at 2,000 MB/s it carries leaves, flushes
    idempotently and ends bit for bit where a local replay of its carry
    schedule ends; tokens/s at staleness 0 and 1 without the cap;
20. ``train_variants``: the plain local fwd + bwd + Adam step on one card
    under bench.py's four step variants (full remat, the
    ``dots_with_no_batch_dims_saveable`` remat policy, the chunked-vocab
    cross entropy in 8 chunks, ``fused_adam_step`` with one launch of the
    fused Adam kernel a leaf), their gates and tokens/s;
21. ``zero``: the ZeRO-1 step (optimizer state sharded over the group)
    with Adam, on one card and, where the machine has two, on two ranks
    over NCCL, bit for bit a replay of Adam on the mean gradient;
22. ``parallel``: two ranks (a card each over NCCL where the machine
    has two, else both on one card over gloo, whose all-to-alls and
    rotations go through host copies) train, 4 Adam steps each from one
    seeded weight set, Llama small() (B=4, S=2048) under ring attention
    over ``sp``, under Ulysses with B1 over ``sp``, pipelined over
    ``pp`` (M = 4), and MoE small() (B=8, S=512) with its experts over
    ``ep``; each rank's losses, step-0 gradients and parameter moves are
    held to a one-process replay on the card in bf16 and f32; tokens/s,
    peak memory, transport and the bytes each collective moved.

23. ``spmd``, the GSPMD tier (``parallel/spmd.py``): two ranks (placed as
    in phase 22) train, 4 Adam steps each through
    ``make_spmd_train_step`` from one seeded weight set, Llama small()
    (B=4, S=2048) Megatron-parallel over ``tp`` with B1 over each rank's
    3 query heads and 1 KV head, the same model FSDP over ``dp`` (2
    sequences a rank), and BERT-large (B=64, S=128, 15% masked)
    Megatron-parallel over ``tp``; each rank held to a one-process
    replay under phase 22's gates, its bytes at rest and its forward's
    bytes by collective to the reckonings from the shapes.

24. ``observability``, the measurement plane on the PS step: Llama
    small() (B=4, S=2048) against a server thread and a server process,
    dense (host tier) then under device dithering + EF, 4 steps each,
    with BYTEPS_HEALTH and BYTEPS_METRICS_PORT: the ``wire/*`` and
    ``compress/*`` counters against the registry's partitions and the
    codecs' wires, a StepReport a step within 5% of the synchronised
    wall, the fleet read over STATS_PULL with its folded bytes equal to
    the pushed bytes, the ledger's FlopCounterMode FLOPs within 2% of the
    analytic count (attention included), its peak from the table, the
    time series, ``grad_norm`` against the aggregate's norm, ``GET
    /metrics`` against the snapshot; a worker process whose
    BYTEPS_CHAOS_NAN_LEAF=wq@2 trips the NaN guard at step 2 and whose
    SIGTERM dumps the merged flight record (a server event drained over
    FLIGHT_DRAIN) and the time series; tokens/s with BYTEPS_METRICS=0
    against =1 (arms run 0, 1, 1, 0). ``--obs-only`` runs it alone.

Phase 3 also times B1 at the Ulysses path's shape ([4, 2048, 3, 128],
one KV head a query head) and at the tp path's ([4, 2048, 3, 128], one
KV head for the three) against its twin; ``--parallel-only`` runs the
first and phase 22 alone, ``--spmd-only`` the second and phase 23.

Phase 3 also holds the fused Adam kernel to its twin (p, m and v bit for
bit) and times it beside ``torch.optim.Adam(fused=True)``. Phases 3 and
5 also hold the two kernels that round as XLA on the CPU does
(``fma_scalar``: the EF LR rescale and the momentum; ``xla_sum``:
XLA's tree sum of the onebit scale and the L2 norm) to their twins:
``xla_sum`` in its three modes (plain, |x|, x * x) at lengths whose tree
pads levels 1 and 2 on the left, on x and on a view one float past it,
one launch a call, and across two replays of a captured graph;
``fma_scalar`` on views one float in and written into b or c. Phase 3
times them against ``torch.sum`` and ``torch.addcmul``, and the onebit
scale ``xla_mean(x, absolute=True)`` against the same mean over a
separate |x|. The collective path launches each exactly once a
compressed leaf a step (its optimizer takes an LR schedule).

Each PS run takes one more step with its spans on, to show where the time
goes. Before each path runs, the kernel launch counters are zeroed; they are
read just after. It prints a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
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
# timed steps of the PS runs off this slice's main path (the device tier's
# dithering and randomk runs, the host-codec run); the collective and the
# dense PS runs take --steps
SHORT_RUN_STEPS = 3


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
    names = ["onebit", "flash_attn_fwd", "counter_rng", "fused_adam"]
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


# xla_sum's lengths beside the path's: 33 and 32,769 pad level 1 on the
# left (32,769 level 2 too), 32,758 level 1 alone, 32,000 level 2 alone
XLA_SUM_LENGTHS = (EMBED_N, RAGGED_N, 1, 31, 32, 33, 32_769, 32_758, 32_000)
XLA_SUM_MODES = ({}, {"absolute": True}, {"square": True})


def _xla_sum_checks(dev, gen) -> None:
    """``xla_sum`` bit for bit with its twin in every mode, at every
    length, on x and on the view that starts one float past it; the
    onebit form ``xla_mean(x, absolute=True)``; one launch a call; and
    two replays of one captured graph."""
    import numpy as np
    import torch
    from byteps_tpu_torch.ops.compression import kernels as K

    for n in XLA_SUM_LENGTHS:
        base = torch.randn(n + 1, generator=gen, device=dev)
        for view, x in (("x", base[:n]), ("x[1:]", base[1:])):
            for kw in XLA_SUM_MODES:
                before = K.xla_sum.launches
                got = K.xla_sum(x, **kw)
                if K.xla_sum.launches != before + 1:
                    fail(f"xla_sum made {K.xla_sum.launches - before} "
                         f"launches for one call")
                want = K.xla_sum_plain(x, **kw)
                if not torch.equal(got, want):
                    fail(f"xla_sum {kw} of {view} differs from its twin at "
                         f"n={n}: {got.item()} vs {want.item()}")
            got = K.xla_mean(x, absolute=True)
            want = K.xla_sum_plain(x, absolute=True) * float(
                np.float32(1) / np.float32(n))
            if not torch.equal(got, want):
                fail(f"xla_mean(absolute) of {view} differs from its twin "
                     f"at n={n}: {got.item()} vs {want.item()}")
    print(f"xla_sum: bit-exact with its twin in {len(XLA_SUM_MODES)} modes "
          f"at n in {XLA_SUM_LENGTHS}, aligned and x[1:], one launch a "
          f"call", flush=True)
    x = torch.randn(EMBED_N, generator=gen, device=dev)
    want = [K.xla_sum(x, **kw) for kw in XLA_SUM_MODES]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [K.xla_sum(x, **kw) for kw in XLA_SUM_MODES]
    for replay in range(2):
        for o in outs:
            o.fill_(float("nan"))
        g.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(o, w) for o, w in zip(outs, want)):
            fail(f"xla_sum: graph replay {replay} differs from the eager "
                 f"sums")
    print("xla_sum: two graph replays give the eager bits", flush=True)


def _fma_checks(dev, gen) -> None:
    """``fma_scalar`` bit for bit with its twin's exact FMA: the EF LR
    rescale with a device scalar and the Nesterov momentum with mu, at the
    path's lengths; written into b, into c, and on views one float past
    16 bytes."""
    import torch
    from byteps_tpu_torch.ops.compression import kernels as K

    for n in (EMBED_N, RAGGED_N):
        x, e, m = (torch.randn(n + 1, generator=gen, device=dev)
                   for _ in range(3))
        scale = torch.tensor(0.05, device=dev) / torch.tensor(0.03,
                                                               device=dev)
        mu = torch.tensor(0.9, device=dev)
        for view, sl in (("x", slice(0, n)), ("x[1:]", slice(1, n + 1))):
            xs, es, ms = x[sl], e[sl], m[sl]
            for what, got, want in (
                    ("EF rescale", K.fma_scalar(scale, es, xs),
                     K.fma_f32_plain(scale, es, xs)),
                    ("momentum", K.fma_scalar(0.9, ms, xs),
                     K.fma_f32_plain(mu, ms, xs))):
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"fma_scalar ({what}, {view}) differs from its "
                         f"twin at n={n}: {int((got != want).sum())} "
                         f"elements")
            want = K.fma_f32_plain(scale, es, xs)
            for into in ("b", "c"):
                b, c = es.clone(), xs.clone()
                got = K.fma_scalar(scale, b, c, out=b if into == "b" else c)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"fma_scalar (out={into}, {view}) differs from "
                         f"its twin at n={n}")
    print(f"fma_scalar: bit-exact with its twin at n in "
          f"{(EMBED_N, RAGGED_N)}, aligned and x[1:], out new, = b and = c",
          flush=True)


def phase_xla_rounding(dev, gen) -> list:
    """The two kernels that round as XLA on the CPU does, at the collective
    path's largest compressed leaf (the embedding): ``fma_scalar`` (the
    EF LR rescale with a device scalar, the Nesterov momentum with mu)
    and ``xla_sum`` (XLA's tree sum: the onebit L1-mean scale, and the
    L2 norm's sum of squares), each bit for bit against its plain twin,
    whose FMA is exact; then each timed against its PyTorch call, and the
    onebit scale against the same mean over a separate |x|."""
    import torch
    from byteps_tpu_torch.ops.compression import kernels as K

    _fma_checks(dev, gen)
    _xla_sum_checks(dev, gen)
    n = EMBED_N
    x, e = (torch.randn(n, generator=gen, device=dev) for _ in range(2))
    out = torch.empty_like(x)
    scale = torch.tensor(0.6, device=dev)
    fma = dict(
        name="fma_scalar", route="cuda",
        source="byteps_tpu_torch/csrc/counter_rng.cu",
        replaces="byteps_tpu/ops/compression/feedback.py:71",
        max_abs_err=0.0,
        ms=cuda_graph_ms(lambda: K.fma_scalar(scale, e, x, out=out)),
        plain_ms=cuda_ms(lambda: K.fma_f32_plain(scale, e, x), 5),
        # read b and c, write out
        bound_ms=12 * n / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=cuda_graph_ms(lambda: torch.addcmul(x, e, scale,
                                                       out=out)))
    tree = dict(
        name="xla_sum", route="cuda",
        source="byteps_tpu_torch/csrc/counter_rng.cu",
        replaces="byteps_tpu/ops/compression/codecs.py:88",
        max_abs_err=0.0,
        ms=cuda_graph_ms(lambda: K.xla_sum(x)),
        plain_ms=cuda_ms(lambda: K.xla_sum_plain(x), 5),
        # read x once, write the 0-dim result
        bound_ms=(4 * n + 4) / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=cuda_graph_ms(lambda: torch.sum(x)))
    for k in (fma, tree):
        print(f"{k['name']} n={n}: {k['ms']:.4f} ms (plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms, "
              f"library {k['library_ms']:.4f} ms)", flush=True)
    onebit = {
        "xla_mean(x, absolute=True)": lambda: K.xla_mean(x, absolute=True),
        "xla_mean(x.abs())": lambda: K.xla_mean(x.abs()),
        "x.abs().mean()": lambda: x.abs().mean()}
    print(f"onebit scale n={n}: " + "; ".join(
        f"{what} {cuda_graph_ms(fn):.4f} ms" for what, fn in onebit.items()),
        flush=True)
    return [fma, tree]


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


# a ragged round: partitions of 1, 15, 16, 17 and 4,099 elements, each
# slot behind a gap of 3, so that no slot after the first starts on a
# 16-byte boundary (x offsets 3, 7, 25, 44, 64; out offsets 4, 9, 28, 48,
# 69)
RAGGED_ROUND = (1, 15, 16, 17, 4099)
RAGGED_GAP = 3


def path_round(kw: dict, dev, shapes=None):
    """The PS path's round for ``LlamaConfig.small()`` (or the parameter
    shapes ``shapes``): the ``DeviceCompressor``'s own ``_Round`` (and its
    tables) over the registry's partitions of every gradient leaf, built
    without a server, with the default partition size and compression
    threshold."""
    import types

    import torch
    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.core.registry import TensorRegistry
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.training.device_compression import \
        DeviceCompressor
    from byteps_tpu_torch.training.train import named_leaves

    def meta(node):
        if isinstance(node, dict):
            return {k: meta(v) for k, v in node.items()}
        return torch.empty(node, device="meta")

    cfg = Config(num_servers=1)
    state = types.SimpleNamespace(registry=TensorRegistry(cfg))
    dc = DeviceCompressor(None, 1, kw, cfg.min_compress_bytes)
    if shapes is None:
        shapes = llama.param_shapes(llama.LlamaConfig.small())
    plans = [dc.plan(state, "grad/" + name, t.numel(), dev) for name, t in
             named_leaves(meta(shapes))]
    return dc._spec(plans).round


def _ragged_layout(ns):
    """x and out offsets of a round with RAGGED_GAP unused elements
    before each slot (one more in out); the x and out lengths."""
    x_offs, out_offs, xe, oe = [], [], 0, 0
    for n in ns:
        xe, oe = xe + RAGGED_GAP, oe + RAGGED_GAP + 1
        x_offs.append(xe)
        out_offs.append(oe)
        xe, oe = xe + n, oe + n
    return x_offs, out_offs, xe, oe


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


def _dither_round_check(x, norms, table, base, partition, what, golden):
    """The B4 round kernel against its plain twin on the card (linear
    bit-exact; natural off by one at most, in at most n/100,000 levels of
    a partition, where log2 rounds at a power of two) and, where
    ``golden`` holds (seed, step), against the numpy host codec; returns
    the largest level difference."""
    import numpy as np
    import torch
    from byteps_tpu_torch.ops.compression import kernels as K
    from byteps_tpu_torch.ops.compression.host import HostDithering

    n_out = table.out_extent
    got = K.dithering_levels_round(
        x, norms, table, base, 127, partition,
        torch.zeros(n_out, dtype=torch.int8, device=x.device))
    want = K.dithering_levels_round_plain(
        x, norms, table, base, 127, partition,
        torch.zeros(n_out, dtype=torch.int8, device=x.device))
    torch.cuda.synchronize()
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs().cpu().numpy()
    got_np, x_np = got.cpu().numpy(), x.cpu().numpy() if golden else None
    n_diff = g_diff = 0
    for x_off, n, out_off, _ in table.rows.tolist():
        d = diff[out_off: out_off + n]
        nd = int((d > 0).sum())
        n_diff += nd
        if (partition == "linear" and nd) or nd > max(1, n // 100_000) \
                or (nd and d.max() > 1):
            fail(f"{what}: {nd} levels of a partition of {n} differ from "
                 f"the twin, by up to {int(d.max())}")
        if golden:
            seed, step = golden
            host = HostDithering(n=n, s=127, partition=partition, seed=seed)
            wire = np.frombuffer(host.compress(x_np[x_off: x_off + n],
                                               step), np.int8)
            gd = int((wire[:n] != got_np[out_off: out_off + n]).sum())
            g_diff += gd
            if gd > max(1, n // 100_000) or (partition == "linear" and gd):
                fail(f"{what}: {gd} levels of a partition of {n} differ "
                     f"from the numpy golden")
    gold = f", {g_diff} from the numpy golden" if golden else ""
    print(f"{what}: {n_diff} levels differ from the twin{gold}", flush=True)
    return int(diff.max(initial=0))


def phase_dither(dev, gen, seed: int) -> list:
    """B4 over the PS path's round (the 125 compressed partitions of
    ``LlamaConfig.small()``) and over a ragged round with unaligned slots:
    linear and natural, max and L2, against the plain twin on the card and
    (max norms) against the numpy golden of the host codec. Times the
    round launch (CUDA-graph replay and one eager call), the same round as
    one launch per partition (the form before rounds), the twin and the
    bound. Then the dequantization kernel of the same rounds
    (``_dequantize_check``)."""
    import torch
    from byteps_tpu_torch.ops.compression import kernels as K
    from byteps_tpu_torch.ops.compression import rng
    from byteps_tpu_torch.ops.compression.codecs import DitheringCodec

    rnd = path_round({"compressor": "dithering"}, dev)
    total, n_parts = rnd.total, len(rnd.members)
    print(f"dithering round of the PS path: {n_parts} partitions, {total} "
          f"elements", flush=True)
    step = 3
    base = rng.uniform_base(seed, step)
    x = _power_of_two_front(torch.randn(total, generator=gen, device=dev))
    views = [x[a: a + n] for a, n in rnd.spans]
    r_x, r_out, r_nx, _ = _ragged_layout(RAGGED_ROUND)
    rx = _power_of_two_front(torch.randn(r_nx, generator=gen, device=dev))
    r_table = K.dithering_table(r_x, RAGGED_ROUND, r_out)
    worst = 0
    for partition in ("linear", "natural"):
        for normalize in ("max", "l2"):
            codec = DitheringCodec(size=1, s=127, partition=partition,
                                   normalize=normalize, seed=seed)
            norms = torch.stack([codec.norm(v) for v in views])
            if normalize == "max" and partition == "linear":
                # the path's one reduction over the round: codec.norm's bits
                if not torch.equal(rnd.norms(views), norms):
                    fail("the round's max norms differ from codec.norm")
            golden = (seed, step) if normalize == "max" else None
            err = _dither_round_check(
                x, norms, rnd.table, base, partition,
                f"dithering_levels round {partition}/{normalize} "
                f"({n_parts} partitions, n={total})", golden)
            r_norms = torch.stack([codec.norm(rx[a: a + n])
                                   for a, n in zip(r_x, RAGGED_ROUND)])
            r_err = _dither_round_check(
                rx, r_norms, r_table, base, partition,
                f"dithering_levels ragged round {partition}/{normalize} "
                f"{RAGGED_ROUND}", golden)
            worst = max(worst, err, r_err)
    # the one-partition wrapper is a round of one: same levels
    norms = rnd.norms(views)
    levels = torch.empty(total, dtype=torch.int8, device=dev)
    K.dithering_levels_round(x, norms, rnd.table, base, 127, "linear",
                             levels)
    for m, (a, n) in enumerate(rnd.spans):
        if not torch.equal(K.dithering_levels(views[m], norms[m], base, 127,
                                              "linear"), levels[a: a + n]):
            fail("dithering_levels (one partition) differs from its round")

    call = lambda: K.dithering_levels_round(  # noqa: E731
        x, norms, rnd.table, base, 127, "linear", levels)
    parts = lambda: [K.dithering_levels(  # noqa: E731
        views[m], norms[m], base, 127, "linear") for m in range(n_parts)]
    plain = lambda: K.dithering_levels_round_plain(  # noqa: E731
        x, norms, rnd.table, base, 127, "linear", levels)
    ms, call_ms = cuda_graph_ms(call), cuda_ms(call, 50)
    parts_ms, parts_call_ms = cuda_graph_ms(parts, reps=2), cuda_ms(parts, 5)
    plain_ms = cuda_graph_ms(plain, reps=1, replays=3)
    plain_call_ms = cuda_ms(plain, 2)
    bound_ms = 5 * total / PEAK_BYTES_PER_S * 1e3
    print(f"dithering_levels round linear/max ({n_parts} partitions, "
          f"n={total}): {ms:.4f} ms on the device, {call_ms:.4f} ms a call "
          f"from Python; as {n_parts} one-partition launches {parts_ms:.4f} "
          f"ms on the device, {parts_call_ms:.4f} ms from Python; bound "
          f"{bound_ms:.4f} ms ({bound_ms / ms:.3f} of it); plain twin "
          f"{plain_ms:.4f} ms on the device, {plain_call_ms:.4f} ms a call",
          flush=True)
    b4 = dict(
        name="dithering_levels", route="cuda",
        source="byteps_tpu_torch/csrc/counter_rng.cu",
        replaces="byteps_tpu/ops/compression/pallas_kernels.py:157",
        max_abs_err=float(worst), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=None)
    return [b4, _dequantize_check(x, rx, r_x, r_table, rnd, base, seed)]


def _dequantize_check(x, rx, r_x, r_table, rnd, base, seed) -> dict:
    """The dequantization kernel of a dithering round (the aggregate,
    dec * norm, and the EF residual, one FMA) over the PS path's round
    and the ragged one, bit for bit against its plain twin (whose FMA is
    exact), linear and natural, on B4's levels; timed as the two
    launches of a PS dithering step (residual in the compress, product
    in the decompress)."""
    import torch
    from byteps_tpu_torch.ops.compression import kernels as K
    from byteps_tpu_torch.ops.compression.codecs import DitheringCodec

    views = [x[a: a + n] for a, n in rnd.spans]
    for partition in ("linear", "natural"):
        codec = DitheringCodec(size=1, s=127, partition=partition, seed=seed)
        for what, xx, tab, nrm in (
                ("path round", x, rnd.table,
                 torch.stack([codec.norm(v) for v in views])),
                ("ragged round", rx, r_table,
                 torch.stack([codec.norm(rx[a: a + n])
                              for a, n in zip(r_x, RAGGED_ROUND)]))):
            lv = K.dithering_levels_round(
                xx, nrm, tab, base, 127, partition,
                torch.zeros(tab.out_extent, dtype=torch.int8,
                            device=xx.device))
            for residual in (False, True):
                got = K.dithering_dequantize_round(
                    lv, nrm, tab, 127, partition,
                    xx.clone() if residual else torch.zeros_like(xx),
                    residual=residual)
                want = K.dithering_dequantize_round_plain(
                    lv, nrm, tab, 127, partition,
                    xx.clone() if residual else torch.zeros_like(xx),
                    residual=residual)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"dithering_dequantize {what} {partition} "
                         f"{'residual' if residual else 'aggregate'}: "
                         f"{int((got != want).sum())} elements differ from "
                         f"the twin")
            print(f"dithering_dequantize {what} {partition}: aggregate and "
                  f"residual bit-exact with the twin", flush=True)
    total = rnd.total
    norms = rnd.norms(views)
    levels = K.dithering_levels_round(
        x, norms, rnd.table, base, 127, "linear",
        torch.empty(total, dtype=torch.int8, device=x.device))
    err, agg = x.clone(), torch.empty_like(x)

    def both():
        K.dithering_dequantize_round(levels, norms, rnd.table, 127, "linear",
                                     err, residual=True)
        K.dithering_dequantize_round(levels, norms, rnd.table, 127, "linear",
                                     agg)

    def plain():
        K.dithering_dequantize_round_plain(levels, norms, rnd.table, 127,
                                           "linear", err, residual=True)
        K.dithering_dequantize_round_plain(levels, norms, rnd.table, 127,
                                           "linear", agg)

    ms, call_ms = cuda_graph_ms(both), cuda_ms(both, 20)
    plain_ms = cuda_ms(plain, 2)
    # residual: 1 byte of levels in, 4 bytes of x in and out; aggregate:
    # 1 byte in, 4 out
    bound_ms = 14 * total / PEAK_BYTES_PER_S * 1e3
    print(f"dithering_dequantize round linear, residual + aggregate "
          f"({len(rnd.members)} partitions, n={total}): {ms:.4f} ms on the "
          f"device, {call_ms:.4f} ms from Python; bound {bound_ms:.4f} ms "
          f"({bound_ms / ms:.3f} of it); plain twin {plain_ms:.4f} ms",
          flush=True)
    return dict(
        name="dithering_dequantize", route="cuda",
        source="byteps_tpu_torch/csrc/counter_rng.cu",
        replaces="byteps_tpu/ops/compression/codecs.py:278",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=None)


def phase_randomk(dev, seed: int) -> dict:
    """B5 over the PS path's round (k = 1% of each of the 125 partitions)
    and over a ragged round with unaligned slots, bit-exact against the
    twin and, partition by partition, the numpy golden; the one-partition
    wrapper at k = 2^20 over the embedding. Times as phase_dither."""
    import numpy as np
    import torch
    from byteps_tpu_torch.ops.compression import kernels as K
    from byteps_tpu_torch.ops.compression import rng

    rnd = path_round({"compressor": "randomk", "k": "0.01"}, dev)
    table = rnd.table
    k_total, n_parts = table.out_extent, len(table)
    step = 5
    base = rng.uniform_base(seed, step)
    _, r_out, _, r_nout = _ragged_layout(RAGGED_ROUND)
    r_table = K.randomk_table([n + 1000 for n in RAGGED_ROUND], RAGGED_ROUND,
                              r_out)
    for what, tab in ((f"path round ({n_parts} partitions, k={k_total})",
                       table), (f"ragged round k={RAGGED_ROUND}", r_table)):
        got = K.randomk_indices_round(tab, base, torch.full(
            (tab.out_extent,), -1, dtype=torch.int32, device=dev))
        want = K.randomk_indices_round_plain(tab, base, torch.full(
            (tab.out_extent,), -1, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"randomk_indices {what} differs from its plain twin")
        got_np = got.cpu().numpy()
        for size, k, out_off, _ in tab.rows.tolist():
            if not np.array_equal(got_np[out_off: out_off + k],
                                  rng.np_index_parallel(seed, k, size,
                                                        step)):
                fail(f"randomk_indices {what}: a partition of size {size} "
                     f"differs from the numpy golden")
        print(f"randomk_indices {what}: bit-exact with the twin and the "
              f"numpy golden", flush=True)
    big = K.randomk_indices(base, EMBED_N, RANDOMK_BIG_K, dev)
    if not np.array_equal(big.cpu().numpy(), rng.np_index_parallel(
            seed, RANDOMK_BIG_K, EMBED_N, step)):
        fail(f"randomk_indices k={RANDOMK_BIG_K} differs from the golden")

    idx = torch.empty(k_total, dtype=torch.int32, device=dev)
    rows = table.rows.tolist()
    call = lambda: K.randomk_indices_round(table, base, idx)  # noqa: E731
    parts = lambda: [K.randomk_indices(  # noqa: E731
        base, size, k, dev) for size, k, _, _ in rows]
    plain = lambda: K.randomk_indices_round_plain(  # noqa: E731
        table, base, idx)
    ms, call_ms = cuda_graph_ms(call), cuda_ms(call, 50)
    parts_ms, parts_call_ms = cuda_graph_ms(parts, reps=2), cuda_ms(parts, 5)
    plain_ms = cuda_graph_ms(plain, reps=1, replays=3)
    plain_call_ms = cuda_ms(plain, 2)
    bound_ms = 4 * k_total / PEAK_BYTES_PER_S * 1e3
    print(f"randomk_indices round ({n_parts} partitions, k={k_total}): "
          f"{ms:.4f} ms on the device, {call_ms:.4f} ms a call from "
          f"Python; as {n_parts} one-partition launches {parts_ms:.4f} ms on "
          f"the device, {parts_call_ms:.4f} ms from Python; bound "
          f"{bound_ms:.6f} ms ({bound_ms / ms:.3f} of it); plain twin "
          f"{plain_ms:.4f} ms on the device, {plain_call_ms:.4f} ms a call",
          flush=True)
    return dict(
        name="randomk_indices", route="cuda",
        source="byteps_tpu_torch/csrc/counter_rng.cu",
        replaces="byteps_tpu/ops/compression/pallas_kernels.py:223",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
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
                "onebit_unpack": K.onebit_unpack,
                "fma_scalar": K.fma_scalar,
                "xla_sum": K.xla_sum}
    bps.init()
    try:
        dev = bps.get_state().device
        cfg = llama.LlamaConfig.small()
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        model = llama.Llama(cfg, device=dev, generator=gen)
        opt = DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-3,
                             betas=(0.9, 0.999), eps=1e-8),
            compression={"compressor": "onebit", "ef": "vanilla"},
            # the EF residual's LR rescale (one FMA per compressed leaf)
            lr_schedule=lambda step: 1e-3)
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
    # one onebit scale (one sum) and one EF LR rescale a compressed leaf
    for name in ("xla_sum", "fma_scalar"):
        if launches[name] != n_comp * args.steps:
            fail(f"{name}: {launches[name]} launches in {args.steps} steps, "
                 f"not one for each of the {n_comp} compressed leaves a "
                 f"step")
    steady = times[1:] if len(times) > 1 else times
    tok_s = B * S / (sum(steady) / len(steady))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"train: {tok_s:.1f} tokens/s over steps 1..{len(times) - 1} "
          f"(step 0 has the warm-up) on {card}; peak memory {peak_gb:.2f} "
          f"GB; launches in {args.steps} steps {launches}", flush=True)
    return launches


@contextlib.contextmanager
def restored_env():
    """``os.environ`` as it was before the block: one phase's settings
    (the failover's server list and wire knobs) never reach the next."""
    saved = dict(os.environ)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


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


@contextlib.contextmanager
def loopback_ps(dev, label: str):
    """A loopback PS server thread (one worker) and ``init`` in PS mode
    on ``dev``; the server must exit after ``shutdown``."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.server import run_server

    port = _free_port()
    os.environ.update({
        "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
        "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_ROLE": "worker"})
    server = threading.Thread(
        target=run_server, args=(port, Config(num_workers=1, num_servers=1)),
        name="ps-server", daemon=True)
    server.start()
    bps.init(device=dev)
    try:
        yield bps.get_state()
    finally:
        bounded(bps.shutdown, f"PS shutdown ({label})")
    server.join(PS_TIMEOUT_S)
    if server.is_alive():
        fail(f"the PS server ({label}) did not exit after shutdown")


def run_steps(step, batch, n: int, label: str, on_card: bool,
              counters: dict) -> dict:
    """``n`` timed steps (launch counters zeroed first, read after), then
    one more with the spans on. Returns losses, times (s), launches, the
    bytes pushed, the spans and, for the host tier, each step's
    counters."""
    import torch
    from byteps_tpu_torch.core.state import get_state

    sched = get_state().scheduler
    for fn in counters.values():
        fn.launches = 0
    pushed0 = sched.bytes_pushed
    losses, times, per_step = [], [], []
    for i in range(n):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_v = bounded(lambda: float(step(batch)), f"PS step {i} ({label})")
        times.append(time.perf_counter() - t0)
        losses.append(loss_v)
        extra = getattr(step, "counters", None)
        if extra is not None:
            per_step.append(dict(extra))
        print(f"ps {label} step {i}: loss {loss_v:.6f} "
              f"({times[-1] * 1e3:.1f} ms)"
              + (f" {extra}" if extra is not None else ""), flush=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    pushed = sched.bytes_pushed - pushed0
    step.spans.enabled = True
    losses.append(bounded(lambda: float(step(batch)),
                          f"PS timed step ({label})"))
    step.spans.enabled = False
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite PS loss ({label}): {losses}")
    return dict(losses=losses, times=times, launches=launches,
                pushed=pushed, spans=dict(step.spans.ms), per_step=per_step)


def report(label: str, card: str, run: dict, B: int, S: int, dev,
           on_card: bool, note: str = "") -> None:
    import torch
    n = len(run["times"])
    steady = run["times"][1:]
    tok_s = B * S / (sum(steady) / len(steady))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if on_card else float("nan")
    per_step = {k: v / n for k, v in run["launches"].items()}
    print(f"ps {label}: {tok_s:.1f} tokens/s over steps 1..{n - 1} (step 0 "
          f"has the warm-up and the key installs) on {card}; steps "
          f"{['%.1f' % (t * 1e3) for t in steady]} ms; peak memory "
          f"{peak_gb:.2f} GB; {run['pushed'] / n:.0f} bytes pushed per "
          f"step{note}; launches per step {per_step}", flush=True)
    spans = run["spans"]
    total = sum(spans.values())
    print(f"ps {label} where the time goes (one more step, host clock, "
          f"device synced at each border; {total:.1f} ms in all"
          + ("; the host tier's spans overlap" if run["per_step"] else "")
          + "): " + ", ".join(f"{k} {v:.1f} ms ({v / total:.3f})"
                              for k, v in spans.items()), flush=True)


def _counters():
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.ops.compression import kernels as K
    return {"flash_attn_fwd": FA.flash_attention_fwd,
            "onebit_pack": K.onebit_pack,
            "onebit_unpack": K.onebit_unpack,
            "dithering_levels": K.dithering_levels,
            "dithering_dequantize": K.dithering_dequantize,
            "randomk_indices": K.randomk_indices}


def phase_ps_train(args, card: str, dev=None, cfg=None, B: int = 4,
                   S: int = 2048) -> dict:
    """The PS path on its device tier: a loopback server, ``init`` in PS
    mode, Llama small() at full width, ``make_ps_train_step`` under
    dithering + EF and then randomk + EF. Returns each run's launch
    counts. ``dev``/``cfg``/``B``/``S`` exist to rehearse the phase on the
    CPU at a tiny size."""
    import torch
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.training import make_ps_train_step

    # the native client waits this long for a round (the default is 600 s)
    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(PS_TIMEOUT_S))
    counters = _counters()
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
    runs = (("dithering", {"compressor": "dithering", "ef": "vanilla"}),
            ("randomk", {"compressor": "randomk", "k": "0.01",
                         "ef": "vanilla"}))
    out = {}
    for label, kw in runs:
        with loopback_ps(dev, label):
            opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                                   betas=(0.9, 0.999), eps=1e-8)
            step = make_ps_train_step(
                lambda b: llama.loss_fn(model.params(), b, cfg, attn), opt,
                model.params(), compression=kw)
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            run = run_steps(step, {"tokens": tokens}, SHORT_RUN_STEPS,
                            label, on_card, counters)
            plans = step.device_compressor()._plans.values()
            n_parts = sum(len(p.codecs) for p in plans)
            n_comp = sum(c is not None for p in plans for c in p.codecs)
            step.close()
        report(label, card, run, B, S, dev, on_card,
               f"; {n_comp} of {n_parts} partitions compressed")
        out[label] = run["launches"]
    # one B4 or B5 launch per PS round, that is per step, and two of the
    # dequantization (the residual, the aggregate) under dithering
    for label, name, per in (("dithering", "dithering_levels", 1),
                             ("dithering", "dithering_dequantize", 2),
                             ("randomk", "randomk_indices", 1)):
        if out[label][name] != per * SHORT_RUN_STEPS:
            fail(f"{name}: {out[label][name]} launches in {SHORT_RUN_STEPS} "
                 f"PS {label} steps, not {per} a step: {out}")
    return out


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def phase_ps_host(args, card: str, dev=None, cfg=None, B: int = 4,
                  S: int = 2048) -> None:
    """The PS path on its host tier, slice 5's main path: Llama small()
    at full width, ``make_ps_train_step(loss, Adam, model.params())``
    with ``compression=None`` (BytePS's dense default: streamed export,
    the fused bucket of the norm leaves, a fused PUSHPULL per partition,
    the completion-ordered drain into the per-leaf Adam step), which must
    push every parameter's bytes each step, launch B1 24 times a step
    and leave the parameters bit for bit where as many plain
    ``loss.backward(); optimizer.step()`` steps from the same weights
    leave them (one worker: the aggregate is the pushed gradient; Adam's
    foreach on both sides); then the host-codec tier, onebit + EF with
    ``device_compress=False``."""
    import torch
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.training import make_ps_train_step

    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(PS_TIMEOUT_S))
    counters = _counters()
    dev = torch.device(dev or "cuda:0")
    on_card = dev.type == "cuda"
    cfg = cfg or llama.LlamaConfig.small()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    model = llama.Llama(cfg, device=dev, generator=gen)
    init = _tree_clone(model.params())
    attn = FA.make_flash_attn()
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device=dev)}
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999),
                                eps=1e-8, foreach=True)

    with loopback_ps(dev, "dense") as state:
        step = make_ps_train_step(
            lambda b: llama.loss_fn(model.params(), b, cfg, attn),
            adam(model.parameters()), model.params())
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        dense = run_steps(step, batch, args.steps, "dense", on_card,
                          counters)
        if args.profile:
            dense["losses"].append(bounded(lambda: profile_step(
                step, batch, args.profile, "ps_dense"), "profiled step"))
        report("dense", card, dense, B, S, dev, on_card,
               f" (every parameter: {n_bytes} bytes)")
        print(f"ps dense arena: {state.arena.stats()}", flush=True)
        n = args.steps
        if dense["pushed"] != n * n_bytes:
            fail(f"dense PS pushed {dense['pushed']} bytes in {n} steps, "
                 f"not {n_bytes} a step")
        if on_card and dense["launches"]["flash_attn_fwd"] != 24 * n:
            fail(f"flash_attn_fwd: {dense['launches']['flash_attn_fwd']} "
                 f"launches in {n} dense PS steps, not 24 a step")
        # the same weights, the same number of plain steps
        ref = llama.Llama(cfg, device=dev, params=init)
        opt = adam(ref.parameters())
        losses = []
        for _ in range(len(dense["losses"])):
            opt.zero_grad(set_to_none=True)
            loss = llama.loss_fn(ref.params(), batch, cfg, attn)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        differ = {name: int((a != b).sum()) for (name, a), b in
                  zip(model.named_parameters(), ref.parameters())
                  if not torch.equal(a, b)}
        if differ or losses != dense["losses"]:
            fail(f"dense PS steps differ from plain local steps: losses "
                 f"{dense['losses']} vs {losses}; elements differing per "
                 f"leaf {differ}")
        print(f"ps dense: parameters after {len(losses)} dense PS steps "
              f"bit-identical to {len(losses)} plain local Adam steps "
              f"(foreach on both sides); losses {losses}", flush=True)
        del ref, opt
        apply_ab(step, batch, on_card, card)
        step.close()

    kw = {"compressor": "onebit", "ef": "vanilla"}
    with loopback_ps(dev, "host-codec"):
        step = make_ps_train_step(
            lambda b: llama.loss_fn(model.params(), b, cfg, attn),
            adam(model.parameters()), model.params(), compression=kw,
            device_compress=False)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        host = run_steps(step, batch, SHORT_RUN_STEPS, "host-codec onebit",
                         on_card, counters)
        step.close()
    report("host-codec onebit", card, host, B, S, dev, on_card,
           " (numpy onebit + EF on the host)")


# ---------------------------------------------------------------------- #
# the collective codecs, topk on the PS tiers, the server failover
# ---------------------------------------------------------------------- #

def _collective_counters():
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.ops.compression import kernels as K
    return {"flash_attn_fwd": FA.flash_attention_fwd,
            "dithering_levels": K.dithering_levels,
            "dithering_dequantize": K.dithering_dequantize,
            "randomk_indices": K.randomk_indices,
            "fma_scalar": K.fma_scalar,
            "xla_sum": K.xla_sum}


COLLECTIVE_RUNS = (
    ("topk", {"compressor": "topk", "k": "0.01", "ef": "vanilla"}),
    ("randomk", {"compressor": "randomk", "k": "0.01", "ef": "vanilla"}),
    ("dithering", {"compressor": "dithering", "ef": "vanilla", "s": "127",
                   "partition_type": "linear", "normalize_type": "max"}),
)


def phase_collective_codecs(args, card: str, dev=None, cfg=None, B: int = 4,
                            S: int = 2048) -> dict:
    """``collective_codecs``: ``make_train_step`` of Llama small() at
    full width through ``DistributedOptimizer(Adam)`` under topk 1% + EF,
    randomk 1% + EF and dithering + EF (s = 127, linear, max), each for
    SHORT_RUN_STEPS steps: the collective compressed push_pull
    (``compressed_psum_tree``) of the three codecs. Each compressed leaf
    launches B5 (randomk) or B4 and two dequantizations (dithering: the
    residual, the gathered payload) once a step, and every step 24 B1.
    Returns each run's launches. ``dev``/``cfg``/``B``/``S`` rehearse it
    on the CPU."""
    import torch
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.training import (DistributedOptimizer,
                                           make_train_step)

    counters = _collective_counters()
    os.environ["DMLC_NUM_SERVER"] = "0"     # no PS: the collective path
    bps.init(device=dev)
    out = {}
    try:
        dev = bps.get_state().device
        on_card = dev.type == "cuda"
        cfg = cfg or llama.LlamaConfig.small()
        gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
        init = llama.Llama(cfg, device=dev, generator=gen).params()
        attn = FA.make_flash_attn()
        tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                               device=dev)
        for label, kw in COLLECTIVE_RUNS:
            # each codec from the same weights
            model = llama.Llama(cfg, device=dev, params=_tree_clone(init))
            opt = DistributedOptimizer(
                torch.optim.Adam(model.parameters(), lr=1e-3,
                                 betas=(0.9, 0.999), eps=1e-8),
                compression=kw, lr_schedule=lambda step: 1e-3)
            n_comp = sum(st is not None for st in opt.compression.stacks)
            step = make_train_step(
                lambda b: llama.loss_fn(model.params(), b, cfg, attn), opt)
            for fn in counters.values():
                fn.launches = 0
            losses, times = [], []
            for i in range(SHORT_RUN_STEPS):
                if on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step({"tokens": tokens})))
                times.append(time.perf_counter() - t0)
                print(f"collective {label} step {i}: loss {losses[-1]:.6f} "
                      f"({times[-1] * 1e3:.1f} ms)", flush=True)
            launches = {k: fn.launches for k, fn in counters.items()}
            if not all(math.isfinite(x) for x in losses):
                fail(f"non-finite collective {label} loss: {losses}")
            steady = times[1:]
            print(f"collective {label}: {B * S / (sum(steady) / len(steady)):.1f} "
                  f"tokens/s over steps 1..{len(times) - 1} on {card}; "
                  f"{n_comp} of {len(opt.params)} leaves compressed; "
                  f"launches in {SHORT_RUN_STEPS} steps {launches}",
                  flush=True)
            # the kernels launch on the card (the CPU takes the twins)
            per = {"randomk": {"randomk_indices": n_comp},
                   "dithering": {"dithering_levels": n_comp,
                                 "dithering_dequantize": 2 * n_comp},
                   "topk": {}}[label] if on_card else {}
            if on_card:
                per["flash_attn_fwd"] = 24
            for name, n in per.items():
                if launches[name] != n * SHORT_RUN_STEPS:
                    fail(f"{name}: {launches[name]} launches in "
                         f"{SHORT_RUN_STEPS} collective {label} steps, not "
                         f"{n} a step")
            out[label] = launches
            del opt, step, model
    finally:
        bps.shutdown()
    return out


def phase_ps_topk(args, card: str, dev=None, cfg=None, B: int = 4,
                  S: int = 2048) -> dict:
    """``ps_topk``: ``make_ps_train_step`` of Llama small() at full width
    under topk 1% + EF, on the device tier (selection on the card,
    partition by partition, the wire's indices ascending) and on the host
    tier (numpy ``HostTopk`` in the scheduler's COMPRESS stage), each
    SHORT_RUN_STEPS steps through a loopback server whose topk
    re-compresses the sum. Returns each tier's launches."""
    import torch
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.training import make_ps_train_step

    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(PS_TIMEOUT_S))
    counters = _counters()
    dev = torch.device(dev or "cuda:0")
    on_card = dev.type == "cuda"
    cfg = cfg or llama.LlamaConfig.small()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    model = llama.Llama(cfg, device=dev, generator=gen)
    attn = FA.make_flash_attn()
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device=dev)}
    kw = {"compressor": "topk", "k": "0.01", "ef": "vanilla"}
    out = {}
    for label, device_compress in (("topk device tier", True),
                                   ("topk host tier", False)):
        with loopback_ps(dev, label):
            opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                                   betas=(0.9, 0.999), eps=1e-8)
            step = make_ps_train_step(
                lambda b: llama.loss_fn(model.params(), b, cfg, attn), opt,
                model.params(), compression=kw,
                device_compress=device_compress)
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            run = run_steps(step, batch, SHORT_RUN_STEPS, label, on_card,
                            counters)
            step.close()
        report(label, card, run, B, S, dev, on_card)
        if on_card and run["launches"]["flash_attn_fwd"] != \
                24 * SHORT_RUN_STEPS:
            fail(f"flash_attn_fwd: {run['launches']['flash_attn_fwd']} "
                 f"launches in {SHORT_RUN_STEPS} PS {label} steps")
        out[label] = run["launches"]
    return out


def _spawn_ps_server(port: int, extra_env=None):
    """``python -m byteps_tpu_torch.server`` on ``port``, one worker."""
    env = {**os.environ,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "DMLC_ROLE": "server", "DMLC_NUM_WORKER": "1",
           "DMLC_PS_ROOT_PORT": str(port), "BYTEPS_SERVER_ID": "0",
           **(extra_env or {})}
    return subprocess.Popen([sys.executable, "-m", "byteps_tpu_torch.server"],
                            env=env, cwd=ROOT)


def _wait_port(port: int, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while True:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            if time.monotonic() > deadline:
                fail(f"the PS server on port {port} never came up")
            time.sleep(0.05)


FAILOVER_STEPS = 4


def _fleet_env(ports, fused: bool, flight_dir: str) -> None:
    os.environ.update({
        "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": str(len(ports)),
        "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(ports[0]),
        "DMLC_ROLE": "worker",
        "BYTEPS_SERVER_HOSTS": ",".join(f"127.0.0.1:{p}" for p in ports),
        "BYTEPS_WIRE_BACKOFF_MS": "25",
        "BYTEPS_FUSED_PUSHPULL": "1" if fused else "0",
        "BYTEPS_FLIGHT_DIR": flight_dir})


def _server1_keys(make_step, batch, dev) -> int:
    """The partitions that server 1 of two holds: one dense step through
    two loopback server threads, and the registry's assignment after it
    (the same declarations as the failover run's)."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.server import run_server

    ports = [_free_port(), _free_port()]
    _fleet_env(ports, True, tempfile.gettempdir())
    threads = [threading.Thread(target=run_server, args=(
        p, Config(num_workers=1, num_servers=2)), daemon=True)
        for p in ports]
    for t in threads:
        t.start()
    bps.init(device=dev)
    try:
        step = make_step()
        bounded(lambda: float(step(batch)), "the failover probe step")
        step.close()
        parts = [p for ctx in bps.get_state().registry.contexts_in_order()
                 for p in ctx.partitions]
    finally:
        bounded(bps.shutdown, "PS shutdown (failover probe)")
    for t in threads:
        t.join(PS_TIMEOUT_S)
    k1 = sum(p.server == 1 for p in parts)
    if not 0 < k1 < len(parts):
        fail(f"the registry puts {k1} of {len(parts)} partitions on server "
             f"1 of 2: no failover to test")
    return k1


def phase_ps_failover(args, card: str, dev=None, cfg=None, B: int = 4,
                      S: int = 2048) -> dict:
    """``ps_failover``, the main path: the dense host-tier step of
    Llama small() at full width against two ``python -m
    byteps_tpu_torch.server`` processes for FAILOVER_STEPS steps, fused
    and then with BYTEPS_FUSED_PUSHPULL=0 (the two-op path). Server 1
    runs with BYTEPS_CHAOS_KILL_AFTER_ROUNDS = K + ceil(K/2), K its
    partitions a step by the registry's assignment (``_server1_keys``),
    so it exits (``_exit(137)``, no teardown) inside the second step; the
    scheduler retries, migrates its keys to server 0 and replays the
    round there (BYTEPS_WIRE_BACKOFF_MS=25). The parameters must end bit
    for bit where FAILOVER_STEPS plain local Adam steps leave them, with
    at least one failover, in the second step. Then server 0 is killed
    and the next step must raise within 30 s, its error naming the
    flight record's dump. Returns the fused run's launches."""
    import torch
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.training import make_ps_train_step

    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(PS_TIMEOUT_S))
    counters = _counters()
    dev = torch.device(dev or "cuda:0")
    on_card = dev.type == "cuda"
    cfg = cfg or llama.LlamaConfig.small()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    init = _tree_clone(llama.Llama(cfg, device=dev, generator=gen).params())
    attn = FA.make_flash_attn()
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device=dev)}

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999),
                                eps=1e-8, foreach=True)

    # FAILOVER_STEPS plain local steps from the same weights
    ref = llama.Llama(cfg, device=dev, params=_tree_clone(init))
    opt = adam(ref.parameters())
    ref_losses = []
    for _ in range(FAILOVER_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = llama.loss_fn(ref.params(), batch, cfg, attn)
        loss.backward()
        opt.step()
        ref_losses.append(float(loss.detach()))
    ref_params = [p.detach().clone() for p in ref.parameters()]
    del ref, opt

    holder = {}

    def make_step():
        model = holder["model"] = llama.Llama(cfg, device=dev,
                                              params=_tree_clone(init))
        return make_ps_train_step(
            lambda b: llama.loss_fn(model.params(), b, cfg, attn),
            adam(model.parameters()), model.params())

    k1 = _server1_keys(make_step, batch, dev)
    kill_after = k1 + (k1 + 1) // 2
    print(f"ps_failover: server 1 holds {k1} partitions a step; it exits "
          f"after {kill_after} rounds, inside step 2 of {FAILOVER_STEPS}",
          flush=True)
    flight_dir = tempfile.mkdtemp(prefix="bps-flight-")
    out = {}
    for fused in (True, False):
        label = "fused" if fused else "two-op"
        ports = [_free_port(), _free_port()]
        while ports[1] == ports[0]:
            ports[1] = _free_port()
        _fleet_env(ports, fused, flight_dir)
        procs = [_spawn_ps_server(ports[0]), _spawn_ps_server(
            ports[1], {"BYTEPS_CHAOS_KILL_AFTER_ROUNDS": str(kill_after)})]
        try:
            for p in ports:
                _wait_port(p)
            bps.init(device=dev)
            state = bps.get_state()
            try:
                if state.scheduler.fused != fused:
                    fail(f"ps_failover {label}: the scheduler's wire is "
                         f"{'fused' if state.scheduler.fused else 'two-op'}")
                step = make_step()
                model = holder["model"]
                for fn in counters.values():
                    fn.launches = 0
                losses, times, per_step = [], [], []
                for i in range(FAILOVER_STEPS):
                    if on_card:
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses.append(bounded(lambda: float(step(batch)),
                                          f"failover step {i} ({label})"))
                    times.append(time.perf_counter() - t0)
                    per_step.append({k: step.counters[k] for k in (
                        "retries", "server_failovers", "key_migrations")})
                    print(f"ps_failover {label} step {i + 1}: loss "
                          f"{losses[-1]:.6f} ({times[-1] * 1e3:.1f} ms) "
                          f"{per_step[-1]}", flush=True)
                launches = {k: fn.launches for k, fn in counters.items()}
                c = state.scheduler.counters()
                if procs[1].wait(timeout=30) != 137:
                    fail(f"ps_failover {label}: server 1 did not exit by "
                         f"its chaos kill (rc {procs[1].returncode})")
                fo = [s["server_failovers"] for s in per_step]
                if fo != [0, 1] + [0] * (FAILOVER_STEPS - 2):
                    fail(f"ps_failover {label}: failovers per step {fo}, "
                         f"not one in step 2")
                if c["key_migrations"] != k1:
                    fail(f"ps_failover {label}: {c['key_migrations']} keys "
                         f"migrated, server 1 held {k1}")
                differ = {n: int((a != b).sum()) for (n, a), b in zip(
                    model.named_parameters(), ref_params)
                    if not torch.equal(a, b)}
                if differ or losses != ref_losses:
                    fail(f"ps_failover {label}: parameters or losses differ "
                         f"from {FAILOVER_STEPS} plain local Adam steps: "
                         f"losses {losses} vs {ref_losses}; elements "
                         f"differing per leaf {differ}")
                if on_card and launches["flash_attn_fwd"] != \
                        24 * FAILOVER_STEPS:
                    fail(f"flash_attn_fwd: {launches['flash_attn_fwd']} "
                         f"launches in {FAILOVER_STEPS} failover steps")
                others = [t for i, t in enumerate(times) if i not in (0, 1)]
                print(f"ps_failover {label}: parameters after "
                      f"{FAILOVER_STEPS} steps bit-identical to "
                      f"{FAILOVER_STEPS} plain local Adam steps; retries "
                      f"{c['retries']}, server failovers "
                      f"{c['server_failovers']}, migrated keys "
                      f"{c['key_migrations']}; the failover step (2) "
                      f"{times[1] * 1e3:.1f} ms, steps 3..{FAILOVER_STEPS} "
                      f"{['%.1f' % (t * 1e3) for t in others]} ms, "
                      f"{B * S / (sum(others) / len(others)):.1f} tokens/s "
                      f"over them on {card}; launches in {FAILOVER_STEPS} "
                      f"steps {launches}", flush=True)
                # the fleet dies: the next round fails within the budget
                procs[0].kill()
                procs[0].wait(timeout=30)
                t0 = time.perf_counter()
                try:
                    bounded(lambda: float(step(batch)),
                            f"the dead fleet's step ({label})")
                except RuntimeError as e:
                    err = str(e)
                else:
                    fail(f"ps_failover {label}: a step with every server "
                         f"dead did not raise")
                dt = time.perf_counter() - t0
                if dt >= 30 or "flight record dumped to" not in err:
                    fail(f"ps_failover {label}: the dead fleet's step took "
                         f"{dt:.1f} s or named no flight dump: {err}")
                path = err.rsplit("flight record dumped to ", 1)[1].strip()
                with open(path) as f:
                    kinds = {e["kind"] for e in
                             json.load(f)["worker"]["events"]}
                if not {"wire_retry", "server_failover", "key_migration",
                        "round_failed"} <= kinds:
                    fail(f"ps_failover {label}: the flight dump {path} "
                         f"holds {sorted(kinds)}")
                print(f"ps_failover {label}: with every server dead the "
                      f"next step raised after {dt * 1e3:.1f} ms, naming "
                      f"{path}", flush=True)
                step.close()
                out[label] = launches
            finally:
                bounded(bps.shutdown, f"PS shutdown (failover {label})")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=30)
    return out


# ---------------------------------------------------------------------- #
# ps_dp2: the dense host-tier step with a dp group of two processes
# ---------------------------------------------------------------------- #

DP2_STEPS = 3


def _dp2_cfg(name: str):
    import dataclasses

    import torch
    from byteps_tpu_torch.models import llama
    if name == "small":
        return llama.LlamaConfig.small()
    # the CPU rehearsal's size
    return dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=64, seq=64),
                               dtype=torch.float32)


def _dp2_tokens(cfg, rank: int, seed: int, B: int, S: int, dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed + 10 + rank)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                    generator=gen, device=dev)}


def _dp2_rank(rank: int, world: int, dev: str, backend: str, port: int,
              coord: int, shard_runs: tuple, seed: int, cfg_name: str,
              B: int, S: int, q) -> None:
    """One rank of ``phase_ps_dp2`` (a spawned process): ``init`` the group
    once from BYTEPS_LOCAL_RANK / BYTEPS_LOCAL_SIZE / BYTEPS_COORD_PORT
    against the server on ``port``; for each run (shard export off or on)
    start from the root's weights and take DP2_STEPS dense PS steps of
    its own batch; then compare the ranks' parameters, the runs'
    parameters, and (the root) plain local Adam steps on the ranks' mean
    gradient. Puts (rank, result) on ``q``."""
    import faulthandler
    # a rank that hangs prints every thread's stack and exits
    faulthandler.dump_traceback_later(PS_TIMEOUT_S * len(shard_runs),
                                      exit=True)
    try:
        q.put((rank, _dp2_rank_body(rank, world, dev, backend, port, coord,
                                    shard_runs, seed, cfg_name, B, S)))
    except BaseException:  # noqa: BLE001 - reported by the parent
        import traceback
        q.put((rank, {"error": traceback.format_exc()}))


def _dp2_rank_body(rank, world, dev, backend, port, coord, shard_runs,
                   seed, cfg_name, B, S):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.training import (broadcast_parameters,
                                           make_ps_train_step)

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(PS_TIMEOUT_S))
    cfg = _dp2_cfg(cfg_name)
    model = llama.Llama(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed + 3))
    init = _tree_clone(model.params())
    attn = FA.make_flash_attn()
    batch = _dp2_tokens(cfg, rank, seed, B, S, dev)

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999),
                                eps=1e-8, foreach=True)

    out, finals = {"runs": {}}, {}
    os.environ.update({
        "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
        "DMLC_WORKER_ID": "0", "DMLC_ROLE": "worker",
        "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
        "BYTEPS_LOCAL_RANK": str(rank), "BYTEPS_LOCAL_SIZE": str(world),
        "BYTEPS_COORD_PORT": str(coord)})
    bps.init(device=dev, backend=backend)
    try:
        group = bps.get_state().group
        for shard in shard_runs:
            with torch.no_grad():
                for p, v in zip(model.parameters(),
                                llama.Llama(cfg, device=dev,
                                            params=init).parameters()):
                    p.copy_(v)
            # every rank starts from the root's weights
            broadcast_parameters(model.parameters(), root_rank=0)
            step = make_ps_train_step(
                lambda b: llama.loss_fn(model.params(), b, cfg, attn),
                adam(model.parameters()), model.params(),
                local_shard_export=shard)
            FA.flash_attention_fwd.launches = 0
            times, losses, pushed = [], [], []
            for i in range(DP2_STEPS):
                if on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(bounded(lambda: float(step(batch)),
                                      f"ps_dp2 step {i} (rank {rank})"))
                times.append(time.perf_counter() - t0)
                pushed.append(step.counters["bytes_pushed"])
            launches = FA.flash_attention_fwd.launches
            plan = step._shards
            # the root's parameters against this rank's
            same = True
            for p in model.parameters():
                root_p = p.detach().clone()
                dist.broadcast(root_p, src=0, group=group)
                same = same and torch.equal(root_p, p.detach())
            flag = torch.tensor([int(same)], device=dev if backend == "nccl"
                                else "cpu")
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
            step.close()
            finals[shard] = [p.detach().clone() for p in model.parameters()]
            out["runs"][shard] = dict(
                times=times, losses=losses, pushed=pushed, launches=launches,
                same_on_every_rank=bool(flag.item()), shard_leaves=len(plan),
                shard_bytes=sum(i["slen"] * 4 for i in plan.values()),
                sharded_leaf_bytes=sum(i["size"] * 4 for i in plan.values()))
            print(f"ps_dp2 rank {rank} shard export "
                  f"{'on' if shard else 'off'}: losses {losses}, bytes "
                  f"pushed per step {pushed}", flush=True)
    finally:
        bounded(bps.shutdown, f"ps_dp2 shutdown (rank {rank})")
    if len(finals) == 2:
        out["on_equals_off"] = all(torch.equal(a, b) for a, b in
                                   zip(finals[False], finals[True]))
    if rank == 0:
        # plain local Adam steps on the ranks' mean gradient
        ref = llama.Llama(cfg, device=dev, params=init)
        opt = adam(ref.parameters())
        batches = [_dp2_tokens(cfg, r, seed, B, S, dev) for r in range(world)]
        for _ in range(DP2_STEPS):
            grads = []
            for b in batches:
                opt.zero_grad(set_to_none=True)
                llama.loss_fn(ref.params(), b, cfg, attn).backward()
                grads.append([p.grad for p in ref.parameters()])
            for p, *gs in zip(ref.parameters(), *grads):
                total = gs[0].clone()
                for g in gs[1:]:
                    total += g
                p.grad = total / world
            opt.step()
        out["local_equal"] = {
            shard: {n: int((a != b).sum()) for (n, b), a in
                    zip(ref.named_parameters(), f) if not torch.equal(a, b)}
            for shard, f in finals.items()}
    out["n_bytes"] = sum(p.numel() * p.element_size()
                         for p in model.parameters())
    return out


def phase_ps_dp2(args, card: str, dev_type: str = "cuda",
                 cfg_name: str = "small", B: int = 4, S: int = 2048) -> dict:
    """The dense host-tier PS step (``make_ps_train_step(loss, Adam,
    model.params())``) with a dp group of two processes: the intra-node
    reduce before the PS round, the root's pushes, the broadcast of each
    aggregate, and with ``local_shard_export`` each rank's own shard keys
    and the drain's all-gather. Llama small() at full width, B per rank,
    DP2_STEPS steps per run. With two cards or more: a rank per card over
    NCCL, the shard export off and on. With one card: both ranks on it
    over gloo (NCCL takes one rank per card), the shard export off (gloo
    has no reduce-scatter of card tensors). The CPU rehearsal runs it off
    and on. It fails unless both ranks' parameters are the same bit for
    bit, equal to plain local Adam steps on the mean gradient and, shard
    on, to the shard-off run; and unless the root pushes every parameter's
    bytes each step with the shard export off, and each rank its own
    shards with it on. Returns the root's launch counts per run.
    ``dev_type``/``cfg_name``/``B``/``S`` exist to rehearse the phase on
    the CPU."""
    import multiprocessing as mp
    import queue as queue_mod

    import torch
    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.server import run_server

    on_card = dev_type == "cuda"
    n_cards = torch.cuda.device_count() if on_card else 0
    two = not on_card or n_cards >= 2
    if on_card:
        devs = ["cuda:0", "cuda:1"] if two else ["cuda:0", "cuda:0"]
        backend = "nccl" if two else "gloo"
    else:
        devs, backend = ["cpu", "cpu"], "gloo"
    # gloo carries no reduce-scatter or all-gather of card tensors
    shard_runs = (False, True) if two else (False,)
    if not two:
        print(f"ps_dp2: NOT RUN on this machine ({n_cards} card): the "
              f"group over NCCL (NCCL takes one rank per card), so both "
              f"ranks run on cuda:0 over gloo; and the locality-shard "
              f"export (gloo has no reduce-scatter or all-gather of card "
              f"tensors)", flush=True)
    if not two:
        torch.cuda.empty_cache()
    # one server and one group for both runs: the shard run's keys are
    # new keys of the same registry
    port = _free_port()
    server = threading.Thread(target=run_server, args=(
        port, Config(num_workers=1, num_servers=1)), daemon=True,
        name="ps-server-dp2")
    server.start()
    coord = _free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_dp2_rank, args=(
        r, 2, devs[r], backend, port, coord, shard_runs, args.seed,
        cfg_name, B, S, q)) for r in range(2)]
    for p in procs:
        p.start()
    res = {}
    try:
        deadline = time.time() + PS_TIMEOUT_S * (1 + len(shard_runs))
        while len(res) < 2:
            try:
                rank, r = q.get(timeout=2.0)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in res and not p.is_alive()]
                if dead or time.time() > deadline:
                    fail(f"ps_dp2: no result from rank(s) "
                         f"{sorted(set(range(2)) - set(res))}; exit codes "
                         f"{[p.exitcode for p in procs]}")
                continue
            res[rank] = r
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for rank, r in sorted(res.items()):
        if "error" in r:
            fail(f"ps_dp2 rank {rank} raised:\n{r['error']}")
    if any(p.exitcode != 0 for p in procs):
        fail(f"ps_dp2: exit codes {[p.exitcode for p in procs]}")
    server.join(PS_TIMEOUT_S)
    if server.is_alive():
        fail("ps_dp2: the PS server did not exit after the root's SHUTDOWN")
    root, peer = res[0], res[1]
    n_bytes = root["n_bytes"]
    out = {}
    for shard in shard_runs:
        a, b = root["runs"][shard], peer["runs"][shard]
        label = f"shard export {'on' if shard else 'off'}"
        if not (a["same_on_every_rank"] and b["same_on_every_rank"]):
            fail(f"ps_dp2 {label}: the ranks' parameters differ")
        if root["local_equal"][shard]:
            fail(f"ps_dp2 {label}: the parameters differ from plain local "
                 f"Adam steps on the mean gradient: elements differing "
                 f"per leaf {root['local_equal'][shard]}")
        if shard:
            want = (n_bytes - a["sharded_leaf_bytes"] + a["shard_bytes"],
                    b["shard_bytes"])
            if a["shard_leaves"] == 0:
                fail("ps_dp2: the shard export planned no leaf")
        else:
            want = (n_bytes, 0)
        got = (set(a["pushed"]), set(b["pushed"]))
        if got != ({want[0]}, {want[1]}):
            fail(f"ps_dp2 {label}: bytes pushed per step {got}, not "
                 f"{want} (root, peer)")
        if on_card and (a["launches"] != 24 * DP2_STEPS
                        or b["launches"] != 24 * DP2_STEPS):
            fail(f"ps_dp2 {label}: flash_attn_fwd launches "
                 f"{a['launches']}, {b['launches']} in {DP2_STEPS} steps, "
                 f"not 24 a step on each rank")
        steady = [max(x, y) for x, y in zip(a["times"][1:], b["times"][1:])]
        tok_s = 2 * B * S / (sum(steady) / len(steady))
        print(f"ps_dp2 {label} ({backend}, {devs[0]} and {devs[1]}): "
              f"{tok_s:.1f} tokens/s for the group ({tok_s / 2:.1f} per "
              f"rank) over steps 1..{DP2_STEPS - 1} on {card}; steps "
              f"{['%.1f' % (t * 1e3) for t in steady]} ms; bytes pushed "
              f"per step: root {want[0]}, peer {want[1]} (every parameter: "
              f"{n_bytes}); {a['shard_leaves']} leaves sharded; B1 "
              f"launches per step per rank {a['launches'] / DP2_STEPS:.0f}; "
              f"parameters bit-identical on both ranks and to {DP2_STEPS} "
              f"plain local Adam steps on the ranks' mean gradient",
              flush=True)
        out[shard] = {"flash_attn_fwd": a["launches"]}
    if len(shard_runs) == 2:
        if not (root["on_equals_off"] and peer["on_equals_off"]):
            fail("ps_dp2: the shard export's parameters differ from the "
                 "shard-off run's")
        print("ps_dp2: shard export on and off leave bit-identical "
              "parameters on both ranks", flush=True)
    return out


# ---------------------------------------------------------------------- #
# the PyTorch adapter (byteps_tpu_torch.torch) and the row-sparse wire
# ---------------------------------------------------------------------- #

ADAPTER_2W_STEPS = 3


def _model_loss(model, batch, attn):
    """The Llama loss through ``model``'s own forward, so that the
    modules' pre-forward hooks (CrossBarrier's) run."""
    from byteps_tpu_torch.models import llama
    inputs, targets = llama.split_batch(batch)
    return llama.next_token_xent(model(inputs, attn_impl=attn), targets)


def _adam(params):
    import torch
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            foreach=True)


def _local_steps(model, loss_of, n: int, grad_fn=None) -> list:
    """``n`` plain local Adam steps of ``model``; ``grad_fn`` maps each
    gradient before the step. Returns the losses."""
    opt = _adam(model.parameters())
    losses = []
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model)
        loss.backward()
        if grad_fn is not None:
            for p in model.parameters():
                p.grad = grad_fn(p.grad)
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def _differ(a_params, b_params) -> dict:
    """{leaf: elements that differ} of two parameter lists; empty when
    they are equal bit for bit."""
    out = {}
    for i, (a, b) in enumerate(zip(a_params, b_params)):
        bad = a.detach() != b.detach()
        if bool(bad.any()):
            out[i] = int(bad.sum())
    return out


def _timed_loop(n: int, body, on_card: bool, label: str) -> tuple:
    import torch
    losses, times = [], []
    for i in range(n):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(bounded(body, f"{label} step {i}"))
        if on_card:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss ({label}): {losses}")
    return losses, times


def _tokens_per_s(times, tokens: int) -> float:
    steady = times[1:]
    return tokens / (sum(steady) / len(steady))


def phase_torch_adapter(args, card: str, dev=None, cfg=None, B: int = 4,
                        S: int = 2048) -> dict:
    """The PyTorch adapter, this slice's main path, one worker against a
    loopback server: Llama small() at full width as an ``nn.Module``,
    ``bps.DistributedOptimizer(torch.optim.Adam(lr=1e-3),
    named_parameters=model.named_parameters())`` for ``--steps`` steps
    (every gradient through its hook's side-stream copy, the export
    thread and a fused PUSHPULL; the aggregates into ``p.grad``), bit for
    bit where plain local Adam steps leave the parameters; then 3 steps
    each of ``Compression.fp16`` (bit for bit against local Adam on
    fp16-rounded gradients), ``DistributedDataParallel`` +
    ``sync_gradients()`` and ``CrossBarrier`` (bit for bit; its poller
    steps torch's own Adam over each parameter; no tolerance, since an
    ulp of an f32 weight can flip its bf16 cast in the forward, which
    Adam's g / (|g| + eps) can turn into moves of up to 2 lr), and an
    ``nn.Embedding(32000, 768, sparse=True)`` on the same 8,192 tokens
    whose gradient rides the row-sparse wire (bit for bit against local
    steps on the densified gradient). Returns the main run's launches."""
    import torch
    import byteps_tpu_torch.torch as bpt
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.torch.cross_barrier import CrossBarrier

    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(PS_TIMEOUT_S))
    dev = torch.device(dev or "cuda:0")
    on_card = dev.type == "cuda"
    cfg = cfg or llama.LlamaConfig.small()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    init = _tree_clone(llama.Llama(cfg, device=dev, generator=gen).params())
    attn = FA.make_flash_attn()
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device=dev)}

    def loss_of(m):
        return _model_loss(m, batch, attn)

    def fresh():
        # Llama takes the tensors it is given: each model its own copy
        return llama.Llama(cfg, device=dev, params=_tree_clone(init))

    def fp16_round(g):
        return g.half().float()

    out = {}
    with loopback_ps(dev, "adapter") as state:
        for kind, n in (("adam", args.steps), ("fp16", SHORT_RUN_STEPS),
                        ("ddp", SHORT_RUN_STEPS),
                        ("cross_barrier", SHORT_RUN_STEPS)):
            model = fresh()
            if kind == "ddp":
                wrapped = bpt.DistributedDataParallel(model)
                opt = _adam(model.parameters())

                def body():
                    opt.zero_grad(set_to_none=True)
                    loss = loss_of(model)
                    loss.backward()
                    wrapped.sync_gradients()
                    opt.step()
                    return float(loss.detach())
            else:
                opt = bpt.DistributedOptimizer(
                    _adam(model.parameters()),
                    named_parameters=model.named_parameters(),
                    compression=bpt.Compression.fp16 if kind == "fp16"
                    else bpt.Compression.none)
                if kind == "cross_barrier":
                    opt = CrossBarrier(model, opt, num_steps=n)
                    opt.step()          # step 0, before any gradient

                def body():
                    opt.zero_grad()
                    loss = loss_of(model)
                    loss.backward()
                    opt.step()
                    return float(loss.detach())
            FA.flash_attention_fwd.launches = 0
            pushed0 = state.scheduler.bytes_pushed
            losses, times = _timed_loop(n, body, on_card, f"adapter {kind}")
            launches = FA.flash_attention_fwd.launches
            pushed = (state.scheduler.bytes_pushed - pushed0) / n
            ref = fresh()
            ref_losses = _local_steps(
                ref, loss_of, n, fp16_round if kind == "fp16" else None)
            differ = _differ(list(model.parameters()), list(ref.parameters()))
            if differ or losses != ref_losses:
                fail(f"adapter {kind}: the parameters differ from {n} "
                     f"plain local Adam steps: elements per leaf {differ}; "
                     f"losses {losses} vs {ref_losses}")
            if on_card and launches != 24 * n:
                fail(f"adapter {kind}: flash_attn_fwd launched {launches} "
                     f"times in {n} steps, not 24 a step")
            print(f"torch_adapter {kind}: {_tokens_per_s(times, B * S):.1f} "
                  f"tokens/s over steps 1..{n - 1} on {card}; steps "
                  f"{['%.1f' % (t * 1e3) for t in times[1:]]} ms; "
                  f"{pushed:.0f} bytes pushed per step; B1 launches per "
                  f"step {launches / n:.0f}; parameters bit-identical to "
                  f"{n} plain local Adam steps"
                  + (" on fp16-rounded gradients" if kind == "fp16" else "")
                  + f"; losses {losses}", flush=True)
            if kind == "adam":
                out["flash_attn_fwd"] = launches
            del model, opt, ref
        # the sparse embedding
        n = SHORT_RUN_STEPS
        tokens = batch["tokens"][:, :-1]
        emb0 = torch.randn(cfg.vocab_size, cfg.dim, generator=gen,
                           device=dev) * 0.02

        def emb_model():
            emb = torch.nn.Embedding(cfg.vocab_size, cfg.dim, sparse=True,
                                     device=dev)
            with torch.no_grad():
                emb.weight.copy_(emb0)
            return emb

        def emb_loss(m):
            return (m(tokens) ** 2).mean()

        emb = emb_model()
        opt = bpt.DistributedOptimizer(
            _adam(emb.parameters()), named_parameters=emb.named_parameters())

        def body():
            opt.zero_grad()
            loss = emb_loss(emb)
            loss.backward()
            opt.step()
            return float(loss.detach())

        pushed0 = state.scheduler.bytes_pushed
        losses, times = _timed_loop(n, body, on_card, "adapter sparse")
        pushed = (state.scheduler.bytes_pushed - pushed0) / n
        ref = emb_model()
        ref_losses = _local_steps(ref, emb_loss, n, lambda g: g.to_dense())
        differ = _differ([emb.weight], [ref.weight])
        rows = int(torch.unique(tokens).numel())
        dense = cfg.vocab_size * cfg.dim * 4
        parts = len(state.registry.declare("grad/weight").partitions)
        if differ or losses != ref_losses:
            fail(f"adapter sparse embedding: differs from {n} local Adam "
                 f"steps on the densified gradient: {differ}; losses "
                 f"{losses} vs {ref_losses}")
        if pushed != 8 * parts + rows * (4 + cfg.dim * 4):
            fail(f"adapter sparse embedding: {pushed:.0f} bytes pushed a "
                 f"step, not the {rows} rows of the batch in {parts} "
                 f"partitions (dense {dense})")
        print(f"torch_adapter sparse embedding [{cfg.vocab_size}, "
              f"{cfg.dim}] on {tokens.numel()} tokens ({rows} rows): "
              f"{_tokens_per_s(times, tokens.numel()):.1f} tokens/s over "
              f"steps 1..{n - 1} on {card}; {pushed:.0f} bytes pushed per "
              f"step against {dense} dense; parameters bit-identical to "
              f"{n} local Adam steps on the densified gradient", flush=True)
    return out


def _adapter_2w_worker(w: int, port: int, seed: int, cfg_name: str,
                       B: int, S: int, dev: str, q) -> None:
    """Worker ``w`` of 2 of ``phase_torch_adapter_2w`` (a spawned
    process). Puts (w, result) on ``q``."""
    import faulthandler
    faulthandler.dump_traceback_later(PS_TIMEOUT_S * 2, exit=True)
    try:
        q.put((w, _adapter_2w_body(w, port, seed, cfg_name, B, S, dev)))
    except BaseException:  # noqa: BLE001 - reported by the parent
        import traceback
        q.put((w, {"error": traceback.format_exc()}))


def _adapter_2w_body(w, port, seed, cfg_name, B, S, dev):
    import hashlib

    import torch
    sys.path.insert(0, ROOT)
    import byteps_tpu_torch.torch as bpt
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.environ.update({
        "DMLC_NUM_WORKER": "2", "DMLC_NUM_SERVER": "1",
        "DMLC_WORKER_ID": str(w), "DMLC_ROLE": "worker",
        "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
        "BYTEPS_LOCAL_RANK": "0", "BYTEPS_LOCAL_SIZE": "1",
        "BYTEPS_CLIENT_TIMEOUT_S": str(PS_TIMEOUT_S)})
    cfg = _dp2_cfg(cfg_name)
    attn = FA.make_flash_attn()
    # each worker its own weights: the broadcasts make them worker 0's
    model = llama.Llama(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed + 20 + w))
    init = _tree_clone(model.params())
    batches = [_dp2_tokens(cfg, r, seed, B, S, dev) for r in range(2)]

    def digest():
        h = hashlib.sha256()
        for p in model.parameters():
            h.update(p.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    out = {"own_init": digest()}
    bpt.init(device=dev)
    try:
        out["rank_size"] = (bpt.rank(), bpt.size())
        print(f"torch_adapter_2w worker {w}: bps.rank() {bpt.rank()}, "
              f"bps.size() {bpt.size()}", flush=True)
        bpt.broadcast_parameters(model.state_dict(), root_rank=0)
        base = _adam(model.parameters())
        if w == 1:
            base.param_groups[0]["lr"] = 0.5    # the root's state wins
        opt = bpt.DistributedOptimizer(
            base, named_parameters=model.named_parameters())
        bpt.broadcast_optimizer_state(opt, root_rank=0)
        out["lr"] = opt.param_groups[0]["lr"]
        out["after_broadcast"] = digest()

        def body():
            opt.zero_grad()
            loss = _model_loss(model, batches[w], attn)
            loss.backward()
            opt.step()
            return float(loss.detach())

        FA.flash_attention_fwd.launches = 0
        out["losses"], out["times"] = _timed_loop(
            ADAPTER_2W_STEPS, body, on_card, f"adapter_2w worker {w}")
        out["launches"] = FA.flash_attention_fwd.launches
        out["final"] = digest()
    finally:
        bounded(bpt.shutdown, f"adapter_2w shutdown (worker {w})")
    if w == 0:
        # local Adam from worker 0's weights on the two workers' mean
        # gradient, as ps_dp2 builds its reference
        ref = llama.Llama(cfg, device=dev, params=init)
        opt = _adam(ref.parameters())
        for _ in range(ADAPTER_2W_STEPS):
            grads = []
            for b in batches:
                opt.zero_grad(set_to_none=True)
                _model_loss(ref, b, attn).backward()
                grads.append([p.grad for p in ref.parameters()])
            for p, g0, g1 in zip(ref.parameters(), *grads):
                p.grad = (g0 + g1) / 2
            opt.step()
        out["local_differ"] = _differ(list(model.parameters()),
                                      list(ref.parameters()))
    return out


def phase_torch_adapter_2w(args, card: str, dev_type: str = "cuda",
                           cfg_name: str = "small", B: int = 4,
                           S: int = 2048) -> dict:
    """Two PS workers through the adapter (``DMLC_NUM_WORKER=2``): each a
    spawned process with a ``dp`` group of one, both on the one card,
    and one ``python -m byteps_tpu_torch.server`` process. Worker 1
    starts from other weights and another learning rate;
    ``broadcast_parameters`` and ``broadcast_optimizer_state`` from
    worker 0 make them equal; each takes ADAPTER_2W_STEPS steps of
    ``DistributedOptimizer(Adam)`` on its own batch. Fails unless both end
    bit for bit equal to each other and to local Adam on the mean of the
    two gradients, and ``rank()``/``size()`` are (w, 2). Returns worker
    0's launches. ``dev_type``/``cfg_name``/``B``/``S`` exist to
    rehearse the phase on the CPU."""
    import multiprocessing as mp
    import queue as queue_mod

    dev = "cuda:0" if dev_type == "cuda" else "cpu"
    port = _free_port()
    server = _spawn_ps_server(port, {"DMLC_NUM_WORKER": "2"})
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = []
    res = {}
    try:
        _wait_port(port)
        procs = [ctx.Process(target=_adapter_2w_worker, args=(
            w, port, args.seed, cfg_name, B, S, dev, q)) for w in range(2)]
        for p in procs:
            p.start()
        deadline = time.time() + PS_TIMEOUT_S * 2
        while len(res) < 2:
            try:
                w, r = q.get(timeout=2.0)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in res and not p.is_alive()]
                if dead or time.time() > deadline:
                    fail(f"torch_adapter_2w: no result from worker(s) "
                         f"{sorted(set(range(2)) - set(res))}; exit codes "
                         f"{[p.exitcode for p in procs]}")
                continue
            res[w] = r
        for p in procs:
            p.join(60)
        try:
            server.wait(PS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail("torch_adapter_2w: the PS server did not exit after both "
                 "workers' SHUTDOWN")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if server.poll() is None:
            server.kill()
            server.wait()
    for w, r in sorted(res.items()):
        if "error" in r:
            fail(f"torch_adapter_2w worker {w} raised:\n{r['error']}")
    a, b = res[0], res[1]
    if (a["rank_size"], b["rank_size"]) != ((0, 2), (1, 2)):
        fail(f"torch_adapter_2w: rank()/size() {a['rank_size']}, "
             f"{b['rank_size']}, not (0, 2) and (1, 2)")
    if a["own_init"] == b["own_init"]:
        fail("torch_adapter_2w: the workers started from the same weights")
    if a["after_broadcast"] != b["after_broadcast"] or \
            b["after_broadcast"] != a["own_init"] or a["lr"] != b["lr"]:
        fail("torch_adapter_2w: broadcast_parameters/broadcast_optimizer_"
             "state did not make worker 1 equal to worker 0")
    if a["final"] != b["final"]:
        fail("torch_adapter_2w: the workers' parameters differ")
    if a["local_differ"]:
        fail(f"torch_adapter_2w: the parameters differ from local Adam on "
             f"the mean gradient: elements per leaf {a['local_differ']}")
    if dev_type == "cuda" and (a["launches"], b["launches"]) != (
            24 * ADAPTER_2W_STEPS,) * 2:
        fail(f"torch_adapter_2w: flash_attn_fwd launches {a['launches']}, "
             f"{b['launches']}, not 24 a step on each worker")
    steady = [max(x, y) for x, y in zip(a["times"][1:], b["times"][1:])]
    tok_s = 2 * B * S / (sum(steady) / len(steady))
    print(f"torch_adapter_2w (two PS workers, one card, one server "
          f"process): {tok_s:.1f} tokens/s for the fleet ({tok_s / 2:.1f} "
          f"per worker) over steps 1..{ADAPTER_2W_STEPS - 1} on {card}; "
          f"steps {['%.1f' % (t * 1e3) for t in steady]} ms; rank/size "
          f"{a['rank_size']} and {b['rank_size']}; parameters bit-identical "
          f"on both workers and to {ADAPTER_2W_STEPS} local Adam steps on "
          f"the mean of the two gradients; losses {a['losses']} and "
          f"{b['losses']}", flush=True)
    return {"flash_attn_fwd": a["launches"]}


def phase_ps_rowsparse(args, card: str, dev=None, cfg=None, B: int = 4,
                       S: int = 2048) -> dict:
    """``make_ps_train_step(..., rowsparse_params=("embed",))`` on the
    dense host tier, one worker: the embedding's gradient leaves the
    streamed export and travels row-sparse after the backward; the
    parameters must end bit for bit where plain local Adam steps (and so
    the dense host tier, ``phase_ps_host``) leave them; its row-sparse
    bytes are printed against its dense bytes. Then one device-tier
    dithering + EF step with the same ``rowsparse_params``: the
    embedding through the host row-sparse path, the rest compressed on
    the card (one B4 launch). Returns the host tier's launches."""
    import torch
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.training import make_ps_train_step

    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(PS_TIMEOUT_S))
    counters = _counters()
    dev = torch.device(dev or "cuda:0")
    on_card = dev.type == "cuda"
    cfg = cfg or llama.LlamaConfig.small()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 6)
    model = llama.Llama(cfg, device=dev, generator=gen)
    init = _tree_clone(model.params())
    attn = FA.make_flash_attn()
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device=dev)}
    rows = int(torch.unique(batch["tokens"][:, :-1]).numel())
    dense = cfg.vocab_size * cfg.dim * 4

    def loss(b):
        return llama.loss_fn(model.params(), b, cfg, attn)

    with loopback_ps(dev, "rowsparse") as state:
        step = make_ps_train_step(loss, _adam(model.parameters()),
                                  model.params(), rowsparse_params=("embed",))
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        run = run_steps(step, batch, args.steps, "rowsparse", on_card,
                        counters)
        step.close()
        ctx = state.registry.declare("grad/embed")
        parts = len(ctx.partitions)
        aligned = ctx.align_bytes == cfg.dim * 4
    report("rowsparse", card, run, B, S, dev, on_card,
           " (the embedding row-sparse)")
    sparse = [c["rowsparse_bytes"] for c in run["per_step"]]
    ref = llama.Llama(cfg, device=dev, params=init)
    ref_losses = _local_steps(
        ref, lambda m: llama.loss_fn(m.params(), batch, cfg, attn),
        len(run["losses"]))
    differ = _differ(list(model.parameters()), list(ref.parameters()))
    if differ or ref_losses != run["losses"]:
        fail(f"ps_rowsparse: the parameters differ from plain local Adam "
             f"steps: elements per leaf {differ}; losses {run['losses']} "
             f"vs {ref_losses}")
    want = 8 * parts + rows * (4 + cfg.dim * 4)
    if not aligned or set(sparse) != {want}:
        fail(f"ps_rowsparse: the embedding pushed {sparse} row-sparse bytes "
             f"a step, not {want} ({rows} rows, {parts} row-aligned "
             f"partitions: {aligned})")
    if on_card and run["launches"]["flash_attn_fwd"] != 24 * args.steps:
        fail(f"ps_rowsparse: flash_attn_fwd launched "
             f"{run['launches']['flash_attn_fwd']} times in {args.steps} "
             f"steps, not 24 a step")
    print(f"ps_rowsparse: the embedding [{cfg.vocab_size}, {cfg.dim}] "
          f"pushed {want} bytes a step row-sparse ({rows} of "
          f"{cfg.vocab_size} rows, {parts} row-aligned partitions) against "
          f"{dense} dense; parameters after {len(ref_losses)} steps "
          f"bit-identical to plain local Adam steps (the dense host tier's "
          f"result, phase ps_host)", flush=True)
    del ref
    kw = {"compressor": "dithering", "ef": "vanilla"}
    with loopback_ps(dev, "rowsparse device tier") as state:
        step = make_ps_train_step(loss, _adam(model.parameters()),
                                  model.params(), compression=kw,
                                  rowsparse_params=("embed",))
        for fn in counters.values():
            fn.launches = 0
        pushed0 = state.scheduler.bytes_pushed
        loss_v = bounded(lambda: float(step(batch)),
                         "ps_rowsparse device-tier step")
        pushed = state.scheduler.bytes_pushed - pushed0
        levels = counters["dithering_levels"].launches
        aligned = state.registry.declare("grad/embed").align_bytes == \
            cfg.dim * 4
        step.close()
    if not math.isfinite(loss_v) or not aligned or \
            (on_card and levels != 1):
        fail(f"ps_rowsparse device tier: loss {loss_v}, embedding "
             f"row-aligned {aligned}, B4 launches {levels}")
    print(f"ps_rowsparse device tier (dithering + EF, the embedding "
          f"row-sparse through the host): one step, loss {loss_v:.6f}, "
          f"{pushed} bytes pushed, B4 launches {levels}", flush=True)
    return dict(run["launches"])


# ---------------------------------------------------------------------- #
# the rest of the host codecs (lossless, varint dithering, the native
# codec) and cross-barrier bounded staleness, on the dense host tier's
# Llama small() at full width
# ---------------------------------------------------------------------- #

# the level count of the varint run: most of a gradient's levels are 0
VARINT_S = "2"
# the server's rate cap (MB/s) in the carried cross-barrier run: the
# step's 2 x 499 MB then take about as long as its backward
XB_THROTTLE_MBPS = "2000"
# and its per-request delay (ms, BYTEPS_CHAOS_SLOW_SERVER), with the keys
# submitted after the backward in flatten order: lm_head, the last key,
# has its partitions' delays still to come when the last key the step
# waits for (the final_norm bucket) has landed, so it is carried every
# step. (Streamed, the bucket is the last key sent and the step's wait
# for it leaves every carry-eligible reply in, or nearly.)
XB_SLOW_MS = "20"


def _llama_setup(args, dev, cfg, B: int, S: int, seed_off: int):
    """(device, config, initial weights, batch, attention) of a host-tier
    phase; the weights are copied into each run's fresh model."""
    import torch
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    dev = torch.device(dev or "cuda:0")
    cfg = cfg or llama.LlamaConfig.small()
    gen = torch.Generator(device=dev).manual_seed(args.seed + seed_off)
    init = _tree_clone(llama.Llama(cfg, device=dev, generator=gen).params())
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device=dev)}
    return dev, cfg, init, batch, FA.make_flash_attn()


def _host_run(label: str, card: str, setup, n: int, env: dict, B: int,
              S: int, note: str = "", flush: bool = False, **kw):
    """``n`` timed steps and one with its spans on of the host-tier step
    (Adam, foreach) of a fresh model from the setup's weights, against a
    loopback server that starts under ``env`` (``os.environ`` is put back
    after). ``flush``: then ``step.flush()``, twice, the second a no-op.
    Returns (model, run); ``run["per_step"]`` has every step's
    counters."""
    import torch
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.training import make_ps_train_step
    dev, cfg, init, batch, attn = setup
    on_card = dev.type == "cuda"
    model = llama.Llama(cfg, device=dev, params=_tree_clone(init))
    with restored_env():
        os.environ.update(env)
        with loopback_ps(dev, label):
            step = make_ps_train_step(
                lambda b: llama.loss_fn(model.params(), b, cfg, attn),
                _adam(model.parameters()), model.params(), **kw)
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            run = run_steps(step, batch, n, label, on_card, _counters())
            run["per_step"].append(dict(step.counters))
            if flush:
                bounded(step.flush, f"flush ({label})")
                once = [p.detach().clone() for p in model.parameters()]
                bounded(step.flush, f"second flush ({label})")
                if _differ(once, model.parameters()):
                    fail(f"{label}: a second flush() changed the "
                         f"parameters")
            step.close()
    report(label, card, run, B, S, dev, on_card, note)
    if on_card and run["launches"]["flash_attn_fwd"] != 24 * n:
        fail(f"flash_attn_fwd: {run['launches']['flash_attn_fwd']} "
             f"launches in {n} {label} steps, not 24 a step")
    return model, run


def _same_run(label: str, a, b) -> None:
    """Fail unless two runs (model, run) end with the same parameters and
    losses, bit for bit."""
    differ = _differ(list(a[0].parameters()), list(b[0].parameters()))
    if differ or a[1]["losses"] != b[1]["losses"]:
        fail(f"{label}: losses {a[1]['losses']} vs {b[1]['losses']}; "
             f"elements differing per leaf {differ}")


def phase_ps_host_lossless(args, card: str, dev=None, cfg=None, B: int = 4,
                           S: int = 2048) -> None:
    """``ps_host_lossless``: the host-codec tier under
    ``{"compressor": "lossless"}`` (byte planes + zlib on the worker, the
    server decoding, folding and re-encoding) against the dense host tier
    from the same weights: the codec is exact, so the parameters must
    end bit for bit alike; the bytes pushed a step are printed against
    the dense ones."""
    setup = _llama_setup(args, dev, cfg, B, S, 11)
    n = SHORT_RUN_STEPS
    dense = _host_run("lossless: dense host tier", card, setup, n, {}, B, S)
    lossless = _host_run("host lossless", card, setup, n, {}, B, S,
                         compression={"compressor": "lossless"},
                         device_compress=False)
    _same_run("host lossless against the dense host tier", lossless, dense)
    print(f"ps host lossless: parameters after {len(dense[1]['losses'])} "
          f"steps bit-identical to the dense host tier's; "
          f"{lossless[1]['pushed'] / n:.0f} bytes pushed a step against "
          f"the dense {dense[1]['pushed'] / n:.0f} "
          f"({lossless[1]['pushed'] / dense[1]['pushed']:.4f})", flush=True)


def phase_ps_host_varint(args, card: str, dev=None, cfg=None, B: int = 4,
                         S: int = 2048) -> None:
    """``ps_host_varint``: host dithering + EF at s = VARINT_S with
    ``index_coding=varint`` (the nonzero levels and their LEB128 index
    gaps) against the same configuration on the dense int8 wire, from
    the same weights: the same levels, so the parameters must end bit for
    bit alike; both wires' bytes a step are printed."""
    setup = _llama_setup(args, dev, cfg, B, S, 12)
    n = SHORT_RUN_STEPS
    kw = {"compressor": "dithering", "s": VARINT_S, "ef": "vanilla"}
    runs = {}
    for coding in ("dense", "varint"):
        runs[coding] = _host_run(
            f"host dithering s={VARINT_S} {coding} wire", card, setup, n, {},
            B, S, compression=dict(kw, index_coding=coding),
            device_compress=False)
    _same_run("varint against dense dithering", runs["varint"],
              runs["dense"])
    pushed = {k: r[1]["pushed"] / n for k, r in runs.items()}
    print(f"ps host varint: parameters after "
          f"{len(runs['dense'][1]['losses'])} steps bit-identical to the "
          f"dense wire's; bytes pushed a step: varint {pushed['varint']:.0f}"
          f", dense {pushed['dense']:.0f} "
          f"({pushed['varint'] / pushed['dense']:.4f})", flush=True)


NATIVE_GATE_KWS = (
    {"compressor": "onebit"}, {"compressor": "topk", "k": "0.01"},
    {"compressor": "randomk", "k": "0.01", "seed": "3"},
    {"compressor": "dithering", "seed": "4"})


def phase_native_codec(args, card: str, dev=None, cfg=None, B: int = 4,
                       S: int = 2048) -> None:
    """The native (C++) host codec against the numpy tier on the card's
    own gradients of one round: each leaf cut into the registry's
    partitions, each partition through both tiers; topk, randomk and
    dithering must write the same bytes, onebit the same signs with its
    scale within an ulp. Then the host onebit step with the native codec
    (the default) and with BYTEPS_NATIVE_CODEC=0, from the same
    weights."""
    import numpy as np
    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops.compression.host import make_host_codec
    from byteps_tpu_torch.ops.compression.native import NativeCodec
    from byteps_tpu_torch.training.train import named_leaves

    setup = _llama_setup(args, dev, cfg, B, S, 13)
    dev, cfg, init, batch, attn = setup
    model = llama.Llama(cfg, device=dev, params=_tree_clone(init))
    llama.loss_fn(model.params(), batch, cfg, attn).backward()
    part = Config.from_env().partition_bytes // 4
    pieces = []
    for _, p in named_leaves(model.params()):
        g = p.grad.detach().float().reshape(-1).cpu().numpy()
        pieces += [g[o:o + part] for o in range(0, g.size, part)]
    del model
    checked = {}
    t0 = time.perf_counter()
    for kw in NATIVE_GATE_KWS:
        name = kw["compressor"]
        for i, x in enumerate(pieces):
            with restored_env():
                os.environ.pop("BYTEPS_NATIVE_CODEC", None)
                native = make_host_codec(kw, x.size)
                os.environ["BYTEPS_NATIVE_CODEC"] = "0"
                plain = make_host_codec(kw, x.size)
            if not isinstance(native, NativeCodec) or isinstance(
                    plain, NativeCodec):
                fail(f"native codec gate: {name} took the wrong tiers")
            a = native.compress(x, step=1).tobytes()
            b = plain.compress(x, step=1)
            if name != "onebit":
                ok = a == b
            else:
                sa, sb = (np.frombuffer(w[-4:], np.int32)[0] for w in (a, b))
                ok = a[:-4] == b[:-4] and abs(int(sa) - int(sb)) <= 1
            if not ok:
                fail(f"native codec gate: {name} partition {i} of "
                     f"{x.size} elements differs from the numpy tier")
        checked[name] = len(pieces)
    print(f"native codec: {checked} partitions of the card's gradients, "
          f"native wire = numpy wire (onebit: signs equal, scale within an "
          f"ulp), {time.perf_counter() - t0:.1f} s", flush=True)
    kw = {"compressor": "onebit", "ef": "vanilla"}
    n = SHORT_RUN_STEPS
    arms = {}
    for arm, env in (("native", {}), ("numpy", {"BYTEPS_NATIVE_CODEC": "0"}),
                     ):
        _, run = _host_run(f"host onebit, {arm} codec", card, setup, n, env,
                           B, S, compression=kw, device_compress=False)
        arms[arm] = _tokens_per_s(run["times"], B * S)
    print(f"host onebit tokens/s on {card}: native codec "
          f"{arms['native']:.1f}, numpy codec {arms['numpy']:.1f}", flush=True)


def _replay_carry(setup, schedule):
    """Plain local Adam steps (each leaf's step alone, as the PS step's
    drain runs it) in which the leaves named in ``schedule[t]`` take step
    t's update after step t + 1's backward, and the last step's after
    the run. Returns (model, losses)."""
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.training.optim import make_leaf_apply
    from byteps_tpu_torch.training.train import named_leaves
    dev, cfg, init, batch, attn = setup
    model = llama.Llama(cfg, device=dev, params=_tree_clone(init))
    apply = make_leaf_apply(_adam(model.parameters()))
    leaves = [("grad/" + n, p) for n, p in named_leaves(model.params())]
    late, losses = [], []
    for carried in schedule:
        model.zero_grad(set_to_none=True)
        loss = llama.loss_fn(model.params(), batch, cfg, attn)
        loss.backward()
        losses.append(float(loss.detach()))
        grads = [p.grad.clone() for _, p in leaves]
        for p, g in late:
            p.grad = g
            apply.step(p)
        late = []
        for (name, p), g in zip(leaves, grads):
            if name in carried:
                late.append((p, g))
            else:
                p.grad = g
                apply.step(p)
    for p, g in late:
        p.grad = g
        apply.step(p)
    return model, losses


def phase_ps_cross_barrier(args, card: str, dev=None, cfg=None, B: int = 4,
                           S: int = 2048) -> None:
    """``ps_cross_barrier``: the dense host tier with
    BYTEPS_CROSS_BARRIER=1 (the server reads it too). At
    BYTEPS_STALENESS=0 it is the synchronous step bit for bit. At 1,
    against a server capped at XB_THROTTLE_MBPS and slowed by XB_SLOW_MS
    a request, the export after the backward, it must carry leaves
    (``carried_leaves``), keep every loss finite, flush idempotently and
    end bit for bit where a plain local replay of the recorded carry
    schedule ends. Tokens/s at staleness 0 and 1 without the cap; the
    run at 1 is held to the replay of its own schedule too."""
    setup = _llama_setup(args, dev, cfg, B, S, 14)
    n = SHORT_RUN_STEPS
    xb = {"BYTEPS_CROSS_BARRIER": "1"}
    sync = _host_run("cross-barrier: synchronous", card, setup, n, {}, B, S)
    s0 = _host_run("cross-barrier staleness 0", card, setup, n,
                   dict(xb, BYTEPS_STALENESS="0"), B, S)
    _same_run("staleness 0 against the synchronous step", s0, sync)
    thr = _host_run(f"cross-barrier staleness 1, server at "
                    f"{XB_THROTTLE_MBPS} MB/s and {XB_SLOW_MS} ms a request, "
                    f"keys after the backward", card, setup, n,
                    dict(xb, BYTEPS_STALENESS="1",
                         BYTEPS_SERVER_THROTTLE_MBPS=XB_THROTTLE_MBPS,
                         BYTEPS_CHAOS_SLOW_SERVER=XB_SLOW_MS,
                         BYTEPS_STREAM_EXPORT="0"),
                    B, S, flush=True)
    per_step = thr[1]["per_step"]
    carried = sum(c["carried_leaves"] for c in per_step)
    if carried == 0:
        fail(f"cross-barrier staleness 1 carried no leaf: {per_step}")
    schedule = [c["carried"] for c in per_step]
    replay = _replay_carry(setup, schedule)
    _same_run("staleness 1 against the replay of its carry schedule", thr,
              (replay[0], {"losses": replay[1]}))
    print(f"ps cross-barrier: staleness 0 bit-identical to the synchronous "
          f"step; staleness 1 (server at {XB_THROTTLE_MBPS} MB/s, "
          f"{XB_SLOW_MS} ms a request) carried "
          f"{carried} leaves over {len(per_step)} steps "
          f"({[list(s) for s in schedule]}; lags "
          f"{[c['carry_lag'] for c in per_step]}), flush idempotent, "
          f"parameters bit-identical to the local replay of that schedule",
          flush=True)
    s1 = _host_run("cross-barrier staleness 1", card, setup, n,
                   dict(xb, BYTEPS_STALENESS="1"), B, S, flush=True)
    replay = _replay_carry(setup, [c["carried"] for c in s1[1]["per_step"]])
    _same_run("staleness 1 (no server cap) against the replay of its carry "
              "schedule", s1, (replay[0], {"losses": replay[1]}))
    del replay
    rates = {k: _tokens_per_s(r[1]["times"], B * S)
             for k, r in (("synchronous", sync), ("staleness 0", s0),
                          ("staleness 1", s1))}
    print(f"ps cross-barrier tokens/s on {card}, no server cap: "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + f"; staleness 1 carried "
          f"{[c['carried_leaves'] for c in s1[1]['per_step']]}", flush=True)


# ---------------------------------------------------------------------- #
# the elastic fleet, asynchronous training, the carry over a dp group
# ---------------------------------------------------------------------- #

ELASTIC_STEPS = 8
# the step after which each event comes (1-based): a join, a drain, a
# suspend and resume
ELASTIC_JOIN, ELASTIC_DRAIN, ELASTIC_RESUME = 2, 4, 6


def _spawn_fleet(n: int, extra_env=None):
    """``n`` ``python -m byteps_tpu_torch.server`` processes on free
    ports, up: (ports, processes)."""
    ports, procs = [], []
    for _ in range(n):
        port = _free_port()
        while port in ports:
            port = _free_port()
        ports.append(port)
        procs.append(_spawn_ps_server(port, extra_env))
    for port in ports:
        _wait_port(port)
    return ports, procs


def _stop_fleet(procs, label: str) -> None:
    """Wait for each server's exit after its workers' SHUTDOWN; kill the
    ones still up (a server that a resume left holds its connection)."""
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            print(f"{label}: a server still up after the shutdown was "
                  f"killed", flush=True)


def _peak_gb(dev) -> float:
    import torch
    return torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else float("nan")


def phase_ps_elastic(args, card: str, dev=None, cfg=None, B: int = 4,
                     S: int = 2048) -> dict:
    """``ps_elastic``: the dense host-tier step (Adam) of Llama small()
    at full width, one worker, against two ``python -m
    byteps_tpu_torch.server`` processes, for ELASTIC_STEPS steps. After
    step ELASTIC_JOIN a third server is spawned and joined
    (``bps.add_server``): its load must be above 0. After step
    ELASTIC_DRAIN server 0 is drained (``bps.drain_server(0)``): its load
    must be 0. After step ELASTIC_RESUME, ``suspend()`` and
    ``resume(1, 3)`` onto the exported host list and retired set. The
    parameters and losses must end bit for bit where as many plain local
    Adam steps leave them. Then the adapter, ``DistributedOptimizer(Adam)``
    on a fleet of two, across a suspend and a resume after step 2 of 4,
    bit for bit against plain local Adam too. Prints the keys each event
    moved, the events' times and the tokens/s of the steps that follow no
    event. Returns the host-tier run's launches."""
    import torch
    import byteps_tpu_torch as bps
    import byteps_tpu_torch.torch as bpt
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.training import make_ps_train_step

    setup = _llama_setup(args, dev, cfg, B, S, 15)
    dev, cfg, init, batch, attn = setup
    on_card = dev.type == "cuda"
    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(PS_TIMEOUT_S))
    ref = llama.Llama(cfg, device=dev, params=_tree_clone(init))
    ref_losses = _local_steps(
        ref, lambda m: llama.loss_fn(m.params(), batch, cfg, attn),
        ELASTIC_STEPS)
    ref_params = [p.detach().clone() for p in ref.parameters()]
    del ref
    counters = _counters()
    events = {}
    with restored_env():
        ports, procs = _spawn_fleet(2)
        _fleet_env(ports, True, tempfile.gettempdir())
        try:
            bps.init(device=dev)
            try:
                state = bps.get_state()
                model = llama.Llama(cfg, device=dev, params=_tree_clone(init))
                step = make_ps_train_step(
                    lambda b: llama.loss_fn(model.params(), b, cfg, attn),
                    _adam(model.parameters()), model.params())
                for fn in counters.values():
                    fn.launches = 0
                if on_card:
                    torch.cuda.reset_peak_memory_stats(dev)
                losses, times = [], []
                for i in range(1, ELASTIC_STEPS + 1):
                    if on_card:
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses.append(bounded(lambda: float(step(batch)),
                                          f"ps_elastic step {i}"))
                    times.append(time.perf_counter() - t0)
                    if i == ELASTIC_JOIN:
                        # the fleet's servers hold their ports: a free
                        # one is a new one
                        (port,), (proc,) = _spawn_fleet(1)
                        procs.append(proc)
                        t0 = time.perf_counter()
                        idx = bps.add_server(f"127.0.0.1:{port}")
                        events["join"] = (time.perf_counter() - t0) * 1e3
                        load = state.registry.server_loads()[idx]
                        moved = sum(p.server == idx for c in
                                    state.registry.contexts_in_order()
                                    for p in c.partitions)
                        events["join_keys"] = moved
                        if idx != 2 or load <= 0:
                            fail(f"ps_elastic: the joined server {idx} holds "
                                 f"{load} bytes")
                    elif i == ELASTIC_DRAIN:
                        t0 = time.perf_counter()
                        moved = bps.drain_server(0)
                        events["drain"] = (time.perf_counter() - t0) * 1e3
                        events["drain_keys"] = len(moved)
                        load = state.registry.server_loads()[0]
                        if load != 0 or not moved:
                            fail(f"ps_elastic: server 0 holds {load} bytes "
                                 f"after its drain moved {len(moved)} keys")
                    elif i == ELASTIC_RESUME:
                        retired = os.environ.get("BYTEPS_RETIRED_SERVERS")
                        t0 = time.perf_counter()
                        bps.suspend()
                        bps.resume(1, 3)
                        events["resume"] = (time.perf_counter() - t0) * 1e3
                        state = bps.get_state()
                        if state.registry.dead_servers() != [0] or \
                                retired != "0":
                            fail(f"ps_elastic: resumed with retired "
                                 f"{state.registry.dead_servers()} "
                                 f"(exported {retired!r})")
                launches = {k: fn.launches for k, fn in counters.items()}
                peak = _peak_gb(dev)
                step.close()
            finally:
                bounded(bps.shutdown, "PS shutdown (ps_elastic)")
        finally:
            _stop_fleet(procs, "ps_elastic")
    differ = _differ(list(model.parameters()), ref_params)
    if differ or losses != ref_losses:
        fail(f"ps_elastic: parameters or losses differ from "
             f"{ELASTIC_STEPS} plain local Adam steps: losses {losses} vs "
             f"{ref_losses}; elements differing per leaf {differ}")
    if on_card and launches["flash_attn_fwd"] != 24 * ELASTIC_STEPS:
        fail(f"flash_attn_fwd: {launches['flash_attn_fwd']} launches in "
             f"{ELASTIC_STEPS} ps_elastic steps")
    del model, step
    after_event = {ELASTIC_JOIN + 1, ELASTIC_DRAIN + 1, ELASTIC_RESUME + 1}
    steady = [t for i, t in enumerate(times, 1)
              if i > 1 and i not in after_event]
    print(f"ps_elastic: the join moved {events['join_keys']} partitions "
          f"onto server 2 in {events['join']:.1f} ms, the drain "
          f"{events['drain_keys']} off server 0 in {events['drain']:.1f} "
          f"ms, suspend + resume(1, 3) took {events['resume']:.1f} ms; "
          f"parameters after {ELASTIC_STEPS} steps bit-identical to plain "
          f"local Adam; steps {['%.1f' % (t * 1e3) for t in times]} ms; "
          f"{B * S / (sum(steady) / len(steady)):.1f} tokens/s over the "
          f"steps after no event on {card}; peak memory {peak:.2f} GB",
          flush=True)

    # the adapter across a suspend and a resume
    n = 4
    ref = llama.Llama(cfg, device=dev, params=_tree_clone(init))
    ref_losses = _local_steps(ref, lambda m: _model_loss(m, batch, attn), n)
    ref_params = [p.detach().clone() for p in ref.parameters()]
    del ref
    with restored_env():
        ports, procs = _spawn_fleet(2)
        _fleet_env(ports, True, tempfile.gettempdir())
        try:
            bpt.init(device=dev)
            try:
                model = llama.Llama(cfg, device=dev, params=_tree_clone(init))
                opt = bpt.DistributedOptimizer(
                    _adam(model.parameters()),
                    named_parameters=model.named_parameters())

                def body():
                    opt.zero_grad()
                    loss = _model_loss(model, batch, attn)
                    loss.backward()
                    opt.step()
                    return float(loss.detach())

                losses = []
                for i in range(n):
                    losses.append(bounded(body, f"ps_elastic adapter {i}"))
                    if i == 1:
                        t0 = time.perf_counter()
                        bpt.suspend()
                        bpt.resume(1, 2)
                        t_res = (time.perf_counter() - t0) * 1e3
            finally:
                bounded(bpt.shutdown, "adapter shutdown (ps_elastic)")
        finally:
            _stop_fleet(procs, "ps_elastic adapter")
    differ = _differ(list(model.parameters()), ref_params)
    if differ or losses != ref_losses:
        fail(f"ps_elastic adapter: parameters or losses differ from {n} "
             f"local Adam steps across the suspend/resume: {differ}")
    print(f"ps_elastic adapter: DistributedOptimizer(Adam) across suspend "
          f"+ resume(1, 2) after step 2 ({t_res:.1f} ms), parameters after "
          f"{n} steps bit-identical to plain local Adam", flush=True)
    return launches


ASYNC_STEPS = 4
ASYNC_2W_STEPS = 3


def phase_ps_async(args, card: str, dev=None, cfg=None, B: int = 4,
                   S: int = 2048, dev_type: str = "cuda",
                   cfg_name: str = "small") -> dict:
    """``ps_async``: ``make_async_ps_train_step`` (Adam) of Llama small()
    at full width against one ``python -m byteps_tpu_torch.server`` run
    with BYTEPS_ENABLE_ASYNC=1, ASYNC_STEPS steps: each step's weight
    delta goes up and the server's weights come back, so the parameters
    must end bit for bit where a local replay leaves them that adds each
    step's delta to the weights in f32, as the server does. Then two
    worker processes on the card against one async server of two
    workers, ASYNC_2W_STEPS steps each on its own batch: every loss
    finite, 24 B1 launches a step on each, and after both are done a
    zero-delta pull gives both the same weights, which lie within the
    rounding bound of the seed plus both workers' deltas
    (``_fold_check``). Prints tokens/s, the bytes a step moves and the
    fleet's tokens/s. Returns the one-worker run's launches."""
    import torch
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.training import make_async_ps_train_step

    setup = _llama_setup(args, dev, cfg, B, S, 16)
    dev, cfg, init, batch, attn = setup
    on_card = dev.type == "cuda"
    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(PS_TIMEOUT_S))
    # the replay: local Adam, the weights then the old ones plus the delta
    ref = llama.Llama(cfg, device=dev, params=_tree_clone(init))
    opt = _adam(ref.parameters())
    ref_losses = []
    for _ in range(ASYNC_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = llama.loss_fn(ref.params(), batch, cfg, attn)
        loss.backward()
        ref_losses.append(float(loss.detach()))
        old = [p.detach().clone() for p in ref.parameters()]
        opt.step()
        with torch.no_grad():
            for p, o in zip(ref.parameters(), old):
                p.copy_(o + (p - o))
    ref_params = [p.detach().clone() for p in ref.parameters()]
    del ref, opt, old
    counters = _counters()
    with restored_env():
        ports, procs = _spawn_fleet(1, {"BYTEPS_ENABLE_ASYNC": "1"})
        _fleet_env(ports, True, tempfile.gettempdir())
        try:
            bps.init(device=dev)
            try:
                model = llama.Llama(cfg, device=dev, params=_tree_clone(init))
                step = make_async_ps_train_step(
                    lambda b: llama.loss_fn(model.params(), b, cfg, attn),
                    _adam(model.parameters()), model.params())
                for fn in counters.values():
                    fn.launches = 0
                if on_card:
                    torch.cuda.reset_peak_memory_stats(dev)
                losses, times = _timed_loop(
                    ASYNC_STEPS, lambda: float(step(batch)), on_card,
                    "ps_async")
                launches = {k: fn.launches for k, fn in counters.items()}
                peak = _peak_gb(dev)
                moved = dict(step.counters)
            finally:
                bounded(bps.shutdown, "PS shutdown (ps_async)")
        finally:
            _stop_fleet(procs, "ps_async")
    differ = _differ(list(model.parameters()), ref_params)
    if differ or losses != ref_losses:
        fail(f"ps_async: parameters or losses differ from the local replay "
             f"of the deltas: losses {losses} vs {ref_losses}; elements "
             f"differing per leaf {differ}")
    if on_card and launches["flash_attn_fwd"] != 24 * ASYNC_STEPS:
        fail(f"flash_attn_fwd: {launches['flash_attn_fwd']} launches in "
             f"{ASYNC_STEPS} ps_async steps")
    del model, step
    print(f"ps_async: {_tokens_per_s(times, B * S):.1f} tokens/s over steps "
          f"1..{ASYNC_STEPS - 1} on {card}; steps "
          f"{['%.1f' % (t * 1e3) for t in times]} ms; bytes a step: "
          f"{moved['bytes_pushed']} of deltas up, {moved['bytes_pulled']} "
          f"of weights down; peak memory {peak:.2f} GB; parameters "
          f"bit-identical to the local replay of the deltas", flush=True)
    _async_fleet(args, card, dev_type, cfg_name, B, S)
    return launches


def _async_2w_worker(w: int, port: int, seed: int, cfg_name: str, B: int,
                     S: int, dev: str, barrier, tmp: str, q) -> None:
    import faulthandler
    faulthandler.dump_traceback_later(PS_TIMEOUT_S * 2, exit=True)
    try:
        q.put((w, _async_2w_body(w, port, seed, cfg_name, B, S, dev,
                                 barrier, tmp)))
    except BaseException:  # noqa: BLE001 - reported by the parent
        import traceback
        q.put((w, {"error": traceback.format_exc()}))


def _async_2w_body(w, port, seed, cfg_name, B, S, dev, barrier, tmp):
    """One worker of the async fleet. Its optimizer's hooks sum, in f32,
    the deltas that each step pushes (and their magnitudes); after both
    workers are done, a zero delta pulls the server's weights, each
    worker saves its sums under ``tmp``, and worker 0 holds the weights
    to the seed plus both workers' deltas (``_fold_check``)."""
    import hashlib

    import torch
    sys.path.insert(0, ROOT)
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core.types import host_array, host_tensor
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.training import make_async_ps_train_step

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.environ.update({
        "DMLC_NUM_WORKER": "2", "DMLC_NUM_SERVER": "1",
        "DMLC_WORKER_ID": str(w), "DMLC_ROLE": "worker",
        "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
        "BYTEPS_CLIENT_TIMEOUT_S": str(PS_TIMEOUT_S)})
    cfg = _dp2_cfg(cfg_name)
    attn = FA.make_flash_attn()
    # the same weights on both workers: the first init wins anyway
    model = llama.Llama(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed + 30))
    batch = _dp2_tokens(cfg, w, seed, B, S, dev)
    params = list(model.parameters())
    seed_w = [p.detach().to(torch.float32, copy=True) for p in params]
    sums = {"delta": [torch.zeros_like(x) for x in seed_w],
            "abs": [torch.zeros_like(x) for x in seed_w]}
    before = []
    opt = _adam(params)

    def snap(*_):
        before[:] = [p.detach().clone() for p in params]

    def add(*_):
        # the step pushes exactly these: the new weights minus the old
        with torch.no_grad():
            for p, o, d, a in zip(params, before, sums["delta"],
                                  sums["abs"]):
                x = (p.detach() - o).float()
                d += x
                a += x.abs()

    opt.register_step_pre_hook(snap)
    opt.register_step_post_hook(add)
    out = {}
    bps.init(device=dev)
    try:
        step = make_async_ps_train_step(
            lambda b: llama.loss_fn(model.params(), b, cfg, attn),
            opt, model.params())
        FA.flash_attention_fwd.launches = 0
        out["losses"], out["times"] = _timed_loop(
            ASYNC_2W_STEPS, lambda: float(step(batch)), on_card,
            f"ps_async worker {w}")
        out["launches"] = FA.flash_attention_fwd.launches
        barrier.wait(PS_TIMEOUT_S)
        # both are done: a zero delta pulls the weights both folded into
        state = bps.get_state()
        ctxs = [state.registry.get("asyncw/" + n.replace(".", "/"))
                for n, _ in model.named_parameters()]
        zeros = [host_array(torch.zeros(p.numel(), dtype=p.dtype))
                 for p in params]
        got = state.ps_client.push_delta_pull_weights(
            ctxs, [z for z, _ in zeros])
        h = hashlib.sha256()
        for g in got:
            h.update(g.tobytes())
        out["weights"] = h.hexdigest()
        barrier.wait(PS_TIMEOUT_S)
    finally:
        bounded(bps.shutdown, f"ps_async shutdown (worker {w})")
    torch.save({k: [x.cpu() for x in v] for k, v in sums.items()},
               os.path.join(tmp, f"deltas_{w}.pt"))
    barrier.wait(PS_TIMEOUT_S)
    if w == 0:
        peer = torch.load(os.path.join(tmp, "deltas_1.pt"))
        weights = [host_tensor(g, wire).to(dev).float()
                   for g, (_, wire) in zip(got, zeros)]
        out.update(_fold_check(weights, seed_w, sums, peer,
                               2 * ASYNC_2W_STEPS,
                               torch.finfo(cfg.dtype).eps / 2))
    return out


def _fold_check(weights, seed_w, mine, peer, folds: int, u: float) -> dict:
    """The async server's weights against the seed plus every delta of
    both workers, element by element. The server folds each delta into
    weights of the model's dtype, rounding to nearest once a fold, so
    each fold errs by at most ``u`` (half the dtype's epsilon) of the
    weights it leaves, and no weights along the way exceed ``mag`` = |the
    seed| + both workers' summed |delta|: the tolerance is ``folds * u *
    (1 + folds * u) * mag``, plus 8 f32 roundings of ``mag`` for this
    reference's own f32 sums. Returns the elements over it (the gate),
    the worst error as a share of it, and the share of elements where a
    lost worker's deltas (worker 1's) would exceed it."""
    import torch
    over, worst, lost, total = 0, 0.0, 0, 0
    for i, (got, w0) in enumerate(zip(weights, seed_w)):
        peer_d = peer["delta"][i].to(w0.device)
        mag = w0.abs() + mine["abs"][i] + peer["abs"][i].to(w0.device)
        tol = (folds * u * (1 + folds * u) + 8 * 2.0 ** -24) * mag
        err = (got.reshape(w0.shape) - (w0 + mine["delta"][i] + peer_d)
               ).abs()
        over += int((err > tol).sum())
        ratio = err / tol.clamp_min(torch.finfo(torch.float32).tiny)
        worst = max(worst, float(ratio.max()))
        lost += int((peer_d.abs() > tol).sum())
        total += w0.numel()
    return {"fold_over": over, "fold_worst": worst,
            "fold_lost_visible": lost / total}


def _async_fleet(args, card: str, dev_type: str, cfg_name: str, B: int,
                 S: int) -> None:
    import multiprocessing as mp
    import queue as queue_mod

    dev = "cuda:0" if dev_type == "cuda" else "cpu"
    port = _free_port()
    server = _spawn_ps_server(port, {"DMLC_NUM_WORKER": "2",
                                     "BYTEPS_ENABLE_ASYNC": "1"})
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    barrier = ctx.Barrier(2)
    tmp = tempfile.mkdtemp(prefix="bps_async_")
    procs, res = [], {}
    try:
        _wait_port(port)
        procs = [ctx.Process(target=_async_2w_worker, args=(
            w, port, args.seed, cfg_name, B, S, dev, barrier, tmp, q))
            for w in range(2)]
        for p in procs:
            p.start()
        deadline = time.time() + PS_TIMEOUT_S * 2
        while len(res) < 2:
            try:
                w, r = q.get(timeout=2.0)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in res and not p.is_alive()]
                if dead or time.time() > deadline:
                    fail(f"ps_async fleet: no result from worker(s) "
                         f"{sorted(set(range(2)) - set(res))}; exit codes "
                         f"{[p.exitcode for p in procs]}")
                continue
            res[w] = r
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        _stop_fleet([server], "ps_async fleet")
        shutil.rmtree(tmp, ignore_errors=True)
    for w, r in sorted(res.items()):
        if "error" in r:
            fail(f"ps_async fleet worker {w} raised:\n{r['error']}")
    a, b = res[0], res[1]
    if a["weights"] != b["weights"]:
        fail("ps_async fleet: the zero-delta pulls gave the workers "
             "different weights")
    if a["fold_over"]:
        fail(f"ps_async fleet: {a['fold_over']} elements of the server's "
             f"weights lie outside the rounding bound of seed + both "
             f"workers' deltas (worst {a['fold_worst']:.3f} of the bound)")
    if dev_type == "cuda" and (a["launches"] != 24 * ASYNC_2W_STEPS
                               or b["launches"] != 24 * ASYNC_2W_STEPS):
        fail(f"ps_async fleet: flash_attn_fwd launches {a['launches']}, "
             f"{b['launches']} in {ASYNC_2W_STEPS} steps")
    steady = [max(x, y) for x, y in zip(a["times"][1:], b["times"][1:])]
    tok_s = 2 * B * S / (sum(steady) / len(steady))
    print(f"ps_async fleet (two workers, one card, one async server): "
          f"{tok_s:.1f} tokens/s for the fleet over steps "
          f"1..{ASYNC_2W_STEPS - 1} on {card}; steps "
          f"{['%.1f' % (t * 1e3) for t in steady]} ms; losses {a['losses']} "
          f"and {b['losses']}; flash launches a worker {a['launches']}, "
          f"{b['launches']}; the last zero-delta pull the same weights on "
          f"both, within the rounding bound of seed + both workers' deltas "
          f"(worst {a['fold_worst']:.4f} of it; worker 1's deltas alone "
          f"exceed it on {100 * a['fold_lost_visible']:.1f}% of elements)",
          flush=True)


XB_DP2_STEPS = 3


def _xb_dp2_rank(rank, world, dev, port, coord, seed, cfg_name, B, S, q):
    import faulthandler
    faulthandler.dump_traceback_later(PS_TIMEOUT_S * 2, exit=True)
    try:
        q.put((rank, _xb_dp2_body(rank, world, dev, port, coord, seed,
                                  cfg_name, B, S)))
    except BaseException:  # noqa: BLE001 - reported by the parent
        import traceback
        q.put((rank, {"error": traceback.format_exc()}))


def _xb_dp2_body(rank, world, dev, port, coord, seed, cfg_name, B, S):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.training import (broadcast_parameters,
                                           make_ps_train_step)
    from byteps_tpu_torch.training.optim import make_leaf_apply
    from byteps_tpu_torch.training.train import named_leaves

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.environ.update({
        "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
        "DMLC_WORKER_ID": "0", "DMLC_ROLE": "worker",
        "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
        "BYTEPS_LOCAL_RANK": str(rank), "BYTEPS_LOCAL_SIZE": str(world),
        "BYTEPS_COORD_PORT": str(coord),
        "BYTEPS_CLIENT_TIMEOUT_S": str(PS_TIMEOUT_S),
        "BYTEPS_CROSS_BARRIER": "1", "BYTEPS_STALENESS": "1",
        "BYTEPS_STREAM_EXPORT": "0"})
    cfg = _dp2_cfg(cfg_name)
    attn = FA.make_flash_attn()
    model = llama.Llama(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed + 40))
    init = _tree_clone(model.params())
    batches = [_dp2_tokens(cfg, r, seed + 40, B, S, dev)
               for r in range(world)]
    out = {}
    bps.init(device=dev, backend="gloo")
    try:
        group = bps.get_state().group
        broadcast_parameters(model.parameters(), root_rank=0)
        step = make_ps_train_step(
            lambda b: llama.loss_fn(model.params(), b, cfg, attn),
            _adam(model.parameters()), model.params())
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        carried = []

        def body():
            loss = float(step(batches[rank]))
            carried.append(list(step.counters["carried"]))
            return loss

        FA.flash_attention_fwd.launches = 0
        out["losses"], out["times"] = _timed_loop(
            XB_DP2_STEPS, body, on_card, f"xb dp2 rank {rank}")
        out["launches"] = FA.flash_attention_fwd.launches
        bounded(step.flush, f"xb dp2 flush (rank {rank})")
        out["flushed"] = step._carry is None
        out["carried"] = carried
        out["peak_gb"] = _peak_gb(dev)
        same = True
        for p in model.parameters():
            root_p = p.detach().clone()
            dist.broadcast(root_p, src=0, group=group)
            same = same and torch.equal(root_p, p.detach())
        out["same_as_root"] = same
        step.close()
    finally:
        bounded(bps.shutdown, f"xb dp2 shutdown (rank {rank})")
    if rank == 0:
        # the local replay on the ranks' mean gradient: the leaves named
        # in carried[t] take step t's update after step t + 1's backward
        ref = llama.Llama(cfg, device=dev, params=init)
        apply = make_leaf_apply(_adam(ref.parameters()))
        leaves = [("grad/" + n, p) for n, p in named_leaves(ref.params())]
        late = []
        for names in carried:
            per_rank = []
            for b in batches:
                ref.zero_grad(set_to_none=True)
                llama.loss_fn(ref.params(), b, cfg, attn).backward()
                per_rank.append([p.grad for _, p in leaves])
            grads = []
            for gs in zip(*per_rank):
                total = gs[0].clone()
                for g in gs[1:]:
                    total += g
                grads.append(total / world)
            for p, g in late:
                p.grad = g
                apply.step(p)
            late = []
            for (name, p), g in zip(leaves, grads):
                if name in names:
                    late.append((p, g))
                else:
                    p.grad = g
                    apply.step(p)
        for p, g in late:
            p.grad = g
            apply.step(p)
        out["replay_differ"] = _differ(list(model.parameters()),
                                       list(ref.parameters()))
    return out


def phase_ps_cross_barrier_dp2(args, card: str, dev_type: str = "cuda",
                               cfg_name: str = "small", B: int = 4,
                               S: int = 2048) -> dict:
    """``ps_cross_barrier_dp2``: the dense host tier of Llama small() with
    a dp group of two processes on the one card (gloo, as ``ps_dp2``
    runs on one card) and cross-barrier staleness 1, against a ``python
    -m byteps_tpu_torch.server`` capped as ``ps_cross_barrier``'s capped
    run is (XB_THROTTLE_MBPS, XB_SLOW_MS a request, the keys after the
    backward), so ``lm_head`` is carried. The root decides the carry:
    both ranks must carry the same leaves in every step, carry at least
    one, land them in the next step and at ``flush()``, and end with the
    same parameters, bit for bit those of a local replay of the carry
    schedule on the ranks' mean gradient. Returns rank 0's B1 launches,
    24 a step on each rank."""
    import multiprocessing as mp
    import queue as queue_mod

    dev = "cuda:0" if dev_type == "cuda" else "cpu"
    port = _free_port()
    server = _spawn_ps_server(port, {
        "BYTEPS_CROSS_BARRIER": "1", "BYTEPS_STALENESS": "1",
        "BYTEPS_SERVER_THROTTLE_MBPS": XB_THROTTLE_MBPS,
        "BYTEPS_CHAOS_SLOW_SERVER": XB_SLOW_MS})
    coord = _free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs, res = [], {}
    try:
        _wait_port(port)
        procs = [ctx.Process(target=_xb_dp2_rank, args=(
            r, 2, dev, port, coord, args.seed, cfg_name, B, S, q))
            for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.time() + PS_TIMEOUT_S * 2
        while len(res) < 2:
            try:
                rank, r = q.get(timeout=2.0)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in res and not p.is_alive()]
                if dead or time.time() > deadline:
                    fail(f"ps_cross_barrier_dp2: no result from rank(s) "
                         f"{sorted(set(range(2)) - set(res))}; exit codes "
                         f"{[p.exitcode for p in procs]}")
                continue
            res[rank] = r
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        _stop_fleet([server], "ps_cross_barrier_dp2")
    for rank, r in sorted(res.items()):
        if "error" in r:
            fail(f"ps_cross_barrier_dp2 rank {rank} raised:\n{r['error']}")
    a, b = res[0], res[1]
    if a["carried"] != b["carried"]:
        fail(f"ps_cross_barrier_dp2: the ranks carried different leaves: "
             f"{a['carried']} and {b['carried']}")
    if not any(a["carried"]):
        fail(f"ps_cross_barrier_dp2: nothing carried: {a['carried']}")
    if not (a["flushed"] and b["flushed"]):
        fail("ps_cross_barrier_dp2: flush() left a carry")
    if not (a["same_as_root"] and b["same_as_root"]):
        fail("ps_cross_barrier_dp2: the ranks' parameters differ")
    if a["replay_differ"]:
        fail(f"ps_cross_barrier_dp2: the parameters differ from the local "
             f"replay of the carry schedule {a['carried']}: elements per "
             f"leaf {a['replay_differ']}")
    if a["losses"] != b["losses"]:
        fail(f"ps_cross_barrier_dp2: losses {a['losses']} and {b['losses']}")
    if dev_type == "cuda" and (a["launches"] != 24 * XB_DP2_STEPS
                               or b["launches"] != 24 * XB_DP2_STEPS):
        fail(f"ps_cross_barrier_dp2: flash_attn_fwd launches "
             f"{a['launches']}, {b['launches']} in {XB_DP2_STEPS} steps")
    steady = [max(x, y) for x, y in zip(a["times"][1:], b["times"][1:])]
    tok_s = 2 * B * S / (sum(steady) / len(steady))
    print(f"ps_cross_barrier_dp2 (gloo, both ranks on {dev}; server at "
          f"{XB_THROTTLE_MBPS} MB/s and {XB_SLOW_MS} ms a request, keys "
          f"after the backward): carried {a['carried']} on both ranks; "
          f"{tok_s:.1f} tokens/s for the group over steps "
          f"1..{XB_DP2_STEPS - 1} on {card}; steps "
          f"{['%.1f' % (t * 1e3) for t in steady]} ms; flash launches a "
          f"rank {a['launches']}, {b['launches']}; peak memory "
          f"{a['peak_gb']:.2f} / {b['peak_gb']:.2f} GB; parameters "
          f"bit-identical on both ranks and to the local replay of the "
          f"schedule on the mean gradient", flush=True)
    return {"flash_attn_fwd": a["launches"]}


# ---------------------------------------------------------------------- #
# the model zoo: BytePS's published workloads on the PS step, the
# PyTorch adapter and the codec paths
# ---------------------------------------------------------------------- #

ZOO_STEPS = 3
ZOO_LR = 0.01           # BytePS's benchmark_byteps.py: SGD(lr=0.01)


def _zoo_spec(name: str, dev, seed: int, tiny: bool) -> dict:
    """One zoo model at its preset's full width (``tiny``: its tiny()
    config, to rehearse on the CPU) with seeded weights and a seeded
    batch: the model, ``loss(model, batch)``, the batch, the samples and
    the unit a step counts (images or tokens) and a fresh copy of the
    model from the same weights (``clone()``)."""
    import torch
    from byteps_tpu_torch.models import bert, mlp, moe, resnet, vgg

    gen = torch.Generator(device=dev).manual_seed(seed)
    if name == "mlp":
        cfg = mlp.MLPConfig()
        B = 64
        model = mlp.MLP(cfg, dev, generator=gen)
        batch = {"x": torch.rand(B, cfg.in_dim, generator=gen, device=dev),
                 "y": torch.randint(0, cfg.n_classes, (B,), generator=gen,
                                    device=dev)}
        loss = lambda m, b: mlp.loss_fn(m.params(), b, cfg)  # noqa: E731
        make = lambda p: mlp.MLP(cfg, dev, params=p)  # noqa: E731
        unit, per = "images", B
        desc = f"MLPConfig() {cfg.in_dim}-{'-'.join(map(str, cfg.hidden))}-" \
               f"{cfg.n_classes} f32, B={B}"
    elif name in ("resnet50", "vgg16"):
        if name == "resnet50":
            cfg = resnet.ResNetConfig.tiny() if tiny else \
                resnet.ResNetConfig.resnet50()
            model = resnet.ResNet(cfg, dev, generator=gen)
            state0 = _tree_clone(model.state())
            loss = lambda m, b: resnet.loss_fn(  # noqa: E731
                m.params(), state0, b, cfg)[0]
            make = lambda p: resnet.ResNet(  # noqa: E731
                cfg, dev, params=p, state=state0)
            size, desc = (32 if tiny else 224), \
                f"ResNetConfig.{'tiny' if tiny else 'resnet50'}()"
        else:
            cfg = vgg.VGGConfig.tiny() if tiny else vgg.VGGConfig.vgg16()
            model = vgg.VGG(cfg, dev, generator=gen)
            loss = lambda m, b: vgg.loss_fn(m.params(), b, cfg)  # noqa: E731
            make = lambda p: vgg.VGG(cfg, dev, params=p)  # noqa: E731
            size, desc = cfg.image_size, \
                f"VGGConfig.{'tiny' if tiny else 'vgg16'}()"
        B = 4 if tiny else 64
        batch = {"x": torch.rand(B, size, size, 3, generator=gen, device=dev),
                 "y": torch.randint(0, cfg.n_classes, (B,), generator=gen,
                                    device=dev)}
        unit, per = "images", B
        desc += f" bf16, B={B}, {size}x{size}x3"
    elif name == "bert_large":
        cfg = bert.BertConfig.tiny() if tiny else bert.BertConfig.bert_large()
        B, S = (4, 64) if tiny else (64, 128)
        model = bert.Bert(cfg, dev, generator=gen)
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=dev)
        masked = torch.rand(B, S, generator=gen, device=dev) < 0.15
        labels = torch.where(masked, torch.randint(
            0, cfg.vocab_size, (B, S), generator=gen, device=dev), -1)
        batch = {"tokens": toks, "labels": labels}
        loss = lambda m, b: bert.loss_fn(m.params(), b, cfg)  # noqa: E731
        make = lambda p: bert.Bert(cfg, dev, params=p)  # noqa: E731
        unit, per = "tokens", B * S
        desc = f"BertConfig.{'tiny' if tiny else 'bert_large'}() bf16, " \
               f"B={B}, S={S}, 15% masked"
    else:
        cfg = moe.MoEConfig.tiny() if tiny else moe.MoEConfig.small()
        B, S = (2, 64) if tiny else (8, 512)
        model = moe.MoE(cfg, dev, generator=gen)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                         generator=gen, device=dev)}
        loss = lambda m, b: moe.loss_fn(m.params(), b, cfg)  # noqa: E731
        make = lambda p: moe.MoE(cfg, dev, params=p)  # noqa: E731
        unit, per = "tokens", B * S
        desc = f"MoEConfig.{'tiny' if tiny else 'small'}() bf16, " \
               f"{cfg.n_experts} experts, top {cfg.top_k}, B={B}, S={S}"
    init = _tree_clone(model.params())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    return dict(model=model, loss=loss, batch=batch, unit=unit, per=per,
                desc=desc, n_bytes=n_bytes, held=0,
                n_leaves=len(list(model.parameters())),
                clone=lambda: make(_tree_clone(init)))


def _sgd(params):
    import torch
    return torch.optim.SGD(params, lr=ZOO_LR, foreach=True)


def _zoo_plain(spec, n: int):
    """``n`` plain local SGD steps of a fresh copy of the model on the
    same batch: (the copy, the losses)."""
    ref = spec["clone"]()
    opt = _sgd(ref.parameters())
    losses = []
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        loss = spec["loss"](ref, spec["batch"])
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return ref, losses


def _zoo_gate_plain(label: str, spec, model, losses) -> None:
    """The run's parameters bit for bit where as many plain local SGD
    steps leave them (one worker: the aggregate is the pushed
    gradient)."""
    ref, ref_losses = _zoo_plain(spec, len(losses))
    differ = _differ(list(model.parameters()), list(ref.parameters()))
    if differ or losses != ref_losses:
        fail(f"zoo {label}: the parameters differ from {len(losses)} plain "
             f"local SGD steps: elements per leaf {differ}; losses "
             f"{losses} vs {ref_losses}")
    print(f"zoo {label}: parameters bit-identical to {len(losses)} plain "
          f"local SGD steps; losses {losses}", flush=True)
    del ref


def _zoo_report(label: str, card: str, spec, times, pushed: float, dev,
                on_card: bool, extra: str = "") -> dict:
    import torch
    rate = _tokens_per_s(times, spec["per"])
    # the path's own peak: what the earlier phases left allocated is
    # taken off (phase_zoo reset the peak before building the model)
    peak_gb = (torch.cuda.max_memory_allocated(dev) - spec["held"]) / 1e9 \
        if on_card else float("nan")
    print(f"zoo {label}: {spec['desc']}; {spec['n_bytes']} parameter bytes "
          f"in {spec['n_leaves']} leaves; {rate:.1f} {spec['unit']}/s over "
          f"steps 1..{len(times) - 1} on {card}; steps "
          f"{['%.1f' % (t * 1e3) for t in times[1:]]} ms; {pushed:.0f} "
          f"bytes pushed per step; peak memory {peak_gb:.2f} GB (the "
          f"model, its step and its activations){extra}",
          flush=True)
    return dict(rate=rate, unit=spec["unit"], pushed=pushed,
                peak_gb=peak_gb)


def _declared(state) -> str:
    names = list(state.registry._contexts)
    fused = sum(n.startswith("fused/") for n in names)
    return f"; {len(names)} keys declared, {fused} of them fused buckets"


def _zoo_ps_host(label, spec, card, dev, on_card, counters) -> dict:
    """The dense host tier: ``make_ps_train_step(loss, SGD,
    model.params())`` through a loopback server, gated bit for bit."""
    from byteps_tpu_torch.training import make_ps_train_step

    model = spec["model"]
    with loopback_ps(dev, label) as state:
        step = make_ps_train_step(lambda b: spec["loss"](model, b),
                                  _sgd(model.parameters()), model.params())
        run = run_steps(step, spec["batch"], ZOO_STEPS, label, on_card,
                        counters)
        c = step.counters
        extra = (f"; leaves streamed {c['leaves_streamed']}, after the "
                 f"backward {c['leaves_post_backward']}, fused buckets "
                 f"{c['fused_buckets']}" + _declared(state))
        step.close()
        del step
    if run["pushed"] != ZOO_STEPS * spec["n_bytes"]:
        fail(f"zoo {label}: pushed {run['pushed']} bytes in {ZOO_STEPS} "
             f"steps, not {spec['n_bytes']} a step")
    out = _zoo_report(label, card, spec, run["times"],
                      run["pushed"] / ZOO_STEPS, dev, on_card, extra)
    spans = run["spans"]
    print(f"zoo {label} spans of one more step (host clock; they overlap): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in spans.items()),
          flush=True)
    _zoo_gate_plain(label, spec, model, run["losses"])
    out["launches"] = run["launches"]
    return out


def _zoo_adapter(label, spec, card, dev, on_card) -> dict:
    """The reference's ``benchmark_byteps.py`` route: the PyTorch
    adapter's ``DistributedOptimizer(SGD(lr=0.01))`` over the model as an
    ``nn.Module``, through a loopback server, gated bit for bit."""
    import byteps_tpu_torch.torch as bpt

    model = spec["model"]
    with loopback_ps(dev, label) as state:
        opt = bpt.DistributedOptimizer(
            _sgd(model.parameters()),
            named_parameters=model.named_parameters())

        def body():
            opt.zero_grad()
            loss = spec["loss"](model, spec["batch"])
            loss.backward()
            opt.step()
            return float(loss.detach())

        pushed0 = state.scheduler.bytes_pushed
        losses, times = _timed_loop(ZOO_STEPS + 1, body, on_card, label)
        pushed = (state.scheduler.bytes_pushed - pushed0) / (ZOO_STEPS + 1)
        extra = _declared(state)
        del opt
    if pushed != spec["n_bytes"]:
        fail(f"zoo {label}: {pushed:.0f} bytes pushed a step, not "
             f"{spec['n_bytes']}")
    out = _zoo_report(label, card, spec, times, pushed, dev, on_card, extra)
    _zoo_gate_plain(label, spec, model, losses)
    return out


def _zoo_ps_dithering(label, spec, card, dev, on_card, counters) -> dict:
    """The device tier under dithering + EF: one B4 launch a round (a
    step), two of the dequantization; gated on finite losses and the
    launch counts."""
    from byteps_tpu_torch.training import make_ps_train_step

    model = spec["model"]
    with loopback_ps(dev, label) as state:
        step = make_ps_train_step(
            lambda b: spec["loss"](model, b), _sgd(model.parameters()),
            model.params(), compression={"compressor": "dithering",
                                         "ef": "vanilla"})
        run = run_steps(step, spec["batch"], ZOO_STEPS, label, on_card,
                        counters)
        plans = step.device_compressor()._plans.values()
        n_parts = sum(len(p.codecs) for p in plans)
        n_comp = sum(c is not None for p in plans for c in p.codecs)
        extra = f"; {n_comp} of {n_parts} partitions compressed" + \
            _declared(state)
        step.close()
        del step
    out = _zoo_report(label, card, spec, run["times"],
                      run["pushed"] / ZOO_STEPS, dev, on_card, extra)
    if on_card:
        for name, per in (("dithering_levels", 1),
                          ("dithering_dequantize", 2)):
            if run["launches"][name] != per * ZOO_STEPS:
                fail(f"zoo {label}: {name} launched "
                     f"{run['launches'][name]} times in {ZOO_STEPS} steps, "
                     f"not {per} a step")
    out["launches"] = run["launches"]
    return out


def _zoo_collective_onebit(label, spec, card, dev, on_card,
                           counters) -> dict:
    """``make_train_step`` through ``DistributedOptimizer(SGD)`` under
    onebit + EF with an LR schedule: per compressed leaf a step, one B2,
    two B3 (EF and the gathered payload), one ``xla_sum`` (the scale) and
    one ``fma_scalar`` (the EF LR rescale)."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.training import (DistributedOptimizer,
                                           make_train_step)

    model = spec["model"]
    os.environ["DMLC_NUM_SERVER"] = "0"     # no PS: the collective path
    bps.init(device=dev)
    try:
        opt = DistributedOptimizer(
            _sgd(model.parameters()),
            compression={"compressor": "onebit", "ef": "vanilla"},
            lr_schedule=lambda s: ZOO_LR)
        n_comp = sum(st is not None for st in opt.compression.stacks)
        largest = max((p.numel() for p, st in zip(opt.params,
                                                  opt.compression.stacks)
                       if st is not None), default=0)
        step = make_train_step(lambda b: spec["loss"](model, b), opt)
        for fn in counters.values():
            fn.launches = 0
        losses, times = _timed_loop(
            ZOO_STEPS, lambda: float(step(spec["batch"])), on_card, label)
        launches = {k: fn.launches for k, fn in counters.items()}
        del opt, step
    finally:
        bps.shutdown()
    out = _zoo_report(label, card, spec, times, 0.0, dev, on_card,
                      f" (the collective path pushes nothing to a server); "
                      f"{n_comp} of {spec['n_leaves']} leaves compressed")
    if on_card:
        for name, per in (("onebit_pack", 1), ("onebit_unpack", 2),
                          ("xla_sum", 1), ("fma_scalar", 1)):
            if launches[name] != per * n_comp * ZOO_STEPS:
                fail(f"zoo {label}: {name} launched {launches[name]} times "
                     f"in {ZOO_STEPS} steps, not {per} for each of the "
                     f"{n_comp} compressed leaves a step")
    out.update(launches=launches, largest=largest)
    return out


def _zoo_onebit_checks(dev, n: int) -> None:
    """The collective onebit path's kernels at its largest compressed
    leaf, bit for bit against their plain twins."""
    import numpy as np
    import torch
    from byteps_tpu_torch.ops.compression import kernels as K

    gen = torch.Generator(device=dev).manual_seed(n)
    x, e = (torch.randn(n, generator=gen, device=dev) for _ in range(2))
    x[::97] = 0.0
    words = K.onebit_pack(x)
    scale = K.xla_mean(x, absolute=True)
    want_scale = K.xla_sum_plain(x, absolute=True) * float(
        np.float32(1) / np.float32(n))
    checks = {
        "onebit_pack": torch.equal(words, K.onebit_pack_plain(x)),
        "onebit_unpack": torch.equal(K.onebit_unpack(words, scale, n),
                                     K.onebit_unpack_plain(words, scale, n)),
        "xla_sum": torch.equal(scale, want_scale),
        "fma_scalar": torch.equal(K.fma_scalar(scale, e, x),
                                  K.fma_f32_plain(scale, e, x))}
    torch.cuda.synchronize()
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"zoo: {bad} differ from their plain twins at n={n}")
    print(f"zoo kernels at the collective onebit path's largest leaf "
          f"(n={n}): onebit_pack, onebit_unpack, xla_sum (the scale) and "
          f"fma_scalar bit-exact with their twins", flush=True)


def _zoo_dither_checks(dev, shapes, seed: int) -> None:
    """B4 and the dequantization over the device tier's round of a
    zoo model (``shapes``: its parameter shapes), bit for bit against
    their plain twins."""
    import torch
    from byteps_tpu_torch.ops.compression import kernels as K
    from byteps_tpu_torch.ops.compression import rng

    rnd = path_round({"compressor": "dithering"}, dev, shapes)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rnd.total, generator=gen, device=dev)
    views = [x[a: a + n] for a, n in rnd.spans]
    norms = rnd.norms(views)
    base = rng.uniform_base(seed, 1)
    _dither_round_check(
        x, norms, rnd.table, base, "linear",
        f"zoo dithering_levels round ({len(rnd.members)} partitions, "
        f"n={rnd.total})", None)
    lv = K.dithering_levels_round(
        x, norms, rnd.table, base, 127, "linear",
        torch.empty(rnd.table.out_extent, dtype=torch.int8, device=dev))
    for residual in (False, True):
        got = K.dithering_dequantize_round(
            lv, norms, rnd.table, 127, "linear",
            x.clone() if residual else torch.zeros_like(x),
            residual=residual)
        want = K.dithering_dequantize_round_plain(
            lv, norms, rnd.table, 127, "linear",
            x.clone() if residual else torch.zeros_like(x),
            residual=residual)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"zoo dithering_dequantize "
                 f"({'residual' if residual else 'aggregate'}): "
                 f"{int((got != want).sum())} elements differ from the twin")
    print(f"zoo dithering_dequantize over the same round: aggregate and "
          f"residual bit-exact with the twin", flush=True)


ZOO_PATHS = (("mlp", "ps host dense"), ("resnet50", "ps host dense"),
             ("resnet50", "adapter"), ("vgg16", "ps host dense"),
             ("vgg16", "ps device dithering"),
             ("bert_large", "ps host dense"),
             ("bert_large", "collective onebit"), ("moe_small",
                                                   "ps host dense"))


def phase_zoo(args, card: str, dev=None, tiny: bool = False) -> dict:
    """``zoo``: the five models of the JAX zoo beside Llama at their
    presets' full width and depth on one card (MLPConfig(), ResNet-50,
    VGG-16, BERT-large, MoE small), seeded random weights, BytePS's
    published batch of 64 a GPU for the three BytePS workloads (ResNet-50
    and VGG-16 at 224x224, BERT-large at S=128 with 15% masked) and
    examples/benchmark.py's shapes otherwise (MLP B=64, MoE B=8 S=512),
    ZOO_STEPS timed steps (and one more with the spans) on each of
    ZOO_PATHS, with SGD(lr=0.01). Dense host-tier and adapter paths end
    bit for bit where plain local SGD steps leave the parameters; the
    device-tier and collective paths launch their kernels as many times
    as a round or a compressed leaf asks, and those kernels are held to
    their twins at the path's shapes. The model, optimizer and step are
    freed before the next model. ``tiny`` rehearses it on the CPU at the
    tiny() configs. Returns each path's launches."""
    import torch

    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(PS_TIMEOUT_S))
    dev = torch.device(dev or "cuda:0")
    on_card = dev.type == "cuda"
    counters = {**_counters(), **_collective_counters()}
    # cuDNN's fastest backward algorithms add in a run-dependent order:
    # the bit-for-bit gates need the deterministic ones
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    t_zoo = time.perf_counter()
    try:
        for i, (name, path) in enumerate(ZOO_PATHS):
            label = f"{name} {path}"
            held = 0
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev)
            spec = _zoo_spec(name, dev, args.seed + 10 + i, tiny)
            spec["held"] = held
            t0 = time.perf_counter()
            if path == "ps host dense":
                res = _zoo_ps_host(label, spec, card, dev, on_card, counters)
            elif path == "adapter":
                res = _zoo_adapter(label, spec, card, dev, on_card)
            elif path == "ps device dithering":
                res = _zoo_ps_dithering(label, spec, card, dev, on_card,
                                        counters)
                if on_card:
                    _zoo_dither_checks(dev, _shapes(spec["model"]),
                                       args.seed)
            else:
                res = _zoo_collective_onebit(label, spec, card, dev,
                                             on_card, counters)
                if on_card and res["largest"]:
                    _zoo_onebit_checks(dev, res["largest"])
            print(f"zoo {label}: {time.perf_counter() - t0:.1f} s for the "
                  f"path, its gates and checks", flush=True)
            out[label] = res
            del spec, res
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"zoo: {time.perf_counter() - t_zoo:.1f} s for the "
          f"{len(ZOO_PATHS)} paths", flush=True)
    return out


# ---------------------------------------------------------------------- #
# the one-device step variants (remat policies, chunked cross entropy,
# the fused Adam step) and ZeRO-1
# ---------------------------------------------------------------------- #

VARIANT_STEPS = 4
ZERO_STEPS = 4
# an Adam update of the embedding: read p, g, v as f32 and m as bf16,
# write p, v and m
ADAM_BYTES_PER_ELEMENT = 24


def phase_fused_adam(dev, gen) -> dict:
    """The fused Adam kernel (``csrc/fused_adam.cu``) bit for bit with its
    twin on p, m and v after one update, at the embedding's length, at a
    ragged one and on views one element in (the scalar path); then timed
    at the embedding's shape beside the twin and
    ``torch.optim.Adam(fused=True)`` stepping that one parameter (which
    keeps m in f32: 28 bytes an element)."""
    import torch
    from byteps_tpu_torch.ops import fused_adam as FA

    worst = 0.0
    for n in (EMBED_N, RAGGED_N):
        p = torch.randn(n + 1, generator=gen, device=dev) * 0.02
        m = (torch.randn(n + 1, generator=gen, device=dev) * 1e-3).to(
            torch.bfloat16)
        v = torch.rand(n + 1, generator=gen, device=dev) * 1e-6
        g = torch.randn(n, generator=gen, device=dev) * 1e-2
        for view in (slice(0, n), slice(1, n + 1)):
            for count in (1, 1000):
                bc1, bc2 = FA.bias_corrections(count, 0.9, 0.999)
                got = [t[view].clone() for t in (p, m, v)]
                want = [t[view].clone() for t in (p, m, v)]
                FA.fused_adam_leaf(got[0], g, got[1], got[2], 1e-3, 0.9,
                                   0.999, 1e-8, bc1, bc2)
                FA.fused_adam_leaf_plain(want[0], g, want[1], want[2], 1e-3,
                                         0.9, 0.999, 1e-8, bc1, bc2)
                torch.cuda.synchronize()
                for a, b, name in zip(got, want, "pmv"):
                    err = float((a.float() - b.float()).abs().max())
                    worst = max(worst, err)
                    if not torch.equal(a, b):
                        fail(f"fused_adam differs from its twin on {name} "
                             f"at n={n}, view {view}, count {count}: "
                             f"{int((a != b).sum())} elements, max abs err "
                             f"{err}")
    print(f"fused_adam: bit-exact with its twin on p, m and v at n in "
          f"{(EMBED_N, RAGGED_N)}, aligned and one element in, counts 1 "
          f"and 1000", flush=True)
    n = EMBED_N
    p = torch.randn(n, generator=gen, device=dev) * 0.02
    g = torch.randn(n, generator=gen, device=dev) * 1e-2
    m = torch.zeros(n, dtype=torch.bfloat16, device=dev)
    v = torch.zeros(n, device=dev)
    bc1, bc2 = FA.bias_corrections(1, 0.9, 0.999)
    ms = cuda_graph_ms(lambda: FA.fused_adam_leaf(p, g, m, v, 1e-3, 0.9,
                                                  0.999, 1e-8, bc1, bc2))
    plain_ms = cuda_ms(lambda: FA.fused_adam_leaf_plain(
        p, g, m, v, 1e-3, 0.9, 0.999, 1e-8, bc1, bc2), 5)
    lib_p = torch.nn.Parameter(p.clone())
    lib_p.grad = g.clone()
    lib = torch.optim.Adam([lib_p], lr=1e-3, fused=True)
    library_ms = cuda_ms(lib.step, 20)
    entry = dict(
        name="fused_adam", route="cuda",
        source="byteps_tpu_torch/csrc/fused_adam.cu",
        replaces="byteps_tpu/jax/optim.py:36", max_abs_err=worst, ms=ms,
        plain_ms=plain_ms,
        bound_ms=ADAM_BYTES_PER_ELEMENT * n / PEAK_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=library_ms)
    print(f"fused_adam n={n}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
          f"{entry['bound_ms']:.4f} ms at 24 B an element, library "
          f"torch.optim.Adam(fused=True) {library_ms:.4f} ms at 28 B an "
          f"element)", flush=True)
    return entry


def _grads_at(model, cfg, batch, attn) -> tuple:
    """The loss and every gradient of ``model`` under ``cfg``, nothing
    left in ``.grad``."""
    import torch
    from byteps_tpu_torch.models import llama
    loss = llama.loss_fn(model.params(), batch, cfg, attn)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), grads


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() /
                 b.float().norm().clamp_min(1e-30))


def phase_train_variants(args, card: str, dev=None, cfg=None, B: int = 4,
                         S: int = 2048) -> dict:
    """The plain local fwd + bwd + Adam step of ``bench.py``'s
    ``phase_train`` on one card, no PS and no compression, Llama small()
    (flash attention, seeded), under its four variants for VARIANT_STEPS
    steps each from the same weights: ``remat`` (full recompute,
    ``torch.optim.Adam(1e-3)``), ``remat_dots_nb``
    (``remat_policy="dots_with_no_batch_dims_saveable"``), ``chunked8``
    (``xent_chunks=8`` over remat) and ``fused_adam``
    (``fused_adam_step`` over remat_dots_nb's config). Tokens/s over steps
    1.. and peak memory of each. Gates: every loss finite; from the same
    weights and batch, remat_dots_nb's loss and every gradient equal
    remat's bit for bit; chunked8's loss within 1e-5 relative of remat's
    and each gradient within 1e-4 relative L2 in f32, and in bf16 the
    loss within 1e-3 and each gradient at most 1.3 times as far from the
    f32 gradient as remat's; fused_adam's first update
    bit for bit its twin on the same gradients (caught by hooks on the
    leaves); 24 B1 launches a step on every variant and one fused Adam
    launch a leaf a step. fused_adam's peak leaves out its gate (steps
    1..). With ``--profile``, one more step of each variant under
    ``profile_step``, after its counts are read. Returns each variant's
    launches."""
    import dataclasses

    import torch
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.ops import fused_adam as FAD
    from byteps_tpu_torch.training import fused_adam_step

    dev = torch.device(dev) if dev is not None else torch.device("cuda", 0)
    on_card = dev.type == "cuda"
    cfg = cfg if cfg is not None else llama.LlamaConfig.small()
    cfg = dataclasses.replace(cfg, remat=True)
    configs = {
        "remat": cfg,
        "remat_dots_nb": dataclasses.replace(
            cfg, remat_policy="dots_with_no_batch_dims_saveable"),
        "chunked8": dataclasses.replace(cfg, xent_chunks=8)}
    configs["fused_adam"] = configs["remat_dots_nb"]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 21)
    model = llama.Llama(cfg, device=dev, generator=gen)
    init = [p.detach().clone() for p in model.parameters()]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device=dev)}
    attn = FA.make_flash_attn()
    n_leaves = len(init)

    def reset():
        """The initial weights, no gradients: a variant's peak holds
        nothing of the one before."""
        with torch.no_grad():
            for p, x in zip(model.parameters(), init):
                p.copy_(x)
                p.grad = None

    # the gates from the same weights and batch
    ref_loss, ref = _grads_at(model, configs["remat"], batch, attn)
    loss, grads = _grads_at(model, configs["remat_dots_nb"], batch, attn)
    bad = [i for i, (a, b) in enumerate(zip(grads, ref))
           if not torch.equal(a, b)]
    if not torch.equal(loss, ref_loss) or bad:
        fail(f"train_variants: remat_dots_nb's loss {float(loss)} or "
             f"gradients {bad} differ from remat's ({float(ref_loss)})")
    del grads
    # chunked8 against remat. In f32 the two differ by the order of the
    # logsumexps alone: loss within 1e-5 relative, every gradient within
    # 1e-4 relative L2 (the card read 0 and 2.4e-6 at most). In bf16 each
    # chunk's share of the hidden state's gradient is rounded to bf16
    # before the shares (which largely cancel) are added, as in the JAX
    # function (its bf16 run on the CPU shows the same gap at the head), so
    # there each gradient's distance from the f32 one may be at most 1.3
    # times remat's own (the card read 1.14 times at most), and the loss
    # within 1e-3 relative
    f32 = {k: dataclasses.replace(configs[k], dtype=torch.float32)
           for k in ("remat", "chunked8")}
    loss32, truth = _grads_at(model, f32["remat"], batch, attn)
    c_loss32, grads = _grads_at(model, f32["chunked8"], batch, attn)
    loss_rel32 = abs(float(c_loss32) - float(loss32)) / abs(float(loss32))
    rels32 = [_rel_l2(a, b) for a, b in zip(grads, truth)]
    del grads
    loss, grads = _grads_at(model, configs["chunked8"], batch, attn)
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    rels = [_rel_l2(a, b) for a, b in zip(grads, ref)]
    own = [_rel_l2(a, t) for a, t in zip(ref, truth)]
    mine = [_rel_l2(a, t) for a, t in zip(grads, truth)]
    print(f"train_variants: from the same weights, remat_dots_nb's loss and "
          f"all {n_leaves} gradients equal remat's bit for bit. chunked8 in "
          f"f32: loss {float(c_loss32):.6f} against {float(loss32):.6f} "
          f"(relative {loss_rel32:.3e}), gradients' relative L2 at most "
          f"{max(rels32):.3e}; in bf16: loss {float(loss):.6f} against "
          f"{float(ref_loss):.6f} (relative {loss_rel:.3e}), gradients' "
          f"relative L2 from remat's {['%.3e' % x for x in rels]}; from the "
          f"f32 gradients chunked8 {['%.3e' % x for x in mine]}, remat "
          f"{['%.3e' % x for x in own]}", flush=True)
    if loss_rel32 > 1e-5 or max(rels32) >= 1e-4 or loss_rel > 1e-3 or any(
            m > 1.3 * o for m, o in zip(mine, own)):
        fail(f"train_variants: chunked8 off remat: f32 loss {loss_rel32:.3e}"
             f", gradients {rels32}; bf16 loss {loss_rel:.3e}, distance "
             f"from the f32 gradients {mine} against remat's {own}")
    del truth
    del grads, ref

    out = {}
    for name, c in configs.items():
        reset()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        FA.flash_attention_fwd.launches = 0
        FAD.fused_adam_leaf.launches = 0
        if name == "fused_adam":
            init_fn, fstep = fused_adam_step(
                lambda p, b, c=c: llama.loss_fn(p, b, c, attn))
            state = init_fn(model.params())
            caught = {}
            hooks = [p.register_hook(
                lambda g, i=i: caught.__setitem__(i, g.clone()))
                for i, p in enumerate(model.parameters())]
            holder = {"state": state}

            def body():
                _, holder["state"], l = fstep(model.params(),
                                              holder["state"], batch)
                for h in hooks:
                    h.remove()
                hooks.clear()
                return float(l)
        else:
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)

            def body(c=c, opt=opt):
                opt.zero_grad(set_to_none=True)
                loss = llama.loss_fn(model.params(), batch, c, attn)
                loss.backward()
                opt.step()
                return float(loss.detach())
        if name == "fused_adam":
            losses, times = _timed_loop(1, body, on_card, f"variant {name}")
            # the first update against the twin on the caught gradients
            bc1, bc2 = FAD.bias_corrections(1, 0.9, 0.999)
            bad = []
            for i, (p, x) in enumerate(zip(model.parameters(), init)):
                t, m = x.clone(), torch.zeros_like(x, dtype=torch.bfloat16)
                FAD.fused_adam_leaf_plain(t, caught[i], m,
                                          torch.zeros_like(x), 1e-3, 0.9,
                                          0.999, 1e-8, bc1, bc2)
                if not torch.equal(p.detach(), t):
                    bad.append(i)
            if len(caught) != n_leaves or bad:
                fail(f"train_variants: fused_adam's first update differs "
                     f"from its twin on leaves {bad} ({len(caught)} "
                     f"gradients caught)")
            # the peak of the steps, not of the gate's copies
            caught.clear()
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            more, t_more = _timed_loop(VARIANT_STEPS - 1, body, on_card,
                                       f"variant {name}")
            losses, times = losses + more, times + t_more
        else:
            losses, times = _timed_loop(VARIANT_STEPS, body, on_card,
                                        f"variant {name}")
        launches = {"flash_attn_fwd": FA.flash_attention_fwd.launches,
                    "fused_adam": FAD.fused_adam_leaf.launches}
        want = {"flash_attn_fwd": 24 * VARIANT_STEPS if on_card else 0,
                "fused_adam": (n_leaves * VARIANT_STEPS
                               if name == "fused_adam" and on_card else 0)}
        if launches != want:
            fail(f"train_variants {name}: launches {launches}, not {want}")
        tok_s = _tokens_per_s(times, B * S)
        print(f"train_variants {name}: {tok_s:.1f} tokens/s over steps "
              f"1..{VARIANT_STEPS - 1} on {card}; steps "
              f"{['%.1f' % (t * 1e3) for t in times]} ms; losses "
              f"{['%.6f' % x for x in losses]}; peak memory "
              f"{_peak_gb(dev):.2f} GB; launches {launches}", flush=True)
        if args.profile:
            bounded(lambda: profile_step(lambda _: body(), batch,
                                         args.profile, f"variant_{name}"),
                    "profiled step")
        out[name] = launches
        body = opt = state = holder = None
    del model, init
    if on_card:
        torch.cuda.empty_cache()
    return out


def _zero_run(cfg, dev, rank: int, world: int, seed: int, B: int, S: int,
              group) -> dict:
    """ZeRO_STEPS ZeRO-1 steps of Llama ``cfg`` with Adam(1e-3) on this
    rank's batch inside an ``init``ed group, then a replay of plain Adam
    over the whole leaves on the group's mean gradient from the same
    weights: the elements that differ, times, losses, B1 launches, the
    optimizer state's bytes and the peak memory."""
    import torch
    import torch.distributed as dist
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.ops.push_pull import shard_layout
    from byteps_tpu_torch.training import (init_zero_state,
                                           make_zero_train_step)

    on_card = dev.type == "cuda"
    model = llama.Llama(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed + 31))
    init = _tree_clone(model.params())
    attn = FA.make_flash_attn()
    batch = _dp2_tokens(cfg, rank, seed, B, S, dev)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    objects = list(model.parameters())
    zs = init_zero_state(model.params(), _adam)
    step = make_zero_train_step(
        lambda b: llama.loss_fn(model.params(), b, cfg, attn),
        model.params(), zs)
    FA.flash_attention_fwd.launches = 0
    losses, times = _timed_loop(ZERO_STEPS, lambda: float(step(batch)),
                                on_card, f"zero (rank {rank})")
    launches = FA.flash_attention_fwd.launches
    peak = _peak_gb(dev)
    state_bytes = zs.state_bytes()
    want_bytes = 2 * 4 * sum(shard_layout(p.numel(), world)[0]
                             for p in model.parameters())
    same_objects = all(a is b for a, b in zip(objects, model.parameters()))
    del step, zs
    ref = llama.Llama(cfg, device=dev, params=init)
    opt = _adam(ref.parameters())
    for _ in range(ZERO_STEPS):
        opt.zero_grad(set_to_none=True)
        llama.loss_fn(ref.params(), batch, cfg, attn).backward()
        for p in ref.parameters():
            dist.all_reduce(p.grad, group=group)
            p.grad /= world
        opt.step()
    differ = _differ(model.parameters(), ref.parameters())
    return dict(losses=losses, times=times, launches=launches, peak=peak,
                state_bytes=state_bytes, want_bytes=want_bytes,
                n_bytes=sum(p.numel() * 4 for p in model.parameters()),
                differ=differ, same_objects=same_objects)


def _zero_check(label: str, r: dict, on_card: bool) -> None:
    if r["differ"]:
        fail(f"{label}: the parameters differ from the replay of Adam on "
             f"the mean gradient: elements per leaf {r['differ']}")
    if not r["same_objects"]:
        fail(f"{label}: the step replaced the module's parameter objects")
    if r["state_bytes"] != r["want_bytes"]:
        fail(f"{label}: optimizer state {r['state_bytes']} B, not "
             f"{r['want_bytes']} (two f32 moments of one shard a leaf)")
    if on_card and r["launches"] != 24 * ZERO_STEPS:
        fail(f"{label}: {r['launches']} B1 launches in {ZERO_STEPS} steps, "
             f"not 24 a step")


def _zero_rank(rank, world, dev, port, seed, cfg_name, B, S, q) -> None:
    """One rank of ``zero``'s group (a spawned process): NCCL, a card a
    rank, from BYTEPS_LOCAL_RANK / BYTEPS_LOCAL_SIZE / BYTEPS_COORD_PORT;
    puts (rank, result) on ``q``."""
    import faulthandler
    faulthandler.dump_traceback_later(PS_TIMEOUT_S, exit=True)
    try:
        import torch
        sys.path.insert(0, ROOT)
        import byteps_tpu_torch as bps

        dev = torch.device(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        os.environ.pop("DMLC_NUM_SERVER", None)
        os.environ.update({"BYTEPS_LOCAL_RANK": str(rank),
                           "BYTEPS_LOCAL_SIZE": str(world),
                           "BYTEPS_COORD_PORT": str(port)})
        bps.init(device=dev)
        try:
            r = _zero_run(_dp2_cfg(cfg_name), dev, rank, world, seed, B, S,
                          bps.get_state().group)
        finally:
            bps.shutdown()
        q.put((rank, r))
    except BaseException:  # noqa: BLE001 - reported by the parent
        import traceback
        q.put((rank, {"error": traceback.format_exc()}))


def _zero_report(label: str, card: str, runs: list, B: int, S: int) -> None:
    world = len(runs)
    steady = [max(ts) for ts in zip(*(r["times"][1:] for r in runs))]
    tok_s = world * B * S / (sum(steady) / len(steady))
    r = runs[0]
    print(f"{label}: {tok_s:.1f} tokens/s for the group over steps "
          f"1..{ZERO_STEPS - 1} on {card}; steps "
          f"{['%.1f' % (t * 1e3) for t in steady]} ms; losses "
          f"{['%.6f' % x for x in r['losses']]}; optimizer state "
          f"{r['state_bytes']} B a rank against {2 * r['n_bytes']} B of "
          f"whole-leaf Adam ({r['state_bytes'] / (2 * r['n_bytes']):.4f}); "
          f"peak memory {max(x['peak'] for x in runs):.2f} GB; B1 launches "
          f"a step a rank {r['launches'] / ZERO_STEPS:.0f}; parameters bit "
          f"for bit the replay of Adam on the mean gradient", flush=True)


def phase_zero(args, card: str, dev_type: str = "cuda",
               cfg_name: str = "small", B: int = 4, S: int = 2048) -> dict:
    """ZeRO-1 (``init_zero_state``, ``make_zero_train_step``) on Llama
    small() with Adam(1e-3), ZERO_STEPS steps: in this process on one
    card (a group of one over NCCL: the collectives run, degenerate),
    then, where the machine has two cards, two ranks on two cards over
    NCCL (spawned). Each run's parameters must end bit for bit where a
    replay of ``torch.optim.Adam`` over the whole leaves on the group's
    mean gradient leaves them, the module's parameter objects kept, the
    optimizer state two f32 moments of one 1/N shard a leaf. Returns the
    one-card run's launches."""
    import multiprocessing as mp
    import queue as queue_mod

    import torch
    import byteps_tpu_torch as bps

    on_card = dev_type == "cuda"
    with restored_env():
        os.environ.pop("DMLC_NUM_SERVER", None)
        for k in ("BYTEPS_LOCAL_RANK", "BYTEPS_LOCAL_SIZE"):
            os.environ.pop(k, None)
        bps.init(device=None if on_card else "cpu")
        try:
            dev = bps.get_state().device
            one = _zero_run(_dp2_cfg(cfg_name), dev, 0, 1, args.seed, B, S,
                            bps.get_state().group)
        finally:
            bps.shutdown()
    _zero_check("zero (one card)", one, on_card)
    _zero_report(f"zero, one process ({dev_type})", card, [one], B, S)
    if on_card:
        torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count() if on_card else 0
    if on_card and n_cards < 2:
        print(f"zero two ranks: NOT RUN on this machine ({n_cards} card): "
              f"the group over NCCL takes one rank per card, and gloo has "
              f"no reduce-scatter or all-gather of card tensors", flush=True)
        return {"flash_attn_fwd": one["launches"]}
    devs = ["cuda:0", "cuda:1"] if on_card else ["cpu", "cpu"]
    port = _free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_zero_rank, args=(
        r, 2, devs[r], port, args.seed, cfg_name, B, S, q))
        for r in range(2)]
    for p in procs:
        p.start()
    res = {}
    try:
        deadline = time.time() + PS_TIMEOUT_S
        while len(res) < 2:
            try:
                rank, r = q.get(timeout=2.0)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in res and not p.is_alive()]
                if dead or time.time() > deadline:
                    fail(f"zero two ranks: no result from rank(s) "
                         f"{sorted(set(range(2)) - set(res))}; exit codes "
                         f"{[p.exitcode for p in procs]}")
                continue
            res[rank] = r
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for rank, r in sorted(res.items()):
        if "error" in r:
            fail(f"zero rank {rank} raised:\n{r['error']}")
        _zero_check(f"zero rank {rank}", r, on_card)
    if res[0]["losses"] != res[1]["losses"]:
        fail(f"zero two ranks: the group's losses differ: "
             f"{res[0]['losses']}, {res[1]['losses']}")
    _zero_report(f"zero, two ranks ({devs[0]}, {devs[1]})", card,
                 [res[0], res[1]], B, S)
    return {"flash_attn_fwd": one["launches"]}


# ---------------------------------------------------------------------- #
# the parallel strategies: sp (ring, Ulysses), pp, ep over two ranks
# ---------------------------------------------------------------------- #

PARALLEL_STEPS = 4
PARALLEL_PATHS = ("sp_ring", "sp_ulysses", "pp", "ep")
# the B1 shape on Ulysses' path: small()'s 6 heads split over sp = 2,
# the 2 KV heads expanded to 6 before the all-to-all
FLASH_ULYSSES_SHAPE = dict(B=4, S=2048, H=3, Hkv=3, D=128)
# gates against the one-process replay (tolerances set before the first
# chip run of the phase): every loss within 2e-3 relative (half of
# bf16's 2^-8); each gradient of step 0, and each parameter's move over
# the steps, no farther from the bf16 replay's (relative L2) than 2x the
# bf16 replay's own distance from the same replay in f32: the parallel
# path may add no more than its own share of bf16 rounding (two
# independent bf16 roundings sit sqrt(2) apart)
PAR_LOSS_RTOL = 2e-3
PAR_RATIO = 2.0


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _names(tree, prefix="") -> list:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k],
                                                        f"{prefix}{k}/")]
    return [prefix[:-1]]


def _par_setup(path: str, dev, rank: int, seed: int, tiny: bool) -> dict:
    """One path's model, full weights, this rank's batch and weights, its
    loss and gradient correction, and the replay's loss over the whole
    batch (``replay(params, cfg)``)."""
    import dataclasses
    import functools

    import torch
    from byteps_tpu_torch.models import llama, moe
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.parallel import collectives as C
    from byteps_tpu_torch.parallel import pipeline as PL
    from byteps_tpu_torch.parallel import sharding as sh
    from byteps_tpu_torch.parallel.ulysses import make_ulysses_attn

    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    if path == "ep":
        cfg = moe.MoEConfig.small() if not tiny else dataclasses.replace(
            moe.MoEConfig.tiny(vocab_size=64, seq=32), n_experts=4)
        B, S = (8, 512) if not tiny else (4, 32)
        full = moe.init_params(cfg, gen, dev)
        tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                               device=dev)
        half = B // 2
        batches = [{"tokens": tokens[r * half:(r + 1) * half]}
                   for r in range(2)]
        # each rank's loss is over its own tokens; the replay's, and the
        # one reported, is the ranks' mean
        return dict(
            cfg=cfg, full=full, specs=sh.moe_param_specs(), tokens=B * S,
            axis="ep",
            loss=lambda p: moe.loss_fn(p, batches[rank], cfg, ep_axis="ep"),
            fix=lambda g: moe.ep_grad_correction(g, "ep"),
            report=lambda x: C.pmean(x, "ep"),
            replay=lambda p, c: 0.5 * (moe.loss_fn(p, batches[0], c)
                                       + moe.loss_fn(p, batches[1], c)))
    cfg = llama.LlamaConfig.small() if not tiny else dataclasses.replace(
        llama.LlamaConfig.tiny(vocab_size=64, seq=64), remat=True)
    B, S = (4, 2048) if not tiny else (4, 64)
    full = llama.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           device=dev)
    if path == "pp":
        M = 4
        return dict(
            cfg=cfg, full=full, specs=sh.llama_pp_param_specs(),
            tokens=B * S, axis="pp",
            loss=lambda p: llama.loss_fn_pp(p, {"tokens": tokens}, cfg,
                                            num_microbatches=M,
                                            pp_axis="pp"),
            fix=lambda g: {k: (PL.replicated_grad_correction(v, "pp")
                               if k != "blocks" else v)
                           for k, v in g.items()},
            replay=lambda p, c: llama.loss_fn(p, {"tokens": tokens}, c))
    whole = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    half = S // 2
    local = {k: v[:, rank * half:(rank + 1) * half] for k, v in whole.items()}
    if path == "sp_ring":
        # the ring's fold, over the whole sequence in two blocks
        attn, ref_attn = None, functools.partial(
            FA.blockwise_attention, causal=True, block_k=half)
    else:
        attn, ref_attn = make_ulysses_attn("sp", flash=True), \
            FA.make_flash_attn()
    return dict(
        cfg=cfg, full=full, specs=sh.P(), tokens=B * S, axis="sp",
        loss=lambda p: llama.loss_fn(p, local, cfg, attn, sp_axis="sp"),
        fix=lambda g: C.pmean(g, "sp"),
        replay=lambda p, c: llama.loss_fn(p, whole, c, ref_attn))


def _par_train(params, loss_grads, n: int, on_card: bool, label: str,
               count: bool = False, report=None) -> dict:
    """``n`` Adam(1e-3) steps of the tree ``params`` on the gradients of
    ``loss_grads(params)``: losses (through ``report``), step times, step
    0's gradients, the B1 launches of the steps; with ``count``, the
    collectives' bytes of step 1."""
    import torch
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.parallel import collectives as C

    leaves = _leaves(params)
    opt = _adam(leaves)
    out = dict(losses=[], times=[])
    FA.flash_attention_fwd.launches = 0
    for i in range(n):
        if count and i == 1:
            C.reset_bytes()
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = loss_grads(params)
        for p, g in zip(leaves, _leaves(grads)):
            p.grad = g
        opt.step()
        loss = float(report(loss) if report else loss)
        if on_card:
            torch.cuda.synchronize()
        out["times"].append(time.perf_counter() - t0)
        out["losses"].append(loss)
        if i == 0:
            out["g0"] = [g.detach() for g in _leaves(grads)]
        if count and i == 1:
            out["step_bytes"] = C.bytes_moved()
    out["launches"] = FA.flash_attention_fwd.launches
    if not all(math.isfinite(x) for x in out["losses"]):
        fail(f"non-finite loss ({label}): {out['losses']}")
    return out


def _par_path(path: str, dev, rank: int, seed: int, tiny: bool,
              mesh) -> dict:
    """One path on this rank: PARALLEL_STEPS sharded steps, then the same
    steps replayed in one process over the whole batch in bf16 and in
    f32; the gates' numbers on this rank's slice."""
    import dataclasses

    import torch
    from byteps_tpu_torch.parallel import collectives as C
    from byteps_tpu_torch.parallel import sharding as sh

    on_card = dev.type == "cuda"
    s = _par_setup(path, dev, rank, seed, tiny)
    cfg, full, specs = s["cfg"], s["full"], s["specs"]

    def grads_of(loss_fn, fix=None):
        def fn(p):
            loss = loss_fn(p)
            gs = torch.autograd.grad(loss, _leaves(p))
            it = iter(gs)
            g = _rebuild(p, it)
            with torch.no_grad():
                return loss.detach(), fix(g) if fix else g
        return fn

    # the forward alone, for the bytes
    local = sh.place_params(full, mesh, specs)
    with torch.no_grad():
        C.reset_bytes()
        float(s["loss"](local))
        fwd_bytes = C.bytes_moved()
    for p in _leaves(local):
        p.requires_grad_()
    init_local = [p.detach().clone() for p in _leaves(local)]
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    par = _par_train(local, grads_of(s["loss"], s["fix"]), PARALLEL_STEPS,
                     on_card, f"{path} rank {rank}", count=True,
                     report=s.get("report"))
    peak = _peak_gb(dev)
    par_end = [p.detach() for p in _leaves(local)]
    del local
    reps = {}
    for dtype in (cfg.dtype, torch.float32):
        c = dataclasses.replace(cfg, dtype=dtype)
        whole = _tree_clone(full)
        for p in _leaves(whole):
            p.requires_grad_()
        r = _par_train(whole, grads_of(lambda p, c=c: s["replay"](p, c)),
                       PARALLEL_STEPS, on_card, f"{path} replay {dtype}")
        # this rank's slice of the replay's gradients and parameters
        mine = lambda ts: _leaves(sh.place_params(  # noqa: E731
            _rebuild(full, iter(ts)), mesh, specs))
        reps[dtype] = dict(losses=r["losses"], g0=mine(r["g0"]),
                           end=mine([p.detach() for p in _leaves(whole)]))
        del whole, r
    bf, f32 = reps[cfg.dtype], reps[torch.float32]
    grad_gate, move_gate = [], []
    for name, g, gb, gf, p1, pb, pf, p0 in zip(
            _names(full), par["g0"], bf["g0"], f32["g0"], par_end,
            bf["end"], f32["end"], init_local):
        grad_gate.append((name, _rel_l2(g, gb), _rel_l2(gb, gf)))
        move_gate.append((name, _rel_l2(p1 - p0, pb - p0),
                          _rel_l2(pb - p0, pf - p0)))
    return dict(losses=par["losses"], times=par["times"],
                launches=par["launches"], peak=peak,
                step_bytes=par["step_bytes"], fwd_bytes=fwd_bytes,
                replay_losses=bf["losses"], replay_f32_losses=f32["losses"],
                grad_gate=grad_gate, move_gate=move_gate,
                transport=C.transport(mesh.group(s["axis"])),
                tokens=s["tokens"])


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    return next(it)


def _par_rank(rank, world, dev, backend, port, seed, tiny, q) -> None:
    """One rank of ``parallel`` (a spawned process): the job's group
    through ``parallel.distributed.ensure_initialized``, then every path
    on a mesh of one axis of two; puts (rank, {path: result}) on ``q``."""
    import faulthandler
    faulthandler.dump_traceback_later(PS_TIMEOUT_S * 3, exit=True)
    try:
        import torch
        import torch.distributed as dist
        sys.path.insert(0, ROOT)
        from byteps_tpu_torch.config import Config
        from byteps_tpu_torch.parallel import distributed as D
        from byteps_tpu_torch.parallel.mesh import make_mesh

        dev = torch.device(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(2)    # the CPU rehearsal's two ranks
        cfg = Config(num_processes=world, process_id=rank, coord_port=port)
        D.ensure_initialized(cfg, backend=backend)
        res = {}
        try:
            meshes = {ax: make_mesh({ax: world}) for ax in ("sp", "pp", "ep")}
            for path in PARALLEL_PATHS:
                mesh = meshes[path.split("_")[0]]
                with mesh:
                    res[path] = _par_path(path, dev, rank, seed, tiny, mesh)
                D.sync_global_devices(path)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        q.put((rank, res))
    except BaseException:  # noqa: BLE001 - reported by the parent
        import traceback
        q.put((rank, {"error": traceback.format_exc()}))


def _fwd_reckoning(path: str, tiny: bool) -> tuple:
    """(collective, bytes) one rank sends in one forward, from the
    shapes: the numbers the phase's forward must move."""
    if tiny:
        return None, None
    L, bf = 12, 2
    if path == "sp_ring":          # 1 rotation of K and V a layer
        return "ppermute", L * 1 * 2 * (4 * 1024 * 2 * 128 * bf)
    if path == "sp_ulysses":       # q, k, v in and o out, half leaves
        return "all_to_all", L * 4 * (4 * 1024 * 6 * 128 * bf) // 2
    if path == "pp":               # M + P - 1 ticks of a microbatch
        return "ppermute", 5 * (1 * 2048 * 768 * bf)
    return "all_to_all", L * 2 * (8 * 640 * 768 * bf) // 2


def _par_check_replay(label: str, r: dict) -> None:
    """The gates against the one-process replay: losses, step 0's
    gradients and the parameters' moves."""
    for a, b in zip(r["losses"], r["replay_losses"]):
        if abs(a - b) > PAR_LOSS_RTOL * abs(b):
            fail(f"{label}: losses {r['losses']} against the replay's "
                 f"{r['replay_losses']} (tolerance {PAR_LOSS_RTOL} "
                 f"relative)")
    for what, gate in (("gradient", r["grad_gate"]),
                       ("parameter move", r["move_gate"])):
        bad = [(n, a, b) for n, a, b in gate if a > PAR_RATIO * b]
        if bad:
            fail(f"{label}: {what} farther from the bf16 replay than "
                 f"{PAR_RATIO}x the replay's own bf16-f32 distance: "
                 f"{bad}")


def _par_check(path: str, rank: int, r: dict, on_card: bool,
               tiny: bool) -> None:
    label = f"parallel {path} rank {rank}"
    _par_check_replay(label, r)
    name, want = _fwd_reckoning(path, tiny)
    if name is not None and r["fwd_bytes"][name] != want:
        fail(f"{label}: a forward moved {r['fwd_bytes'][name]} B by "
             f"{name}, not {want}")
    if on_card and path == "sp_ulysses" and \
            r["launches"] != 24 * PARALLEL_STEPS:
        fail(f"{label}: {r['launches']} B1 launches in {PARALLEL_STEPS} "
             f"steps, not 24 a step")


def _two_ranks(target, args, dev_type: str, tiny: bool, label: str):
    """Two spawned ranks of ``target(rank, world, dev, backend, port,
    seed, tiny, q)``: a rank per card over NCCL where the machine has two
    cards; on one card both ranks on it over gloo (the all-to-alls,
    rotations and gathers through host copies,
    ``collectives.via_host``). Returns ({rank: result}, devices,
    backend, seconds)."""
    import multiprocessing as mp
    import queue as queue_mod

    import torch

    on_card = dev_type == "cuda"
    n_cards = torch.cuda.device_count() if on_card else 0
    if n_cards >= 2:
        devs, backend = ["cuda:0", "cuda:1"], "nccl"
    elif on_card:
        devs, backend = ["cuda:0", "cuda:0"], "gloo"
    else:
        devs, backend = ["cpu", "cpu"], "gloo"
    port = _free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=target, args=(
        r, 2, devs[r], backend, port, args.seed, tiny, q))
        for r in range(2)]
    for p in procs:
        p.start()
    res = {}
    try:
        deadline = time.time() + PS_TIMEOUT_S * 3
        while len(res) < 2:
            try:
                rank, r = q.get(timeout=2.0)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in res and not p.is_alive()]
                if dead or time.time() > deadline:
                    fail(f"{label}: no result from rank(s) "
                         f"{sorted(set(range(2)) - set(res))}; exit codes "
                         f"{[p.exitcode for p in procs]}")
                continue
            res[rank] = r
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for rank, r in sorted(res.items()):
        if "error" in r:
            fail(f"{label} rank {rank} raised:\n{r['error']}")
    return res, devs, backend, time.perf_counter() - t0


def _par_report(label: str, card: str, runs: list, steps: int,
                bytes_text: str) -> None:
    """A path's line: the group's tokens/s over steps 1.., peaks,
    transport, ``bytes_text``, losses against the replay's, the worst
    gate ratios and B1's launches a step a rank."""
    steady = [max(ts) for ts in zip(*(r["times"][1:] for r in runs))]
    tok_s = runs[0]["tokens"] / (sum(steady) / len(steady))
    r = runs[0]
    worst_g = max(a / max(b, 1e-30) for rr in runs
                  for _, a, b in rr["grad_gate"])
    worst_m = max(a / max(b, 1e-30) for rr in runs
                  for _, a, b in rr["move_gate"])
    print(f"{label}: {tok_s:.1f} tokens/s for the group over "
          f"steps 1..{steps - 1} on {card}; steps "
          f"{['%.1f' % (t * 1e3) for t in steady]} ms; peak "
          f"{', '.join('%.2f' % x['peak'] for x in runs)} GB by rank; "
          f"transport {r['transport']}; {bytes_text}; losses "
          f"{['%.6f' % x for x in r['losses']]} (replay "
          f"{['%.6f' % x for x in r['replay_losses']]}, f32 "
          f"{['%.6f' % x for x in r['replay_f32_losses']]}); worst "
          f"ratio to the bf16 replay's own distance: gradients "
          f"{worst_g:.3f}, parameter moves {worst_m:.3f} (gate "
          f"{PAR_RATIO}); B1 launches a step a rank "
          f"{r['launches'] / steps:g}", flush=True)


def phase_parallel(args, card: str, dev_type: str = "cuda",
                   tiny: bool = False) -> dict:
    """Expert, sequence and pipeline parallelism on two ranks
    (``parallel/``): Llama small() under ring attention and under Ulysses
    with B1 over ``sp``, pipelined over ``pp`` (M = 4), and MoE small()
    with its experts over ``ep``, PARALLEL_STEPS Adam(1e-3) steps each
    from one seeded weight set, each rank held to a one-process replay
    on the card (``_two_ranks`` says where the ranks run). Returns rank
    0's B1 launches on the Ulysses path."""
    res, devs, backend, secs = _two_ranks(_par_rank, args, dev_type, tiny,
                                          "parallel")
    on_card = dev_type == "cuda"
    print(f"parallel: two ranks on {devs[0]}, {devs[1]} over {backend}, "
          f"{secs:.1f} s for the four paths with their replays", flush=True)
    for path in PARALLEL_PATHS:
        runs = [res[0][path], res[1][path]]
        for rank, r in enumerate(runs):
            _par_check(path, rank, r, on_card, tiny)
        r = runs[0]
        name, want = _fwd_reckoning(path, tiny)
        fwd = {k: v for k, v in r["fwd_bytes"].items() if v}
        step = {k: v for k, v in r["step_bytes"].items() if v}
        multiple = (f"; {name} a step = "
                    f"{r['step_bytes'][name] / want:.3f} x the forward's "
                    f"{want}" if name else "")
        _par_report(f"parallel {path}", card, runs, PARALLEL_STEPS,
                    f"bytes rank 0 sent a step {step}, in a forward "
                    f"{fwd}{multiple}")
    return {"flash_attn_fwd": res[0]["sp_ulysses"]["launches"]}


def _flash_at(shape: dict, what: str, dev, gen) -> dict:
    """B1 at a path's ``shape``: the gate against the blockwise twin, its
    time, the twin's, scaled_dot_product_attention's and the bound."""
    import torch
    B, S, H, Hkv, D = (shape[k] for k in ("B", "S", "H", "Hkv", "D"))
    bf = torch.bfloat16
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev).to(bf)
               for h in (H, Hkv, Hkv))
    err = _flash_check(q, k, v)
    ms, plain_ms, lib_ms, bound_ms, bound_by = _flash_times(q, k, v, True)
    print(f"flash_attention at {what}, B={B} S={S} H={H} Hkv={Hkv} D={D} "
          f"bf16 causal: {ms:.4f} ms, {bound_ms / ms:.3f} of its bound "
          f"({bound_ms:.4f} ms, {bound_by}); {ms / lib_ms:.2f}x "
          f"scaled_dot_product_attention's {lib_ms:.4f} ms; plain twin "
          f"{plain_ms:.4f} ms; max abs err {err}", flush=True)
    return dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


def phase_flash_ulysses(dev, gen) -> dict:
    """B1 at the Ulysses path's shape (3 heads a rank, one KV head
    each)."""
    return _flash_at(FLASH_ULYSSES_SHAPE, "Ulysses' shape", dev, gen)


# ---------------------------------------------------------------------- #
# the GSPMD tier: Megatron tp (Llama, BERT) and FSDP over two ranks
# ---------------------------------------------------------------------- #

SPMD_STEPS = 4
SPMD_PATHS = ("tp", "fsdp", "bert_tp")
# B1 on the tp path: small()'s 6 query heads and 2 KV heads over tp = 2
FLASH_TP_SHAPE = dict(B=4, S=2048, H=3, Hkv=1, D=128)
# the reckonings, from the shapes (written before the first chip run):
# bytes of parameters a rank holds in f32. small(): half of the
# 498,597,888 B of split leaves plus the 76,800 B of norms that both
# tables leave whole (12 x 768 attn_norm, 12 x 768 mlp_norm, 768
# final_norm); BERT-large under tp = 2: half of the 1,337,171,968 B of
# split leaves (tok_embed, the six block matrices, mlm_dense) plus the
# 3,525,864 B left whole (the biases, LayerNorms, pos_embed, type_embed,
# mlm_out_bias)
SPMD_AT_REST = {"tp": 249_375_744, "fsdp": 249_375_744,
                "bert_tp": 672_111_848}
# Adam's exp_avg and exp_avg_sq beside the fsdp path's slices
SPMD_ADAM_FSDP = 498_751_488


def _spmd_setup(path: str, dev, seed: int, tiny: bool) -> dict:
    """One path's model, full weights, spec tree, mesh axes, batch spec,
    global batch, the step's loss function and the one-process replay's
    loss over the whole batch (``replay(params, cfg)``)."""
    import dataclasses

    import torch
    from byteps_tpu_torch.models import bert, llama
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.parallel import sharding as sh

    gen = torch.Generator(device=dev).manual_seed(seed + 43)
    if path == "bert_tp":
        cfg = bert.BertConfig.bert_large() if not tiny else \
            dataclasses.replace(bert.BertConfig.tiny(vocab_size=64, seq=32),
                                remat=True)
        B, S = (64, 128) if not tiny else (8, 32)
        full = bert.init_params(cfg, gen, dev)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=dev)
        masked = torch.rand(B, S, generator=gen, device=dev) < 0.15
        batch = {"tokens": tokens,
                 "labels": torch.where(masked, tokens,
                                       torch.full_like(tokens, -100))}
        return dict(
            cfg=cfg, full=full, specs=sh.bert_param_specs(), axes={"tp": 2},
            bspec=sh.P(), batch=batch, tokens=B * S,
            loss=lambda p, b: bert.loss_parts(p, b, cfg, tp_axis="tp"),
            replay=lambda p, c: bert.loss_fn(p, batch, c))
    cfg = llama.LlamaConfig.small() if not tiny else dataclasses.replace(
        llama.LlamaConfig.tiny(vocab_size=64, seq=64), remat=True)
    B, S = (4, 2048) if not tiny else (4, 64)
    full = llama.init_params(cfg, gen, dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device=dev)}
    attn = FA.make_flash_attn()
    common = dict(cfg=cfg, full=full, batch=batch, tokens=B * S,
                  replay=lambda p, c: llama.loss_fn(p, batch, c, attn))
    if path == "tp":
        return dict(common, specs=sh.llama_param_specs(), axes={"tp": 2},
                    bspec=sh.P(), loss=lambda p, b: llama.loss_fn(
                        p, b, cfg, attn, tp_axis="tp"))
    return dict(common, specs=sh.fsdp_param_specs(full, axis_size=2),
                axes={"dp": 2}, bspec=sh.P("dp"),
                loss=lambda p, b: llama.loss_fn(p, b, cfg, attn))


def _spmd_fwd_reckoning(path: str, tiny: bool) -> dict:
    """{counter: bytes} rank 0 sends in one forward, from the shapes:
    the numbers the phase's forward must move (``collectives``'
    conventions; at n = 2 an all-reduce counts its tensor once)."""
    if tiny:
        return {}
    bf, f32 = 2, 4
    if path == "tp":              # x [4, 2048, 768] bf16 after the
        act = 4 * 2048 * 768 * bf  # embedding and each wo, w_down; the
        return {"psum": 25 * act + 3 * 4 * 2048 * f32}   # xent's 3
    if path == "fsdp":            # embed and lm_head halves gathered;
        per_layer = 768 * (768 + 256 + 256 + 768 + 3 * 2048) * f32
        return {"all_gather": 2 * 16000 * 768 * f32,   # layers 0-5 sent
                "broadcast": 6 * per_layer}             # by rank 0
    act = 64 * 128 * 1024 * bf    # BERT-large: the embedding, wo and
    return {"psum": 49 * act + 3 * 64 * 128 * f32,      # w_out of 24
            "all_gather": 64 * 128 * 512 * bf}          # layers; mlm


def _spmd_train(step, leaves, batch, n: int, on_card: bool,
                label: str) -> dict:
    """``n`` calls of the spmd ``step``: losses, step times, step 0's
    gradients (``.grad`` after it), the B1 launches, and step 1's bytes
    by collective."""
    import torch
    from byteps_tpu_torch.ops import flash_attention as FA
    from byteps_tpu_torch.parallel import collectives as C

    out = dict(losses=[], times=[])
    FA.flash_attention_fwd.launches = 0
    for i in range(n):
        if i == 1:
            C.reset_bytes()
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(batch))
        if on_card:
            torch.cuda.synchronize()
        out["times"].append(time.perf_counter() - t0)
        out["losses"].append(loss)
        if i == 0:
            out["g0"] = [p.grad.detach().clone() for p in leaves]
        if i == 1:
            out["step_bytes"] = C.bytes_moved()
    out["launches"] = FA.flash_attention_fwd.launches
    if not all(math.isfinite(x) for x in out["losses"]):
        fail(f"non-finite loss ({label}): {out['losses']}")
    return out


def _spmd_path(path: str, dev, rank: int, seed: int, tiny: bool,
               mesh) -> dict:
    """One path on this rank through ``make_spmd_train_step``: the
    forward's bytes, SPMD_STEPS steps, then the same steps replayed in one
    process over the whole batch in bf16 and f32; the gates' numbers on
    this rank's slices."""
    import dataclasses

    import torch
    from byteps_tpu_torch.parallel import collectives as C
    from byteps_tpu_torch.parallel import fsdp
    from byteps_tpu_torch.parallel import sharding as sh
    from byteps_tpu_torch.parallel.spmd import data_axes, make_spmd_train_step

    on_card = dev.type == "cuda"
    s = _spmd_setup(path, dev, seed, tiny)
    cfg, full, specs = s["cfg"], s["full"], s["specs"]
    local = sh.place_params(full, mesh, specs)
    at_rest = sum(p.numel() * p.element_size() for p in _leaves(local))
    with mesh, torch.no_grad():
        C.reset_bytes()
        view = fsdp.view(local, specs, mesh, data_axes(s["bspec"]))
        part = s["loss"](view, sh.place_params(s["batch"], mesh, s["bspec"]))
        float(part[0] if isinstance(part, tuple) else part)
        fwd_bytes = C.bytes_moved()
    leaves = [p.requires_grad_() for p in _leaves(local)]
    init_local = [p.detach().clone() for p in leaves]
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    opt = _adam(leaves)
    step = make_spmd_train_step(s["loss"], opt, local, mesh, specs,
                                s["bspec"])
    run = _spmd_train(step, leaves, s["batch"], SPMD_STEPS, on_card,
                      f"spmd {path} rank {rank}")
    peak = _peak_gb(dev)
    adam_bytes = sum(v.numel() * v.element_size() for p in leaves
                     for k, v in opt.state[p].items()
                     if k in ("exp_avg", "exp_avg_sq"))
    par_end = [p.detach() for p in leaves]
    del step, opt, local
    reps = {}
    for dtype in (cfg.dtype, torch.float32):
        c = dataclasses.replace(cfg, dtype=dtype)
        whole = _tree_clone(full)
        for p in _leaves(whole):
            p.requires_grad_()

        def grads_of(p, c=c):
            loss = s["replay"](p, c)
            gs = torch.autograd.grad(loss, _leaves(p), allow_unused=True)
            gs = [torch.zeros_like(x) if g is None else g
                  for x, g in zip(_leaves(p), gs)]
            return loss.detach(), _rebuild(p, iter(gs))

        r = _par_train(whole, grads_of, SPMD_STEPS, on_card,
                       f"spmd {path} replay {dtype}")
        mine = lambda ts: _leaves(sh.place_params(  # noqa: E731
            _rebuild(full, iter(ts)), mesh, specs))
        reps[dtype] = dict(losses=r["losses"], g0=mine(r["g0"]),
                           end=mine([p.detach() for p in _leaves(whole)]),
                           times=r["times"])
        del whole, r
    bf, f32 = reps[cfg.dtype], reps[torch.float32]
    grad_gate, move_gate = [], []
    for name, g, gb, gf, p1, pb, pf, p0 in zip(
            _names(full), run["g0"], bf["g0"], f32["g0"], par_end,
            bf["end"], f32["end"], init_local):
        grad_gate.append((name, _rel_l2(g, gb), _rel_l2(gb, gf)))
        move_gate.append((name, _rel_l2(p1 - p0, pb - p0),
                          _rel_l2(pb - p0, pf - p0)))
    axis = next(iter(s["axes"]))
    return dict(losses=run["losses"], times=run["times"],
                launches=run["launches"], peak=peak,
                step_bytes=run["step_bytes"], fwd_bytes=fwd_bytes,
                at_rest=at_rest, adam_bytes=adam_bytes,
                replay_losses=bf["losses"], replay_f32_losses=f32["losses"],
                replay_tok_s=_tokens_per_s(bf["times"], s["tokens"]),
                grad_gate=grad_gate, move_gate=move_gate,
                transport=C.transport(mesh.group(axis)),
                tokens=s["tokens"])


def _spmd_rank(rank, world, dev, backend, port, seed, tiny, q) -> None:
    """One rank of ``spmd`` (a spawned process): the job's group, then
    every path on its mesh of two; puts (rank, {path: result}) on ``q``."""
    import faulthandler
    faulthandler.dump_traceback_later(PS_TIMEOUT_S * 3, exit=True)
    try:
        import torch
        import torch.distributed as dist
        sys.path.insert(0, ROOT)
        from byteps_tpu_torch.config import Config
        from byteps_tpu_torch.parallel import distributed as D
        from byteps_tpu_torch.parallel.mesh import make_mesh

        dev = torch.device(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(2)    # the CPU rehearsal's two ranks
        D.ensure_initialized(Config(num_processes=world, process_id=rank,
                                    coord_port=port), backend=backend)
        res = {}
        try:
            meshes = {ax: make_mesh({ax: world}) for ax in ("tp", "dp")}
            for path in SPMD_PATHS:
                mesh = meshes["dp" if path == "fsdp" else "tp"]
                res[path] = _spmd_path(path, dev, rank, seed, tiny, mesh)
                D.sync_global_devices(path)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        q.put((rank, res))
    except BaseException:  # noqa: BLE001 - reported by the parent
        import traceback
        q.put((rank, {"error": traceback.format_exc()}))


def _spmd_check(path: str, rank: int, r: dict, on_card: bool,
                tiny: bool) -> None:
    label = f"spmd {path} rank {rank}"
    _par_check_replay(label, r)
    want = _spmd_fwd_reckoning(path, tiny)
    got = {k: v for k, v in r["fwd_bytes"].items() if v}
    if want and got != want:
        fail(f"{label}: a forward moved {got}, not the reckoning {want}")
    if not tiny and r["at_rest"] != SPMD_AT_REST[path]:
        fail(f"{label}: {r['at_rest']} B of parameters at rest, not "
             f"{SPMD_AT_REST[path]}")
    if not tiny and path == "fsdp" and r["adam_bytes"] != SPMD_ADAM_FSDP:
        fail(f"{label}: {r['adam_bytes']} B of Adam state, not "
             f"{SPMD_ADAM_FSDP}")
    if on_card and path in ("tp", "fsdp") and \
            r["launches"] != 24 * SPMD_STEPS:
        fail(f"{label}: {r['launches']} B1 launches in {SPMD_STEPS} steps, "
             f"not 24 a step")


def phase_spmd(args, card: str, dev_type: str = "cuda",
               tiny: bool = False) -> dict:
    """The GSPMD tier on two ranks (``parallel/spmd.py``): Llama small()
    (B=4, S=2048) Megatron-parallel over ``tp`` with B1 over each rank's
    3 query heads and 1 KV head, the same model FSDP over ``dp`` (2
    sequences a rank), and BERT-large (B=64, S=128, 15% masked)
    Megatron-parallel over ``tp``; SPMD_STEPS Adam(1e-3) steps each
    through ``make_spmd_train_step`` from one seeded weight set, each rank
    held to a one-process replay on the card under the parallel phase's
    gates, its bytes at rest and its forward's bytes to the reckonings. A
    rank per card over NCCL where the machine has two cards; on one card
    both ranks on it over gloo. Returns rank 0's B1 launches on the tp
    path."""
    res, devs, backend, secs = _two_ranks(_spmd_rank, args, dev_type, tiny,
                                          "spmd")
    on_card = dev_type == "cuda"
    print(f"spmd: two ranks on {devs[0]}, {devs[1]} over {backend}, "
          f"{secs:.1f} s for the three paths with their replays",
          flush=True)
    for path in SPMD_PATHS:
        runs = [res[0][path], res[1][path]]
        for rank, r in enumerate(runs):
            _spmd_check(path, rank, r, on_card, tiny)
        r = runs[0]
        fwd = {k: v for k, v in r["fwd_bytes"].items() if v}
        step = {k: v for k, v in r["step_bytes"].items() if v}
        multiple = {k: round(v / fwd[k], 4) for k, v in step.items()
                    if fwd.get(k)}
        _par_report(f"spmd {path}", card, runs, SPMD_STEPS,
                    f"rank 0's one-process bf16 replay of the whole batch "
                    f"(each rank replays at once, on its card) "
                    f"{r['replay_tok_s']:.1f} tokens/s; "
                    f"bytes rank 0 sent a step {step}, in a forward {fwd} "
                    f"(step / forward {multiple}); bytes at rest a rank "
                    f"{[x['at_rest'] for x in runs]}, Adam state a rank "
                    f"{[x['adam_bytes'] for x in runs]}")
    return {"flash_attn_fwd": res[0]["tp"]["launches"]}


def phase_flash_tp(dev, gen) -> dict:
    """B1 at the tp path's shape (3 query heads and 1 KV head a rank):
    the gate against the blockwise twin, its time, the twin's,
    scaled_dot_product_attention's and the bound."""
    return _flash_at(FLASH_TP_SHAPE, "the tp-local heads", dev, gen)


def _shapes(model):
    """A model's parameter shapes as the nested dict its params() has."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return tuple(node.shape)
    return walk(model.params())


def apply_ab(step, batch, on_card: bool, card: str, n: int = 4) -> dict:
    """The dense step with each leaf's optimizer step run as its
    aggregate lands (``sharded_apply`` on) against one
    ``optimizer.step()`` after the whole drain (off), in segments of
    ``n`` timed steps ordered on, off, off, on. Each step's time, and its
    tail: from the last aggregate's completion to the end of the step's
    device work (the loss read waits for it), the part the per-leaf
    apply shortens. Returns {mode: (step ms, tail ms)}."""
    import statistics

    import torch
    times = {True: ([], []), False: ([], [])}
    for on in (True, False, False, True):
        step.sharded_apply = on
        for i in range(n):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = bounded(lambda: float(step(batch)),
                           f"apply A/B step {i}")
            t1 = time.perf_counter()
            times[on][0].append((t1 - t0) * 1e3)
            times[on][1].append((t1 - step.last_completion) * 1e3)
            if not math.isfinite(loss):
                fail(f"non-finite loss in the apply A/B: {loss}")
    step.sharded_apply = None
    out = {"per-leaf": times[True], "after the drain": times[False]}
    for k, (st, tail) in out.items():
        print(f"ps dense apply A/B, {k}, on {card} (segments on, off, off, "
              f"on; {n} steps each): step median "
              f"{statistics.median(st):.2f} ms, mean "
              f"{statistics.fmean(st):.2f} ms; tail after the last "
              f"completion median {statistics.median(tail):.3f} ms, mean "
              f"{statistics.fmean(tail):.3f} ms; steps "
              f"{['%.1f' % t for t in st]}; tails "
              f"{['%.2f' % t for t in tail]}", flush=True)
    return out


def profile_step(step, batch, out_dir: str, label: str = "train") -> float:
    """One more train step under torch.profiler: device time by kernel
    (and copy), the device-busy share of the step, and a Chrome trace in
    out_dir. Returns the step's loss."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loss = float(step(batch))
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          f"{label}_step_trace.json"))

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
    print(f"profile {label}: step {wall_ms:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} "
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
    return loss


def _kernel_class(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_fwd (B1)"
    if "onebit" in name:
        return "onebit (B2, B3)"
    if "nccl" in name.lower():
        return "nccl"
    if "Memcpy" in name:
        return "memcpy (D2H, H2D)"
    if "nvjet" in name or ("gemm" in name and "bf16" in name):
        return "gemm bf16"
    if "sgemm" in name or "f32f32" in name:
        return "gemm f32"
    if "reduce_kernel" in name:
        return "reductions"
    if "elementwise" in name or "copy" in name:
        return "elementwise and copies"
    return "other"


# the measurement plane's phase: timed steps of each run, and the child's
OBS_STEPS = 4
OBS_CHILD_STEPS = 3


def _llama_step_flops(cfg, B: int, S: int, flash: bool = True) -> float:
    """The analytic FLOPs of one Llama train step (forward and backward),
    counted as the step runs them: 2 a weight a token forward, 4
    backward (6N a token), and under remat 2 more for the recompute of
    each block but its last product (w_down: the checkpoint stops at the
    last saved tensor); attention in units of ``_flash_flops`` (the
    causal QK^T and PV forward): the flash forward one unit, one more for
    its recompute under remat, and its backward 7 (the blockwise
    recompute 2, its checkpoint's scores 1, the gradients 4); the plain
    path 2 a forward pass and 4 backward."""
    d, h, L, V = cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.vocab_size
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = B * S
    n_layer = d * nh * hd + 2 * d * nkv * hd + nh * hd * d + 3 * d * h
    dense = 6 * T * (L * n_layer + d * V)
    if cfg.remat:
        dense += 2 * T * L * (n_layer - h * d)
    u = _flash_flops(B, S, nh, hd)
    att = (1 + cfg.remat + 7) * u if flash else (6 + 2 * cfg.remat) * u
    return float(dense + L * att)


def obs_child(flight_dir: str) -> int:
    """The observability phase's worker process (``--obs-child``): a
    loopback server thread, Llama tiny() on the card with BYTEPS_HEALTH,
    BYTEPS_NAN_GUARD and BYTEPS_CHAOS_NAN_LEAF=wq@2 (every leaf its own
    key), steps until the guard raises; then one push replayed at the
    same round (the server's flight ring records its dedup), a line
    ``OBS_CHILD {...}`` and ``READY``, and a wait for SIGTERM."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.core.types import (
        DataType, RequestType, get_command_type,
    )
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.server import run_server
    from byteps_tpu_torch.training import make_ps_train_step

    port = _free_port()
    os.environ.update({
        "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
        "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_ROLE": "worker", "BYTEPS_HEALTH": "1", "BYTEPS_NAN_GUARD": "1",
        "BYTEPS_CHAOS_NAN_LEAF": "wq@2", "BYTEPS_FUSION_BYTES": "0",
        "BYTEPS_FLIGHT_DIR": flight_dir})
    for k in ("BYTEPS_SERVER_HOSTS", "BYTEPS_METRICS_PORT"):
        os.environ.pop(k, None)
    threading.Thread(target=run_server, args=(
        port, Config(num_workers=1, num_servers=1)), daemon=True).start()
    bps.init(device="cuda:0")
    cfg = llama.LlamaConfig.tiny(vocab_size=256, seq=128)
    gen = torch.Generator(device="cuda").manual_seed(5)
    model = llama.Llama(cfg, device="cuda:0", generator=gen)
    step = make_ps_train_step(
        lambda b: llama.loss_fn(model.params(), b, cfg),
        torch.optim.Adam(model.parameters(), lr=1e-3), model.params())
    tokens = torch.randint(0, 256, (2, 129), generator=gen, device="cuda")
    out = {"guard_step": None}
    for i in range(OBS_CHILD_STEPS):
        try:
            step({"tokens": tokens})
        except RuntimeError as e:
            out["guard_step"], out["guard"] = i + 1, str(e)[:200]
            break
    out["reports"] = [(r["step"], r["nonfinite_leaves"], r["health_flags"])
                      for r in bps.get_step_reports()]
    client = bps.get_state().ps_client
    cmd = get_command_type(RequestType.DEFAULT_PUSH_PULL, DataType.FLOAT32)
    key, data = (1 << 40) + 7, np.ones(8, np.float32)
    client.init_key(0, key, data, cmd)
    for _ in range(2):              # the second is a replay of round 1
        done = threading.Event()
        client.zpushpull_async(0, key, data, np.empty_like(data), cmd,
                               lambda got, err: done.set(), epoch=1 << 16)
        if not done.wait(60):
            print("OBS_CHILD no reply", flush=True)
            return 1
    print("OBS_CHILD " + json.dumps(out), flush=True)
    print("READY", flush=True)
    time.sleep(600)
    return 1


def _obs_child_start(flight_dir: str):
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--obs-child",
         flight_dir], cwd=ROOT, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": ROOT + os.pathsep
             + os.environ.get("PYTHONPATH", "")})


def _obs_child_finish(proc, flight_dir: str) -> dict:
    """Wait for the child's READY, SIGTERM it, and hold its dumps: the
    guard raised at step 2 with step 2's report nonfinite, the merged
    flight record with the server's replay dedup drained over
    FLIGHT_DRAIN and the worker's chaos and health events, and the
    time-series JSONL."""
    import signal
    lines: list = []
    box = {}

    def read():
        for line in proc.stdout:
            lines.append(line.strip())
            if line.strip() == "READY":
                box["ready"] = True
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(PS_TIMEOUT_S)
    try:
        if not box.get("ready"):
            fail(f"obs: the SIGTERM worker never became ready: {lines}")
        info = json.loads(next(x for x in lines
                               if x.startswith("OBS_CHILD {"))[10:])
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != -signal.SIGTERM:
        fail(f"obs: the worker ended with {proc.returncode}, not by SIGTERM")
    if info["guard_step"] != 2 or "BYTEPS_NAN_GUARD" not in info["guard"]:
        fail(f"obs: BYTEPS_CHAOS_NAN_LEAF=wq@2 did not raise at step 2: "
             f"{info}")
    rep = {s: (nf, flags) for s, nf, flags in info["reports"]}
    if rep.get(1, (None,))[0] != 0 or rep.get(2, (0, ()))[0] < 1 or \
            "nonfinite" not in (rep[2][1] or ()):
        fail(f"obs: step 2 did not latch nonfinite: {info['reports']}")
    path = os.path.join(flight_dir, f"flight-{proc.pid}.json")
    ts_path = os.path.join(flight_dir, f"timeseries-{proc.pid}.jsonl")
    if not (os.path.exists(path) and os.path.exists(ts_path)):
        fail(f"obs: SIGTERM left {os.listdir(flight_dir)}")
    doc = json.load(open(path))
    srv = [e["kind"] for e in doc["merged"] if e["source"] == "server0"]
    kinds = [e["kind"] for e in doc["worker"]["events"]]
    if doc["reason"] != "SIGTERM" or "replay_dedup" not in srv or \
            "chaos_nan_injected" not in kinds or \
            "health_nonfinite" not in kinds:
        fail(f"obs: the SIGTERM dump lacks events: server {srv}, "
             f"worker {kinds}")
    ts = [json.loads(x) for x in open(ts_path).read().splitlines()]
    if ts[0]["reason"] != "SIGTERM" or "step/wall_ms" not in \
            {x.get("name") for x in ts[1:]}:
        fail(f"obs: the SIGTERM time-series dump is wrong: {ts[0]}")
    return {"server_events": srv, "worker_events": kinds,
            "series": len(ts) - 1}


def _obs_ab(args, dev, cfg, model, attn, batch, B, S) -> dict:
    """Tokens/s of the dense PS step with BYTEPS_METRICS=0 against =1,
    each arm twice in the order 0, 1, 1, 0 on a loopback server each;
    the mean of an arm's two runs (recorded, not gated)."""
    import torch
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.training import make_ps_train_step
    on_card = dev.type == "cuda"
    out = {"0": [], "1": []}
    for metrics in ("0", "1", "1", "0"):
        with restored_env():
            os.environ["BYTEPS_METRICS"] = metrics
            with loopback_ps(dev, f"obs metrics={metrics}"):
                step = make_ps_train_step(
                    lambda b: llama.loss_fn(model.params(), b, cfg, attn),
                    torch.optim.Adam(model.parameters(), lr=1e-3),
                    model.params())
                times = []
                for i in range(OBS_STEPS):
                    if on_card:
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    bounded(lambda: float(step(batch)), f"obs A/B step {i}")
                    times.append(time.perf_counter() - t0)
                step.close()
        steady = times[1:]
        out[metrics].append(B * S / (sum(steady) / len(steady)))
    return {k: sum(v) / len(v) for k, v in out.items()} | {"runs": out}


def phase_observability(args, card: str, dev=None, cfg=None, B: int = 4,
                        S: int = 2048) -> dict:
    """The measurement plane on the PS step (``--obs-only`` runs it alone):
    Llama small() at full width, one server thread in this process and
    one ``python -m byteps_tpu_torch.server`` process (so the fleet is
    read over the wire), BYTEPS_HEALTH and BYTEPS_METRICS_PORT on;
    ``make_ps_train_step`` dense (host tier) for OBS_STEPS steps, then
    under device dithering + EF for OBS_STEPS. Gates: the ``wire/*``
    bytes equal the registry's partitions (dense) and the codecs' wires
    (dithering) exactly, and ``compress/*`` the dithering payloads'
    dense and wire bytes; a StepReport a step with a verdict, its
    ``wall_ms`` within 5% of this phase's synchronised wall of the step
    and ``compute_ms`` <= ``wall_ms``; the fleet section has both servers
    and their folded bytes sum to ``wire/push_bytes``; the ledger's peak
    comes from its table and its FLOPs are within 2% of
    ``_llama_step_flops`` (attention included); the time series hold
    every step; the dense reports' ``grad_norm`` equals
    ``torch.linalg.vector_norm`` of the aggregate in ``p.grad`` within
    1e-5 relative; ``GET /metrics`` parses, with the snapshot's counters.
    A worker process (``obs_child``) proves the NaN guard and the
    SIGTERM dumps. Recorded: tokens/s with BYTEPS_METRICS=0 against =1.
    Returns the run's launches (B1, B4 and the dequantization)."""
    import torch
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.ops import flash_attention as FA

    t_phase = time.perf_counter()
    os.environ.setdefault("BYTEPS_CLIENT_TIMEOUT_S", str(PS_TIMEOUT_S))
    dev = torch.device(dev or "cuda:0")
    on_card = dev.type == "cuda"
    cfg = cfg or llama.LlamaConfig.small()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 16)
    model = llama.Llama(cfg, device=dev, generator=gen)
    attn = FA.make_flash_attn()
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device=dev)}
    flight_dir = tempfile.mkdtemp(prefix="obs_flight_")
    child = _obs_child_start(flight_dir) if on_card else None
    try:
        return _observe(args, card, dev, cfg, model, attn, batch, B, S,
                        flight_dir, child, t_phase)
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(flight_dir, ignore_errors=True)


def _observe(args, card, dev, cfg, model, attn, batch, B, S, flight_dir,
             child, t_phase) -> dict:
    """The body of ``phase_observability``."""
    import urllib.request

    import torch
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.core.metrics import StepReport, classify_step
    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.server import run_server
    from byteps_tpu_torch.training import make_ps_train_step

    on_card = dev.type == "cuda"
    counters = _counters()
    ports = [_free_port(), _free_port()]
    mport = _free_port()
    dither = {"compressor": "dithering", "ef": "vanilla"}
    runs = {}
    with restored_env():
        os.environ.update({
            "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "2",
            "DMLC_PS_ROOT_URI": "127.0.0.1",
            "DMLC_PS_ROOT_PORT": str(ports[0]), "DMLC_ROLE": "worker",
            "BYTEPS_SERVER_HOSTS": ",".join(f"127.0.0.1:{p}" for p in ports),
            "BYTEPS_HEALTH": "1", "BYTEPS_METRICS_PORT": str(mport),
            "BYTEPS_FLIGHT_DIR": flight_dir})
        proc = _spawn_ps_server(ports[1])
        server = threading.Thread(target=run_server, args=(
            ports[0], Config(num_workers=1, num_servers=2)), daemon=True)
        server.start()
        try:
            _wait_port(ports[1])
            bps.init(device=dev)
            try:
                state = bps.get_state()
                fleet0 = bps.get_fleet_metrics()
                for label, kw in (("dense", {}), ("dithering",
                                                  {"compression": dither})):
                    step = make_ps_train_step(
                        lambda b: llama.loss_fn(model.params(), b, cfg,
                                                attn),
                        torch.optim.Adam(model.parameters(), lr=1e-3),
                        model.params(), **kw)
                    c0 = dict(bps.get_metrics()["counters"])
                    for fn in counters.values():
                        fn.launches = 0
                    walls, norms = [], []
                    for i in range(OBS_STEPS):
                        if on_card:
                            torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        loss = bounded(lambda: float(step(batch)),
                                       f"obs {label} step {i}")
                        if on_card:
                            torch.cuda.synchronize()
                        walls.append((time.perf_counter() - t0) * 1e3)
                        if not math.isfinite(loss):
                            fail(f"obs {label}: loss {loss}")
                        if label == "dense":
                            norms.append(float(torch.linalg.vector_norm(
                                torch.cat([p.grad.reshape(-1) for p in
                                           model.parameters()]),
                                dtype=torch.float64)))
                    launches = {k: fn.launches for k, fn in counters.items()}
                    c1 = dict(bps.get_metrics()["counters"])
                    if label == "dense":
                        part = sum(p.length
                                   for c in state.registry.contexts_in_order()
                                   for p in c.partitions)
                        want = {"wire/push_bytes": part * OBS_STEPS,
                                "wire/pull_bytes": part * OBS_STEPS,
                                "compress/bytes_pre": 0,
                                "compress/bytes_post": 0}
                    else:
                        plans = step.device_compressor()._plans.values()
                        wires = sum(pl.reply_len(i) for pl in plans
                                    for i in range(len(pl.codecs)))
                        pre = sum(2 * q.length for pl in plans
                                  for q, c in zip(pl.ctx.partitions,
                                                  pl.codecs) if c is not None)
                        post = sum(2 * pl.reply_len(i) for pl in plans
                                   for i, c in enumerate(pl.codecs)
                                   if c is not None)
                        want = {"wire/push_bytes": wires * OBS_STEPS,
                                "wire/pull_bytes": wires * OBS_STEPS,
                                "compress/bytes_pre": pre * OBS_STEPS,
                                "compress/bytes_post": post * OBS_STEPS}
                    got = {k: c1.get(k, 0) - c0.get(k, 0) for k in want}
                    if got != want:
                        fail(f"obs {label}: counters {got}, reckoned {want}")
                    step.close()
                    runs[label] = dict(walls=walls, norms=norms,
                                       launches=launches, counters=got)
                reports = bps.get_step_reports()
                fleet = bps.get_fleet_metrics()
                ledger = bps.get_ledger()
                series = bps.get_timeseries()
                snap = bps.get_metrics()
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{mport}/metrics",
                        timeout=30) as r:
                    prom = r.read().decode()
            finally:
                bounded(bps.shutdown, "obs shutdown")
            if proc.wait(timeout=PS_TIMEOUT_S) != 0:
                fail("obs: the server process did not exit cleanly")
            server.join(PS_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    walls = runs["dense"]["walls"] + runs["dithering"]["walls"]
    if len(reports) != 2 * OBS_STEPS:
        fail(f"obs: {len(reports)} step reports, not {2 * OBS_STEPS}")
    for r, w in zip(reports, walls):
        verdict = classify_step(StepReport(**r))
        if not verdict or not r["compute_ms"] <= r["wall_ms"] or \
                abs(r["wall_ms"] - w) > 0.05 * w:
            fail(f"obs: step {r['step']}: wall {r['wall_ms']:.1f} ms "
                 f"against the synchronised {w:.1f}, compute "
                 f"{r['compute_ms']:.1f} ms, verdict {verdict!r}")
    for r, n in zip(reports, runs["dense"]["norms"]):
        if r["grad_norm"] is None or abs(r["grad_norm"] - n) > 1e-5 * n:
            fail(f"obs: step {r['step']}: grad_norm {r['grad_norm']} "
                 f"against the aggregate's {n}")
    srv = fleet["fleet"]
    folded = sum(s["fold_bytes"] for s in srv["server"].values()) - sum(
        s["fold_bytes"] for s in fleet0["fleet"]["server"].values())
    pushed = sum(r["counters"]["wire/push_bytes"] for r in runs.values())
    if srv["source"] != "wire" or sorted(srv["server"]) != ["0", "1"] or \
            folded != pushed:
        fail(f"obs: fleet {srv['source']} {sorted(srv['server'])}: "
             f"{folded} bytes folded against {pushed} pushed")
    want_flops = _llama_step_flops(cfg, B, S)
    if ledger["source"] != "flop_counter" or not ledger["model_flops"] or \
            abs(ledger["model_flops"] - want_flops) > 0.02 * want_flops:
        fail(f"obs: the ledger counts {ledger['model_flops']} FLOPs "
             f"({ledger['source']}), the analytic count {want_flops:.6g}")
    if on_card and ledger["peak_source"] != "table":
        fail(f"obs: the ledger's peak is {ledger['peak_source']} for "
             f"{ledger['device_kind']}")
    wall_series = series["series"].get("step/wall_ms", {}).get("steps", [])
    if wall_series != [r["step"] for r in reports]:
        fail(f"obs: the time series hold steps {wall_series}")
    parsed = {}
    for line in prom.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            parsed[name] = float(value)
    for name, v in snap["counters"].items():
        pn = "byteps_" + "".join(ch if ch.isalnum() or ch == "_" else "_"
                                 for ch in name)
        if parsed.get(pn) != v:
            fail(f"obs: /metrics has {pn} {parsed.get(pn)}, the snapshot "
                 f"{v}")
    launches = {k: runs["dense"]["launches"][k]
                 + runs["dithering"]["launches"][k] for k in counters}
    if on_card and (launches["flash_attn_fwd"] == 0
                    or launches["dithering_levels"] == 0):
        fail(f"obs: a kernel of the path never launched: {launches}")
    ab = _obs_ab(args, dev, cfg, model, attn, batch, B, S)
    sig = _obs_child_finish(child, flight_dir) if child is not None else {}
    mfu = [r["mfu"] for r in reports]
    print(f"obs: {2 * OBS_STEPS} step reports on {card}; walls "
          f"{['%.1f' % r['wall_ms'] for r in reports]} ms against the "
          f"synchronised {['%.1f' % w for w in walls]}; compute "
          f"{['%.1f' % r['compute_ms'] for r in reports]} ms; verdicts "
          f"{[classify_step(StepReport(**r)) for r in reports[-2:]]}",
          flush=True)
    print(f"obs: ledger {ledger['model_flops']:.6g} FLOPs a step "
          f"(analytic {want_flops:.6g}, "
          f"{ledger['model_flops'] / want_flops - 1:+.2e}), peak "
          f"{ledger['peak_flops']:.4g} ({ledger['peak_source']}, "
          f"{ledger['device_kind']}); mfu by step "
          f"{['%.4f' % m if m is not None else None for m in mfu]}; "
          f"grad_norm {[r['grad_norm'] for r in reports[:OBS_STEPS]]} "
          f"against {runs['dense']['norms']}", flush=True)
    print(f"obs: counters {json.dumps({k: v['counters'] for k, v in runs.items()})}; "
          f"fleet {srv['source']}, {len(srv['server'])} servers, "
          f"{folded} bytes folded = pushed; /metrics {len(parsed)} series; "
          f"SIGTERM {sig}; launches {launches}", flush=True)
    print(f"obs: dense PS tokens/s with BYTEPS_METRICS=0 {ab['0']:.1f}, "
          f"=1 {ab['1']:.1f} ({ab['1'] / ab['0'] - 1:+.4f}; runs in the "
          f"order 0, 1, 1, 0: {ab['runs']}); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="profile one extra train step; trace into DIR")
    ap.add_argument("--dp2-only", action="store_true",
                    help="build, then run only the ps_dp2 phase (for a "
                         "machine with several cards); no result line")
    ap.add_argument("--zoo-only", action="store_true",
                    help="build, then run only the zoo phase; no result "
                         "line")
    ap.add_argument("--zero-only", action="store_true",
                    help="build, then run only the zero phase (its two "
                         "ranks on a machine with several cards); no "
                         "result line")
    ap.add_argument("--parallel-only", action="store_true",
                    help="build, then run only the parallel phase (over "
                         "NCCL on a machine with several cards, else over "
                         "gloo on one); no result line")
    ap.add_argument("--spmd-only", action="store_true",
                    help="build, then run only B1 at the tp shape and the "
                         "spmd phase (over NCCL on a machine with several "
                         "cards, else over gloo on one); no result line")
    ap.add_argument("--obs-only", action="store_true",
                    help="build, then run only the observability phase; "
                         "no result line")
    ap.add_argument("--obs-child", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.steps < 3:
        fail("--steps must be at least 3")
    if args.obs_child:
        return obs_child(args.obs_child)

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(ROOT, "byteps_tpu_torch", "csrc")):
        fail(f"no byteps_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    if args.dp2_only:
        phase_ps_dp2(args, card)
        return 0
    if args.zoo_only:
        phase_zoo(args, card)
        return 0
    if args.zero_only:
        phase_zero(args, card)
        return 0
    if args.parallel_only:
        phase_flash_ulysses(torch.device("cuda", 0), torch.Generator(
            device="cuda").manual_seed(args.seed))
        phase_parallel(args, card)
        return 0
    if args.spmd_only:
        phase_flash_tp(torch.device("cuda", 0), torch.Generator(
            device="cuda").manual_seed(args.seed))
        phase_spmd(args, card)
        return 0
    if args.obs_only:
        phase_observability(args, card)
        return 0
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kernels = phase_onebit(dev, gen)
    kernels.insert(0, phase_flash(dev, gen))
    kernels[0]["ulysses"] = phase_flash_ulysses(dev, gen)
    kernels[0]["tp_local"] = phase_flash_tp(dev, gen)
    kernels.extend(phase_dither(dev, gen, args.seed))
    kernels.append(phase_randomk(dev, args.seed))
    kernels.extend(phase_xla_rounding(dev, gen))
    kernels.append(phase_fused_adam(dev, gen))
    phase_small_model(dev)
    launches = phase_train(args, card)
    onebit_run = dict(launches)
    variants = phase_train_variants(args, card)
    zero = phase_zero(args, card)
    parallel = phase_parallel(args, card)
    coll = phase_collective_codecs(args, card)
    ps = phase_ps_train(args, card)
    phase_ps_host(args, card)
    dp2 = phase_ps_dp2(args, card)
    ps_topk = phase_ps_topk(args, card)
    with restored_env():
        failover = phase_ps_failover(args, card)
    adapter = phase_torch_adapter(args, card)
    adapter_2w = phase_torch_adapter_2w(args, card)
    rowsparse = phase_ps_rowsparse(args, card)
    phase_ps_host_lossless(args, card)
    phase_ps_host_varint(args, card)
    phase_native_codec(args, card)
    phase_ps_cross_barrier(args, card)
    elastic = phase_ps_elastic(args, card)
    ps_async = phase_ps_async(args, card)
    xb_dp2 = phase_ps_cross_barrier_dp2(args, card)
    zoo = {k: v["launches"] for k, v in phase_zoo(args, card).items()
           if "launches" in v}
    spmd = phase_spmd(args, card)
    obs = phase_observability(args, card)
    # each kernel's count from a path that runs it, each path's counters
    # zeroed just before it and read just after: B1 from the adapter's
    # DistributedOptimizer(Adam) run (this slice's main path; every path
    # launches it, 24 a step), B4 and the dequantization from the
    # collective dithering run and B5 from the collective randomk run
    # (collective_codecs), B2, B3, fma_scalar and xla_sum from the
    # collective onebit run
    launches["flash_attn_fwd"] = adapter["flash_attn_fwd"]
    for name in ("dithering_levels", "dithering_dequantize"):
        launches[name] = coll["dithering"][name]
    launches["randomk_indices"] = coll["randomk"]["randomk_indices"]
    # the fused Adam kernel from train_variants' fused_adam run (12 a step)
    launches["fused_adam"] = variants["fused_adam"]["fused_adam"]
    # B1 on Ulysses' path (rank 0 of the parallel phase, 24 a step), also
    # on its own beside B1's entry at that path's shape
    launches["flash_attn_fwd"] += parallel["flash_attn_fwd"]
    kernels[0]["ulysses"]["launches"] = parallel["flash_attn_fwd"]
    # B1 on the tp path's local heads (rank 0 of the spmd phase, 24 a
    # step), also on its own beside B1's entry at that path's shape
    launches["flash_attn_fwd"] += spmd["flash_attn_fwd"]
    kernels[0]["tp_local"]["launches"] = spmd["flash_attn_fwd"]
    # and the zoo's paths beside them, each counted from 0 on its own: B2,
    # B3, xla_sum and fma_scalar from BERT-large's collective onebit, B4
    # and the dequantization from VGG-16's device-tier dithering
    for path in zoo.values():
        for name, n in path.items():
            if name in launches:
                launches[name] += n
    # and the observability phase's PS runs (dense, then device
    # dithering): B1 24 a step, B4 one a dithering step and the
    # dequantization two
    for name in ("flash_attn_fwd", "dithering_levels",
                 "dithering_dequantize"):
        launches[name] += obs[name]
    print("launches by path: " + json.dumps({
        "collective onebit": onebit_run,
        "ps device tier": ps, "ps dp2 (root, shard off)": dp2[False],
        "collective codecs": coll, "ps topk": ps_topk,
        "ps failover": failover, "torch adapter": adapter,
        "torch adapter, two workers (worker 0)": adapter_2w,
        "ps rowsparse": rowsparse, "ps elastic": elastic,
        "ps async": ps_async, "ps cross-barrier dp2 (rank 0)": xb_dp2,
        "zoo": zoo, "train variants": variants, "zero": zero,
        "parallel sp_ulysses (rank 0)": parallel,
        "spmd tp (rank 0)": spmd, "observability": obs}), flush=True)
    for e in kernels:
        e["launches"] = launches[e["name"]]
    print(f"chip_smoke: every phase passed, "
          f"{time.perf_counter() - t_start:.1f} s from the start", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ulysses",
            "tp_local")
    print(json.dumps({"kernels": [{k: e[k] for k in keys if k in e}
                                  for e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

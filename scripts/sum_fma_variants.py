#!/usr/bin/env python3
"""Build variants of ``csrc/counter_rng.cu`` and time ``xla_sum`` and
``fma_scalar`` in each, on the card.

    python3 scripts/sum_fma_variants.py NAME[=[SOURCE][:NVCC_FLAGS]] ...

Each variant is a CUDA source with the C interface of the port's
``counter_rng.cu`` (that file where SOURCE is left out), compiled with the
port's nvcc flags plus its own (space-separated after the colon), for
example ``ref mine=chip_tree/x.cu other=chip_tree/y.cu:-DFLAG=1``; list
the port's own source as a variant too.
All variants build at once; each then runs in a process of its own under a
time limit, with the wrappers of ``ops/compression/kernels.py`` bound to
its library. A run holds both kernels bit for bit to their plain twins at
the embedding's length (24,576,000) and on its view one float in, then
prints the device time (CUDA-graph replay, ``chip_smoke.cuda_graph_ms``)
of the bare sum, of the onebit scale ``xla_mean(x, absolute=True)`` and of
``fma_scalar``, each beside the PyTorch call for the same function
(``torch.sum``, ``x.abs().mean()``, ``torch.addcmul``) timed in the same
process. Compare variants only within one call.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 120


def run_one(lib_path: str, name: str) -> int:
    import ctypes
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from byteps_tpu_torch.native import build
    from byteps_tpu_torch.ops.compression import kernels as K

    lib = ctypes.CDLL(lib_path)
    lib.bps_error_string.argtypes = [ctypes.c_int]
    lib.bps_error_string.restype = ctypes.c_char_p
    build.load = lambda _name: lib       # the wrappers take this variant
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = chip_smoke.EMBED_N
    base, e = (torch.randn(n + 1, generator=gen, device=dev)
               for _ in range(2))
    bad = 0
    for view, x in (("x", base[:n]), ("x[1:]", base[1:])):
        for kw in chip_smoke.XLA_SUM_MODES:
            bad += not torch.equal(K.xla_sum(x, **kw), K.xla_sum_plain(x, **kw))
        want = K.fma_f32_plain(torch.tensor(0.6, device=dev), e[:n], x)
        bad += not torch.equal(K.fma_scalar(0.6, e[:n], x), want)
    x, e = base[:n], e[:n]
    out = torch.empty_like(x)
    scale = torch.tensor(0.6, device=dev)
    ms = chip_smoke.cuda_graph_ms
    times = {
        "xla_sum": ms(lambda: K.xla_sum(x)),
        "torch.sum": ms(lambda: torch.sum(x)),
        "xla_mean(x, absolute=True)": ms(lambda: K.xla_mean(x,
                                                            absolute=True)),
        "x.abs().mean()": ms(lambda: x.abs().mean()),
        "fma_scalar": ms(lambda: K.fma_scalar(scale, e, x, out=out)),
        "torch.addcmul": ms(lambda: torch.addcmul(x, e, scale, out=out)),
    }
    print(f"{name}: {'bit-exact' if not bad else f'{bad} MISMATCHES'}; "
          + "; ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
          flush=True)
    # time against length: the slope is the streaming rate, the intercept
    # what a call costs besides (the upper levels, the launch)
    scan = []
    for m in (n // 4, n // 2, 2 * n, 4 * n):
        y = torch.randn(m, generator=gen, device=dev)
        scan.append(f"n={m}: xla_sum {ms(lambda: K.xla_sum(y)):.4f} ms, "
                    f"torch.sum {ms(lambda: torch.sum(y)):.4f} ms")
        del y
    print(f"{name}: " + "; ".join(scan), flush=True)
    return 1 if bad else 0


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--run":
        return run_one(argv[1], argv[2])
    sys.path.insert(0, ROOT)
    from byteps_tpu_torch.native import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = tempfile.mkdtemp(prefix="sum-fma-variants-")
    procs = {}
    for spec in argv:
        name, _, rest = spec.partition("=")
        source, _, flags = rest.partition(":")
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *flags.split(),
             source or build.source("counter_rng"), "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    built = []
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        print(f"== build {name}: rc {proc.returncode} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        # errors, and the registers and spills of the two kernels
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "error" in line or (
                    ("xla_sum_kernel" in line or "fma_scalar" in line)
                    and "Compiling" in line):
                print("   ", " | ".join(x.strip()[:120]
                                        for x in lines[i: i + 4]))
        if proc.returncode == 0:
            built.append((name, lib))
    rc = 0 if len(built) == len(procs) else 1
    for name, lib in built:
        try:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--run", lib, name], timeout=RUN_TIMEOUT_S)
            rc |= r.returncode
        except subprocess.TimeoutExpired:
            print(f"== run {name}: no end within {RUN_TIMEOUT_S} s")
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

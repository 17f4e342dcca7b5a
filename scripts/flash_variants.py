#!/usr/bin/env python3
"""Build variants of the flash-attention kernel and time each on the card.

    python3 scripts/flash_variants.py NAME=SOURCE[:NVCC_FLAGS] ...

Each variant is a CUDA source with the C interface of
``byteps_tpu_torch/csrc/flash_attn_fwd.cu`` (``bps_flash_fwd``), compiled
with the port's nvcc flags plus its own (space-separated after the colon).
All variants build at once; each then runs in a process of its own under a
time limit, so a variant that faults or hangs costs only itself. A run
holds its variant against the blockwise twin under the card gate (one bf16
step of the fp32 result) at the shapes of the card tests, and prints its
time at the training path's shape (B=4 S=2048 H=6 Hkv=2, causal) for
D = 128 and 64. Compare variants only within one call: list the reference
source as a variant too.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(1, 128, 1, 1, 64, False), (1, 128, 1, 1, 128, True),
          (2, 192, 4, 2, 128, True), (2, 192, 4, 2, 64, False),
          (2, 256, 6, 6, 128, True), (2, 256, 6, 1, 128, True),
          (2, 512, 4, 2, 64, True), (16, 128, 8, 1, 128, True),
          (4, 2048, 6, 2, 128, True), (4, 2048, 6, 2, 64, True)]
RUN_TIMEOUT_S = 120


def run_one(lib_path: str, name: str) -> int:
    """Gate checks and times of one built variant; non-zero if any shape
    fails the gate."""
    import ctypes
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from byteps_tpu_torch.ops import flash_attention as FA

    lib = ctypes.CDLL(lib_path)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bps_flash_fwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i,
                                  ctypes.POINTER(ctypes.c_longlong),
                                  ctypes.c_float, i, vp]
    lib.bps_error_string.restype = ctypes.c_char_p

    def fwd(q, k, v, causal):
        B, S, H, D = q.shape
        out = torch.empty_like(q)
        st = (ctypes.c_longlong * 9)(*(x for t in (q, k, v)
                                       for x in FA._strides(t)))
        err = lib.bps_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0, B,
            S, H, k.shape[2], D, st, float(np.float32(1 / np.sqrt(D))),
            int(causal), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(lib.bps_error_string(err).decode())
        return out

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    bad = 0
    for B, S, H, Hkv, D, causal in SHAPES:
        g = torch.Generator(device=dev).manual_seed(S + D)
        q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev).bfloat16()
                   for h in (H, Hkv, Hkv))
        with torch.no_grad():
            got = fwd(q, k, v, causal).float()
            ref = FA.blockwise_attention(q, k, v, causal=causal).float()
        above = int(((got - ref).abs() > 2.0 ** -7 * ref.abs() + 1e-6).sum())
        bad += above
        print(f"{name} B={B} S={S} H={H} Hkv={Hkv} D={D} causal={causal}: "
              f"{above} of {got.numel()} above one bf16 step", flush=True)
        if S == 2048:
            with torch.no_grad():
                ms = chip_smoke.cuda_ms(lambda: fwd(q, k, v, True), 50)
            print(f"{name} D={D}: {ms:.4f} ms", flush=True)
    return 1 if bad else 0


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--run":
        return run_one(argv[1], argv[2])
    sys.path.insert(0, ROOT)
    from byteps_tpu_torch.native import build
    out_dir = tempfile.mkdtemp(prefix="flash-variants-")
    procs = {}
    for spec in argv:
        name, rest = spec.split("=", 1)
        source, _, flags = rest.partition(":")
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *flags.split(), source, "-o",
             lib], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    t0 = time.perf_counter()
    built = []
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        print(f"== build {name}: rc {proc.returncode} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        for line in text.splitlines():
            if any(w in line for w in ("error", "registers", "spill",
                                       "C75")):
                print("   ", line.strip()[:200])
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

#!/usr/bin/env python3
"""The device memory each phase of ``chip_smoke.py`` leaves allocated.

    python3 scripts/phase_memory.py

Runs ``chip_smoke.py`` whole on one card (its own gates, its result
line) and, after each phase returns, collects garbage and prints
``torch.cuda.memory_allocated()``: a phase that frees what it built
leaves the figure where it found it, so a rise names the phase whose
models, optimizers or buffers outlive it.
"""

import functools
import gc
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probed(name, fn):
    import torch

    @functools.wraps(fn)
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        gc.collect()
        torch.cuda.synchronize()
        print(f"phase_memory: after {name}: "
              f"{torch.cuda.memory_allocated(0) / 1e9:.3f} GB allocated",
              flush=True)
        return out

    return run


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke

    for name in dir(chip_smoke):
        if name.startswith("phase_") and name not in ("phase_card",
                                                      "phase_build"):
            setattr(chip_smoke, name,
                    _probed(name, getattr(chip_smoke, name)))
    sys.argv = [os.path.join(ROOT, "chip_smoke.py")]
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())

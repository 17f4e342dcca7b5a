"""The parameter server: the native C++ server of ``native/ps.cc``.

Port of byteps_tpu/server/__init__.py, trimmed to ``run_server``, which
runs the server in asynchronous mode under BYTEPS_ENABLE_ASYNC (each
push folded into the weights the server holds, every pull answered at
once; ``training.make_async_ps_train_step``). The
server is ``ps.cc`` itself (engine threads, per-key stores, the
aggregation rounds, the compressed tier that decompresses, sums and
re-compresses); this module builds it with g++ at first use
(``native.build.build_ps``) and runs it. The worker-side client is
``client.py``.

    python -c "from byteps_tpu_torch.server import run_server; run_server()"
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

from ..config import Config
from ..native.build import build_ps


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.bps_server_create_dbg.restype = ctypes.c_void_p
    lib.bps_server_create_dbg.argtypes = [ctypes.c_int] * 5 + [
        ctypes.c_int64]
    lib.bps_server_run.restype = ctypes.c_int
    lib.bps_server_run.argtypes = [ctypes.c_void_p]
    lib.bps_server_destroy.argtypes = [ctypes.c_void_p]
    return lib


def run_server(port: Optional[int] = None,
               config: Optional[Config] = None) -> int:
    """Start the native PS on ``port`` (default DMLC_PS_ROOT_PORT +
    BYTEPS_SERVER_ID) and block until every worker sent SHUTDOWN. The
    native loop releases the GIL, so a daemon thread can host it."""
    config = config or Config.from_env()
    if port is None:
        port = config.scheduler_port + int(
            os.environ.get("BYTEPS_SERVER_ID", "0"))
    lib = _bind(ctypes.CDLL(build_ps()))
    # synchronous rounds (asynchronous under BYTEPS_ENABLE_ASYNC), no
    # server-side scheduling, no debug key: the modes the port's train
    # steps run
    srv = lib.bps_server_create_dbg(
        port, max(1, config.num_workers), config.server_engine_threads,
        1 if config.enable_async else 0, 0, -1)
    if not srv:
        raise RuntimeError(f"failed to create the PS server on port {port}")
    try:
        return lib.bps_server_run(srv)
    finally:
        lib.bps_server_destroy(srv)

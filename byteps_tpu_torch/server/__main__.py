"""``python -m byteps_tpu_torch.server``: run one parameter-server process
until every worker has sent SHUTDOWN. Its topology comes from the
environment (DMLC_NUM_WORKER, DMLC_PS_ROOT_PORT + BYTEPS_SERVER_ID for its
port, BYTEPS_SERVER_ENGINE_THREAD), as ``python -m byteps_tpu.server``
reads it; the BYTEPS_CHAOS_* knobs of ``native/ps.cc`` apply to it."""

import sys

from . import run_server

if __name__ == "__main__":
    sys.exit(run_server())

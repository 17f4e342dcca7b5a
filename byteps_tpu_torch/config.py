"""Environment configuration read by the PyTorch port.

Only the knobs the port reads live here, with the same names, defaults
and parsing as the JAX package's config (byteps_tpu/config.py; BytePS's
global.cc for the partition size and the compression threshold). A
boolean knob is false only at "0", "false", "off" or "no" (any case) and
true at any other value, as ``byteps_tpu.config._env_bool`` reads it.
``BYTEPS_LOG_LEVEL`` is read by ``utils/logging.py``.

The parameter-server knobs keep the reference's names, so launch tooling
carries over: DMLC_* for the topology (communicator.cc:60-96), and
BYTEPS_PARTITION_BYTES, BYTEPS_SCHEDULING_CREDIT, the key hash with its
colocated mixed mode (BYTEPS_KEY_HASH_FN, BYTEPS_ENABLE_MIXED_MODE,
BYTEPS_MIXED_MODE_BOUND) and the server's engine threads, server-side
scheduling and debug key (global.cc:134-176, server.cc:412-456). The PS
train step's host tier reads five knobs of the JAX package's own
(byteps_tpu/config.py): BYTEPS_FUSION_BYTES, BYTEPS_STREAM_EXPORT,
BYTEPS_SHARDED_APPLY, BYTEPS_LOCAL_SHARD_EXPORT and
BYTEPS_SHARD_MIN_BYTES, and BYTEPS_STAGING_ARENA switches its host
staging arena. The scheduler's wire reads three more
(byteps_tpu/config.py:171,201-202): BYTEPS_FUSED_PUSHPULL,
BYTEPS_WIRE_RETRY and BYTEPS_WIRE_BACKOFF_MS. Cross-barrier bounded
staleness reads BYTEPS_CROSS_BARRIER and BYTEPS_STALENESS
(byteps_tpu/config.py:188-189, 355-356), and the host codecs
BYTEPS_NATIVE_CODEC (``native_codec_on``; the server reads the first two
itself). The elastic fleet and the asynchronous step read
BYTEPS_RETIRED_SERVERS and BYTEPS_ENABLE_ASYNC (byteps_tpu/config.py:205,
223). The multi-process runtime of ``parallel/distributed.py`` reads
BYTEPS_NUM_PROCESS, BYTEPS_PROCESS_ID and BYTEPS_COORD_PORT
(byteps_tpu/config.py:314-316, 403-406).

The measurement plane (byteps_tpu/config.py:230-308) reads the metrics
registry's BYTEPS_METRICS, BYTEPS_METRICS_PORT, BYTEPS_STALL_DIAG and
BYTEPS_STEP_REPORTS; the push_pull byte rate's BYTEPS_TELEMETRY_ON; the
flight recorder's BYTEPS_FLIGHT_RECORDER, BYTEPS_FLIGHT_RING and
BYTEPS_FLIGHT_DIR; the time-series plane's BYTEPS_TIMESERIES and
BYTEPS_TS_POINTS; the training-health plane's BYTEPS_HEALTH,
BYTEPS_NAN_GUARD and BYTEPS_HEALTH_* (the server reads BYTEPS_HEALTH
itself); and the efficiency ledger's BYTEPS_LEDGER, BYTEPS_PEAK_FLOPS,
BYTEPS_PEAK_BW_GBPS, BYTEPS_PERF_ARCHIVE, BYTEPS_PERF_FLUSH_STEPS and
BYTEPS_EFF_DROP_*.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

# Default partition size: 4 MB (global.cc:42,134-144).
DEFAULT_PARTITION_BYTES = 4096000
# Partition lengths round to a page (global.cc:140-144).
PAGE_SIZE = 4096
# Minimum tensor size eligible for compression, in bytes (global.cc:43).
DEFAULT_MIN_COMPRESS_BYTES = 1024000
# Leaves below this many bytes fuse into one bucket key (byteps_tpu).
DEFAULT_FUSION_BYTES = 2097152
# Leaves below this many bytes keep whole-leaf keys on the locality-shard
# export (byteps_tpu).
DEFAULT_SHARD_MIN_BYTES = 65536
# The wire retry's backoff doubles per attempt up to this (byteps_tpu).
WIRE_BACKOFF_CAP_MS = 2000.0


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    # the JAX package's rule: an explicit "off" in any case is false, and
    # every other value is true
    return v.lower() not in ("0", "false", "off", "no")


def _env_str(name: str, default: str) -> str:
    v = os.environ.get(name)
    return v if v not in (None, "") else default


@dataclasses.dataclass(frozen=True)
class Config:
    # --- identity / topology ---
    role: str = "worker"                  # DMLC_ROLE: worker | server
    worker_id: int = 0                    # DMLC_WORKER_ID
    num_workers: int = 1                  # DMLC_NUM_WORKER
    num_servers: int = 0                  # DMLC_NUM_SERVER
    scheduler_uri: str = "127.0.0.1"      # DMLC_PS_ROOT_URI
    scheduler_port: int = 9000            # DMLC_PS_ROOT_PORT
    local_rank: int = 0                   # BYTEPS_LOCAL_RANK
    local_size: int = 1                   # BYTEPS_LOCAL_SIZE
    global_rank: Optional[int] = None     # BYTEPS_GLOBAL_RANK

    # --- partitioning / scheduling ---
    partition_bytes: int = DEFAULT_PARTITION_BYTES  # BYTEPS_PARTITION_BYTES
    scheduling_credit: int = 0            # BYTEPS_SCHEDULING_CREDIT (0 = off)
    key_hash_fn: str = "djb2"             # BYTEPS_KEY_HASH_FN
    # the colocated mixed mode (global.cc:566-596): the last num_workers
    # servers share a host with a worker, and a djb2 double hash under
    # the bound sends a computed share of keys to the dedicated ones
    enable_mixed_mode: bool = False       # BYTEPS_ENABLE_MIXED_MODE
    mixed_mode_bound: int = 101           # BYTEPS_MIXED_MODE_BOUND

    # --- compression ---
    min_compress_bytes: int = DEFAULT_MIN_COMPRESS_BYTES  # BYTEPS_MIN_COMPRESS_BYTES

    # --- the PS train step's host tier ---
    # leaves under this many bytes travel in one fused bucket key; the
    # rest may stream out of the backward (0: nothing fuses)
    fusion_bytes: int = DEFAULT_FUSION_BYTES  # BYTEPS_FUSION_BYTES
    # export each eligible gradient as the backward produces it
    stream_export: bool = True            # BYTEPS_STREAM_EXPORT
    # the optimizer step per leaf as its aggregate lands
    sharded_apply: bool = True            # BYTEPS_SHARDED_APPLY
    # with a dp group of more than one process: each rank pushes its own
    # 1/local_size shard of the leaves at or above
    # max(fusion_bytes, shard_min_bytes) under its own key, and the
    # drain all-gathers them (byteps_tpu/config.py:145-150)
    local_shard_export: bool = True       # BYTEPS_LOCAL_SHARD_EXPORT
    shard_min_bytes: int = DEFAULT_SHARD_MIN_BYTES  # BYTEPS_SHARD_MIN_BYTES
    # the host staging arena (core/arena.py): off, every checkout takes a
    # fresh buffer, with the same numbers
    staging_arena: bool = True            # BYTEPS_STAGING_ARENA

    # --- the wire (byteps_tpu/config.py:171,201-202) ---
    # one PUSHPULL message per partition and round; off: a PUSH, then a
    # blocking PULL (the two-op path), numerically the same
    fused_pushpull: bool = True           # BYTEPS_FUSED_PUSHPULL
    # retries of a failed wire exchange after the first attempt (0: fail
    # on the first error), and the first backoff, doubling per attempt
    # up to WIRE_BACKOFF_CAP_MS; a retry to a dead server first moves
    # that server's keys to the survivors
    wire_retry: int = 2                   # BYTEPS_WIRE_RETRY
    wire_backoff_ms: float = 50.0         # BYTEPS_WIRE_BACKOFF_MS

    # --- cross-barrier bounded staleness (the host tier's carried drain)
    # the step releases once the front half of the model has landed; the
    # tail's pull, copy and apply may drain after the next step's export,
    # at most ``staleness`` rounds of one key in flight beyond the first
    # (0: the synchronous step, bit for bit). Fused PUSHPULL only
    cross_barrier: bool = False           # BYTEPS_CROSS_BARRIER
    staleness: int = 1                    # BYTEPS_STALENESS, 0..8

    # --- the elastic fleet and asynchronous training ---
    # the server folds each push straight into the weights it holds and
    # answers every pull at once (server.cc:315-319); the workers run
    # ``make_async_ps_train_step``
    enable_async: bool = False            # BYTEPS_ENABLE_ASYNC
    # server indices retired from assignment (drained, evicted, or a
    # join whose probe failed), comma-separated: ``core/elastic.py``
    # exports them so that a suspend/resume keeps them retired, since
    # the positional host list and the client's connections cannot
    # shrink
    retired_servers: Tuple[int, ...] = ()  # BYTEPS_RETIRED_SERVERS

    # --- server (server.cc:412-456) ---
    server_engine_threads: int = 4        # BYTEPS_SERVER_ENGINE_THREAD
    # the server's own priority scheduling of its engine queues
    server_enable_schedule: bool = False  # BYTEPS_SERVER_ENABLE_SCHEDULE

    # --- the measurement plane (byteps_tpu/config.py:230-308) ---
    # BYTEPS_METRICS=0 makes every instrument op a flag check; a port > 0
    # serves /metrics (Prometheus text) and / (JSON) on 127.0.0.1; the
    # stall diagnosis logs one line a step; the step-report ring's depth
    metrics_on: bool = True               # BYTEPS_METRICS
    metrics_port: int = 0                 # BYTEPS_METRICS_PORT (0 = off)
    stall_diag: bool = False              # BYTEPS_STALL_DIAG
    step_report_window: int = 64          # BYTEPS_STEP_REPORTS
    # the push_pull byte rate of get_pushpull_speed()
    telemetry_on: bool = True             # BYTEPS_TELEMETRY_ON
    # the crash flight recorder's event ring and where it dumps
    flight_recorder: bool = True          # BYTEPS_FLIGHT_RECORDER
    flight_ring: int = 2048               # BYTEPS_FLIGHT_RING
    flight_dir: str = "./flight"          # BYTEPS_FLIGHT_DIR
    # the per-step time-series rings and their depth
    timeseries: bool = True               # BYTEPS_TIMESERIES
    ts_points: int = 512                  # BYTEPS_TS_POINTS (at least 16)
    # the training-health plane: the server's in-fold statistics and the
    # worker's drain tap and detector; nan_guard makes a nonfinite round
    # raise after the flight record is dumped
    health: bool = False                  # BYTEPS_HEALTH
    nan_guard: bool = False               # BYTEPS_NAN_GUARD
    health_window: int = 16               # BYTEPS_HEALTH_WINDOW
    health_explode_ratio: float = 10.0    # BYTEPS_HEALTH_EXPLODE_RATIO
    health_collapse_ratio: float = 0.01   # BYTEPS_HEALTH_COLLAPSE_RATIO
    health_streak: int = 2                # BYTEPS_HEALTH_STREAK
    health_drift_frac: float = 0.1        # BYTEPS_HEALTH_DRIFT_FRAC
    health_drift_keys: int = 8            # BYTEPS_HEALTH_DRIFT_KEYS
    # the step efficiency ledger: peaks (0: the device's table row), the
    # per-step JSONL archive ("" = off) and the efficiency-drop events
    ledger: bool = True                   # BYTEPS_LEDGER
    peak_flops: float = 0.0               # BYTEPS_PEAK_FLOPS (0 = auto)
    peak_bw_gbps: float = 0.0             # BYTEPS_PEAK_BW_GBPS (0 = auto)
    perf_archive: str = ""                # BYTEPS_PERF_ARCHIVE ("" = off)
    perf_flush_steps: int = 32            # BYTEPS_PERF_FLUSH_STEPS
    eff_drop_frac: float = 0.25           # BYTEPS_EFF_DROP_FRAC
    eff_drop_window: int = 16             # BYTEPS_EFF_DROP_WINDOW

    # --- the multi-process runtime (parallel/distributed.py) ---
    num_processes: int = 1                # BYTEPS_NUM_PROCESS
    process_id: int = 0                   # BYTEPS_PROCESS_ID (default: worker_id)
    coord_port: int = 0                   # BYTEPS_COORD_PORT (0 = scheduler_port + 512)

    @staticmethod
    def from_env() -> "Config":
        return Config(
            role=_env_str("DMLC_ROLE", "worker"),
            worker_id=_env_int("DMLC_WORKER_ID", 0),
            num_workers=_env_int("DMLC_NUM_WORKER", 1),
            num_servers=_env_int("DMLC_NUM_SERVER", 0),
            scheduler_uri=_env_str("DMLC_PS_ROOT_URI", "127.0.0.1"),
            scheduler_port=_env_int("DMLC_PS_ROOT_PORT", 9000),
            local_rank=_env_int("BYTEPS_LOCAL_RANK", 0),
            local_size=_env_int("BYTEPS_LOCAL_SIZE", 1),
            global_rank=(int(os.environ["BYTEPS_GLOBAL_RANK"])
                         if os.environ.get("BYTEPS_GLOBAL_RANK") else None),
            partition_bytes=_env_int("BYTEPS_PARTITION_BYTES",
                                     DEFAULT_PARTITION_BYTES),
            scheduling_credit=_env_int("BYTEPS_SCHEDULING_CREDIT", 0),
            key_hash_fn=_env_str("BYTEPS_KEY_HASH_FN", "djb2"),
            enable_mixed_mode=_env_bool("BYTEPS_ENABLE_MIXED_MODE"),
            mixed_mode_bound=_env_int("BYTEPS_MIXED_MODE_BOUND", 101),
            min_compress_bytes=_env_int("BYTEPS_MIN_COMPRESS_BYTES",
                                        DEFAULT_MIN_COMPRESS_BYTES),
            fusion_bytes=_env_int("BYTEPS_FUSION_BYTES",
                                  DEFAULT_FUSION_BYTES),
            stream_export=_env_bool("BYTEPS_STREAM_EXPORT", True),
            sharded_apply=_env_bool("BYTEPS_SHARDED_APPLY", True),
            local_shard_export=_env_bool("BYTEPS_LOCAL_SHARD_EXPORT", True),
            shard_min_bytes=_env_int("BYTEPS_SHARD_MIN_BYTES",
                                     DEFAULT_SHARD_MIN_BYTES),
            staging_arena=_env_bool("BYTEPS_STAGING_ARENA", True),
            fused_pushpull=_env_bool("BYTEPS_FUSED_PUSHPULL", True),
            wire_retry=_env_int("BYTEPS_WIRE_RETRY", 2),
            wire_backoff_ms=float(_env_str("BYTEPS_WIRE_BACKOFF_MS", "50")),
            cross_barrier=_env_bool("BYTEPS_CROSS_BARRIER"),
            staleness=max(0, min(8, _env_int("BYTEPS_STALENESS", 1))),
            enable_async=_env_bool("BYTEPS_ENABLE_ASYNC"),
            retired_servers=tuple(
                int(tok) for tok in
                os.environ.get("BYTEPS_RETIRED_SERVERS", "").split(",")
                if tok.strip()),
            server_engine_threads=_env_int("BYTEPS_SERVER_ENGINE_THREAD", 4),
            server_enable_schedule=_env_bool("BYTEPS_SERVER_ENABLE_SCHEDULE"),
            metrics_on=_env_bool("BYTEPS_METRICS", True),
            metrics_port=_env_int("BYTEPS_METRICS_PORT", 0),
            stall_diag=_env_bool("BYTEPS_STALL_DIAG"),
            step_report_window=_env_int("BYTEPS_STEP_REPORTS", 64),
            telemetry_on=_env_bool("BYTEPS_TELEMETRY_ON", True),
            flight_recorder=_env_bool("BYTEPS_FLIGHT_RECORDER", True),
            flight_ring=_env_int("BYTEPS_FLIGHT_RING", 2048),
            flight_dir=_env_str("BYTEPS_FLIGHT_DIR", "./flight"),
            timeseries=_env_bool("BYTEPS_TIMESERIES", True),
            ts_points=max(16, _env_int("BYTEPS_TS_POINTS", 512)),
            health=_env_bool("BYTEPS_HEALTH"),
            nan_guard=_env_bool("BYTEPS_NAN_GUARD"),
            health_window=_env_int("BYTEPS_HEALTH_WINDOW", 16),
            health_explode_ratio=float(
                _env_str("BYTEPS_HEALTH_EXPLODE_RATIO", "10")),
            health_collapse_ratio=float(
                _env_str("BYTEPS_HEALTH_COLLAPSE_RATIO", "0.01")),
            health_streak=_env_int("BYTEPS_HEALTH_STREAK", 2),
            health_drift_frac=float(
                _env_str("BYTEPS_HEALTH_DRIFT_FRAC", "0.1")),
            health_drift_keys=_env_int("BYTEPS_HEALTH_DRIFT_KEYS", 8),
            ledger=_env_bool("BYTEPS_LEDGER", True),
            peak_flops=float(_env_str("BYTEPS_PEAK_FLOPS", "0")),
            peak_bw_gbps=float(_env_str("BYTEPS_PEAK_BW_GBPS", "0")),
            perf_archive=_env_str("BYTEPS_PERF_ARCHIVE", ""),
            perf_flush_steps=_env_int("BYTEPS_PERF_FLUSH_STEPS", 32),
            eff_drop_frac=float(_env_str("BYTEPS_EFF_DROP_FRAC", "0.25")),
            eff_drop_window=_env_int("BYTEPS_EFF_DROP_WINDOW", 16),
            num_processes=_env_int("BYTEPS_NUM_PROCESS", 1),
            process_id=_env_int("BYTEPS_PROCESS_ID",
                                _env_int("DMLC_WORKER_ID", 0)),
            coord_port=_env_int("BYTEPS_COORD_PORT", 0),
        )


def native_codec_on() -> bool:
    """BYTEPS_NATIVE_CODEC (on unless "0"): onebit, topk, randomk and
    default dithering through the C++ codec of native/ps.cc
    (ops/compression/native.py), else numpy. Read as each host codec is
    made: the codecs are made per partition, also outside ``init``."""
    return os.environ.get("BYTEPS_NATIVE_CODEC", "1") != "0"

"""The parameter server: the native C++ server of ``native/ps.cc``, and
the in-process stats mirror.

Port of byteps_tpu/server/__init__.py. ``run_server`` builds ``ps.cc``
with g++ at first use (``native.build.build_ps``) and runs it: engine
threads, per-key stores, the aggregation rounds, the compressed tier
that decompresses, sums and re-compresses, the asynchronous mode that
``training.make_async_ps_train_step`` runs against. The worker-side
client is ``client.py``.

A server that runs inside this interpreter (the loopback topology of the
tests and of ``chip_smoke.py``) registers its native handle in ``_live``
while it serves, so that ``stage_stats``, ``per_server_stats``,
``key_health``, ``engine_stats`` and ``per_conn_stripe_stats`` read its
data-plane counters (recv, queue-wait, fold and reply walls, the fold's
bytes, the training-health pass's rounds) with a ctypes call; a server
in another process answers the same slot vector over the STATS_PULL
control op (``PSClient.server_stats``). ``_STAT_SLOTS`` names the slots
of ``bps_server_stats`` in the order of ``ps.cc``'s ``kStatSlotNames``
(``native_stat_slot_names`` reads the loaded library's), and
``parse_stat_slots`` is the one parser of both.

    python -c "from byteps_tpu_torch.server import run_server; run_server()"
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Dict, List, Optional

from ..config import Config, _env_bool
from ..native.build import build_ps

# native handles of servers currently serving IN THIS PROCESS
# (run_server registers around its blocking Run); remote/subprocess
# servers are invisible here by construction — their counters belong to
# their own process's snapshot
_live_mu = threading.Lock()
_live: list = []  # [(lib, ptr), ...]; every access under _live_mu

# bps_server_stats / STATS_PULL slot layout: the append-only contract
# with native/ps.cc kStatSlotNames (a test holds the two equal); the same
# vector answers the STATS_PULL wire op, so this mirror parses a remote
# server's snapshot too.
_STAT_SLOTS = (
    "recv_ns", "recv_count", "queue_ns", "queue_count", "fold_ns",
    "fold_count", "fold_bytes", "reply_ns", "reply_count",
    "direct_recvs", "oob_msgs", "simd_tier", "engine_threads",
    "trace_records", "trace_dropped", "flight_records",
    "flight_dropped", "draining", "health_rounds", "health_nonfinite",
    "window_deferred", "window_rejected",
    # the wire plane: reply-batch ring (tx_batches/tx_msgs: msgs per
    # batch > 1 proves per-message sends retired), staged recv buffer
    # (rx_batches/rx_msgs), stripe reassembly (segments/payload bytes),
    # fused lossless decode-into-fold, and transport block registration
    "tx_batches", "tx_msgs", "rx_batches", "rx_msgs", "stripe_segs",
    "stripe_bytes", "fused_decode_folds", "reg_blocks", "reg_miss",
)

# Wire-sampled trace record (native/ps.cc TraceRec, drained over the
# TRACE_DRAIN control op). Field order and packing are wire contract.
# kind 0 = request span (t0 recv, t1 enqueue, t2 dequeue/fold start,
# t3 handler done), kind 1 = reply send (t0 = send instant).
TRACE_REC_FMT = "<QQQQQIHBB"
TRACE_REC_BYTES = 48
_TRACE_REC_FIELDS = (
    "key", "t0", "t1", "t2", "t3", "rid", "sender", "op", "kind",
)
assert struct.calcsize(TRACE_REC_FMT) == TRACE_REC_BYTES

# Server-side flight-recorder record (native/ps.cc FlightRec, drained
# over FLIGHT_DRAIN — a SNAPSHOT read: polls never steal the events a
# crash dump needs). Wire contract, like the trace record.
FLIGHT_REC_FMT = "<QQQIHBB"
FLIGHT_REC_BYTES = 32
_FLIGHT_REC_FIELDS = (
    "ts_ns", "key", "detail", "rid", "sender", "kind", "pad",
)
assert struct.calcsize(FLIGHT_REC_FMT) == FLIGHT_REC_BYTES

# Per-key training-health record (native/ps.cc HealthRec, answered over
# the HEALTH_PULL control op and mirrored in-process by
# ``bps_server_key_health``). The two doubles (sum of squares / abs-max
# over the FINITE elements of the last published aggregate) travel as
# IEEE-754 bit patterns in u64 fields so the record stays fixed-width;
# ``parse_health_rec`` reassembles them.
HEALTH_REC_FMT = "<QQQQQQ"
HEALTH_REC_BYTES = 48
_HEALTH_REC_FIELDS = (
    "key", "round", "sumsq_bits", "absmax_bits", "nonfinite", "elems",
)
assert struct.calcsize(HEALTH_REC_FMT) == HEALTH_REC_BYTES

# Per-conn / per-data-lane wire-counter record (native/ps.cc StripeRec,
# answered over the STRIPE_PULL control op and mirrored in-process by
# ``bps_server_stripe_stats``) — the time-series plane's de-aggregated
# stripe source: one record per live connection, counters CUMULATIVE
# since accept (readers difference them into per-stripe series).
# sender is ~0 (2**64-1) until the lane's first message identifies its
# worker. Wire contract, like the trace record.
STRIPE_REC_FMT = "<QQQQQQQQ"
STRIPE_REC_BYTES = 64
_STRIPE_REC_FIELDS = (
    "conn", "sender", "tx_bytes", "tx_msgs", "rx_bytes", "rx_msgs",
    "seg_count", "seg_bytes",
)
assert struct.calcsize(STRIPE_REC_FMT) == STRIPE_REC_BYTES


def parse_stripe_recs(raw: bytes) -> List[Dict[str, int]]:
    """Packed StripeRec[] -> list of per-lane dicts — THE one parser
    for the STRIPE_PULL wire reply and the in-process mirror. Returns
    [] on a length mismatch (oversized/truncated reply)."""
    if not raw or len(raw) % STRIPE_REC_BYTES:
        return []
    return [dict(zip(_STRIPE_REC_FIELDS, vals))
            for vals in struct.iter_unpack(STRIPE_REC_FMT, raw)]


def parse_health_rec(raw: bytes) -> Optional[Dict[str, float]]:
    """One packed HealthRec -> dict with the doubles reassembled
    (None on a length mismatch) — THE one parser for the wire reply
    and the in-process mirror."""
    if len(raw) != HEALTH_REC_BYTES:
        return None
    vals = dict(zip(_HEALTH_REC_FIELDS, struct.unpack(HEALTH_REC_FMT,
                                                      raw)))
    out = {
        "key": vals["key"], "round": vals["round"],
        "sumsq": struct.unpack(
            "<d", struct.pack("<Q", vals["sumsq_bits"]))[0],
        "absmax": struct.unpack(
            "<d", struct.pack("<Q", vals["absmax_bits"]))[0],
        "nonfinite": vals["nonfinite"], "elems": vals["elems"],
    }
    return out

# native/ps.cc enum FlightKind — event names for the merged dump
FLIGHT_KIND_NAMES = {
    1: "replay_dedup", 2: "codec_reject", 3: "chaos_drop",
    4: "worker_departed", 5: "pull_abort", 6: "unknown_op",
    7: "round_skew", 8: "drained",
}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.bps_server_create_dbg.restype = ctypes.c_void_p
    lib.bps_server_create_dbg.argtypes = [ctypes.c_int] * 5 + [
        ctypes.c_int64]
    lib.bps_server_run.argtypes = [ctypes.c_void_p]
    lib.bps_server_destroy.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "bps_server_stats"):
        # guarded: a stale .so predating the stats ABI must still serve
        lib.bps_server_stats.restype = ctypes.c_int
        lib.bps_server_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int]
        lib.bps_server_engine_bytes.restype = ctypes.c_int
        lib.bps_server_engine_bytes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int]
    if hasattr(lib, "bps_server_stat_name"):
        # runtime view of the slot-layout manifest (guarded: stale .so)
        lib.bps_server_stat_name.restype = ctypes.c_char_p
        lib.bps_server_stat_name.argtypes = [ctypes.c_int]
        lib.bps_server_stat_count.restype = ctypes.c_int
        lib.bps_server_stat_count.argtypes = []
    if hasattr(lib, "bps_server_key_health"):
        # training-health in-process mirror (guarded: stale .so)
        lib.bps_server_key_health.restype = ctypes.c_int
        lib.bps_server_key_health.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64)]
    if hasattr(lib, "bps_server_stripe_stats"):
        # per-lane wire counters, in-process mirror (guarded: stale .so)
        lib.bps_server_stripe_stats.restype = ctypes.c_int
        lib.bps_server_stripe_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int]
        lib.bps_server_stripe_field.restype = ctypes.c_char_p
        lib.bps_server_stripe_field.argtypes = [ctypes.c_int]
        lib.bps_server_stripe_field_count.restype = ctypes.c_int
        lib.bps_server_stripe_field_count.argtypes = []
    return lib


def native_stat_slot_names() -> List[str]:
    """The loaded library's slot-name manifest (empty on a stale .so):
    a test holds it equal to ``_STAT_SLOTS``, the mirror that parses
    it."""
    lib = _bind(ctypes.CDLL(build_ps()))
    if not hasattr(lib, "bps_server_stat_name"):
        return []
    return [lib.bps_server_stat_name(i).decode()
            for i in range(lib.bps_server_stat_count())]


def native_stripe_field_names() -> List[str]:
    """The LOADED .so's stripe-record field manifest (empty on a stale
    .so), to hold against ``_STRIPE_REC_FIELDS``."""
    lib = _bind(ctypes.CDLL(build_ps()))
    if not hasattr(lib, "bps_server_stripe_field"):
        return []
    return [lib.bps_server_stripe_field(i).decode()
            for i in range(lib.bps_server_stripe_field_count())]


def per_conn_stripe_stats() -> List[List[Dict[str, int]]]:
    """Per-conn / per-data-lane wire counters from the live IN-PROCESS
    servers: one list of lane record dicts (``_STRIPE_REC_FIELDS``
    keys) per server, registration order — the local half of the
    time-series plane's stripe source (remote fleets answer the same
    records over STRIPE_PULL, ``PSClient.stripe_stats``)."""
    out: List[List[Dict[str, int]]] = []
    n_fields = len(_STRIPE_REC_FIELDS)
    max_recs = 64  # native kCtrlStripeMax
    buf = (ctypes.c_uint64 * (max_recs * n_fields))()
    with _live_mu:  # see stage_stats: excludes a concurrent destroy
        for lib, ptr in _live:
            if not hasattr(lib, "bps_server_stripe_stats"):
                continue
            n = lib.bps_server_stripe_stats(ptr, buf, max_recs)
            out.append([
                dict(zip(_STRIPE_REC_FIELDS,
                         [int(buf[r * n_fields + f])
                          for f in range(n_fields)]))
                for r in range(n)])
    return out


def parse_stat_slots(raw) -> Dict[str, int]:
    """u64 slot vector (ctypes array, bytes, or int sequence) ->
    name->value dict under the append-only ``_STAT_SLOTS`` contract —
    THE one parser for both the in-process mirror and the STATS_PULL
    wire reply."""
    if isinstance(raw, (bytes, bytearray, memoryview)):
        raw = struct.unpack(f"<{len(raw) // 8}Q", bytes(raw))
    out = {k: 0 for k in _STAT_SLOTS}
    for i, v in enumerate(raw):
        if i >= len(_STAT_SLOTS):
            break  # newer server: trailing slots unknown to this mirror
        out[_STAT_SLOTS[i]] = int(v)
    return out


def derive_stage_section(raw: Dict[str, int]) -> Dict[str, float]:
    """Raw slot dict -> the documented ms-derived ``server``-section
    shape (shared by the in-process section and the per-server entries
    of ``bps.get_fleet_metrics()``, so the two surfaces can't drift)."""
    return {
        "recv_ms": raw["recv_ns"] / 1e6,
        "recv_count": raw["recv_count"],
        "queue_wait_ms": raw["queue_ns"] / 1e6,
        "queue_count": raw["queue_count"],
        "fold_ms": raw["fold_ns"] / 1e6,
        "fold_count": raw["fold_count"],
        "fold_bytes": raw["fold_bytes"],
        "reply_ms": raw["reply_ns"] / 1e6,
        "reply_count": raw["reply_count"],
        "direct_recvs": raw["direct_recvs"],
        "oob_msgs": raw["oob_msgs"],
        "simd_tier": raw["simd_tier"],
        "engine_threads": raw["engine_threads"],
        "trace_records": raw["trace_records"],
        "trace_dropped": raw["trace_dropped"],
        "flight_records": raw["flight_records"],
        "flight_dropped": raw["flight_dropped"],
        "draining": raw["draining"],
        "health_rounds": raw["health_rounds"],
        "health_nonfinite": raw["health_nonfinite"],
        "window_deferred": raw["window_deferred"],
        "window_rejected": raw["window_rejected"],
        "tx_batches": raw["tx_batches"],
        "tx_msgs": raw["tx_msgs"],
        "rx_batches": raw["rx_batches"],
        "rx_msgs": raw["rx_msgs"],
        "stripe_segs": raw["stripe_segs"],
        "stripe_bytes": raw["stripe_bytes"],
        "fused_decode_folds": raw["fused_decode_folds"],
        "reg_blocks": raw["reg_blocks"],
        "reg_miss": raw["reg_miss"],
    }


def stage_stats() -> Dict[str, int]:
    """Raw per-stage counters summed over every live in-process server
    (zeros when none — remote fleets export from their own process).
    ``simd_tier``/``engine_threads`` report the max across servers (one
    topology per process in practice)."""
    out = {k: 0 for k in _STAT_SLOTS}
    buf = (ctypes.c_uint64 * len(_STAT_SLOTS))()
    # the native calls run UNDER _live_mu: run_server destroys its
    # handle under the same lock, so a metrics poll racing a server
    # shutdown reads live-or-absent, never freed (use-after-free)
    with _live_mu:
        n_live = len(_live)
        for lib, ptr in _live:
            if not hasattr(lib, "bps_server_stats"):
                continue
            n = lib.bps_server_stats(ptr, buf, len(_STAT_SLOTS))
            for i in range(n):
                k = _STAT_SLOTS[i]
                if k in ("simd_tier", "engine_threads"):
                    out[k] = max(out[k], int(buf[i]))
                else:
                    out[k] += int(buf[i])
    out["live"] = n_live
    return out


def per_server_stats() -> List[Dict[str, int]]:
    """One raw slot dict per live IN-PROCESS server, in registration
    order — the local half of the fleet snapshot (remote/subprocess
    servers answer the same vector over the STATS_PULL control op)."""
    out: List[Dict[str, int]] = []
    buf = (ctypes.c_uint64 * len(_STAT_SLOTS))()
    with _live_mu:  # see stage_stats: excludes a concurrent destroy
        for lib, ptr in _live:
            if not hasattr(lib, "bps_server_stats"):
                continue
            n = lib.bps_server_stats(ptr, buf, len(_STAT_SLOTS))
            out.append(parse_stat_slots([buf[i] for i in range(n)]))
    return out


def key_health(key: int) -> Optional[Dict[str, float]]:
    """Per-key post-aggregation health statistics from the live
    IN-PROCESS servers (the loopback test/bench topology): the first
    server owning the key answers. None when no server holds the key
    or the health pass (BYTEPS_HEALTH) is off — remote fleets answer
    the same record over the HEALTH_PULL control op
    (``PSClient.health_pull``)."""
    buf = (ctypes.c_uint64 * 5)()
    with _live_mu:  # see stage_stats: excludes a concurrent destroy
        for lib, ptr in _live:
            if not hasattr(lib, "bps_server_key_health"):
                continue
            if lib.bps_server_key_health(ptr, int(key), buf) == 0:
                raw = struct.pack(
                    HEALTH_REC_FMT, int(key),
                    *[int(buf[i]) for i in range(5)])
                return parse_health_rec(raw)
    return None


def engine_stats() -> List[List[int]]:
    """Cumulative queued payload bytes per engine thread, one list per
    live in-process server (the byte-weighted key-to-engine placement's
    balance)."""
    out: List[List[int]] = []
    buf = (ctypes.c_uint64 * 64)()
    with _live_mu:  # see stage_stats: excludes a concurrent destroy
        for lib, ptr in _live:
            if not hasattr(lib, "bps_server_engine_bytes"):
                continue
            n = lib.bps_server_engine_bytes(ptr, buf, 64)
            out.append([int(buf[i]) for i in range(n)])
    return out


def stage_section() -> Dict[str, float]:
    """The ``server`` section of ``get_metrics()``: per-stage walls in
    milliseconds plus counts, the fold-byte total, zero-copy tier
    engagement, the active SIMD tier, and how many servers are live in
    this process. The keys are fixed whether or not a server is local."""
    raw = stage_stats()
    out = derive_stage_section(raw)
    out["live"] = raw["live"]
    return out


def run_server(port: Optional[int] = None,
               config: Optional[Config] = None) -> int:
    """Start the native PS on ``port`` (default DMLC_PS_ROOT_PORT +
    BYTEPS_SERVER_ID) and block until every worker sent SHUTDOWN. The
    native loop releases the GIL, so a daemon thread can host it; while
    it serves, its handle is in ``_live`` for the in-process stats. The
    server runs asynchronous rounds under BYTEPS_ENABLE_ASYNC, schedules
    its engine queues under BYTEPS_SERVER_ENABLE_SCHEDULE, and prints each
    stage's values of one key under BYTEPS_SERVER_DEBUG (the key
    BYTEPS_SERVER_DEBUG_KEY, default 0; server.cc:120-144, 439-442)."""
    config = config or Config.from_env()
    if port is None:
        server_id = int(os.environ.get("BYTEPS_SERVER_ID", "0"))
        port = config.scheduler_port + server_id
    lib = _bind(ctypes.CDLL(build_ps()))
    debug_key = -1
    if _env_bool("BYTEPS_SERVER_DEBUG", False):
        debug_key = int(os.environ.get("BYTEPS_SERVER_DEBUG_KEY", "0"))
    srv = lib.bps_server_create_dbg(
        port, max(1, config.num_workers), config.server_engine_threads,
        1 if config.enable_async else 0,
        1 if config.server_enable_schedule else 0,
        debug_key)
    entry = (lib, srv)
    with _live_mu:
        _live.append(entry)
    try:
        rc = lib.bps_server_run(srv)
    finally:
        # unregister AND destroy under the lock: stage_stats() /
        # engine_stats() read the handle under _live_mu, so destroying
        # outside it would free a pointer a poll is mid-read on
        with _live_mu:
            try:
                _live.remove(entry)
            except ValueError:
                pass
            lib.bps_server_destroy(srv)
    return rc

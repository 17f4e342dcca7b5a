"""The elastic PS fleet: a server joined at run time, a server drained.

Port of byteps_tpu/core/elastic.py. Each operation is a routing change
of the registry's one plan engine (``core/registry.py``
``RebalancePlan``), fenced by the routing version:

- ``join_server``: the client connects the new server, the JOIN_PROBE
  handshake checks its worker count and that it is not draining before
  any key routes there, and ``plan_join`` moves the earliest-declared
  partitions of the most-loaded servers onto it;
- ``drain_server``: ``plan_drain`` moves every partition of the server to
  the least-loaded survivors and retires it; the DRAIN_REQ acknowledgement
  is asked for afterwards and gates nothing.

The JAX package's ``evict_server`` (a drain that its autoscaler triggers)
waits for that autoscaler (ROADMAP.md A13).

Before a plan applies, its keys must have no queued, in-flight or
parked round (``scheduler.keys_idle``): a round still on the wire, such
as one a cross-barrier step carries, lands on its old server first. The
moved keys leave the client's init cache, so their next round's
``ensure_init`` makes their store on the new server (the init barrier of
every worker). A key of a host codec then self-heals in one retried
round (its first push meets a store with no codec, and the retry
re-installs it); a key of the PS device tier is refused, as in the JAX
package (ROADMAP.md §C).

Call these from the training thread between steps. Every worker of a
fleet makes the same call at the same step boundary: the plans depend
only on the declarations and the loads, so each computes the same one.
Each event goes to the flight record (``server_join``,
``server_drain``, ``key_migration``), and
``_export_topology_env`` writes the fleet back into DMLC_NUM_SERVER,
BYTEPS_SERVER_HOSTS and BYTEPS_RETIRED_SERVERS, so that a later
``suspend``/``resume`` reconnects the whole fleet and keeps the retired
slots retired.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

from ..utils.logging import log
from . import flight

# the moving keys must settle within this, polled at this period
_QUIESCE_TIMEOUT_S = 30.0
_QUIESCE_POLL_S = 0.02


def _quiesce(scheduler, keys: List[int], what: str,
             timeout_s: float = _QUIESCE_TIMEOUT_S) -> None:
    if scheduler is None or not keys:
        return
    deadline = time.monotonic() + timeout_s
    while not scheduler.keys_idle(keys):
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"{what}: keys {keys[:8]}... never went quiescent within "
                f"{timeout_s:.0f}s — call from the training thread "
                f"between steps (in-flight rounds must settle before the "
                f"routing table moves under them)")
        time.sleep(_QUIESCE_POLL_S)


def _export_topology_env(state) -> None:
    """The live fleet into the environment that ``Config.from_env``
    reads at a resume: the server count, the address list (positional,
    it only grows) and the retired slots."""
    client, registry = state.ps_client, state.registry
    os.environ["DMLC_NUM_SERVER"] = str(state.config.num_servers)
    if client is not None:
        os.environ["BYTEPS_SERVER_HOSTS"] = ",".join(client.servers)
    retired = registry.dead_servers() if registry is not None else []
    if retired:
        os.environ["BYTEPS_RETIRED_SERVERS"] = ",".join(map(str, retired))
    else:
        os.environ.pop("BYTEPS_RETIRED_SERVERS", None)


def join_server(state, address: Optional[str] = None) -> int:
    """Bring a server started at run time into the fleet and move keys
    onto it; returns its index. ``address`` defaults to
    ``scheduler_uri:scheduler_port + index``. Order: connect, probe (a
    failed or refused probe raises, and its slot is retired unused so
    that the next join's index aligns), grow the registry, then plan,
    quiesce and apply, re-planning up to 3 times on a stale fence."""
    client, registry = state.ps_client, state.registry
    if client is None or registry is None:
        raise RuntimeError("join_server: no PS client (init with "
                           "num_servers > 0 first)")
    cfg = state.config
    new_idx = cfg.num_servers
    if address is None:
        address = f"{cfg.scheduler_uri}:{cfg.scheduler_port + new_idx}"
    got = client.add_server(address)
    if got != new_idx:
        raise RuntimeError(
            f"join_server: native client connected {address!r} at index "
            f"{got}, expected {new_idx} — client/registry server tables "
            f"have diverged")
    try:
        probe = client.join_probe(new_idx)
        if probe is None:
            raise RuntimeError(
                f"join_server: server {new_idx} at {address!r} did not "
                f"answer the JOIN_PROBE handshake")
        want = max(1, cfg.num_workers)
        if probe["num_workers"] != want:
            raise RuntimeError(
                f"join_server: server at {address!r} runs num_workers="
                f"{probe['num_workers']}, this fleet has {want} — refusing "
                f"the join (its aggregation rounds would never complete)")
        if probe["draining"]:
            raise RuntimeError(
                f"join_server: server at {address!r} is draining — "
                f"refusing to route keys to a retiring server")
    except Exception:
        # the client's table cannot shrink: the slot is accounted for
        # and retired, no key ever routes there, the next join aligns
        abandoned = registry.add_server()
        registry.retire_server(abandoned)
        state.config = dataclasses.replace(cfg, num_servers=abandoned + 1)
        _export_topology_env(state)
        log.warning("elastic: join of %s failed after the connect — server "
                    "index %d retired unused", address, abandoned)
        raise
    ridx = registry.add_server()
    if ridx != new_idx:
        raise RuntimeError(
            f"join_server: registry grew to index {ridx}, client to "
            f"{new_idx} — server tables have diverged")
    state.config = dataclasses.replace(cfg, num_servers=new_idx + 1)
    # the server is in the fleet from here, whatever the rebalance does
    _export_topology_env(state)
    moved: List[int] = []
    for attempt in range(3):
        plan = registry.plan_join(new_idx)
        try:
            _quiesce(state.scheduler, plan.keys(), "join_server")
        except TimeoutError as e:
            flight.record("server_join", key=new_idx,
                          detail=f"addr={address} moved_keys=0 "
                                 f"quiesce_timeout=1")
            raise RuntimeError(
                f"join_server: server {new_idx} at {address!r} JOINED "
                f"(connected, probed, assignable to new keys) but no "
                f"existing key moved onto it: {e}") from e
        try:
            moved = registry.rebalance(plan)
            break
        except RuntimeError as e:
            # a failover moved the table while the keys settled
            if "stale rebalance plan" not in str(e) or attempt == 2:
                raise
            log.info("elastic: join rebalance raced a routing change (%s); "
                     "recomputing the plan", e)
    client.invalidate_init(moved)
    _export_topology_env(state)
    flight.record("server_join", key=new_idx,
                  detail=f"addr={address} moved_keys={len(moved)} "
                         f"routing_version={registry.routing_version}")
    for k in moved:
        flight.record("key_migration", key=k,
                      detail=f"to_server={new_idx} trigger=join")
    log.info("elastic: server %d joined at %s; %d key(s) re-homed to it "
             "(routing_version=%d)", new_idx, address, len(moved),
             registry.routing_version)
    return new_idx


def drain_server(state, server: int) -> List[int]:
    """Move every key of ``server`` to the survivors and retire it;
    returns the moved keys. The server process keeps running and holds
    nothing afterwards: stop it at leisure."""
    client, registry = state.ps_client, state.registry
    if client is None or registry is None:
        raise RuntimeError("drain_server: no PS client")
    plan = registry.plan_drain(server)
    _quiesce(state.scheduler, plan.keys(), "drain_server")
    moved = registry.rebalance(plan)
    client.invalidate_init(moved)
    _export_topology_env(state)
    try:
        ack = client.drain_req(server, timeout_s=2)
    except Exception:  # noqa: BLE001 - the acknowledgement gates nothing
        ack = None
    flight.record("server_drain", key=server,
                  detail=f"moved_keys={len(moved)} ack={ack is not None} "
                         f"routing_version={registry.routing_version}")
    for k in moved:
        flight.record("key_migration", key=k,
                      detail=f"from_server={server} trigger=drain")
    log.warning("elastic: server %d drained; %d key(s) migrated to "
                "survivors (routing_version=%d, drain ack=%s)", server,
                len(moved), registry.routing_version, ack)
    return moved

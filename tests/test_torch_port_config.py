"""The port's configuration and routing knobs against the JAX package.

- ``Config.from_env()`` of both packages reads the same boolean knobs
  alike, whatever the value (the JAX rule: false only at "0", "false",
  "off" or "no", in any case);
- the colocated mixed mode (BYTEPS_ENABLE_MIXED_MODE,
  BYTEPS_MIXED_MODE_BOUND) puts every partition on the server the JAX
  registry puts it on, and refuses the topologies the JAX registry
  refuses;
- the measurement plane's knobs have the JAX package's defaults and
  parsing.
"""

import pytest

from byteps_tpu.config import Config as JConfig
from byteps_tpu.core.registry import TensorRegistry as JRegistry
from byteps_tpu_torch.config import Config
from byteps_tpu_torch.core.registry import TensorRegistry

BOOL_KNOBS = {
    "BYTEPS_ENABLE_ASYNC": "enable_async",
    "BYTEPS_CROSS_BARRIER": "cross_barrier",
    "BYTEPS_STREAM_EXPORT": "stream_export",
    "BYTEPS_FUSED_PUSHPULL": "fused_pushpull",
    "BYTEPS_LOCAL_SHARD_EXPORT": "local_shard_export",
    "BYTEPS_SHARDED_APPLY": "sharded_apply",
}
VALUES = ("2", "y", "enabled", "none", "1", "TRUE", "no", "0")


@pytest.mark.parametrize("value", VALUES)
@pytest.mark.parametrize("var", sorted(BOOL_KNOBS))
def test_bool_knob_reads_as_in_jax(var, value, monkeypatch):
    for v in BOOL_KNOBS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv(var, value)
    field = BOOL_KNOBS[var]
    want = getattr(JConfig.from_env(), field)
    assert getattr(Config.from_env(), field) is want
    # and the JAX rule itself: only an explicit "off" is false
    assert want is (value.lower() not in ("0", "false", "off", "no"))


# the measurement plane's knobs, each set to a value off its default
PLANE_KNOBS = {
    "BYTEPS_METRICS": ("metrics_on", "0"),
    "BYTEPS_METRICS_PORT": ("metrics_port", "9123"),
    "BYTEPS_STALL_DIAG": ("stall_diag", "1"),
    "BYTEPS_STEP_REPORTS": ("step_report_window", "7"),
    "BYTEPS_TELEMETRY_ON": ("telemetry_on", "off"),
    "BYTEPS_FLIGHT_RECORDER": ("flight_recorder", "no"),
    "BYTEPS_FLIGHT_RING": ("flight_ring", "99"),
    "BYTEPS_FLIGHT_DIR": ("flight_dir", "/tmp/fl"),
    "BYTEPS_TIMESERIES": ("timeseries", "0"),
    "BYTEPS_TS_POINTS": ("ts_points", "3"),
    "BYTEPS_HEALTH": ("health", "1"),
    "BYTEPS_NAN_GUARD": ("nan_guard", "yes"),
    "BYTEPS_HEALTH_WINDOW": ("health_window", "5"),
    "BYTEPS_HEALTH_EXPLODE_RATIO": ("health_explode_ratio", "3.5"),
    "BYTEPS_HEALTH_COLLAPSE_RATIO": ("health_collapse_ratio", "0.2"),
    "BYTEPS_HEALTH_STREAK": ("health_streak", "4"),
    "BYTEPS_HEALTH_DRIFT_FRAC": ("health_drift_frac", "0.3"),
    "BYTEPS_HEALTH_DRIFT_KEYS": ("health_drift_keys", "2"),
    "BYTEPS_LEDGER": ("ledger", "0"),
    "BYTEPS_PEAK_FLOPS": ("peak_flops", "1e15"),
    "BYTEPS_PEAK_BW_GBPS": ("peak_bw_gbps", "3000"),
    "BYTEPS_PERF_ARCHIVE": ("perf_archive", "/tmp/perf"),
    "BYTEPS_PERF_FLUSH_STEPS": ("perf_flush_steps", "5"),
    "BYTEPS_EFF_DROP_FRAC": ("eff_drop_frac", "0.5"),
    "BYTEPS_EFF_DROP_WINDOW": ("eff_drop_window", "9"),
    "BYTEPS_SERVER_ENABLE_SCHEDULE": ("server_enable_schedule", "1"),
    "BYTEPS_STAGING_ARENA": ("staging_arena", "0"),
    "BYTEPS_ENABLE_MIXED_MODE": ("enable_mixed_mode", "1"),
    "BYTEPS_MIXED_MODE_BOUND": ("mixed_mode_bound", "53"),
}


def test_plane_knobs_default_and_parse_as_in_jax(monkeypatch):
    for var in PLANE_KNOBS:
        monkeypatch.delenv(var, raising=False)
    for var, (field, _) in PLANE_KNOBS.items():
        assert getattr(Config.from_env(), field) == \
            getattr(JConfig.from_env(), field), var
    for var, (field, value) in PLANE_KNOBS.items():
        monkeypatch.setenv(var, value)
    port, jax = Config.from_env(), JConfig.from_env()
    for var, (field, _) in PLANE_KNOBS.items():
        assert getattr(port, field) == getattr(jax, field), var
        assert getattr(port, field) != getattr(Config(), field), var


# --------------------------------------------------------------------- #
# the colocated mixed mode
# --------------------------------------------------------------------- #

MIXED_ENV = {"DMLC_NUM_SERVER": "3", "DMLC_NUM_WORKER": "2",
             "BYTEPS_ENABLE_MIXED_MODE": "1",
             "BYTEPS_PARTITION_BYTES": "4096"}


def _servers(registry_cls, config_cls):
    reg = registry_cls(config_cls.from_env())
    out = {}
    for i in range(12):
        ctx = reg.init_tensor(f"grad/l{i}", 12288)
        out.update({p.key: p.server for p in ctx.partitions})
    return out


def test_mixed_mode_puts_each_partition_where_jax_does(monkeypatch):
    for k, v in MIXED_ENV.items():
        monkeypatch.setenv(k, v)
    want = _servers(JRegistry, JConfig)
    got = _servers(TensorRegistry, Config)
    assert len(got) == 36
    assert got == want
    # the mode is on: the plain djb2 hash routes most of these elsewhere
    monkeypatch.setenv("BYTEPS_ENABLE_MIXED_MODE", "0")
    assert _servers(TensorRegistry, Config) != got


@pytest.mark.parametrize("env,match", [
    ({"DMLC_NUM_SERVER": "2", "DMLC_NUM_WORKER": "2"}, "num_servers > "),
    ({"DMLC_NUM_SERVER": "3", "DMLC_NUM_WORKER": "1"}, ">= 2 workers"),
    ({"BYTEPS_MIXED_MODE_BOUND": "2"}, "BYTEPS_MIXED_MODE_BOUND 2"),
], ids=["servers-not-above-workers", "one-worker", "bound-below-servers"])
def test_mixed_mode_refuses_what_jax_refuses(env, match, monkeypatch):
    for k, v in {**MIXED_ENV, **env}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(AssertionError, match=match):
        JRegistry(JConfig.from_env()).init_tensor("grad/w", 12288)
    with pytest.raises(RuntimeError, match=match):
        TensorRegistry(Config.from_env()).init_tensor("grad/w", 12288)

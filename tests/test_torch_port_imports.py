"""The port stands alone: no module of byteps_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package byteps_tpu."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "byteps_tpu")


def _port_files():
    files = sorted((ROOT / "byteps_tpu_torch").rglob("*.py"))
    assert files, "byteps_tpu_torch has no modules"
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    # byteps_tpu_torch is not byteps_tpu: compare whole dotted names
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_no_module_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_the_ps_path_modules_are_checked():
    """The parameter-server slice's modules, the model zoo, the host
    codecs (lossless, the native codec), the elastic fleet, the
    asynchronous step's modules, the parallel strategies' modules (the
    GSPMD tier's too) and the measurement plane's are among the files
    above."""
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("config", "core/arena", "core/registry", "core/scheduler",
                "core/types", "native/build", "ops/compression/host",
                "ops/compression/rng", "server/__init__", "server/client",
                "training/device_compression", "training/train",
                "utils/spans", "torch/__init__", "torch/compression",
                "torch/cross_barrier", "ops/push_pull",
                "training/__init__", "models/__init__", "models/common",
                "models/llama", "models/mlp", "models/vgg",
                "models/resnet", "models/bert", "models/moe",
                "ops/compression/lossless", "ops/compression/native",
                "core/elastic", "core/flight", "core/state",
                "parallel/mesh", "parallel/collectives",
                "parallel/distributed", "parallel/sharding",
                "parallel/ring_attention", "parallel/ulysses",
                "parallel/pipeline", "parallel/tensor_parallel",
                "parallel/fsdp", "parallel/spmd", "core/metrics",
                "core/health", "core/ledger", "core/timeseries",
                "utils/flops", "__init__"):
        assert f"byteps_tpu_torch/{mod}.py" in files, mod


def test_ps_cc_stat_slot_names_are_the_mirrors():
    """The slot-layout check of the JAX lint (tools/lint/wire_layout.py)
    over the port: ``kStatSlotNames`` in the port's ``ps.cc`` names the
    slots of ``server._STAT_SLOTS``, in order."""
    import re

    from byteps_tpu_torch.server import _STAT_SLOTS
    src = (ROOT / "byteps_tpu_torch/native/ps.cc").read_text()
    body = re.search(r"kStatSlotNames\[\]\s*=\s*\{(.*?)\};", src,
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    assert tuple(re.findall(r'"([a-z_0-9]+)"', body)) == _STAT_SLOTS


def test_forbidden_name_rule():
    assert _forbidden("byteps_tpu.ops") and _forbidden("jax.numpy")
    assert not _forbidden("byteps_tpu_torch.ops")


def test_import_with_jax_blocked():
    """Every port module and chip_smoke.py import in a fresh interpreter
    where importing jax or byteps_tpu fails."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "byteps_tpu_torch").rglob("*.py"))
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'optax', 'byteps_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import importlib\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'byteps_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("path", ["byteps_tpu_torch/csrc/onebit.cu",
                                  "byteps_tpu_torch/csrc/flash_attn_fwd.cu",
                                  "byteps_tpu_torch/csrc/counter_rng.cu"])
def test_kernel_sources_export_the_error_string(path):
    """Every kernel library exports bps_error_string, which the loader
    binds (native/build.py)."""
    assert "bps_error_string" in (ROOT / path).read_text()

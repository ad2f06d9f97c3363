"""The PyTorch port imports neither JAX nor anything of the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "repro_torch",
    "repro_torch.device",
    "repro_torch.core.tir",
    "repro_torch.core.trace",
    "repro_torch.core.schedule",
    "repro_torch.core.validator",
    "repro_torch.core.modules",
    "repro_torch.core.mutators",
    "repro_torch.core.workloads",
    "repro_torch.obs",
    "repro_torch.obs.metrics",
    "repro_torch.obs.trace",
    "repro_torch.configs.base",
    "repro_torch.search",
    "repro_torch.search.database",
    "repro_torch.search.features",
    "repro_torch.search.cost_model",
    "repro_torch.search.distributions",
    "repro_torch.search.evolutionary",
    "repro_torch.search.task_scheduler",
    "repro_torch.search.tune",
    "repro_torch.search.measure",
    "repro_torch.search.measure.protocol",
    "repro_torch.search.measure.hashing",
    "repro_torch.search.measure.cached",
    "repro_torch.search.measure.local",
    "repro_torch.search.measure.registry",
    "repro_torch.backends",
    "repro_torch.backends.loops",
    "repro_torch.backends.registry",
    "repro_torch.backends.gpu_backend",
    "repro_torch.kernels",
    "repro_torch.kernels.ref",
    "repro_torch.kernels.matmul",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels._build",
    "repro_torch.models",
    "repro_torch.models.layers",
    "repro_torch.models.transformer",
    "repro_torch.models.registry",
    "repro_torch.models.convert",
    "repro_torch.integration",
    "repro_torch.integration.extract",
    "repro_torch.integration.dispatch",
]

_PROBE = """
import importlib, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
for name in {mods!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("LEAKED", bad)
"""


def _probe(mods):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT), mods=list(mods))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_port_modules_import_no_jax_and_no_reference():
    assert _probe(MODULES) == "LEAKED []"


def test_chip_smoke_imports_no_jax_and_no_reference():
    assert _probe(["chip_smoke"]) == "LEAKED []"


@pytest.mark.parametrize(
    "name",
    ["tune_workload", "TuneConfig", "TaskScheduler", "extract_tasks",
     "DispatchContext", "Database"],
)
def test_public_surface_is_lazy_and_resolves(name):
    import repro_torch

    assert name in repro_torch.__all__
    assert getattr(repro_torch, name) is not None

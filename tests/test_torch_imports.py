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
    "repro_torch.obs.report",
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
    "repro_torch.search.measure.pool",
    "repro_torch.search.measure.rpc",
    "repro_torch.search.measure.worker",
    "repro_torch.search.runner",
    "repro_torch.backends",
    "repro_torch.backends.analysis",
    "repro_torch.backends.loops",
    "repro_torch.backends.registry",
    "repro_torch.backends.gpu_backend",
    "repro_torch.backends.torch_backend",
    "repro_torch.kernels",
    "repro_torch.kernels.ref",
    "repro_torch.kernels.matmul",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.softmax",
    "repro_torch.kernels.ssd",
    "repro_torch.kernels.ops",
    "repro_torch.kernels._build",
    "repro_torch.models",
    "repro_torch.models.layers",
    "repro_torch.models.transformer",
    "repro_torch.models.registry",
    "repro_torch.models.convert",
    "repro_torch.integration",
    "repro_torch.integration.extract",
    "repro_torch.integration.dispatch",
    "repro_torch.serving",
    "repro_torch.serving.config",
    "repro_torch.serving.request",
    "repro_torch.serving.kv",
    "repro_torch.serving.engine",
    "repro_torch.serving.scheduler",
    "repro_torch.serving.worker",
    "repro_torch.serving.router",
    "repro_torch.launch",
    "repro_torch.launch.serve",
    "repro_torch.launch.train",
    "repro_torch.launch.mesh",
    "repro_torch.launch.dryrun",
    "repro_torch.distributed",
    "repro_torch.distributed.sharding",
    "repro_torch.data",
    "repro_torch.data.pipeline",
    "repro_torch.training",
    "repro_torch.training.optimizer",
    "repro_torch.training.train_loop",
    "repro_torch.training.checkpoint",
    "repro_torch.training.fault_tolerance",
]

_PROBE = """
import importlib, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
for name in {mods!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro.") or m == "ml_dtypes")
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


# a module the spawned pool worker imports to report its own modules after
# measuring one candidate through the real worker function
_LEAK_PROBE = """
import sys

from repro_torch.search.measure.pool import _measure_worker


def measure_and_list(payload):
    out = _measure_worker(payload)
    out["error"] = repr(sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "repro", "ml_dtypes")))
    return out
"""

_WORKER_PROBE = """
import os, subprocess, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {probe_dir!r})
import leak_probe
from repro_torch.core.modules import SpaceGenerator, default_modules
from repro_torch.core.workloads import get_workload
from repro_torch.search.measure import MeasureInput, ProcessPoolRunner, RPCRunner

func = get_workload("dense", m=16, n=16, k=16)
sch = SpaceGenerator(default_modules()).generate(func, seed=0)
mi = MeasureInput("dense/k=16/m=16/n=16", func, sch.trace)
pool = ProcessPoolRunner(max_workers=1, device="cpu", worker_fn=leak_probe.measure_and_list)
res = pool.run([mi])[0]
pool.close()
print("POOL", res.latency_s, res.error)
# the worker CLI as its own process, every import it makes logged
log = open({probe_dir!r} + "/importtime.log", "w+")
proc = subprocess.Popen(
    [sys.executable, "-X", "importtime", "-m", "repro_torch.search.measure.worker",
     "--device", "cpu", "--port", "0", "--once"],
    stdout=subprocess.PIPE, stderr=log, text=True,
    env=dict(os.environ, PYTHONPATH={src!r}))
line = proc.stdout.readline()
port = int(dict(kv.split("=", 1) for kv in line.split()[1:])["port"])
rpc = RPCRunner(address=f"127.0.0.1:{{port}}", device="cpu")
print("RPC", rpc.run([mi])[0].latency_s)
rpc.close()  # the worker leaves with its only client (--once)
proc.communicate(timeout=120)
log.seek(0)
names = [l.rsplit("|", 1)[-1].strip() for l in log if l.startswith("import time:")]
print("IMPORTED", len(names), "LEAKED", sorted(n for n in names
      if n.split(".")[0] in ("jax", "repro", "ml_dtypes")))
"""


def test_spawned_workers_import_no_jax_and_no_reference(tmp_path):
    """A pool worker (spawned) and the RPC worker CLI (its own process)
    each measure a real dense candidate on the CPU and load neither JAX
    nor the reference package."""
    (tmp_path / "leak_probe.py").write_text(_LEAK_PROBE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = _WORKER_PROBE.format(src=str(ROOT / "src"), probe_dir=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().splitlines())
    lat, leaked = lines["POOL"].split(" ", 1)
    assert float(lat) > 0 and leaked == "[]"
    assert float(lines["RPC"]) > 0
    count, leaked = lines["IMPORTED"].split(" LEAKED ")
    assert int(count) > 100 and leaked == "[]"  # torch and the port were logged


@pytest.mark.parametrize(
    "name",
    ["tune_workload", "TuneConfig", "TaskScheduler", "extract_tasks",
     "DispatchContext", "Database", "extract_decode_tasks", "ServeConfig",
     "ServingEngine", "ContinuousBatchingScheduler", "ProcessPoolRunner",
     "RPCRunner", "spawn_local_workers", "PROTOCOL_VERSION", "ProtocolError",
     "MeasurementFault"],
)
def test_public_surface_is_lazy_and_resolves(name):
    import repro_torch

    assert name in repro_torch.__all__
    assert getattr(repro_torch, name) is not None

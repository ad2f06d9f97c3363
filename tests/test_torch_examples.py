"""The three ``examples/*_torch.py`` drivers, each run as its own process.

On the CPU each runs with ``--device cpu`` and small flags, must exit 0 and
print its result lines, and imports neither JAX nor the JAX package (its
``-X importtime`` log is read).  The temporary directory of each run is the
test's own, so the databases the drivers keep there do not outlive it.  The
same runs on the card carry the ``cuda`` marker.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

CASES = {
    "quickstart_torch.py": ["--smoke"],
    "serve_batched_torch.py": [],
    "tune_and_train_torch.py": ["--steps", "4", "--rounds", "1"],
}


def _run(script, args, device, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-X", "importtime", str(EXAMPLES / script), *args,
         "--device", device],
        capture_output=True, text=True, env=env, timeout=600, cwd=tmp_path,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    imported = [l.rsplit("|", 1)[-1].strip() for l in out.stderr.splitlines()
                if l.startswith("import time:")]
    leaked = sorted(n for n in imported
                    if n.split(".")[0] in ("jax", "repro", "ml_dtypes"))
    assert "repro_torch" in imported and leaked == []
    return out.stdout


def _check(script, stdout, device):
    if script == "quickstart_torch.py":
        assert "=== sampled schedule (Figure 3) ===" in stdout
        assert "=== recorded trace (Figure 6) ===" in stdout
        assert f"device            : {device}" in stdout
        best = float(re.search(r"best latency\s*:\s*(\S+) us", stdout).group(1))
        assert 0 < best < float("inf")
        assert re.search(r"trials\s*:\s*8,", stdout)
    elif script == "serve_batched_torch.py":
        assert f"served 8/8 requests on {device}" in stdout
        assert re.search(r"prefill 256 tok in .* \| decode \d+ steps", stdout)
    else:
        assert "== phase 1: tune the model's tensor programs" in stdout
        assert "== phase 2: train with tuned kernels in the database ==" in stdout
        first, last = map(float, re.search(
            r"done: first loss (\S+) -> last (\S+) ", stdout).groups())
        assert last < first
        assert "training improved loss; tuned records live in" in stdout
        assert "tune_and_train_torch_db.json" in stdout


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_twin_runs_on_the_cpu(script, tmp_path):
    stdout = _run(script, CASES[script], "cpu", tmp_path)
    _check(script, stdout, "cpu")
    if script == "tune_and_train_torch.py":
        # its database sits in the run's own temporary directory
        assert (tmp_path / "tune_and_train_torch_db.json").exists()


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_twin_asks_for_the_card_by_default(script, tmp_path):
    """Without ``--device`` a twin runs on the card; where there is none it
    fails before any result, never carrying on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, str(EXAMPLES / script), *CASES[script]],
                         capture_output=True, text=True, env=env, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "best latency" not in out.stdout and "served" not in out.stdout
    assert "training improved loss" not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("script", sorted(CASES))
def test_example_twin_runs_on_the_card(script, tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stdout = _run(script, CASES[script], "cuda", tmp_path)
    _check(script, stdout, "cuda")

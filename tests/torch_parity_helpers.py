"""Helpers the narrow-model parity tests share (qwen1.5-110b, arctic-480b).

Each such test draws a narrow model's parameters from a numpy seed in the
reference's shapes, carries them into the port with
``models/convert.py:params_from_jax``, and compares the two packages on
the CPU; these are the pieces they have in common.  Not a test module.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np

from repro.configs.base import get_config as jcfg
from repro.core.workloads import get_workload as jget
from repro.models import transformer as JT
from repro.search.database import Database as JDatabase
from repro.search.database import TuningRecord as JRecord
from repro_torch.configs.base import get_config as tcfg
from repro_torch.core.workloads import get_workload as tget
from repro_torch.search.database import Database, TuningRecord
from repro_torch.search.task_scheduler import TuneTask


def chip_smoke():
    """``chip_smoke.py`` as a module, for its depths, keys and rules."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def configs(arch, **over):
    """(the reference's config, the port's) of ``arch`` with ``over``."""
    return (dataclasses.replace(jcfg(arch), **over),
            dataclasses.replace(tcfg(arch), **over))


def numpy_params(jc, seed=0):
    """float32 parameters in the reference's shapes: matrices N(0, 1) at
    fan-in scale (the router and the biases too, over their second-to-last
    axis), norm weights 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, spec):
        shape = tuple(spec.shape)
        if "ln" in path[-1].key:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, JT.param_specs(jc))


def tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def rel(got, want):
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def fields(specs):
    """The task specs as comparable rows: key, weight, structural hash and
    dispatchability."""
    return sorted((t.key, t.weight, t.struct_hash, t.dispatchable) for t in specs)


def reasons(ctx):
    """A dispatch context's (site, reason) pairs."""
    return {(row["site"], r) for row in ctx.stats_by_key().values() for r in row["reasons"]}


def stored(specs, ops):
    """Both packages' databases with the same stored trace (its JSON) for
    each task of ``ops``, the first the port's space generates that its
    validator accepts, and each package's tasks for them."""
    from repro_torch.core.modules import SpaceGenerator, default_modules
    from repro_torch.core.validator import validate_trace

    jdb, db, jtasks, tasks = JDatabase(), Database(), [], []
    for t in (s for s in specs if s.op in ops):
        func = tget(t.op, **t.kwargs)
        gen = SpaceGenerator(default_modules())
        tr = next(tr for tr in (gen.generate(func, seed=s).trace for s in range(32))
                  if validate_trace(func, tr).ok)
        jdb.put(JRecord(t.key, tr.to_json(), 1e-5))
        db.put(TuningRecord(t.key, tr.to_json(), 1e-5))
        jtasks.append(type("T", (), dict(key=t.key, func=jget(t.op, **t.kwargs))))
        tasks.append(TuneTask(key=t.key, func=func))
    return jdb, db, jtasks, tasks


def divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]

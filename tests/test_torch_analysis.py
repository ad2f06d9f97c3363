"""The port's analytical cost model against the JAX package's.

``estimate_schedule`` walks the schedule exactly as the reference does;
only the constants differ (an H100's, not a TPU v5e's).  With the
reference's constants patched into the port's module, every term of the
estimate, ``AnalyticalRunner.measure`` and ``baseline`` must equal the
reference's within 1e-12 relative (the same float operations in the same
order).  With the port's own constants the estimates are finite and
positive, and tensorizing a matmul still lowers its compute term.
"""

import math

import numpy as np
import pytest

import repro.backends.analysis as jan
from repro.core.modules import SpaceGenerator as JSpace
from repro.core.modules import default_modules as jmodules
from repro.core.schedule import Schedule as JSchedule
from repro.core.workloads import get_workload as jget
import repro_torch.backends.analysis as tan
from repro_torch.core.modules import SpaceGenerator as TSpace
from repro_torch.core.modules import default_modules as tmodules
from repro_torch.core.schedule import Schedule as TSchedule
from repro_torch.core.workloads import get_workload as tget
from repro_torch.search.measure import LegacyRunnerAdapter, MeasureInput, as_runner

CASES = [
    ("gmm", dict(n=128, m=128, k=128)),
    ("dense", dict(m=256, n=576, k=576)),
    ("dense", dict(m=36, n=40, k=24)),
    ("batch_matmul", dict(b=3, m=768, n=64, k=256)),
    ("attention", dict(b=1, h=9, kvh=3, s=256, d=64)),
    ("sfm", dict(m=256, n=256)),
    ("rmsnorm", dict(tokens=256, d=576)),
]


@pytest.fixture
def reference_constants(monkeypatch):
    """The reference's TPU v5e constants in the port's module."""
    monkeypatch.setattr(tan, "TENSORIZED_FLOPS", jan.PEAK_BF16_FLOPS)
    monkeypatch.setattr(tan, "UNALIGNED_FACTOR", 0.25)
    monkeypatch.setattr(tan, "ELEMENTWISE_FLOPS", jan.VPU_FLOPS)
    monkeypatch.setattr(tan, "PEAK_HBM_BYTES", jan.HBM_BW)
    monkeypatch.setattr(tan, "GRID_STEP_OVERHEAD", jan.GRID_STEP_OVERHEAD)


def _schedules(name, kw, mxu):
    jf, tf = jget(name, **kw), tget(name, **kw)
    js, ts = JSpace(jmodules(use_mxu=mxu)), TSpace(tmodules(use_mxu=mxu))
    for seed in range(3):
        yield js.generate(jf, seed=seed), ts.generate(tf, seed=seed)


def _terms(est):
    return (est.compute_s, est.memory_s, est.overhead_s, est.total_s, est.dominant)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("name,kw", CASES)
def test_estimates_equal_the_reference_under_its_constants(
        reference_constants, name, kw, mxu):
    for jsch, tsch in _schedules(name, kw, mxu):
        want, got = _terms(jan.estimate_schedule(jsch)), _terms(tan.estimate_schedule(tsch))
        assert got[:4] == pytest.approx(want[:4], rel=1e-12) and got[4] == want[4]
        assert tan.AnalyticalRunner().measure(tsch).latency_s == pytest.approx(
            jan.AnalyticalRunner().measure(jsch).latency_s, rel=1e-12)
    assert tan.AnalyticalRunner().baseline(tget(name, **kw)) == pytest.approx(
        jan.AnalyticalRunner().baseline(jget(name, **kw)), rel=1e-12)


def _hand_schedule(Schedule, func, mxu):
    """The reference test's gmm schedule: i and k unrolled, j vectorized."""
    sch = Schedule(func, seed=0)
    b = sch.get_block("C")
    i, j, k = sch.get_loops(b)
    sch.unroll(i)
    sch.unroll(k)
    sch.vectorize(j)
    if mxu:
        sch.tensorize_mxu(b)
    return sch


@pytest.mark.parametrize("mxu", [False, True])
def test_hand_schedule_equals_the_reference_under_its_constants(reference_constants, mxu):
    kw = dict(n=128, m=128, k=128)
    want = jan.estimate_schedule(_hand_schedule(JSchedule, jget("gmm", **kw), mxu))
    got = tan.estimate_schedule(_hand_schedule(TSchedule, tget("gmm", **kw), mxu))
    assert _terms(got)[:4] == pytest.approx(_terms(want)[:4], rel=1e-12)


def test_h100_constants_are_the_data_sheets():
    assert tan.PEAK_3XTF32_FLOPS == tan.TENSORIZED_FLOPS == 495e12 / 3
    assert tan.UNALIGNED_FACTOR == pytest.approx(67 / 165, rel=1e-15)
    assert tan.ELEMENTWISE_FLOPS == tan.PEAK_F32_FLOPS == 67e12
    assert tan.PEAK_HBM_BYTES == 3.35e12 and tan.PEAK_BF16_FLOPS == 989e12
    assert tan.GRID_STEP_OVERHEAD == 0.0
    assert not hasattr(tan, "ICI_BW") and not hasattr(tan, "VMEM_BYTES")


@pytest.mark.parametrize("name,kw", CASES)
def test_h100_estimates_are_finite_and_positive(name, kw):
    func = tget(name, **kw)
    for mxu in (False, True):
        sch = TSpace(tmodules(use_mxu=mxu)).generate(func, seed=0)
        est = tan.estimate_schedule(sch)
        assert est.overhead_s == 0.0
        assert math.isfinite(est.total_s) and est.total_s > 0
        assert est.dominant in ("compute", "memory")
    base = tan.AnalyticalRunner().baseline(func)
    assert math.isfinite(base) and base > 0


def test_tensorizing_lowers_the_compute_term():
    f = tget("gmm", n=128, m=128, k=128)
    tc = tan.estimate_schedule(_hand_schedule(TSchedule, f, True))
    f32 = tan.estimate_schedule(_hand_schedule(TSchedule, f, False))
    assert tc.compute_s < f32.compute_s
    # the j tile is 128 wide, a multiple of 8: the aligned 3xTF32 rate
    assert tc.compute_s == pytest.approx(f32.compute_s * 67 / 165, rel=1e-12)


def test_analytical_runner_behind_the_batch_protocol():
    func = tget("dense", m=32, n=64, k=32)
    sch = TSpace(tmodules()).generate(func, seed=0)
    runner = as_runner(tan.AnalyticalRunner())
    assert isinstance(runner, LegacyRunnerAdapter)
    (res,) = runner.run([MeasureInput("dense/k=32/m=32/n=64", func, sch.trace)])
    assert res.ok and res.latency_s == tan.estimate_schedule(sch).total_s
    assert np.isfinite(res.latency_s)

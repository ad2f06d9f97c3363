"""The port's GPU backend against the JAX package's Pallas backend.

For seeded traces of ``dense``, ``batch_matmul`` and ``attention`` at small
sizes, sampled by the reference and carried across as trace JSON, the
port's tile extraction, divisor snapping and provenance meta must equal
``pallas_backend``'s, and the lowered executables must compute the same
outputs on ``random_inputs(func, 0)`` (float32, rtol/atol 2e-4: the two
sum in different orders).  Pallas runs in interpret mode; traces whose
grid has more than 256 steps are compared on meta only, to keep interpret
mode fast.
"""

import numpy as np
import pytest
import torch

from repro.backends import pallas_backend as pb
from repro.core.modules import SpaceGenerator, default_modules
from repro.core.tir import random_inputs
from repro.core.validator import validate_trace as jvalidate
from repro.core.workloads import get_workload as jget
from repro_torch.backends import gpu_backend as gb
from repro_torch.backends.registry import backend_names, get_backend
from repro_torch.core.trace import Trace as TTrace
from repro_torch.core.validator import validate_trace as tvalidate
from repro_torch.core.workloads import get_workload as tget

CASES = [
    ("dense", dict(m=32, n=48, k=24, epilogue="none")),
    ("dense", dict(m=16, n=32, k=48, epilogue="bias_gelu")),
    ("batch_matmul", dict(b=3, m=24, n=16, k=32)),
    ("attention", dict(b=1, h=4, kvh=2, s=24, d=8)),
    ("attention", dict(b=1, h=2, kvh=1, s=16, d=8, window=8, softcap=20.0)),
]
SEEDS = range(4)
MAX_COMPARED_STEPS = 256


def _pair(name, kw, seed):
    jfunc = jget(name, **kw)
    tr = SpaceGenerator(default_modules(use_mxu=True)).generate(jfunc, seed=seed).trace
    jv = jvalidate(jfunc, tr)
    tfunc = tget(name, **kw)
    tv = tvalidate(tfunc, TTrace.from_json(tr.to_json()))
    assert jv.ok == tv.ok
    return jv, tv


def _steps(func, snapped):
    if func.name.startswith("attention_"):
        b, kvh, g, s, d = func.inputs[0].shape
        return b * kvh * g * (s // snapped[0]) * (s // snapped[1])
    shape = func.inputs[0].shape
    bsz = shape[0] if len(shape) == 3 else 1
    M, K = shape[-2:]
    N = func.inputs[1].shape[-1]
    bm, bn, bk = snapped
    return bsz * (M // bm) * (N // bn) * (K // bk)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,kw", CASES)
def test_blocks_meta_and_outputs_match_pallas_backend(name, kw, seed):
    jv, tv = _pair(name, kw, seed)
    if not jv.ok:
        pytest.skip(f"seed {seed} samples an invalid trace")
    jsch, tsch = jv.schedule, tv.schedule
    if name == "attention":
        assert gb.extract_attention_blocks(tsch) == pb.extract_attention_blocks(jsch)
    else:
        assert gb.extract_matmul_blocks(tsch) == pb.extract_matmul_blocks(jsch)
    jfn, jmeta = pb.lower_to_pallas(jsch, interpret=True)
    tfn, tmeta = gb.lower_to_cuda(tsch)
    assert tmeta == jmeta  # sampled / snapped / adjusted / source, key for key
    if _steps(jsch.func, jmeta["pallas_blocks_snapped"]) > MAX_COMPARED_STEPS:
        return
    ins = random_inputs(jsch.func, 0)
    want = {k: np.asarray(v) for k, v in jfn(ins).items()}
    got = tfn({k: torch.from_numpy(v) for k, v in ins.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dims,blocks", [
    ((48, 48, 24), (20, 13, 7)),
    ((256, 1536, 576), (96, 100, 50)),
    ((24, 24), (5, 24)),
])
def test_snap_blocks_matches_pallas_backend(dims, blocks):
    assert gb.snap_blocks(dims, blocks) == pb.snap_blocks(dims, blocks)


@pytest.mark.parametrize("sampled,snapped", [
    (None, (32, 32, 32)), ((20, 13, 7), (24, 12, 8)), ((32, 16), (32, 16)),
])
def test_block_meta_matches_pallas_backend(sampled, snapped):
    assert gb._block_meta("matmul", sampled, snapped) == pb._block_meta(
        "matmul", sampled, snapped
    )


def test_registry_has_only_cuda_and_its_meta_names_the_backend():
    """The kernels' backend, and the structural one it falls back to."""
    assert backend_names() == ["cuda", "torch"]
    func = tget("dense", m=16, n=16, k=16)
    tr = SpaceGenerator(default_modules(use_mxu=True)).generate(
        jget("dense", m=16, n=16, k=16), seed=0
    ).trace
    sch = tvalidate(func, TTrace.from_json(tr.to_json())).schedule
    low = get_backend("cuda").lower(sch)
    assert low.meta["backend"] == "cuda"
    assert low.meta["pallas_kernel"] == "matmul"


@pytest.mark.parametrize("name,kw", [
    ("sfm", dict(m=16, n=16)),
    ("rmsnorm", dict(tokens=16, d=16)),
    ("gmm", dict(n=16, m=16, k=16)),
])
def test_other_workloads_raise_instead_of_falling_back(name, kw):
    """sfm lowers to K4 now; a workload without a kernel falls back to the
    structural lowering and says so in the meta."""
    from repro_torch.core.schedule import Schedule

    func = tget(name, **kw)
    sch = Schedule(func, seed=None)  # the untransformed program
    meta = get_backend("cuda").lower(sch).meta
    if name == "sfm":
        assert gb.supports(func) and meta["pallas_kernel"] == "row_softmax"
        return
    assert not gb.supports(func)
    assert meta == {"backend": "cuda", "lowered_with": "torch-fallback"}
    with pytest.raises(NotImplementedError):
        gb.lower_to_cuda(sch)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("use_mxu", [False, True])
def test_sfm_row_block_meta_and_outputs_match_pallas_backend(seed, use_mxu):
    kw = dict(m=48, n=32)
    jfunc, tfunc = jget("sfm", **kw), tget("sfm", **kw)
    tr = SpaceGenerator(default_modules(use_mxu=use_mxu)).generate(jfunc, seed=seed).trace
    jv = jvalidate(jfunc, tr)
    tv = tvalidate(tfunc, TTrace.from_json(tr.to_json()))
    assert jv.ok == tv.ok
    if not jv.ok:
        pytest.skip(f"seed {seed} samples an invalid trace")
    assert gb.extract_row_block(tv.schedule) == pb.extract_row_block(jv.schedule)
    jfn, jmeta = pb.lower_sfm(jv.schedule, interpret=True)
    tfn, tmeta = gb.lower_sfm(tv.schedule)
    assert tmeta == jmeta
    assert get_backend("cuda").lower(tv.schedule).meta == {"backend": "cuda", **jmeta}
    ins = random_inputs(jfunc, 0)
    want = np.asarray(jfn(ins)["Y"])
    got = tfn({"A": torch.from_numpy(ins["A"])})["Y"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_untuned_fused_attention_uses_divisor_blocks():
    r = np.random.default_rng(0)
    q = torch.from_numpy(r.standard_normal((1, 4, 24, 8), dtype=np.float32))
    k = torch.from_numpy(r.standard_normal((1, 2, 24, 8), dtype=np.float32))
    v = torch.from_numpy(r.standard_normal((1, 2, 24, 8), dtype=np.float32))
    from repro.kernels.ref import flash_attention as jflash

    got = get_backend("cuda").fused_attention(q, k, v, causal=True)
    want = np.asarray(jflash(q.numpy(), k.numpy(), v.numpy(), causal=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)

"""The port's structural lowering against the JAX package's jnp backend.

``repro_torch.backends.torch_backend`` is the port of
``repro.backends.jnp_backend``: for seeded traces of every registered
workload at ``REDUCED_KWARGS`` (sampled by the reference and carried across
as trace JSON), ``build`` must compute what the jnp lowering computes on
``random_inputs(func, 0)``, and ``build_oracle`` what the jnp oracle
computes.  Float32, rtol 1e-4 / atol 1e-5: the same operations, summed in
another order.  Two hand-built programs reach the places where JAX and
PyTorch indexing differ: a write window whose start JAX clamps, a gather
of negative and too-large indices (wrapped once, then clamped), and a
scatter whose negative indices wrap and whose too-large ones drop.  The
registry's ``cuda`` backend falls back to this lowering, and only for a
workload without a kernel.
"""

import numpy as np
import pytest
import torch

from repro.backends import jnp_backend as jb
from repro.core import tir as jtir
from repro.core.modules import SpaceGenerator, default_modules
from repro.core.schedule import Schedule as JSchedule
from repro.core.tir import random_inputs
from repro.core.validator import validate_trace as jvalidate
from repro.core.workloads import REDUCED_KWARGS, WORKLOADS
from repro.core.workloads import get_workload as jget
from repro_torch.backends import gpu_backend as gb
from repro_torch.backends import torch_backend as tb
from repro_torch.backends.registry import get_backend
from repro_torch.core import tir as ttir
from repro_torch.core.schedule import Schedule as TSchedule
from repro_torch.core.trace import Trace as TTrace
from repro_torch.core.validator import validate_trace as tvalidate
from repro_torch.core.workloads import get_workload as tget
from repro_torch.kernels import ScheduleRejected

RTOL, ATOL = 1e-4, 1e-5

# (workload, use_mxu, seed): seeded valid traces with at most a few hundred
# iterated trips, among them traces that write through the scatter path
# (sfm, rmsnorm, the convolutions), iterated reductions (every contraction
# split over k) and tensorized einsum tiles (use_mxu=True)
TRACES = [
    ("attention", False, 0), ("attention", True, 3),
    ("attention_decode", False, 0), ("attention_decode", True, 3),
    ("batch_matmul", False, 0), ("batch_matmul", True, 3),
    ("c1d", False, 0), ("c1d", True, 1),
    ("c2d", False, 0), ("c2d", True, 1),
    ("c3d", False, 2), ("c3d", True, 1),
    ("cbr", False, 0), ("cbr", True, 1),
    ("dense", False, 0), ("dense", True, 3),
    ("dep", False, 0), ("dep", True, 1),
    ("dil", False, 0), ("dil", True, 1),
    ("fused_dense", False, 0), ("fused_dense", True, 3),
    ("gmm", False, 0), ("gmm", True, 3),
    ("grp", False, 0), ("grp", True, 1),
    ("nrm", False, 2), ("nrm", True, 1),
    ("relu", False, 0), ("relu", True, 1),
    ("rmsnorm", False, 2), ("rmsnorm", True, 1),
    ("sfm", False, 0), ("sfm", True, 1),
    ("t2d", False, 2), ("t2d", True, 1),
    ("tbg", False, 0), ("tbg", True, 3),
]


def _torch(ins):
    return {k: torch.from_numpy(v) for k, v in ins.items()}


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL
        )


def test_traces_cover_every_registered_workload():
    assert {name for name, _, _ in TRACES} == set(WORKLOADS)
    assert set(WORKLOADS) <= set(REDUCED_KWARGS)


@pytest.mark.parametrize("name,use_mxu,seed", TRACES)
def test_build_matches_jnp_backend(name, use_mxu, seed):
    kw = REDUCED_KWARGS[name]
    jfunc, tfunc = jget(name, **kw), tget(name, **kw)
    tr = SpaceGenerator(default_modules(use_mxu=use_mxu)).generate(jfunc, seed=seed).trace
    jv = jvalidate(jfunc, tr)
    tv = tvalidate(tfunc, TTrace.from_json(tr.to_json()))
    assert jv.ok and tv.ok
    jlow, tlow = jb.build(jv.schedule), tb.build(tv.schedule)
    assert (tlow.iterated_count, tlow.tile_elems) == (
        jlow.iterated_count, jlow.tile_elems
    )
    ins = random_inputs(jfunc, 0)
    _close(tlow.fn(_torch(ins)), jlow.fn(ins))


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_oracle_matches_jnp_oracle(name):
    kw = REDUCED_KWARGS[name]
    jfunc, tfunc = jget(name, **kw), tget(name, **kw)
    ins = random_inputs(jfunc, 0)
    _close(tb.build_oracle(tfunc)(_torch(ins)), jb.build_oracle(jfunc)(ins))


def _shift(tir):
    """B[i + 2] = A[i - 2] over i < 8, A and B of 8: tiled by 4, the second
    tile's write window starts at 6 and JAX clamps it to 4; the first
    tile's load reads A[-2], A[-1], which JAX wraps to A[8 - 2], A[8 - 1]."""
    A, B = tir.Buffer("A", (8,)), tir.Buffer("B", (8,))
    i = tir.LinExpr.var("i")
    blk = tir.Block("shift", (tir.Axis("i", 8),), tir.load(A, i - 2), B, (i + 2,))
    return tir.PrimFunc("shift", (A,), (B,), (blk,))


def _strided(tir):
    """B[2i - 4] = A[i] over i < 10, B of 13: one tile, written by scatter;
    i = 0, 1 land on -4, -2 and wrap to 9, 11; i = 9 lands on 14 and is
    dropped."""
    A, B = tir.Buffer("A", (10,)), tir.Buffer("B", (13,))
    i = tir.LinExpr.var("i")
    blk = tir.Block("strided", (tir.Axis("i", 10),), tir.load(A, i), B, (i * 2 - 4,))
    return tir.PrimFunc("strided", (A,), (B,), (blk,))


def _schedule(Schedule, func, tiles):
    sch = Schedule(func, seed=0)
    blk = sch.get_blocks()[0]
    (loop,) = sch.get_loops(blk)
    if tiles:
        _, loop = sch.split(loop, tiles)
    sch.vectorize(loop)
    return sch


@pytest.mark.parametrize("make,tiles", [(_shift, [2, 4]), (_strided, None)])
def test_jax_index_semantics_are_kept(make, tiles):
    jsch = _schedule(JSchedule, make(jtir), tiles)
    tsch = _schedule(TSchedule, make(ttir), tiles)
    ins = random_inputs(jsch.func, 0)
    want = jb.build(jsch).fn(ins)
    got = tb.build(tsch).fn(_torch(ins))
    _close(got, want)
    if make is _shift:  # the clamped window rewrote B[4:6]
        a = ins["A"]
        np.testing.assert_array_equal(
            got["B"].numpy(), np.concatenate([[0, 0], a[[6, 7]], a[2:6]])
        )


def test_a_write_view_must_hit_each_element_once():
    buf = torch.zeros(4, 6)
    assert tb._one_to_one(buf.as_strided((4, 3), (6, 2)))
    assert not tb._one_to_one(buf.as_strided((2, 3), (1, 1)))  # overlaps
    assert not tb._one_to_one(buf.as_strided((3, 2), (1, 2)))  # 2·1 = 1·2


def test_a_tile_loop_feeding_spatial_and_reduce_axes_is_rejected(monkeypatch):
    func = tget("gmm", n=8, m=8, k=8)
    sch = TSchedule(func, seed=None)

    def both(bn, tile_loops):
        raise tb.ScheduleError("tile loop feeds both S and R axes")

    monkeypatch.setattr(tb, "_classify_tile_vars", both)
    with pytest.raises(ScheduleRejected) as e:
        tb.build(sch)
    assert e.value.reason == "structure"


@pytest.mark.parametrize("name", ["rmsnorm", "gmm", "c2d", "nrm"])
def test_cuda_backend_falls_back_only_without_a_kernel(name):
    kw = REDUCED_KWARGS[name]
    jfunc, tfunc = jget(name, **kw), tget(name, **kw)
    tr = SpaceGenerator(default_modules()).generate(jfunc, seed=0).trace
    tv = tvalidate(tfunc, TTrace.from_json(tr.to_json()))
    assert tv.ok and not gb.supports(tfunc)
    low = get_backend("cuda").lower(tv.schedule)
    assert low.meta == {"backend": "cuda", "lowered_with": "torch-fallback"}
    ins = random_inputs(jfunc, 0)
    _close(low.fn(_torch(ins)), jb.build_oracle(jfunc)(ins))
    assert get_backend("torch").lower(tv.schedule).meta == {"backend": "torch"}


@pytest.mark.parametrize("name", ["dense", "batch_matmul", "attention",
                                  "attention_decode", "sfm"])
def test_a_workload_with_a_kernel_never_falls_back(name, monkeypatch):
    kw = REDUCED_KWARGS[name]
    func = tget(name, **kw)
    sch = TSchedule(func, seed=None)
    assert gb.supports(func)

    def boom(s):
        raise RuntimeError("kernel lowering failed")

    def fell_back(s):
        raise AssertionError("a workload with a kernel fell back")

    monkeypatch.setattr(gb, "lower_to_cuda", boom)
    monkeypatch.setattr(tb, "build", fell_back)
    with pytest.raises(RuntimeError, match="kernel lowering failed"):
        get_backend("cuda").lower(sch)


def test_plain_is_the_oracle_for_workloads_without_a_kernel():
    func = tget("c1d", **REDUCED_KWARGS["c1d"])
    ins = random_inputs(func, 0)
    _close(gb.plain(func)(_torch(ins)), tb.build_oracle(func)(_torch(ins)))

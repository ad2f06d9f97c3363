"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips, inside the test,
when there is no CUDA device; on the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports nothing of the JAX package, so it runs where JAX is not
installed.  TF32 is switched off for float32 matmuls
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set to False), so the plain versions
run in full float32.  Tolerances: 1e-3 for f32 matrix products with
K <= 72 (different summation orders), 1e-4 for attention, whose outputs
are convex combinations of v.
"""

import math

import pytest
import torch

import repro_torch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ScheduleRejected
from repro_torch.kernels import ref as tref
from repro_torch.kernels import softmax as sm
from repro_torch.search.evolutionary import SearchConfig

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("ep", ["none", "bias", "gelu", "softcap"])
def test_cuda_matmul_against_plain(ep):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(96, 72, generator=g, device=dev)
    w = torch.randn(120, 72, generator=g, device=dev).t()  # strided
    b = torch.randn(120, generator=g, device=dev) if ep == "bias" else None
    n = mm.matmul.launches
    got = mm.matmul(x, w, b, epilogue=ep, block_sizes=(32, 40, 24))
    torch.cuda.synchronize()
    assert mm.matmul.launches == n + 1
    assert mm.matmul.last_launch["grid"] == (3, 3, 1)
    want = tref.matmul(x, w, b, epilogue=ep)
    assert float((got - want).abs().max()) < 1e-3


def test_cuda_batch_matmul_against_plain():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(3, 96, 64, generator=g, device=dev)
    b = torch.randn(3, 64, 48, generator=g, device=dev)
    n = mm.batch_matmul.launches
    got = mm.batch_matmul(a, b, block_sizes=(24, 48, 16))
    torch.cuda.synchronize()
    assert mm.batch_matmul.launches == n + 1
    assert mm.batch_matmul.last_launch["grid"] == (1, 4, 3)
    assert float((got - tref.batch_matmul(a, b)).abs().max()) < 1e-3


def test_cuda_flash_attention_against_plain():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, 9, 96, 64, generator=g, device=dev)
    k = torch.randn(1, 3, 96, 64, generator=g, device=dev)
    v = torch.randn(1, 3, 96, 64, generator=g, device=dev)
    for kw in (dict(causal=True), dict(causal=True, window=32, softcap=50.0)):
        got = fa.flash_attention(q, k, v, block_q=48, block_kv=32, **kw)
        want = tref.flash_attention(q, k, v, **kw)
        assert float((got - want).abs().max()) < 1e-4


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _cuda()
    x = torch.randn(32, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        mm.matmul(x, x)
    q = torch.randn(1, 2, 32, 16, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)


def test_cuda_tune_workload_times_the_kernel():
    _cuda()
    n = mm.matmul.launches
    r = repro_torch.tune_workload(
        "dense", m=64, n=96, k=48,
        config=repro_torch.TuneConfig(search=SearchConfig(
            max_trials=6, init_random=3, population=6, measure_per_round=3)),
    )
    assert math.isfinite(r.best_latency_s) and r.best_latency_s > 0
    assert math.isfinite(r.baseline_latency_s)
    assert mm.matmul.launches > n


def _bias(lengths, T, dev, window=0):
    pos = torch.arange(T, device=dev)[None, :]
    lv = torch.tensor(lengths, device=dev)[:, None]
    ok = pos < lv
    if window:
        ok &= pos > lv - 1 - window
    return torch.where(ok, 0.0, -1e30).float()


@pytest.mark.parametrize("T,block_kv,softcap,window", [
    (256, 64, None, 0), (192, 48, 50.0, 0), (192, 96, None, 40), (256, 256, None, 0),
])
def test_cuda_decode_attention_against_plain(T, block_kv, softcap, window):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(T + block_kv)
    q = torch.randn(4, 3, 3, 64, generator=g, device=dev)
    k = torch.randn(4, 3, T, 64, generator=g, device=dev)
    v = torch.randn(4, 3, T, 64, generator=g, device=dev)
    bias = _bias([T, 1, 77, T - 5], T, dev, window)  # ragged per-slot lengths
    n = fa.decode_flash_attention.launches
    got = fa.decode_flash_attention(q, k, v, bias, softcap=softcap, block_kv=block_kv)
    torch.cuda.synchronize()
    assert fa.decode_flash_attention.launches == n + 1
    assert fa.decode_flash_attention.last_launch["blocks"] == (block_kv,)
    assert fa.decode_flash_attention.last_launch["grid"] == (12,)
    want = tref.decode_attention(q, k, v, bias, softcap=softcap)
    assert float((got - want).abs().max()) < 1e-4


def test_cuda_paged_decode_attention_against_decode_on_the_gathered_view():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    B, KVH, G, D, ps, P = 4, 3, 3, 64, 16, 16
    n_pages = B * P + 3
    q = torch.randn(B, KVH, G, D, generator=g, device=dev)
    kp = torch.randn(n_pages, KVH, ps, D, generator=g, device=dev)
    vp = torch.randn(n_pages, KVH, ps, D, generator=g, device=dev)
    table = torch.randperm(n_pages - 1, generator=g, device=dev)[: B * P]
    table = table.reshape(B, P).to(torch.int32)
    table[1, 10:] = n_pages  # sentinel tail, masked by the bias
    bias = _bias([P * ps, 10 * ps - 3, 1, 100], P * ps, dev)
    n = fa.paged_decode_flash_attention.launches
    got = fa.paged_decode_flash_attention(q, kp, vp, table, bias)
    torch.cuda.synchronize()
    assert fa.paged_decode_flash_attention.launches == n + 1
    idx = torch.clamp(table.long(), max=n_pages - 1)
    gk = kp[idx].permute(0, 2, 1, 3, 4).reshape(B, KVH, P * ps, D).contiguous()
    gv = vp[idx].permute(0, 2, 1, 3, 4).reshape(B, KVH, P * ps, D).contiguous()
    want = fa.decode_flash_attention(q, gk, gv, bias, block_kv=ps)
    assert float((got - want).abs().max()) < 1e-4
    assert float((got - tref.paged_decode_attention(q, kp, vp, table, bias))
                 .abs().max()) < 1e-4


@pytest.mark.parametrize("bm", [36, 72, 144])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 8e-3)])
def test_cuda_row_softmax_against_plain(bm, dtype, tol):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(6)
    x = (torch.randn(2304, 256, generator=g, device=dev) * 4).to(dtype)
    n = sm.row_softmax.launches
    got = sm.row_softmax(x, block_rows=bm)
    torch.cuda.synchronize()
    assert sm.row_softmax.launches == n + 1
    assert sm.row_softmax.last_launch["blocks"] == (bm,)
    assert sm.row_softmax.last_launch["grid"] == (2304 // bm,)
    assert got.dtype == dtype
    assert float((got.float() - tref.row_softmax(x).float()).abs().max()) <= tol


def test_cuda_row_softmax_refuses_what_the_kernel_does_not_take():
    dev = _cuda()
    x = torch.randn(2304, 256, device=dev)
    with pytest.raises(ScheduleRejected) as e:
        sm.row_softmax(x, block_rows=288)
    assert e.value.reason == "shared_memory"
    with pytest.raises(TypeError):
        sm.row_softmax(x.half())
    with pytest.raises(ValueError):
        sm.row_softmax(x.t())

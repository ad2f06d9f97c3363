"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips, inside the test,
when there is no CUDA device; on the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports nothing of the JAX package, so it runs where JAX is not
installed.  TF32 is switched off for float32 matmuls
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set to False), so the plain versions
run in full float32.  Tolerances: 1e-3 for f32 matrix products with
K <= 72 (different summation orders), 2e-3 with K up to 2048 (N(0, 1)
inputs, |y| up to ~200: ``TOL_MATMUL`` of ``chip_smoke.py``; the ``tc``
variant's 3xTF32 keeps f32 accuracy; the sum's rounding grows as
sqrt(K)·2^-24·|y|, 1e-4 at K 2048), 1e-4 for attention, whose outputs
are convex combinations of v.  The olmoe-smoke MoE layer dispatched on
the card against the same layer plain: 1e-5 (f32, sums of 64 products).  K7 (ssd) against its plain version: 1e-5
of the output's largest magnitude in f32 (sums of up to N + L terms in
another order), 8e-3 of it with bf16 x/B/C (both round y to bf16 once: one
ulp is 2^-8 of |y|); the f32 state within 1e-5 of its largest magnitude.
The kernels that split their work over CTAs (K5, K6, K7) or over warps
(K3) must give the same bits on a second call and on two replays of one
CUDA graph.
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
from repro_torch.kernels import ssd as ssd_k
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


K1_EPILOGUES = ("none", "bias", "relu", "gelu", "silu", "softcap")
TOL_MATMUL = 2e-3


def _k1_operands(dev, seed, M, K, N, w_layout, x_layout="k"):
    """x (M, K) and w (K, N) on the card; ``w_layout`` "k" reads w through a
    (N, K) table transposed (the tied unembed), "n" is row-major; x "m" is a
    transposed (K, M) tensor, "pad" a row-major one with rows of K + 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if x_layout == "m":
        x = torch.randn(K, M, generator=g, device=dev).t()
    elif x_layout == "pad":
        x = torch.randn(M, K + 1, generator=g, device=dev)[:, :K]
    else:
        x = torch.randn(M, K, generator=g, device=dev)
    if w_layout == "k":
        w = torch.randn(N, K, generator=g, device=dev).t()
    else:
        w = torch.randn(K, N, generator=g, device=dev)
    return x, w, torch.randn(N, generator=g, device=dev)


def _k1_against_plain(x, w, bias, blocks, variant):
    for ep in K1_EPILOGUES:
        b = bias if ep == "bias" else None
        n = mm.matmul.launches_by_variant[variant]
        got = mm.matmul(x, w, b, epilogue=ep, block_sizes=blocks)
        again = mm.matmul(x, w, b, epilogue=ep, block_sizes=blocks)
        torch.cuda.synchronize()
        assert mm.matmul.launches_by_variant[variant] == n + 2
        cfg = mm.matmul.last_launch
        assert cfg["variant"] == variant and cfg["blocks"] == blocks
        want = tref.matmul(x, w, b, epilogue=ep)
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) < TOL_MATMUL, ep
        assert torch.equal(got, again)  # the same bits every run
    return cfg


# decode shapes (M = 4 and an odd M = 3): one split and many, a bm below M,
# a bn or bk that is not a multiple of 4 (scalar loads), both layouts of w
@pytest.mark.parametrize("M,K,N,blocks", [
    (4, 576, 576, (4, 64, 36)),
    (4, 576, 576, (4, 64, 576)),
    (4, 576, 1536, (2, 96, 96)),
    (4, 1536, 576, (4, 18, 48)),
    (3, 72, 120, (3, 40, 18)),
    (4, 1024, 50280, (4, 60, 64)),  # mamba2's unembed at decode
])
@pytest.mark.parametrize("w_layout", ["n", "k"])
def test_cuda_matmul_splitk_against_plain(M, K, N, blocks, w_layout):
    dev = _cuda()
    x, w, bias = _k1_operands(dev, M + K + N, M, K, N, w_layout)
    cfg = _k1_against_plain(x, w, bias, blocks, "splitk")
    bm, bn, bk = blocks
    assert cfg["grid"] == (N // bn, M // bm, K // bk)
    assert cfg["splits"] == K // bk and cfg["threads"] == mm.SPLITK_THREADS


def test_cuda_matmul_splitk_unembed_shape():
    """The tied unembed at decode: (4, 576) @ the (49152, 576) table read
    transposed, many splits."""
    dev = _cuda()
    x, w, _ = _k1_operands(dev, 7, 4, 576, 49152, "k")
    got = mm.matmul(x, w, block_sizes=(4, 256, 96))
    torch.cuda.synchronize()
    assert mm.matmul.last_launch["variant"] == "splitk"
    assert mm.matmul.last_launch["grid"] == (192, 1, 6)
    assert float((got - tref.matmul(x, w)).abs().max()) < TOL_MATMUL


def test_cuda_matmul_splitk_on_two_streams():
    """Split-K launches on two streams at once keep their own tile counters:
    each gives the bits it gives alone."""
    dev = _cuda()
    x, w, bias = _k1_operands(dev, 11, 4, 1536, 576, "n")
    blocks = (4, 18, 48)  # 32 splits
    alone = mm.matmul(x, w, bias, epilogue="bias", block_sizes=blocks)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
    outs = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    for _ in range(8):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(mm.matmul(x, w, bias, epilogue="bias", block_sizes=blocks))
    torch.cuda.synchronize()
    for out in outs[0] + outs[1]:
        assert torch.equal(out, alone)


# forward shapes: two stages and one (128^3 needs 139 KB a stage), both
# layouts of w, x transposed and x with rows that break 16-byte alignment
@pytest.mark.parametrize("M,K,N,blocks,stages", [
    (256, 576, 576, (64, 64, 32), 2),
    (256, 576, 192, (32, 48, 64), 2),
    (256, 256, 256, (128, 128, 128), 1),
    (48, 72, 120, (16, 40, 24), 2),
    (128, 576, 1536, (128, 16, 24), 2),  # a smollm serving chunk
    (256, 1024, 50280, (32, 120, 32), 2),  # mamba2's unembed, bn 8 mod 16
])
@pytest.mark.parametrize("w_layout", ["n", "k"])
def test_cuda_matmul_tc_against_plain(M, K, N, blocks, stages, w_layout):
    dev = _cuda()
    x, w, bias = _k1_operands(dev, M + K + N, M, K, N, w_layout)
    cfg = _k1_against_plain(x, w, bias, blocks, "tc")
    bm, bn, _ = blocks
    assert cfg["grid"] == (N // bn, M // bm, 1) and cfg["stages"] == stages
    assert cfg["smem_bytes"] == stages * mm.tc_stage_bytes(*blocks)


@pytest.mark.parametrize("x_layout", ["m", "pad"])
def test_cuda_matmul_tc_reads_x_through_its_strides(x_layout):
    dev = _cuda()
    x, w, bias = _k1_operands(dev, 3, 64, 96, 128, "n", x_layout)
    assert not x.is_contiguous()
    _k1_against_plain(x, w, bias, (32, 64, 32), "tc")


def test_cuda_matmul_fma_variant_against_plain():
    dev = _cuda()
    x, w, bias = _k1_operands(dev, 5, 64, 72, 96, "n")
    cfg = _k1_against_plain(x, w, bias, (32, 12, 36), "fma")
    assert cfg["grid"] == (8, 2, 1)


def test_cuda_batch_matmul_against_plain():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(3, 96, 64, generator=g, device=dev)
    b = torch.randn(3, 64, 48, generator=g, device=dev)
    n = mm.batch_matmul.launches
    got = mm.batch_matmul(a, b, block_sizes=(24, 48, 16))
    torch.cuda.synchronize()
    assert mm.batch_matmul.launches == n + 1
    assert mm.batch_matmul.last_launch["variant"] == "fma"  # bm 24: ragged
    assert mm.batch_matmul.last_launch["grid"] == (1, 4, 3)
    assert float((got - tref.batch_matmul(a, b)).abs().max()) < 1e-3


def test_cuda_batch_matmul_tc_against_plain():
    """The tc twin of the test above: the same operands, a tensor-core tile."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(3, 96, 64, generator=g, device=dev)
    b = torch.randn(3, 64, 48, generator=g, device=dev)
    n = mm.batch_matmul.launches
    got = mm.batch_matmul(a, b, block_sizes=(32, 48, 16))
    torch.cuda.synchronize()
    assert mm.batch_matmul.launches == n + 1
    assert mm.batch_matmul.last_launch["variant"] == "tc"
    assert mm.batch_matmul.last_launch["grid"] == (1, 3, 3)
    assert float((got - tref.batch_matmul(a, b)).abs().max()) < 1e-3


def _k2_operands(dev, seed, B, M, K, N, layout):
    """x (B, M, K) and w (B, K, N) on the card.  "c": contiguous; "t":
    transposed views, x m-contiguous and w k-contiguous (as attention reads
    k transposed); "pad": row-major with a batch stride of one more than a
    batch's size, which breaks every batch's 16-byte alignment but the
    first."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "t":
        x = torch.randn(B, K, M, generator=g, device=dev).transpose(1, 2)
        w = torch.randn(B, N, K, generator=g, device=dev).transpose(1, 2)
    elif layout == "pad":
        x = torch.randn(B * (M * K + 1), generator=g, device=dev)
        x = x.as_strided((B, M, K), (M * K + 1, K, 1))
        w = torch.randn(B * (K * N + 1), generator=g, device=dev)
        w = w.as_strided((B, K, N), (K * N + 1, N, 1))
    else:
        x = torch.randn(B, M, K, generator=g, device=dev)
        w = torch.randn(B, K, N, generator=g, device=dev)
    return x, w


def _k2_against_plain(x, w, blocks, variant):
    n = mm.batch_matmul.launches_by_variant[variant]
    got = mm.batch_matmul(x, w, block_sizes=blocks)
    again = mm.batch_matmul(x, w, block_sizes=blocks)
    torch.cuda.synchronize()
    assert mm.batch_matmul.launches_by_variant[variant] == n + 2
    cfg = mm.batch_matmul.last_launch
    assert cfg["variant"] == variant and cfg["blocks"] == blocks
    want = tref.batch_matmul(x, w)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) < TOL_MATMUL
    assert torch.equal(got, again)  # the same bits every run
    return cfg


# the smoke's two forward contractions (b3 m768; 128x64x256 is one stage)
# and hymba-1.5b's (b5 m1280), each operand in every layout
@pytest.mark.parametrize("B,M,K,N,blocks,stages", [
    (3, 768, 256, 64, (96, 64, 32), 2),
    (3, 768, 256, 64, (128, 64, 256), 1),
    (3, 768, 64, 256, (48, 64, 64), 2),
    (5, 1280, 256, 64, (64, 64, 64), 2),
    (5, 1280, 64, 256, (128, 128, 64), 2),
])
@pytest.mark.parametrize("layout", ["c", "t", "pad"])
def test_cuda_batch_matmul_tc_variant_against_plain(B, M, K, N, blocks, stages, layout):
    dev = _cuda()
    x, w = _k2_operands(dev, B + M + K + N, B, M, K, N, layout)
    cfg = _k2_against_plain(x, w, blocks, "tc")
    bm, bn, _ = blocks
    assert cfg["grid"] == (N // bn, M // bm, B) and cfg["stages"] == stages


# the decode contraction (b12 m3 k256 n64): one split and many, bm below M,
# a bn that is not a multiple of 4 (scalar loads)
@pytest.mark.parametrize("blocks", [(3, 64, 256), (3, 64, 32), (1, 16, 64), (3, 2, 16)])
@pytest.mark.parametrize("layout", ["c", "t", "pad"])
def test_cuda_batch_matmul_splitk_against_plain(blocks, layout):
    dev = _cuda()
    B, M, K, N = 12, 3, 256, 64
    x, w = _k2_operands(dev, sum(blocks), B, M, K, N, layout)
    cfg = _k2_against_plain(x, w, blocks, "splitk")
    bm, bn, bk = blocks
    assert cfg["grid"] == (N // bn, B * (M // bm), K // bk)
    assert cfg["splits"] == K // bk


def test_cuda_batch_matmul_fma_variant_against_plain():
    dev = _cuda()
    x, w = _k2_operands(dev, 9, 3, 768, 256, 64, "t")
    cfg = _k2_against_plain(x, w, (24, 32, 32), "fma")
    assert cfg["grid"] == (2, 32, 3)


def test_cuda_batch_matmul_batch_of_one_is_matmul():
    """At B = 1 K2 runs K1's launch: the same configuration and bits."""
    dev = _cuda()
    for M, blocks in ((4, (4, 32, 32)), (256, (64, 32, 32)), (256, (32, 12, 32))):
        x, w = _k2_operands(dev, M, 1, M, 256, 96, "c")
        got = mm.batch_matmul(x, w, block_sizes=blocks)
        one = mm.matmul(x[0], w[0], block_sizes=blocks)
        torch.cuda.synchronize()
        assert mm.batch_matmul.last_launch == mm.matmul.last_launch
        assert torch.equal(got[0], one)


def test_cuda_flash_attention_against_plain():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, 9, 96, 64, generator=g, device=dev)
    k = torch.randn(1, 3, 96, 64, generator=g, device=dev)
    v = torch.randn(1, 3, 96, 64, generator=g, device=dev)
    for kw in (dict(causal=True), dict(causal=True, window=32, softcap=50.0)):
        got = fa.flash_attention(q, k, v, block_q=48, block_kv=32, **kw)
        want = tref.flash_attention(q, k, v, **kw)
        assert fa.flash_attention.last_launch["variant"] == "tc"
        assert float((got - want).abs().max()) < 1e-4


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def _k3_operands(dev, seed, H, KVH, S, D=64):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(1, H, S, D, generator=g, device=dev),
            torch.randn(1, KVH, S, D, generator=g, device=dev),
            torch.randn(1, KVH, S, D, generator=g, device=dev))


def _k3_against_plain(q, k, v, bq, bkv, variant, **kw):
    """K3 at (bq, bkv) against the plain version within 1e-4, its launch
    counted under ``variant`` with the plan of ``launch_config``, and a
    second call giving the same bits."""
    B, H, S, D = q.shape
    plan = fa.launch_config(B, H, k.shape[1], S, D, bq, bkv,
                            repro_torch.kernels.sm_count(q.device))
    assert plan["variant"] == variant
    n, by = fa.flash_attention.launches, dict(fa.flash_attention.launches_by_variant)
    got = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
    again = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 2
    assert fa.flash_attention.launches_by_variant[variant] == by[variant] + 2
    assert fa.flash_attention.last_launch == plan
    assert torch.equal(got, again)
    want = tref.flash_attention(q, k, v, **kw)
    assert float((got - want).abs().max()) < 1e-4


@pytest.mark.parametrize("bq,bkv,variant", [(8, 128, "tc"), (64, 128, "tc"), (64, 4, "fma"),
                                            (8, 2, "fma")])
def test_cuda_flash_attention_variants_count_their_launches(bq, bkv, variant):
    dev = _cuda()
    _k3_against_plain(*_k3_operands(dev, bq + bkv, 9, 3, 256), bq, bkv, variant,
                      causal=True)


# every tile of smollm-135m's forward shape (H 9, KVH 3, S 256, D 64) that
# the tc variant takes: both sides divide 256, bkv a multiple of 8
@pytest.mark.parametrize("bq", _divisors(256))
@pytest.mark.parametrize("bkv", [d for d in _divisors(256) if d % 8 == 0])
def test_cuda_flash_attention_tc_at_every_forward_tile(bq, bkv):
    dev = _cuda()
    _k3_against_plain(*_k3_operands(dev, 3, 9, 3, 256), bq, bkv, "tc", causal=True)


# S 96 and 48 (the last m16 tile of a CTA partly filled: G·bq rows of 24,
# 8, 72 or 4), each mask, G 3 and G 1
@pytest.mark.parametrize("S,bq,bkv", [(96, 8, 32), (96, 24, 48), (96, 4, 96), (48, 8, 8),
                                      (48, 24, 16), (48, 48, 24)])
@pytest.mark.parametrize("H,KVH", [(9, 3), (4, 4)])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=20),
                                dict(causal=True, softcap=50.0), dict(causal=False),
                                dict(causal=False, window=17, softcap=30.0)],
                         ids=["causal", "window", "softcap", "full", "full-window-softcap"])
def test_cuda_flash_attention_tc_masks_and_ragged_tiles(S, bq, bkv, H, KVH, kw):
    dev = _cuda()
    _k3_against_plain(*_k3_operands(dev, S + bq, H, KVH, S), bq, bkv, "tc", **kw)


def test_cuda_flash_attention_small_head_dims_and_batch():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    for B, H, KVH, S, D, bq, bkv in ((2, 4, 2, 64, 16, 8, 16), (2, 6, 3, 48, 8, 16, 24),
                                     (3, 4, 1, 32, 32, 32, 8)):
        q = torch.randn(B, H, S, D, generator=g, device=dev)
        k = torch.randn(B, KVH, S, D, generator=g, device=dev)
        v = torch.randn(B, KVH, S, D, generator=g, device=dev)
        _k3_against_plain(q, k, v, bq, bkv, "tc", causal=True, window=9)


def test_cuda_flash_attention_reads_unaligned_operands():
    # a view 4 bytes into its storage takes the 4-byte copies
    dev = _cuda()
    q, k, v = _k3_operands(dev, 9, 9, 3, 96)
    buf = torch.empty(k.numel() + 1, device=dev)
    k1 = buf[1:].view(k.shape)
    k1.copy_(k)
    assert k1.data_ptr() % 16
    got = fa.flash_attention(q, k1, v, block_q=16, block_kv=32)
    assert float((got - tref.flash_attention(q, k, v)).abs().max()) < 1e-4


@pytest.mark.parametrize("bq,bkv", [(8, 128), (16, 16)])
def test_cuda_flash_attention_replays_from_a_graph(bq, bkv):
    # the split's partials live in shared memory: two replays of one graph
    # give the eager call's bits
    dev = _cuda()
    q, k, v = _k3_operands(dev, 21, 9, 3, 256)
    want = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


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


# every kv tile that divides T = 256 and 192, so every split the plan makes
# at the serving shape (B 4, KVH 3, G 3, D 64): rows of every length (a
# length-1 slot masks every split but the first), then with a softcap and
# with a window that masks whole splits at small tiles
@pytest.mark.parametrize("T,block_kv", [(256, d) for d in _divisors(256)]
                         + [(192, d) for d in _divisors(192)])
def test_cuda_decode_attention_against_plain(T, block_kv):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(T + block_kv)
    q = torch.randn(4, 3, 3, 64, generator=g, device=dev)
    k = torch.randn(4, 3, T, 64, generator=g, device=dev)
    v = torch.randn(4, 3, T, 64, generator=g, device=dev)
    plan = fa.decode_launch_config(4, 3, 3, T, 64, block_kv,
                                   repro_torch.kernels.sm_count(dev))
    for softcap, window, lengths in ((None, 0, [T, 1, 77, T - 5]),
                                     (50.0, 0, [T, 33, 2, 150]),
                                     (None, 40, [T, 100, 64, 9])):
        bias = _bias(lengths, T, dev, window)
        n = fa.decode_flash_attention.launches
        got = fa.decode_flash_attention(q, k, v, bias, softcap=softcap,
                                        block_kv=block_kv)
        again = fa.decode_flash_attention(q, k, v, bias, softcap=softcap,
                                          block_kv=block_kv)
        torch.cuda.synchronize()
        assert fa.decode_flash_attention.launches == n + 2
        assert fa.decode_flash_attention.last_launch == plan
        assert torch.equal(got, again)
        want = tref.decode_attention(q, k, v, bias, softcap=softcap)
        assert float((got - want).abs().max()) < 1e-4


@pytest.mark.parametrize("block_kv", [8, 96])
def test_cuda_decode_attention_head_dim_without_vector_loads(block_kv):
    # D 30 takes the 4-byte loads of K and V
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(block_kv)
    q = torch.randn(4, 3, 3, 30, generator=g, device=dev)
    k = torch.randn(4, 3, 96, 30, generator=g, device=dev)
    v = torch.randn(4, 3, 96, 30, generator=g, device=dev)
    bias = _bias([96, 1, 50, 9], 96, dev, 20)
    got = fa.decode_flash_attention(q, k, v, bias, block_kv=block_kv)
    torch.cuda.synchronize()
    assert fa.decode_flash_attention.last_launch["splits"] > 1
    want = tref.decode_attention(q, k, v, bias)
    assert float((got - want).abs().max()) < 1e-4


def test_cuda_decode_attention_fills_the_card_at_small_tiles():
    dev = _cuda()
    q = torch.randn(4, 3, 3, 64, device=dev)
    k = torch.randn(4, 3, 256, 64, device=dev)
    bias = _bias([256, 1, 77, 251], 256, dev)
    fa.decode_flash_attention(q, k, k, bias, block_kv=16)
    grid = fa.decode_flash_attention.last_launch["grid"]
    assert grid == (12, 16) or repro_torch.kernels.sm_count(dev) != 132
    assert grid[0] * grid[1] >= min(132, repro_torch.kernels.sm_count(dev))


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
    plan = fa.paged_decode_flash_attention.last_launch
    assert plan == fa.decode_launch_config(B, KVH, G, P * ps, D, ps,
                                           repro_torch.kernels.sm_count(dev))
    want = fa.decode_flash_attention(q, gk, gv, bias, block_kv=ps)
    # the same splits over the same values: the same bits
    assert fa.decode_flash_attention.last_launch == plan
    assert torch.equal(got, want)
    assert float((got - tref.paged_decode_attention(q, kp, vp, table, bias))
                 .abs().max()) < 1e-4


@pytest.mark.parametrize("block_kv", [16, 64])
def test_cuda_decode_kernels_replay_from_a_graph(block_kv):
    # the split counters reset themselves, so a graph replays the same bits
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(11)
    B, KVH, G, D, ps, P = 4, 3, 3, 64, 16, 16
    n_pages = B * P + 3
    q = torch.randn(B, KVH, G, D, generator=g, device=dev)
    k = torch.randn(B, KVH, P * ps, D, generator=g, device=dev)
    v = torch.randn(B, KVH, P * ps, D, generator=g, device=dev)
    kp = torch.randn(n_pages, KVH, ps, D, generator=g, device=dev)
    vp = torch.randn(n_pages, KVH, ps, D, generator=g, device=dev)
    table = torch.randperm(n_pages - 1, generator=g, device=dev)[: B * P]
    table = table.reshape(B, P).to(torch.int32)
    table[3, 1:] = n_pages
    bias = _bias([P * ps, 1, 77, 16], P * ps, dev)

    def both():
        return (fa.decode_flash_attention(q, k, v, bias, block_kv=block_kv),
                fa.paged_decode_flash_attention(q, kp, vp, table, bias))

    want = both()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = both()
    for _ in range(2):
        for t in got:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bm", [36, 72, 144, 288])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 8e-3)])
def test_cuda_row_softmax_against_plain(bm, dtype, tol):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(6)
    x = (torch.randn(2304, 256, generator=g, device=dev) * 4).to(dtype)
    n = sm.row_softmax.launches
    got = sm.row_softmax(x, block_rows=bm)
    torch.cuda.synchronize()
    assert sm.row_softmax.launches == n + 1
    assert sm.row_softmax.last_launch["variant"] == "registers"
    assert sm.row_softmax.last_launch["blocks"] == (bm,)
    assert sm.row_softmax.last_launch["grid"] == (2304 // bm,)
    assert got.dtype == dtype
    assert float((got.float() - tref.row_softmax(x).float()).abs().max()) <= tol


# the shared-memory variant (N % 4 != 0 or N > 1024), the registers one at
# a row that leaves lanes empty (N = 132) and at its cap, and 4-byte loads
# from a base that is not 16-byte aligned (the same bits as aligned)
@pytest.mark.parametrize("M,N,bm,variant", [
    (96, 258, 24, "shared"), (64, 2000, 16, "shared"), (96, 132, 48, "registers"),
    (64, 1024, 64, "registers"),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 8e-3)])
def test_cuda_row_softmax_variants_against_plain(M, N, bm, variant, dtype, tol):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(N)
    x = (torch.randn(M, N, generator=g, device=dev) * 4).to(dtype)
    got = sm.row_softmax(x, block_rows=bm)
    torch.cuda.synchronize()
    assert sm.row_softmax.last_launch["variant"] == variant
    assert float((got.float() - tref.row_softmax(x).float()).abs().max()) <= tol
    odd = torch.empty(M * N + 1, device=dev, dtype=dtype)[1:].view(M, N)
    odd.copy_(x)
    assert torch.equal(sm.row_softmax(odd, block_rows=bm), got)


def test_cuda_row_softmax_refuses_what_the_kernel_does_not_take():
    dev = _cuda()
    x = torch.randn(2304, 258, device=dev)  # the shared variant
    with pytest.raises(ScheduleRejected) as e:
        sm.row_softmax(x, block_rows=288)
    assert e.value.reason == "shared_memory"
    with pytest.raises(ScheduleRejected) as e:
        sm.row_softmax(x[:, :256].contiguous(), block_rows=100)
    assert e.value.reason == "divide"
    with pytest.raises(TypeError):
        sm.row_softmax(x.half())
    with pytest.raises(ValueError):
        sm.row_softmax(x.t())


def _ssd_inputs(dev, batch, S, H, P, N, decay=0.3, seed=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(batch, S, H, P, generator=g, device=dev)
    la = -torch.rand(batch, S, H, generator=g, device=dev) * decay
    B = torch.randn(batch, S, N, generator=g, device=dev) * 0.3
    C = torch.randn(batch, S, N, generator=g, device=dev) * 0.3
    return x, la, B, C


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


# (batch, S, H, P, N): mamba2-370m's and hymba-1.5b's heads and states;
# S 17 and 37 (slot-arena prompts: one chunk that fills no mma tile), 48,
# 128 and 256; batch 4 and 8, where a CTA owns 3 heads of 32 or of 25
@pytest.mark.parametrize("shape,chunk,decay", [
    ((1, 256, 32, 64, 128), 64, 0.3),   # mamba2-370m's forward
    ((1, 256, 25, 64, 16), 64, 0.3),    # hymba-1.5b's
    ((1, 17, 32, 64, 128), 64, 0.3),    # a 17-token prompt: chunk 17
    ((2, 37, 25, 64, 16), 64, 0.3),     # a 37-token prompt: chunk 37
    ((2, 48, 4, 32, 16), 64, 0.3),      # a 48-token prompt: chunk 48
    ((1, 128, 4, 64, 128), 64, 20.0),   # exp overflows above the diagonal
    ((4, 256, 32, 64, 128), 64, 0.3),   # head groups of 3, the last of 2
    ((8, 128, 25, 64, 16), 64, 0.3),    # head groups of 3, the last of 1
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 8e-3)])
def test_cuda_ssd_against_plain(shape, chunk, decay, dtype, tol):
    dev = _cuda()
    x, la, B, C = _ssd_inputs(dev, *shape, decay=decay)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    L = min(chunk, shape[1])
    want, want_h = tref.ssd_chunked(x, la, B, C, chunk=L, return_state=True)
    n = ssd_k.ssd.launches
    got = ssd_k.ssd(x, la, B, C, chunk=chunk)
    got2, h = ssd_k.ssd(x, la, B, C, chunk=chunk, return_state=True)
    got3 = ssd_k.ssd(x, la, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_k.ssd.launches == n + 3
    plan = ssd_k.launch_config(*shape, chunk, repro_torch.kernels.sm_count(dev),
                               x.element_size())
    assert ssd_k.ssd.last_launch == plan
    assert plan["blocks"] == (L,) and plan["kernels"] == (1 if L == shape[1] else 2)
    assert got.dtype == dtype and h.dtype == torch.float32
    assert torch.isfinite(got.float()).all() and torch.isfinite(h).all()
    assert torch.equal(got, got2) and torch.equal(got, got3)
    assert _rel(got, want) <= tol
    assert _rel(h, want_h) <= 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 8e-3)])
def test_cuda_ssd_widths_that_fill_no_tile_and_allow_no_vector_copy(dtype, tol):
    # N 12 and P 20 pad to 16 and 32 in shared memory; in bf16 neither
    # allows 16-byte copies, and one pass slice of P holds no column of it
    dev = _cuda()
    x, la, B, C = _ssd_inputs(dev, 2, 96, 3, 20, 12)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    want, want_h = tref.ssd_chunked(x, la, B, C, chunk=32, return_state=True)
    got, h = ssd_k.ssd(x, la, B, C, chunk=32, return_state=True)
    torch.cuda.synchronize()
    plan = ssd_k.ssd.last_launch
    assert plan["kernels"] == 2 and plan["pass_grid"][0] * plan["p_slice"] > 24
    assert _rel(got, want) <= tol
    assert _rel(h, want_h) <= 1e-5


def test_cuda_ssd_main_shape_fills_the_card():
    dev = _cuda()
    x, la, B, C = _ssd_inputs(dev, 1, 256, 32, 64, 128)
    ssd_k.ssd(x.bfloat16(), la, B.bfloat16(), C.bfloat16())
    plan = ssd_k.ssd.last_launch
    if repro_torch.kernels.sm_count(dev) == 132:
        assert plan["grid"] == (32, 4, 1)  # 128 CTAs, one head each
        assert plan["pass_grid"] == (4, 32, 1)  # 128 CTAs of 8 warps
    assert plan["grid"][0] * plan["grid"][1] * plan["grid"][2] >= 128


@pytest.mark.parametrize("shape", [(1, 256, 32, 64, 128), (2, 37, 25, 64, 16)])
def test_cuda_ssd_replays_from_a_graph(shape):
    dev = _cuda()
    x, la, B, C = _ssd_inputs(dev, *shape)
    x, B, C = x.bfloat16(), B.bfloat16(), C.bfloat16()
    want, want_h = ssd_k.ssd(x, la, B, C, return_state=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd_k.ssd(x, la, B, C, return_state=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got, h = ssd_k.ssd(x, la, B, C, return_state=True)
    for _ in range(2):
        got.zero_()
        h.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(h, want_h)


def test_cuda_ssd_reads_x_through_its_strides():
    dev = _cuda()
    x, la, B, C = _ssd_inputs(dev, 1, 128, 8, 32, 16)
    xt = x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)  # (b, S, H, P) view
    assert not xt.is_contiguous()
    got = ssd_k.ssd(xt, la, B, C, chunk=32)
    assert _rel(got, tref.ssd_chunked(x, la, B, C, chunk=32)) <= 1e-5


def test_cuda_ssd_refuses_what_the_kernel_does_not_take():
    dev = _cuda()
    x, la, B, C = _ssd_inputs(dev, 1, 256, 2, 64, 128)
    with pytest.raises(ScheduleRejected) as e:
        ssd_k.ssd(x, la, B, C, chunk=256)
    assert e.value.reason == "shared_memory"
    x, la, B, C = _ssd_inputs(dev, 1, 80, 2, 16, 8)
    with pytest.raises(ScheduleRejected) as e:
        ssd_k.ssd(x, la, B, C, chunk=64)
    assert e.value.reason == "divide"
    with pytest.raises(TypeError):
        ssd_k.ssd(x.half(), la, B, C)
    with pytest.raises(TypeError):
        ssd_k.ssd(x, la.double(), B, C)


# ---------------------------------------------------------------------------
# olmoe-1b-7b's shapes: the expert products (K2), attention at D 128
# (K3's fma variant, K5 at G 1), and an MoE layer dispatched
# ---------------------------------------------------------------------------


def _replays_the_same_bits(fn):
    """Two replays of one CUDA graph that captured ``fn`` give its eager
    output's bits."""
    want = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = fn()
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            return False
    return True


# the forward's expert products (m64: wi and wg, then wo) and a prefill
# chunk's (m32), on the tc variant; the decode tick's (m4) on splitk in one
# split and in 128 and 512
@pytest.mark.parametrize("B,M,K,N,blocks,variant", [
    (64, 64, 2048, 1024, (64, 64, 32), "tc"),
    (64, 64, 1024, 2048, (32, 128, 32), "tc"),
    (64, 32, 2048, 1024, (32, 64, 64), "tc"),
    (64, 32, 1024, 2048, (32, 32, 32), "tc"),
    (64, 4, 2048, 1024, (4, 1024, 2048), "splitk"),
    (64, 4, 2048, 1024, (4, 64, 16), "splitk"),
    (64, 4, 1024, 2048, (2, 32, 2), "splitk"),
])
def test_cuda_batch_matmul_at_the_olmoe_expert_shapes(B, M, K, N, blocks, variant):
    dev = _cuda()
    x, w = _k2_operands(dev, M + K, B, M, K, N, "c")
    cfg = _k2_against_plain(x, w, blocks, variant)
    if variant == "splitk":
        assert cfg["splits"] == K // blocks[2]
    assert _replays_the_same_bits(lambda: mm.batch_matmul(x, w, block_sizes=blocks))


@pytest.mark.parametrize("S,bq,bkv", [(256, 32, 32), (256, 64, 64), (256, 16, 128),
                                      (96, 32, 32), (96, 24, 48), (96, 96, 8)])
def test_cuda_flash_attention_fma_at_head_dim_128(S, bq, bkv):
    # olmoe's attention: 16 heads of 128 over 16 kv heads, causal; tc takes
    # no D above 64, so every tile is fma
    dev = _cuda()
    q, k, v = _k3_operands(dev, S + bq + bkv, 16, 16, S, D=128)
    _k3_against_plain(q, k, v, bq, bkv, "fma", causal=True)
    assert _replays_the_same_bits(
        lambda: fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv))


@pytest.mark.parametrize("block_kv", [8, 16, 64, 128])
def test_cuda_decode_attention_at_head_dim_128_group_1(block_kv):
    # olmoe's decode tick: 4 slots, 16 kv heads of one query head, D 128
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(block_kv)
    B, KVH, G, T, D = 4, 16, 1, 256, 128
    q = torch.randn(B, KVH, G, D, generator=g, device=dev)
    k = torch.randn(B, KVH, T, D, generator=g, device=dev)
    v = torch.randn(B, KVH, T, D, generator=g, device=dev)
    bias = _bias([T, 1, 77, 200], T, dev)
    got = fa.decode_flash_attention(q, k, v, bias, block_kv=block_kv)
    torch.cuda.synchronize()
    assert fa.decode_flash_attention.last_launch == fa.decode_launch_config(
        B, KVH, G, T, D, block_kv, repro_torch.kernels.sm_count(dev))
    assert float((got - tref.decode_attention(q, k, v, bias)).abs().max()) < 1e-4
    assert _replays_the_same_bits(
        lambda: fa.decode_flash_attention(q, k, v, bias, block_kv=block_kv))


def test_cuda_moe_layer_dispatched_against_plain():
    """One olmoe-smoke MoE layer, f32, its two expert-product tasks tuned on
    the card: under DispatchContext K2 runs its three products and the
    output is the plain layer's within 1e-5; routing runs plain in both,
    so the experts are the same.  A graph replay gives the same bits."""
    from repro_torch.configs.base import get_config
    from repro_torch.integration.dispatch import DispatchContext
    from repro_torch.models import layers as TL
    from repro_torch.models import transformer as TT
    from repro_torch.search.database import Database

    dev = _cuda()
    cfg = get_config("olmoe-1b-7b", smoke=True)
    S = 16
    tasks = [t for t in repro_torch.extract_tasks(cfg, batch=1, seq=S, min_task_elems=1)
             if t.key.startswith(f"batch_matmul/b={cfg.moe_experts}/")]
    assert len(tasks) == 2
    db = Database()
    repro_torch.TaskScheduler(tasks, database=db, config=repro_torch.TuneConfig(
        search=SearchConfig(max_trials=4, init_random=2, population=4,
                            measure_per_round=2),
        runner_spec="cached+local", backend="cuda", device="cuda",
    )).tune(total_rounds=2)
    params = TT.init_params(cfg, seed=0, device="cuda")
    p = {k: t.float() for k, t in TT._layer(params["layers"], 0)["moe"].items()}
    g = torch.Generator(device=dev).manual_seed(3)
    h2 = torch.randn(1, S, cfg.d_model, generator=g, device=dev)

    def layer():
        return TL.moe(p, h2, cfg.moe_top_k, cfg.moe_capacity_factor, act=cfg.act)

    want = layer()
    ctx = DispatchContext(db, tasks=tasks, backend="cuda")
    n = mm.batch_matmul.launches
    with ctx:
        got = layer()
        torch.cuda.synchronize()
        assert mm.batch_matmul.launches == n + 3
        assert _replays_the_same_bits(layer)
    assert sum(ctx.hits_by_key.values()) >= 3
    err = float((got - want).abs().max() / want.abs().max())
    assert torch.isfinite(got).all() and err < 1e-5


# ---------------------------------------------------------------------------
# training: K7's gradient and a dispatched train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("return_state", [False, True])
def test_cuda_ssd_gradient_is_the_plain_scans(dtype, tol, return_state):
    """K7 launched on inputs that need a gradient: one launch, and the
    gradient of every input is the plain scan's (its backward is the plain
    scan's autograd; y, and so dL/dy = y, differ by K7's forward error: 1e-5
    of |y| in f32, one bf16 ulp in bf16, so the gradients within 1e-4 and
    3e-2 of each input's max |g|)."""
    from repro_torch.kernels import ops

    dev = _cuda()
    ins = _ssd_inputs(dev, 2, 128, 4, 64, 128)
    ins = [ins[0].to(dtype), ins[1], ins[2].to(dtype), ins[3].to(dtype)]
    g = torch.Generator(device=dev).manual_seed(5)
    proj = torch.randn(2, 4, 128, 64, generator=g, device=dev)
    grads = []
    for fn in (ops.ssd, tref.ssd_chunked):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        n = ssd_k.ssd.launches
        out = fn(*leaves, chunk=64, return_state=return_state)
        y, h = out if return_state else (out, None)
        loss = y.float().square().sum() / 2 + ((h * proj).sum() if h is not None else 0)
        loss.backward()
        torch.cuda.synchronize()
        assert ssd_k.ssd.launches == n + (fn is ops.ssd)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
        assert float(want.abs().max()) > 0
        assert _rel(got, want) <= tol


def test_cuda_dispatched_train_step_against_plain():
    """smollm-smoke's train step, f32, its forward tasks tuned on the card:
    under DispatchContext K1 runs at every dense site and K3 (tc) at every
    attention, twice a step with remat, and the step is the plain step's:
    the loss within 1e-5 relative, each gradient leaf within 1e-4 of its
    max |g| (f32 kernels, sums in another order), the updated parameters
    within 2·lr (the first AdamW step is about sign(g)·lr)."""
    from repro_torch.configs.base import get_config
    from repro_torch.integration.dispatch import DispatchContext
    from repro_torch.models import transformer as TT
    from repro_torch.models.registry import build_model
    from repro_torch.search.database import Database
    from repro_torch.training.optimizer import OptConfig, adamw_init, tree_leaves, tree_map
    from repro_torch.training.train_loop import make_train_step, value_and_grad

    dev = _cuda()
    cfg = get_config("smollm-135m", smoke=True)
    B, S = 2, 32
    tasks = repro_torch.extract_tasks(cfg, batch=B, seq=S, min_task_elems=16,
                                      dispatchable_only=True)
    db = Database()
    repro_torch.TaskScheduler(tasks, database=db, config=repro_torch.TuneConfig(
        search=SearchConfig(max_trials=4, init_random=2, population=4,
                            measure_per_round=2),
        runner_spec="cached+local", backend="cuda", device="cuda",
    )).tune(total_rounds=len(tasks))
    params = tree_map(lambda t: t.float(), TT.init_params(cfg, seed=0, device="cuda"))
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S + 1), generator=g,
                                     device=dev, dtype=torch.int32)}
    model, opt = build_model(cfg), OptConfig(lr=1e-3, warmup_steps=1)
    ctx = DispatchContext(db, tasks=tasks, backend="cuda")
    n1, n3 = mm.matmul.launches, fa.flash_attention.launches
    new_d, _, m_d = make_train_step(model, opt, dispatch=ctx)(
        params, adamw_init(params), batch)
    torch.cuda.synchronize()
    dense_hits = sum(n for k, n in ctx.hits_by_key.items() if k.startswith("dense/"))
    assert dense_hits == 2 * 7 * cfg.n_layers + 1
    assert mm.matmul.launches - n1 == dense_hits
    assert fa.flash_attention.launches - n3 == 2 * cfg.n_layers
    new_p, _, m_p = make_train_step(model, opt)(params, adamw_init(params), batch)
    assert abs(float(m_d["loss"]) - float(m_p["loss"])) <= 1e-5 * float(m_p["loss"])
    for a, b in zip(tree_leaves(new_d), tree_leaves(new_p)):
        assert float((a - b).abs().max()) <= 2 * opt.lr
    with ctx:
        _, g_d = value_and_grad(model.loss, params, batch)
    _, g_p = value_and_grad(model.loss, params, batch)
    for a, b in zip(tree_leaves(g_d), tree_leaves(g_p)):
        assert float(b.abs().max()) > 0 and _rel(a, b) <= 1e-4


# whisper-medium's encoder self-attention: 16 heads of 64 over 1500 frames,
# not causal.  No divisor of 1500 is a multiple of 8, so every tile K3 takes
# there is fma
@pytest.mark.parametrize("bq,bkv", [(60, 50), (125, 125), (250, 20), (30, 300)])
def test_cuda_flash_attention_non_causal_at_the_whisper_encoder_shape(bq, bkv):
    dev = _cuda()
    q, k, v = _k3_operands(dev, bq + bkv, 16, 16, 1500)
    _k3_against_plain(q, k, v, bq, bkv, "fma", causal=False)
    assert _replays_the_same_bits(
        lambda: fa.flash_attention(q, k, v, causal=False, block_q=bq, block_kv=bkv))


# whisper-medium's cross-attention decode: 4 slots, 16 kv heads of one query
# head, D 64, over the fixed 1500-frame encoder cache, at kv tiles of 1 to
# 375 rows (a larger one overflows shared memory)
@pytest.mark.parametrize("block_kv", [1, 4, 50, 125, 375])
def test_cuda_decode_attention_over_the_whisper_cross_attention_cache(block_kv):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(block_kv)
    B, KVH, G, T, D = 4, 16, 1, 1500, 64
    q = torch.randn(B, KVH, G, D, generator=g, device=dev)
    k = torch.randn(B, KVH, T, D, generator=g, device=dev)
    v = torch.randn(B, KVH, T, D, generator=g, device=dev)
    plan = fa.decode_launch_config(B, KVH, G, T, D, block_kv,
                                   repro_torch.kernels.sm_count(dev))
    for lengths in ([T] * B, [T, 1, 777, T - 3]):
        bias = _bias(lengths, T, dev)
        got = fa.decode_flash_attention(q, k, v, bias, block_kv=block_kv)
        torch.cuda.synchronize()
        assert fa.decode_flash_attention.last_launch == plan
        assert float((got - tref.decode_attention(q, k, v, bias)).abs().max()) < 1e-4
    assert _replays_the_same_bits(
        lambda: fa.decode_flash_attention(q, k, v, bias, block_kv=block_kv))


def test_cuda_pool_measures_in_spawned_workers_sharing_the_card():
    """Two spawned pool workers time K1 candidates on one card, in turns
    under the card's timing lock: every candidate comes back measured or
    rejected by the lowering, with the kernel's provenance and the launches
    the worker's counters saw (at least the first call, one warmup and
    three repeats, split by variant), and nothing times out, crashes or is
    quarantined."""
    _cuda()
    from repro_torch.core.modules import SpaceGenerator, default_modules
    from repro_torch.core.workloads import get_workload
    from repro_torch.search.measure import MeasureInput, create_runner

    func = get_workload("dense", m=256, n=576, k=576)
    space = SpaceGenerator(default_modules())
    inputs = [MeasureInput("dense/k=576/m=256/n=576", func,
                           space.generate(func, seed=s).trace) for s in range(6)]
    runner = create_runner("cached+pool://workers=2", device="cuda")
    try:
        out = runner.run(inputs)
        stats = runner.stats()
    finally:
        runner.close()
    assert len(out) == len(inputs)
    for r in out:
        assert r.ok or r.error.startswith(("rejected (", "invalid trace"))
        if r.ok:
            assert r.meta["pallas_kernel"] == "matmul" and 0 < r.latency_s < 1.0
            launched = r.meta["launches"]
            assert launched["matmul"] >= 5
            assert sum(n for k, n in launched.items()
                       if k.startswith("matmul/")) == launched["matmul"]
    assert any(r.ok for r in out)
    assert (stats["inner_timeouts"], stats["inner_crashes"],
            stats["inner_quarantined_traces"]) == (0, 0, 0)

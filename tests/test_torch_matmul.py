"""K1's and K2's launch configuration on the CPU: which variant a tile
takes, and the grid, threads, shared memory, stages and splits it launches
with.

The variant is chosen from M and the snapped tile alone (``splitk`` for
M < 16, ``tc`` for bm % 16, bn % 8 and bk % 8 all 0, ``fma`` otherwise), by
one rule for both products, so the search's sampled tile decides the launch
before any card is involved.  K2's batch rides grid y for ``splitk``
(batch-major over the row tiles) and grid z for ``tc`` and ``fma``.  The
kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``-m cuda -k "matmul"``).  No tolerances: the numbers here are exact.
"""

import pytest

import repro_torch
from repro_torch.kernels import ScheduleRejected
from repro_torch.kernels import matmul as mm
from repro_torch.search.evolutionary import SearchConfig


def _splitk_smem(bm, bn, bk):
    return 4 * (bm * bk + 4 * bm * bn)


def _tc_stage(bm, bn, bk):
    pad = 8 if bn % 16 == 0 else 0
    return 4 * (max(bm * (bk + 4), bk * (bm + 8)) + max(bk * (bn + pad), bn * (bk + 4)))


@pytest.mark.parametrize("M,N,K,blocks,want", [
    # decode (M = 4): the split is K / bk, grid z
    (4, 576, 576, (4, 64, 36),
     dict(variant="splitk", grid=(9, 1, 16), splits=16, stages=1, threads=128,
          smem_bytes=_splitk_smem(4, 64, 36), warp_tile=None)),
    (4, 576, 576, (4, 64, 576),
     dict(variant="splitk", grid=(9, 1, 1), splits=1, smem_bytes=_splitk_smem(4, 64, 576))),
    (4, 576, 576, (4, 18, 64), dict(variant="splitk", grid=(32, 1, 9), splits=9)),
    (4, 49152, 576, (4, 256, 96), dict(variant="splitk", grid=(192, 1, 6), splits=6)),
    (4, 1536, 576, (2, 96, 96), dict(variant="splitk", grid=(16, 2, 6))),
    (15, 60, 30, (5, 12, 10), dict(variant="splitk", grid=(5, 3, 3), splits=3)),
    # the default tile at M = 4, clamped as the wrapper clamps it
    (4, 256, 256, mm._clamp(mm.DEFAULT_BLOCKS, 4, 256, 256),
     dict(variant="splitk", grid=(2, 1, 2), smem_bytes=_splitk_smem(4, 128, 128))),
    # M >= 16 with a tensor-core tile
    (16, 64, 64, (16, 64, 64),
     dict(variant="tc", grid=(1, 1, 1), warp_tile=(1, 1), threads=256, stages=2,
          splits=1, smem_bytes=2 * _tc_stage(16, 64, 64))),
    (96, 120, 72, (32, 40, 24),
     dict(variant="tc", grid=(3, 3, 1), warp_tile=(1, 1), threads=320, stages=2)),
    (256, 576, 576, (64, 64, 32),
     dict(variant="tc", grid=(9, 4, 1), warp_tile=(1, 2), threads=512, stages=2,
          smem_bytes=2 * _tc_stage(64, 64, 32))),
    (256, 49152, 576, (64, 192, 64),
     dict(variant="tc", grid=(256, 4, 1), warp_tile=(2, 4), threads=384, stages=2)),
    (256, 1536, 576, (128, 192, 96),
     dict(variant="tc", warp_tile=(4, 4), threads=384, stages=1,
          smem_bytes=_tc_stage(128, 192, 96))),
    # DEFAULT_BLOCKS stay legal: one stage of 139,264 bytes
    (256, 256, 256, mm.DEFAULT_BLOCKS,
     dict(variant="tc", grid=(2, 2, 1), warp_tile=(2, 4), threads=512, stages=1,
          smem_bytes=139264)),
    # tiles neither of the others takes: bm = 8 at M = 256, bk = 36, bn = 12
    (256, 576, 576, (8, 64, 32),
     dict(variant="fma", grid=(9, 32, 1), stages=1, splits=1, warp_tile=None,
          micro_tile=1, threads=512, smem_bytes=4 * (8 * 32 + 32 * 64))),
    (256, 1536, 576, (128, 8, 36),
     dict(variant="fma", grid=(192, 2, 1), micro_tile=2, threads=256,
          smem_bytes=4 * (128 * 36 + 36 * 8))),
    (256, 576, 576, (32, 12, 32), dict(variant="fma", grid=(48, 8, 1))),
])
def test_matmul_launch_config_picks_the_variant(M, N, K, blocks, want):
    cfg = mm.launch_config(1, M, N, K, blocks)
    assert mm.variant(M, blocks) == cfg["variant"]
    assert cfg["blocks"] == tuple(blocks)
    assert {k: cfg[k] for k in want} == want
    assert cfg["smem_bytes"] <= mm.MAX_SMEM_BYTES
    assert set(cfg) == {"variant", "blocks", "grid", "threads", "smem_bytes",
                        "stages", "splits", "warp_tile", "micro_tile"}


@pytest.mark.parametrize("M,N,K,blocks,reason", [
    (256, 576, 576, (96, 64, 32), "divide"),
    (4, 576, 576, (4, 64, 40), "divide"),
    (4, 49152, 576, (4, 4096, 576), "shared_memory"),  # splitk partials
    (256, 1536, 576, (256, 1536, 576), "shared_memory"),  # one tc stage
    (256, 256, 64, (256, 256, 64), "threads"),  # tc: > 16 warps of 4x4
    (256, 1024, 36, (256, 1024, 36), "threads"),  # fma: > 512 threads
    (4, 8, 70000, (4, 8, 1), "grid"),  # splitk: K / bk > 65535
    (16 * 65536, 8, 8, (16, 8, 8), "grid"),  # tc: M / bm > 65535
])
def test_matmul_launch_config_rejects_by_reason(M, N, K, blocks, reason):
    with pytest.raises(ScheduleRejected) as e:
        mm.launch_config(1, M, N, K, blocks)
    assert e.value.reason == reason


# K2 takes K1's variant for its M and tile, with the batch on the variant's
# batch axis: the smoke's forward (b3 m768), decode (b12 m3) and hymba's
# (b5 m1280) shapes
@pytest.mark.parametrize("batch,M,N,K,blocks,want", [
    (12, 3, 64, 256, (3, 64, 32),
     dict(variant="splitk", grid=(1, 12, 8), splits=8, threads=128, stages=1,
          smem_bytes=_splitk_smem(3, 64, 32), warp_tile=None, micro_tile=None)),
    (12, 3, 64, 256, (3, 16, 256),
     dict(variant="splitk", grid=(4, 12, 1), splits=1)),
    (2, 4, 64, 64, (2, 64, 64), dict(variant="splitk", grid=(1, 4, 1), splits=1)),
    (5, 15, 60, 30, (5, 12, 10), dict(variant="splitk", grid=(5, 15, 3), splits=3)),
    (3, 768, 64, 256, (96, 64, 32),
     dict(variant="tc", grid=(1, 8, 3), warp_tile=(2, 2), threads=384, stages=2,
          splits=1, smem_bytes=2 * _tc_stage(96, 64, 32), micro_tile=None)),
    (3, 768, 256, 64, (48, 64, 64),
     dict(variant="tc", grid=(4, 16, 3), warp_tile=(1, 2), threads=384, stages=2)),
    (5, 1280, 64, 256, (64, 64, 64), dict(variant="tc", grid=(1, 20, 5), stages=2)),
    (5, 1280, 256, 64, (128, 128, 64), dict(variant="tc", grid=(2, 10, 5), stages=2,
                                        smem_bytes=139264)),
    (3, 768, 256, 64, (24, 32, 32),
     dict(variant="fma", grid=(8, 32, 3), micro_tile=2, threads=192,
          smem_bytes=4 * (24 * 32 + 32 * 32))),
])
def test_batch_matmul_launch_config_picks_the_variant(batch, M, N, K, blocks, want):
    cfg = mm.launch_config(batch, M, N, K, blocks)
    assert cfg["variant"] == mm.variant(M, blocks)
    assert {k: cfg[k] for k in want} == want
    # the per-batch launch is K1's: only the batch axis differs
    one = mm.launch_config(1, M, N, K, blocks)
    axis = 1 if cfg["variant"] == "splitk" else 2
    grid = list(one["grid"])
    grid[axis] *= batch
    assert cfg == dict(one, grid=tuple(grid))


# ragged tiles (bm % 16 != 0 at M >= 16) stay on the FMA kernel, for K2 as
# for K1, with the batch on grid z
@pytest.mark.parametrize("batch,M,N,K,blocks", [
    (3, 768, 256, 64, (24, 32, 32)),
    (3, 768, 64, 256, (24, 64, 32)),
    (5, 1280, 64, 256, (40, 64, 64)),
])
def test_batch_matmul_launch_config_is_the_fma_kernels(batch, M, N, K, blocks):
    bm, bn, bk = blocks
    t, threads = mm.micro_tile(bm, bn)
    want = {"variant": "fma", "blocks": blocks, "grid": (N // bn, M // bm, batch),
            "threads": threads, "micro_tile": t, "smem_bytes": 4 * (bm * bk + bk * bn),
            "stages": 1, "splits": 1, "warp_tile": None}
    assert mm.launch_config(batch, M, N, K, blocks) == want


@pytest.mark.parametrize("batch,M,N,K,blocks,reason", [
    (2, 4, 8, 70000, (4, 8, 1), "grid"),  # splitk: grid z = K / bk > 65535
    (2, 16 * 65536, 8, 8, (16, 8, 8), "grid"),  # tc: grid y = M / bm > 65535
    (2, 70000, 8, 8, (1, 8, 8), "grid"),  # fma: grid y = M / bm > 65535
    (70000, 70000, 8, 8, (1, 8, 8), "grid"),  # fma: one batch's rows already too many
    (3, 768, 64, 256, (96, 64, 40), "divide"),
])
def test_batch_matmul_launch_config_rejects_by_reason(batch, M, N, K, blocks, reason):
    with pytest.raises(ScheduleRejected) as e:
        mm.launch_config(batch, M, N, K, blocks)
    assert e.value.reason == reason


def test_batch_matmul_splitk_grid_fits_at_the_cap():
    cfg = mm.launch_config(65535, 1, 8, 8, (1, 8, 8))
    assert cfg["grid"] == (1, 65535, 1) and cfg["variant"] == "splitk"


# A batch over the card's 65,535 blocks of grid y (splitk, with the M
# tiles) or z (tc, fma) runs as several launches, each over at most
# batches_per_launch batches: hymba-1.5b's train step extracts a product
# of 65536 batches (m1 n25 k1), which the reference tunes
@pytest.mark.parametrize("batch,M,N,K,blocks,per,grid", [
    (70000, 1, 8, 8, (1, 8, 8), 65535, (1, 65535, 1)),  # splitk
    (9000, 8, 8, 8, (1, 8, 8), 8191, (1, 65528, 1)),  # splitk: 8 row tiles a batch
    (65536, 32, 8, 8, (32, 8, 8), 65535, (1, 1, 65535)),  # tc
    (65536, 24, 8, 8, (24, 8, 8), 65535, (1, 1, 65535)),  # fma
    (65536, 1, 25, 1, (1, 25, 1), 65535, (1, 65535, 1)),  # hymba's train step
])
def test_batch_matmul_splits_a_batch_over_the_grid_cap(batch, M, N, K, blocks, per, grid):
    cfg = mm.launch_config(batch, M, N, K, blocks)
    assert cfg["grid"] == grid
    assert mm.batches_per_launch(cfg["variant"], batch, M // blocks[0]) == per
    assert cfg == mm.launch_config(per, M, N, K, blocks)


def test_cpu_matmul_counts_no_variant():
    import torch

    before = dict(mm.matmul.launches_by_variant)
    mm.matmul(torch.ones(4, 8), torch.ones(8, 16), block_sizes=(4, 8, 8))
    assert mm.matmul.launches_by_variant == before
    assert set(before) == set(mm.VARIANTS)


def test_cpu_batch_matmul_counts_no_variant():
    import torch

    before = dict(mm.batch_matmul.launches_by_variant)
    launches = mm.batch_matmul.launches
    y = mm.batch_matmul(torch.ones(2, 4, 8), torch.ones(2, 8, 16), block_sizes=(4, 8, 8))
    assert torch.equal(y, torch.full((2, 4, 16), 8.0))
    assert mm.batch_matmul.launches_by_variant == before
    assert mm.batch_matmul.launches == launches
    assert set(before) == set(mm.VARIANTS)


def test_dense_lowering_asks_for_k1s_configuration(monkeypatch):
    """``lower_dense`` checks a tile against K1's configuration: the shared
    launch configuration at batch 1."""
    calls = []
    real = mm.launch_config

    def spy(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(mm, "launch_config", spy)
    r = repro_torch.tune_workload(
        "dense", m=4, n=64, k=48,
        config=repro_torch.TuneConfig(
            search=SearchConfig(max_trials=3, init_random=2, population=3,
                                measure_per_round=2),
            backend="cuda", device="cpu"),
    )
    assert r.trials > 0
    assert calls and set(calls) == {1}

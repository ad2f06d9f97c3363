"""The port's kernels K1-K4 against the JAX package's, on the CPU.

On the CPU each wrapper runs its plain PyTorch version; those are held
against ``repro.kernels.ref`` and against the Pallas kernels in interpret
mode, on the same numpy inputs made from a seed.  Tolerances are float32
ones: the two frameworks sum in different orders (matmul rtol/atol 2e-4,
as the JAX package's own kernel tests use).  The launch-configuration
arithmetic that decides which tiles the card can run is pure Python and is
tested here too; the CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.matmul import batch_matmul as pallas_bmm
from repro.kernels.matmul import matmul as pallas_matmul
from repro.kernels.softmax import row_softmax as pallas_softmax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ScheduleRejected
from repro_torch.kernels import ref as tref
from repro_torch.kernels import softmax as sm

RTOL = ATOL = 2e-4


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


EPILOGUES = ["none", "bias", "relu", "bias_relu", "bias_gelu", "bias_silu",
             "gelu", "silu", "softcap"]


@pytest.mark.parametrize("ep", EPILOGUES)
def test_matmul_epilogues_match_reference_and_pallas(ep):
    r = _rng(1)
    x = r.standard_normal((64, 48), dtype=np.float32)
    w = r.standard_normal((48, 96), dtype=np.float32)
    b = r.standard_normal((96,), dtype=np.float32) if "bias" in ep else None
    launches = mm.matmul.launches
    got = mm.matmul(_t(x), _t(w), None if b is None else _t(b), epilogue=ep,
                    block_sizes=(32, 48, 16))
    assert mm.matmul.launches == launches  # CPU tensor: plain version, no launch
    want = np.asarray(jref.matmul(x, w, b, ep))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    pal = np.asarray(pallas_matmul(x, w, b, epilogue=ep, block_sizes=(32, 32, 16)))
    np.testing.assert_allclose(got.numpy(), pal, rtol=RTOL, atol=ATOL)


def test_matmul_reads_a_transposed_weight():
    r = _rng(2)
    x = r.standard_normal((32, 24), dtype=np.float32)
    table = r.standard_normal((80, 24), dtype=np.float32)  # (vocab, d)
    got = mm.matmul(_t(x), _t(table).t())
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.matmul(x, table.T)), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("B,M,N,K,blocks", [
    (3, 96, 32, 64, (48, 32, 32)),
    (2, 48, 64, 48, (24, 64, 16)),
    (12, 3, 64, 256, (3, 64, 32)),  # the decode contraction (splitk on the card)
    (5, 80, 64, 32, (16, 32, 16)),  # hymba's layout, narrow (tc on the card)
])
def test_batch_matmul_matches_pallas(B, M, N, K, blocks):
    r = _rng(3)
    x = r.standard_normal((B, M, K), dtype=np.float32)
    w = r.standard_normal((B, K, N), dtype=np.float32)
    got = mm.batch_matmul(_t(x), _t(w), block_sizes=blocks)
    pal = np.asarray(pallas_bmm(x, w, block_sizes=blocks))
    np.testing.assert_allclose(got.numpy(), pal, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(), np.einsum("bmk,bkn->bmn", x, w), rtol=RTOL, atol=ATOL
    )


ATTN_CASES = [
    # B, H, KVH, S, D, causal, window, softcap, bq, bkv
    (1, 4, 4, 64, 16, True, None, None, 32, 32),
    (2, 6, 3, 48, 16, True, None, None, 20, 13),  # S=48: blocks snap
    (1, 9, 3, 48, 8, True, 16, None, 16, 48),  # GQA 9/3, sliding window
    (1, 4, 2, 32, 8, True, None, 30.0, 8, 16),  # softcap before the mask
    (1, 2, 1, 32, 8, False, None, None, 32, 32),
    (2, 6, 2, 48, 8, True, 8, 20.0, 12, 24),
]


@pytest.mark.parametrize("B,H,KVH,S,D,causal,win,cap,bq,bkv", ATTN_CASES)
def test_flash_attention_matches_reference_and_pallas(
    B, H, KVH, S, D, causal, win, cap, bq, bkv
):
    r = _rng(4)
    q = r.standard_normal((B, H, S, D), dtype=np.float32) * 0.5
    k = r.standard_normal((B, KVH, S, D), dtype=np.float32) * 0.5
    v = r.standard_normal((B, KVH, S, D), dtype=np.float32)
    kw = dict(causal=causal, window=win, softcap=cap)
    launches = fa.flash_attention.launches
    got = fa.flash_attention(_t(q), _t(k), _t(v), block_q=bq, block_kv=bkv, **kw)
    assert fa.flash_attention.launches == launches
    want = np.asarray(jref.flash_attention(q, k, v, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    pal = np.asarray(pallas_flash(q, k, v, block_q=bq, block_kv=bkv, **kw))
    np.testing.assert_allclose(got.numpy(), pal, rtol=1e-4, atol=1e-5)


def test_flash_attention_masks_with_minus_1e30_not_inf():
    # a row whose every score is masked stays finite (uniform weights), as
    # in the reference: the mask value is -1e30, not -inf
    q = torch.zeros(1, 1, 4, 2)
    k = torch.zeros(1, 1, 4, 2)
    v = torch.arange(8, dtype=torch.float32).reshape(1, 1, 4, 2)
    out = tref.flash_attention(q, k, v, causal=True, window=0)
    assert torch.isfinite(out).all()


def test_gelu_is_exact_not_tanh():
    y = torch.linspace(-3, 3, 13)
    got = tref.apply_epilogue(y, "gelu").numpy()
    want = np.asarray(jref.apply_epilogue(y.numpy(), "gelu"))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,target,want", [(48, 20, 24), (48, 13, 12), (256, 48, 64),
                                           (96, 64, 48), (7, 3, 1)])
def test_best_divisor_matches_reference(n, target, want):
    from repro.kernels.flash_attention import best_divisor as jbest

    assert fa.best_divisor(n, target) == jbest(n, target) == want


def test_launch_config_follows_the_tile():
    cfg = mm.launch_config(3, 768, 256, 64, (96, 64, 32))
    assert cfg["variant"] == "tc" and cfg["grid"] == (4, 8, 3)
    assert cfg["smem_bytes"] == cfg["stages"] * mm.tc_stage_bytes(96, 64, 32)
    (wm, wn), threads = mm.warp_tile(96, 64)
    assert cfg["threads"] == threads == 32 * (96 // (16 * wm)) * (64 // (8 * wn)) <= 512
    # K3 at smollm's forward shape: 64 positions x 3 heads = 12 m16 tiles a
    # q block, two a CTA; 72 CTAs of 4 kv splits, 2 runs of 128-key tiles
    # with 2 parts each, one round (one stage)
    acfg = fa.launch_config(1, 9, 3, 256, 64, 64, 128, 132)
    assert acfg["variant"] == "tc" and acfg["grid"] == (4 * 3 * 6,)
    assert (acfg["m_warps"], acfg["groups"], acfg["tiles"], acfg["sub"]) == (2, 6, 2, 2)
    assert acfg["splits"] == 4 and acfg["threads"] == 32 * 2 * 4
    assert acfg["stages"] == 1 and acfg["kv_step"] == 32
    assert acfg["smem_bytes"] == fa.tc_smem_bytes(128, 64, 2, 2, 4, 1) == 4 * (2 * 16 + 2 * 2 * 128) * 68
    fcfg = fa.launch_config(1, 9, 3, 256, 64, 64, 4, 132)
    assert fcfg["variant"] == "fma" and fcfg["grid"] == (4, 9)
    assert fcfg["threads"] == fa.THREADS and fcfg["smem_bytes"] == fa.smem_bytes(64, 4, 64)


@pytest.mark.parametrize("call", [
    lambda: mm.launch_config(1, 256, 1536, 576, (256, 1536, 576)),  # smem
    lambda: mm.launch_config(1, 1024, 1024, 4, (512, 512, 4)),  # threads
    lambda: mm.launch_config(1, 256, 256, 64, (96, 64, 32)),  # divisibility
    lambda: fa.launch_config(1, 9, 3, 512, 64, 512, 512, 132),  # smem
])
def test_launch_config_rejects_what_the_card_cannot_run(call):
    with pytest.raises(ValueError):
        call()


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


# K3's plan at smollm-135m's forward shape (B 1, H 9, KVH 3, S 256, D 64) on
# 132 SMs, for every tile whose sides divide 256
@pytest.mark.parametrize("bq", _divisors(256))
@pytest.mark.parametrize("bkv", _divisors(256))
def test_flash_attention_launch_config_at_the_forward_shape(bq, bkv):
    cfg = fa.launch_config(1, 9, 3, 256, 64, bq, bkv, 132)
    assert cfg["blocks"] == (bq, bkv) and cfg["smem_bytes"] <= fa.MAX_SMEM_BYTES
    if bkv % 8:
        assert cfg["variant"] == "fma" and cfg["grid"] == (256 // bq, 9)
        assert cfg["threads"] == 256 and cfg["smem_bytes"] == fa.smem_bytes(bq, bkv, 64)
        assert cfg["splits"] == cfg["stages"] == 1
        return
    assert cfg["variant"] == "tc"
    m_tiles = -(-3 * bq // 16)
    mw = cfg["m_warps"]
    assert mw == (2 if m_tiles % 2 == 0 else 1) and cfg["groups"] == m_tiles // mw
    ctas = (256 // bq) * 3 * cfg["groups"]
    assert cfg["grid"] == (ctas,)
    tiles, sub, splits = cfg["tiles"], cfg["sub"], cfg["splits"]
    assert splits == tiles * sub and 1 <= tiles <= 256 // bkv
    assert cfg["threads"] == 32 * mw * splits <= 32 * fa.TC_MAX_WARPS
    # as many splits as bring the card to 8 warps an SM, within 8 warps a
    # CTA, shrunk only to fit shared memory
    want = min(fa.TC_MAX_WARPS // mw, -(-fa.TC_WARPS_PER_SM * 132 // (ctas * mw)))
    assert splits <= want and (splits == want or cfg["smem_bytes"] > fa.MAX_SMEM_BYTES // 2)
    assert bkv % (sub * cfg["kv_step"]) == 0 and cfg["kv_step"] in (8, 16, 32)
    rounds = -(-(256 // bkv) // tiles)
    assert cfg["stages"] == (2 if rounds > 1 else 1)
    assert cfg["smem_bytes"] == fa.tc_smem_bytes(bkv, 64, mw, tiles, splits, cfg["stages"])


@pytest.mark.parametrize("bq,bkv,plan", [
    # the search's tile in PERF.md's run 15: 24 rows, two m16 tiles (the
    # second half padded), 2 runs of one 128-key tile, 2 parts each
    (8, 128, dict(grid=(96,), threads=256, m_warps=2, groups=1, tiles=2, sub=2,
                  stages=1, kv_step=32, smem_bytes=4 * (2 * 16 + 2 * 2 * 128) * 68)),
    # 48 rows: three m16 tiles a q block, one a CTA; 8 runs of 16-key
    # tiles, two rounds at the last q block
    (16, 16, dict(grid=(144,), threads=256, m_warps=1, groups=3, tiles=8, sub=1,
                  stages=2, kv_step=16, smem_bytes=4 * (16 + 2 * 8 * 2 * 16) * 68)),
    # one whole-sequence kv tile: one run, 4 parts of 64 keys
    (64, 256, dict(grid=(72,), threads=256, m_warps=2, groups=6, tiles=1, sub=4,
                   stages=1, kv_step=32, smem_bytes=4 * (2 * 16 + 2 * 256) * 68)),
    (1, 8, dict(grid=(768,), threads=64, m_warps=1, groups=1, tiles=2, sub=1,
                stages=2, kv_step=8, smem_bytes=4 * (16 + 2 * 2 * 2 * 8) * 68)),
])
def test_flash_attention_tc_plans(bq, bkv, plan):
    cfg = fa.launch_config(1, 9, 3, 256, 64, bq, bkv, 132)
    assert {k: cfg[k] for k in plan} == plan
    assert cfg["splits"] == plan["tiles"] * plan["sub"]


def test_flash_attention_splits_follow_the_sm_count():
    # one SM wants no split; a card the CTAs alone fill wants none either
    assert fa.launch_config(1, 9, 3, 256, 64, 16, 16, 1)["splits"] == 1
    assert fa.launch_config(64, 9, 3, 256, 64, 16, 16, 132)["splits"] == 1
    assert fa.launch_config(1, 9, 3, 256, 64, 16, 16, 132)["splits"] == 8
    # check_tile: the plan of one SM, the least shared memory
    assert fa.check_tile(1, 9, 3, 256, 64, 16, 16) == fa.launch_config(
        1, 9, 3, 256, 64, 16, 16, 1)


@pytest.mark.parametrize("D,bkv,variant", [(64, 8, "tc"), (64, 4, "fma"), (16, 24, "tc"),
                                           (8, 16, "tc"), (48, 16, "fma"), (128, 64, "fma"),
                                           (64, 12, "fma")])
def test_flash_attention_variant_rule(D, bkv, variant):
    assert fa.variant(D, bkv) == variant
    assert fa.launch_config(1, 4, 2, 96 if bkv in (12, 24) else 64, D, 16, bkv,
                            132)["variant"] == variant


@pytest.mark.parametrize("args,reason", [
    ((1, 9, 3, 256, 64, 48, 64), "divide"),
    ((1, 9, 3, 256, 64, 64, 48), "divide"),
    ((1, 9, 3, 512, 64, 16, 512), "shared_memory"),  # tc: one 512-row K and V tile
    ((1, 4, 2, 256, 128, 256, 256), "shared_memory"),  # fma (D 128)
    ((8000, 9, 3, 16, 128, 16, 4), "grid"),  # fma: B·H > 65535
])
def test_flash_attention_launch_config_rejections(args, reason):
    with pytest.raises(ScheduleRejected) as e:
        fa.launch_config(*args, 132)
    assert e.value.reason == reason
    with pytest.raises(ScheduleRejected):
        fa.check_tile(*args)


def _split_run(n, ns, s):
    base, rem = divmod(n, ns)
    return s * base + min(s, rem), base + (1 if s < rem else 0)


def _tc_split_plain(q, k, v, cfg, causal, window, softcap):
    """A plain model of the tc kernel's order of work (csrc/flash_attention.cu):
    per CTA and m16 tile, each kv split's online softmax over its chunks of
    kv_step keys (the kernel's skips included), then the partials combined
    in split order."""
    B, H, S, D = q.shape
    KVH = k.shape[1]
    G = H // KVH
    bq, bkv = cfg["blocks"]
    mw, groups, tiles, sub, step = (cfg[x] for x in ("m_warps", "groups", "tiles", "sub",
                                                     "kv_step"))
    scale, R, span, neg = D ** -0.5, G * bq, bkv // sub, -1e30
    out = torch.zeros_like(q)
    for b in range(B):
        for kvh in range(KVH):
            for q0 in range(0, S, bq):
                for grp in range(groups):
                    c_r0 = grp * mw * 16
                    c_r1 = min(R, c_r0 + mw * 16)
                    kv_hi = q0 + (c_r1 - 1) // G + 1 if causal else S
                    kv_lo = max(0, q0 + c_r0 // G - window + 1) if window else 0
                    t_lo = kv_lo // bkv
                    n_t = -(-kv_hi // bkv) - t_lo
                    for wm in range(mw):
                        rows = list(range(c_r0 + 16 * wm, min(R, c_r0 + 16 * wm + 16)))
                        pos = torch.tensor([q0 + r // G for r in rows])
                        heads = torch.tensor([kvh * G + r % G for r in rows])
                        lo, hi = int(pos[0]), int(pos[-1])
                        qr = q[b, heads, pos]
                        parts = []
                        for split in range(tiles * sub):
                            run, part = divmod(split, sub)
                            start, count = _split_run(n_t, tiles, run)
                            m = torch.full((len(rows),), neg)
                            l = torch.zeros(len(rows))
                            acc = torch.zeros(len(rows), D)
                            for r in range(count):
                                key_t = (t_lo + start + r) * bkv
                                for c0 in range(part * span, (part + 1) * span, step):
                                    key0 = key_t + c0
                                    if causal and key0 > hi:
                                        break
                                    if window and key0 + step - 1 < lo - window + 1:
                                        continue
                                    keys = torch.arange(key0, key0 + step)
                                    s = (qr @ k[b, kvh, keys].T) * scale
                                    if softcap:
                                        s = softcap * torch.tanh(s / softcap)
                                    keep = torch.ones_like(s, dtype=torch.bool)
                                    if causal:
                                        keep &= keys[None, :] <= pos[:, None]
                                    if window:
                                        keep &= pos[:, None] - keys[None, :] < window
                                    s = torch.where(keep, s, torch.full_like(s, neg))
                                    mn = torch.maximum(m, s.max(1).values)
                                    alpha = torch.exp(m - mn)
                                    p = torch.exp(s - mn[:, None])
                                    l = l * alpha + p.sum(1)
                                    acc = acc * alpha[:, None] + p @ v[b, kvh, keys]
                                    m = mn
                            parts.append((m, l, acc))
                        mt = torch.stack([p[0] for p in parts]).max(0).values
                        l_tot, acc_tot = torch.zeros_like(mt), torch.zeros(len(rows), D)
                        for m_s, l_s, acc_s in parts:  # in split order
                            w = torch.exp(m_s - mt)
                            l_tot = l_tot + w * l_s
                            acc_tot = acc_tot + w[:, None] * acc_s
                        out[b, heads, pos] = acc_tot / torch.clamp(l_tot, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("B,H,KVH,S,D,causal,win,cap,bq,bkv", ATTN_CASES)
def test_flash_attention_tc_split_and_combine_match_reference(
    B, H, KVH, S, D, causal, win, cap, bq, bkv, sms
):
    """The tc kernel's split of each q block's kv range over warps and its
    combine in split order, as plain PyTorch, against the JAX package's
    reference: the same function up to summation order (rtol 1e-4, atol
    1e-5).  A case whose tile the fma kernel takes uses kv tiles of 8."""
    r = _rng(4)
    q = r.standard_normal((B, H, S, D), dtype=np.float32) * 0.5
    k = r.standard_normal((B, KVH, S, D), dtype=np.float32) * 0.5
    v = r.standard_normal((B, KVH, S, D), dtype=np.float32)
    bq, bkv = fa.best_divisor(S, bq), fa.best_divisor(S, bkv)
    if fa.variant(D, bkv) != "tc":
        bkv = 8
    cfg = fa.launch_config(B, H, KVH, S, D, bq, bkv, sms)
    assert cfg["variant"] == "tc"
    got = _tc_split_plain(_t(q), _t(k), _t(v), cfg, causal, win, cap)
    want = np.asarray(jref.flash_attention(q, k, v, causal=causal, window=win, softcap=cap))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.device import resolve_device
    from repro_torch.search.measure.local import LocalRunner

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalRunner(device="cuda")



# K4: the row softmax of the sfm task.  f32: the same max/exp/sum/divide,
# values in [0, 1], atol 1e-6; bf16: both round the f32 result to bf16 once,
# so they may differ by one bf16 ulp at the value (at most 2^-7 relative).
@pytest.mark.parametrize("M,N,bm", [(48, 32, 16), (72, 40, 36), (96, 64, 96),
                                    (2304, 256, 144), (2304, 256, 288), (48, 30, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_softmax_plain_matches_pallas(M, N, bm, dtype):
    import jax.numpy as jnp

    x = (_rng(M).standard_normal((M, N)) * 4).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    want = np.asarray(pallas_softmax(jx, block_rows=bm, interpret=True)
                      .astype(jnp.float32))
    tx = _t(x).to(getattr(torch, dtype))
    launches = sm.row_softmax.launches
    got = sm.row_softmax(tx, block_rows=bm)
    assert sm.row_softmax.launches == launches  # CPU tensor: plain version
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(tref.row_softmax(tx).float().numpy(), got)


def test_row_softmax_launch_config_follows_the_row_block():
    # N = 256: the registers variant, one warp a row, 32 warps at most
    cfg = sm.launch_config(2304, 256, 72)
    assert cfg == {"variant": "registers", "blocks": (72,), "grid": (32,),
                   "threads": 1024, "smem_bytes": 0, "groups": 2}
    assert sm.launch_config(2304, 256, 4)["threads"] == 128
    assert sm.launch_config(2304, 256, 12)["threads"] == 384
    # a row of N = 258 does not split into 4-value groups: shared memory
    cfg = sm.launch_config(2304, 258, 72)
    assert cfg == {"variant": "shared", "blocks": (72,), "grid": (32,),
                   "threads": 256, "smem_bytes": 72 * 258 * 4, "groups": None}
    assert sm.launch_config(2304, 258, 4)["threads"] == 128


@pytest.mark.parametrize("N,groups", [(4, 1), (128, 1), (132, 2), (256, 2), (512, 4),
                                      (640, 8), (1024, 8)])
def test_row_softmax_registers_variant_holds_the_row_in_groups_of_four(N, groups):
    cfg = sm.launch_config(96, N, 96)
    assert cfg["variant"] == sm.variant(N) == "registers"
    assert cfg["groups"] == groups and 32 * 4 * groups >= N
    assert cfg["smem_bytes"] == 0 and cfg["threads"] == 1024


@pytest.mark.parametrize("N", [1, 6, 255, 1028, 4096])
def test_row_softmax_other_rows_take_the_shared_variant(N):
    cfg = sm.launch_config(8, N, 8)
    assert cfg["variant"] == sm.variant(N) == "shared"
    assert cfg["smem_bytes"] == sm.smem_bytes(8, N) and cfg["threads"] == 256


@pytest.mark.parametrize("bm", [36, 72, 144, 288, 576, 2304])
def test_row_softmax_registers_variant_takes_any_dividing_block(bm):
    """No shared memory on this path, so large blocks are legal (288 at
    N = 256 was refused for shared memory before rows lived in registers)."""
    cfg = sm.launch_config(2304, 256, bm)
    assert cfg["grid"] == (2304 // bm,) and cfg["threads"] == 32 * min(bm, 32)


@pytest.mark.parametrize("M,N,bm,reason", [(2304, 258, 288, "shared_memory"),
                                           (2304, 256, 100, "divide")])
def test_row_softmax_launch_config_rejects_what_the_card_cannot_run(M, N, bm, reason):
    with pytest.raises(ScheduleRejected) as e:
        sm.launch_config(M, N, bm)
    assert e.value.reason == reason


def test_library_path_follows_the_headers_a_source_includes(tmp_path, monkeypatch):
    """An edited header rebuilds every library whose source includes it,
    through a header of its own too, and no other."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "SOURCES",
                        {n: csrc / p.name for n, p in _build.SOURCES.items()})
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    users = {"matmul", "flash_attention", "ssd"}
    header = csrc / "tf32_mma.cuh"
    for name, src in _build.SOURCES.items():
        assert (header.resolve() in _build.included_headers(src)) == (name in users)

    def paths():
        return {n: _build.library_path(n) for n in _build.SOURCES}

    before = paths()
    header.write_text(header.read_text() + "\n// edited\n")
    after = paths()
    assert {n for n in before if before[n] != after[n]} == users
    # a header the header includes counts as well
    (csrc / "inner.cuh").write_text("#pragma once\n")
    header.write_text(header.read_text() + '#include "inner.cuh"\n')
    again = paths()
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert {n for n, p in paths().items() if p != again[n]} == users

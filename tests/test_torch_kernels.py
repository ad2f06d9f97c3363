"""The port's kernels K1-K3 against the JAX package's, on the CPU.

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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ref as tref

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
    assert cfg["grid"] == (4, 8, 3)
    assert cfg["smem_bytes"] == 4 * (96 * 32 + 32 * 64)
    t = cfg["micro_tile"]
    assert cfg["threads"] == -(-96 // t) * -(-64 // t) <= 512
    acfg = fa.launch_config(1, 9, 256, 64, 64, 128)
    assert acfg["grid"] == (4, 9)
    assert acfg["smem_bytes"] == fa.smem_bytes(64, 128, 64)


@pytest.mark.parametrize("call", [
    lambda: mm.launch_config(1, 256, 1536, 576, (256, 1536, 576)),  # smem
    lambda: mm.launch_config(1, 1024, 1024, 4, (512, 512, 4)),  # threads
    lambda: mm.launch_config(1, 256, 256, 64, (96, 64, 32)),  # divisibility
    lambda: fa.launch_config(1, 9, 256, 64, 256, 256),  # smem
])
def test_launch_config_rejects_what_the_card_cannot_run(call):
    with pytest.raises(ValueError):
        call()


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.device import resolve_device
    from repro_torch.search.measure.local import LocalRunner

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalRunner(device="cuda")


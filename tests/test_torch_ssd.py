"""K7's plain side on the CPU: the port's ``ssd_scan`` / ``ssd_chunked``, the
three plain passes ``ssd_chunked`` is made of (those of the kernel's two
kernels) and ``kernels/ssd.py:ssd`` against the JAX package's, and the
launch plan's pure Python (head groups, pass slices and stages, shared
memory, scratch, rejections) as a function of the shape, dtype and SM
count.

Inputs come from a numpy seed and go to both packages.  Tolerances: the
chunked scan against the naive recurrence within rtol/atol 3e-3 (the
reference's own test of its kernel, ``tests/test_kernels.py``); the port
against the reference's same function within 1e-5 (float32, sums in
another order); with bfloat16 x/B/C both round y to bfloat16 once, so
within two bfloat16 ulps (2^-7 relative) of the output's largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd import ssd as jssd
from repro_torch.kernels import ScheduleRejected
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as tssd

SHAPES = [  # the reference's kernel sweep (tests/test_kernels.py)
    (2, 128, 4, 32, 16, 32),
    (1, 64, 2, 16, 8, 16),
    (1, 256, 1, 64, 32, 64),
    (3, 32, 8, 8, 4, 8),
]


def _inputs(B, S, H, P, N, seed=0, decay=0.3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, H, P), dtype=np.float32)
    la = -np.abs(r.standard_normal((B, S, H), dtype=np.float32)) * decay
    Bm = r.standard_normal((B, S, N), dtype=np.float32) * 0.3
    Cm = r.standard_normal((B, S, N), dtype=np.float32) * 0.3
    return x, la, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_chunked_and_kernel_match_the_recurrence(B, S, H, P, N, chunk):
    x, la, Bm, Cm = _inputs(B, S, H, P, N)
    want = tref.ssd_scan(*_t(x, la, Bm, Cm)).numpy()
    np.testing.assert_allclose(
        tref.ssd_chunked(*_t(x, la, Bm, Cm), chunk=chunk).numpy(), want,
        rtol=3e-3, atol=3e-3,
    )
    np.testing.assert_allclose(
        tssd.ssd(*_t(x, la, Bm, Cm), chunk=chunk).numpy(), want,
        rtol=3e-3, atol=3e-3,
    )


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_port_matches_the_reference_functions(B, S, H, P, N, chunk):
    x, la, Bm, Cm = _inputs(B, S, H, P, N, seed=1)
    np.testing.assert_allclose(
        tref.ssd_scan(*_t(x, la, Bm, Cm)).numpy(),
        np.asarray(jref.ssd_scan(x, la, Bm, Cm)), rtol=1e-5, atol=1e-5,
    )
    y, h = tref.ssd_chunked(*_t(x, la, Bm, Cm), chunk=chunk, return_state=True)
    jy, jh = jref.ssd_chunked(x, la, Bm, Cm, chunk=chunk, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    # the wrapper's plain version against the Pallas kernel in interpret mode
    np.testing.assert_allclose(
        tssd.ssd(*_t(x, la, Bm, Cm), chunk=chunk).numpy(),
        np.asarray(jssd(x, la, Bm, Cm, chunk=chunk, interpret=True)),
        rtol=1e-5, atol=1e-5,
    )


# the plain passes of K7's two kernels (batch 2, P 16), composed by hand
@pytest.mark.parametrize("S,H,N,chunk", [
    (48, 4, 8, 48), (64, 25, 16, 16), (128, 4, 16, 32), (128, 25, 8, 64),
])
def test_plain_passes_compose_to_the_reference_and_the_pallas_kernel(S, H, N, chunk):
    x, la, Bm, Cm = _inputs(2, S, H, 16, N, seed=S + H)
    tx, tla, tB, tC = _t(x, la, Bm, Cm)
    cum, y_intra, states = tref.ssd_chunk_pass(tx, tla, tB, tC, chunk)
    nc = S // chunk
    assert tuple(cum.shape) == (2, nc, chunk, H)
    assert tuple(y_intra.shape) == (2, S, H, 16) and y_intra.dtype == torch.float32
    assert tuple(states.shape) == (2, nc, H, N, 16)
    h_prev, h = tref.ssd_state_pass(states, cum)
    assert torch.equal(h_prev[:, 0], torch.zeros_like(h))  # no state before chunk 0
    y = (y_intra + tref.ssd_inter(tC, cum, h_prev)).numpy()
    jy, jh = jref.ssd_chunked(x, la, Bm, Cm, chunk=chunk, return_state=True)
    np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        y, np.asarray(jssd(x, la, Bm, Cm, chunk=chunk, interpret=True)),
        rtol=1e-5, atol=1e-5,
    )
    # the last chunk's state carries the one before it: h = exp(cum_L) h_prev + s
    last = torch.exp(cum[:, -1, -1, :])[:, :, None, None] * h_prev[:, -1] + states[:, -1]
    assert torch.equal(last, h)


def test_bf16_inputs_match_the_reference_and_keep_their_dtype():
    x, la, Bm, Cm = _inputs(1, 128, 4, 32, 16, seed=2)
    xb, Bb, Cb = (jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, Cm))
    want = np.asarray(jref.ssd_chunked(xb, la, Bb, Cb, chunk=64), np.float32)
    tx, tB, tC = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (xb, Bb, Cb))
    got = tssd.ssd(tx, torch.from_numpy(la), tB, tC, chunk=64)
    assert got.dtype == torch.bfloat16
    tol = 2 ** -7 * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= tol


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_return_state_is_the_recurrence_state(B, S, H, P, N, chunk):
    x, la, Bm, Cm = _inputs(B, S, H, P, N, seed=3)
    _, h = tssd.ssd(*_t(x, la, Bm, Cm), chunk=chunk, return_state=True)
    # the recurrence's state after the last step, in float64
    st = np.zeros((B, H, N, P))
    for t in range(S):
        st = (np.exp(la[:, t].astype(np.float64))[:, :, None, None] * st
              + Bm[:, t, None, :, None] * x[:, t, :, None, :])
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, H, N, P)
    np.testing.assert_allclose(h.numpy(), st, rtol=3e-3, atol=3e-3)


def test_strong_decay_stays_finite():
    # cum_i - cum_j is about +20 per step above the diagonal: exp overflows
    # there and the mask must be applied before it meets a zero.  cum
    # reaches about -800, so the float32 differences cum_i - cum_j carry an
    # absolute error near 800 * 2^-24 = 5e-5 into the exponent, whatever
    # the summation order: rtol/atol 1e-4
    x, la, Bm, Cm = _inputs(1, 128, 2, 16, 8, seed=4, decay=20.0)
    y, h = tssd.ssd(*_t(x, la, Bm, Cm), chunk=64, return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jref.ssd_chunked(x, la, Bm, Cm, chunk=64)),
                               rtol=1e-4, atol=1e-4)


def test_a_chunk_that_does_not_divide_s_raises_as_in_the_reference():
    x, la, Bm, Cm = _inputs(1, 80, 2, 16, 8)
    with pytest.raises((TypeError, ValueError)):  # the reference's reshape
        jref.ssd_chunked(x, la, Bm, Cm, chunk=64)
    with pytest.raises(ValueError, match="must divide"):
        tref.ssd_chunked(*_t(x, la, Bm, Cm), chunk=64)
    with pytest.raises(ValueError, match="must divide"):
        tssd.ssd(*_t(x, la, Bm, Cm), chunk=64)
    # min(chunk, S): a short sequence is one chunk
    y = tssd.ssd(*_t(x[:, :48], la[:, :48], Bm[:, :48], Cm[:, :48]), chunk=64)
    assert tuple(y.shape) == (1, 48, 2, 16)


def test_launch_config_follows_the_chunk():
    # mamba2-370m's forward on 132 SMs, bf16: 4 chunks x 32 heads, one head
    # a CTA, then the pass over chunks in slices of 16 columns of P, 3
    # chunks in flight
    cfg = tssd.launch_config(1, 256, 32, 64, 128, 64, 132, 2)
    assert cfg["blocks"] == (64,) and cfg["grid"] == (32, 4, 1)
    assert cfg["head_group"] == 1 and cfg["threads"] == tssd.THREADS
    assert cfg["smem_bytes"] == 2 * (2 * 64 * 136 + 64 * 72) + 4 * (2 * 64 * 68 + 64 + 64)
    assert cfg["smem_bytes"] == tssd.chunk_smem_bytes(64, 128, 64, 1, 2) == 79360
    assert cfg["kernels"] == 2 and cfg["p_slice"] == 16 and cfg["stages"] == 3
    assert cfg["pass_grid"] == (4, 32, 1) and cfg["pass_threads"] == 256
    assert cfg["pass_smem_bytes"] == (3 * (2 * 64 * 136 + 4 * (64 * 16 + 128 * 16 + 64))
                                      + 4 * 128 * 24)
    # y_intra 2 MB, the chunk states 4 MB, cum 32 KB
    assert cfg["scratch_bytes"] == 4 * (256 * 32 * 64 + 4 * 32 * 128 * 64 + 32 * 256)
    # in f32, B is held twice and two chunks fit in flight for two CTAs an SM
    cfg = tssd.launch_config(1, 256, 32, 64, 128, 64, 132, 4)
    assert cfg["smem_bytes"] == 4 * (2 * 64 * 132 + 64 * 72 + 64 * 136 + 2 * 64 * 68
                                     + 64 + 64) == 156160
    assert cfg["stages"] == 2
    assert cfg["pass_smem_bytes"] == tssd.pass_smem_bytes(64, 128, 16, 2, 4)
    assert tssd.pass_smem_bytes(64, 128, 16, 3, 4) > tssd.MAX_SMEM_BYTES // 2
    # min(chunk, S): a 48-token prompt runs one chunk of 48, and one kernel
    cfg = tssd.launch_config(2, 48, 25, 64, 16, 64, 132, 4)
    assert cfg["blocks"] == (48,) and cfg["grid"] == (25, 1, 2)
    assert cfg["smem_bytes"] == tssd.chunk_smem_bytes(48, 16, 64, 1, 4)
    assert cfg["kernels"] == 1 and cfg["pass_grid"] is None
    assert cfg["scratch_bytes"] == 0 and cfg["stages"] == 0


@pytest.mark.parametrize("S,chunk,elem_bytes,stages", [
    (128, 64, 2, 2),    # two chunks: both in flight
    (1024, 64, 2, 3),   # three leave room for two CTAs an SM
    (1024, 64, 4, 2),   # f32: two stages leave room for two CTAs an SM
    (256, 32, 4, 3),    # f32 chunks of 32
    (2048, 16, 2, 4),   # capped at MAX_STAGES
])
def test_pass_stages_follow_the_chunks_and_shared_memory(S, chunk, elem_bytes, stages):
    cfg = tssd.launch_config(1, S, 32, 64, 128, chunk, 132, elem_bytes)
    assert cfg["stages"] == stages
    assert cfg["pass_smem_bytes"] == tssd.pass_smem_bytes(chunk, 128, cfg["p_slice"],
                                                          stages, elem_bytes)
    if stages < min(tssd.MAX_STAGES, S // chunk):
        assert tssd.pass_smem_bytes(chunk, 128, cfg["p_slice"], stages + 1,
                                    elem_bytes) > tssd.MAX_SMEM_BYTES // 2


@pytest.mark.parametrize("batch,S,H,sms,group,grid", [
    (1, 256, 32, 132, 1, (32, 4, 1)),    # 128 CTAs: one wave is not full
    (4, 256, 32, 132, 3, (11, 4, 4)),    # 176 CTAs; 32 heads in groups of 3
    (8, 128, 25, 132, 3, (9, 2, 8)),     # hymba: 25 heads in groups of 3
    (16, 256, 32, 132, 15, (3, 4, 16)),  # groups of 15, the last of 2
    (64, 1024, 32, 132, 32, (1, 16, 64)),  # capped at MAX_GROUP
    (4, 256, 32, 16, 32, (1, 4, 4)),     # a card of 16 SMs
    (1, 37, 25, 132, 1, (25, 1, 1)),     # a 37-token prompt: chunk 37
])
def test_head_groups_fill_one_wave(batch, S, H, sms, group, grid):
    cfg = tssd.launch_config(batch, S, H, 64, 128, 64, sms, 4)
    assert cfg["head_group"] == tssd.head_group(batch, S // min(64, S), H, sms) == group
    assert cfg["grid"] == grid
    ctas = grid[0] * grid[1] * grid[2]
    # the largest group that still fills the card: one head more would not
    assert ctas >= sms or group == 1
    if group < min(H, tssd.MAX_GROUP):
        assert batch * grid[1] * -(-H // (group + 1)) < sms
    assert cfg["smem_bytes"] == tssd.chunk_smem_bytes(min(64, S), 128, 64, group, 4)


@pytest.mark.parametrize("batch,H,P,sms,ps", [
    (1, 32, 64, 132, 16),   # 128 CTAs of 8 warps; 32 would give 64
    (4, 32, 64, 132, 32),   # 256 CTAs; 64 would need 32 warps
    (8, 32, 64, 132, 32),
    (1, 25, 64, 132, 16),   # hymba: 100 CTAs
    (1, 4, 32, 132, 8),     # nothing fills half the card: the narrowest slice
    (1, 4, 20, 8, 32),      # P padded to 32: one slice, 4 CTAs on 8 SMs
])
def test_pass_slices_fill_half_a_wave(batch, H, P, sms, ps):
    assert tssd.p_slice(batch, H, P, 64, sms) == ps
    cfg = tssd.launch_config(batch, 256, H, P, 16, 64, sms, 4)
    Pp = -(-P // 16) * 16
    assert cfg["pass_grid"] == (Pp // ps, H, batch)
    assert cfg["pass_threads"] == tssd.pass_threads(64, ps) == 32 * 4 * (ps // 8)
    assert cfg["pass_threads"] <= tssd.MAX_PASS_THREADS
    assert cfg["pass_smem_bytes"] == tssd.pass_smem_bytes(64, 16, ps, cfg["stages"], 4)


def test_every_chunk_the_pass_kernel_cannot_run_is_rejected_for_shared_memory():
    # the pass kernel has a warp for every 16 rows: 16 warps at chunk 256.
    # The chunk kernel's scores already exceed shared memory past chunk 144
    assert tssd.chunk_smem_bytes(144, 16, 16, 1, 2) <= tssd.MAX_SMEM_BYTES
    assert tssd.launch_config(1, 288, 4, 16, 16, 144, 132, 2)["pass_threads"] <= 512
    for chunk in (160, 256):
        assert tssd.chunk_smem_bytes(chunk, 16, 16, 1, 2) > tssd.MAX_SMEM_BYTES
        with pytest.raises(ScheduleRejected) as e:
            tssd.launch_config(1, 2 * chunk, 4, 16, 16, chunk, 132, 2)
        assert e.value.reason == "shared_memory"


def test_scratch_holds_y_intra_states_and_cum():
    # rounded up to 4 floats each, so every part starts 16-byte aligned
    assert tssd.scratch_floats(1, 34, 3, 5, 7, 17) == 512 + 212 + 104
    assert tssd.scratch_floats(2, 48, 4, 32, 16, 48) == 0  # one chunk


@pytest.mark.parametrize("S,N,chunk,reason", [
    (80, 128, 64, "divide"),
    (256, 128, 256, "shared_memory"),
    (96, 16, 0, "divide"),
])
def test_launch_config_rejects_what_the_card_cannot_run(S, N, chunk, reason):
    with pytest.raises(ScheduleRejected) as e:
        tssd.launch_config(1, S, 32, 64, N, chunk, 132, 4)
    assert e.value.reason == reason


def test_the_wrapper_checks_shapes_and_runs_no_kernel_off_the_card():
    x, la, Bm, Cm = _t(*_inputs(1, 32, 2, 8, 4))
    with pytest.raises(ValueError):
        tssd.ssd(x, la[:, :16], Bm, Cm)
    with pytest.raises(ValueError):
        tssd.ssd(x, la, Bm, Cm[:, :, :2])
    with pytest.raises(RuntimeError, match="no kernel"):
        tssd.ssd(*(t.to("meta") for t in (x, la, Bm, Cm)))
    n = tssd.ssd.launches
    tssd.ssd(x, la, Bm, Cm)  # CPU tensors: the plain version, no launch
    assert tssd.ssd.launches == n

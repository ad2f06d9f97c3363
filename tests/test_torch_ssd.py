"""K7's plain side on the CPU: the port's ``ssd_scan`` / ``ssd_chunked`` and
``kernels/ssd.py:ssd`` against the JAX package's, and the launcher's pure
Python (shared memory, grid, rejections).

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
    cfg = tssd.launch_config(1, 256, 32, 64, 128, 64)
    assert cfg["blocks"] == (64,) and cfg["grid"] == (32,)
    assert cfg["threads"] == tssd.THREADS
    assert cfg["smem_bytes"] == 4 * (64 * 64 + 2 * 64 * 128 + 64 * 64 + 128 * 64 + 64)
    assert cfg["smem_bytes"] == 131328
    # min(chunk, S): a 48-token prompt runs one chunk of 48
    cfg = tssd.launch_config(2, 48, 25, 64, 16, 64)
    assert cfg["blocks"] == (48,) and cfg["grid"] == (50,)
    assert cfg["smem_bytes"] == tssd.smem_bytes(48, 16, 64)


@pytest.mark.parametrize("S,N,chunk,reason", [
    (80, 128, 64, "divide"),
    (256, 128, 256, "shared_memory"),
    (96, 16, 0, "divide"),
])
def test_launch_config_rejects_what_the_card_cannot_run(S, N, chunk, reason):
    with pytest.raises(ScheduleRejected) as e:
        tssd.launch_config(1, S, 32, 64, N, chunk)
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

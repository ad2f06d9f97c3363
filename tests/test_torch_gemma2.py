"""gemma2-2b's path in the port against the JAX package's, on the CPU.

A narrow gemma2 with the real head_dim: 2 layers, d_model 256, 2 query
heads over 1 kv head, head_dim 256, d_ff 512, vocab 512, attention softcap
50, final-logit softcap 30, post-norms and gelu, and a 16-token window on
every other layer, run at seq 48 > 16 so that the window masks.  The
parameters are drawn from a numpy seed in the reference's shapes and
carried into the port with ``models/convert.py:params_from_jax``;
everything runs in float32.  Tolerances:

* logits (forward, prefill, decode steps, serve ticks) and caches: rtol /
  atol 1e-4 (float32 sums in other orders through two layers; logits of
  order 1, bounded by the 30 softcap);
* K3's and K5's plain versions at D 256 against the Pallas kernels in
  interpret mode and the reference's plain version: rtol 1e-4 / atol 1e-5
  (K3) and rtol / atol 2e-6 (K5), as ``tests/test_torch_kernels.py`` and
  ``tests/test_torch_decode.py`` hold them at other head dims;
* extraction: keys, weights and structural hashes equal (at batch 1 over
  one kv head the chunked attention's contractions are ``dense`` sites,
  not ``batch_matmul``, as the reference's jaxpr walk sees them).

At depth 5 the layer windows (16, 0, 16, 0, 16) have no period that
divides the depth (``window_period``), and both packages extract no
attention task.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jcfg
from repro.integration.extract import EXTRACTABLE_OPS as JOPS
from repro.integration.extract import DECODE_EXTRACTABLE_OPS as JDECODE_OPS
from repro.integration.extract import extract_decode_task_specs as jextract_decode
from repro.integration.extract import extract_task_specs as jextract
from repro.kernels import ref as jref
from repro.kernels.flash_attention import decode_flash_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import transformer as JT
from repro_torch.configs.base import get_config as tcfg
from repro_torch.integration.extract import extract_decode_task_specs as textract_decode
from repro_torch.integration.extract import extract_task_specs as textract
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax

TOL = 1e-4
SEQ = 48
WINDOW = 16
NARROW = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=1, head_dim=256,
              d_ff=512, vocab=512, local_window=WINDOW, dtype="float32")


def _configs(layers: int = 2):
    kw = dict(NARROW, n_layers=layers)
    return (dataclasses.replace(jcfg("gemma2-2b"), **kw),
            dataclasses.replace(tcfg("gemma2-2b"), **kw))


def _numpy_params(jc, seed: int = 0):
    """float32 parameters in the reference's shapes: matrices N(0, 1) at
    fan-in scale, norm weights N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, spec):
        shape = tuple(spec.shape)
        if "ln" in path[-1].key:  # ln1, ln2, post_ln1, post_ln2, final_ln
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, JT.param_specs(jc))


@pytest.fixture(scope="module")
def narrow():
    jc, tc = _configs()
    npp = _numpy_params(jc)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    tp = params_from_jax(npp, device="cpu")
    return jc, tc, jp, tp


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_narrow_model_keeps_gemma2s_features(narrow):
    jc, tc, _, tp = narrow
    assert tc.head_dim == 256 and tc.attn_softcap == 50.0 and tc.logit_softcap == 30.0
    assert tc.post_norms and tc.act == "gelu" and tc.alt_local_global
    assert TT.layer_windows(tc).tolist() == [WINDOW, 0] == JT.layer_windows(jc).tolist()
    assert tp["layers"]["post_ln1"].dtype == torch.float32
    assert tp["layers"]["attn"]["wq"].shape == (2, 256, 512)


def test_forward_matches_reference(narrow):
    jc, tc, jp, tp = narrow
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, SEQ)).astype(np.int32)
    want = np.asarray(JT.forward(jc, jp, tokens=jnp.asarray(toks)))
    got = TT.forward(tc, tp, tokens=torch.from_numpy(toks))
    assert tuple(got.shape) == (2, SEQ, 512) and np.abs(want).max() <= 30.0
    _close(got, want)


def test_prefill_then_decode_steps_match_reference(narrow):
    """Prefill past the window, then decode steps through the ring cache of
    the windowed layer."""
    jc, tc, jp, tp = narrow
    max_seq = SEQ + 16
    toks = np.random.default_rng(2).integers(0, jc.vocab, (2, SEQ - 8)).astype(np.int32)
    jcache, tcache = JT.init_cache(jc, 2, max_seq), TT.init_cache(tc, 2, max_seq, device="cpu")
    assert tuple(tcache["k"].shape) == jcache["k"].shape
    jl, jcache = JT.prefill(jc, jp, jcache, tokens=jnp.asarray(toks))
    tl, tcache = TT.prefill(tc, tp, tcache, torch.from_numpy(toks))
    _close(tl, jl)
    _close(tcache["k"], jcache["k"])
    nxt = np.array([[3], [5]], np.int32)
    for _ in range(4):
        jl, jcache = JT.decode_step(jc, jp, jcache, jnp.asarray(nxt))
        tl, tcache = TT.decode_step(tc, tp, tcache, torch.from_numpy(nxt))
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
    _close(tcache["v"], jcache["v"])
    assert int(tcache["pos"]) == int(jcache["pos"]) == SEQ - 4


def test_serve_step_tick_matches_reference(narrow):
    """A mixed tick (a decode lane past the window, a 4-token chunk lane,
    an idle lane), twice."""
    jc, tc, jp, tp = narrow
    B, C = 3, 4
    jcache = dict(JT.init_cache(jc, B, SEQ))
    r = np.random.default_rng(3)
    for name in ("k", "v"):
        jcache[name] = jnp.asarray(r.standard_normal(jcache[name].shape).astype(np.float32))
    jcache["pos"] = jnp.asarray([WINDOW + 9, 2, 0], jnp.int32)
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    toks = r.integers(0, jc.vocab, (B, C)).astype(np.int32)
    valid = np.array([1, 4, 0], np.int32)
    for _ in range(2):
        jl, jcache = JT.serve_step(jc, jp, jcache, jnp.asarray(toks), jnp.asarray(valid))
        tl, tcache = TT.serve_step(tc, tp, tcache, torch.from_numpy(toks),
                                   torch.from_numpy(valid))
        _close(tl[:2], jl[:2])  # lane 2 is idle: its logits are never sampled
        _close(tcache["k"], jcache["k"])
        _close(tcache["v"], jcache["v"])
        assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


def _fields(tasks):
    return sorted((t.key, t.weight, t.struct_hash, t.dispatchable) for t in tasks)


@pytest.mark.parametrize("layers", [2, 5])
def test_forward_extraction_matches_reference(layers):
    jc, tc = _configs(layers)
    kw = dict(batch=1, seq=SEQ, ops=JOPS, min_task_elems=1)
    want = jextract(jc, mesh=None, **kw)
    got = textract(tc, **kw)
    assert _fields(got) == _fields(want)
    attn = sorted(t.key for t in got if t.op == "attention")
    if layers == 2:
        assert attn == [
            f"attention/b=1/causal=1/d=256/h=2/kvh=1/s={SEQ}/softcap=50.0/window=0",
            f"attention/b=1/causal=1/d=256/h=2/kvh=1/s={SEQ}/softcap=50.0/window={WINDOW}",
        ]
    else:  # no window period divides 5: the fused attention task is dropped
        assert attn == []


@pytest.mark.parametrize("layers", [2, 5])
@pytest.mark.parametrize("kw", [dict(), dict(paged=True, chunk=8, page_size=8)])
def test_decode_extraction_matches_reference(layers, kw):
    jc, tc = _configs(layers)
    kw = dict(kw, batch=2, max_seq=SEQ, ops=JDECODE_OPS, min_task_elems=1)
    want = jextract_decode(jc, mesh=None, **kw)
    got = textract_decode(tc, **kw)
    assert _fields(got) == _fields(want)
    if layers == 2:
        assert f"attention_decode/b=2/d=256/h=2/kvh=1/softcap=50.0/t={SEQ}" in \
            {t.key for t in got}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("window,bq,bkv", [(WINDOW, 8, 16), (None, 16, 8), (WINDOW, 48, 48)])
def test_flash_attention_plain_matches_pallas_at_head_dim_256(window, bq, bkv):
    r = np.random.default_rng(4)
    q = r.standard_normal((1, 2, SEQ, 256), dtype=np.float32) * 0.5
    k = r.standard_normal((1, 1, SEQ, 256), dtype=np.float32) * 0.5
    v = r.standard_normal((1, 1, SEQ, 256), dtype=np.float32)
    kw = dict(causal=True, window=window, softcap=50.0)
    n = fa.flash_attention.launches
    got = fa.flash_attention(_t(q), _t(k), _t(v), block_q=bq, block_kv=bkv, **kw)
    assert fa.flash_attention.launches == n  # the CPU runs no kernel
    want = np.asarray(jref.flash_attention(q, k, v, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    pal = np.asarray(pallas_flash(q, k, v, block_q=bq, block_kv=bkv, interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), pal, rtol=1e-4, atol=1e-5)


def _bias(lengths, T, window=0):
    pos = np.arange(T)[None, :]
    lv = np.asarray(lengths)[:, None]
    ok = pos < lv
    if window:
        ok &= pos > lv - 1 - window
    return np.where(ok, 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("window,block_kv", [(0, 16), (WINDOW, 8), (WINDOW, 48)])
def test_decode_attention_plain_matches_pallas_at_head_dim_256(window, block_kv):
    B, KVH, G, T, D = 3, 1, 2, SEQ, 256
    r = np.random.default_rng(5)
    q = r.standard_normal((B, KVH, G, D), dtype=np.float32)
    k = r.standard_normal((B, KVH, T, D), dtype=np.float32)
    v = r.standard_normal((B, KVH, T, D), dtype=np.float32)
    bias = _bias([T, 29, 1], T, window)  # ragged lengths, one past the window
    want = np.asarray(pallas_decode(q, k, v, bias, softcap=50.0, block_kv=block_kv,
                                    interpret=True))
    n = fa.decode_flash_attention.launches
    got = fa.decode_flash_attention(_t(q), _t(k), _t(v), _t(bias), softcap=50.0,
                                    block_kv=block_kv)
    assert fa.decode_flash_attention.launches == n
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("call,reason", [
    # K3's fma CTA at D 256: (8, 64) fits in 149,856 bytes, (64, 64) needs
    # 279,552; K5's at G 2: block_kv 64 fits in 135,960, 128 needs 267,800
    (lambda: fa.check_tile(1, 8, 4, 4608, 256, 64, 64), "shared_memory"),
    (lambda: fa.check_decode_tile(2, 256, 256, 128), "shared_memory"),
])
def test_gemma2_tiles_over_the_shared_memory_cap_are_rejected(call, reason):
    from repro_torch.kernels import ScheduleRejected

    with pytest.raises(ScheduleRejected) as e:
        call()
    assert e.value.reason == reason


def test_gemma2_tiles_the_card_runs():
    """The tiles beside the refused ones: K3's fma CTA at (8, 64) and (16,
    64) fits in shared memory at D 256, but a q block of 8 rows exceeds the
    lowering's grid cap at S 4608, so the search reaches (16, 64) and not
    (8, 64); K5's block_kv 64 fits at G 2."""
    from repro_torch.backends.gpu_backend import MAX_GRID_STEPS

    assert fa.check_tile(1, 8, 4, 4608, 256, 8, 64)["smem_bytes"] == 149_856
    assert fa.check_tile(1, 8, 4, 4608, 256, 16, 64)["smem_bytes"] == 168_384
    assert fa.smem_bytes(64, 64, 256) == 279_552
    assert 8 * (4608 // 8) * (4608 // 64) > MAX_GRID_STEPS >= 8 * (4608 // 16) * (4608 // 64)
    assert fa.check_decode_tile(2, 256, 256, 64) == 135_960
    assert fa.decode_smem_bytes(2, 128, 256) == 267_800

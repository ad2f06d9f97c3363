"""The port's dense-family model against the JAX package's, on the CPU.

``jax.random`` cannot be reproduced in torch, so the reference initialises
the parameters and ``models/convert.py`` carries them across.  Both
forwards then run in float32 on the same tokens; they differ only in the
order of float32 sums (tolerance rtol/atol 1e-4 on logits of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jcfg
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs.base import get_config as tcfg
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model

DENSE = ["smollm-135m", "gemma2-2b", "stablelm-3b", "qwen1.5-110b"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


@pytest.mark.parametrize("arch", DENSE)
def test_smoke_forward_logits_match_in_f32(arch):
    jc, tc = jcfg(arch, smoke=True), tcfg(arch, smoke=True)
    jparams = _f32(JT.init_params(jc, jax.random.PRNGKey(0)))
    tparams = params_from_jax(_np_tree(jparams))
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 32)).astype(np.int32)
    want = np.asarray(JT.forward(jc, jparams, tokens=jnp.asarray(toks)))
    got = build_model(tc).forward(tparams, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_init_params_have_the_reference_shapes_and_dtypes():
    jc, tc = jcfg("smollm-135m"), tcfg("smollm-135m")
    spec = JT.param_specs(jc)
    mine = TT.init_params(tc, device="meta")

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in flat(spec)}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flat(mine)}
    assert got == want


def test_bf16_parameters_convert_exactly():
    jparams = JT.init_params(jcfg("smollm-135m", smoke=True), jax.random.PRNGKey(0))
    tparams = params_from_jax(_np_tree(jparams))
    w = tparams["layers"]["attn"]["wq"]
    assert w.dtype == torch.bfloat16
    back = w.float().numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jparams["layers"]["attn"]["wq"].astype(jnp.float32))
    )


def test_seeded_init_is_reproducible_and_full_width_on_meta():
    cfg = tcfg("smollm-135m", smoke=True)
    a = TT.init_params(cfg, seed=3, device="cpu")
    b = TT.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    full = TT.init_params(tcfg("smollm-135m"), device="meta")
    assert full["layers"]["mlp"]["wi"].shape == (30, 576, 1536)


@pytest.mark.parametrize("chunk,window,softcap,T_pad", [
    (8, None, None, False), (8, 6, 20.0, True), (32, None, None, False),
])
def test_chunked_attention_matches_reference(chunk, window, softcap, T_pad):
    r = np.random.default_rng(2)
    S = 20 if T_pad else 24
    q = r.standard_normal((1, 6, S, 8), dtype=np.float32)
    k = r.standard_normal((1, 2, S, 8), dtype=np.float32)
    v = r.standard_normal((1, 2, S, 8), dtype=np.float32)
    kw = dict(causal=True, window=window, softcap=softcap, chunk=chunk)
    want = np.asarray(JL.chunked_attention(q, k, v, **kw))
    got = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rmsnorm_and_rope_match_reference():
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 5, 16), dtype=np.float32)
    w = r.standard_normal((16,), dtype=np.float32)
    np.testing.assert_allclose(
        TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(JL.rmsnorm(x, w, 1e-6)), rtol=1e-5, atol=1e-6,
    )
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(JL.apply_rope(x, pos)), rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m", "whisper-medium",
                                  "qwen2-vl-2b"])
def test_other_families_raise(arch):
    with pytest.raises(NotImplementedError):
        TT.init_params(tcfg(arch, smoke=True), device="meta")


def test_window_period_and_layer_windows_match_reference():
    for arch in ("gemma2-2b", "smollm-135m", "hymba-1.5b"):
        jw, tw = JT.layer_windows(jcfg(arch)), TT.layer_windows(tcfg(arch))
        np.testing.assert_array_equal(jw, tw)
        assert JT.window_period(jw) == TT.window_period(tw)

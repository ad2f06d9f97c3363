"""The port's state-space (mamba2) and hybrid (hymba) models against the JAX
package's, on the CPU.

``jax.random`` cannot be reproduced in torch, so the reference initialises
the parameters and ``models/convert.py`` carries them across.  Model parity
runs in float32 on the same tokens (``dataclasses.replace(cfg,
dtype="float32")`` and float32 parameters); the two differ only in the
order of float32 sums: logits and SSD states within rtol/atol 1e-4 (values
of order 1), the mixers within 1e-5.  Task extraction must give the
reference's keys, weights and dispatchable flags exactly, and the serving
streams must be equal token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jcfg
from repro.integration import extract as JE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingScheduler as JScheduler
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JEngine
from repro_torch.configs.base import get_config as tcfg
from repro_torch.integration import extract as TE
from repro_torch.kernels import ssd as tssd
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.serving import ContinuousBatchingScheduler, KVArena, ServeConfig
from repro_torch.serving import ServingEngine

TOL = 1e-4
SSM = ["mamba2-370m", "hymba-1.5b"]


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, **over):
    jc = dataclasses.replace(jcfg(arch, smoke=True), dtype="float32", **over)
    tc = dataclasses.replace(tcfg(arch, smoke=True), dtype="float32", **over)
    jp = _f32(JT.init_params(jc, jax.random.PRNGKey(0)))
    return jc, tc, jp, params_from_jax(_np(jp), device="cpu")


@pytest.fixture(scope="module", params=SSM)
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def mamba():
    return _pair("mamba2-370m")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _tokens(vocab, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# the SSD mixer
# ---------------------------------------------------------------------------


def _mixer_inputs(arch, dtype=jnp.float32, B=2, S=48):
    jc = jcfg(arch, smoke=True)
    jp = JL.ssd_init(jax.random.PRNGKey(3), jc, "ssd")
    jp = {k: (v if v.dtype == jnp.float32 else v.astype(dtype)) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((B, S, jc.d_model)).astype(np.float32)
    tp = params_from_jax(_np(jp), device="cpu")
    xt = torch.from_numpy(x).to(torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    return jc, tcfg(arch, smoke=True), jp, tp, jnp.asarray(x, dtype), xt


@pytest.mark.parametrize("arch", SSM)
@pytest.mark.parametrize("S", [48, 128])
def test_ssd_mixers_match_the_reference(arch, S):
    jc, tc, jp, tp, jx, tx = _mixer_inputs(arch, S=S)
    _close(TL.ssd_mixer(tp, tx, tc), JL.ssd_mixer(jp, jx, jc), 1e-5)
    y, st = TL.ssd_mixer_with_state(tp, tx, tc)
    jy, jst = JL.ssd_mixer_with_state(jp, jx, jc)
    _close(y, jy, 1e-5)
    _close(st, jst, 1e-5)
    # one more token through the decode recurrence from that state
    x1 = tx[:, :1] * 0.5
    s1, st1 = TL.ssd_decode_step(tp, x1, st, tc)
    js1, jst1 = JL.ssd_decode_step(jp, jnp.asarray(x1.numpy()), jst, jc)
    _close(s1, js1, 1e-5)
    _close(st1, jst1, 1e-5)


def test_ssd_mixer_keeps_the_references_dtypes():
    jc, tc, jp, tp, jx, tx = _mixer_inputs("mamba2-370m", dtype=jnp.bfloat16)
    assert tp["wdt"].dtype == tp["A_log"].dtype == tp["dt_bias"].dtype == torch.float32
    assert tp["wx"].dtype == tp["wo"].dtype == torch.bfloat16
    want = JL._ssd_common(jp, jx, jc)
    got = TL._ssd_common(tp, tx, tc)
    for g, w in zip(got, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), (g.dtype, w.dtype)
    xin, z, Bm, Cm, log_a = got
    assert xin.dtype == torch.bfloat16 and log_a.dtype == torch.float32
    y, st = TL.ssd_mixer_with_state(tp, tx, tc)
    jy, jst = JL.ssd_mixer_with_state(jp, jx, jc)
    assert y.dtype == torch.bfloat16 and str(jy.dtype) == "bfloat16"
    assert st.dtype == torch.float32 and str(jst.dtype) == "float32"
    s1, st1 = TL.ssd_decode_step(tp, tx[:, :1], st, tc)
    assert s1.dtype == torch.bfloat16 and st1.dtype == torch.float32
    # bf16 projections, f32 scan: both round the same f32 values to bf16
    tol = 2 ** -6 * float(np.abs(np.asarray(jy, np.float32)).max())
    assert float((y.float() - torch.from_numpy(np.asarray(jy, np.float32))).abs().max()) <= tol


def test_ssd_mixer_runs_its_scan_through_ops_with_the_chunk_rule(mamba):
    jc, tc, jp, tp = mamba
    p = TT._layer(tp["layers"], 0)["ssd"]
    x = torch.randn(1, 80, tc.d_model)
    with pytest.raises(ValueError, match="must divide"):
        TL.ssd_mixer(p, x, tc)  # S = 80, chunk min(64, 80) = 64, as in the reference
    with pytest.raises((TypeError, ValueError)):
        JL.ssd_mixer(jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["ssd"]),
                     jnp.asarray(x.numpy()), jc)
    n = tssd.ssd.launches
    TL.ssd_mixer(p, x[:, :64], tc)
    TL.ssd_mixer(p, x[:, :64], tc, backend="torch")
    assert tssd.ssd.launches == n  # CPU tensors: the plain version


@pytest.mark.parametrize("arch", SSM)
def test_ssd_parameters_convert_exactly_with_their_dtypes(arch):
    jp = JT.init_params(jcfg(arch, smoke=True), jax.random.PRNGKey(0))
    tp = params_from_jax(_np(jp), device="cpu")
    for name, leaf in jp["layers"]["ssd"].items():
        got = tp["layers"]["ssd"][name]
        want = "float32" if name in ("wdt", "A_log", "dt_bias") else "bfloat16"
        assert str(leaf.dtype) == want and str(got.dtype) == f"torch.{want}", name
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [32, 128])
def test_smoke_forward_logits_match_in_f32(pair, S):
    jc, tc, jp, tp = pair
    toks = _tokens(jc.vocab, 2, S)
    want = JT.forward(jc, jp, tokens=jnp.asarray(toks))
    got = build_model(tc).forward(tp, torch.from_numpy(toks).long())
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    _close(got, want)
    _close(TT.forward(tc, tp, torch.from_numpy(toks).long(), ssd_backend="torch"), want)


def test_full_width_mamba2_forward_matches_in_f32():
    # mamba2-370m at full width (d_model 1024, 32 heads of 64, state 128,
    # vocab 50280), two layers, seq 64
    jc = dataclasses.replace(jcfg("mamba2-370m"), n_layers=2, dtype="float32")
    tc = dataclasses.replace(tcfg("mamba2-370m"), n_layers=2, dtype="float32")
    jp = _f32(JT.init_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(_np(jp), device="cpu")
    toks = _tokens(jc.vocab, 1, 64, seed=2)
    want = JT.forward(jc, jp, tokens=jnp.asarray(toks))
    got = TT.forward(tc, tp, torch.from_numpy(toks).long())
    _close(got, want)


@pytest.mark.parametrize("S", [48, 128])
def test_prefill_then_decode_steps_match_reference(pair, S):
    jc, tc, jp, tp = pair
    toks = _tokens(jc.vocab, 2, S, seed=5)
    jcache, tcache = JT.init_cache(jc, 2, 256), TT.init_cache(tc, 2, 256, device="cpu")
    assert set(tcache) == set(jcache)
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape, k
    jl, jcache = JT.prefill(jc, jp, jcache, tokens=jnp.asarray(toks))
    tl, tcache = TT.prefill(tc, tp, tcache, torch.from_numpy(toks).long())
    _close(tl, jl)
    _close(tcache["state"], jcache["state"])
    assert int(tcache["pos"]) == S
    tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
    for _ in range(4):
        jl, jcache = JT.decode_step(jc, jp, jcache, jnp.asarray(tok))
        tl, tcache = TT.decode_step(tc, tp, tcache, torch.from_numpy(tok).long())
        _close(tl, jl)
        _close(tcache["state"], jcache["state"])
        if "k" in jcache:
            _close(tcache["k"], jcache["k"])
        tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)


def test_prefill_of_a_prompt_the_reference_cannot_scan_raises(mamba):
    jc, tc, jp, tp = mamba
    toks = _tokens(jc.vocab, 1, 80)
    with pytest.raises((TypeError, ValueError)):
        JT.prefill(jc, jp, JT.init_cache(jc, 1, 256), tokens=jnp.asarray(toks))
    with pytest.raises(ValueError, match="must divide"):
        TT.prefill(tc, tp, TT.init_cache(tc, 1, 256, device="cpu"),
                   torch.from_numpy(toks).long())


@pytest.mark.parametrize("arch", SSM)
def test_bounded_state_decode_at_a_long_declared_context(arch):
    # the port's twin of the reference's TestLongContextDecode
    cfg = tcfg(arch, smoke=True)
    m = build_model(cfg)
    params = m.init(seed=0, device="cpu")
    big_ctx = 4096
    spec = m.cache_specs(1, max_seq=big_ctx)
    if "k" in spec:
        assert spec["k"].shape[3] <= big_ctx
    assert tuple(spec["state"].shape) == (cfg.n_layers, 1, cfg.ssm_heads,
                                          cfg.ssm_state, cfg.ssm_head_dim)
    cache = m.init_cache(1, max_seq=big_ctx, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    for _ in range(3):
        logits, cache = m.decode_step(params, cache, tok)
    assert torch.isfinite(logits.float()).all()
    assert int(cache["pos"]) == 3


def test_attention_free_cache_has_no_kv_and_serve_step_raises(mamba):
    jc, tc, jp, tp = mamba
    assert TT.cache_max_len(tc, 256) == JT.cache_max_len(jc, 256) == 0
    cache = TT.init_cache(tc, 2, 64, device="cpu")
    assert set(cache) == {"pos", "state"}
    cache["pos"] = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="pure-attention"):
        TT.serve_step(tc, tp, cache, torch.zeros((2, 1), dtype=torch.long),
                      torch.ones(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# task extraction
# ---------------------------------------------------------------------------


def _specs(tasks):
    return {t.key: (t.weight, t.dispatchable) for t in tasks}


@pytest.mark.parametrize("arch,n_fwd,n_dec", [("mamba2-370m", 14, 7),
                                              ("hymba-1.5b", 20, 11)])
def test_extraction_gives_the_references_tasks(arch, n_fwd, n_dec):
    jc, tc = jcfg(arch), tcfg(arch)
    want = _specs(JE.extract_task_specs(jc, batch=1, seq=256))
    got = _specs(TE.extract_task_specs(tc, batch=1, seq=256))
    assert len(want) == n_fwd and got == want
    want = _specs(JE.extract_decode_task_specs(jc, batch=4, max_seq=256))
    got = _specs(TE.extract_decode_task_specs(tc, batch=4, max_seq=256))
    assert len(want) == n_dec and got == want


def test_smoke_extraction_at_a_48_token_prompt_gives_the_references_tasks():
    jc, tc = jcfg("mamba2-370m", smoke=True), tcfg("mamba2-370m", smoke=True)
    for kw in (dict(batch=2, seq=48), dict(batch=1, seq=64)):
        want = _specs(JE.extract_task_specs(jc, min_task_elems=1, **kw))
        assert _specs(TE.extract_task_specs(tc, min_task_elems=1, **kw)) == want


EINSUMS = [  # (spec, shapes): the SSD einsums at several sizes, and others
    ("bsd,di->bsi", [(1, 256, 1024), (1024, 2048)]),
    ("bsd,dn->bn", [(4, 1, 1024), (1024, 128)]),
    ("bn,bhnp->bhp", [(4, 128), (4, 32, 128, 64)]),
    ("bcin,bcjn->bcij", [(1, 1, 64, 16), (1, 1, 64, 16)]),
    ("bcij,bcijh,bcjhp->bcihp", [(2, 1, 48, 48), (2, 1, 48, 48, 4), (2, 1, 48, 4, 32)]),
    ("bcij,bcijh,bcjhp->bcihp", [(1, 4, 64, 64), (1, 4, 64, 64, 25), (1, 4, 64, 25, 64)]),
    ("bcjn,bcjh,bcjhp->bchnp", [(1, 4, 64, 16), (1, 4, 64, 25), (1, 4, 64, 25, 64)]),
    ("bcjn,bcjh,bcjhp->bchnp", [(1, 4, 64, 128), (1, 4, 64, 32), (1, 4, 64, 32, 64)]),
    ("bcin,bcih,bchnp->bcihp", [(1, 4, 64, 16), (1, 4, 64, 25), (1, 4, 25, 16, 64)]),
    ("bcin,bcih,bchnp->bcihp", [(3, 2, 16, 8), (3, 2, 16, 4), (3, 2, 4, 8, 16)]),
    ("ij,jk,kl->il", [(8, 32), (32, 4), (4, 64)]),
    ("abc,cd,bd->ad", [(5, 6, 7), (7, 8), (6, 8)]),
]


@pytest.mark.parametrize("spec,shapes", EINSUMS)
def test_einsum_sites_are_the_reference_jaxpr_walks(spec, shapes):
    ops = [jnp.zeros(s, jnp.float32) for s in shapes]
    jaxpr = jax.make_jaxpr(lambda *a: jnp.einsum(spec, *a))(*ops)
    want = [(s.op, s.kwargs, s.dispatchable) for s in JE.sites_from_jaxpr(jaxpr)]
    got = [(s.op, s.kwargs, s.dispatchable) for s in TE.einsum_sites(spec, *shapes)]
    assert got == want


@pytest.mark.parametrize("shape", [(2, 48, 4), (4, 32), (5,), (3, 1), (2, 3, 4, 5, 6)])
def test_exp_sites_are_the_reference_jaxpr_walks(shape):
    jaxpr = jax.make_jaxpr(jnp.exp)(jnp.zeros(shape, jnp.float32))
    want = [(s.op, s.kwargs) for s in JE.sites_from_jaxpr(jaxpr)]
    site = TE.exp_site(shape)
    assert ([] if site is None else [(site.op, site.kwargs)]) == want


# ---------------------------------------------------------------------------
# serving on the slot arena
# ---------------------------------------------------------------------------

MAX_SEQ = 32
SLOTS = 2


def _sched_streams(Sched, Config, cfg, params, prompts, budgets, **mode):
    sched = Sched(cfg, params, config=Config(max_slots=SLOTS, max_seq=MAX_SEQ, **mode))
    reqs = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    sched.run()
    return [list(r.generated) for r in reqs], sched


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("mode", [dict(), dict(paged=True, prefill_chunk=4)],
                         ids=["defaults", "paged-chunked-asked"])
def test_scheduler_streams_equal_reference(pair, mode):
    jc, tc, jp, tp = pair
    # 3 requests through 2 slots: one waits, then takes a recycled slot; an
    # SSD model serves on the slot tier whatever the config asks
    prompts = _prompts(jc.vocab, [6, 13, 5], seed=1)
    budgets = [4, 3, 5]
    want, jsched = _sched_streams(JScheduler, JServeConfig, jc, jp, prompts,
                                  budgets, **mode)
    got, sched = _sched_streams(ContinuousBatchingScheduler, ServeConfig, tc, tp,
                                prompts, budgets, **mode)
    assert got == want
    assert isinstance(sched.arena, KVArena)
    assert sched.config.paged is False and sched.config.prefill_chunk == 0
    for k in ("prefill_tokens", "decode_tokens", "decode_steps", "admitted",
              "released"):
        assert sched.stats[k] == jsched.stats[k], k
    assert not sched.pending()
    # free lanes decode garbage that is never sampled, in both packages: the
    # arenas end equal, lane for lane
    _close(sched.arena.cache["state"], jsched.arena.cache["state"])


def test_engine_streams_equal_reference(mamba):
    jc, tc, jp, tp = mamba
    prompts = _prompts(jc.vocab, [6, 4, 8])
    budgets = [3, 5, 2]

    def run(Engine, Config, cfg, params):
        eng = Engine(cfg, params, config=Config(max_slots=2, max_seq=MAX_SEQ))
        for p, b in zip(prompts, budgets):
            eng.submit(p, max_new_tokens=b)
        return [list(r.generated) for r in eng.run()]

    assert run(ServingEngine, ServeConfig, tc, tp) == run(JEngine, JServeConfig, jc, jp)


def test_slot_arena_loads_and_zeroes_the_state_lane(mamba):
    jc, tc, jp, tp = mamba
    model = build_model(tc)
    arena = KVArena(model, SLOTS, MAX_SEQ, device="cpu")
    assert set(arena.cache) == {"pos", "state"}
    toks = torch.from_numpy(_tokens(jc.vocab, 1, 12)).long()
    _, rc = model.prefill(tp, model.init_cache(1, MAX_SEQ, device="cpu"), toks)
    arena.load_slot(1, rc)
    assert torch.equal(arena.cache["state"][:, 1], rc["state"][:, 0])
    assert float(arena.cache["state"][:, 0].abs().max()) == 0
    assert int(arena.positions[1]) == 12
    arena.release_slot(1, used=12)
    assert float(arena.cache["state"].abs().max()) == 0
    assert int(arena.positions[1]) == 0


def test_launch_serve_serves_mamba2_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    reqs = main(["--arch", "mamba2-370m", "--device", "cpu", "--requests", "3",
                 "--prompt-len", "6", "--new-tokens", "3", "--max-batch", "2"])
    assert len(reqs) == 3 and all(len(r.generated) == 3 for r in reqs)
    assert "decode" in capsys.readouterr().out

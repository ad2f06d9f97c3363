"""The port's qwen2-vl backbone (M-RoPE, embedding inputs) and whisper
encoder-decoder against the JAX package's, on the CPU.

The reference initialises the parameters and ``models/convert.py``
carries them across; both packages then run in float32
(``dataclasses.replace(cfg, dtype="float32")`` and float32 parameters) on
the same seeded numpy inputs: embeddings, whisper's encoder frames, tokens.
Logits of order 1 agree within rtol/atol 1e-4 (float32 sums in other
orders), gradients within 1e-4 of each leaf's max |g|; the modality
frontends are stubs in both packages.  Extraction at full width gives the
reference's keys and weights (``tests/test_torch_integration.py``,
``tests/test_torch_decode.py``), and dispatch the reference's hits,
misses and fallback reasons by key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jcfg
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.kv import KVArena as JArena
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.base import get_config as tcfg
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model, prefill_input_specs
from repro_torch.serving import (
    ContinuousBatchingScheduler,
    KVArena,
    PagedKVArena,
    ServeConfig,
    ServingEngine,
)
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import value_and_grad

TOL = 1e-4
ARCHS = ["whisper-medium", "qwen2-vl-2b"]


def _f32_pair(arch):
    jc = dataclasses.replace(jcfg(arch, smoke=True), dtype="float32")
    tc = dataclasses.replace(tcfg(arch, smoke=True), dtype="float32")
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), JT.init_params(jc, jax.random.PRNGKey(0))
    )
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _f32_pair(request.param)


@pytest.fixture(scope="module")
def whisper():
    return _f32_pair("whisper-medium")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _inputs(cfg, B, S, seed=1, embeds=True):
    """Seeded numpy inputs: ``embeds`` (or ``tokens``), and whisper's
    ``frames``."""
    r = np.random.default_rng(seed)
    if embeds:
        ins = {"embeds": r.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    else:
        ins = {"tokens": r.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.enc_layers:
        ins["frames"] = r.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return ins


def _j(ins):
    return {k: jnp.asarray(v) for k, v in ins.items()}


def _t(ins):
    return {k: torch.from_numpy(v) for k, v in ins.items()}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_have_the_reference_shapes_and_dtypes(arch):
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  JT.param_specs(jcfg(arch)))
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        TT.init_params(tcfg(arch), device="meta"),
    )
    assert got == want
    if arch == "whisper-medium":
        assert got["enc_layers"]["attn"]["wq"] == ((24, 1024, 1024), "bfloat16")
        assert got["layers"]["xattn"]["wk"] == ((24, 1024, 1024), "bfloat16")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_every_subtree(arch):
    jp = JT.init_params(jcfg(arch, smoke=True), jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jp)]
    assert len(paths) == len(tree_leaves(tp))
    for (_, a), b in zip(jax.tree_util.tree_leaves_with_path(jp), tree_leaves(tp)):
        assert str(b.dtype).replace("torch.", "") == str(a.dtype)
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))
    if arch == "whisper-medium":
        assert set(tp["enc_layers"]) == {"ln1", "attn", "ln2", "mlp"}
        assert {"ln_x", "xattn"} <= set(tp["layers"])
        assert "enc_final_ln" in tp


def test_prefill_input_specs_are_the_references():
    from repro.configs.base import ShapeConfig as JShape
    from repro.models.registry import prefill_input_specs as jspecs

    for arch in ARCHS + ["smollm-135m"]:
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in jspecs(jcfg(arch), JShape("x", 64, 2, "prefill")).items()}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in prefill_input_specs(tcfg(arch), ShapeConfig("x", 64, 2,
                                                                       "prefill")).items()}
        assert got == want


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", [16, 128, 10])
def test_apply_mrope_matches_reference_with_distinct_ids(head_dim):
    """Distinct t/h/w ids, where M-RoPE is not plain rope: 16 and 128 take
    the (16, 24, 24) split rescaled, 10 leaves the last section the
    remainder."""
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 3, 7, head_dim)).astype(np.float32)
    pos = r.integers(0, 50, (2, 1, 7, 3)).astype(np.int32)
    want = np.asarray(JL.apply_mrope(x, pos, theta=1e6))
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta=1e6)
    _close(got, want, 1e-5)
    plain = np.asarray(JL.apply_rope(x, pos[..., 0], theta=1e6))
    assert np.abs(want - plain).max() > 1e-2
    # text tokens (t = h = w) reduce to plain rope
    same = np.repeat(pos[..., :1], 3, -1)
    _close(TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), theta=1e6),
           np.asarray(JL.apply_rope(x, same[..., 0], theta=1e6)), 1e-5)


def test_mrope_sections_rescale_to_the_head_dim():
    assert TL.mrope_sections(128) == [16, 24, 24]
    assert TL.mrope_sections(16) == [2, 3, 3]
    assert TL.mrope_sections(10) == [1, 1, 3]


# ---------------------------------------------------------------------------
# forward, serving, loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("embeds", [True, False], ids=["embeds", "tokens"])
def test_forward_matches_reference_in_f32(pair, embeds):
    jc, tc, jp, tp = pair
    ins = _inputs(jc, 2, 16, embeds=embeds)
    want = JT.forward(jc, jp, **_j(ins))
    got = build_model(tc).forward(tp, **_t(ins))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)


def test_whisper_forward_needs_frames(whisper):
    _, tc, _, tp = whisper
    with pytest.raises(ValueError, match="frames"):
        TT.forward(tc, tp, torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar_pos", "per_slot_pos"])
def test_prefill_then_eight_decode_steps_match_reference(pair, per_slot):
    jc, tc, jp, tp = pair
    ins = _inputs(jc, 2, 8, embeds=False)
    jcache, tcache = JT.init_cache(jc, 2, 24), TT.init_cache(tc, 2, 24, device="cpu")
    assert sorted(tcache) == sorted(jcache)
    jl, jcache = JT.prefill(jc, jp, jcache, **_j(ins))
    tl, tcache = TT.prefill(tc, tp, tcache, **_t(ins))
    _close(tl, jl)
    for key in ("k", "v", "xk", "xv"):
        if key in jcache:
            _close(tcache[key], jcache[key])
    if per_slot:  # the continuous-batching layout: lanes at their own positions
        jcache = dict(jcache, pos=jnp.asarray([8, 3], jnp.int32))
        tcache = dict(tcache, pos=torch.tensor([8, 3], dtype=torch.int32))
    nxt = np.array([[3], [5]], np.int32)
    for _ in range(8):
        jl, jcache = JT.decode_step(jc, jp, jcache, jnp.asarray(nxt))
        tl, tcache = TT.decode_step(tc, tp, tcache, torch.from_numpy(nxt))
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
    _close(tcache["k"], jcache["k"])
    assert np.asarray(tcache["pos"]).tolist() == np.asarray(jcache["pos"]).tolist()


def test_prefill_from_embeddings_matches_reference(pair):
    jc, tc, jp, tp = pair
    ins = _inputs(jc, 2, 8)
    jl, jcache = JT.prefill(jc, jp, JT.init_cache(jc, 2, 16), **_j(ins))
    tl, tcache = TT.prefill(tc, tp, TT.init_cache(tc, 2, 16, device="cpu"), **_t(ins))
    _close(tl, jl)
    _close(tcache["v"], jcache["v"])


@pytest.mark.parametrize("batch_kind", ["embeds", "tokens"])
def test_loss_and_every_gradient_match_the_reference(pair, batch_kind):
    jc, tc, jp, tp = pair
    r = np.random.default_rng(3)
    B, S = 2, 12
    if batch_kind == "embeds":
        batch = {"embeds": r.standard_normal((B, S, jc.d_model)).astype(np.float32),
                 "labels": r.integers(0, jc.vocab, (B, S)).astype(np.int32)}
    else:
        batch = {"tokens": r.integers(0, jc.vocab, (B, S + 1)).astype(np.int32)}
    if jc.enc_layers:
        batch["frames"] = r.standard_normal((B, jc.enc_frames, jc.d_model)).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda p: JT.loss_fn(jc, p, _j(batch)))(jp)
    tl, tg = value_and_grad(build_model(tc).loss, tp, _t(batch))
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    jleaves = jax.tree_util.tree_leaves(jg)
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        a = np.asarray(a, np.float32)
        assert a.shape == tuple(b.shape)
        assert np.abs(a - b.float().numpy()).max() <= TOL * max(np.abs(a).max(), 1e-30)
    if jc.enc_layers:  # the encoder is reached through every layer's cross-attention
        assert float(tg["enc_layers"]["attn"]["wq"].abs().max()) > 0
        assert float(tg["layers"]["xattn"]["wk"].abs().max()) > 0


# ---------------------------------------------------------------------------
# serving: the xk / xv lanes, and what the reference refuses
# ---------------------------------------------------------------------------


def test_slot_arena_admits_the_cross_attention_lanes(whisper):
    """A batch-1 whisper prefill admitted into slot 1 of a 3-slot arena
    copies its xk/xv lanes as the reference's arena does; a per-slot decode
    step over both arenas then agrees (the idle lanes compute what is never
    sampled), and releasing the slot zeroes its lanes."""
    jc, tc, jp, tp = whisper
    ins = _inputs(jc, 1, 6, embeds=False)
    jmodel = type("M", (), dict(init_cache=lambda self, b, s: JT.init_cache(jc, b, s)))()
    jarena, tarena = JArena(jmodel, 3, 16), KVArena(build_model(tc), 3, 16, device="cpu")
    _, jrc = JT.prefill(jc, jp, JT.init_cache(jc, 1, 16), **_j(ins))
    _, trc = TT.prefill(tc, tp, TT.init_cache(tc, 1, 16, device="cpu"), **_t(ins))
    jarena.load_slot(1, jrc)
    tarena.load_slot(1, trc)
    for key in ("k", "v", "xk", "xv"):
        _close(tarena.cache[key], jarena.cache[key])
    assert float(tarena.cache["xk"][:, 1].abs().max()) > 0
    assert float(tarena.cache["xk"][:, 0].abs().max()) == 0
    toks = np.array([[1], [2], [3]], np.int32)
    jl, _ = JT.decode_step(jc, jp, jarena.cache, jnp.asarray(toks))
    tl, _ = TT.decode_step(tc, tp, tarena.cache, torch.from_numpy(toks))
    _close(tl[1], jl[1])
    tarena.release_slot(1, used=7)
    for key in ("k", "v", "xk", "xv"):
        assert float(tarena.cache[key][:, 1].abs().max()) == 0
    assert int(tarena.positions[1]) == 0


def test_serve_step_and_the_paged_arena_refuse_whisper_as_the_reference(whisper):
    jc, tc, jp, tp = whisper
    toks, valid = np.zeros((1, 2), np.int32), np.ones((1,), np.int32)
    with pytest.raises(NotImplementedError, match="pure-attention"):
        JT.serve_step(jc, jp, JT.init_cache(jc, 1, 8), jnp.asarray(toks), jnp.asarray(valid))
    with pytest.raises(NotImplementedError, match="pure-attention"):
        TT.serve_step(tc, tp, TT.init_cache(tc, 1, 8, device="cpu"),
                      torch.from_numpy(toks), torch.from_numpy(valid))
    from repro.serving.kv import PagedKVArena as JPaged

    jmodel = type("M", (), dict(cfg=jc))()
    with pytest.raises(ValueError, match="pure-attention"):
        JPaged(jmodel, 2, 8)
    with pytest.raises(ValueError, match="pure-attention"):
        PagedKVArena(build_model(tc), 2, 8, device="cpu")
    # the serving configuration routes it off both, as the reference's does
    sc = ServeConfig(paged=True, prefill_chunk=4).resolved_for(tc)
    assert (sc.paged, sc.prefill_chunk) == (False, 0)


def test_engine_and_scheduler_refuse_whisper_for_its_missing_frames(whisper):
    """The serving path prefills with tokens only, as the reference's does
    (``serving/engine.py``), so it cannot carry whisper's encoder frames."""
    _, tc, _, tp = whisper
    for cls in (ServingEngine, ContinuousBatchingScheduler):
        with pytest.raises(ValueError, match="frames"):
            cls(tc, tp, config=ServeConfig(max_slots=2, max_seq=16))


def test_qwen2vl_scheduler_streams_equal_reference():
    """qwen2-vl serves from tokens (its embedding table) on the paged arena
    with chunked prefill, M-RoPE at every written position."""
    from repro.serving import ContinuousBatchingScheduler as JScheduler
    from repro.serving import ServeConfig as JServeConfig

    jc, tc, jp, tp = _f32_pair("qwen2-vl-2b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jc.vocab, n).astype(np.int32) for n in (5, 9, 3)]
    kw = dict(max_slots=2, max_seq=32, paged=True, page_size=8, prefill_chunk=4)
    js = JScheduler(jc, jp, config=JServeConfig(**kw))
    ts = ContinuousBatchingScheduler(tc, tp, config=ServeConfig(**kw))
    jr = [js.submit(p, max_new_tokens=5) for p in prompts]
    tr = [ts.submit(p, max_new_tokens=5) for p in prompts]
    js.run()
    ts.run()
    assert [r.generated for r in tr] == [r.generated for r in jr]


def test_launch_serve_and_train_run_qwen2vl_on_the_cpu(tmp_path):
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as train

    reqs = serve(["--arch", "qwen2-vl-2b", "--device", "cpu", "--requests", "2",
                  "--prompt-len", "5", "--new-tokens", "2", "--max-batch", "2"])
    assert [len(r.generated) for r in reqs] == [2, 2]
    losses = train(["--arch", "qwen2-vl-2b", "--smoke", "--device", "cpu", "--steps",
                    "3", "--batch", "2", "--seq", "16", "--log-every", "5"])
    assert len(losses) == 3 and all(np.isfinite(losses))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_whisper_dispatch_hits_misses_and_fallbacks_match_the_reference():
    """The smoke forward (embeddings and frames) under both packages'
    DispatchContext with the same stored traces for the cross-attention's
    two contractions and none for the other tasks: the hits, misses and
    reasons of every key are the reference's.  The cross-attention (S != T)
    falls back with ``shape_mismatch`` in both and its chunked contractions
    hit; its q/k/v projections are plain einsums in both, so they reach no
    hook.  The reference runs under ``jax.disable_jit()`` so that its scans
    call the hooks once a layer, on its ``jnp`` backend; the port on that
    backend's twin, the structural ``torch`` one: neither has an untuned
    fused attention (``no_fused_backend``).  Each stored trace is the
    sampled one of fewest iterated trips, which the structural lowering runs
    one by one."""
    from repro.core.modules import SpaceGenerator, default_modules
    from repro.core.validator import validate_trace as jvalidate
    from repro.core.workloads import get_workload as jget
    from repro.integration.dispatch import DispatchContext as JDispatch
    from repro.integration.extract import extract_task_specs as jextract
    from repro.search.database import Database as JDatabase
    from repro.search.database import TuningRecord as JRecord
    from repro_torch.core.workloads import get_workload as tget
    from repro_torch.integration.dispatch import DispatchContext
    from repro_torch.search.database import Database, TuningRecord

    jc, tc, jp, tp = _f32_pair("whisper-medium")
    S, L, F = 8, tc.n_layers, tc.enc_frames
    B, KVH, D = 1, tc.n_kv_heads, tc.head_dim
    cross = {f"batch_matmul/b={B * KVH}/k={D}/m={S}/n={F}",
             f"batch_matmul/b={B * KVH}/k={F}/m={S}/n={D}"}
    specs = jextract(jc, batch=B, seq=S, mesh=None, min_task_elems=1,
                     dispatchable_only=True)
    jdb, tdb, jtasks, ttasks = JDatabase(), Database(), [], []
    for t in specs:
        func = jget(t.op, **t.kwargs)
        if t.key in cross:
            traces = [SpaceGenerator(default_modules()).generate(func, seed=i).trace
                      for i in range(32)]
            tr = min(traces, key=lambda tr: jvalidate(func, tr).iterations)
            jdb.put(JRecord(t.key, tr.to_json(), 1e-5))
            tdb.put(TuningRecord(t.key, tr.to_json(), 1e-5))
        jtasks.append(type("T", (), dict(key=t.key, func=func)))
        ttasks.append(type("T", (), dict(key=t.key, func=tget(t.op, **t.kwargs))))
    assert set(jdb.keys()) == cross
    ins = _inputs(jc, B, S)
    with jax.disable_jit(), JDispatch(jdb, tasks=jtasks, backend="jnp") as jctx:
        want = JT.forward(jc, jp, **_j(ins))
    with DispatchContext(tdb, tasks=ttasks, backend="torch") as tctx:
        got = TT.forward(tc, tp, **_t(ins))
    trows = tctx.stats_by_key()
    assert trows == jctx.stats_by_key()
    assert trows["site:attention"]["reasons"] == {
        "no_fused_backend": tc.enc_layers + L, "shape_mismatch": L}
    for key in cross:  # the cross-attention's one chunk of 32 frames a layer
        assert trows[key]["hits"] == L
    assert (tctx.stats["hits"], tctx.stats["misses"]) == (jctx.stats["hits"],
                                                          jctx.stats["misses"])
    _close(got, want)


def test_no_schedule_reaches_the_qwen2vl_forward_unembed_in_either_package():
    """The validator caps a tile at 2^17 elements (bm·bn·bk) and the
    lowering caps a grid at 2^18 tile steps, the same caps in both
    packages; qwen2-vl-2b's forward unembed (m256 k1536 n151936) has more
    multiply-adds than their product, so every tile the validator accepts
    is rejected for its grid, and the search can find none (whisper's
    unembed, m256 k1024 n51865, fits)."""
    from repro.backends.pallas_backend import MAX_GRID_STEPS as JGRID
    from repro.core.validator import MAX_TILE_ELEMS as JTILE
    from repro_torch.backends import gpu_backend as gb
    from repro_torch.core.modules import SpaceGenerator, default_modules
    from repro_torch.core.validator import MAX_TILE_ELEMS, validate_trace
    from repro_torch.core.workloads import get_workload
    from repro_torch.kernels import ScheduleRejected

    assert (MAX_TILE_ELEMS, gb.MAX_GRID_STEPS) == (JTILE, JGRID)
    cap = MAX_TILE_ELEMS * gb.MAX_GRID_STEPS
    assert 256 * 1024 * 51865 <= cap < 256 * 1536 * 151936
    func = get_workload("dense", m=256, n=151936, k=1536)
    gen = SpaceGenerator(default_modules(use_mxu=True))
    valid = 0
    for seed in range(320):
        v = validate_trace(func, gen.generate(func, seed=seed).trace)
        if not v.ok:
            continue
        valid += 1
        with pytest.raises(ScheduleRejected, match="grid of"):
            gb.lower_dense(v.schedule)
    assert valid >= 20

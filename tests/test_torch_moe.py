"""The port's mixture-of-experts family (olmoe, arctic) against the JAX
package's, on the CPU.

``jax.random`` cannot be reproduced in torch, so the layer tests build
their inputs with numpy and the model tests carry the reference's
parameters across with ``models/convert.py``.  Everything runs in float32.
Top-k routing is discontinuous, so every test first asserts that the two
packages chose the same experts for every token (a routing flip shows up
as a flip, not as a large difference), then compares outputs: the MoE layer
within rtol/atol 1e-5 (sums of at most 64 products and 8 gates in another
order, values of order 1), logits within rtol/atol 1e-4 (as the other model
tests).  NaN must land on the same elements.  Task extraction must give the
reference's tasks field for field, and dispatch its hits and misses by key.
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
from repro_torch.configs.base import get_config as tcfg
from repro_torch.integration import extract as TE
from repro_torch.kernels import ScheduleRejected, tile_counters
from repro_torch.kernels import matmul as mm
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax

TOL_LAYER = 1e-5
TOL_LOGITS = 1e-4
MOE = ["olmoe-1b-7b", "arctic-480b"]


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v))
            for k, v in tree.items()}


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _ref_route(p, x, top_k):
    """The reference ``moe``'s routing, step for step."""
    xt = x.reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), p["router"])
    return jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)[1]


def _layer_params(r, D, E, F, skew=0.0):
    """numpy MoE parameters; ``skew`` > 0 adds one shared direction to the
    router's columns 0-7, which then win most tokens and overflow."""
    router = r.standard_normal((D, E)).astype(np.float32)
    if skew:
        router[:, :8] += skew
    return dict(
        router=router,
        wi=(r.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
        wg=(r.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
        wo=(r.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32),
    )


def _drops(gate_idx, E, C):
    """(token, slot) pairs past their expert's capacity C."""
    flat = gate_idx.reshape(-1)
    seen = np.zeros(E, np.int64)
    dropped = 0
    for e in flat:
        dropped += seen[e] >= C
        seen[e] += 1
    return int(dropped)


def _layer_pair(p, x, top_k, cf):
    """Both packages' ``moe`` on numpy inputs; asserts the routing first."""
    want_idx = np.asarray(_ref_route(_j(p), jnp.asarray(x), top_k))
    _, got_idx = TL.moe_route(_t(p), torch.from_numpy(x).reshape(-1, x.shape[-1]), top_k)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    want = np.asarray(JL.moe(_j(p), jnp.asarray(x), top_k, cf))
    got = TL.moe(_t(p), torch.from_numpy(x), top_k, cf).numpy()
    return got, want, want_idx


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,cf,skew", [(16, -1.0, 0.0), (4, 2.0, 0.0), (128, 2.0, 1.5)],
                         ids=["dropless", "E64-top8-T4", "E64-top8-T128-drops"])
def test_moe_layer_matches_reference(T, cf, skew):
    D, E, F, k = 32, 64, 16, 8
    r = np.random.default_rng(T)
    p = _layer_params(r, D, E, F, skew)
    x = r.standard_normal((2, T // 2, D)).astype(np.float32)
    got, want, idx = _layer_pair(p, x, k, cf)
    C = TL.moe_capacity(T, k, E, cf)
    assert C == (T if cf <= 0 else max(int(cf * k * T / E), 4))
    if T == 128:
        assert C == 32 and _drops(idx, E, C) > 0  # the capacity rule bites
    else:
        # dropless, or T = 4 at the capacity floor of 4: a token takes an
        # expert at most once, so no expert can overflow
        assert _drops(idx, E, C) == 0
    np.testing.assert_allclose(got, want, rtol=TOL_LAYER, atol=TOL_LAYER)


def test_moe_top_k_tie_takes_the_lower_index_first():
    # columns 1 and 2 are equal: every token's second choice is a tie
    # between experts 1 and 2, which jax.lax.top_k breaks to expert 1
    D, E, F = 8, 4, 4
    r = np.random.default_rng(3)
    p = _layer_params(r, D, E, F)
    v = np.abs(r.standard_normal(D)).astype(np.float32)
    p["router"] = np.stack([2 * v, v, v, -v], axis=1)
    x = np.abs(r.standard_normal((1, 6, D))).astype(np.float32)
    probs = TL.moe_route(_t(p), torch.from_numpy(x[0]), 2)
    assert (probs[1].numpy() == [0, 1]).all()
    assert np.asarray(jax.lax.top_k(jnp.asarray([1.0, 2.0, 2.0, 0.0]), 2)[1]).tolist() == [1, 2]
    got, want, idx = _layer_pair(p, x, 2, -1.0)
    assert (idx == [0, 1]).all()
    np.testing.assert_allclose(got, want, rtol=TOL_LAYER, atol=TOL_LAYER)


def test_moe_nan_in_an_expert_reaches_the_same_tokens():
    # expert 63's output is NaN.  A dropped pair gathers out_e[E-1, C-1] in
    # the reference (JAX clamps the out-of-range gather) and weights it by
    # 0, so NaN reaches every token with a dropped pair as well as those
    # routed to expert 63; the port clamps the same way
    D, E, F, k, T = 32, 64, 16, 8, 128
    r = np.random.default_rng(5)
    p = _layer_params(r, D, E, F, skew=1.5)
    p["wo"][E - 1, 0, 0] = np.nan
    x = r.standard_normal((1, T, D)).astype(np.float32)
    got, want, idx = _layer_pair(p, x, k, 2.0)
    nan_rows = np.isnan(want[0]).any(-1)
    routed = (idx == E - 1).any(-1)
    assert nan_rows.sum() > routed.sum() > 0  # dropped pairs carry NaN too
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=TOL_LAYER, atol=TOL_LAYER)


def test_moe_layer_runs_on_meta_tensors_at_olmoe_width():
    cfg = tcfg("olmoe-1b-7b")
    p = TT._layer(TT.init_params(cfg, device="meta")["layers"], 0)["moe"]
    x = torch.empty((1, 256, cfg.d_model), dtype=torch.bfloat16, device="meta")
    out = TL.moe(p, x, cfg.moe_top_k, cfg.moe_capacity_factor)
    assert out.shape == x.shape and out.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the models: forward, prefill -> decode_step, serve_step
# ---------------------------------------------------------------------------

CASES = [("olmoe-1b-7b", {}), ("arctic-480b", {}),
         ("olmoe-1b-7b", dict(moe_capacity_factor=1.0))]
IDS = ["olmoe-smoke", "arctic-smoke", "olmoe-smoke-capacity1"]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def pair(request):
    arch, over = request.param
    jc = dataclasses.replace(jcfg(arch, smoke=True), dtype="float32", **over)
    tc = dataclasses.replace(tcfg(arch, smoke=True), dtype="float32", **over)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                JT.init_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.fixture
def routes(monkeypatch):
    """Each package's gate indices, call by call: the reference's through
    ``jax.debug.callback`` from inside its layer scan, the port's from the
    same routing on the same input."""
    got, want = [], []
    j_moe, t_moe = JL.moe, TL.moe

    def j_spy(p, x, top_k, *a, **kw):
        jax.debug.callback(lambda g: want.append(np.asarray(g)),
                           _ref_route(p, x, top_k), ordered=True)
        return j_moe(p, x, top_k, *a, **kw)

    def t_spy(p, x, top_k, *a, **kw):
        got.append(TL.moe_route(p, x.reshape(-1, x.shape[-1]), top_k)[1].numpy())
        return t_moe(p, x, top_k, *a, **kw)

    monkeypatch.setattr(JL, "moe", j_spy)
    monkeypatch.setattr(TL, "moe", t_spy)

    def check(n_calls):
        jax.effects_barrier()
        assert len(got) == len(want) == n_calls
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return got

    return check


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=TOL_LOGITS, atol=TOL_LOGITS)


def test_forward_logits_match_reference(pair, routes):
    jc, tc, jp, tp = pair
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 16)).astype(np.int32)
    want = JT.forward(jc, jp, tokens=jnp.asarray(toks))
    got = TT.forward(tc, tp, torch.from_numpy(toks).long())
    idx = routes(jc.n_layers)
    if jc.moe_capacity_factor > 0:
        C = TL.moe_capacity(32, jc.moe_top_k, jc.moe_experts, jc.moe_capacity_factor)
        assert sum(_drops(g, jc.moe_experts, C) for g in idx) > 0
    assert got.shape == want.shape
    _close(got, want)


def test_prefill_then_decode_steps_match_reference(pair, routes):
    jc, tc, jp, tp = pair
    toks = np.random.default_rng(2).integers(0, jc.vocab, (2, 8)).astype(np.int32)
    jcache, tcache = JT.init_cache(jc, 2, 24), TT.init_cache(tc, 2, 24, device="cpu")
    jl, jcache = JT.prefill(jc, jp, jcache, tokens=jnp.asarray(toks))
    tl, tcache = TT.prefill(tc, tp, tcache, torch.from_numpy(toks).long())
    _close(tl, jl)
    _close(tcache["k"], jcache["k"])
    nxt = np.array([[3], [5]], np.int32)
    for _ in range(3):
        jl, jcache = JT.decode_step(jc, jp, jcache, jnp.asarray(nxt))
        tl, tcache = TT.decode_step(tc, tp, tcache, torch.from_numpy(nxt).long())
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
    routes(4 * jc.n_layers)
    _close(tcache["v"], jcache["v"])


@pytest.mark.parametrize("paged", [False, True])
def test_serve_step_with_padding_lanes_matches_reference(pair, routes, paged):
    """A (B, C) tick of a decode lane, a chunk lane and an idle lane: every
    column, padding included, is routed and takes expert capacity."""
    jc, tc, jp, tp = pair
    B, C = 3, 4
    jcache = dict(JT.init_cache(jc, B, 16))
    if paged:
        table = np.array([[0, 3], [1, 6], [6, 6]], np.int32)
        r = np.random.default_rng(3)
        shape = (jc.n_layers, 6, jc.n_kv_heads, 8, jc.head_dim)
        jcache = {"k": jnp.asarray(r.standard_normal(shape).astype(np.float32)),
                  "v": jnp.asarray(r.standard_normal(shape).astype(np.float32)),
                  "page_table": jnp.asarray(table)}
    jcache["pos"] = jnp.asarray([5, 2, 0], jnp.int32)
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    toks = np.random.default_rng(4).integers(0, jc.vocab, (B, C)).astype(np.int32)
    valid = np.array([1, 4, 0], np.int32)
    for _ in range(2):
        jl, jcache = JT.serve_step(jc, jp, jcache, jnp.asarray(toks), jnp.asarray(valid))
        tl, tcache = TT.serve_step(tc, tp, tcache, torch.from_numpy(toks).long(),
                                   torch.from_numpy(valid))
        _close(tl[:2], jl[:2])  # lane 2 is idle: its logits are never sampled
        _close(tcache["k"], jcache["k"])
        _close(tcache["v"], jcache["v"])
    idx = routes(2 * jc.n_layers)
    assert all(g.shape == (B * C, jc.moe_top_k) for g in idx)


def test_params_from_jax_carries_the_moe_subtree(pair):
    jc, tc, _, _ = pair
    jp = JT.init_params(jc, jax.random.PRNGKey(1))  # the reference's dtypes
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    moe = tp["layers"]["moe"]
    assert set(moe) == {"router", "wi", "wg", "wo"}
    assert ("mlp" in tp["layers"]) == jc.moe_dense_residual
    assert moe["router"].dtype == torch.float32
    L, D, E, F = jc.n_layers, jc.d_model, jc.moe_experts, jc.d_ff
    shapes = dict(router=(L, D, E), wi=(L, E, D, F), wg=(L, E, D, F), wo=(L, E, F, D))
    for name, t in moe.items():
        want = np.asarray(jp["layers"]["moe"][name].astype(jnp.float32))
        assert tuple(t.shape) == shapes[name] == want.shape
        assert str(t.dtype)[6:] == str(jp["layers"]["moe"][name].dtype)
        np.testing.assert_array_equal(t.float().numpy(), want)
    mine = TT.init_params(tc, device="meta")
    got = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), mine)
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert got == want


# ---------------------------------------------------------------------------
# serving entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_launch_serve_serves_the_moe_smoke_models_on_the_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    reqs = main(["--device", "cpu", "--arch", arch, "--new-tokens", "4"])
    assert len(reqs) == 8 and all(r.done and len(r.generated) == 4 for r in reqs)
    assert "decode" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# task extraction
# ---------------------------------------------------------------------------


def _fields(tasks):
    return [(t.key, t.op, t.kwargs, t.weight, t.flops, t.dispatchable, t.struct_hash)
            for t in tasks]


@pytest.mark.parametrize("arch,smoke,n_fwd,n_dec", [
    ("olmoe-1b-7b", False, 11, 16),
    ("olmoe-1b-7b", True, None, None),
    ("arctic-480b", True, None, None),
])
def test_extraction_gives_the_references_tasks(arch, smoke, n_fwd, n_dec):
    jc, tc = jcfg(arch, smoke=smoke), tcfg(arch, smoke=smoke)
    seq = 256 if not smoke else 32
    kw = dict(batch=1, seq=seq, min_task_elems=4096 if not smoke else 1)
    want = _fields(JE.extract_task_specs(jc, mesh=None, **kw))
    assert _fields(TE.extract_task_specs(tc, **kw)) == want
    dkw = dict(batch=4, max_seq=256, chunk=32, paged=True, page_size=16)
    if smoke:
        dkw = dict(batch=2, max_seq=32, chunk=4, paged=True, page_size=8, min_task_elems=1)
    dwant = _fields(JE.extract_decode_task_specs(jc, mesh=None, **dkw))
    assert _fields(TE.extract_decode_task_specs(tc, **dkw)) == dwant
    if not smoke:
        assert (len(want), len(dwant)) == (n_fwd, n_dec)
        keys = {f[0]: f for f in want}
        assert keys["batch_matmul/b=64/k=2048/m=64/n=1024"][3] == 32
        assert keys["dense/k=2048/m=256/n=64"][5]  # the router, never hooked
        assert not keys["sfm/m=256/n=64"][5]
        dkeys = {f[0] for f in dwant}
        assert {"batch_matmul/b=64/k=2048/m=4/n=1024",
                "batch_matmul/b=64/k=1024/m=32/n=2048"} <= dkeys


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_dispatch_hits_and_misses_by_key_match_the_reference():
    """The smoke forward under both packages' DispatchContext with the same
    stored traces for the expert products and none for the other tasks: the
    hits, misses and reasons of every key are the reference's.  The
    reference runs with ``jax.disable_jit()`` so that its layer scan calls
    the hooks once a layer, as the port's loop does, on its ``jnp``
    backend; the port on that backend's twin, the structural ``torch``
    one, which like it has no untuned fused attention, so both fall back
    to the chunked path and look up its contractions."""
    from repro.core.modules import SpaceGenerator, default_modules
    from repro.core.workloads import get_workload as jget
    from repro.integration.dispatch import DispatchContext as JDispatch
    from repro.search.database import Database as JDatabase
    from repro.search.database import TuningRecord as JRecord
    from repro_torch.core.workloads import get_workload as tget
    from repro_torch.integration.dispatch import DispatchContext
    from repro_torch.search.database import Database, TuningRecord

    jc, tc = jcfg("olmoe-1b-7b", smoke=True), tcfg("olmoe-1b-7b", smoke=True)
    S = 8
    specs = JE.extract_task_specs(jc, batch=1, seq=S, mesh=None, min_task_elems=1,
                                  dispatchable_only=True)
    jdb, tdb, jtasks, ttasks = JDatabase(), Database(), [], []
    for i, t in enumerate(specs):
        func = jget(t.op, **t.kwargs)
        if t.key.startswith(f"batch_matmul/b={jc.moe_experts}/"):
            tr = SpaceGenerator(default_modules()).generate(func, seed=i).trace
            jdb.put(JRecord(t.key, tr.to_json(), 1e-5))
            tdb.put(TuningRecord(t.key, tr.to_json(), 1e-5))
        jtasks.append(type("T", (), dict(key=t.key, func=func)))
        ttasks.append(type("T", (), dict(key=t.key, func=tget(t.op, **t.kwargs))))
    assert len(jdb.keys()) == 2
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                JT.init_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, jc.vocab, (1, S)).astype(np.int32)
    with jax.disable_jit(), JDispatch(jdb, tasks=jtasks, backend="jnp") as jctx:
        want = JT.forward(jc, jp, tokens=jnp.asarray(toks))
    with DispatchContext(tdb, tasks=ttasks, backend="torch") as tctx:
        got = TT.forward(tc, tp, torch.from_numpy(toks).long())
    trows = tctx.stats_by_key()
    assert trows == jctx.stats_by_key()
    assert trows["site:attention"]["reasons"] == {"no_fused_backend": tc.n_layers}
    assert (tctx.stats["hits"], tctx.stats["misses"]) == (jctx.stats["hits"],
                                                          jctx.stats["misses"])
    for key in jdb.keys():
        assert trows[key]["hits"] == (2 if "/k=64/" in key else 1) * tc.n_layers
    _close(got, want)


def test_dispatched_expert_products_read_the_bf16_weights_as_f32():
    """K2 takes f32: dispatch hands it the expert weights as an f32 copy of
    the bf16 values, exact, as the reference's ``astype`` does."""
    from repro_torch.integration.dispatch import DispatchContext

    E, C, D, F = 4, 8, 16, 12
    r = np.random.default_rng(0)
    a = torch.from_numpy(r.standard_normal((E, C, D), dtype=np.float32)).bfloat16()
    w = torch.from_numpy(r.standard_normal((E, D, F), dtype=np.float32)).bfloat16()
    import repro_torch
    from repro_torch.core.workloads import get_workload
    from repro_torch.search.database import Database
    from repro_torch.search.evolutionary import SearchConfig
    from repro_torch.search.task_scheduler import TuneTask

    tasks = [TuneTask(key=f"batch_matmul/b={E}/k={D}/m={C}/n={F}",
                      func=get_workload("batch_matmul", b=E, m=C, n=F, k=D))]
    db = Database()
    repro_torch.TaskScheduler(tasks, database=db, config=repro_torch.TuneConfig(
        search=SearchConfig(max_trials=2, init_random=2, population=2,
                            measure_per_round=2),
        runner_spec="cached+local", backend="cuda", device="cpu",
    )).tune(total_rounds=1)
    seen = []
    with DispatchContext(db, tasks=tasks) as ctx:
        kern = ctx.kernel(tasks[0].key)
        inner = kern.fn
        kern.fn = lambda ins: (seen.append(ins), inner(ins))[1]
        out = TL.bmm_op(a, w)
    assert ctx.hits_by_key[tasks[0].key] == 1 and len(seen) == 1
    A, B = seen[0]["A"], seen[0]["B"]
    assert A.dtype == B.dtype == torch.float32
    want_b = np.asarray(jnp.asarray(w.float().numpy()).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(B.numpy(), want_b)
    assert torch.equal(A, a.float())
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), (a.float() @ w.float()).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,N", [(2048, 1024), (1024, 2048)])
def test_splitk_plans_scale_to_olmoe_decode_at_every_split(K, N):
    """K2 at olmoe's decode shapes (b64 m4): every tile whose split count
    divides K plans within the card's grid, its split counters come from
    ``tile_counters`` zeroed and as many as the plan's output tiles, and
    its partials fit 64-bit addressing the kernel uses (and 2^31 floats)."""
    B, M = 64, 4
    splits_seen = set()
    for bk in [d for d in range(1, K + 1) if K % d == 0]:
        for bm, bn in ((4, 64), (1, 32), (2, 8), (4, N)):
            try:
                cfg = mm.launch_config(B, M, N, K, (bm, bn, bk))
            except ScheduleRejected as e:
                assert e.reason == "shared_memory"
                assert mm.splitk_smem_bytes(bm, bn, bk) > mm.MAX_SMEM_BYTES
                continue
            assert cfg["variant"] == "splitk" and cfg["splits"] == K // bk
            gx, gy, gz = cfg["grid"]
            assert (gx, gy, gz) == (N // bn, B * M // bm, K // bk)
            assert gy <= 65535 and gz <= 65535
            counters = tile_counters(torch.device("cpu"), 0, gx * gy)
            assert counters.numel() >= gx * gy and not counters.any()
            assert cfg["splits"] * B * M * N < 2**31
            splits_seen.add(cfg["splits"])
    assert max(splits_seen) == K and 1 in splits_seen

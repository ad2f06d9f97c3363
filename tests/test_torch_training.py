"""The port's training stack against the JAX package's, on the CPU.

Both packages get the same seeded numpy inputs at smoke size, in float32
unless stated; ``models/convert.py`` carries the reference's parameters
across.  Tolerances, each with its reason:

* loss and gradients: 1e-5 of the loss and of each leaf's max |g| (f32
  sums in another order; the observed differences are ~2e-6);
* AdamW: 1e-6 absolute on f32 parameters and moments (the same f32
  arithmetic in the same order; pow and cos may differ by an ulp), one
  bf16 ulp on a bf16 leaf;
* a whole train step: the loss within 1e-5 relative, and the updated
  parameters within 2·lr: the first AdamW step moves each element by
  about sign(g)·lr, so an element whose gradient sits at rounding level
  may flip sign between two correct runs; the elements further apart than
  1e-6 are counted and must stay rare;
* batches, pipelines and checkpoints: byte for byte;
* resume against an uninterrupted run: 1e-5, as the reference's own test.
"""

import dataclasses
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_config as jcfg
from repro.data.pipeline import SyntheticTokenPipeline as JPipeline
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.training import checkpoint as jckpt
from repro.training import optimizer as JO
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.base import get_config as tcfg
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ssd as tssd
from repro_torch.models import registry as TR
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as TO
from repro_torch.training.fault_tolerance import StepFailure, StragglerDetector, retry
from repro_torch.training.train_loop import make_eval_step, make_train_step, value_and_grad

TOL_GRAD = 1e-5
TOL_ADAMW = 1e-6


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch):
    jc = dataclasses.replace(jcfg(arch, smoke=True), dtype="float32")
    tc = dataclasses.replace(tcfg(arch, smoke=True), dtype="float32")
    jp = _f32(JT.init_params(jc, jax.random.PRNGKey(0)))
    return jc, tc, jp, params_from_jax(_np(jp), device="cpu")


@pytest.fixture(scope="module")
def smollm():
    return _pair("smollm-135m")


@pytest.fixture(scope="module")
def mamba():
    return _pair("mamba2-370m")


def _tokens(vocab, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)


def _close_trees(jtree, ttree, tol):
    """Every leaf within ``tol`` of its reference leaf's max |value|."""
    jl, tl = jax.tree_util.tree_leaves(jtree), TO.tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a, b = np.asarray(a, np.float32), b.detach().float().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-30)


def _step_close(jtree, ttree, lr):
    """Updated parameters within 2·lr; elements off by more than 1e-6 are
    sign flips of rounding-level gradients, and stay rare."""
    far = total = 0
    for a, b in zip(jax.tree_util.tree_leaves(jtree), TO.tree_leaves(ttree)):
        d = np.abs(np.asarray(a, np.float32) - b.float().numpy())
        assert d.max() <= 2 * lr
        far += int((d > 1e-6).sum())
        total += d.size
    assert far <= 1e-3 * total, (far, total)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm", "mamba"])
def test_loss_and_every_gradient_match_the_reference(arch, request):
    jc, tc, jp, tp = request.getfixturevalue(arch)
    toks = _tokens(jc.vocab, 2, 32)
    jl, jg = jax.value_and_grad(
        lambda p: JT.loss_fn(jc, p, {"tokens": jnp.asarray(toks)}))(jp)
    tl, tg = value_and_grad(TR.build_model(tc).loss, tp,
                            {"tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(jl)) <= TOL_GRAD * abs(float(jl))
    _close_trees(jg, tg, TOL_GRAD)
    # every leaf reaches the loss
    assert all(float(g.abs().max()) > 0 for g in TO.tree_leaves(tg))


def test_eval_step_is_the_loss_without_a_graph(smollm):
    _, tc, _, tp = smollm
    batch = {"tokens": torch.from_numpy(_tokens(tc.vocab, 2, 16))}
    model = TR.build_model(tc)
    got = make_eval_step(model)(tp, batch)
    assert got.grad_fn is None
    assert torch.equal(got, model.loss(tp, batch).detach())


# ---------------------------------------------------------------------------
# batches and the data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-vl-2b", "whisper-medium"])
def test_train_batch_and_specs_are_the_reference(arch):
    jc, tc = jcfg(arch, smoke=True), tcfg(arch, smoke=True)
    jshape, tshape = JShape("t", 16, 2, "train"), ShapeConfig("t", 16, 2, "train")
    want = JR.make_train_batch(jc, jshape, seed=5)
    got = TR.make_train_batch(tc, tshape, seed=5, device="cpu")
    specs, jspecs = TR.train_batch_specs(tc, tshape), JR.train_batch_specs(jc, jshape)
    assert sorted(got) == sorted(want) == sorted(specs) == sorted(jspecs)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].view(torch.int16).numpy() if got[k].dtype == torch.bfloat16 \
            else got[k].numpy()
        assert g.tobytes() == w.tobytes(), k
        assert specs[k].device.type == "meta"
        assert tuple(specs[k].shape) == jspecs[k].shape == w.shape
        assert str(specs[k].dtype).split(".")[1] == str(jspecs[k].dtype)


@pytest.mark.parametrize("arch,shards", [("smollm-135m", 1), ("smollm-135m", 2),
                                         ("qwen2-vl-2b", 1)])
def test_pipeline_batches_are_the_reference_bytes(arch, shards):
    kw = dict(seq_len=16, global_batch=4, seed=7, num_shards=shards,
              shard_id=shards - 1)
    want = JPipeline(jcfg(arch, smoke=True), **kw)
    got = SyntheticTokenPipeline(tcfg(arch, smoke=True), **kw)
    for step in (0, 3, 11):
        a, b = want.batch_at(step), got.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    cont = [b["tokens" if "tokens" in b else "labels"]
            for _, b in zip(range(5), iter(got))]
    resumed = [b["tokens" if "tokens" in b else "labels"]
               for _, b in zip(range(2), got.iter_from(3))]
    assert all(x.tobytes() == y.tobytes() for x, y in zip(cont[3:], resumed))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_schedule_matches_the_reference():
    for cfg in (JO.OptConfig(lr=1e-2, warmup_steps=3, total_steps=10),
                JO.OptConfig(warmup_steps=0, total_steps=1)):
        tcfg_ = TO.OptConfig(**dataclasses.asdict(cfg))
        for step in range(0, 14):
            want = float(JO.schedule(cfg, jnp.asarray(step, jnp.int32)))
            got = float(TO.schedule(tcfg_, torch.tensor(step, dtype=torch.int32)))
            assert abs(got - want) <= TOL_ADAMW * cfg.lr


def test_adamw_steps_match_the_reference():
    """Six steps through warmup into the cosine, weight decay on, one step
    with a 1e6 gradient that clipping must cap; f32 leaves within 1e-6,
    the bf16 leaf within one bf16 ulp."""
    r = np.random.default_rng(0)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=10, weight_decay=0.1)
    jcfg_, tcfg_ = JO.OptConfig(**cfg), TO.OptConfig(**cfg)
    p0 = {"w": r.standard_normal(64).astype(np.float32),
          "b": {"x": r.standard_normal((8, 4)).astype(np.float32)},
          "h": r.standard_normal((4, 4)).astype(np.float32)}
    jp = {"w": jnp.asarray(p0["w"]), "b": {"x": jnp.asarray(p0["b"]["x"])},
          "h": jnp.asarray(p0["h"], jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p0["w"]), "b": {"x": torch.from_numpy(p0["b"]["x"])},
          "h": torch.from_numpy(p0["h"]).to(torch.bfloat16)}
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    assert to["step"].dtype == torch.int32 and to["m"]["h"].dtype == torch.float32
    for step in range(6):
        g = {"w": r.standard_normal(64).astype(np.float32),
             "b": {"x": r.standard_normal((8, 4)).astype(np.float32)},
             "h": r.standard_normal((4, 4)).astype(np.float32)}
        if step == 2:
            g["w"][5] = 1e6
        jg = {"w": jnp.asarray(g["w"]), "b": {"x": jnp.asarray(g["b"]["x"])},
              "h": jnp.asarray(g["h"])}
        tg = {"w": torch.from_numpy(g["w"]), "b": {"x": torch.from_numpy(g["b"]["x"])},
              "h": torch.from_numpy(g["h"])}
        if step == 2:
            assert float(TO.global_norm(tg)) > 1e5  # clipped to clip_norm
            np.testing.assert_allclose(float(TO.global_norm(tg)),
                                       float(JO.global_norm(jg)), rtol=1e-6)
        jp, jo = JO.adamw_update(jcfg_, jg, jo, jp)
        tp, to = TO.adamw_update(tcfg_, tg, to, tp)
        assert int(to["step"]) == int(jo["step"]) == step + 1
        for a, b in ((jp["w"], tp["w"]), (jp["b"]["x"], tp["b"]["x"]),
                     (jo["m"]["w"], to["m"]["w"]), (jo["v"]["w"], to["v"]["w"]),
                     (jo["m"]["h"], to["m"]["h"]), (jo["v"]["b"]["x"], to["v"]["b"]["x"])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=TOL_ADAMW)
        assert tp["h"].dtype == torch.bfloat16
        np.testing.assert_allclose(tp["h"].float().numpy(),
                                   np.asarray(jp["h"], np.float32), rtol=2.0**-8)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_compression_error_is_within_one_quantum(bits):
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(256)),
         "v": torch.from_numpy(np.random.default_rng(1).standard_normal((8, 8))
                               .astype(np.float32)).to(torch.bfloat16)}
    gq = TO.compress_gradients(g, bits, TO.seeded_generator("cpu"))
    for k in g:
        x, y = g[k].double(), gq[k].double()
        assert gq[k].dtype == g[k].dtype
        quantum = float(x.abs().max()) / (2 ** (bits - 1) - 1)
        slack = 1.01 if g[k].dtype != torch.bfloat16 else 1.01 + 2.0**-7
        assert float((y - x).abs().max()) <= quantum * slack
    again = TO.compress_gradients(g, bits, TO.seeded_generator("cpu"))
    assert all(torch.equal(gq[k], again[k]) for k in g)
    assert TO.compress_gradients(g, 0, None) is g


def test_compressed_update_draws_its_noise_from_the_generator():
    p = {"w": torch.zeros(64)}
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(64)
                               .astype(np.float32))}
    cfg = TO.OptConfig(lr=1.0, warmup_steps=1, compress_bits=2, weight_decay=0.0)
    a, _ = TO.adamw_update(cfg, g, TO.adamw_init(p), p)
    b, _ = TO.adamw_update(cfg, g, TO.adamw_init(p), p,
                           compress_gen=TO.seeded_generator("cpu", 0))
    c, _ = TO.adamw_update(cfg, g, TO.adamw_init(p), p,
                           compress_gen=TO.seeded_generator("cpu", 1))
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def test_microbatched_train_step_matches_the_reference(smollm):
    jc, tc, jp, tp = smollm
    cfg = dict(lr=1e-3, warmup_steps=1)
    toks = _tokens(jc.vocab, 4, 16)
    jstep = jax.jit(jmake_train_step(JR.build_model(jc), JO.OptConfig(**cfg),
                                     num_microbatches=2))
    jp2, jo2, jm = jstep(jp, JO.adamw_init(jp), {"tokens": jnp.asarray(toks)})
    tstep = make_train_step(TR.build_model(tc), TO.OptConfig(**cfg), num_microbatches=2)
    tp2, to2, tm = tstep(tp, TO.adamw_init(tp), {"tokens": torch.from_numpy(toks)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL_GRAD * float(jm["loss"])
    _step_close(jp2, tp2, cfg["lr"])
    _close_trees(jo2["m"], to2["m"], TOL_GRAD)  # (1 - b1)·g, clipped
    # the step leaves its inputs as they are
    assert torch.equal(TO.tree_leaves(tp)[0], params_from_jax(_np(jp), "cpu")["embed"])


def _dispatch_setup(jc, tc, B, S):
    """The same stored trace (its JSON) for every task in both packages'
    databases, each generated by the port and valid in both."""
    from repro.integration.dispatch import DispatchContext as JDispatch
    from repro.integration.extract import extract_tasks as jextract
    from repro.search.database import Database as JDatabase
    from repro.search.database import TuningRecord as JRecord
    import repro_torch
    from repro_torch.core.modules import SpaceGenerator, default_modules
    from repro_torch.core.validator import validate_trace
    from repro_torch.integration.dispatch import DispatchContext
    from repro_torch.search.database import Database, TuningRecord

    kw = dict(batch=B, seq=S, min_task_elems=16, dispatchable_only=True)
    jtasks, ttasks = jextract(jc, **kw), repro_torch.extract_tasks(tc, **kw)
    assert sorted(t.key for t in jtasks) == sorted(t.key for t in ttasks)
    jdb, tdb = JDatabase(), Database()
    for t in ttasks:
        gen = SpaceGenerator(default_modules(use_mxu=t.use_mxu))
        for s in range(16):
            tr = gen.generate(t.func, seed=s).trace
            if validate_trace(t.func, tr).ok:
                jdb.put(JRecord(t.key, tr.to_json(), 1e-6, time.time()))
                tdb.put(TuningRecord(t.key, tr.to_json(), 1e-6, time.time()))
                break
    jctx, tctx = JDispatch(jdb, tasks=jtasks), DispatchContext(tdb, tasks=ttasks)
    for t in jtasks:  # every stored trace replays in the reference too
        assert jctx._schedule_for(t.key, t.func)[0] is not None, t.key
    return jctx, tctx, ttasks


def test_dispatched_train_step_matches_the_references(smollm):
    """Under a DispatchContext every dense, attention and rmsnorm site
    hits, twice a step (the forward and remat's recompute; the unembed,
    outside the checkpoint, once), and the step is the reference's
    dispatched step."""
    jc, tc, jp, tp = smollm
    B, S = 2, 16
    jctx, tctx, ttasks = _dispatch_setup(jc, tc, B, S)
    cfg = dict(lr=1e-3, warmup_steps=1)
    toks = _tokens(jc.vocab, B, S)
    jstep = jax.jit(jmake_train_step(JR.build_model(jc), JO.OptConfig(**cfg),
                                     dispatch=jctx))
    jp2, _, jm = jstep(jp, JO.adamw_init(jp), {"tokens": jnp.asarray(toks)})
    assert jctx.stats["hits"] > 0
    tstep = make_train_step(TR.build_model(tc), TO.OptConfig(**cfg), dispatch=tctx)
    tp2, _, tm = tstep(tp, TO.adamw_init(tp), {"tokens": torch.from_numpy(toks)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL_GRAD * float(jm["loss"])
    _step_close(jp2, tp2, cfg["lr"])
    # one site of each of these keys sits outside the layers: the unembed
    # and the final norm
    once = (f"/n={tc.vocab}", "rmsnorm/")
    hits = {t.key: 2 * t.weight - any(o in t.key for o in once)
            for t in ttasks if not t.key.startswith("batch_matmul/")}
    assert tctx.hits_by_key == hits
    assert tctx.stats["misses"] == 0 and tctx.stats["attention_tuned"] == 2 * tc.n_layers


def test_remat_recompute_reenters_the_dispatch_context(smollm):
    """Backward after leaving the ``with`` block, as autograd's device
    thread sees it: the recompute must dispatch as the forward did.
    Without the captured context it takes the plain path and checkpoint
    refuses the recomputed tensors."""
    jc, tc, _, tp = smollm
    B, S = 2, 16
    _, tctx, _ = _dispatch_setup(jc, tc, B, S)
    batch = {"tokens": torch.from_numpy(_tokens(tc.vocab, B, S))}
    with tctx:
        want_loss, want = value_and_grad(lambda p, b: TT.loss_fn(tc, p, b), tp, batch)
    fwd_hits = dict(tctx.hits_by_key)
    live = TO.tree_map(lambda p: p.detach().requires_grad_(True), tp)
    with tctx:
        loss = TT.loss_fn(tc, live, batch)
    loss.backward()
    assert {k: n - fwd_hits[k] for k, n in tctx.hits_by_key.items()} == fwd_hits
    assert torch.equal(loss.detach(), want_loss)
    for g, w in zip(TO.tree_leaves(TO.tree_map(lambda p: p.grad, live)),
                    TO.tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_k7_launch_gets_the_plain_scans_gradient(mamba, monkeypatch):
    """The SSD scan through a stand-in for K7 that, like the card's
    kernel, returns tensors with no grad_fn (the plain scan under
    no_grad): the six leaves that reach the loss only through the scan
    get the plain scan's gradient, and so does the final state."""
    jc, tc, _, tp = mamba

    def standin(x, log_a, B, C, *, chunk=64, return_state=False):
        with torch.no_grad():
            return kref.ssd_chunked(x, log_a, B, C, chunk=min(chunk, x.shape[1]),
                                    return_state=return_state)

    batch = {"tokens": torch.from_numpy(_tokens(tc.vocab, 2, 32))}
    want_loss, want = value_and_grad(lambda p, b: TT.loss_fn(tc, p, b, ssd_backend="torch"),
                                     tp, batch)
    monkeypatch.setattr(tssd, "ssd", standin)
    loss, got = value_and_grad(lambda p, b: TT.loss_fn(tc, p, b), tp, batch)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    for name in ("wx", "wB", "wC", "wdt", "A_log", "dt_bias"):
        g, w = got["layers"]["ssd"][name], want["layers"]["ssd"][name]
        assert float(w.abs().max()) > 0
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
    # return_state: y's and the state's gradients, and y's alone
    r = np.random.default_rng(3)
    ins = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
           for s in ((1, 32, 2, 8), (1, 32, 2), (1, 32, 4), (1, 32, 4))]
    ins[1] = -ins[1].abs()
    for use_state in (True, False):
        grads = []
        for fn in (ops.ssd, kref.ssd_chunked):
            leaves = [t.clone().requires_grad_(True) for t in ins]
            y, h = fn(*leaves, chunk=16, return_state=True)
            (y.square().sum() + (h.sum() if use_state else 0)).backward()
            grads.append([t.grad for t in leaves])
        for g, w in zip(*grads):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    # no gradient asked for: one raw launch, nothing saved
    assert ops.ssd(*ins, chunk=16).grad_fn is None


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------


def _tree():
    r = np.random.default_rng(2)
    bf = r.standard_normal((3, 5)).astype(np.float32)
    return ({"w": r.standard_normal((4, 6)).astype(np.float32),
             "e": {"bf": bf, "i": np.arange(7, dtype=np.int32)},
             "step": np.asarray(3, np.int32)}, bf)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree, bf = _tree()
    t = {"w": torch.from_numpy(tree["w"]),
         "e": {"bf": torch.from_numpy(bf).to(torch.bfloat16),
               "i": torch.from_numpy(tree["e"]["i"])},
         "step": torch.tensor(3, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 4, t, extra={"note": "port"})
    step, back, extra = jckpt.restore(str(tmp_path))
    assert step == 4 and extra == {"note": "port"}
    assert str(back["e"]["bf"].dtype) == "bfloat16"
    assert np.asarray(back["e"]["bf"]).tobytes() == \
        t["e"]["bf"].view(torch.int16).numpy().tobytes()
    assert np.asarray(back["w"]).tobytes() == tree["w"].tobytes()
    assert np.asarray(back["e"]["i"]).tobytes() == tree["e"]["i"].tobytes()
    assert np.asarray(back["step"]).shape == () and int(back["step"]) == 3


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree, bf = _tree()
    jtree = {"w": jnp.asarray(tree["w"]),
             "e": {"bf": jnp.asarray(bf, jnp.bfloat16), "i": jnp.asarray(tree["e"]["i"])},
             "step": jnp.asarray(tree["step"])}
    jckpt.save(str(tmp_path), 9, jtree, extra={"note": "ref"})
    assert ckpt.latest_step(str(tmp_path)) == 9
    step, back, extra = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 9 and extra == {"note": "ref"}
    assert back["e"]["bf"].dtype == torch.bfloat16
    assert back["e"]["bf"].view(torch.int16).numpy().tobytes() == \
        np.asarray(jtree["e"]["bf"]).tobytes()
    assert back["w"].numpy().tobytes() == tree["w"].tobytes()
    assert back["e"]["i"].dtype == torch.int32 and back["step"].shape == ()
    # and back out again, bitwise
    ckpt.save(str(tmp_path), 10, back)
    _, again, _ = ckpt.restore(str(tmp_path), device="cpu")
    assert all(torch.equal(a.view(torch.uint8) if a.dim() else a, b.view(torch.uint8)
                           if b.dim() else b)
               for a, b in zip(TO.tree_leaves(back), TO.tree_leaves(again)))


def test_latest_pointer_gc_and_refusals(tmp_path):
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, {"w": torch.zeros(2)})
    assert ckpt.latest_step(str(tmp_path)) == 4
    ckpt.gc_old(str(tmp_path), keep_last=2)
    assert {n for n in os.listdir(tmp_path) if n.startswith("step_")} == {"step_3", "step_4"}
    from repro_torch.distributed.sharding import Mesh

    # restoring onto a mesh across two devices waits for the multi-card mesh
    with pytest.raises(NotImplementedError, match="multi-card mesh"):
        ckpt.restore(str(tmp_path), mesh=Mesh(["cpu", "cpu:1"], ("data",)), device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), device="cpu")


def test_training_resume_matches_uninterrupted(tmp_path):
    """Fault-tolerance contract: crash + resume == continuous run."""
    cfg = tcfg("smollm-135m", smoke=True)
    model = TR.build_model(cfg)
    step_fn = make_train_step(model, TO.OptConfig(lr=1e-3))
    pipe = SyntheticTokenPipeline(cfg, 16, 2, seed=3)

    def run(n_steps, params, opt, start=0):
        for _, batch in zip(range(start, n_steps), pipe.iter_from(start)):
            batch = {k: torch.from_numpy(v) for k, v in batch.items()}
            params, opt, _ = step_fn(params, opt, batch)
        return params, opt

    p0 = model.init(seed=0, device="cpu")
    pc, _ = run(6, p0, TO.adamw_init(p0))
    p1, o1 = run(3, p0, TO.adamw_init(p0))
    ckpt.save(str(tmp_path), 3, {"p": p1, "o": o1})
    _, state, _ = ckpt.restore(str(tmp_path), device="cpu")
    pr, _ = run(6, state["p"], state["o"], start=3)
    for a, b in zip(TO.tree_leaves(pc), TO.tree_leaves(pr)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# fault tolerance and the launcher
# ---------------------------------------------------------------------------


def test_retry_recovers_and_exhausts():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert retry(flaky, max_attempts=3, backoff_s=0.01) == "ok"
    with pytest.raises(StepFailure):
        retry(lambda: 1 / 0, max_attempts=2, backoff_s=0.01)


def test_straggler_detection():
    d = StragglerDetector(threshold=2.0)
    for s in range(10):
        d.record(s, 0.1)
    assert d.record(10, 0.5) is True
    assert 10 in d.flagged
    assert d.median_step_s == pytest.approx(0.1)


def test_train_launcher_resumes_where_it_stopped(tmp_path, capsys):
    from repro_torch.launch import train

    args = ["--device", "cpu", "--smoke", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--log-every", "1"]
    full = train.main(args + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    assert len(full) == 4 and all(np.isfinite(full))
    assert sorted(os.listdir(tmp_path / "a")) == ["LATEST", "step_2", "step_4"]
    # a run cut after step 2: its directory holds the step-2 checkpoint
    shutil.copytree(tmp_path / "a" / "step_2", tmp_path / "b" / "step_2")
    (tmp_path / "b" / "LATEST").write_text("2")
    resumed = train.main(args + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    assert "resumed from step 2" in capsys.readouterr().out
    np.testing.assert_allclose(resumed, full[2:], rtol=1e-5)


def test_train_launcher_asks_for_the_card():
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])

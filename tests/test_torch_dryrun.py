"""The port's dry run and mesh factory against the JAX package's.

* per-device argument bytes of smollm-smoke's train and decode cells on a
  (data 2, model 4) mesh equal the sum of the reference's
  ``NamedSharding.shard_shape`` bytes over the same inputs (exact: bytes);
* the forward's FLOPs as ``FlopCounterMode`` counts them on meta tensors
  equal the reference's ``analyze_hlo(...)["dot_flops"]`` of its compiled
  forward on one device (within 1 %; observed equal);
* a cell's record keeps the reference's keys, with the fields the port has
  no source for set to null;
* the mesh factory's shapes, names and refusals;
* the port's counterparts of the reference's red
  ``TestMultiDeviceLowering::test_smoke_cell_lowers_on_8_fake_devices``
  (a smoke cell on a (2, 4) mesh: 8 devices, flops > 0) and
  ``TestShardingRules::test_sharded_train_step_runs_under_mesh`` (a train
  step under a (1, 1) mesh with the parameters placed through
  ``restore(shardings=)``, whose loss equals the reference's step on an
  Auto (1, 1) mesh with the same parameters, float32, 1e-5 relative)."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import cell_supported as jcell_supported
from repro.configs.base import get_config as jcfg
from repro.distributed import sharding as jshd
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.base import get_config as tcfg
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as TO
from repro_torch.training.train_loop import make_train_step


def _jbytes(tree, shardings):
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(shs)
    return sum(math.prod(s.shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
               for a, s in zip(leaves, shs))


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_argument_bytes_equal_the_references_shard_bytes(kind):
    jc, tc = jcfg("smollm-135m", smoke=True), tcfg("smollm-135m", smoke=True)
    jm = AbstractMesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    tm = shd.Mesh(None, ("data", "model"), (2, 4))
    shape = ShapeConfig("t", 64, 8, kind)
    step, args, _ = DR.build_step(tc, shape, tm)
    got = sum(DR.sharded_bytes(a, s) for a, s in zip(args, step.in_shardings))
    model = JR.build_model(jc)
    ps = model.param_specs()
    jshape = JShape("t", 64, 8, kind)
    if kind == "train":
        want = (_jbytes(ps, jshd.param_shardings(jm, ps))
                + _jbytes(jax.eval_shape(JO.adamw_init, ps), jshd.opt_state_shardings(jm, ps))
                + _jbytes(JR.train_batch_specs(jc, jshape),
                          jshd.batch_shardings(jm, JR.train_batch_specs(jc, jshape))))
    else:
        cache = model.cache_specs(8, 64)
        ins = JR.decode_input_specs(jc, jshape)
        want = (_jbytes(ps, jshd.param_shardings(jm, ps, fsdp=False))
                + _jbytes(cache, jshd.cache_shardings(jm, cache))
                + _jbytes(ins, jshd.batch_shardings(jm, ins)))
    assert got == want


@pytest.mark.parametrize("batch,seq", [(2, 32), (1, 128)])
def test_forward_flops_equal_the_references_dot_flops(batch, seq):
    jc, tc = jcfg("smollm-135m", smoke=True), tcfg("smollm-135m", smoke=True)
    toks = jax.ShapeDtypeStruct((batch, seq), jnp.int32)
    hlo = jax.jit(lambda p, t: JT.forward(jc, p, tokens=t)).lower(
        JT.param_specs(jc), toks).compile().as_text()
    want = analyze_hlo(hlo)["dot_flops"]
    counter = FlopCounterMode(display=False)
    with counter:
        TT.forward(tc, TT.param_specs(tc),
                   torch.zeros((batch, seq), dtype=torch.int64, device="meta"))
    assert abs(counter.get_total_flops() / want - 1) < 0.01


def test_smoke_cell_on_eight_devices():
    """The counterpart of the reference's red 8-fake-device lowering."""
    cfg = tcfg("smollm-135m", smoke=True)
    mesh = M.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    assert mesh.size == 8
    with shd.use_mesh(mesh):
        step, args, meta = DR.build_step(cfg, ShapeConfig("t", 64, 8, "train"), mesh)
        counter = FlopCounterMode(display=False)
        with counter:
            step(*args)
    assert counter.get_total_flops() > 0
    assert meta["kind"] == "train" and meta["arch"] == cfg.name


def test_cell_record_keys_and_nulls(tmp_path):
    rec = DR.run_cell("smollm-135m", "decode_32k", multi_pod=False)
    assert rec["status"] == "ok", rec.get("error")
    assert set(rec) == {"arch", "shape", "mesh", "status", "meta", "compile_s",
                        "n_devices", "memory", "cost", "collectives", "corrected",
                        "notes"}
    assert rec["n_devices"] == 256 and rec["mesh"] == "pod16x16"
    assert rec["cost"]["flops"] > 0
    assert rec["corrected"]["dot_flops"] == rec["cost"]["flops"]
    assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["output_bytes"] > 0
    assert rec["memory"]["temp_bytes"] is None and rec["memory"]["peak_bytes"] is None
    assert rec["cost"]["bytes_accessed"] is None and rec["collectives"] is None
    skipped = DR.run_cell("smollm-135m", "long_500k", multi_pod=True)
    ok, reason = jcell_supported(jcfg("smollm-135m"), SHAPES["long_500k"])
    assert skipped == {"arch": "smollm-135m", "shape": "long_500k",
                       "mesh": "pod2x16x16", "status": "skipped", "reason": reason}
    assert DR.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                    "--out", str(tmp_path)]) == 0
    with open(tmp_path / "smollm-135m__decode_32k__pod16x16.json") as f:
        assert json.load(f)["status"] == "ok"


def test_mesh_factory():
    pod = M.make_production_mesh()
    assert pod.axis_names == ("data", "model") and pod.shape == {"data": 16, "model": 16}
    assert pod.is_abstract and pod.size == 256
    multi = M.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    host = M.make_host_mesh(device="cpu")
    assert host.axis_names == ("data", "model") and host.shape == {"data": 1, "model": 1}
    six = M.make_mesh((2, 3), ("data", "model"), devices=["cpu"] * 6)
    assert six.shape == {"data": 2, "model": 3}
    assert six.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="distinct"):
        M.make_mesh((2, 3), ("data", "model"), device="cpu")
    with pytest.raises(ValueError):
        M.make_mesh((2, 3), ("data", "model"), devices=["cpu"] * 5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            M.make_host_mesh()


def test_sharded_train_step_under_a_one_by_one_mesh(tmp_path):
    """The counterpart of the reference's red sharded train step."""
    jc = dataclasses.replace(jcfg("smollm-135m", smoke=True), dtype="float32")
    tc = dataclasses.replace(tcfg("smollm-135m", smoke=True), dtype="float32")
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                JT.init_params(jc, jax.random.PRNGKey(0)))
    jm = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jbatch = JR.make_train_batch(jc, JShape("s", 16, 2, "train"))
    jmodel = JR.build_model(jc)
    with jshd.use_mesh(jm):
        fn = jax.jit(jmake_train_step(jmodel, JO.OptConfig()), in_shardings=(
            jshd.param_shardings(jm, jp), jshd.opt_state_shardings(jm, jp),
            jshd.batch_shardings(jm, jbatch)))
        _, _, jmetrics = fn(jp, JO.adamw_init(jp), jbatch)
    want = float(jmetrics["loss"])

    tm = M.make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    ckpt.save(str(tmp_path), 0, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    p_sh = shd.param_shardings(tm, TT.param_specs(tc))
    _, params, _ = ckpt.restore(str(tmp_path), mesh=tm, shardings=p_sh)
    from repro_torch.models import registry as TR

    batch = TR.make_train_batch(tc, ShapeConfig("s", 16, 2, "train"), device="cpu")
    with shd.use_mesh(tm):
        _, _, metrics = make_train_step(TR.build_model(tc), TO.OptConfig())(
            params, TO.adamw_init(params), batch)
    got = float(metrics["loss"])
    assert math.isfinite(got)
    assert abs(got - want) <= 1e-5 * abs(want)

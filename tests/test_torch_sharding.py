"""The port's sharding rules against the JAX package's.

Every spec is compared exactly (no tolerance: specs are names).  The
reference runs on ``AbstractMesh`` meshes with ``Auto`` axes: under JAX
0.9 ``jax.make_mesh`` defaults to ``Explicit`` axes, which the reference's
``with_sharding_constraint`` refuses, while its rules run unchanged on Auto
axes.  ``param_shardings``, ``opt_state_shardings``, ``cache_shardings``
and ``batch_shardings`` for all ten archs at full width on the production
meshes (16, 16) and (2, 16, 16) and on (2, 3) and (1, 1); the activation
specs and the ``shard`` policy under every ``STRATEGY`` setting (the
reference's constraint is captured where it would apply it);
``shard_workload`` on every case of ``tests/test_mesh_dispatch.py``; the
``PARAM_AXES`` table against the reference's registry; and
``shard_map``'s block order on a (pod 2, data 2, model 2) mesh against the
reference's ``shard_map`` on 8 fake CPU devices (a subprocess)."""

import itertools
import json
import os
import subprocess
import sys
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jcfg
from repro.distributed import sharding as jshd
from repro.models import registry as JR
from repro_torch.configs.base import ARCHS, SHAPES
from repro_torch.configs.base import get_config as tcfg
from repro_torch.distributed import sharding as shd
from repro_torch.models import registry as TR

MESHES = {
    "pod16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "data2_model3": ((2, 3), ("data", "model")),
    "one": ((1, 1), ("data", "model")),
}


def jmesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def tmesh(name):
    shape, axes = MESHES[name]
    return shd.Mesh(None, axes, shape)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def specs(tree):
    """path -> spec tuple of a tree of NamedShardings (either package)."""
    return {p: tuple(s.spec) for p, s in _flat(tree).items()}


@lru_cache(maxsize=None)
def jspecs(arch):
    return JR.build_model(jcfg(arch)).param_specs()


@lru_cache(maxsize=None)
def tspecs(arch):
    return TR.build_model(tcfg(arch)).param_specs()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_opt_cache_and_batch_shardings_match_reference(arch, mesh):
    jm, tm = jmesh(mesh), tmesh(mesh)
    jp, tp = jspecs(arch), tspecs(arch)
    shapes = {p: tuple(a.shape) for p, a in _flat(jp).items()}
    assert {p: tuple(a.shape) for p, a in _flat(tp).items()} == shapes
    for fsdp in (True, False):
        assert specs(shd.param_shardings(tm, tp, fsdp=fsdp)) == \
            specs(jshd.param_shardings(jm, jp, fsdp=fsdp))
    assert specs(shd.opt_state_shardings(tm, tp)) == \
        specs(jshd.opt_state_shardings(jm, jp))
    jc, tc = jcfg(arch), tcfg(arch)
    jcache = JR.build_model(jc).cache_specs(128, 4096)
    tcache = TR.build_model(tc).cache_specs(128, 4096)
    assert specs(shd.cache_shardings(tm, tcache)) == specs(jshd.cache_shardings(jm, jcache))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        js, ts = JSHAPES[name], SHAPES[name]
        for jfn, tfn in ((JR.train_batch_specs, TR.train_batch_specs),
                         (JR.prefill_input_specs, TR.prefill_input_specs),
                         (JR.decode_input_specs, TR.decode_input_specs)):
            assert specs(shd.batch_shardings(tm, tfn(tc, ts))) == \
                specs(jshd.batch_shardings(jm, jfn(jc, js))), (name, tfn.__name__)


def test_spec_for_param_example_and_shard_shape():
    """Two specs the reference gives on the production mesh, and the block
    each leaves one device."""
    tm = tmesh("pod16x16")
    sh = shd.param_shardings(tm, tspecs("smollm-135m"))
    assert tuple(sh["layers"]["attn"]["wq"].spec) == (None, "data", "model")
    assert tuple(sh["embed"].spec) == ("model", "data")
    # wq (30, 576, 576): 576 over data 16 and model 16
    assert sh["layers"]["attn"]["wq"].shard_shape((30, 576, 576)) == (30, 36, 36)
    with pytest.raises(ValueError, match="does not divide"):
        shd.NamedSharding(tm, shd.P("data")).shard_shape((9,))


STRATEGIES = list(itertools.product(
    (True, False), (True, False), (True, False, "auto", "0")))
ACT_CASES = [
    ("residual", (2, 32, 64)), ("residual", (32, 256, 576)), ("residual", (1, 9, 8)),
    ("logits", (2, 32, 49152)), ("logits", (3, 5, 7)),
    ("act_heads", (2, 9, 32, 64)), ("act_heads", (32, 16, 64, 128)),
    ("act_heads", (2, 8, 16, 64)), ("act_kv_heads", (2, 3, 32, 64)),
    ("act_kv_heads", (32, 48, 8, 96)), ("ffn", (4, 16, 1536)),
    ("experts", (64, 40, 2048)), ("experts", (6, 4, 12)),
    ("tokens", (512, 576)), ("tokens", (7, 3)), ("block_input", (32, 128, 576)),
]
HEAD_DIMS = [None, (9, 3), (16, 16), (8, 4), (48, 8), (32, 2)]


@pytest.mark.parametrize("strategy", STRATEGIES, ids=[
    f"sp{int(a)}-hd{int(b)}-attn{c}" for a, b, c in STRATEGIES])
def test_activation_specs_and_shard_policy_match_reference(strategy, monkeypatch):
    keys = ("sp_residual", "act_head_dim_fallback", "constrain_attn_acts")
    setting = dict(zip(keys, strategy))
    monkeypatch.setattr(jshd, "STRATEGY", dict(setting))
    monkeypatch.setattr(shd, "STRATEGY", dict(setting))
    applied = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: (applied.append(tuple(s.spec)), x)[1])
    for mesh in MESHES:
        jm, tm = jmesh(mesh), tmesh(mesh)
        for kind, shape in ACT_CASES:
            want = tuple(jshd.spec_for_activation(jm, kind, shape))
            assert tuple(shd.spec_for_activation(tm, kind, shape)) == want
            for dims in HEAD_DIMS:
                applied.clear()
                with jshd.use_mesh(jm):
                    jshd.shard(jnp.zeros(shape, jnp.bfloat16), kind, dims)
                got = shd.activation_constraint(tm, kind, shape, dims)
                assert (None if not applied else applied[0]) == \
                    (None if got is None else tuple(got)), (mesh, kind, shape, dims)
                x = torch.empty(shape, device="meta")
                with shd.use_mesh(tm):
                    assert shd.shard(x, kind, dims) is x  # an identity on values


def test_act_heads_policy_matrix():
    """The port's counterpart of the reference's red
    ``TestAdaptiveShardingPolicy::test_policy_matrix``: on a (1, 1) mesh
    every head count divides, so the constraint applies and keeps the
    shape; on (data 2, model 3) the "auto" policy constrains smollm's (9,
    3) heads and leaves (8, 4) alone, as the reference does on an Auto
    mesh."""
    assert shd.STRATEGY["constrain_attn_acts"] == "auto"
    x = torch.zeros((2, 8, 16, 64))
    with shd.use_mesh(tmesh("one")):
        out = shd.shard(x, "act_heads", (8, 4))
        assert out.shape == x.shape and out is x
    assert shd.activation_constraint(tmesh("one"), "act_heads", (2, 8, 16, 64),
                                     (8, 4)) == shd.P("data", "model", None, None)
    m = tmesh("data2_model3")
    assert tuple(shd.activation_constraint(m, "act_heads", (2, 9, 16, 64), (9, 3))) == \
        ("data", "model", None, None)
    assert shd.activation_constraint(m, "act_heads", (2, 8, 16, 64), (8, 4)) is None
    jm = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    with jshd.use_mesh(jm):
        jout = jshd.shard(jnp.zeros((2, 8, 16, 64)), "act_heads", (8, 4))
    assert jout.shape == (2, 8, 16, 64)


class FakeMesh:
    """shard_workload only reads .axis_names and .shape."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


WORKLOAD_CASES = [  # every case of tests/test_mesh_dispatch.py::TestShardWorkload
    ("dense", dict(m=64, n=64, k=32), dict(data=2, model=2)),
    ("dense", dict(m=64, n=64, k=32), dict(data=2)),
    ("dense", dict(m=64, n=64, k=32), dict(pod=2, data=2)),
    ("batch_matmul", dict(b=4, m=16, n=16, k=8), dict(data=2, model=2)),
    ("batch_matmul", dict(b=4, m=16, n=16, k=8), dict(data=2, model=3)),
    ("attention", dict(b=2, h=8, kvh=4, s=32, d=16), dict(data=2, model=2)),
    ("attention", dict(b=2, h=8, kvh=3, s=32, d=16), dict(data=2, model=2)),
    ("dense", dict(m=63, n=65, k=32), dict(data=2, model=2)),
    ("attention", dict(b=1, h=7, kvh=7, s=32, d=16), dict(data=2, model=2)),
    ("rmsnorm", dict(n=64, d=64), dict(data=2)),
    ("dense", dict(m=64, n=64, k=32), None),
    ("dense", dict(m=64, n=64, k=32), dict(data=1, model=1)),
    # and smollm's per-shard shapes on (data 2, model 3)
    ("dense", dict(m=512, n=49152, k=576), dict(data=2, model=3)),
    ("attention", dict(b=2, h=9, kvh=3, s=256, d=64), dict(data=2, model=3)),
    ("attention_decode", dict(b=4, h=9, kvh=3, t=256, d=64), dict(data=2, model=3)),
    ("batch_matmul", dict(b=64, m=64, n=1024, k=2048), dict(model=2)),
]


@pytest.mark.parametrize("op,kwargs,axes", WORKLOAD_CASES)
def test_shard_workload_matches_reference(op, kwargs, axes):
    mesh = None if axes is None else FakeMesh(**axes)
    want = jshd.shard_workload(op, kwargs, mesh)
    got = shd.shard_workload(op, kwargs, mesh)
    if want is None:
        assert got is None
    else:
        assert (got.kwargs, got.dim_axes) == (want.kwargs, want.dim_axes)


def test_param_axes_table_equals_reference_registry():
    from repro.models import transformer as JT
    from repro.models.layers import PARAM_AXES as JAXES
    from repro_torch.models.layers import PARAM_AXES

    for arch in ARCHS:
        JT.param_specs(jcfg(arch, smoke=True))  # registers as it inits
    assert PARAM_AXES == JAXES


def test_mesh_and_shard_map_basics():
    m = shd.Mesh([["cpu"] * 3] * 2, ("data", "model"))
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert m.distinct_devices() == [torch.device("cpu")]
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    w = torch.randn(6, 9, generator=torch.Generator().manual_seed(1))
    calls = []

    def body(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return a @ b

    f = shd.shard_map(body, m, (shd.P("data", None), shd.P(None, "model")),
                      shd.P("data", "model"))
    torch.testing.assert_close(f(x, w), x @ w, rtol=0, atol=0)
    assert calls == [((2, 6), (6, 3))] * 6
    with pytest.raises(RuntimeError, match="abstract"):
        shd.shard_map(body, tmesh("one"), (shd.P(),), shd.P())
    with pytest.raises(ValueError):
        shd.Mesh(None, ("data", "model"))
    assert shd.P(("data",), None, ("pod", "data")) == ("data", None, ("pod", "data"))


_SHARD_MAP_SCRIPT = r"""
import json, warnings
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
warnings.simplefilter("ignore")
from jax.experimental.shard_map import shard_map
assert len(jax.devices()) == 8
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
x = jnp.arange(8 * 4 * 3, dtype=jnp.float32).reshape(8, 4, 3)
out = {}
for name, ins, outs in CASES:
    f = shard_map(lambda b: b.sum(axis=(0, 1, 2), keepdims=True).reshape(1, 1),
                  mesh=mesh, in_specs=(P(*ins),), out_specs=P(*outs), check_rep=False)
    out[name] = np.asarray(f(x)).tolist()
print(json.dumps(out))
"""

SHARD_MAP_CASES = [
    ("pod_data_rows", [["pod", "data"], "model", None], ["model", ["data", "pod"]]),
    ("data_pod_rows", [["data", "pod"], None, None], [["pod", "data"], None]),
    ("model_pod_rows", [["model", "pod"], "data", None], ["data", ["model", "pod"]]),
    ("missing_axes", ["data", None, None], ["data", None]),
]


def test_shard_map_block_order_matches_reference():
    """Each block's sum, written where ``out_specs`` puts that coordinate,
    shows which block each coordinate received: composite axes split
    row-major, and an axis missing from ``out_specs`` keeps coordinate 0."""
    code = "CASES = " + repr(SHARD_MAP_CASES) + "\n" + _SHARD_MAP_SCRIPT
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    m = shd.Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 2, 2),
                 ("pod", "data", "model"))
    x = torch.arange(8 * 4 * 3, dtype=torch.float32).reshape(8, 4, 3)
    for name, ins, outs in SHARD_MAP_CASES:
        f = shd.shard_map(lambda b: b.sum().reshape(1, 1), m, (shd.P(*ins),), shd.P(*outs))
        assert f(x).tolist() == want[name], name

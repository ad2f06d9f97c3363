"""The attention servability guard on dispatch's global path.

A structurally lowered (not fused) attention kernel materializes the (b,
h, s, s) f32 score buffer; the reference serves such a record only while
that buffer stays within ``MAX_STRUCTURAL_ATTN_SCORE_BYTES`` (256 MiB) and
otherwise counts a miss with reason ``unservable``.  At b 1, h 16 the cap
is exactly s 2048, so s 2049 is the smallest crossing sequence: the port
must miss there as the reference does (stats and per-key notes equal),
never calling the kernel, and neither backend (the port's ``torch``, the
reference's ``jnp``) has a fused fallback.  The fused K3 lowering is
always servable."""

import jax.numpy as jnp
import torch

from repro.integration.dispatch import DispatchContext as JDispatch
from repro.search.database import Database as JDatabase
from repro.search.database import TuningRecord as JRecord
from repro_torch.core.modules import SpaceGenerator, default_modules
from repro_torch.core.validator import validate_trace
from repro_torch.core.workloads import get_workload
from repro_torch.integration import dispatch as D
from repro_torch.search.database import Database, TuningRecord, workload_key

S_OVER = 2049  # 4 * 1 * 16 * 2049**2 bytes > 256 MiB = 4 * 1 * 16 * 2048**2


def valid_trace(op, kw):
    func = get_workload(op, **kw)
    gen = SpaceGenerator(default_modules(use_mxu=False))
    for seed in range(32):
        tr = gen.generate(func, seed=seed).trace
        if validate_trace(func, tr).ok:
            return tr.to_json()
    raise AssertionError(f"no valid schedule for {op} {kw}")


def test_structural_attention_over_the_cap_is_unservable(monkeypatch):
    kw = dict(b=1, h=16, kvh=16, s=S_OVER, d=8, causal=1, window=0, softcap=0.0)
    key = workload_key("attention", **kw)
    trace = valid_trace("attention", kw)
    db = Database()
    db.put(TuningRecord(key, trace, 1e-6))
    ctx = D.DispatchContext(db, backend="torch")
    kern = ctx.kernel(key)
    assert kern is not None

    def never(_):
        raise AssertionError("a structurally lowered attention over the cap was served")

    monkeypatch.setattr(kern, "fn", never)
    q = torch.zeros((1, 16, S_OVER, 8))
    assert ctx.attention(q, q, q, causal=True) is None

    jdb = JDatabase()
    jdb.put(JRecord(key, trace, 1e-6))
    jctx = JDispatch(jdb, backend="jnp")
    z = jnp.zeros((1, 16, S_OVER, 8), jnp.float32)
    assert jctx.attention(z, z, z, causal=True) is None
    assert ctx.stats == jctx.stats
    assert ctx.stats_by_key() == jctx.stats_by_key()
    assert ctx.stats_by_key()[key]["reasons"] == {"unservable": 1}
    assert ctx.stats_by_key()["site:attention"]["reasons"] == {"no_fused_backend": 1}

    assert 4 * 1 * 16 * 2048 ** 2 == D.MAX_STRUCTURAL_ATTN_SCORE_BYTES
    assert not D._attention_kern_servable(kern, 1, 16, S_OVER)
    assert D._attention_kern_servable(kern, 1, 16, 2048)
    fused = D.CompiledKernel(key, None, None, "Y", "database",
                             meta={"pallas_kernel": "flash_attention"})
    assert D._attention_kern_servable(fused, 1, 16, S_OVER)

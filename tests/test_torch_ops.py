"""The port's ``kernels/ops.py`` against the JAX package's, on the CPU.

The tuned-tile lookup reads a ``Database`` under the reference's workload
key; the three ops on CPU tensors run their plain versions and equal the
reference's ``backend="jnp"`` on the same numpy inputs within 1e-5
(float32, sums in another order); ``backend="torch"`` is the plain version
everywhere.
"""

import numpy as np
import pytest
import torch

from repro.kernels import matmul as jmm
from repro.kernels import ops as jops
from repro.search.database import Database as JDatabase
from repro.search.database import TuningRecord as JRecord
from repro.search.database import workload_key as jkey
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd as tssd
from repro_torch.search.database import Database, TuningRecord, workload_key

TOL = 1e-5


@pytest.fixture
def restore_db():
    saved_t, saved_j = tops._DB, jops._DB
    yield
    tops.set_database(saved_t)
    jops.set_database(saved_j)


def _record(key, blocks, latency=1e-4):
    meta = {"blocks": list(blocks)} if blocks is not None else {}
    return TuningRecord(key, "{}", latency, meta=meta)


def test_tuned_matmul_blocks_reads_the_best_dense_record(restore_db):
    db = Database()
    key = workload_key("dense", k=576, m=256, n=1536)
    db.put(_record(key, (64, 96, 48), latency=2e-4))
    db.put(TuningRecord(key, '{"other": 1}', 1e-4, meta={"blocks": [32, 192, 64]}))
    tops.set_database(db)
    assert tops.tuned_matmul_blocks(256, 1536, 576) == (32, 192, 64)
    # the reference gives the same blocks from the same record
    jdb = JDatabase()
    jdb.put(JRecord(key, "{}", 1e-4, meta={"blocks": [32, 192, 64]}))
    jops.set_database(jdb)
    assert jops.tuned_matmul_blocks(256, 1536, 576) == (32, 192, 64)


@pytest.mark.parametrize("setup", ["no_database", "no_record", "no_blocks"])
def test_tuned_matmul_blocks_defaults_without_a_tuned_record(restore_db, setup,
                                                              monkeypatch):
    db = None if setup == "no_database" else Database()
    if setup == "no_blocks":
        db.put(_record(workload_key("dense", k=64, m=32, n=48), None))
    tops.set_database(db)
    monkeypatch.setattr(tops, "_DB_PATH", "")
    assert tops.tuned_matmul_blocks(32, 48, 64) == tmm.DEFAULT_BLOCKS
    assert tmm.DEFAULT_BLOCKS == jmm.DEFAULT_BLOCKS


def test_tuned_matmul_blocks_reads_the_database_file_it_is_given(restore_db, tmp_path,
                                                                 monkeypatch):
    path = str(tmp_path / "db.json")
    db = Database(path)
    db.put(_record(workload_key("dense", k=8, m=16, n=24), (16, 8, 8)))
    tops.set_database(None)
    monkeypatch.setattr(tops, "_DB_PATH", path)
    assert tops.tuned_matmul_blocks(16, 24, 8) == (16, 8, 8)


@pytest.mark.parametrize("m,n,k", [(256, 1536, 576), (4, 50280, 1024), (1, 1, 1)])
def test_the_lookup_key_is_the_references(m, n, k):
    assert workload_key("dense", k=k, m=m, n=n) == jkey("dense", k=k, m=m, n=n)
    assert workload_key("dense", m=m, n=n, k=k).encode() == \
        jkey("dense", k=k, m=m, n=n).encode()


def _rand(*shape, seed=0, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


@pytest.mark.parametrize("epilogue", ["none", "relu", "gelu", "silu", "softcap"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_matmul_on_the_cpu_equals_the_reference(epilogue, backend):
    x, w, b = _rand(48, 40, seed=1), _rand(40, 24, seed=2), _rand(24, seed=3)
    want = np.asarray(jops.matmul(x, w, b, epilogue=epilogue, backend="jnp"))
    got = tops.matmul(*(torch.from_numpy(a) for a in (x, w, b)), epilogue=epilogue,
                      backend=backend)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=8),
                                dict(causal=False, softcap=20.0)])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_attention_on_the_cpu_equals_the_reference(kw, backend):
    q, k, v = _rand(1, 4, 32, 16, seed=4), _rand(1, 2, 32, 16, seed=5), \
        _rand(1, 2, 32, 16, seed=6)
    want = np.asarray(jops.attention(q, k, v, backend="jnp", **kw))
    got = tops.attention(*(torch.from_numpy(a) for a in (q, k, v)), backend=backend,
                         block_q=16, block_kv=8, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S,chunk", [(128, 64), (48, 64), (96, 32)])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_ssd_on_the_cpu_equals_the_reference(S, chunk, backend):
    x = _rand(2, S, 4, 16, seed=7)
    la = -np.abs(_rand(2, S, 4, seed=8)) * 0.3
    B, C = _rand(2, S, 8, seed=9, scale=0.3), _rand(2, S, 8, seed=10, scale=0.3)
    want = np.asarray(jops.ssd(x, la, B, C, chunk=chunk, backend="jnp"))
    n = tssd.ssd.launches
    got = tops.ssd(*(torch.from_numpy(a) for a in (x, la, B, C)), chunk=chunk,
                   backend=backend)
    assert tssd.ssd.launches == n  # CPU tensors launch nothing
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    y, h = tops.ssd(*(torch.from_numpy(a) for a in (x, la, B, C)), chunk=chunk,
                    backend=backend, return_state=True)
    assert torch.equal(y, got) and tuple(h.shape) == (2, 4, 8, 16)


def test_an_unknown_backend_raises():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="backend"):
        tops.matmul(x, x, backend="pallas")

"""Gradient-boosted regression trees (pure numpy) — the learned cost model.

The paper uses a tree-boosting cost model updated online from measured
latencies (§4 "Cost model").  XGBoost is not available offline, so this is a
compact exact-greedy GBDT: squared-error boosting of depth-limited trees.
Targets are per-task normalized throughput scores (best measured latency /
latency ∈ (0, 1]), so the model ranks candidates; ranking is all the search
consumes.

Transfer across tasks and runs ("Learning to Optimize Tensor Programs"
setup): the model pools training samples *per task key* over the
shape-generic features of :mod:`repro_torch.search.features`, so one instance
shared by a :class:`~repro_torch.search.task_scheduler.TaskScheduler` learns from
every task at once, and :meth:`GBDTCostModel.save` /
:meth:`GBDTCostModel.load` persist the fitted trees plus the sample pools
alongside the tuning database (see ``docs/db_format.md`` for the on-disk
schema).  A loaded model predicts immediately — the warm-start signal the
``costmodel.round`` telemetry surfaces as rank correlation arriving in
earlier rounds.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import emit, metrics, trace_enabled

#: Version stamp written into persisted cost-model files; bump when the
#: JSON schema documented in docs/db_format.md changes incompatibly.
COST_MODEL_FORMAT_VERSION = 1


@dataclass
class _TreeNode:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0
    is_leaf: bool = True


class RegressionTree:
    """A depth-limited exact-greedy regression tree (one boosting stage)."""

    def __init__(self, max_depth: int = 4, min_samples: int = 4):
        self.max_depth = max_depth
        self.min_samples = min_samples
        self.nodes: List[_TreeNode] = []

    def fit(self, X: np.ndarray, y: np.ndarray):
        """Fit the tree to ``(X, y)`` and return ``self``."""
        self.nodes = []
        self._build(X, y, 0)
        return self

    def _build(self, X, y, depth) -> int:
        idx = len(self.nodes)
        node = _TreeNode(value=float(y.mean()) if len(y) else 0.0)
        self.nodes.append(node)
        if depth >= self.max_depth or len(y) < self.min_samples or np.allclose(y, y[0]):
            return idx
        best = self._best_split(X, y)
        if best is None:
            return idx
        f, t, gain = best
        mask = X[:, f] <= t
        node.feature, node.threshold, node.is_leaf = f, t, False
        node.left = self._build(X[mask], y[mask], depth + 1)
        node.right = self._build(X[~mask], y[~mask], depth + 1)
        return idx

    def _best_split(self, X, y):
        n, d = X.shape
        base = ((y - y.mean()) ** 2).sum()
        best = None
        best_gain = 1e-8
        for f in range(d):
            vals = X[:, f]
            order = np.argsort(vals, kind="stable")
            xs, ys = vals[order], y[order]
            # candidate thresholds at value changes
            csum = np.cumsum(ys)
            csq = np.cumsum(ys**2)
            total, total_sq = csum[-1], csq[-1]
            for i in range(self.min_samples - 1, n - self.min_samples):
                if xs[i] == xs[i + 1]:
                    continue
                nl = i + 1
                nr = n - nl
                sl, sql = csum[i], csq[i]
                sr, sqr = total - sl, total_sq - sql
                ssl = sql - sl * sl / nl
                ssr = sqr - sr * sr / nr
                gain = base - (ssl + ssr)
                if gain > best_gain:
                    best_gain = gain
                    best = (f, float((xs[i] + xs[i + 1]) / 2), gain)
        return best

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Predict one value per row of ``X``."""
        out = np.empty(len(X), dtype=np.float64)
        for r in range(len(X)):
            i = 0
            while not self.nodes[i].is_leaf:
                nd = self.nodes[i]
                i = nd.left if X[r, nd.feature] <= nd.threshold else nd.right
            out[r] = self.nodes[i].value
        return out

    def to_dict(self) -> Dict:
        """Serialize the fitted node list (documented in docs/db_format.md)."""
        return {
            "nodes": [
                [n.feature, n.threshold, n.left, n.right, n.value, int(n.is_leaf)]
                for n in self.nodes
            ]
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "RegressionTree":
        """Inverse of :meth:`to_dict`."""
        t = cls()
        t.nodes = [
            _TreeNode(int(f), float(th), int(l), int(r), float(v), bool(leaf))
            for f, th, l, r, v, leaf in d["nodes"]
        ]
        return t


class GBDTCostModel:
    """Squared-error gradient boosting over per-task sample pools.

    ``set_task_data`` replaces one task's pool and refits on the union of
    every pool (dataset sizes here are hundreds of rows — exact refit is
    cheap), which is what lets a single instance transfer across the tasks
    of a :class:`~repro_torch.search.task_scheduler.TaskScheduler` session.
    ``save``/``load`` persist both the fitted trees and the pools, so a
    later run predicts immediately and keeps accumulating.
    """

    def __init__(
        self,
        n_trees: int = 50,
        learning_rate: float = 0.15,
        max_depth: int = 4,
        seed: int = 0,
    ):
        self.n_trees = n_trees
        self.lr = learning_rate
        self.max_depth = max_depth
        self.trees: List[RegressionTree] = []
        self.base = 0.0
        # task key -> (X, y) sample pool; refits pool the union in sorted
        # key order so fitting is deterministic regardless of tuning order
        self._data: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    @property
    def trained(self) -> bool:
        """Whether the model has fitted trees (predictions are informative)."""
        return bool(self.trees)

    @property
    def n_samples(self) -> int:
        """Total training samples pooled across all task keys."""
        return sum(len(y) for _, y in self._data.values())

    def tasks(self) -> List[str]:
        """Task keys that have contributed samples to the pool."""
        return sorted(self._data)

    # -- training -----------------------------------------------------------

    def _pooled(self) -> Tuple[np.ndarray, np.ndarray]:
        xs, ys = [], []
        for k in sorted(self._data):
            X, y = self._data[k]
            xs.append(X)
            ys.append(y)
        return np.concatenate(xs), np.concatenate(ys)

    def set_task_data(self, task: str, X: np.ndarray, y: np.ndarray) -> None:
        """Replace ``task``'s sample pool and refit on the union of pools.

        ``X`` are shape-generic feature rows (:func:`extract_features`),
        ``y`` per-task normalized throughput scores in ``(0, 1]``.
        """
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float64)
        if len(X):
            self._data[task] = (X, y)
        elif task in self._data:
            del self._data[task]
        if not self._data:
            return
        t0 = time.perf_counter()
        Xp, yp = self._pooled()
        self._fit(Xp, yp)
        dt = time.perf_counter() - t0
        metrics().observe("costmodel.fit_s", dt)
        if trace_enabled():
            emit(
                "costmodel.update",
                task=task,
                n_samples=len(yp),
                n_tasks=len(self._data),
                n_trees=len(self.trees),
                dur_s=dt,
            )

    def update(self, X: np.ndarray, y: np.ndarray) -> None:
        """Append samples under an anonymous task key and refit.

        Back-compat single-task entry point; multi-task callers should use
        :meth:`set_task_data` with their workload key.
        """
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float64)
        if "__default__" in self._data:
            X0, y0 = self._data["__default__"]
            X, y = np.concatenate([X0, X]), np.concatenate([y0, y])
        self.set_task_data("__default__", X, y)

    def _fit(self, X, y):
        self.trees = []
        self.base = float(y.mean())
        pred = np.full(len(y), self.base)
        for _ in range(self.n_trees):
            resid = y - pred
            if np.abs(resid).max() < 1e-9:
                break
            t = RegressionTree(max_depth=self.max_depth).fit(X, resid)
            pred = pred + self.lr * t.predict(X)
            self.trees.append(t)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Predicted normalized-throughput score per row (0 when untrained)."""
        X = np.asarray(X, dtype=np.float32)
        if not self.trees:
            return np.zeros(len(X))
        out = np.full(len(X), self.base)
        for t in self.trees:
            out = out + self.lr * t.predict(X)
        return out

    # -- persistence ----------------------------------------------------------

    def to_json(self) -> str:
        """Serialize trees + sample pools (schema: docs/db_format.md)."""
        return json.dumps(
            {
                "version": COST_MODEL_FORMAT_VERSION,
                "params": {
                    "n_trees": self.n_trees,
                    "learning_rate": self.lr,
                    "max_depth": self.max_depth,
                },
                "base": self.base,
                "trees": [t.to_dict() for t in self.trees],
                "tasks": {
                    k: {
                        "X": np.asarray(X, dtype=np.float64).tolist(),
                        "y": np.asarray(y, dtype=np.float64).tolist(),
                    }
                    for k, (X, y) in self._data.items()
                },
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "GBDTCostModel":
        """Inverse of :meth:`to_json`; raises ``ValueError`` on a version
        newer than this code understands.
        """
        d = json.loads(s)
        version = int(d.get("version", 1))
        if version > COST_MODEL_FORMAT_VERSION:
            raise ValueError(
                f"cost-model format version {version} > supported "
                f"{COST_MODEL_FORMAT_VERSION}"
            )
        p = d.get("params", {})
        m = cls(
            n_trees=int(p.get("n_trees", 50)),
            learning_rate=float(p.get("learning_rate", 0.15)),
            max_depth=int(p.get("max_depth", 4)),
        )
        m.base = float(d.get("base", 0.0))
        m.trees = [RegressionTree.from_dict(t) for t in d.get("trees", [])]
        for k, pool in d.get("tasks", {}).items():
            X = np.asarray(pool["X"], dtype=np.float32)
            y = np.asarray(pool["y"], dtype=np.float64)
            if len(X):
                m._data[k] = (X, y)
        return m

    def save(self, path: str) -> None:
        """Atomically write the model JSON to ``path``."""
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(self.to_json())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @classmethod
    def load(cls, path: str) -> "GBDTCostModel":
        """Load a model persisted by :meth:`save`."""
        with open(path) as f:
            return cls.from_json(f.read())


#: Public alias — the name used throughout the docs for the cost model.
GBDTModel = GBDTCostModel

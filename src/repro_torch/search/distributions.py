"""Learned per-decision sampling distributions over schedule choices.

The paper's central claim is that stochastic schedule decisions form a
probabilistic program whose sampling distributions can be *learned* rather
than left uniform.  This module is that learning: each decision site kind —
perfect-tile factorizations, categorical annotation choices, compute-at
locations — gets a small distribution object with ``fit`` / ``sample`` /
``log_prob``, estimated from measured tuning records weighted by their
normalized throughput.  :class:`DecisionDistributions` is the registry the
evolutionary search consults when drawing fresh candidates (replacing the
uniform prior for a learned slice of the population) and refits after every
measured round.

Sites are keyed *shape-generically* so knowledge transfers across tasks and
runs: a tile split is keyed by ``(extent, n_parts, max_innermost)`` — any
loop of extent 64 split 4-ways shares one distribution regardless of which
workload it came from — and a categorical by its candidate tuple.  The
registry persists to JSON next to the tuning database
(``<db>.dists.json``, schema in ``docs/db_format.md``) and is warm-started
from database records via :meth:`DecisionDistributions.observe_database`.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core.trace import Instruction, Trace

#: Version stamp for persisted distribution files; bump when the JSON
#: schema documented in docs/db_format.md changes incompatibly.
DIST_FORMAT_VERSION = 1

#: Exponent sharpening observation weights: weight = (best/latency) ** GAMMA,
#: so near-best schedules dominate the learned distribution while slow ones
#: still contribute a little exploration mass.
QUALITY_GAMMA = 4.0


def decision_site_key(inst: Instruction) -> Optional[str]:
    """Shape-generic distribution key for one sampling instruction.

    Returns ``None`` for instructions that are not sampling decisions.
    Tile splits key on ``(extent, n, max_innermost)`` — the extent is
    recovered from the recorded decision, so no loop context is needed;
    categoricals key on their candidate tuple; compute locations pool into
    one site per decision kind (their support is state-dependent, so the
    learned part is the global inline/root/loop-depth preference).
    """
    if inst.name == "sample_perfect_tile":
        if not inst.decision:
            return None
        extent = int(np.prod(inst.decision))
        n = inst.attrs.get("n", len(inst.decision))
        maxin = inst.attrs.get("max_innermost_factor", 16)
        return f"tile/extent={extent}/n={n}/max={maxin}"
    if inst.name == "sample_categorical":
        cands = ",".join(str(c) for c in inst.attrs.get("candidates", []))
        return f"cat/candidates={cands}"
    if inst.name == "sample_compute_location":
        return "loc"
    return None


def _enc(decision: Any) -> str:
    """Canonical JSON-string encoding of a decision (dict key safe)."""
    return json.dumps(decision, separators=(",", ":"))


class LearnedCategorical:
    """Dirichlet-smoothed categorical over the observed decisions of one site.

    ``support`` may be closed (``sample_categorical`` enumerates its
    candidates, so every option carries smoothing mass) or open (tile
    factorizations / compute locations — only observed decisions are
    representable, and ``explore`` probability mass is reserved for the
    uniform prior, in which case :meth:`sample` returns ``None`` and the
    caller keeps its prior draw).
    """

    def __init__(
        self,
        kind: str,
        support: Optional[List[Any]] = None,
        alpha: float = 0.25,
        explore: float = 0.15,
    ):
        self.kind = kind
        self.support = list(support) if support is not None else None
        self.alpha = float(alpha)
        self.explore = float(explore) if support is None else 0.0
        self._counts: Dict[str, float] = {}
        self._values: Dict[str, Any] = {}
        if self.support is not None:
            for v in self.support:
                self._counts.setdefault(_enc(v), 0.0)
                self._values[_enc(v)] = v
        # fitted state (lists aligned by index)
        self._keys: List[str] = []
        self._probs: Optional[np.ndarray] = None

    @property
    def n_observations(self) -> float:
        """Total observation weight accumulated so far."""
        return float(sum(self._counts.values()))

    def observe(self, decision: Any, weight: float = 1.0) -> None:
        """Accumulate ``weight`` pseudo-counts for ``decision``."""
        k = _enc(decision)
        self._counts[k] = self._counts.get(k, 0.0) + float(weight)
        self._values[k] = decision
        self._probs = None

    def fit(self) -> "LearnedCategorical":
        """Normalize accumulated counts (+ smoothing) into probabilities."""
        self._keys = sorted(self._counts)
        w = np.array([self._counts[k] + self.alpha for k in self._keys])
        self._probs = w / w.sum() if w.sum() > 0 else None
        return self

    def _ensure_fit(self):
        if self._probs is None and self._counts:
            self.fit()

    def sample(self, rng: np.random.Generator) -> Optional[Any]:
        """Draw a decision; ``None`` means "fall back to the prior".

        Open-support sites return ``None`` with probability ``explore`` (and
        always, when nothing has been observed yet).
        """
        self._ensure_fit()
        if self._probs is None or not len(self._keys):
            return None
        if self.explore > 0 and rng.random() < self.explore:
            return None
        idx = int(rng.choice(len(self._keys), p=self._probs))
        return self._values[self._keys[idx]]

    def log_prob(self, decision: Any) -> float:
        """Log-probability of ``decision`` under the fitted mixture.

        Open-support sites fold the ``explore`` mass into a floor for
        unseen decisions, so the result is always finite.
        """
        self._ensure_fit()
        floor = max(self.explore, 1e-6) / (len(self._keys) + 1 or 1)
        if self._probs is None:
            return math.log(floor)
        k = _enc(decision)
        try:
            i = self._keys.index(k)
        except ValueError:
            return math.log(floor)
        p = (1.0 - self.explore) * float(self._probs[i])
        return math.log(max(p, floor))

    def top(self, k: int = 3) -> List[Tuple[Any, float]]:
        """The ``k`` highest-probability decisions, as (decision, prob)."""
        self._ensure_fit()
        if self._probs is None:
            return []
        order = np.argsort(-self._probs)[:k]
        return [
            (self._values[self._keys[i]], float(self._probs[i])) for i in order
        ]

    def to_dict(self) -> Dict:
        """Serialize counts + params (schema: docs/db_format.md)."""
        return {
            "kind": self.kind,
            "support": self.support,
            "alpha": self.alpha,
            "explore": self.explore,
            "counts": {k: self._counts[k] for k in sorted(self._counts)},
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "LearnedCategorical":
        """Inverse of :meth:`to_dict`."""
        obj = cls(
            d.get("kind", "?"),
            support=d.get("support"),
            alpha=d.get("alpha", 0.25),
            explore=d.get("explore", 0.15),
        )
        obj.explore = float(d.get("explore", obj.explore))
        for k, w in d.get("counts", {}).items():
            obj._counts[k] = float(w)
            obj._values[k] = json.loads(k)
        return obj


class DecisionDistributions:
    """Registry of learned distributions, one per decision site key.

    The evolutionary search calls :meth:`observe_trace` with each measured
    candidate (weighted by normalized throughput), :meth:`fit` once per
    round, and :meth:`decisions_for` when sampling fresh candidates — the
    returned overrides replace the uniform prior's decisions wherever a
    site has learned anything.  ``save``/``load`` persist the registry next
    to the tuning database for cross-run warm starts.
    """

    def __init__(self, alpha: float = 0.25, explore: float = 0.15):
        self.alpha = alpha
        self.explore = explore
        self.dists: Dict[str, LearnedCategorical] = {}
        self.observations = 0

    def __len__(self):
        return len(self.dists)

    def __bool__(self):
        # an empty registry is still a real (shared) registry — never let
        # `dists or Default()` silently replace it
        return True

    @property
    def fitted(self) -> bool:
        """Whether any site has accumulated observations."""
        return self.observations > 0

    def _site(self, key: str, inst: Instruction) -> LearnedCategorical:
        if key not in self.dists:
            support = None
            if inst.name == "sample_categorical":
                support = list(range(len(inst.attrs.get("candidates", []))))
            self.dists[key] = LearnedCategorical(
                kind=key.split("/", 1)[0],
                support=support,
                alpha=self.alpha,
                explore=self.explore,
            )
        return self.dists[key]

    # -- learning -----------------------------------------------------------

    def observe_trace(self, trace: Trace, weight: float = 1.0) -> None:
        """Accumulate one trace's sampling decisions with ``weight``."""
        for inst in trace.insts:
            if not inst.is_sampling or inst.decision is None:
                continue
            key = decision_site_key(inst)
            if key is None:
                continue
            self._site(key, inst).observe(inst.decision, weight)
        self.observations += 1

    def observe_database(self, db, keys: Optional[Iterable[str]] = None) -> int:
        """Warm-start from tuning records (all keys, or a subset).

        Records are weighted by normalized throughput relative to the best
        record under the *same* workload key, sharpened by
        ``QUALITY_GAMMA`` — so cross-task pooling never lets a slow task's
        records outweigh a fast one's.  Returns the number of records
        observed (unparseable traces are skipped).
        """
        n = 0
        for key in keys if keys is not None else db.keys():
            rows = db.records.get(key, [])
            if not rows:
                continue
            best = min(r.latency_s for r in rows)
            for r in rows:
                try:
                    t = r.trace()
                except Exception:
                    continue
                w = (best / r.latency_s) ** QUALITY_GAMMA if r.latency_s else 1.0
                self.observe_trace(t, w)
                n += 1
        return n

    def fit(self) -> "DecisionDistributions":
        """Refit every site distribution from its accumulated counts."""
        for d in self.dists.values():
            d.fit()
        return self

    # -- sampling -----------------------------------------------------------

    def decisions_for(
        self, trace: Trace, rng: np.random.Generator
    ) -> Dict[int, Any]:
        """Learned decision overrides for ``trace``'s sampling instructions.

        Returns ``{instruction index: decision}`` for every site where the
        learned distribution produced a draw; indices it skips keep the
        trace's prior decision.  The caller replays the overridden trace
        through the validator, which rejects out-of-support combinations.
        """
        out: Dict[int, Any] = {}
        for i, inst in enumerate(trace.insts):
            if not inst.is_sampling:
                continue
            key = decision_site_key(inst)
            if key is None or key not in self.dists:
                continue
            dec = self.dists[key].sample(rng)
            if dec is not None and dec != inst.decision:
                out[i] = dec
        return out

    def log_prob(self, trace: Trace) -> float:
        """Sum of site log-probabilities over the trace's decisions.

        Sites without a learned distribution contribute nothing — the value
        compares candidates drawn from the *same* space, which is all the
        search needs.
        """
        total = 0.0
        for inst in trace.insts:
            if not inst.is_sampling or inst.decision is None:
                continue
            key = decision_site_key(inst)
            if key is None or key not in self.dists:
                continue
            total += self.dists[key].log_prob(inst.decision)
        return total

    # -- persistence ----------------------------------------------------------

    def to_json(self) -> str:
        """Serialize the registry (schema: docs/db_format.md)."""
        return json.dumps(
            {
                "version": DIST_FORMAT_VERSION,
                "alpha": self.alpha,
                "explore": self.explore,
                "observations": self.observations,
                "sites": {k: d.to_dict() for k, d in sorted(self.dists.items())},
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "DecisionDistributions":
        """Inverse of :meth:`to_json`; raises ``ValueError`` on a version
        newer than this code understands.
        """
        d = json.loads(s)
        version = int(d.get("version", 1))
        if version > DIST_FORMAT_VERSION:
            raise ValueError(
                f"distribution format version {version} > supported "
                f"{DIST_FORMAT_VERSION}"
            )
        obj = cls(alpha=d.get("alpha", 0.25), explore=d.get("explore", 0.15))
        obj.observations = int(d.get("observations", 0))
        for k, dd in d.get("sites", {}).items():
            obj.dists[k] = LearnedCategorical.from_dict(dd)
        return obj

    def save(self, path: str) -> None:
        """Atomically write the registry JSON to ``path``."""
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
    def load(cls, path: str) -> "DecisionDistributions":
        """Load a registry persisted by :meth:`save`."""
        with open(path) as f:
            return cls.from_json(f.read())

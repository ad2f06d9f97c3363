"""Learning-driven evolutionary search (paper §4, Figure 7).

MAP inference over P(τ|e0) ∝ exp(−f(g(e0, τ))) · P(τ):

* the prior P(τ) is the space generator (module composition) — initial
  population = samples from it;
* proposals mutate sampling decisions of traces (parallel-chain MCMC view);
* the validator rejects proposals outside the support;
* annealed Metropolis–Hastings accepts/rejects using the *learned* cost
  model f̂ (temperature decays across generations);
* an ε-greedy slice of each round is measured on hardware (here: the CPU
  jnp lowering), the database is updated, and f̂ is retrained online.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.modules import SpaceGenerator
from ..core.mutators import mutate
from ..core.schedule import Schedule
from ..core.tir import PrimFunc
from ..core.trace import Trace
from ..core.validator import validate_trace
from ..obs import ConsoleSink, emit, metrics, span, spearman, trace_enabled
from .cost_model import GBDTCostModel
from .database import Database, TuningRecord
from .distributions import QUALITY_GAMMA, DecisionDistributions
from .features import extract_features
from .measure import MeasureInput, as_runner, structural_hash


@dataclass
class SearchConfig:
    """Knobs of the learning-driven evolutionary search (paper §4)."""

    max_trials: int = 64            # total hardware measurements
    population: int = 24            # candidates per round
    init_random: int = 16           # initial random samples from the space
    generations: int = 4            # MH evolution generations per round
    measure_per_round: int = 8      # ε-greedy measured slice
    epsilon: float = 0.2            # fraction of measured picks taken randomly
    temp_init: float = 0.3          # annealing temperature (score units)
    temp_decay: float = 0.7
    seed: int = 0
    # learned sampling: fraction of fresh samples whose decisions are drawn
    # from the fitted per-site distributions instead of the uniform prior
    learned_sampling: bool = True
    learned_frac: float = 0.5
    # cost-model-only rollout pruning: once the model is trained, each round
    # samples rollout_factor x the population, scores all of them with the
    # model alone, and only the top `population` survive to evolution and
    # the measured slice ("Toward Compiler World Models")
    rollout_factor: int = 4


@dataclass
class Candidate:
    """One schedule candidate: trace + features + model-predicted score."""

    trace: Trace
    schedule: Schedule
    features: np.ndarray
    score: float = 0.0  # model-predicted normalized throughput


class EvolutionarySearch:
    """Learning-driven evolutionary search over one task's trace space.

    Each round: sample a candidate pool (a learned slice of it through the
    fitted per-decision distributions), prune it with cost-model-only
    rollouts, evolve the survivors with annealed MH, measure the ε-greedy
    top slice, then retrain the cost model and refit the distributions on
    the new measurements.  ``cost_model`` and ``distributions`` may be
    shared across sibling searches (cross-task transfer) and persisted
    across runs (warm start) — see :func:`repro_torch.search.tune.tune_workload`
    and :class:`repro_torch.search.task_scheduler.TaskScheduler`.
    """

    def __init__(
        self,
        func: PrimFunc,
        space: SpaceGenerator,
        runner=None,  # Runner | registry spec str | None
        database: Optional[Database] = None,
        workload_key: str = "",
        config: Optional[SearchConfig] = None,
        cost_model: Optional[GBDTCostModel] = None,
        distributions: Optional[DecisionDistributions] = None,
        verbose: bool = False,
    ):
        self.func = func
        self.space = space
        self.runner = as_runner(runner)
        self.db = database
        self.key = workload_key or func.name
        self.cfg = config or SearchConfig()
        self.model = (
            cost_model if cost_model is not None else GBDTCostModel(seed=self.cfg.seed)
        )
        owns_dists = distributions is None
        self.dists = (
            distributions if distributions is not None else DecisionDistributions()
        )
        # when this search owns its distributions, warm-start them from the
        # database's records for this task (a shared registry is seeded by
        # its owner — TaskScheduler / tune_workload — across all keys)
        if owns_dists and self.db is not None and self.db.records.get(self.key):
            self.dists.observe_database(self.db, keys=[self.key])
            self.dists.fit()
        self.rng = np.random.default_rng(self.cfg.seed)
        self.verbose = verbose
        # verbose=True is a console-sink alias: the same events the tracer
        # records go to stdout as compact lines (the old print() paths)
        self._console = ConsoleSink() if verbose else None
        # measured state
        self.measured: Dict[str, float] = {}  # structural hash -> latency
        self.best_latency = float("inf")
        self.best_trace: Optional[Trace] = None
        self.history: List[Tuple[int, float]] = []  # (trial, best so far)
        self.failure_counts: List[int] = []  # failed measurements per round
        self.errors: List[Tuple[str, str]] = []  # (structural hash, error)
        # per-round predicted-vs-measured record: the cost model's rank
        # correlation is a first-class recorded metric, not a debug print
        self.round_correlations: List[Dict] = []
        # per-round rollout-pruning record: (pool scored, kept)
        self.prune_events: List[Dict] = []
        # how many candidates came from the learned distributions vs prior
        self.learned_samples = 0
        self.prior_samples = 0
        self._X: List[np.ndarray] = []
        self._lat: List[float] = []

    # -- helpers --------------------------------------------------------------

    def _dkey(self, trace: Trace) -> str:
        return structural_hash(self.key, trace)

    def _event(self, ev: str, **fields) -> None:
        """Emit to the tracer and, when ``verbose``, to the console."""
        emit(ev, **fields)
        if self._console is not None:
            self._console.write({"ev": ev, **fields})

    @property
    def total_failures(self) -> int:
        """Total failed measurements across all rounds."""
        return sum(self.failure_counts)

    def _provenance(self, res) -> Dict:
        """Build/run provenance persisted into ``TuningRecord.meta``."""
        meta = {
            "func": self.func.name,
            "runner": getattr(self.runner, "name", type(self.runner).__name__),
            "backend": getattr(self.runner, "backend", "jnp"),
            "build_time_s": round(res.build_time_s, 6),
            "run_time_s": round(res.run_time_s, 6),
            "source": res.source,
            "trials_so_far": len(self.measured),
            "failures_so_far": len(self.errors),
            "recent_errors": [e for _, e in self.errors[-3:]],
        }
        # lowering provenance from the backend (e.g. the *snapped* Pallas
        # block sizes actually measured, vs the sampled tile) — never lose
        # what really ran
        if getattr(res, "meta", None):
            meta.update(res.meta)
        return meta

    def _validated(self, trace: Trace) -> Optional[Candidate]:
        res = validate_trace(self.func, trace)
        if not res.ok:
            return None
        feats = extract_features(res.schedule)
        return Candidate(res.schedule.trace, res.schedule, feats)

    def _learned_variant(self, trace: Trace) -> Optional[Candidate]:
        """Re-draw a fresh trace's decisions from the learned distributions.

        Returns ``None`` when no site produced an override or the overridden
        trace falls outside the support (the validator rejects it).
        """
        decs = self.dists.decisions_for(trace, self.rng)
        if not decs:
            return None
        return self._validated(trace.with_decisions(decs))

    def _sample_initial(self, n: int) -> List[Candidate]:
        t0 = time.perf_counter()
        out: List[Candidate] = []
        tries = 0
        learned = 0
        use_learned = (
            self.cfg.learned_sampling
            and self.cfg.learned_frac > 0
            and self.dists.fitted
        )
        while len(out) < n and tries < n * 10:
            tries += 1
            seed = int(self.rng.integers(0, 2**31))
            sch = self.space.generate(self.func, seed=seed)
            cand = None
            if use_learned and self.rng.random() < self.cfg.learned_frac:
                cand = self._learned_variant(sch.trace)
                if cand is not None:
                    learned += 1
            if cand is None:
                cand = self._validated(sch.trace)
            if cand is not None:
                out.append(cand)
        self.learned_samples += learned
        self.prior_samples += len(out) - learned
        if trace_enabled():
            emit(
                "search.sample",
                task=self.key,
                requested=n,
                valid=len(out),
                learned=learned,
                tries=tries,
                dur_s=time.perf_counter() - t0,
            )
        return out

    def _propose_pool(
        self, survivors: Optional[List[Candidate]] = None
    ) -> List[Candidate]:
        """One round's candidate pool: sample, rollout-prune, evolve.

        With a trained cost model and ``rollout_factor > 1``, the fresh
        sample is ``rollout_factor``x oversized; all candidates are scored
        model-only and just the top ``population`` survive to MH evolution
        (and from there, at most ``measure_per_round`` to real measurement).
        """
        survivors = survivors or []
        n_fresh = max(self.cfg.population - len(survivors), 0)
        factor = (
            self.cfg.rollout_factor
            if self.model.trained and self.cfg.rollout_factor > 1
            else 1
        )
        fresh = self._sample_initial(n_fresh * factor)
        pool = survivors + fresh
        self._score(pool)
        if factor > 1 and len(pool) > self.cfg.population:
            pool.sort(key=lambda c: -c.score)
            kept = pool[: self.cfg.population]
            rec = {
                "round": len(self.failure_counts),
                "scored": len(pool),
                "kept": len(kept),
            }
            self.prune_events.append(rec)
            metrics().inc("costmodel.pruned", len(pool) - len(kept), task=self.key)
            if trace_enabled():
                emit(
                    "costmodel.prune",
                    task=self.key,
                    cutoff_score=kept[-1].score,
                    **rec,
                )
            pool = kept
        return self._evolve(pool)

    def _score(self, cands: List[Candidate]) -> None:
        if not cands:
            return
        X = np.stack([c.features for c in cands])
        if self.model.trained:
            s = self.model.predict(X)
        else:
            s = self.rng.random(len(cands)) * 1e-3  # untrained: explore
        for c, v in zip(cands, s):
            c.score = float(v)

    # -- evolution -----------------------------------------------------------

    def _evolve(self, population: List[Candidate]) -> List[Candidate]:
        """Annealed-MH evolution of the candidate pool via trace mutation."""
        with span(
            "search.evolve",
            task=self.key,
            population=len(population),
            generations=self.cfg.generations,
        ):
            return self._evolve_inner(population)

    def _evolve_inner(self, population: List[Candidate]) -> List[Candidate]:
        temp = self.cfg.temp_init
        pool = list(population)
        self._score(pool)
        for gen in range(self.cfg.generations):
            nxt: List[Candidate] = []
            for cand in pool:
                prop_trace = mutate(self.func, cand.trace, self.rng)
                if prop_trace is None:
                    nxt.append(cand)
                    continue
                prop = self._validated(prop_trace)
                if prop is None:  # validator rejection
                    nxt.append(cand)
                    continue
                self._score([prop])
                delta = prop.score - cand.score
                if delta >= 0 or self.rng.random() < math.exp(delta / max(temp, 1e-6)):
                    nxt.append(prop)  # MH accept
                else:
                    nxt.append(cand)
            pool = nxt
            temp *= self.cfg.temp_decay
        return pool

    def _select_to_measure(self, pool: List[Candidate], k: int) -> List[Candidate]:
        """ε-greedy: top-(1-ε)k by model score + εk random, dedup measured."""
        fresh = [c for c in pool if self._dkey(c.trace) not in self.measured]
        if not fresh:
            return []
        fresh.sort(key=lambda c: -c.score)
        n_greedy = max(1, int(round(k * (1 - self.cfg.epsilon))))
        picked = fresh[:n_greedy]
        rest = fresh[n_greedy:]
        if rest and k - len(picked) > 0:
            extra = self.rng.choice(
                len(rest), size=min(k - len(picked), len(rest)), replace=False
            )
            picked += [rest[i] for i in extra]
        # dedup by decision key
        seen = set()
        out = []
        for c in picked:
            dk = self._dkey(c.trace)
            if dk not in seen:
                seen.add(dk)
                out.append(c)
        return out[:k]

    def _measure(self, cands: List[Candidate]) -> None:
        """Measure one round as a single batched request to the runner
        (parallel runners overlap builds/timings across workers; results
        come back in candidate order regardless)."""
        if not cands:
            return
        batch = [
            MeasureInput(self.key, self.func, c.trace, schedule=c.schedule)
            for c in cands
        ]
        # predictions were made against the model state *before* this
        # round's retrain — capture it for the correlation record
        model_trained = self.model.trained
        with span("measure.batch", task=self.key, n=len(cands)):
            results = self.runner.run(batch)
        round_failures = 0
        for c, res in zip(cands, results):
            lat = res.latency_s
            h = self._dkey(c.trace)
            self.measured[h] = lat
            if res.ok:
                self._X.append(c.features)
                self._lat.append(lat)
                if lat < self.best_latency:
                    self.best_latency = lat
                    self.best_trace = c.trace
                    if self.db is not None:
                        self.db.put(
                            TuningRecord(
                                self.key,
                                c.trace.to_json(),
                                lat,
                                time.time(),
                                self._provenance(res),
                            )
                        )
            else:
                round_failures += 1
                self.errors.append((h, res.error))
            self.history.append((len(self.measured), self.best_latency))
        self.failure_counts.append(round_failures)
        round_idx = len(self.failure_counts)
        if round_failures:
            self._event(
                "measure.round_failures",
                task=self.key,
                round=round_idx,
                failed=round_failures,
                of=len(cands),
                last_error=self.errors[-1][1],
            )
        # cost-model accuracy: rank correlation of predicted score vs
        # measured latency for this round's candidates.  Scores rank
        # *throughput*, so correlate against negated latency — a healthy
        # model trends toward +1.
        pairs = [
            (float(c.score), float(res.latency_s))
            for c, res in zip(cands, results)
            if res.ok
        ]
        rho = spearman([p for p, _ in pairs], [-l for _, l in pairs])
        rec = {
            "round": round_idx,
            "n": len(pairs),
            "spearman": rho,
            "trained": model_trained,
        }
        self.round_correlations.append(rec)
        if rho is not None and model_trained:
            metrics().observe("costmodel.rank_corr", rho, task=self.key)
        if trace_enabled():
            emit(
                "costmodel.round",
                task=self.key,
                pairs=[[round(p, 6), l] for p, l in pairs],
                **rec,
            )
        metrics().inc("search.measured", len(cands), task=self.key)
        metrics().inc("search.failures", round_failures, task=self.key)
        if np.isfinite(self.best_latency):
            metrics().gauge(
                "search.best_latency_s", self.best_latency, task=self.key
            )
        # retrain the model on normalized throughput scores: this task's
        # sample pool is replaced wholesale; a model shared across tasks
        # (TaskScheduler) refits on the union of every task's pool
        if self._lat:
            best = min(self._lat)
            y = np.array([best / l for l in self._lat])
            self.model.set_task_data(self.key, np.stack(self._X), y)
        # refit the learned sampling distributions on this round's measured
        # candidates, weighted by normalized throughput (sharpened so
        # near-best schedules dominate the learned prior)
        if np.isfinite(self.best_latency):
            for c, res in zip(cands, results):
                if res.ok:
                    w = (self.best_latency / res.latency_s) ** QUALITY_GAMMA
                    self.dists.observe_trace(c.trace, w)
            self.dists.fit()
            if trace_enabled():
                emit(
                    "search.dists",
                    task=self.key,
                    sites=len(self.dists),
                    observations=self.dists.observations,
                )

    # -- main loop -------------------------------------------------------------

    def tune(self) -> "EvolutionarySearch":
        """Run the full search loop until ``max_trials`` measurements."""
        with span("tune.round", task=self.key, round=0) as sp:
            init = self._sample_initial(self.cfg.init_random)
            if not init:
                raise RuntimeError(
                    f"{self.key}: space generated no valid samples"
                )
            self._measure(init[: self.cfg.measure_per_round])
            sp.note(trials=len(self.measured), best_latency_s=self.best_latency)
        if self._console is not None:
            self._console.write(
                {
                    "ev": "tune.round",
                    "task": self.key,
                    "trials": len(self.measured),
                    "best_us": self.best_latency * 1e6,
                }
            )
        pool = init
        r = 0
        while len(self.measured) < self.cfg.max_trials:
            r += 1
            with span("tune.round", task=self.key, round=r) as sp:
                # refill population with fresh samples (learned + prior,
                # rollout-pruned) on top of the best survivors
                survivors = sorted(pool, key=lambda c: -c.score)[
                    : self.cfg.population // 2
                ]
                pool = self._propose_pool(survivors)
                to_measure = self._select_to_measure(
                    pool,
                    min(
                        self.cfg.measure_per_round,
                        self.cfg.max_trials - len(self.measured),
                    ),
                )
                if not to_measure:
                    break
                self._measure(to_measure)
                sp.note(
                    trials=len(self.measured), best_latency_s=self.best_latency
                )
            if self._console is not None:
                self._console.write(
                    {
                        "ev": "tune.round",
                        "task": self.key,
                        "trials": len(self.measured),
                        "best_us": self.best_latency * 1e6,
                    }
                )
        return self

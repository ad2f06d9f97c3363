"""Multi-task tuning scheduler (end-to-end model workflow, Appendix A.6).

A model extracts several tensor-program tasks (one per distinct hot
operator shape).  The scheduler allocates measurement trials across tasks
with a gradient-style policy: each round it picks the task whose recent
best-latency slope (weighted by task FLOPs) promises the largest end-to-end
gain — the same idea as TVM's gradient task scheduler — and runs one
search round for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.modules import SpaceGenerator, default_modules
from ..core.tir import PrimFunc
from ..obs import ConsoleSink, emit, metrics, span, trace_enabled
from .cost_model import GBDTCostModel
from .database import Database
from .distributions import DecisionDistributions
from .evolutionary import EvolutionarySearch, SearchConfig
from .measure import as_runner


@dataclass
class TuneTask:
    """One extracted tensor-program task: workload key, program, weight."""

    key: str
    func: PrimFunc
    weight: float = 1.0  # e.g. occurrence count in the model
    use_mxu: bool = False


class TaskScheduler:
    """Gradient task scheduler with round-robin warmup and early stopping.

    Every task gets one initialization round *before* any gradient-based
    selection (previously the all-``inf`` gradients of cold tasks made
    ``argmax`` hammer task 0 to a plateau before task 1 ever started).
    After warmup, rounds go to the task whose recent best-latency slope —
    weighted by its extracted occurrence count — promises the largest
    end-to-end gain; exact gradient ties break uniformly at random.  A
    task that fails to improve for ``patience`` consecutive rounds is
    considered plateaued and stops receiving trials; tuning ends early
    once every task has plateaued.

    All tasks share **one** cost model and **one** learned-distribution
    registry: the model pools every task's samples over shape-generic
    features, and the distributions pool decisions by shape-generic site
    keys — the cross-task transfer of "Learning to Optimize Tensor
    Programs".  With a file-backed database (``warm_start=True``), both are
    loaded from the database's sidecar files before tuning and saved back
    after, so knowledge also transfers across runs.
    """

    def __init__(
        self,
        tasks: Sequence[TuneTask],
        database: Optional[Database] = None,
        config=None,  # TuneConfig
    ):
        from .tune import as_tune_config, load_search_state

        tc = as_tune_config(config, "TaskScheduler")
        self.tasks = list(tasks)
        self.db = database
        # one shared runner across tasks: a caching runner then dedups
        # identical candidates across sibling tasks with equal shapes
        self.runner = as_runner(
            tc.runner_spec, backend=tc.backend, device=tc.device
        )
        self.backend = getattr(self.runner, "backend", "cuda")
        cfg = tc.search or SearchConfig()
        self.verbose = tc.verbose
        # verbose=True is a console-sink alias for the round events the
        # tracer records (the old per-round print() path)
        self._console = ConsoleSink() if tc.verbose else None
        self.patience = tc.patience
        self.rel_improvement = tc.rel_improvement
        self.seed_defaults = tc.seed_defaults
        self.rng = np.random.default_rng(
            tc.seed if tc.seed is not None else cfg.seed
        )
        # shared learned state: one model + one distribution registry for
        # every task (cross-task transfer), warm-started from the
        # database's sidecar files when present (cross-run transfer)
        self.warm_start = tc.warm_start
        self.warm_started = False
        model, dists = tc.cost_model, tc.distributions
        if tc.warm_start and (model is None or dists is None):
            loaded_model, loaded_dists = load_search_state(database)
            if model is None and loaded_model is not None:
                model, self.warm_started = loaded_model, True
            if dists is None and loaded_dists is not None:
                dists, self.warm_started = loaded_dists, True
        self.model = model if model is not None else GBDTCostModel(seed=cfg.seed)
        self.dists = dists if dists is not None else DecisionDistributions()
        if not self.warm_started and self.db is not None and self.db.records:
            # no sidecars: learn the prior from existing database records
            self.dists.observe_database(self.db)
            self.dists.fit()
        if self.warm_started and trace_enabled():
            emit(
                "costmodel.warm_start",
                tasks=[t.key for t in self.tasks],
                model_samples=self.model.n_samples,
                model_trained=self.model.trained,
                dist_sites=len(self.dists),
            )
        self.searches: List[EvolutionarySearch] = []
        for t in self.tasks:
            space = SpaceGenerator(default_modules(use_mxu=t.use_mxu))
            self.searches.append(
                EvolutionarySearch(
                    t.func,
                    space,
                    runner=self.runner,
                    database=self.db,
                    workload_key=t.key,
                    config=SearchConfig(**{**cfg.__dict__}),
                    cost_model=self.model,
                    distributions=self.dists,
                )
            )
        n = len(self.tasks)
        self._initialized = [False] * n
        self._stale_rounds = [0] * n
        self._best_seen = [float("inf")] * n
        self.rounds_run = 0

    def _gradient(self, i: int) -> float:
        """Expected end-to-end gain of giving task i one more round."""
        s = self.searches[i]
        t = self.tasks[i]
        if self._stale_rounds[i] >= self.patience:
            return float("-inf")  # plateaued: stop allocating trials
        if not self._initialized[i] or not np.isfinite(s.best_latency):
            return float("inf")  # cold tasks first
        h = s.history
        if len(h) < 2:
            return float("inf")
        # recent slope of best latency, weighted by occurrence count x latency
        window = h[-8:]
        d = window[0][1] - window[-1][1]
        return t.weight * max(d, 0.0) + 1e-9 * t.weight * s.best_latency

    def _pick_task(self) -> Optional[int]:
        """Warmup round-robin over cold tasks, then randomized argmax."""
        cold = [i for i in range(len(self.tasks)) if not self._initialized[i]]
        if cold:
            return cold[0]
        g = np.array([self._gradient(i) for i in range(len(self.tasks))])
        if not len(g) or np.all(np.isneginf(g)):
            return None  # every task plateaued
        ties = np.flatnonzero(g == g.max())
        return int(self.rng.choice(ties))

    def _default_candidate(self, i: int):
        """The canonical untuned schedule — the same program
        ``DispatchContext``'s ``mode="default"`` baseline compiles."""
        from ..core.validator import first_valid_schedule

        s = self.searches[i]
        sch = first_valid_schedule(s.func, s.space)
        return s._validated(sch.trace) if sch is not None else None

    def _run_round(self, i: int) -> None:
        s = self.searches[i]
        if not self._initialized[i]:
            init = s._sample_initial(s.cfg.init_random)
            if self.seed_defaults:
                # warm-start with the default schedule so the tuned best
                # is never worse than the untuned baseline (and mutation
                # can descend from it)
                dflt = self._default_candidate(i)
                if dflt is not None:
                    dk = s._dkey(dflt.trace)
                    init = [dflt] + [c for c in init if s._dkey(c.trace) != dk]
            if init:
                s._measure(init[: s.cfg.measure_per_round])
            self._initialized[i] = True
        else:
            # sample (learned + prior), rollout-prune with the shared cost
            # model, evolve, then measure the e-greedy slice
            pool = s._propose_pool()
            picks = s._select_to_measure(pool, s.cfg.measure_per_round)
            if picks:
                s._measure(picks)
        # plateau tracking: did this round improve the task's best?
        prev = self._best_seen[i]
        now = s.best_latency
        if now < prev * (1.0 - self.rel_improvement) or (
            np.isfinite(now) and not np.isfinite(prev)
        ):
            self._stale_rounds[i] = 0
        else:
            self._stale_rounds[i] += 1
        self._best_seen[i] = min(prev, now)

    def tune(self, total_rounds: int = 16) -> Dict[str, float]:
        """Allocate up to ``total_rounds`` search rounds across tasks.

        Returns ``{workload key: best latency}``; the shared cost model and
        distributions are persisted beside the database on the way out.
        """
        with span(
            "tune.session",
            tasks=[t.key for t in self.tasks],
            backend=self.backend,
            total_rounds=total_rounds,
        ) as sess:
            for r in range(total_rounds):
                i = self._pick_task()
                if i is None:
                    if self._console is not None:
                        self._console.write(
                            {"ev": "tune.early_stop", "round": r}
                        )
                    sess.note(early_stop_round=r)
                    break
                key = self.tasks[i].key
                with span("tune.round", task=key, round=r) as sp:
                    self._run_round(i)
                    s = self.searches[i]
                    sp.note(
                        trials=len(s.measured),
                        best_latency_s=s.best_latency,
                        stale=self._stale_rounds[i],
                    )
                self.rounds_run += 1
                metrics().inc("tune.rounds", task=key)
                if np.isfinite(s.best_latency):
                    metrics().gauge(
                        "search.best_latency_s", s.best_latency, task=key
                    )
                if self._console is not None:
                    self._console.write(
                        {
                            "ev": "tune.round",
                            "round": r,
                            "task": key,
                            "best_us": s.best_latency * 1e6,
                            "stale": self._stale_rounds[i],
                        }
                    )
            sess.note(rounds_run=self.rounds_run)
        if self.warm_start:
            # persist the shared model + distributions beside the database
            # so the next run (or another pipeline on the same db) warm-starts
            from .tune import save_search_state

            save_search_state(self.db, self.model, self.dists)
        return {t.key: s.best_latency for t, s in zip(self.tasks, self.searches)}

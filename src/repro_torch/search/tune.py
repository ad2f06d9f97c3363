"""Top-level tuning API.

``tune_workload`` = paper Figure 7 end-to-end for one tensor program, measured
on one device (``device="cuda"`` by default).
``TuneConfig`` is the session object every tuning entrypoint
(:func:`tune_workload`, :class:`~repro_torch.search.task_scheduler.TaskScheduler`,
the benchmarks) accepts: search knobs plus runner/backend/learned-state
wiring in one place.  ``apply_best`` replays the best database trace and
returns the lowered executable — the integration point used by models and
benchmarks.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Sequence


from ..backends.registry import DEFAULT_BACKEND, get_backend
from ..core.modules import Module, SpaceGenerator, default_modules
from ..obs import emit, trace_enabled, span
from ..core.tir import PrimFunc
from ..core.trace import Trace
from ..core.validator import validate_trace
from ..core.workloads import get_workload
from .cost_model import GBDTCostModel
from .database import Database, sidecar_path, workload_key
from .distributions import DecisionDistributions
from .evolutionary import EvolutionarySearch, SearchConfig
from .measure import MeasureInput, as_runner
from .measure.local import LocalRunner


@dataclass
class TuneConfig:
    """One object for a whole tuning session, and the only way to configure
    one.

    ``search`` carries the evolutionary-search knobs
    (:class:`~repro_torch.search.evolutionary.SearchConfig`); the rest wires
    measurement (``runner_spec`` — a registry spec string, ``"local"`` or
    ``"cached+local"``, or a built ``Runner``), lowering (``backend``,
    ``None`` for ``"cuda"``), the search space (``modules`` / ``use_mxu``)
    and learned-state transfer (``warm_start``, ``cost_model``,
    ``distributions``).  ``device`` is where candidates are measured:
    ``"cuda"`` (the default) raises when there is no card.  Scheduler-only knobs (``patience``,
    ``rel_improvement``, ``seed``, ``seed_defaults``) are ignored by
    single-workload :func:`tune_workload`.
    """

    search: Optional[SearchConfig] = None
    runner_spec: Any = None   # registry spec str or measure.Runner
    backend: Optional[str] = None  # lowering-backend spec; None -> "cuda"
    device: str = "cuda"  # where the runner measures
    modules: Optional[Sequence[Module]] = None
    use_mxu: bool = False
    warm_start: bool = True
    verbose: bool = False
    cost_model: Optional[GBDTCostModel] = None
    distributions: Optional[DecisionDistributions] = None
    # task-scheduler knobs
    patience: int = 4
    rel_improvement: float = 1e-3
    seed: Optional[int] = None
    seed_defaults: bool = True


def as_tune_config(config: Optional[TuneConfig], caller: str) -> TuneConfig:
    """A private copy of ``config`` (``None`` -> the defaults) that the
    caller may adjust without touching the caller's object."""
    if config is None:
        return TuneConfig()
    if not isinstance(config, TuneConfig):
        raise TypeError(
            f"{caller}() config must be a TuneConfig, got {type(config).__name__}"
        )
    return replace(config)


@dataclass
class TuneResult:
    """Outcome of one :func:`tune_workload` call (latency in seconds)."""

    workload_key: str
    best_latency_s: float
    baseline_latency_s: float   # the workload's plain PyTorch version
    default_latency_s: float    # first valid sample from the space, untuned
    trials: int
    best_trace: Trace
    history: list
    tuning_time_s: float = 0.0
    runner_name: str = "local"
    backend: str = "cuda"
    measure_failures: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    runner_stats: Optional[Dict] = None
    warm_started: bool = False  # persisted cost model / dists were loaded

    @property
    def speedup_vs_baseline(self) -> float:
        """Tuned best vs the workload's plain PyTorch version."""
        return self.baseline_latency_s / self.best_latency_s

    @property
    def speedup_vs_default(self) -> float:
        """The search's contribution: tuned vs untuned schedule."""
        return self.default_latency_s / self.best_latency_s

    @property
    def trials_to_best(self) -> int:
        """First trial count at which the final best latency was reached —
        the x-axis of the warm-start claim in ``benchmarks/tuning_time.py``.
        """
        for trial, best in self.history:
            if best <= self.best_latency_s:
                return trial
        return self.trials

    def trials_to(self, target_latency_s: float) -> Optional[int]:
        """First trial count at which ``best <= target`` was reached, or
        ``None`` if the search never got there."""
        for trial, best in self.history:
            if best <= target_latency_s:
                return trial
        return None


def load_search_state(
    database: Optional[Database],
) -> "tuple[Optional[GBDTCostModel], Optional[DecisionDistributions]]":
    """Load the persisted cost model + distributions beside a database.

    Returns ``(model, dists)``, each ``None`` when its sidecar file
    (``<db>.model.json`` / ``<db>.dists.json``) is absent or unreadable.
    """
    model = dists = None
    if database is None or not database.path:
        return None, None
    mp = sidecar_path(database.path, "model")
    dp = sidecar_path(database.path, "dists")
    import os

    if os.path.exists(mp):
        try:
            model = GBDTCostModel.load(mp)
        except (ValueError, OSError, KeyError):
            model = None
    if os.path.exists(dp):
        try:
            dists = DecisionDistributions.load(dp)
        except (ValueError, OSError, KeyError):
            dists = None
    return model, dists


def save_search_state(
    database: Optional[Database],
    model: Optional[GBDTCostModel],
    dists: Optional[DecisionDistributions],
) -> None:
    """Persist the cost model + distributions beside a database (no-op for
    in-memory databases)."""
    if database is None or not database.path:
        return
    if model is not None and model.trained:
        model.save(sidecar_path(database.path, "model"))
    if dists is not None and dists.fitted:
        dists.save(sidecar_path(database.path, "dists"))


def tune_workload(
    name: str,
    shape_kwargs: Optional[Dict] = None,
    config: Optional[TuneConfig] = None,
    database: Optional[Database] = None,
    device: Optional[str] = None,
    **shape,
) -> TuneResult:
    """Tune one workload end to end (paper Figure 7) and return the result.

    The workload's shape comes from ``shape_kwargs`` and/or keyword
    arguments (``tune_workload("dense", m=32, n=64, k=32, device="cpu")``).
    ``config`` is a :class:`TuneConfig`; ``device``, when given, overrides
    ``config.device``.

    With a file-backed ``database`` and ``warm_start=True`` (the default),
    the GBDT cost model and the learned sampling distributions are loaded
    from the database's sidecar files (``<db>.model.json`` /
    ``<db>.dists.json``) before the search and saved back after it.

    ``baseline_latency_s`` is the median time, on the same device, of the
    workload's plain PyTorch version (``gpu_backend.plain``: the kernel's
    plain version, or for a workload without a kernel the whole-domain
    structural oracle, as the reference package's jnp oracle); ``default_latency_s`` is the
    canonical untuned schedule measured through the same backend.
    """
    import time

    cfg = as_tune_config(config, "tune_workload")
    if device is not None:
        cfg.device = device
    search_cfg = cfg.search
    backend = cfg.backend
    shape_kwargs = {**(shape_kwargs or {}), **shape}
    func = get_workload(name, **shape_kwargs)
    key = workload_key(name, **shape_kwargs)
    space = SpaceGenerator(
        cfg.modules if cfg.modules is not None else default_modules(cfg.use_mxu)
    )
    runner = as_runner(cfg.runner_spec, backend=backend, device=cfg.device)

    # -- warm start: persisted model + distributions beside the database --
    warm_started = False
    model, dists = cfg.cost_model, cfg.distributions
    if cfg.warm_start and (model is None or dists is None):
        loaded_model, loaded_dists = load_search_state(database)
        if model is None and loaded_model is not None:
            model, warm_started = loaded_model, True
        if dists is None and loaded_dists is not None:
            dists, warm_started = loaded_dists, True
    if warm_started and trace_enabled():
        emit(
            "costmodel.warm_start",
            task=key,
            model_samples=getattr(model, "n_samples", 0),
            model_trained=getattr(model, "trained", False),
            dist_sites=len(dists) if dists is not None else 0,
        )
    if dists is None and database is not None and database.records:
        # no persisted distributions: learn the prior from the database's
        # records (every key — tile sites are keyed shape-generically)
        dists = DecisionDistributions()
        dists.observe_database(database)
        dists.fit()

    t0 = time.perf_counter()
    with span(
        "tune.session",
        tasks=[key],
        backend=getattr(runner, "backend", backend or DEFAULT_BACKEND),
    ):
        search = EvolutionarySearch(
            func,
            space,
            runner=runner,
            database=database,
            workload_key=key,
            config=search_cfg,
            cost_model=model,
            distributions=dists,
            verbose=cfg.verbose,
        ).tune()
    dt = time.perf_counter() - t0
    if cfg.warm_start:
        save_search_state(database, search.model, search.dists)
    if search.best_trace is not None:
        # re-verify the winner through the same runner: with a caching
        # runner this is a guaranteed dedup hit, not a re-measurement.
        # Outside the timed window — for non-caching runners it is a full
        # measurement and would bias cross-runner tuning-time comparisons.
        runner.run([MeasureInput(key, func, search.best_trace)])
    # baseline + canonical untuned point are reference measurements, taken
    # serially in-process so they are comparable across runner backends
    serial = LocalRunner(backend=backend, device=cfg.device)
    baseline = serial.measure_plain(func)
    default_lat = float("nan")
    from ..core.validator import first_valid_schedule

    sch0 = first_valid_schedule(func, space, seed_scan=16)
    if sch0 is not None:
        default_lat = serial.run([MeasureInput(key, func, sch0.trace, sch0)])[
            0
        ].latency_s
    stats = runner.stats()
    return TuneResult(
        workload_key=key,
        best_latency_s=search.best_latency,
        baseline_latency_s=baseline,
        default_latency_s=default_lat,
        trials=len(search.measured),
        best_trace=search.best_trace,
        history=search.history,
        tuning_time_s=dt,
        runner_name=getattr(runner, "name", type(runner).__name__),
        backend=getattr(runner, "backend", backend or DEFAULT_BACKEND),
        measure_failures=search.total_failures,
        cache_hits=int(stats.get("cache_hits", 0)),
        cache_misses=int(stats.get("cache_misses", 0)),
        runner_stats=stats,
        warm_started=warm_started,
    )


def apply_trace(func: PrimFunc, trace: Trace, backend: Optional[str] = None):
    """Replay a trace and lower it through the selected backend;
    returns (schedule, lowered) where ``lowered`` has ``.fn`` and
    ``.meta`` (see :class:`repro_torch.backends.registry.Lowered`)."""
    res = validate_trace(func, trace)
    if not res.ok:
        raise ValueError(f"invalid trace for {func.name}: {res.reason}")
    be = get_backend(backend)
    lowered = be.lower(res.schedule, workload_key=func.name)
    lowered.func = func  # convenience for callers that need shapes
    return res.schedule, lowered


def apply_best(
    name: str,
    database: Database,
    shape_kwargs: Optional[Dict] = None,
    backend: Optional[str] = None,
):
    """Lower the database-best trace for a workload (A.6 integration)."""
    shape_kwargs = shape_kwargs or {}
    key = workload_key(name, **shape_kwargs)
    rec = database.best(key)
    if rec is None:
        raise KeyError(f"no tuning record for {key}")
    func = get_workload(name, **shape_kwargs)
    return apply_trace(func, rec.trace(), backend=backend)

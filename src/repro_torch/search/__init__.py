"""Search layer: tuning entry points, database, runners, learned state."""

from .tune import (  # noqa: F401
    TuneConfig,
    TuneResult,
    apply_best,
    apply_trace,
    load_search_state,
    save_search_state,
    tune_workload,
)
from .cost_model import GBDTCostModel, GBDTModel  # noqa: F401
from .database import Database, TuningRecord, sidecar_path, workload_key  # noqa: F401
from .distributions import DecisionDistributions, LearnedCategorical  # noqa: F401
from .evolutionary import EvolutionarySearch, SearchConfig  # noqa: F401
from .task_scheduler import TaskScheduler, TuneTask  # noqa: F401
from .measure import (  # noqa: F401
    PROTOCOL_VERSION,
    CachedRunner,
    MeasurementFault,
    ProcessPoolRunner,
    ProtocolError,
    RPCRunner,
    Runner,
    as_runner,
    create_runner,
    runner_names,
    spawn_local_workers,
)

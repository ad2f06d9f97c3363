"""Tensor-program autotuning with probabilistic programs, on PyTorch and CUDA.

The port of the JAX package ``repro`` to one NVIDIA H100: the same
MetaSchedule loop (workload → trace → kernel → measurement → database →
dispatch into the model), with the TPU kernels rewritten by hand in CUDA
C++.  The public surface, importable straight off the package::

    import repro_torch

    tasks = repro_torch.extract_tasks(get_config("smollm-135m"), seq=256)
    repro_torch.TaskScheduler(
        tasks, database=db, config=repro_torch.TuneConfig(
            backend="cuda", runner_spec="cached+pool://workers=2"),
    ).tune()  # candidates measured in two spawned workers sharing the card
    with repro_torch.DispatchContext(db, tasks=tasks):
        ...  # model forward — tuned kernels served by workload key

    sched = repro_torch.ContinuousBatchingScheduler(
        cfg, params, config=repro_torch.ServeConfig(dispatch=ctx),
    )  # serving: tuned decode kernels serve every generated token

Entry points measure and run on ``device="cuda"`` unless told otherwise and
raise when there is no card.  Everything here is a lazy re-export (PEP
562): importing ``repro_torch`` stays cheap until a symbol is touched.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

# public name -> defining module (relative to this package)
_EXPORTS = {
    # tuning front door
    "tune_workload": "search.tune",
    "apply_best": "search.tune",
    "TuneConfig": "search.tune",
    "TuneResult": "search.tune",
    "SearchConfig": "search.evolutionary",
    # multi-task tuning
    "TaskScheduler": "search.task_scheduler",
    "TuneTask": "search.task_scheduler",
    "extract_tasks": "integration.extract",
    "extract_decode_tasks": "integration.extract",
    # persistence + dispatch + serving
    "Database": "search.database",
    "DispatchContext": "integration.dispatch",
    "ServeConfig": "serving.config",
    "ServingEngine": "serving.engine",
    "ContinuousBatchingScheduler": "serving.scheduler",
    # measurement fleet
    "create_runner": "search.measure",
    "as_runner": "search.measure",
    "runner_names": "search.measure",
    "ProcessPoolRunner": "search.measure",
    "RPCRunner": "search.measure",
    "spawn_local_workers": "search.measure",
    "PROTOCOL_VERSION": "search.measure",
    "ProtocolError": "search.measure",
    "MeasurementFault": "search.measure",
    # telemetry
    "metrics": "obs",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        modname = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    return getattr(importlib.import_module(f".{modname}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


if TYPE_CHECKING:  # static-analysis view of the lazy exports
    from .integration.dispatch import DispatchContext  # noqa: F401
    from .integration.extract import (  # noqa: F401
        extract_decode_tasks,
        extract_tasks,
    )
    from .obs import metrics  # noqa: F401
    from .search.database import Database  # noqa: F401
    from .search.evolutionary import SearchConfig  # noqa: F401
    from .search.measure import (  # noqa: F401
        PROTOCOL_VERSION,
        MeasurementFault,
        ProcessPoolRunner,
        ProtocolError,
        RPCRunner,
        as_runner,
        create_runner,
        runner_names,
        spawn_local_workers,
    )
    from .search.task_scheduler import TaskScheduler, TuneTask  # noqa: F401
    from .serving.config import ServeConfig  # noqa: F401
    from .serving.engine import ServingEngine  # noqa: F401
    from .serving.scheduler import ContinuousBatchingScheduler  # noqa: F401
    from .search.tune import (  # noqa: F401
        TuneConfig,
        TuneResult,
        apply_best,
        tune_workload,
    )

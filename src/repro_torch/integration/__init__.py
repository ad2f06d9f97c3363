"""End-to-end model tuning: task extraction + tuned-kernel dispatch.

``extract`` records a model's hook call sites into weighted tuning tasks;
``dispatch`` swaps the database's best traces back into the model layers.
Exports are lazy (PEP 562): ``extract`` imports the model code, whose
layers in turn probe :mod:`repro_torch.integration.dispatch` — laziness
keeps the import graph acyclic.
"""

from __future__ import annotations

_EXPORTS = {
    "extract_tasks": "extract",
    "extract_task_specs": "extract",
    "ExtractedTask": "extract",
    "TaskSite": "extract",
    "SiteRecorder": "extract",
    "TOKEN_TILE": "extract",
    "DispatchContext": "dispatch",
    "CompiledKernel": "dispatch",
    "current": "dispatch",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

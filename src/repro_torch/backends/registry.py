"""Lowering-backend registry: how a sampled schedule reaches hardware.

MetaSchedule's contract (paper Fig 1, Appendix A.6) is that the
probabilistic space is constructed once and a *backend* carries the
sampled decisions to an executable.  The measurement stack builds
candidates, and the dispatch layer serves models, through the *same*
selected lowering::

    "cuda"   the hand-written CUDA kernels (dense, batch_matmul, prefill
             attention, single-token decode attention, row softmax);
             tensors on the CPU run the kernels' plain versions.  Every
             other workload falls back to the structural lowering, and the
             fallback is recorded as ``lowered_with: "torch-fallback"``
    "torch"  the structural PyTorch lowering of any schedule (the port of
             the JAX package's ``jnp`` backend), on the inputs' device

Selection is explicit (``backend="cuda"`` through ``tune_workload`` /
``TaskScheduler`` / ``DispatchContext``); ``None`` means
``DEFAULT_BACKEND``.  A workload that has a kernel never falls back: a
failure to lower or launch it propagates.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..core.schedule import Schedule

DEFAULT_BACKEND = "cuda"

_BACKENDS: Dict[str, Callable[[], "Backend"]] = {}
_INSTANCES: Dict[str, "Backend"] = {}


@dataclass
class Lowered:
    """A backend-lowered schedule: executable + lowering provenance.

    ``fn`` is ``callable(dict inputs) -> dict outputs`` on tensors;
    ``meta`` is a flat JSON-able dict recording what the lowering actually
    did (backend name, snapped block sizes, ...) and is persisted into
    ``TuningRecord.meta`` by the search and surfaced on
    ``CompiledKernel.meta`` by the dispatch layer.
    """

    fn: Callable[[Dict[str, Any]], Dict[str, Any]]
    meta: Dict[str, Any] = field(default_factory=dict)


class Backend(abc.ABC):
    """Lowers validated schedules to executables."""

    name: str = "backend"

    @abc.abstractmethod
    def lower(self, sch: Schedule, workload_key: str = "") -> Lowered:
        """Lower a schedule; raise on impossibility."""

    def prepare(self, device) -> None:
        """Make the backend ready to run on ``device`` before anything is
        timed (e.g. build kernels).  Default: nothing to do."""


def register_backend(name: str):
    def deco(factory: Callable[[], Backend]):
        _BACKENDS[name] = factory
        return factory

    return deco


def backend_names() -> List[str]:
    return sorted(_BACKENDS)


def get_backend(spec: Optional[str] = None) -> Backend:
    """Instantiate (memoized) a backend from a registry spec.

    ``None`` means ``DEFAULT_BACKEND``; unknown names raise ``KeyError``
    listing what is available.
    """
    spec = spec or DEFAULT_BACKEND
    if spec not in _BACKENDS:
        raise KeyError(
            f"unknown backend {spec!r}; available: {', '.join(backend_names())}"
        )
    if spec not in _INSTANCES:
        _INSTANCES[spec] = _BACKENDS[spec]()
    return _INSTANCES[spec]


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------


class TorchBackend(Backend):
    """The structural PyTorch lowering: every schedule, as its loop tree."""

    name = "torch"

    def lower(self, sch: Schedule, workload_key: str = "") -> Lowered:
        from . import torch_backend

        return Lowered(torch_backend.build(sch).fn, {"backend": self.name})


class CudaBackend(Backend):
    """Hand-written CUDA kernels for tuned schedules (dense, batch_matmul,
    prefill attention, decode attention, row softmax) plus the untuned
    fused attention the dispatch layer serves.  A workload without a
    kernel goes through the structural lowering instead, recorded in the
    meta as ``lowered_with: "torch-fallback"``."""

    name = "cuda"

    def supports(self, func) -> bool:
        from . import gpu_backend

        return gpu_backend.supports(func)

    def lower(self, sch: Schedule, workload_key: str = "") -> Lowered:
        from . import gpu_backend, torch_backend

        if gpu_backend.supports(sch.func):
            fn, meta = gpu_backend.lower_to_cuda(sch)
            return Lowered(fn, {"backend": self.name, **meta})
        return Lowered(
            torch_backend.build(sch).fn,
            {"backend": self.name, "lowered_with": "torch-fallback"},
        )

    def prepare(self, device) -> None:
        import torch

        if torch.device(device).type == "cuda":
            from ..kernels._build import build_all

            build_all()

    # -- fused ops served directly to the dispatch layer --------------------

    def fused_attention(self, q, k, v, **kwargs):
        """Fused flash attention (K3) for the dispatch layer's attention
        hook; see :meth:`DispatchContext.attention`.

        This is the *untuned* fallback: when the database holds a tuned
        ``attention`` record the dispatch layer serves the fully-lowered
        kernel (db-tuned blocks) and never reaches here.  Blocks snap to
        the largest divisor of the sequence length <= 128 — the pre-tuning
        fixed default.
        """
        from ..kernels.flash_attention import best_divisor, flash_attention

        bq = best_divisor(int(q.shape[2]), 128)
        return flash_attention(q, k, v, block_q=bq, block_kv=bq, **kwargs)


@register_backend("cuda")
def _make_cuda() -> Backend:
    return CudaBackend()


@register_backend("torch")
def _make_torch() -> Backend:
    return TorchBackend()

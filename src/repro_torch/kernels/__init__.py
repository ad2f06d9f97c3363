# Hand-written CUDA kernels for the compute hot-spots the tuner optimizes:
# the tunable-tile matmul and batched matmul (matmul.py, csrc/matmul.cu) and
# prefill flash attention (flash_attention.py, csrc/flash_attention.cu).
# ref.py holds their plain PyTorch versions; _build.py compiles the sources
# at first use.


class ScheduleRejected(ValueError):
    """A tile the card cannot run: it does not divide the problem, or it
    exceeds the shared-memory, thread or grid caps.  The measurement stack
    turns this, and only this, into a rejected candidate and the dispatch
    layer into a ``lowering_failed`` miss; every other error propagates.
    ``reason`` is one of ``divide``, ``shared_memory``, ``threads`` and
    ``grid``."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


from . import ref  # noqa: E402,F401

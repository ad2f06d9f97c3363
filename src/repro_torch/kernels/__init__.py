# Hand-written CUDA kernels for the compute hot-spots the tuner optimizes:
# the tunable-tile matmul and batched matmul (matmul.py, csrc/matmul.cu),
# prefill flash attention (flash_attention.py, csrc/flash_attention.cu),
# single-token decode attention, contiguous and paged (flash_attention.py,
# csrc/decode_attention.cu), the row softmax of the ``sfm`` task
# (softmax.py, csrc/softmax.cu) and the Mamba-2 chunked SSD scan (ssd.py,
# csrc/ssd.cu).
# ref.py holds their plain PyTorch versions; _build.py compiles the sources
# at first use; ops.py is the models' entry to them.


class ScheduleRejected(ValueError):
    """A tile the card cannot run: it does not divide the problem, or it
    exceeds the shared-memory, thread or grid caps.  The measurement stack
    turns this, and only this, into a rejected candidate and the dispatch
    layer into a ``lowering_failed`` miss; every other error propagates.
    ``reason`` is one of ``divide``, ``shared_memory``, ``threads`` and
    ``grid``, or ``structure`` for a schedule the structural lowering
    (``backends/torch_backend.py``) cannot express."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


from . import ref  # noqa: E402,F401

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


_SM_COUNTS = {}


def sm_count(device) -> int:
    """The streaming multiprocessors of the CUDA ``device`` (read once).
    The launch plans of K5, K6 and K7 take this count as an argument, so
    that they stay pure functions the CPU tests can call."""
    import torch

    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNTS[index]


_TILE_COUNTERS = {}


def tile_counters(device, stream: int, tiles: int):
    """At least ``tiles`` zeroed int32 counters on ``device`` for launches
    on ``stream``: one a split-K output tile (K1, K2) or a (batch, kv head)
    split over kv (K5, K6), whose last CTA sums the partials.  Each launch
    leaves its counters zero, and launches on one stream run one after
    another, so no two launches share a counter at once, and a CUDA graph
    that captured a launch finds them zero at every replay."""
    import torch

    buf = _TILE_COUNTERS.get((device, stream))
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
        _TILE_COUNTERS[(device, stream)] = buf
    return buf


def _wrappers():
    from .flash_attention import (
        decode_flash_attention,
        flash_attention,
        paged_decode_flash_attention,
    )
    from .matmul import batch_matmul, matmul
    from .softmax import row_softmax
    from .ssd import ssd

    return (matmul, batch_matmul, flash_attention, decode_flash_attention,
            paged_decode_flash_attention, row_softmax, ssd)


def launch_counts() -> dict:
    """The kernel launches this process has made so far, read from the
    wrappers' counters: ``{name: launches}``, and ``{"name/variant":
    launches}`` for the wrappers that also count by variant."""
    out = {}
    for w in _wrappers():
        out[w.__name__] = w.launches
        for v, n in getattr(w, "launches_by_variant", {}).items():
            out[f"{w.__name__}/{v}"] = n
    return out


def launches_since(before: dict) -> dict:
    """The launches made since ``before`` (a :func:`launch_counts`), the
    counters that moved only."""
    now = launch_counts()
    return {k: n - before.get(k, 0) for k, n in now.items() if n != before.get(k, 0)}


from . import ref  # noqa: E402,F401

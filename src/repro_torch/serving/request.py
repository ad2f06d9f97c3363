"""The one request type the serving tier shares.

``ServingEngine.submit()`` and ``ContinuousBatchingScheduler.submit()``
both return a :class:`Request`, with the same result shape (``generated``
token list + submit/admit/first-token/finish timestamps) and a streaming
interface — ``.tokens()`` yields tokens as they decode, pumping the owning
engine or scheduler forward while the request is unfinished.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    generated: List[int] = field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None
    # perf_counter timestamps along the lifecycle
    submit_s: float = 0.0
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    # chunked prefill progress: prompt tokens already processed
    prefill_done: int = 0
    # set by the owning engine/scheduler at submit(): advances serving by
    # one unit of work (a tick / a batch) so .tokens() can stream
    _pump: Optional[Callable[[], object]] = field(
        default=None, repr=False, compare=False
    )

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit -> first generated token (the prefill sample)."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.submit_s

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.submit_s

    def mark_submitted(self) -> "Request":
        self.submit_s = time.perf_counter()
        return self

    def tokens(self) -> Iterator[int]:
        """Stream generated tokens, driving the server until done.

        Yields every token already generated, then pumps the owning
        engine/scheduler (one tick per pump) until the request finishes —
        requests on other slots advance too, exactly as under ``run()``.
        """
        i = 0
        while True:
            while i < len(self.generated):
                yield int(self.generated[i])
                i += 1
            if self.done:
                return
            if self._pump is None:
                raise RuntimeError(
                    "request is not attached to a running engine/scheduler"
                )
            self._pump()

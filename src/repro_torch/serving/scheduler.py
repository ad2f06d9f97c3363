"""Continuous-batching serving scheduler over a shared KV arena.

Request-level scheduling, configured by one
:class:`~repro_torch.serving.config.ServeConfig`:

* **admission queue** — ``submit()`` enqueues; each tick admits requests
  into free slots.  Under the paged arena admission is gated on free
  *pages* (the request's full reach, prompt + generation budget), not just
  free slots.
* **paged or slot-pool KV arena** — one fixed-shape cache whose batch dim
  is the slot pool (:mod:`repro_torch.serving.kv`); every tick is one model
  call over all slots with per-slot positions, so a prefill joins a *live*
  decode batch without a full-batch barrier.
* **in-tick chunked prefill** (``prefill_chunk > 0``) — prompts stream
  through the same ``serve_step`` call as decode: each tick budgets
  ``ServeConfig.tick_budget`` tokens, gives every live decode lane one, and
  splits the remainder over prefilling requests in admission order as
  chunks of at most ``prefill_chunk`` tokens.
* **early release / recycling** — a request leaving at ``max_new_tokens``
  frees its slot (and pages) at once; the next queued request takes them
  on the following tick while the other lanes keep decoding.

With ``prefill_chunk == 0`` admission prefills the request alone at its
exact prompt length (batch 1, no padding) and copies the resulting cache
into the slot; ticks are then ``decode_step`` calls unless the arena is
paged.

The JAX package compiles its three programs (prefill, decode step, serve
step) with ``jax.jit``; here they are plain eager calls, each run under the
optional DispatchContext, so tuned ``attention_decode`` / ``dense`` kernels
(extracted with ``extract_decode_tasks``) serve every generated token.

Observability (``repro_torch.obs``): ``serve.queue_depth`` /
``serve.slot_utilization`` / ``serve.free_pages`` gauges, ``serve.admit`` /
``serve.evict`` events, the per-request time-to-first-token histogram
``serve.ttft_s``, and the ``serve.prefill`` / ``serve.decode`` events the
engine emits (chunked prefill tags its events with ``chunked=True``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.registry import build_model
from ..obs import emit, metrics, trace_enabled
from .config import ServeConfig, check_servable, coerce_serve_config
from .engine import logits_to_numpy, sample
from .kv import KVArena, PagedKVArena, SlotPool
from .request import Request


class ContinuousBatchingScheduler:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        config: Optional[ServeConfig] = None,
    ):
        check_servable(cfg)
        self.config = coerce_serve_config(
            config, "ContinuousBatchingScheduler"
        ).resolved_for(cfg)
        sc = self.config
        self.cfg = cfg
        self.model = build_model(cfg)
        self.params = params
        self.device = params["embed"].device
        self.n_slots = sc.max_slots
        self.max_seq = sc.max_seq
        self.rng = np.random.default_rng(sc.seed)
        self.dispatch = sc.dispatch
        # serve_step carries both tick shapes (decode-only and mixed); the
        # decode_step call is kept for the non-paged, whole-prompt mode
        self._use_serve = bool(sc.paged or sc.prefill_chunk > 0)
        if sc.paged:
            self.arena = PagedKVArena(
                self.model, sc.max_slots, sc.max_seq,
                page_size=sc.page_size, total_pages=sc.total_pages,
                device=self.device,
            )
        else:
            self.arena = KVArena(self.model, sc.max_slots, sc.max_seq,
                                 device=self.device)
        self.pool = SlotPool(sc.max_slots)
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> decoding request
        self.prefilling: Dict[int, Request] = {}  # slot -> mid-prompt req
        self._prefill_order: List[int] = []  # admission order, for budget
        self._next_tok = np.zeros((sc.max_slots,), np.int64)
        self._requests: List[Request] = []
        self.stats: Dict[str, float] = {
            "prefill_tokens": 0, "decode_steps": 0, "decode_tokens": 0,
            "prefill_s": 0.0, "decode_s": 0.0,
            "admitted": 0, "released": 0, "peak_active": 0,
            "prefill_chunks": 0, "mixed_ticks": 0, "pages_reserved": 0,
        }

    # -- engine-compatible throughput properties ----------------------------

    @property
    def prefill_tok_s(self) -> float:
        s = self.stats["prefill_s"]
        return self.stats["prefill_tokens"] / s if s > 0 else 0.0

    @property
    def decode_tok_s(self) -> float:
        s = self.stats["decode_s"]
        return self.stats["decode_tokens"] / s if s > 0 else 0.0

    # -- request lifecycle --------------------------------------------------

    def submit(
        self, prompt: np.ndarray, max_new_tokens: int = 16,
        temperature: Optional[float] = None,
    ) -> Request:
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) < 1:
            raise ValueError("prompt must have at least one token")
        if len(prompt) > self.max_seq:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds max_seq {self.max_seq}"
            )
        if temperature is None:
            temperature = self.config.temperature
        r = Request(len(self._requests), prompt, max_new_tokens, temperature)
        r._pump = self.step
        r.mark_submitted()
        self._requests.append(r)
        self.queue.append(r)
        metrics().gauge("serve.queue_depth", len(self.queue), model=self.cfg.name)
        return r

    def pending(self) -> bool:
        """True while any request is queued, prefilling, or decoding."""
        return bool(self.queue or self.prefilling or self.active)

    def _dctx(self):
        from ..integration.dispatch import maybe_dispatch

        return maybe_dispatch(self.dispatch)

    def _can_admit(self, r: Request) -> bool:
        if not self.pool.free:
            return False
        if isinstance(self.arena, PagedKVArena):
            return self.arena.can_admit(len(r.prompt) + r.max_new_tokens)
        return True

    def _admit_one(self) -> None:
        slot = self.pool.alloc()
        r = self.queue.popleft()
        r.slot = slot
        r.admit_s = time.perf_counter()
        if isinstance(self.arena, PagedKVArena):
            self.stats["pages_reserved"] += self.arena.reserve(
                slot, len(r.prompt) + r.max_new_tokens
            )
        metrics().inc("serve.admit", model=self.cfg.name)
        self.stats["admitted"] += 1
        if trace_enabled():
            emit(
                "serve.admit",
                model=self.cfg.name,
                rid=r.rid,
                slot=slot,
                prompt_len=len(r.prompt),
                queue_wait_s=round(r.admit_s - r.submit_s, 6),
            )
        if self.config.prefill_chunk > 0:
            # the prompt streams through the serve tick in chunks
            r.prefill_done = 0
            self.prefilling[slot] = r
            self._prefill_order.append(slot)
            return
        self._prefill_whole(slot, r)

    def _prefill_whole(self, slot: int, r: Request) -> None:
        """Admission without chunking: batch=1 exact-length prefill outside
        the tick."""
        prompt = torch.from_numpy(r.prompt.astype(np.int64)[None, :]).to(self.device)
        cache = self.model.init_cache(1, self.max_seq, device=self.device)
        t0 = time.perf_counter()
        with torch.no_grad(), self._dctx():
            logits, cache = self.model.prefill(self.params, cache, prompt)
            logits = logits_to_numpy(logits)
        dt = time.perf_counter() - t0
        self.stats["prefill_s"] += dt
        self.stats["prefill_tokens"] += len(r.prompt)
        m = metrics()
        m.inc("serve.prefill_tokens", len(r.prompt), model=self.cfg.name)
        m.observe("serve.prefill_s", dt, model=self.cfg.name)
        if trace_enabled():
            emit(
                "serve.prefill",
                model=self.cfg.name,
                batch=1,
                tokens=len(r.prompt),
                dur_s=round(dt, 6),
                tok_s=round(len(r.prompt) / dt, 3) if dt > 0 else None,
            )
        self.arena.load_slot(slot, cache)
        self._first_token(slot, r, sample(self.rng, logits[0], r.temperature))

    def _first_token(self, slot: int, r: Request, tok: int) -> None:
        """Prompt fully processed: record TTFT, move the slot to decode."""
        r.generated.append(tok)
        r.first_token_s = time.perf_counter()
        metrics().observe("serve.ttft_s", r.ttft_s, model=self.cfg.name)
        self._next_tok[slot] = tok
        self.active[slot] = r
        self.stats["peak_active"] = max(self.stats["peak_active"], len(self.active))
        if len(r.generated) >= r.max_new_tokens:
            self._release(slot)  # prefill-only request (max_new_tokens=1)

    def _release(self, slot: int) -> None:
        r = self.active.pop(slot)
        r.done = True
        r.finish_s = time.perf_counter()
        r.slot = None
        used = int(self.arena.positions[slot])
        self.arena.release_slot(slot, used=used)
        self.pool.release(slot)
        self._next_tok[slot] = 0
        self.stats["released"] += 1
        metrics().inc("serve.evict", model=self.cfg.name)
        if trace_enabled():
            emit(
                "serve.evict",
                model=self.cfg.name,
                rid=r.rid,
                slot=slot,
                tokens=len(r.generated),
                ttft_s=round(r.ttft_s, 6),
                latency_s=round(r.latency_s, 6),
            )

    # -- the tick -----------------------------------------------------------

    def step(self) -> bool:
        """One scheduler tick: admit while capacity allows, then one model
        call over the arena — decode lanes plus (when chunked prefill is
        on) in-tick prompt chunks under the token budget.  Returns True if
        any work was done."""
        admitted = False
        while self.queue and self._can_admit(self.queue[0]):
            self._admit_one()
            admitted = True
        m = metrics()
        m.gauge("serve.queue_depth", len(self.queue), model=self.cfg.name)
        m.gauge(
            "serve.slot_utilization",
            (len(self.active) + len(self.prefilling)) / self.n_slots,
            model=self.cfg.name,
        )
        if isinstance(self.arena, PagedKVArena):
            m.gauge("serve.free_pages", self.arena.free_pages, model=self.cfg.name)
        if not self.active and not self.prefilling:
            return admitted
        if not self._use_serve:
            self._decode_tick()
            return True
        self._serve_tick()
        return True

    def _decode_tick(self) -> None:
        """One ``decode_step`` over the arena (every prompt was prefilled
        whole at admission)."""
        m = metrics()
        t0 = time.perf_counter()
        with torch.no_grad(), self._dctx():
            logits, cache = self.model.decode_step(
                self.params, self.arena.cache,
                torch.from_numpy(self._next_tok[:, None]).to(self.device),
            )
            la = logits_to_numpy(logits)
        self.arena.cache = dict(cache)
        dt = time.perf_counter() - t0
        new_tokens = 0
        for slot in list(self.active):
            r = self.active[slot]
            # every live lane appends exactly one token; free lanes decode
            # garbage that is never sampled
            tok = sample(self.rng, la[slot], r.temperature)
            r.generated.append(tok)
            self._next_tok[slot] = tok
            new_tokens += 1
            if len(r.generated) >= r.max_new_tokens:
                self._release(slot)
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += new_tokens
        self.stats["decode_s"] += dt
        m.inc("serve.decode_tokens", new_tokens, model=self.cfg.name)
        m.observe("serve.decode_step_s", dt, model=self.cfg.name)
        m.gauge("serve.decode_tok_s", self.decode_tok_s, model=self.cfg.name)
        if trace_enabled():
            emit(
                "serve.decode",
                model=self.cfg.name,
                batch=new_tokens,
                steps=1,
                tokens=new_tokens,
                dur_s=round(dt, 6),
                tok_s=round(new_tokens / dt, 3) if dt > 0 else None,
            )

    def tick_inputs(self):
        """The next serve tick's ``(tokens (n_slots, width), valid
        (n_slots,), chunked [(slot, n)])`` under the token budget: every
        live decode lane one token, the rest to prefilling requests in
        admission order."""
        sc = self.config
        decode_slots = list(self.active)
        prefill_budget = max(0, sc.tick_budget - len(decode_slots))
        width = 1
        if self.prefilling and prefill_budget > 0 and sc.prefill_chunk > 0:
            width = sc.prefill_chunk
        toks = np.zeros((self.n_slots, width), np.int64)
        valid = np.zeros((self.n_slots,), np.int32)
        for slot in decode_slots:
            toks[slot, 0] = self._next_tok[slot]
            valid[slot] = 1
        chunked: List[tuple] = []
        if width > 1:
            left = prefill_budget
            for slot in list(self._prefill_order):
                if left <= 0:
                    break
                r = self.prefilling[slot]
                n = min(width, len(r.prompt) - r.prefill_done, left)
                if n <= 0:
                    continue
                toks[slot, :n] = r.prompt[r.prefill_done:r.prefill_done + n]
                valid[slot] = n
                left -= n
                chunked.append((slot, n))
        return toks, valid, chunked

    def _serve_tick(self) -> None:
        """Unified tick: every live decode lane gets one token; leftover
        budget flows to prefilling requests as in-tick chunks."""
        m = metrics()
        decode_slots = list(self.active)
        toks, valid, chunked = self.tick_inputs()
        t0 = time.perf_counter()
        with torch.no_grad(), self._dctx():
            logits, cache = self.model.serve_step(
                self.params, self.arena.cache,
                torch.from_numpy(toks).to(self.device),
                torch.from_numpy(valid).to(self.device),
            )
            la = logits_to_numpy(logits)
        self.arena.cache = dict(cache)
        dt = time.perf_counter() - t0
        # prompt chunks advance; a finished prompt samples its first token
        # from this very tick (its sample position was the chunk's last)
        ptoks = 0
        for slot, n in chunked:
            r = self.prefilling[slot]
            r.prefill_done += n
            ptoks += n
            if r.prefill_done >= len(r.prompt):
                del self.prefilling[slot]
                self._prefill_order.remove(slot)
                self._first_token(slot, r, sample(self.rng, la[slot], r.temperature))
        for slot in decode_slots:
            r = self.active[slot]
            tok = sample(self.rng, la[slot], r.temperature)
            r.generated.append(tok)
            self._next_tok[slot] = tok
            if len(r.generated) >= r.max_new_tokens:
                self._release(slot)
        # attribute the tick's wall time to decode/prefill by token share
        n_decode = len(decode_slots)
        total = n_decode + ptoks
        if total:
            self.stats["decode_s"] += dt * n_decode / total
            self.stats["prefill_s"] += dt * ptoks / total
        self.stats["decode_tokens"] += n_decode
        self.stats["prefill_tokens"] += ptoks
        self.stats["prefill_chunks"] += len(chunked)
        if n_decode:
            self.stats["decode_steps"] += 1
            m.inc("serve.decode_tokens", n_decode, model=self.cfg.name)
            m.observe("serve.decode_step_s", dt, model=self.cfg.name)
            m.gauge("serve.decode_tok_s", self.decode_tok_s, model=self.cfg.name)
        if chunked:
            m.inc("serve.prefill_tokens", ptoks, model=self.cfg.name)
            if n_decode:
                self.stats["mixed_ticks"] += 1
        if trace_enabled():
            if n_decode:
                emit(
                    "serve.decode",
                    model=self.cfg.name,
                    batch=n_decode,
                    steps=1,
                    tokens=n_decode,
                    dur_s=round(dt, 6),
                    tok_s=round(n_decode / dt, 3) if dt > 0 else None,
                )
            if chunked:
                emit(
                    "serve.prefill",
                    model=self.cfg.name,
                    batch=len(chunked),
                    tokens=ptoks,
                    dur_s=round(dt, 6),
                    chunked=True,
                    tok_s=round(ptoks / dt, 3) if dt > 0 else None,
                )

    def run(self) -> List[Request]:
        """Drain the queue: tick until every request completes."""
        while self.pending():
            self.step()
        return self._requests

"""Batched serving engine: prefill + decode over a KV cache.

Request lifecycle: submit → (batched) prefill → decode loop → done.  The
engine serves submitted requests in fixed batches of ``max_slots``: one
left-padded batch prefill, then one ``decode_step`` over the whole batch
per generated token.  Greedy or temperature sampling.

Construction takes a :class:`~repro_torch.serving.config.ServeConfig`
(``ServingEngine(cfg, params, config=ServeConfig(max_slots=8))``).  The
engine always runs the contiguous whole-batch layout — the paged arena and
in-tick chunked prefill live in
:class:`~repro_torch.serving.scheduler.ContinuousBatchingScheduler`.  Model
calls run eagerly on the device that holds ``params``, under
``config.dispatch`` when one is given.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.registry import build_model
from ..obs import emit, metrics, trace_enabled
from .config import ServeConfig, check_servable, coerce_serve_config
from .request import Request


def logits_to_numpy(logits: torch.Tensor) -> np.ndarray:
    """(B, 1, V) logits of any dtype and device -> (B, V) float32 numpy."""
    return logits[:, 0].float().cpu().numpy()


def sample(rng: np.random.Generator, logits: np.ndarray, temperature: float) -> int:
    """Greedy at ``temperature <= 0``, else a draw from softmax(logits / T)."""
    if temperature <= 0:
        return int(np.argmax(logits))
    p = np.exp((logits - logits.max()) / temperature)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        config: Optional[ServeConfig] = None,
    ):
        check_servable(cfg)
        self.config = coerce_serve_config(config, "ServingEngine")
        sc = self.config
        self.cfg = cfg
        self.model = build_model(cfg)
        self.params = params
        self.device = params["embed"].device
        self.max_batch = sc.max_slots
        self.max_seq = sc.max_seq
        self.rng = np.random.default_rng(sc.seed)
        self.dispatch = sc.dispatch
        self._requests: List[Request] = []
        self.stats: Dict[str, float] = {
            "prefill_tokens": 0, "decode_steps": 0, "decode_tokens": 0,
            "prefill_s": 0.0, "decode_s": 0.0,
        }

    @property
    def prefill_tok_s(self) -> float:
        """Prompt tokens ingested per second of prefill wall-clock."""
        s = self.stats["prefill_s"]
        return self.stats["prefill_tokens"] / s if s > 0 else 0.0

    @property
    def decode_tok_s(self) -> float:
        """Tokens generated per second of decode-loop wall-clock."""
        s = self.stats["decode_s"]
        return self.stats["decode_tokens"] / s if s > 0 else 0.0

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               temperature: Optional[float] = None) -> Request:
        if temperature is None:
            temperature = self.config.temperature
        r = Request(len(self._requests), np.asarray(prompt, np.int32),
                    max_new_tokens, temperature)
        r._pump = self.run
        r.mark_submitted()
        self._requests.append(r)
        return r

    def run(self) -> List[Request]:
        """Serve all submitted requests in fixed-size batches.

        Batches whose requests already finished are skipped, so run() is
        re-entrant: the streaming ``Request.tokens()`` pump and late
        ``submit()`` + ``run()`` rounds only pay for unfinished work."""
        for i in range(0, len(self._requests), self.max_batch):
            batch = self._requests[i: i + self.max_batch]
            if all(r.done for r in batch):
                continue
            self._run_batch(batch)
        return self._requests

    def _dctx(self):
        from ..integration.dispatch import maybe_dispatch

        return maybe_dispatch(self.dispatch)

    def _run_batch(self, reqs: List[Request]) -> None:
        B = len(reqs)
        S = max(len(r.prompt) for r in reqs)
        prompts = np.zeros((B, S), np.int64)
        for j, r in enumerate(reqs):
            prompts[j, S - len(r.prompt):] = r.prompt  # left-pad
        cache = self.model.init_cache(B, self.max_seq, device=self.device)
        t0 = time.perf_counter()
        with torch.no_grad(), self._dctx():
            logits, cache = self.model.prefill(
                self.params, cache, torch.from_numpy(prompts).to(self.device)
            )
            logits = logits_to_numpy(logits)
        dt = time.perf_counter() - t0
        self.stats["prefill_s"] += dt
        self.stats["prefill_tokens"] += B * S
        m = metrics()
        m.inc("serve.prefill_tokens", B * S, model=self.cfg.name)
        m.observe("serve.prefill_s", dt, model=self.cfg.name)
        m.gauge("serve.prefill_tok_s", self.prefill_tok_s, model=self.cfg.name)
        if trace_enabled():
            emit(
                "serve.prefill",
                model=self.cfg.name,
                batch=B,
                tokens=B * S,
                dur_s=round(dt, 6),
                tok_s=round(B * S / dt, 3) if dt > 0 else None,
            )
        nxt = np.array(
            [sample(self.rng, logits[j], r.temperature) for j, r in enumerate(reqs)],
            np.int64,
        )
        now = time.perf_counter()
        for j, r in enumerate(reqs):
            r.generated.append(int(nxt[j]))
            r.first_token_s = now
            r.done = len(r.generated) >= r.max_new_tokens
        max_new = max(r.max_new_tokens for r in reqs)
        new_tokens = 0
        steps_run = 0
        t0 = time.perf_counter()
        for _ in range(max_new - 1):
            if all(r.done for r in reqs):
                break  # every request in flight finished: stop decoding
            t_step = time.perf_counter()
            with torch.no_grad(), self._dctx():
                logits, cache = self.model.decode_step(
                    self.params, cache, torch.from_numpy(nxt[:, None]).to(self.device)
                )
                la = logits_to_numpy(logits)
            self.stats["decode_steps"] += 1
            steps_run += 1
            m.observe(
                "serve.decode_step_s",
                time.perf_counter() - t_step,
                model=self.cfg.name,
            )
            nxt = np.array(
                [sample(self.rng, la[j], r.temperature) for j, r in enumerate(reqs)],
                np.int64,
            )
            for j, r in enumerate(reqs):
                if len(r.generated) < r.max_new_tokens:
                    r.generated.append(int(nxt[j]))
                    new_tokens += 1
                if len(r.generated) >= r.max_new_tokens:
                    r.done = True
        dt = time.perf_counter() - t0
        self.stats["decode_s"] += dt
        self.stats["decode_tokens"] += new_tokens
        m.inc("serve.decode_tokens", new_tokens, model=self.cfg.name)
        m.observe("serve.decode_s", dt, model=self.cfg.name)
        m.gauge("serve.decode_tok_s", self.decode_tok_s, model=self.cfg.name)
        if trace_enabled():
            emit(
                "serve.decode",
                model=self.cfg.name,
                batch=B,
                steps=steps_run,
                tokens=new_tokens,
                dur_s=round(dt, 6),
                tok_s=round(new_tokens / dt, 3) if dt > 0 else None,
            )
        now = time.perf_counter()
        for r in reqs:
            r.done = True
            if r.finish_s is None:
                r.finish_s = now

"""Deterministic, shardable, resumable synthetic token pipeline.

Counter-based PRNG keyed by (seed, step, shard) — any host can materialize
its shard of any step independently, which gives:

* determinism across restarts (fault tolerance: resume at step k reproduces
  exactly the batch a failed run would have seen),
* no inter-host coordination (each host generates only its shard),
* elastic rescale (shard count is an argument, not baked-in state).

A real deployment swaps `_tokens_for` for tokenized-corpus reads; the
step/shard addressing and resume semantics stay identical.

A copy of the JAX package's ``data/pipeline.py`` (which imports only
numpy), rewired to this package: ``batch_at(step)`` gives the same bytes.
The batches are numpy arrays; the trainer moves them to the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ModelConfig


@dataclass
class SyntheticTokenPipeline:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard_id: int = 0

    def __post_init__(self):
        assert self.global_batch % self.num_shards == 0
        self.local_batch = self.global_batch // self.num_shards

    def _rng(self, step: int) -> np.random.Generator:
        # counter-based: independent stream per (seed, step, shard)
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard_id])
        )

    def _tokens_for(self, step: int) -> np.ndarray:
        rng = self._rng(step)
        # zipfian-ish marginal so losses behave like text, not uniform noise
        v = self.cfg.vocab
        ranks = rng.zipf(1.3, size=(self.local_batch, self.seq_len + 1))
        return (ranks % v).astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        toks = self._tokens_for(step)
        if self.cfg.embedding_inputs:
            rng = self._rng(step)
            out = {
                "embeds": rng.standard_normal(
                    (self.local_batch, self.seq_len, self.cfg.d_model)
                ).astype(np.float32),
                "labels": toks[:, 1:].astype(np.int32)[:, : self.seq_len],
            }
        else:
            out = {"tokens": toks}
        if self.cfg.enc_layers:
            rng = self._rng(step)
            out["frames"] = rng.standard_normal(
                (self.local_batch, self.cfg.enc_frames, self.cfg.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        """Resume exactly where a checkpointed run left off."""
        while True:
            yield self.batch_at(step)
            step += 1

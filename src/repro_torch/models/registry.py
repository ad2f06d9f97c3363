"""Model facade: build a model from its config, init it, run its steps."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from . import transformer as T

Params = Dict[str, Any]


@dataclass
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device: str = "cuda") -> Params:
        return T.init_params(self.cfg, seed=seed, device=device)

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return T.forward(self.cfg, params, tokens)

    def init_cache(self, batch: int, max_seq: int, device: str = "cuda") -> Params:
        return T.init_cache(self.cfg, batch, max_seq, device=device)

    def cache_specs(self, batch: int, max_seq: int) -> Params:
        """The cache's shapes and dtypes, allocated on ``meta``."""
        return T.init_cache(self.cfg, batch, max_seq, device="meta")

    def prefill(self, params: Params, cache: Params, tokens: torch.Tensor):
        return T.prefill(self.cfg, params, cache, tokens)

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor):
        return T.decode_step(self.cfg, params, cache, tokens)

    def serve_step(self, params: Params, cache: Params, tokens, valid):
        return T.serve_step(self.cfg, params, cache, tokens, valid)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)

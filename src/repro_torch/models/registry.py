"""Model facade: build a model from its config, init it, run it forward."""

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


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)

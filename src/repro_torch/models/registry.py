"""Model facade: build a model from its config, init it, run its steps;
the specs of a forward's inputs and of a training batch, and a synthetic
batch.  The modality frontends are stubs, as in the reference: whisper
takes precomputed frame embeddings, qwen2-vl precomputed embeddings."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import transformer as T

Params = Dict[str, Any]


@dataclass
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device: str = "cuda") -> Params:
        return T.init_params(self.cfg, seed=seed, device=device)

    def param_specs(self) -> Params:
        """The parameters' shapes and dtypes, allocated on ``meta``."""
        return T.param_specs(self.cfg)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return T.loss_fn(self.cfg, params, batch)

    def forward(self, params: Params, tokens: Optional[torch.Tensor] = None,
                **inputs) -> torch.Tensor:
        return T.forward(self.cfg, params, tokens, **inputs)

    def init_cache(self, batch: int, max_seq: int, device: str = "cuda") -> Params:
        return T.init_cache(self.cfg, batch, max_seq, device=device)

    def cache_specs(self, batch: int, max_seq: int) -> Params:
        """The cache's shapes and dtypes, allocated on ``meta``."""
        return T.init_cache(self.cfg, batch, max_seq, device="meta")

    def prefill(self, params: Params, cache: Params,
                tokens: Optional[torch.Tensor] = None, **inputs):
        return T.prefill(self.cfg, params, cache, tokens, **inputs)

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor):
        return T.decode_step(self.cfg, params, cache, tokens)

    def serve_step(self, params: Params, cache: Params, tokens, valid):
        return T.serve_step(self.cfg, params, cache, tokens, valid)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The inputs of a (config x shape) cell's forward or prefill as
    ``meta`` tensors: ``embeds`` (B, S, D) bf16 for a model with embedding
    inputs, else ``tokens`` (B, S) int32, plus ``frames`` (B, enc_frames,
    D) bf16 for an encoder."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.embedding_inputs:
        ins = {"embeds": _spec((B, S, cfg.d_model), torch.bfloat16)}
    else:
        ins = {"tokens": _spec((B, S), torch.int32)}
    if cfg.enc_layers:
        ins["frames"] = _spec((B, cfg.enc_frames, cfg.d_model), torch.bfloat16)
    return ins


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The inputs of a (config x shape) cell's decode step as ``meta``
    tensors: one token a sequence, ``tokens`` (B, 1) int32."""
    return {"tokens": _spec((shape.global_batch, 1), torch.int32)}


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The training batch of a (config x shape) cell as ``meta`` tensors:
    ``tokens`` (B, S+1) int32, or ``embeds`` (B, S, D) bf16 with ``labels``
    (B, S) int32, plus ``frames`` (B, enc_frames, D) bf16 for an encoder."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.embedding_inputs:
        batch = {"embeds": _spec((B, S, cfg.d_model), torch.bfloat16),
                 "labels": _spec((B, S), torch.int32)}
    else:
        batch = {"tokens": _spec((B, S + 1), torch.int32)}
    if cfg.enc_layers:
        batch["frames"] = _spec((B, cfg.enc_frames, cfg.d_model), torch.bfloat16)
    return batch


def make_train_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                     device: str = "cuda") -> Dict[str, torch.Tensor]:
    """A concrete synthetic batch with :func:`train_batch_specs`' shapes,
    drawn by the reference's ``np.random.default_rng(seed)`` calls in its
    order, so the integers are the reference's."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B, S = shape.global_batch, shape.seq_len

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(dtype).to(dev)

    if cfg.embedding_inputs:
        batch = {"embeds": put(rng.standard_normal((B, S, cfg.d_model)), torch.bfloat16),
                 "labels": put(rng.integers(0, cfg.vocab, (B, S)), torch.int32)}
    else:
        batch = {"tokens": put(rng.integers(0, cfg.vocab, (B, S + 1)), torch.int32)}
    if cfg.enc_layers:
        batch["frames"] = put(rng.standard_normal((B, cfg.enc_frames, cfg.d_model)),
                              torch.bfloat16)
    return batch

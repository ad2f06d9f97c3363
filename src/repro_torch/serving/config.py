"""One config object for the whole serving tier.

:class:`ServeConfig` holds every knob of a serving session, as the tuning
tier's :class:`~repro_torch.search.tune.TuneConfig` does for tuning; it is
the one way in (``ServingEngine(cfg, params, config=ServeConfig(...))``):
this package has no loose-kwarg constructors.

The paged-serving knobs live here too: ``page_size`` (tokens per KV page),
``total_pages`` (page-pool capacity; admission is gated on free pages),
``prefill_chunk`` (prompt tokens processed per scheduler tick, interleaved
with live decode) and ``token_budget`` (the per-tick token quota split
between decode lanes and prefill chunks).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional


@dataclass
class ServeConfig:
    """One object for a whole serving session.

    ``max_slots`` bounds concurrent decode lanes.  ``paged=None``
    auto-enables the paged KV arena when the model supports it (pure
    attention decoder); ``page_size`` is snapped to a divisor of the cache
    length at arena construction.  ``prefill_chunk=0`` prefills each
    prompt whole (batch 1) outside the decode tick; ``>0`` streams prompts
    through the tick in chunks of at most that many tokens.
    ``token_budget=0`` resolves to ``max_slots + prefill_chunk``.
    ``total_pages=0`` sizes the pool for the worst case (``max_slots``
    full-length sequences) — smaller pools admit on free pages instead of
    free slots.  ``dispatch`` is an optional
    :class:`~repro_torch.integration.dispatch.DispatchContext` that every
    model call runs under.
    """

    max_slots: int = 4
    max_seq: int = 256
    paged: Optional[bool] = None
    page_size: int = 16
    total_pages: int = 0
    prefill_chunk: int = 32
    token_budget: int = 0
    temperature: float = 0.0
    seed: int = 0
    dispatch: Any = None

    def __post_init__(self):
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {self.max_seq}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.prefill_chunk < 0 or self.token_budget < 0:
            raise ValueError("prefill_chunk / token_budget must be >= 0")

    def resolved_for(self, cfg) -> "ServeConfig":
        """Effective config for a model: paged serving and in-tick chunked
        prefill need a pure-attention decoder (per-page ring writes and
        variable-width chunk steps have no SSD / encoder cross-attention
        path), so both are turned off elsewhere; ``paged=None`` becomes
        True where they are supported."""
        out = replace(self)
        if cfg.attn_free or cfg.ssm_state or cfg.enc_layers:
            out.paged = False
            out.prefill_chunk = 0
        elif out.paged is None:
            out.paged = True
        return out

    @property
    def tick_budget(self) -> int:
        return self.token_budget or (self.max_slots + self.prefill_chunk)


def check_servable(cfg) -> None:
    """Serving prefills each prompt from its tokens alone, as the
    reference's engine does (``prefill(params, cache, tokens)``); an
    encoder-decoder model (whisper) also needs its encoder's frames, which
    no request carries, so it is refused here rather than deep in the
    prefill."""
    if cfg.enc_layers:
        raise ValueError(
            f"{cfg.name}: serving prefills from tokens alone, and this "
            "encoder-decoder model needs the encoder's frames; call "
            "prefill(..., frames=) and decode_step directly"
        )


def coerce_serve_config(config, caller: str) -> ServeConfig:
    """A copy of ``config`` (a ServeConfig), or the defaults for None."""
    if isinstance(config, ServeConfig):
        return replace(config)
    if config is None:
        return ServeConfig()
    raise TypeError(
        f"{caller}() config must be a ServeConfig, got {type(config).__name__}"
    )

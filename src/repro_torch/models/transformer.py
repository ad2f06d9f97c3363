"""Decoder LM of every family the JAX package runs: dense (smollm,
stablelm, qwen1.5, gemma-2), mixture-of-experts (olmoe; arctic with its
dense residual MLP), state-space (mamba2), hybrid (hymba), the Qwen2-VL
backbone (M-RoPE, embedding inputs) and Whisper (an encoder stack, and
cross-attention in every decoder layer).

The port of the JAX package's ``models/transformer.py`` — ``forward``, the
training loss ``loss_fn`` and the serving functions ``init_cache``,
``prefill``, ``decode_step``, ``serve_step`` and ``page_view``: parameters
have the reference's names, shapes and dtypes, with layers stacked along a
leading L axis; the reference's ``lax.scan`` over the stack becomes a
Python loop over it, and the per-layer window reaches each layer as a
Python int, typed :class:`~.layers.TracedWindow` where the reference traces
it (an aperiodic window pattern).  A layer mixes with attention, the
Mamba-2 SSD mixer, or both summed (hymba), attends the encoder's output
(whisper), then runs its FFN:
the gated MLP, or the capacity-bounded top-k MoE (plus the MLP on the same
input with ``moe_dense_residual``), whose expert products dispatch through
``bmm_op``.  An attention-free model has no KV cache, only the (L, B, H, N,
P) f32 SSD state; an encoder-decoder model's cache adds the encoder's
cross-attention k/v (``xk``/``xv``).  The modality frontends are stubs, as
in the reference: qwen2-vl takes precomputed embeddings, whisper
precomputed frame embeddings.  The reference's activation sharding
constraints sit at its sites (``distributed/sharding.py:shard``, an
identity on values).
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import sharding as shd
from . import layers as L

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(
    cfg: ModelConfig, seed: int = 0, device: str = "cuda"
) -> Params:
    """Random parameters from a seeded ``torch.Generator``, with the
    reference's shapes and dtypes (bf16 weights, f32 norm scales).  The
    values differ from the reference's ``jax.random`` ones; to run both on
    the same weights convert the reference's with ``models/convert.py``.
    ``device="meta"`` allocates nothing."""
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    Ln, D = cfg.n_layers, cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    layers: Params = {"ln1": ones(Ln, D)}
    if not cfg.attn_free:
        layers["attn"] = L.attention_init(gen, cfg, device=dev, layers=Ln)
        if cfg.post_norms:
            layers["post_ln1"] = ones(Ln, D)
    if cfg.ssm_state:
        layers["ssd"] = L.ssd_init(gen, cfg, device=dev, layers=Ln)
    if cfg.d_ff:
        layers["ln2"] = ones(Ln, D)
        if cfg.moe_experts:
            layers["moe"] = L.moe_init(gen, cfg, device=dev, layers=Ln)
        if not cfg.moe_experts or cfg.moe_dense_residual:
            layers["mlp"] = L.mlp_init(gen, D, cfg.d_ff, device=dev, layers=Ln)
        if cfg.post_norms:
            layers["post_ln2"] = ones(Ln, D)
    if cfg.enc_layers:  # decoder cross-attention (whisper)
        layers["ln_x"] = ones(Ln, D)
        layers["xattn"] = L.attention_init(gen, cfg, device=dev, layers=Ln)
    params = {
        "embed": L.embed_init(gen, cfg.vocab, D, device=dev),
        "layers": layers,
        "final_ln": ones(D),
    }
    if cfg.enc_layers:
        El = cfg.enc_layers
        params["enc_layers"] = {
            "ln1": ones(El, D),
            "attn": L.attention_init(gen, cfg, device=dev, layers=El),
            "ln2": ones(El, D),
            "mlp": L.mlp_init(gen, D, cfg.d_ff, device=dev, layers=El),
        }
        params["enc_final_ln"] = ones(D)
    return params


def param_specs(cfg: ModelConfig) -> Params:
    """Parameter shapes and dtypes on ``meta`` (nothing allocated): the
    dry run's input."""
    return init_params(cfg, device="meta")


# ---------------------------------------------------------------------------
# Per-layer metadata (window pattern)
# ---------------------------------------------------------------------------


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """(L,) int32; 0 = global attention, >0 = sliding window size."""
    Ln = cfg.n_layers
    if cfg.alt_local_global and cfg.local_window:
        w = [(cfg.local_window if i % 2 == 0 else 0) for i in range(Ln)]
    elif cfg.hybrid and cfg.local_window:
        # hymba: global attention on first / middle / last layers
        glb = {0, Ln // 2, Ln - 1}
        w = [(0 if i in glb else cfg.local_window) for i in range(Ln)]
    elif cfg.local_window:
        w = [cfg.local_window] * Ln
    else:
        w = [0] * Ln
    return np.asarray(w, dtype=np.int32)


MAX_WINDOW_PERIOD = 4


def window_period(windows: np.ndarray, max_period: int = MAX_WINDOW_PERIOD):
    """Smallest period ``p <= max_period`` of the window pattern, or None.

    ``p`` divides the layer count and ``windows[i] == windows[i % p]`` for
    all i — uniform models give 1, gemma-2 local/global alternation 2.
    None (hymba at any depth over 4) means the reference traces the window
    through its layer scan; ``_windows`` marks such windows traced, and
    extraction and dispatch keep such a model's attention on the chunked
    path.
    """
    Ln = len(windows)
    for p in range(1, min(max_period, Ln) + 1):
        if Ln % p == 0 and all(
            int(windows[i]) == int(windows[i % p]) for i in range(Ln)
        ):
            return p
    return None


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of the stacked (L, ...) parameter tree."""
    return {
        k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()
    }


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------


def _text_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """(B, S) position ids as the rope takes them: (B, S, 3) with t = h = w
    (text tokens) under M-RoPE."""
    return torch.stack([pos, pos, pos], dim=-1) if cfg.mrope else pos


def _positions(cfg: ModelConfig, B: int, S: int, device, offset: int = 0) -> torch.Tensor:
    pos = offset + torch.arange(S, dtype=torch.int32, device=device)
    return _text_positions(cfg, pos.expand(B, S))


def _rope_q(cfg: ModelConfig, q: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    # q: (B, H, S, D); pos: (B, S) or (B, S, 3)
    if cfg.mrope:
        return L.apply_mrope(q, pos[:, None], theta=cfg.rope_theta)
    return L.apply_rope(q, pos[:, None], theta=cfg.rope_theta)


def _inputs(cfg: ModelConfig, params: Params, tokens, embeds) -> torch.Tensor:
    """The residual stream's input: ``embeds`` (B, S, D) in the config's
    dtype, or the scaled embedding of ``tokens``."""
    if embeds is not None:
        return embeds.to(_dtype(cfg))
    return L.embed(tokens, params["embed"]) * math.sqrt(cfg.d_model)


def _attn_full(cfg, p, x, pos, window: Optional[int], chunk=1024):
    B, S, _ = x.shape
    q, k, v = L.qkv_proj(p, x, cfg)
    hd_dims = (cfg.n_heads, cfg.n_kv_heads)
    q = shd.shard(q, "act_heads", hd_dims)
    k = shd.shard(k, "act_kv_heads", hd_dims)
    v = shd.shard(v, "act_kv_heads", hd_dims)
    q = _rope_q(cfg, q, pos)
    k = _rope_q(cfg, k, pos)
    out = L.chunked_attention(
        q, k, v,
        causal=True,
        window=window,
        softcap=cfg.attn_softcap,
        chunk=min(chunk, S),
    )
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return L.dense_op(out, p["wo"]), (k, v)


def _ffn(cfg: ModelConfig, p: Params, x):
    """The FFN half of a layer, with its residual: the MLP, or the MoE plus
    (arctic) the dense residual MLP on the same input.  Every serving
    column, padding included, is routed and takes expert capacity, as in
    the reference."""
    if cfg.d_ff:
        h2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        if cfg.moe_experts:
            f = L.moe(p["moe"], h2, cfg.moe_top_k, cfg.moe_capacity_factor,
                      act=cfg.act)
            if cfg.moe_dense_residual:
                f = f + L.mlp(p["mlp"], h2, cfg.act)
        else:
            f = L.mlp(p["mlp"], h2, cfg.act)
        if cfg.post_norms:
            f = L.rmsnorm(f, p["post_ln2"], cfg.norm_eps)
        x = x + f
    return x


def _layer_fwd(cfg: ModelConfig, p: Params, x, pos, window: Optional[int],
               collect_state: bool = False, ssd_backend: str = "cuda",
               cross_fn=None):
    """One decoder layer: mixer (attention and/or SSD, summed) →
    cross-attention (``cross_fn``, whisper) → FFN, each with a residual.
    Returns the new residual, the layer's post-rope (k, v), (B, KVH, S,
    D), or None without attention, with ``collect_state`` the SSD state
    after the sequence (else None), and the cross-attention's (k, v) of the
    encoder output (else None)."""
    h = shd.shard(L.rmsnorm(x, p["ln1"], cfg.norm_eps), "residual")
    mix, kv, state = None, None, None
    if not cfg.attn_free:
        mix, kv = _attn_full(cfg, p["attn"], h, pos, window)
        if cfg.post_norms:
            mix = L.rmsnorm(mix, p["post_ln1"], cfg.norm_eps)
    if cfg.ssm_state:
        if collect_state:
            s, state = L.ssd_mixer_with_state(p["ssd"], h, cfg, backend=ssd_backend)
        else:
            s = L.ssd_mixer(p["ssd"], h, cfg, backend=ssd_backend)
        mix = s if mix is None else mix + s
    x = x + mix
    xkv = None
    if cross_fn is not None:  # whisper: cross-attention between mixer and FFN
        xo, xkv = cross_fn(p["xattn"], L.rmsnorm(x, p["ln_x"], cfg.norm_eps))
        x = x + xo
    return shd.shard(_ffn(cfg, p, x), "residual"), kv, state, xkv


def _encoder(cfg: ModelConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings (B, F, D): per
    layer, non-causal self-attention with rope on the frame positions, then
    the MLP, each with a residual; the final norm."""
    x = frames.to(_dtype(cfg))
    B, Fr, _ = x.shape
    pos = _positions(cfg, B, Fr, x.device)
    for i in range(cfg.enc_layers):
        p = _layer(params["enc_layers"], i)
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_proj(p["attn"], h, cfg)
        q, k = _rope_q(cfg, q, pos), _rope_q(cfg, k, pos)
        o = L.chunked_attention(q, k, v, causal=False, chunk=min(1024, Fr))
        o = o.transpose(1, 2).reshape(B, Fr, cfg.n_heads * cfg.head_dim)
        x = x + L.dense_op(o, p["attn"]["wo"])
        x = x + L.mlp(p["mlp"], L.rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.act)
    return L.rmsnorm(x, params["enc_final_ln"], cfg.norm_eps)


def _cross_q(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    q = L._einsum("bsd,dh->bsh", x, p["wq"])
    return q.reshape(B, S, cfg.n_heads, cfg.head_dim).transpose(1, 2)


def _cross_attn(cfg: ModelConfig, p: Params, x: torch.Tensor, enc_out: torch.Tensor):
    """Cross-attention of the decoder rows x (B, S, D) over the encoder
    output (B, F, D), no rope, no mask.  The reference projects q, k and v
    with a plain ``jnp.einsum``, not ``dense_op``, so they run the plain
    product here too (extraction still finds their ``dense`` sites); only
    ``wo`` is a dispatch point.  S != F, so the attention keeps the chunked
    path, whose contractions go through ``bmm_op``.  Returns the output and
    the frames' (k, v), (B, KVH, F, D)."""
    B, S, _ = x.shape
    Fr = enc_out.shape[1]
    KVH, hd = cfg.n_kv_heads, cfg.head_dim
    q = _cross_q(cfg, p, x)
    k = L._einsum("bfd,dh->bfh", enc_out, p["wk"]).reshape(B, Fr, KVH, hd).transpose(1, 2)
    v = L._einsum("bfd,dh->bfh", enc_out, p["wv"]).reshape(B, Fr, KVH, hd).transpose(1, 2)
    o = L.chunked_attention(q, k, v, causal=False, chunk=min(1024, Fr))
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * hd)
    return L.dense_op(o, p["wo"]), (k, v)


def _cross_fn(cfg: ModelConfig, params: Params, frames: Optional[torch.Tensor]):
    """Whisper: run the encoder over ``frames`` once, and return each
    decoder layer's cross-attention over its output; None for a
    decoder-only model."""
    if not cfg.enc_layers:
        return None
    if frames is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder model needs frames")
    enc_out = _encoder(cfg, params, frames)
    return partial(_cross_attn, cfg, enc_out=enc_out)


def forward(
    cfg: ModelConfig, params: Params, tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None, frames: Optional[torch.Tensor] = None,
    ssd_backend: str = "cuda", remat: bool = False,
) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V), from ``tokens`` (B, S) or
    precomputed ``embeds`` (B, S, D), plus the encoder's ``frames`` (B, F,
    D) for whisper.  ``ssd_backend`` is the SSD scan's ``kernels/ops.py``
    backend: ``cuda`` (K7 for CUDA tensors, the plain version for CPU ones)
    or ``torch`` (the plain version).  ``remat`` keeps only each decoder
    layer's input for backward and recomputes the layer there (the
    reference's ``nothing_saveable`` checkpoint); the encoder, the final
    norm and the unembed are not recomputed."""
    x = shd.shard(_inputs(cfg, params, tokens, embeds), "residual")
    B, S, _ = x.shape
    pos = _positions(cfg, B, S, x.device)
    cross = _cross_fn(cfg, params, frames)
    windows = _windows(cfg)
    for i in range(cfg.n_layers):
        layer = partial(_layer_out, cfg, _layer(params["layers"], i), pos=pos,
                        window=windows[i], ssd_backend=ssd_backend, cross_fn=cross)
        x = _recomputed(layer, x) if remat else layer(x)
    return shd.shard(_logits(cfg, params, x), "logits")


def _layer_out(cfg, p, x, pos, window, ssd_backend, cross_fn):
    return _layer_fwd(cfg, p, x, pos, window, ssd_backend=ssd_backend,
                      cross_fn=cross_fn)[0]


def _recomputed(layer, x):
    """``layer(x)`` under non-reentrant activation checkpointing, with the
    DispatchContext and the mesh active now re-entered while backward
    recomputes it.  Both are thread-local, and autograd runs the backward
    of CUDA tensors on a thread of its own, where neither is set: the
    recompute would take another path (the plain one, or the global keys
    instead of the per-shard ones), save other tensors than the forward did
    and fail checkpoint's check (the reference captures both when it
    traces)."""
    ctx, mesh = L._dispatch_ctx(), shd.get_mesh()

    def run(x):
        with ctx if ctx is not None else nullcontext(), shd.use_mesh(mesh):
            return layer(x)

    return checkpoint(run, x, use_reentrant=False)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            ssd_backend: str = "cuda") -> torch.Tensor:
    """Next-token cross entropy, in f32, of ``batch["tokens"]`` (B, S+1):
    the forward with ``remat`` on ``tokens[:, :-1]`` against
    ``tokens[:, 1:]``; or of a ``{"embeds": (B, S, D), "labels": (B, S)}``
    batch, the forward on the embeddings against the labels.  Whisper's
    batches add the encoder's ``frames``."""
    frames = batch.get("frames")
    if "tokens" in batch:
        tokens = batch["tokens"]
        logits = forward(cfg, params, tokens[:, :-1], frames=frames,
                         ssd_backend=ssd_backend, remat=True)
        labels = tokens[:, 1:]
    else:
        logits = forward(cfg, params, embeds=batch["embeds"], frames=frames,
                         ssd_backend=ssd_backend, remat=True)
        labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    return -torch.gather(logp, -1, labels[..., None])[..., 0].mean()


def _logits(cfg: ModelConfig, params: Params, x):
    return _unembed(cfg, params, L.rmsnorm(x, params["final_ln"], cfg.norm_eps))


def _unembed(cfg: ModelConfig, params: Params, x):
    logits = L.unembed(x, params["embed"])
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _windows(cfg: ModelConfig) -> List[Optional[int]]:
    """Each layer's window as the attention hooks take it: an int (None =
    global) where the pattern has a period, as the reference closes it over
    its scan body; otherwise a :class:`~.layers.TracedWindow` for every
    layer, globals included, where the reference traces it through the
    scan."""
    windows = layer_windows(cfg)
    if window_period(windows) is None:
        return [L.TracedWindow(int(w)) for w in windows]
    return [int(w) or None for w in windows]


# ---------------------------------------------------------------------------
# KV cache (serving)
# ---------------------------------------------------------------------------
#
# The reference's serving functions are pure and return new cache arrays.
# Here ``decode_step`` and ``serve_step`` write each token's K/V, and
# ``decode_step`` the new SSD state, into the cache tensors in place (one
# copy of the cache per tick saved); the cache dict they return holds the
# same tensors and the new positions.


def cache_max_len(cfg: ModelConfig, max_seq: int) -> int:
    """Per-layer cache length: a sliding-window layer needs only its window
    (a ring buffer), a global layer the full context; the stacked cache
    takes the longest.  An attention-free model has none (0)."""
    if cfg.attn_free:
        return 0
    windows = np.asarray(layer_windows(cfg))
    return int(max(np.where(windows > 0, np.minimum(windows, max_seq), max_seq)))


def init_cache(
    cfg: ModelConfig, batch: int, max_seq: int, device: str = "cuda"
) -> Params:
    """Decode cache: the scalar position ``pos``; with attention ``k``/``v``
    of (L, batch, KVH, kv_len, D) in the config's dtype; with an SSD mixer
    its ``state`` of (L, batch, H, N, P) in f32, whose size does not grow
    with the context; with an encoder the cross-attention's ``xk``/``xv``
    of (L, batch, KVH, enc_frames, D), which ``prefill`` fills and decoding
    only reads.  ``device="meta"`` allocates nothing."""
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    dt = _dtype(cfg)
    cache: Params = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if not cfg.attn_free:
        kv_len = cache_max_len(cfg, max_seq)
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, kv_len, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
    if cfg.ssm_state:
        cache["state"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
            dtype=torch.float32, device=dev,
        )
    if cfg.enc_layers:
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.enc_frames, cfg.head_dim)
        cache["xk"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["xv"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def prefill(
    cfg: ModelConfig, params: Params, cache: Params,
    tokens: Optional[torch.Tensor] = None, embeds: Optional[torch.Tensor] = None,
    frames: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Params]:
    """Process the prompt (``tokens`` or ``embeds``, and whisper's
    ``frames``), fill the cache, return last-position logits (B, 1, V) and
    the new cache (positions ``0..S-1`` written, the SSD state after the
    prompt, the encoder output's cross-attention k/v, ``pos = S``).  The SSD
    mixer scans in chunks of ``min(64, S)``, which must divide S, as in the
    reference: a prompt longer than 64 tokens must be a multiple of 64."""
    x = _inputs(cfg, params, tokens, embeds)
    B, S, _ = x.shape
    pos = _positions(cfg, B, S, x.device)
    cross = _cross_fn(cfg, params, frames)
    windows = _windows(cfg)
    kv_len = cache["k"].shape[3] if "k" in cache else 0
    if kv_len and kv_len < S and S % kv_len:
        # the ring-buffer handoff assumes slot p % kv_len alignment
        raise ValueError(
            f"prefill of {S} tokens into a ring cache of {kv_len}: S must be "
            "a multiple of the cache length"
        )
    ks, vs, states, xks, xvs = [], [], [], [], []
    for i in range(cfg.n_layers):
        x, kv, state, xkv = _layer_fwd(cfg, _layer(params["layers"], i), x, pos,
                                       windows[i], collect_state=True,
                                       cross_fn=cross)
        if kv is not None:
            k, v = kv
            if kv_len < S:
                k, v = k[:, :, -kv_len:], v[:, :, -kv_len:]
            elif kv_len > S:
                k = F.pad(k, (0, 0, 0, kv_len - S))
                v = F.pad(v, (0, 0, 0, kv_len - S))
            ks.append(k)
            vs.append(v)
        if state is not None:
            states.append(state)
        if xkv is not None:
            xks.append(xkv[0])
            xvs.append(xkv[1])
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = L.unembed(x[:, -1:], params["embed"])
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    new_cache = dict(cache)
    if ks:
        new_cache["k"], new_cache["v"] = torch.stack(ks), torch.stack(vs)
    if states:
        new_cache["state"] = torch.stack(states)
    if xks:
        new_cache["xk"], new_cache["xv"] = torch.stack(xks), torch.stack(xvs)
    new_cache["pos"] = torch.tensor(S, dtype=torch.int32, device=x.device)
    return logits, new_cache


def page_view(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather one layer's page pool through the page table.

    ``pool`` is ``(n_pages, KVH, page_size, D)``; ``table`` is ``(B, P)``
    physical page ids, where the sentinel ``n_pages`` (one past the pool)
    marks unallocated entries.  JAX's gather clamps that index to the last
    page and PyTorch indexing would raise, so it is clamped here; the page
    is never attended to, because the per-slot length mask only exposes
    positions the slot wrote.  Returns a ``(B, KVH, P * page_size, D)``
    contiguous-looking cache view, so attention (and its ``attention_decode``
    key, static in ``T = P * page_size``) is the slot-pool layout's."""
    B, P = table.shape
    n_pages, KVH, ps, D = pool.shape
    g = pool[torch.clamp(table.long(), max=n_pages - 1)]  # (B, P, KVH, ps, D)
    return g.permute(0, 2, 1, 3, 4).reshape(B, KVH, P * ps, D)


def _live_columns(keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lane, column) index pairs where ``keep`` (B, C) is true.  On meta
    tensors (task extraction) the mask has no data: every column counts."""
    if keep.device.type == "meta":
        B, C = keep.shape
        lanes = torch.arange(B, device=keep.device).repeat_interleave(C)
        return lanes, torch.arange(C, device=keep.device).repeat(B)
    return keep.nonzero(as_tuple=True)


def _decode_layer(cfg, p, x, pos, window, write_kv, length, state=None,
                  cross=None):
    """One layer of a cache step: with attention, project, rope,
    ``write_kv(k1, v1)`` into the cache (which returns the (K, V) view to
    attend) and attend against the cache; with an SSD mixer, one step of
    its recurrence from ``state``; with ``cross`` (whisper: the layer's
    ``xk``, ``xv`` and the encoder's frame count), attend the encoder's
    cached k/v; then the FFN.  Returns the new residual and the new SSD
    state (None without one)."""
    B, C, _ = x.shape
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    mix = None
    if not cfg.attn_free:
        q, k1, v1 = L.qkv_proj(p["attn"], h, cfg)
        q = _rope_q(cfg, q, pos)
        k1 = _rope_q(cfg, k1, pos)
        k_view, v_view = write_kv(k1, v1)
        a = L.decode_attention(
            q, k_view, v_view, length=length, window=window,
            softcap=cfg.attn_softcap,
        )
        a = a.transpose(1, 2).reshape(B, C, cfg.n_heads * cfg.head_dim)
        mix = L.dense_op(a, p["attn"]["wo"])
        if cfg.post_norms:
            mix = L.rmsnorm(mix, p["post_ln1"], cfg.norm_eps)
    if cfg.ssm_state:
        s, state = L.ssd_decode_step(p["ssd"], h, state, cfg)
        mix = s if mix is None else mix + s
    x = x + mix
    if cross is not None:
        xk, xv, n_frames = cross
        q = _cross_q(cfg, p["xattn"], L.rmsnorm(x, p["ln_x"], cfg.norm_eps))
        a = L.decode_attention(q, xk, xv, length=n_frames)
        a = a.transpose(1, 2).reshape(B, C, cfg.n_heads * cfg.head_dim)
        x = x + L.dense_op(a, p["xattn"]["wo"])
    return _ffn(cfg, p, x), state


def serve_step(
    cfg: ModelConfig,
    params: Params,
    cache: Params,
    tokens: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, Params]:
    """One serving tick: decode lanes and prefill chunks in one program.

    ``tokens`` is ``(B, C)`` — lane ``b`` contributes its next ``valid[b]``
    tokens this tick (a decode lane has ``valid == 1`` with its sampled
    token in column 0; a prefilling lane carries up to ``C`` prompt tokens;
    an idle lane has ``valid == 0`` and touches nothing).  Returns logits
    ``(B, 1, V)`` taken at each lane's last valid position plus the cache,
    with ``cache["pos"]`` advanced by ``valid``.

    The cache may be contiguous (``(L, B, KVH, kv_len, D)`` lanes, the
    ``KVArena`` layout) or paged (``(L, n_pages, KVH, page_size, D)`` pools
    plus ``cache["page_table"]`` ``(B, P)``, the ``PagedKVArena`` layout).
    The reference scatters every column and lets JAX drop the invalid ones
    (``mode="drop"``); PyTorch would raise on such an index, so only the
    valid columns are written — and, paged, only those whose page-table
    entry is a real page — so an idle lane can never touch a page owned by
    a live request.  Only pure-attention decoders are supported, as in the
    reference: an SSD state and encoder cross-attention have no
    variable-width chunk step, and ``ServeConfig.resolved_for`` routes
    those models to ``decode_step``."""
    if cfg.attn_free or cfg.ssm_state or cfg.enc_layers:
        raise NotImplementedError(
            "serve_step needs a pure-attention decoder; use decode_step"
        )
    x = L.embed(tokens, params["embed"]) * math.sqrt(cfg.d_model)
    B, C = tokens.shape
    dev = x.device
    pos_vec = cache["pos"].to(torch.int32)  # (B,)
    valid = torch.as_tensor(valid, device=dev).to(torch.int32)
    cols = torch.arange(C, dtype=torch.int32, device=dev)
    pos_mat = pos_vec[:, None] + cols[None, :]  # (B, C)
    paged = "page_table" in cache
    if paged:
        table = cache["page_table"]
        n_pages, _, ps, _ = cache["k"].shape[1:]
        kv_len = table.shape[1] * ps
    else:
        kv_len = cache["k"].shape[3]
    wp = (pos_mat % kv_len).long()  # (B, C) ring write positions
    keep = cols[None, :] < valid[:, None]
    if paged:
        phys = torch.gather(table.long(), 1, wp // ps)  # (B, C)
        keep = keep & (phys < n_pages)
        lanes, cs = _live_columns(keep)
        rows, offs = phys[lanes, cs], (wp % ps)[lanes, cs]
    else:
        lanes, cs = _live_columns(keep)
        rows, offs = lanes, wp[lanes, cs]
    length = torch.clamp(pos_vec + 1, max=kv_len)
    windows = _windows(cfg)
    for i in range(cfg.n_layers):
        K, V = cache["k"][i], cache["v"][i]

        def write_kv(k1, v1, K=K, V=V):
            # (B, KVH, C, D) -> the live (lane, column) rows, (N, KVH, D)
            K[rows, :, offs] = k1.transpose(1, 2)[lanes, cs].to(K.dtype)
            V[rows, :, offs] = v1.transpose(1, 2)[lanes, cs].to(V.dtype)
            if paged:
                return page_view(K, table), page_view(V, table)
            return K, V

        x, _ = _decode_layer(cfg, _layer(params["layers"], i), x,
                             _text_positions(cfg, pos_mat), windows[i], write_kv,
                             length)
    # the final norm over every column (the reference's order: its rmsnorm
    # key is at tokens = B·C), then each lane's last valid position; the
    # gather before the unembed keeps the dense workload key at m = B
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    idx = torch.clamp(valid - 1, 0, C - 1).long()
    x_last = torch.gather(x, 1, idx[:, None, None].expand(B, 1, x.shape[-1]))
    logits = _unembed(cfg, params, x_last)
    new_cache = dict(cache)
    new_cache["pos"] = pos_vec + valid
    return logits, new_cache


def decode_step(
    cfg: ModelConfig, params: Params, cache: Params, tokens: torch.Tensor
) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1) -> logits (B, 1, V), cache.

    ``cache["pos"]`` is either a scalar — every lane at the same position,
    the batch-engine layout — or a per-slot ``(B,)`` vector, the
    continuous-batching arena layout where each slot advances on its own
    (writes land at per-lane ring slots, attention masks to per-lane
    lengths).  An SSD layer advances its slice of ``cache["state"]`` by one
    step of the recurrence, in place; whisper's cross-attention attends all
    ``enc_frames`` positions of ``cache["xk"]``/``["xv"]``."""
    x = L.embed(tokens, params["embed"]) * math.sqrt(cfg.d_model)
    B = x.shape[0]
    p_now = cache["pos"]
    per_slot = p_now.ndim > 0
    pos_vec = (p_now if per_slot else p_now.expand(B)).to(torch.int32)
    kv_len = cache["k"].shape[3] if "k" in cache else 0
    write_kv = length = None
    if kv_len:
        slots = (pos_vec % kv_len).long()
        lanes = torch.arange(B, device=x.device)
        length = torch.clamp(pos_vec + 1, max=kv_len)
    n_frames = torch.tensor(cfg.enc_frames, device=x.device) if cfg.enc_layers else None
    pos = _text_positions(cfg, pos_vec[:, None])
    windows = _windows(cfg)
    for i in range(cfg.n_layers):
        if kv_len:
            K, V = cache["k"][i], cache["v"][i]

            def write_kv(k1, v1, K=K, V=V):
                if per_slot:  # each arena slot writes at its own ring position
                    K[lanes, :, slots] = k1[:, :, 0].to(K.dtype)
                    V[lanes, :, slots] = v1[:, :, 0].to(V.dtype)
                else:
                    K.index_copy_(2, slots[:1], k1.to(K.dtype))
                    V.index_copy_(2, slots[:1], v1.to(V.dtype))
                return K, V

        state = cache["state"][i] if "state" in cache else None
        cross = (cache["xk"][i], cache["xv"][i], n_frames) if cfg.enc_layers else None
        x, state = _decode_layer(cfg, _layer(params["layers"], i), x, pos,
                                 windows[i], write_kv, length, state, cross)
        if state is not None:
            cache["state"][i].copy_(state)
    logits = _logits(cfg, params, x)
    new_cache = dict(cache)
    new_cache["pos"] = p_now + 1
    return logits, new_cache

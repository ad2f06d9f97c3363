"""AdamW with warmup+cosine schedule, global-norm clipping, and an optional
int8 gradient-compression hook, on dicts of tensors.

The port of the JAX package's ``training/optimizer.py``, with its
arithmetic in its order (not ``torch.optim.AdamW``: the clipping, the
schedule and the compression hook sit around the update).  Optimizer state
is a tree congruent with params (fp32 m/v) plus an int32 ``step``.  The
update is pure, as the reference's: it returns new parameter and state
trees and leaves its inputs as they are.  ``compress_gradients`` draws its
noise from an explicit ``torch.Generator`` where the reference splits a
``jax.random`` key, so the two packages' noise differs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

Tree = Any


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_bits: int = 0  # 0 = off; 8 = int8 stochastic-rounding grads


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves of a tree of dicts, keys in sorted order (JAX's order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, *trees: Tree) -> Tree:
    """``fn`` over the leaves of trees of one structure, keys in sorted order."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(trees[0])}
    return fn(*trees)


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor or an int): linear
    warmup, then a cosine from ``lr`` down to ``0.1·lr``, in f32."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps).float() / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(params: Tree) -> Dict[str, Any]:
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def compress_gradients(grads: Tree, bits: int, gen: torch.Generator) -> Tree:
    """Simulated gradient compression: per-tensor absmax int-N quantization
    with stochastic rounding, the noise drawn from ``gen`` (on the
    gradients' device), leaf after leaf in sorted key order."""
    if bits <= 0:
        return grads
    qmax = float(2 ** (bits - 1) - 1)

    def q(x):
        xf = x.float()
        scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / qmax
        y = xf / scale
        noise = torch.rand(y.shape, generator=gen, device=y.device) - 0.5
        y = torch.clamp(torch.round(y + noise), -qmax, qmax)
        return (y * scale).to(x.dtype)

    return tree_map(q, grads)


def seeded_generator(device, seed: int = 0) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` — the
    counterpart of the reference's ``jax.random.PRNGKey(seed)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


@torch.no_grad()
def adamw_update(
    cfg: OptConfig,
    grads: Tree,
    opt_state: Dict[str, Any],
    params: Tree,
    compress_gen: Optional[torch.Generator] = None,
) -> Tuple[Tree, Dict[str, Any]]:
    """One AdamW step: the new parameters (in their dtypes) and state.
    ``compress_gen`` feeds ``compress_gradients`` when ``compress_bits`` is
    on; without one, a generator seeded 0 (the reference's default key)."""
    step = opt_state["step"] + 1
    if cfg.compress_bits:
        if compress_gen is None:
            compress_gen = seeded_generator(step.device)
        grads = compress_gradients(grads, cfg.compress_bits, compress_gen)
    gn = global_norm(grads)
    # clip_norm / gn as a division: a scalar over a tensor in PyTorch is
    # a reciprocal and a product, which rounds otherwise
    clip = torch.full_like(gn, cfg.clip_norm) / torch.clamp(gn, min=1e-12)
    scale = torch.clamp(clip, max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=gn.device), step.float())
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=gn.device), step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2), "step": step}


def _pick(tree: Tree, i: int) -> Tree:
    """Element ``i`` of each tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]

"""Train-step factory: loss and gradient, microbatch accumulation, AdamW.

The port of the JAX package's ``training/train_loop.py``.  The gradient is
``torch.autograd.grad`` over the parameter leaves (not ``torch.func``:
dispatch's kernel Functions are old-style ``autograd.Function``s, which
its transforms refuse).  Microbatching is a Python loop summing the
gradients in f32, as the reference's ``lax.scan``; remat is applied per
layer inside the model (``transformer.loss_fn``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..models.registry import Model
from .optimizer import OptConfig, adamw_update, seeded_generator, tree_leaves, tree_map

Tree = Any


def value_and_grad(loss_fn: Callable, params: Tree, batch: Dict) -> Tuple[torch.Tensor, Tree]:
    """``loss_fn(params, batch)`` and its gradient with respect to every
    leaf of ``params`` (zeros for a leaf the loss does not reach), each in
    its leaf's dtype.  ``params`` is left as it is."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
    return loss.detach(), tree_map(lambda _: next(it), live)


def make_train_step(
    model: Model,
    opt_cfg: OptConfig,
    num_microbatches: int = 1,
    dispatch=None,  # Optional[repro_torch.integration.dispatch.DispatchContext]
) -> Callable:
    """Build ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss": loss})``; the batch's tensors are on the parameters' device.

    ``dispatch``: an optional tuned-kernel DispatchContext, entered around
    the loss and gradient; tuned kernels run forward, and their gradients
    are the autograd of the plain versions."""

    def _dctx():
        from ..integration.dispatch import maybe_dispatch

        return maybe_dispatch(dispatch)

    def train_step(params: Tree, opt_state: Dict, batch: Dict):
        device = tree_leaves(params)[0].device
        if num_microbatches <= 1:
            with _dctx():
                loss, grads = value_and_grad(model.loss, params, batch)
        else:
            n = num_microbatches
            micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(n):
                with _dctx():
                    l, g = value_and_grad(model.loss, params,
                                          {k: v[i] for k, v in micro.items()})
                grads = tree_map(lambda a, b: a + b.to(a.dtype), grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
        new_params, new_opt = adamw_update(
            opt_cfg, grads, opt_state, params,
            compress_gen=seeded_generator(device) if opt_cfg.compress_bits else None,
        )
        return new_params, new_opt, {"loss": loss}

    return train_step


def make_eval_step(model: Model) -> Callable:
    def eval_step(params: Tree, batch: Dict):
        with torch.no_grad():
            return model.loss(params, batch)

    return eval_step

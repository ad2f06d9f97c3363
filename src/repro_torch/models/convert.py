"""Carry the JAX package's parameters across to the port.

``params_from_jax`` maps the reference's stacked-layer parameter tree, with
numpy arrays at the leaves (``np.asarray`` of each JAX array), to the
port's parameter dict under the same names.  numpy itself has no bf16, so a
bf16 leaf (whose dtype JAX registers with numpy as ``bfloat16``) goes
through float32, which holds every bf16 value exactly, and back to
``torch.bfloat16``.  This module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def params_from_jax(tree: Dict[str, Any], device: str = "cpu") -> Dict[str, Any]:
    """Port parameters from the reference's tree of numpy arrays."""
    return {
        k: (params_from_jax(v, device) if isinstance(v, dict) else _leaf(v, device))
        for k, v in tree.items()
    }

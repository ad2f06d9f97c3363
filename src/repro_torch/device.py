"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default.  Asking for the card
where CUDA is absent raises: the port never carries on silently on the
CPU.  Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev

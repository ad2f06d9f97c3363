"""Mesh definitions: the production meshes (abstract), a mesh of given
shape over cards, and the host's cards.

Functions, not module-level constants: importing this module touches no
device.  Every mesh is a :class:`repro_torch.distributed.sharding.Mesh`.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..device import resolve_device
from ..distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 chips per pod; 2 pods = 512 chips multi-pod.  Abstract
    (no devices): enough for every spec and for the dry run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(None, axes, shape)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None, device: str = "cuda") -> Mesh:
    """A mesh of ``shape`` named ``axes``.  Without ``devices`` each
    coordinate takes a distinct card of type ``device`` (``cuda:0``,
    ``cuda:1``, ...; raises when there are too few); ``devices`` (one per
    coordinate, row-major) may repeat a device, so a logical mesh fits on
    one card."""
    import numpy as np
    import torch

    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            have = torch.cuda.device_count()
            if have < n:
                raise RuntimeError(
                    f"a {shape} mesh needs {n} distinct cards, {have} visible; "
                    "pass devices= to place several coordinates on one card"
                )
            devices = [torch.device("cuda", i) for i in range(n)]
        elif n == 1:
            devices = [dev]
        else:
            raise RuntimeError(f"a {shape} mesh needs {n} distinct {dev.type} devices; "
                               "pass devices= to repeat one")
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a {shape} mesh")
    for d in devices:
        resolve_device(d)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), tuple(axes))


def make_host_mesh(device: str = "cuda") -> Mesh:
    """A (1, n) ("data", "model") mesh over this host's devices: the
    visible cards (n = ``torch.cuda.device_count()``), or the one CPU."""
    import torch

    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return make_mesh((1, n), ("data", "model"), device=device)

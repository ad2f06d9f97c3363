"""Numpy checkpointing with atomic commit, on the JAX package's layout.

Layout:
    <dir>/step_<k>/
        manifest.json        # tree paths, shapes, dtypes, step, extra
        arr_<i>.npy          # one file per leaf: its raw bytes as uint8
    <dir>/LATEST             # atomic pointer (rename) — crash-safe commit

The port of the JAX package's ``training/checkpoint.py``, byte for byte
on disk: a checkpoint written by either package restores in the other.
The reference names each leaf's dtype as numpy does (``"float32"``,
``"bfloat16"``) and reads bf16 back through ``ml_dtypes``; here the names
map to ``torch`` dtypes and the raw bytes are viewed as the dtype.  Save
is atomic: a crash mid-save never corrupts LATEST; ``gc_old`` keeps the
last few steps.  ``restore`` places every leaf on one explicit device, or
on its sharding's device (``shardings``, a tree of ``NamedSharding`` on a
mesh of one card, which may hold it at several coordinates): each leaf's
shape is first checked against its spec.  Placing a leaf's blocks across
several cards waits for the multi-card mesh (``ROADMAP.md``, Queue 1) and
raises.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

Tree = Any

# the manifest's dtype names (numpy's, as the reference writes them)
DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def _flatten_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree.keys()):
            out += _flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def _unflatten_from_paths(pairs: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in pairs.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def save(ckpt_dir: str, step: int, tree: Tree, extra: Optional[Dict] = None) -> str:
    """Atomically write a checkpoint of a tree of tensors for ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = _flatten_with_paths(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_")
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (path, leaf) in enumerate(leaves):
        t = torch.as_tensor(leaf).detach().cpu().contiguous()
        fn = f"arr_{i}.npy"
        raw = t.reshape(-1).view(torch.uint8).numpy()
        np.save(os.path.join(tmp, fn), raw)
        manifest["leaves"].append(
            {"path": path, "file": fn, "shape": list(t.shape), "dtype": _NAMES[t.dtype]}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    # atomic LATEST pointer
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(str(step))
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _mesh_device(mesh) -> torch.device:
    """The one card a mesh lives on; raises for a mesh across cards."""
    devs = mesh.distinct_devices()
    if len(devs) > 1:
        raise NotImplementedError(
            f"{mesh} spans {len(devs)} devices ({', '.join(map(str, devs))}); "
            "placing a checkpoint's shards across cards is the multi-card mesh "
            "item of ROADMAP.md (Queue 1)"
        )
    return resolve_device(devs[0])


def _place(t: torch.Tensor, sharding, path: str) -> torch.Tensor:
    """``t`` on ``sharding``'s device once its spec fits ``t``'s shape."""
    try:
        sharding.shard_shape(t.shape)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return t.to(_mesh_device(sharding.mesh))


def restore(
    ckpt_dir: str,
    step: Optional[int] = None,
    device: str = "cuda",
    mesh=None,
    shardings: Optional[Tree] = None,
) -> Tuple[int, Tree, Dict]:
    """Load a checkpoint (the LATEST one without ``step``): (step, tree of
    tensors, extra).  A leaf with a sharding in ``shardings`` (a tree of
    ``NamedSharding`` matching the checkpoint's paths) goes to that
    sharding's device; every other leaf to ``mesh``'s device when a mesh is
    given, else to ``device``."""
    dev = _mesh_device(mesh) if mesh is not None else resolve_device(device)
    flat_sh = dict(_flatten_with_paths(shardings)) if shardings is not None else {}
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    pairs = {}
    for rec in manifest["leaves"]:
        if rec["dtype"] not in DTYPES:
            raise TypeError(f"{rec['path']}: no torch dtype for {rec['dtype']!r}")
        raw = torch.from_numpy(np.load(os.path.join(d, rec["file"])))
        t = raw.view(DTYPES[rec["dtype"]]).reshape(rec["shape"])
        sh = flat_sh.get(rec["path"])
        pairs[rec["path"]] = _place(t, sh, rec["path"]) if sh is not None else t.to(dev)
    return step, _unflatten_from_paths(pairs), manifest.get("extra", {})


def gc_old(ckpt_dir: str, keep_last: int = 3) -> None:
    steps = sorted(
        int(n.split("_")[1])
        for n in os.listdir(ckpt_dir)
        if n.startswith("step_")
    )
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)

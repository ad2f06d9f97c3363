"""Sharding rules: logical axes → mesh axes with divisibility fallback.

Parallelism layout, as in the JAX package:

* ``model`` mesh axis — tensor parallel (attention heads / FFN hidden /
  vocab) and expert parallel (MoE experts);
* ``data`` (+ ``pod``) — data parallel batch AND fully-sharded (ZeRO-3)
  parameters/optimizer state;
* sequence dim of long activations / KV caches falls back across axes by
  divisibility (context parallelism for the 512k decode cells).

Every rule is a *fallback chain*: the first candidate whose axis sizes
divide the dimension wins, else the dim is replicated.  Specs are
recomputed for whatever mesh exists, so a checkpoint can restore onto a
different topology.

The mesh is single-controller, as JAX's is: :class:`Mesh` holds an array
of ``torch.device`` (a device may repeat, so a (data 2, model 3) mesh may
hold one card six times) or, with ``devices=None``, only its axis sizes —
an abstract mesh, enough for every spec and for the dry run.
:class:`PartitionSpec` and :class:`NamedSharding` are small classes with
JAX's fields.  :func:`shard_map` runs a body once per mesh coordinate on
that coordinate's blocks and assembles the result; there are no
collectives, so it serves only bodies whose blocks are exact (no
contraction dim is split, which :func:`shard_workload` guarantees).

:func:`shard` returns its input unchanged and computes nothing: the
reference's constraint is an identity on values, and without collectives
the port has no placement to change.  :func:`activation_constraint` gives
the spec the reference would apply.
"""

from __future__ import annotations

import os as _os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Mesh, PartitionSpec, NamedSharding
# ---------------------------------------------------------------------------


def _flat(c) -> Tuple[str, ...]:
    if c is None:
        return ()
    return (c,) if isinstance(c, str) else tuple(c)


class PartitionSpec(tuple):
    """Per-dim mesh axes of an array: ``None`` (replicated), an axis name,
    or a tuple of names split row-major.  A one-name tuple is stored as the
    name, as JAX stores it, so specs compare equal to the reference's."""

    def __new__(cls, *dims):
        def canon(d):
            if d is None or isinstance(d, str):
                return d
            d = tuple(d)
            if not d:
                return None
            return d[0] if len(d) == 1 else d

        return super().__new__(cls, tuple(canon(d) for d in dims))

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(d) for d in self) + ")"


P = PartitionSpec


class Mesh:
    """A named grid of devices.

    ``devices`` is an array (or nested list) of ``torch.device`` (or
    device strings) with the mesh's shape; a device may repeat.  With
    ``devices=None`` the mesh is abstract and ``axis_sizes`` gives its
    shape.  ``axis_names`` and ``shape`` (name → size, in axis order) are
    what the spec functions read, as in the reference."""

    def __init__(self, devices, axis_names: Sequence[str],
                 axis_sizes: Optional[Sequence[int]] = None):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if devices is None:
            if axis_sizes is None or len(axis_sizes) != len(self.axis_names):
                raise ValueError("an abstract mesh needs one size per axis name")
            self.devices = None
            sizes = tuple(int(s) for s in axis_sizes)
        else:
            arr = np.asarray(devices, dtype=object)
            sizes = tuple(arr.shape)
            if len(sizes) != len(self.axis_names):
                raise ValueError(f"devices of shape {sizes} for axes {self.axis_names}")
            if axis_sizes is not None and tuple(axis_sizes) != sizes:
                raise ValueError(f"axis_sizes {tuple(axis_sizes)} against devices {sizes}")
            self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.size = int(np.prod(sizes))

    @property
    def is_abstract(self) -> bool:
        return self.devices is None

    def distinct_devices(self) -> List[Any]:
        """The mesh's devices without repeats, in mesh order."""
        if self.devices is None:
            raise RuntimeError("an abstract mesh has no devices")
        out: List[Any] = []
        for d in self.devices.reshape(-1):
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        kind = "abstract " if self.devices is None else ""
        return f"Mesh({kind}{self.shape})"


class NamedSharding:
    """An array's layout on a mesh: ``spec`` names the mesh axes that
    split each dim (fields as in JAX)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one device's block of an array of ``shape``."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more dims than shape {tuple(shape)}")
        out = []
        for i, size in enumerate(shape):
            entry = self.spec[i] if i < len(self.spec) else None
            n = _axis_size(self.mesh, entry)
            if size % n:
                raise ValueError(
                    f"dim {i} of {tuple(shape)} ({size}) does not divide over "
                    f"{entry!r} ({n}) of {self.mesh}"
                )
            out.append(size // n)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _block_slices(mesh: Mesh, spec: Sequence, shape: Sequence[int],
                  coord: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of the block at mesh coordinate ``coord`` of an array of
    ``shape`` laid out by ``spec``: a composite entry such as ``("pod",
    "data")`` splits the dim row-major over the named axes, as JAX does."""
    out = []
    for i, size in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = _flat(entry)
        if not axes:
            out.append(slice(None))
            continue
        n, idx = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coord[a]
        if size % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {entry!r}")
        b = size // n
        out.append(slice(idx * b, (idx + 1) * b))
    return tuple(out)


def shard_map(body: Callable, mesh: Mesh, in_specs: Sequence, out_specs) -> Callable:
    """``body`` run on each mesh coordinate's blocks, the blocks assembled.

    The returned function slices every operand's block by its spec at each
    coordinate (row-major over the mesh), moves it to that coordinate's
    device, runs ``body`` there and writes its one output into the global
    result (on the first operand's device) by ``out_specs``.  A mesh axis
    missing from ``out_specs`` takes coordinate 0's block along it, which
    is what the reference's ``check_rep=False`` assumes.  Nothing is
    reduced across blocks.  Raises on an abstract mesh."""
    if mesh.is_abstract:
        raise RuntimeError(f"shard_map needs devices; {mesh} is abstract")
    in_specs = tuple(in_specs)
    out_axes = {a for entry in out_specs for a in _flat(entry)}

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map: {len(args)} operands for {len(in_specs)} specs")
        home = args[0].device
        out = None
        for idx in np.ndindex(*mesh.devices.shape):
            coord = dict(zip(mesh.axis_names, idx))
            dev = mesh.devices[idx]
            blocks = [a[_block_slices(mesh, s, a.shape, coord)].to(dev)
                      for a, s in zip(args, in_specs)]
            y = body(*blocks)
            if any(coord[a] for a in mesh.axis_names if a not in out_axes):
                continue  # a replica of coordinate 0's block along this axis
            if out is None:
                gshape = [d * _axis_size(mesh, out_specs[i] if i < len(out_specs) else None)
                          for i, d in enumerate(y.shape)]
                out = torch.empty(gshape, dtype=y.dtype, device=home)
            out[_block_slices(mesh, out_specs, out.shape, coord)] = y.to(home)
        return out

    return run


# ---------------------------------------------------------------------------
# Mesh context
# ---------------------------------------------------------------------------

_CTX = threading.local()


def set_mesh(mesh: Optional[Mesh]) -> None:
    _CTX.mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return getattr(_CTX, "mesh", None)


class use_mesh:
    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __enter__(self):
        self._prev = get_mesh()
        set_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *a):
        set_mesh(self._prev)


def _axis_size(mesh: Mesh, axes) -> int:
    """Product of the named axes' sizes; axes the mesh lacks count as 1
    (a data-only mesh has no "model" axis — treat it as unsplit)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    out = 1
    for a in axes:
        out *= mesh.shape[a] if a in mesh.axis_names else 1
    return out


def _dp_axes(mesh: Mesh):
    """Data-parallel axes: ('pod', 'data') when multi-pod, else ('data',)."""
    names = tuple(mesh.axis_names)
    return tuple(a for a in ("pod", "data") if a in names)


# ---------------------------------------------------------------------------
# Fallback-chain resolution
# ---------------------------------------------------------------------------


def _resolve_dim(mesh: Mesh, size: int, chain: Sequence) -> Optional[Any]:
    """First candidate in the chain whose mesh size divides ``size``.

    Candidates naming an axis the mesh doesn't have are skipped (not
    treated as size-1 matches): a PartitionSpec may only reference real
    mesh axes, so e.g. "model" is simply not an option on a data-only
    mesh."""
    names = set(mesh.axis_names)
    for cand in chain:
        if cand is None:
            return None
        if any(a not in names for a in _flat(cand)):
            continue
        if size % _axis_size(mesh, cand) == 0:
            return cand
    return None


# ---------------------------------------------------------------------------
# Strategy knobs
# ---------------------------------------------------------------------------

STRATEGY: Dict[str, Any] = {
    # shard the inter-layer residual's sequence dim on "model" (Megatron-SP)
    "sp_residual": _os.environ.get("REPRO_SP_RESIDUAL", "1") == "1",
    # when heads don't divide the model axis, fall back to sharding head_dim
    # or replicate the activation and let weight sharding drive
    "act_head_dim_fallback": _os.environ.get("REPRO_ACT_HD", "0") == "1",
    # constrain q/k/v activations: True, False, or "auto" — iff every head
    # count divides the model axis
    "constrain_attn_acts": _os.environ.get("REPRO_CONSTRAIN_ATTN", "auto"),
}


def set_strategy(**kwargs) -> None:
    STRATEGY.update(kwargs)


# activation kinds -> per-dim fallback chains (built per mesh)
def _act_chains(mesh: Mesh) -> Dict[str, List]:
    dp = _dp_axes(mesh)
    seq_chain = ["model", None] if STRATEGY["sp_residual"] else [None]
    hd_chain = ["model", None] if STRATEGY["act_head_dim_fallback"] else [None]
    return {
        # (B, S, D): batch on dp; seq optionally on model (SP); D replicated
        "residual": [[dp, None], seq_chain, [None]],
        # (B, S, V): vocab on model
        "logits": [[dp, None], [None], ["model", None]],
        # (B, H, S, D) query/out heads
        "act_heads": [[dp, None], ["model", None], [None], hd_chain],
        # (B, KVH, S, D): kv heads on model, else head_dim
        "act_kv_heads": [[dp, None], ["model", None], [None], hd_chain],
        # (B, S, F) ffn hidden
        "ffn": [[dp, None], [None], ["model", None]],
        # (E, C, D) expert buffers
        "experts": [["model", None], [None], [dp, None]],
        # (T, D) / (T*k, D) flat token rows (MoE dispatch/combine)
        "tokens": [[dp, None], [None]],
        # (B, S, D) block input: seq gathered
        "block_input": [[dp, None], [None], [None]],
    }


def spec_for_activation(mesh: Mesh, kind: str, shape: Tuple[int, ...]) -> PartitionSpec:
    chains = _act_chains(mesh)[kind]
    dims = []
    used: set = set()
    for i, size in enumerate(shape):
        chain = chains[i] if i < len(chains) else [None]
        # drop candidates that reuse an axis already taken by another dim
        filtered = [c for c in chain
                    if c is None or not any(a in used for a in _flat(c))]
        r = _resolve_dim(mesh, size, filtered)
        used.update(_flat(r))
        dims.append(r)
    return PartitionSpec(*dims)


def activation_constraint(mesh: Mesh, kind: str, shape: Tuple[int, ...],
                          all_head_dims: Optional[Tuple[int, ...]] = None
                          ) -> Optional[PartitionSpec]:
    """The spec the reference's ``shard`` constrains an activation of
    ``shape`` to, or None where its policy leaves the activation alone.

    ``all_head_dims`` (q heads, kv heads) drives the "auto" policy for
    attention activations: constrain q/k/v only when EVERY head count
    divides the model axis."""
    mode = STRATEGY["constrain_attn_acts"]
    if kind in ("act_heads", "act_kv_heads"):
        if mode in (False, "0"):
            return None
        if mode == "auto":
            dims = all_head_dims if all_head_dims else (shape[1],)
            if any(d % _axis_size(mesh, "model") != 0 for d in dims):
                return None
    return spec_for_activation(mesh, kind, tuple(shape))


def shard(x, kind: str, all_head_dims: Optional[Tuple[int, ...]] = None):
    """A named activation sharding constraint: ``x`` itself, with nothing
    computed.  The reference's constraint is an identity on values, and on
    a logical mesh nothing consumes its spec; :func:`activation_constraint`
    gives that spec where a consumer needs it."""
    return x


# ---------------------------------------------------------------------------
# Parameter sharding (logical axes from models.layers.PARAM_AXES)
# ---------------------------------------------------------------------------


def _param_chain(mesh: Mesh, logical: Optional[str], fsdp: bool = True) -> List:
    dp = _dp_axes(mesh)
    return {
        None: [None],
        "layers": [None],
        # training: ZeRO-3/FSDP shard over data(+pod); serving: replicate
        "embed": [dp, None] if fsdp else [None],
        "heads": ["model", None],  # tensor parallel
        "mlp": ["model", None],
        "vocab": ["model", None],
        "experts": ["model", None],  # expert parallel
    }[logical]


def spec_for_param(
    mesh: Mesh, shape: Tuple[int, ...], logical_axes: Tuple[Optional[str], ...],
    scanned: bool = False, fsdp: bool = True,
) -> PartitionSpec:
    dims: List[Any] = []
    used: set = set()
    axes = (("layers",) + tuple(logical_axes)) if scanned else tuple(logical_axes)
    if len(axes) < len(shape):
        axes = axes + (None,) * (len(shape) - len(axes))
    for size, logical in zip(shape, axes):
        chain = [c for c in _param_chain(mesh, logical, fsdp)
                 if c is None or not any(a in used for a in _flat(c))]
        r = _resolve_dim(mesh, size, chain)
        used.update(_flat(r))
        dims.append(r)
    return PartitionSpec(*dims)


def param_shardings(mesh: Mesh, params: Any, fsdp: bool = True) -> Any:
    """NamedSharding tree matching a parameter tree (tensors, or anything
    with ``.shape``).  A leaf's logical axes come from the table
    :data:`repro_torch.models.layers.PARAM_AXES`, keyed by path suffix."""
    from ..models.layers import PARAM_AXES

    def leaf_axes(path: str, leaf) -> Tuple[Optional[str], ...]:
        # path like "layers/attn/wq" -> registered under "attn/wq"
        parts = path.split("/")
        for i in range(len(parts)):
            key = "/".join(parts[i:])
            if key in PARAM_AXES:
                return PARAM_AXES[key]
        if parts[-1] in ("embed",):
            return PARAM_AXES.get("embed", ("vocab", "embed"))
        return (None,) * len(leaf.shape)

    def rec(tree, path: str):
        if isinstance(tree, dict):
            return {k: rec(v, f"{path}/{k}" if path else k) for k, v in tree.items()}
        scanned = path.startswith("layers") or path.startswith("enc_layers")
        shape = tuple(tree.shape)
        want = len(shape) - (1 if scanned else 0)
        axes = tuple(leaf_axes(path, tree))[:want]
        spec = spec_for_param(mesh, shape, axes, scanned=scanned, fsdp=fsdp)
        return NamedSharding(mesh, spec)

    return rec(params, "")


def opt_state_shardings(mesh: Mesh, params: Any) -> Any:
    """AdamW m/v mirror the (FSDP) parameter sharding; step replicated."""
    ps = param_shardings(mesh, params, fsdp=True)
    return {"m": ps, "v": ps, "step": NamedSharding(mesh, PartitionSpec())}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def batch_shardings(mesh: Mesh, batch: Any) -> Any:
    dp = _dp_axes(mesh)

    def one(x):
        dims = [dp if x.shape[0] % _axis_size(mesh, dp) == 0 else None]
        dims += [None] * (len(x.shape) - 1)
        return NamedSharding(mesh, PartitionSpec(*dims))

    return _tree_map(one, batch)


def cache_shardings(mesh: Mesh, cache: Any) -> Any:
    """KV/state cache: (L, B, KVH, S, D) — batch on dp if divisible, else
    context-parallel (seq on dp); heads on model, else head_dim on model."""
    dp = _dp_axes(mesh)

    def one(x):
        ndim = len(x.shape)
        B = x.shape[1]
        dims: List[Any] = [None] * ndim
        used: set = set()
        if B % _axis_size(mesh, dp) == 0:
            dims[1] = dp
            used.update(dp)
        h, s = x.shape[2], x.shape[3]
        if h % _axis_size(mesh, "model") == 0:
            dims[2] = "model"
            used.add("model")
        elif x.shape[-1] % _axis_size(mesh, "model") == 0:
            dims[-1] = "model"
            used.add("model")
        if dims[1] is None and not any(a in used for a in dp) and s % _axis_size(mesh, dp) == 0:
            dims[3] = dp  # context parallelism for batch=1 long decode
        return NamedSharding(mesh, PartitionSpec(*dims))

    def rec(tree):
        if isinstance(tree, dict):
            return {k: rec(v) for k, v in tree.items()}
        if len(getattr(tree, "shape", ())) >= 4:
            return one(tree)
        return NamedSharding(mesh, PartitionSpec())

    return rec(cache)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


# ---------------------------------------------------------------------------
# Per-shard workload shapes (mesh-aware task extraction + dispatch)
# ---------------------------------------------------------------------------


@dataclass
class ShardedWorkload:
    """How one tuned-workload call partitions over a mesh.

    ``kwargs`` are the *per-shard* workload shape kwargs (what to tune and
    what key to look up); ``dim_axes`` maps workload dim names (``m``,
    ``n``, ``b``, ``h``) to the mesh axis (or dp-axis tuple) that splits
    them — the dispatch layer turns this into :func:`shard_map` specs.
    """

    kwargs: Dict[str, Any]
    dim_axes: Dict[str, Any]


def shard_workload(
    op: str, kwargs: Dict[str, Any], mesh: Optional[Mesh]
) -> Optional[ShardedWorkload]:
    """Per-shard shape of one tuned workload under a mesh.

    The one source of the data-parallel/tensor-parallel rules for tuned
    kernels: :mod:`repro_torch.integration.extract` uses it to decide which
    shapes to tune when a mesh is active, and
    :class:`repro_torch.integration.dispatch.DispatchContext` uses it to
    pick the per-shard key it serves inside :func:`shard_map`, so the two
    never disagree on a key.

    Dims shard only when the mesh axis size divides them exactly;
    contraction dims (``k``, ``s`` of attention scores) never shard — every
    shard computes an exact local result and no cross-shard reduction is
    needed.  Returns ``None`` when the op is not mesh-servable or nothing
    divides.
    """
    if mesh is None:
        return None
    dp = _dp_axes(mesh)
    dpn = _axis_size(mesh, dp)
    mdl = mesh.shape["model"] if "model" in mesh.axis_names else 1
    kw = dict(kwargs)
    axes: Dict[str, Any] = {}
    if op == "dense":
        # rows over data-parallel, columns over tensor-parallel; the
        # contraction dim k stays whole
        if dpn > 1 and kw.get("m", 0) % dpn == 0 and kw.get("m", 0) >= dpn:
            kw["m"] //= dpn
            axes["m"] = dp
        if mdl > 1 and kw.get("n", 0) % mdl == 0 and kw.get("n", 0) >= mdl:
            kw["n"] //= mdl
            axes["n"] = "model"
    elif op == "batch_matmul":
        # the leading batch dim carries heads (attention contractions) or
        # experts (MoE): model axis first, data-parallel as fallback
        if mdl > 1 and kw.get("b", 0) % mdl == 0 and kw.get("b", 0) >= mdl:
            kw["b"] //= mdl
            axes["b"] = "model"
        elif dpn > 1 and kw.get("b", 0) % dpn == 0 and kw.get("b", 0) >= dpn:
            kw["b"] //= dpn
            axes["b"] = dp
    elif op in ("attention", "attention_decode"):
        # heads over model (q and kv head counts must both divide so GQA
        # groups stay intact per shard), batch over data-parallel
        h, kvh = kw.get("h", 0), kw.get("kvh", 0)
        if mdl > 1 and h and kvh and h % mdl == 0 and kvh % mdl == 0:
            kw["h"] //= mdl
            kw["kvh"] //= mdl
            axes["h"] = "model"
        if dpn > 1 and kw.get("b", 0) % dpn == 0 and kw.get("b", 0) >= dpn:
            kw["b"] //= dpn
            axes["b"] = dp
    else:
        return None
    if not axes:
        return None
    return ShardedWorkload(kwargs=kw, dim_axes=axes)

"""Dry run: build every (arch × shape) cell's step on the production
meshes and count what each device would hold and compute.

The step (a train step, a prefill or a decode step) runs once on
``meta`` tensors, which carry shapes and dtypes and allocate nothing, on
the abstract 16×16 (single-pod, 256 chips) and 2×16×16 (512-chip) meshes
of :mod:`repro_torch.launch.mesh`.  The record keeps the JAX package's
keys; it fills what the port computes:

* ``memory.argument_bytes`` / ``output_bytes``: per device, the sum over
  the step's inputs (outputs) of each leaf's block under its
  ``NamedSharding`` (``shard_shape``);
* ``cost.flops``: the whole step's FLOPs as
  ``torch.utils.flop_counter.FlopCounterMode`` counts them on the meta
  tensors, over ``n_devices``;
* ``corrected.dot_flops``: the same count — the port loops over layers in
  Python, so there is no while-loop trip count to correct.

``temp_bytes``, ``peak_bytes``, ``bytes_accessed`` and the collectives are
``null`` (``notes`` says why): the port has no compiler and no SPMD
partitioner to report them.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

from ..configs.base import ARCHS, SHAPES, cell_supported, get_config
from ..distributed import sharding as shd
from ..models import registry as R
from ..training.optimizer import OptConfig, adamw_init
from .mesh import make_production_mesh

RESULTS_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch"
)

NOTES = ("temp_bytes, peak_bytes, bytes_accessed and collectives are null: "
         "the port has no compiler and no SPMD partitioner; FLOPs are "
         "FlopCounterMode's count of the step on meta tensors over n_devices")


@dataclass
class ShardedStep:
    """A cell's step with the shardings of its inputs and outputs (the
    reference's ``jax.jit(..., in_shardings=, out_shardings=)``)."""

    fn: Callable
    in_shardings: Tuple
    out_shardings: Tuple

    def __call__(self, *args):
        return self.fn(*args)


def build_cell(arch: str, shape_name: str, mesh, fsdp: bool = True
               ) -> Tuple[ShardedStep, Tuple, Dict]:
    """(step, meta-tensor args, meta) for one cell on ``mesh``."""
    return build_step(get_config(arch), SHAPES[shape_name], mesh)


def build_step(cfg, shape, mesh) -> Tuple[ShardedStep, Tuple, Dict]:
    """:func:`build_cell` for a config and a ``ShapeConfig``."""
    model = R.build_model(cfg)
    pspecs = model.param_specs()

    if shape.kind == "train":
        from ..training.train_loop import make_train_step

        p_sh = shd.param_shardings(mesh, pspecs, fsdp=True)
        o_sh = shd.opt_state_shardings(mesh, pspecs)
        batch_specs = R.train_batch_specs(cfg, shape)
        b_sh = shd.batch_shardings(mesh, batch_specs)
        step = ShardedStep(make_train_step(model, OptConfig()),
                           (p_sh, o_sh, b_sh),
                           (p_sh, o_sh, {"loss": shd.replicated(mesh)}))
        args = (pspecs, adamw_init(pspecs), batch_specs)
    else:
        p_sh = shd.param_shardings(mesh, pspecs, fsdp=False)
        cache_specs = model.cache_specs(shape.global_batch, shape.seq_len)
        c_sh = shd.cache_shardings(mesh, cache_specs)
        if shape.kind == "prefill":
            ins = R.prefill_input_specs(cfg, shape)

            def run(params, cache, inputs):
                return model.prefill(params, cache, **inputs)
        else:
            ins = R.decode_input_specs(cfg, shape)

            def run(params, cache, inputs):
                return model.decode_step(params, cache, inputs["tokens"])

        step = ShardedStep(run, (p_sh, c_sh, shd.batch_shardings(mesh, ins)),
                           (shd.replicated(mesh), c_sh))
        args = (pspecs, cache_specs, ins)

    meta = {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "params": cfg.params_count(),
        "active_params": cfg.active_params_count(),
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
    }
    return step, args, meta


def sharded_bytes(tree: Any, shardings: Any) -> int:
    """Bytes of one device's blocks of every leaf of ``tree`` (tensors),
    laid out by the matching ``shardings`` tree; a sharding that is not a
    tree (one ``NamedSharding``) applies to every leaf below it."""
    if isinstance(tree, dict):
        return sum(sharded_bytes(v, shardings[k] if isinstance(shardings, dict) else shardings)
                   for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return sum(sharded_bytes(v, shardings) for v in tree)
    n = 1
    for d in shardings.shard_shape(tuple(tree.shape)):
        n *= d
    return n * tree.element_size()


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict:
    from torch.utils.flop_counter import FlopCounterMode

    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        with shd.use_mesh(mesh):
            step, args, meta = build_cell(arch, shape_name, mesh)
            counter = FlopCounterMode(display=False)
            with counter:
                outs = step(*args)
        n_dev = mesh.size
        arg_bytes = sum(sharded_bytes(a, s) for a, s in zip(args, step.in_shardings))
        out_bytes = sum(sharded_bytes(o, s) for o, s in zip(outs, step.out_shardings))
        flops = counter.get_total_flops() / n_dev
        rec.update(
            status="ok",
            meta=meta,
            compile_s=round(time.time() - t0, 2),
            n_devices=n_dev,
            memory={"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                    "temp_bytes": None, "peak_bytes": None},
            cost={"flops": flops, "bytes_accessed": None},
            collectives=None,
            corrected={"dot_flops": flops, "collectives": None, "trip_counts": None},
            notes=NOTES,
        )
    except Exception as e:
        rec.update(
            status="error",
            error=f"{type(e).__name__}: {e}",
            trace=traceback.format_exc()[-2000:],
            compile_s=round(time.time() - t0, 2),
        )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    n_ok = n_skip = n_err = 0
    for arch, sh, mp in cells:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        out_path = os.path.join(args.out, f"{arch}__{sh}__{mesh_name}.json")
        if os.path.exists(out_path):
            with open(out_path) as f:
                rec = json.load(f)
            if rec.get("status") in ("ok", "skipped"):
                print(f"[cached] {arch} {sh} {mesh_name}: {rec['status']}")
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                continue
        rec = run_cell(arch, sh, mp)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        tag = rec["status"]
        if tag == "ok":
            n_ok += 1
            print(
                f"[ok] {arch} {sh} {mesh_name}: {rec['compile_s']}s "
                f"args/device {rec['memory']['argument_bytes'] / 2**30:.2f} GiB "
                f"flops/device {rec['cost']['flops']:.3g}"
            )
        elif tag == "skipped":
            n_skip += 1
            print(f"[skip] {arch} {sh} {mesh_name}: {rec['reason'][:60]}")
        else:
            n_err += 1
            print(f"[ERR] {arch} {sh} {mesh_name}: {rec['error'][:200]}")
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT [--smoke] [--device cpu]

Runs on the card unless ``--device cpu`` is given; asking for the card
without one raises.  Parameters are drawn from a seeded ``torch.Generator``
(no download), batches from ``SyntheticTokenPipeline``: tokens, or for a
model with embedding inputs (``--arch qwen2-vl-2b``, ``whisper-medium``)
embeddings and labels, plus whisper's encoder frames.  The loop is
fault-tolerant, as the reference's: a checkpoint every ``--ckpt-every``
steps (the last 3 kept), resume from LATEST, straggler detection on step
times.  The step runs with no DispatchContext, as the reference's
launcher; ``training.train_loop.make_train_step(..., dispatch=ctx)`` is
the dispatched step.  ``main`` returns the losses.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs.base import ARCHS, get_config
from ..data.pipeline import SyntheticTokenPipeline
from ..device import resolve_device
from ..models.registry import build_model
from ..training import checkpoint as ckpt
from ..training.fault_tolerance import StragglerDetector, retry
from ..training.optimizer import OptConfig, adamw_init
from ..training.train_loop import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress-bits", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    opt_cfg = OptConfig(
        lr=args.lr, total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
        compress_bits=args.compress_bits,
    )
    step_fn = make_train_step(model, opt_cfg, num_microbatches=args.microbatches)
    pipe = SyntheticTokenPipeline(cfg, args.seq, args.batch)

    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        start, state, _ = ckpt.restore(args.ckpt_dir, device=dev)
        params, opt_state = state["params"], state["opt"]
        print(f"resumed from step {start}")
    else:
        params = model.init(seed=0, device=dev)
        opt_state = adamw_init(params)

    detector = StragglerDetector()
    losses = []
    for step, batch in enumerate(pipe.iter_from(start), start=start):
        if step >= args.steps:
            break
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt_state, metrics = retry(
            lambda: step_fn(params, opt_state, batch)
        )
        losses.append(float(metrics["loss"]))  # waits for the step's work
        dt = time.perf_counter() - t0
        detector.record(step, dt)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} ({dt*1e3:.0f} ms)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(
                args.ckpt_dir, step + 1, {"params": params, "opt": opt_state}
            )
            ckpt.gc_old(args.ckpt_dir)
    print(
        f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f} "
        f"(median step {detector.median_step_s*1e3:.0f} ms)"
    )
    return losses


if __name__ == "__main__":
    main()

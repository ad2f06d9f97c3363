"""End-to-end driver on PyTorch and CUDA (Appendix A.6): extract the hot
matmul shapes from a model, tune them with MetaSchedule on the card, store
traces in the database, then train the model for a few hundred steps with
fault-tolerant checkpointing.

    PYTHONPATH=src python examples/tune_and_train_torch.py [--steps 200] \
        [--rounds 6] [--device cpu]

``--device`` defaults to ``cuda``; asking for the card without one raises.
The database is ``tune_and_train_torch_db.json`` under the temporary
directory.  Phase 2 names it in ``REPRO_TUNING_DB`` as the JAX package's
driver does, but trains through ``repro_torch.launch.train``, whose step
runs with no ``DispatchContext`` and reads no database; ``kernels/ops.py``
reads that variable once, when it is first imported (during phase 1).
"""
import argparse
import os
import tempfile

import repro_torch
from repro_torch.configs.base import get_config
from repro_torch.launch import train as train_launcher


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="where candidates are measured and the model trains "
                         "(default: cuda)")
    args = ap.parse_args()

    cfg = get_config("smollm-135m", smoke=True)
    db_path = os.path.join(tempfile.gettempdir(), "tune_and_train_torch_db.json")
    db = repro_torch.Database(db_path)

    print("== phase 1: tune the model's tensor programs (task scheduler) ==")
    # tasks extracted automatically from the model's forward — shapes,
    # occurrence weights and dedup all come from the program
    sched = repro_torch.TaskScheduler(
        repro_torch.extract_tasks(cfg, batch=1, seq=128, dispatchable_only=True),
        database=db,
        config=repro_torch.TuneConfig(
            search=repro_torch.SearchConfig(max_trials=24, init_random=6,
                                            population=8, measure_per_round=6),
            verbose=True, device=args.device,
        ),
    )
    best = sched.tune(total_rounds=args.rounds)
    for k, v in best.items():
        print(f"  {k}: {v*1e6:.1f} us")

    print("\n== phase 2: train with tuned kernels in the database ==")
    os.environ["REPRO_TUNING_DB"] = db_path
    with tempfile.TemporaryDirectory() as ckpt_dir:
        losses = train_launcher.main([
            "--arch", "smollm-135m", "--smoke",
            "--steps", str(args.steps), "--batch", "8", "--seq", "128",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "50",
            "--device", args.device,
        ])
    if not losses[-1] < losses[0]:
        raise SystemExit(f"loss did not decrease: {losses[0]:.4f} -> {losses[-1]:.4f}")
    print("training improved loss; tuned records live in", db.path)


if __name__ == "__main__":
    main()

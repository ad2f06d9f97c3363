"""Quickstart on PyTorch and CUDA: construct a probabilistic search space
for a matmul and tune it with the learning-driven search (paper Figures 3
+ 7 end-to-end), measuring on the card.

    PYTHONPATH=src python examples/quickstart_torch.py            # full demo
    PYTHONPATH=src python examples/quickstart_torch.py --smoke    # tiny run
    PYTHONPATH=src python examples/quickstart_torch.py --smoke --device cpu

Candidates are measured on ``--device`` (default ``cuda``; asking for the
card without one raises).  The full demo keeps its database in
``quickstart_torch_db.json`` under the temporary directory, so a second
run warm-starts from the first.
"""

import argparse
import os
import tempfile

import repro_torch
from repro_torch.core.schedule import Schedule
from repro_torch.core.workloads import gmm


def manual_schedule_demo():
    """The paper's Figure 3: 7 lines cover a family of tensor programs."""
    func = gmm(n=128, m=128, k=128)
    sch = Schedule(func, seed=0)
    C = sch.get_block("C")
    i, j, k = sch.get_loops(C)
    ti = sch.sample_perfect_tile(i, n=2, max_innermost_factor=64)
    tj = sch.sample_perfect_tile(j, n=2, max_innermost_factor=64)
    i0, i1 = sch.split(i, ti)
    j0, j1 = sch.split(j, tj)
    sch.reorder(i0, j0, i1, j1)
    sch.parallel(sch.fuse(i0, j0))
    sch.unroll(i1)
    sch.vectorize(j1)
    print("=== sampled schedule (Figure 3) ===")
    print(sch.script())
    print("\n=== recorded trace (Figure 6) ===")
    print(sch.trace.as_python())


def tuned_search_demo(smoke=False, device="cuda"):
    if smoke:
        db = repro_torch.Database(
            os.path.join(tempfile.mkdtemp(), "quickstart_torch_db.json")
        )
        shape = dict(n=32, m=32, k=32)
        search = repro_torch.SearchConfig(max_trials=8, init_random=4, population=6,
                                          measure_per_round=4)
    else:
        db = repro_torch.Database(
            os.path.join(tempfile.gettempdir(), "quickstart_torch_db.json")
        )
        shape = dict(n=128, m=128, k=128)
        search = repro_torch.SearchConfig(max_trials=32, init_random=8,
                                          population=12, measure_per_round=8)
    cfg = repro_torch.TuneConfig(search=search, use_mxu=True, verbose=not smoke,
                                 device=device)
    res = repro_torch.tune_workload("gmm", shape, config=cfg, database=db)
    print(f"\ndevice            : {device}")
    print(f"best latency      : {res.best_latency_s*1e6:9.1f} us")
    print(f"plain baseline    : {res.baseline_latency_s*1e6:9.1f} us")
    print(f"speedup           : {res.speedup_vs_baseline:9.2f}x")
    print(f"trials            : {res.trials}, {res.tuning_time_s:.1f}s")
    print(f"warm-started      : {res.warm_started}")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shape + trial budget")
    ap.add_argument("--device", default="cuda",
                    help="where candidates are measured (default: cuda)")
    args = ap.parse_args()
    manual_schedule_demo()
    tuned_search_demo(smoke=args.smoke, device=args.device)

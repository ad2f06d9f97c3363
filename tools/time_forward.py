#!/usr/bin/env python3
"""Time smollm-135m's dispatched forward with the port in this checkout.

Run from anywhere on a machine with one CUDA card::

    python3 tools/time_forward.py --db DB.json [--reps 7] [--out OUT.json]

It imports ``repro_torch`` from the ``src/`` beside this script's folder,
so a copy of the script placed in another checkout's ``tools/`` times that
checkout.  With ``--db`` naming a file that exists, the forward dispatches
those records; otherwise the forward's 10 tasks (batch 1, seq 256) are
tuned on the card, as ``chip_smoke.py`` phase 4 tunes them, and saved to
``--db``.  Two checkouts run with one ``--db`` therefore dispatch the same
tiles and schedules, and their times compare on one card.

Printed, and written to ``--out`` as JSON:

* the host clock around one bf16 forward (median of ``--reps``, the three
  kinds interleaved): plain, dispatched, and dispatched with rmsnorm left
  plain (the kernel sites alone);
* each dispatched task's call: the CUDA-event median of 20 calls of its
  lowered function on the task's inputs (host time included where the host
  is slower than the card), times its sites in one forward;
* one dispatched forward under ``torch.profiler``: device events, the time
  the device was busy, the idle share of the span, and the largest host
  operators by self time.

Exits 2 without a card; prints no result then.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH = 256, 1


def median(xs):
    return sorted(xs)[len(xs) // 2]


def tune(cfg, tasks, db) -> None:
    """The forward's tasks tuned as ``chip_smoke.py`` phase 4 tunes them."""
    import repro_torch
    from repro_torch.search.evolutionary import SearchConfig

    search = SearchConfig(max_trials=32, init_random=8, population=16,
                          measure_per_round=8, rollout_factor=2)
    config = repro_torch.TuneConfig(search=search, runner_spec="cached+local",
                                    backend="cuda", device="cuda", warm_start=False)
    t0 = time.perf_counter()
    repro_torch.TaskScheduler(tasks, database=db, config=config).tune(
        total_rounds=4 * len(tasks))
    print(f"[tune] {len(tasks)} tasks in {time.perf_counter() - t0:.1f} s")


def site_calls(tasks, db, hits) -> dict:
    """Each dispatched task's lowered call, CUDA-event median of 20."""
    import numpy as np
    import torch

    from repro_torch.search.measure.local import device_inputs, time_call
    from repro_torch.search.tune import apply_trace

    rows = {}
    for t in tasks:
        if not hits.get(t.key):
            continue
        rec = db.best(t.key)
        _, lowered = apply_trace(t.func, rec.trace(), backend="cuda")
        ins = device_inputs(t.func, torch.device("cuda"))
        ms = float(np.median(time_call(lambda: lowered.fn(ins), torch.device("cuda"),
                                       20, 3))) * 1e3
        blocks = rec.meta.get("pallas_blocks_snapped", rec.meta.get("pallas_rows_snapped"))
        rows[t.key] = dict(call_ms=ms, sites=hits[t.key], forward_ms=ms * hits[t.key],
                           kernel=rec.meta.get("pallas_kernel", rec.meta.get("lowered_with")),
                           blocks=blocks)
        print(f"[site] {t.key}: {rows[t.key]['kernel']} {blocks}: {ms:.4f} ms a call "
              f"x {hits[t.key]} = {ms * hits[t.key]:.2f} ms a forward")
    return rows


def profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    host = Counter()
    for e in prof.key_averages():
        host[e.key] += e.self_cpu_time_total
    top = {k: v / 1e3 for k, v in host.most_common(8)}
    if not spans:
        return dict(events=0, host_top_ms=top)
    busy, end = 0.0, spans[0][0]
    for t0, t1 in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    span = end - spans[0][0]
    return dict(events=len(spans), busy_ms=busy / 1e3, span_ms=span / 1e3,
                idle_share=1.0 - busy / span if span > 0 else 0.0, host_top_ms=top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--db", required=True,
                    help="tuning database: dispatched if it exists, else tuned and saved")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default=None, help="JSON file to write the results to")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_forward: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.search.database import Database

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"[forward] repro_torch from {ROOT / 'src'}")
    cfg = get_config("smollm-135m")
    tasks = repro_torch.extract_tasks(cfg, batch=BATCH, seq=SEQ)
    tuned_here = not os.path.exists(args.db)
    db = Database(args.db)
    if tuned_here:
        tune(cfg, tasks, db)
        db.save()
    kernel_tasks = [t for t in tasks if not t.key.startswith("rmsnorm/")]

    params = T.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=g, device="cuda")
    ctx_all = repro_torch.DispatchContext(db, tasks=tasks, backend="cuda")
    ctx_kernels = repro_torch.DispatchContext(db, tasks=kernel_tasks, backend="cuda")
    kinds = {"plain": None, "dispatched": ctx_all, "dispatched_rmsnorm_plain": ctx_kernels}

    def forward(ctx):
        with ctx if ctx is not None else torch.no_grad():
            return T.forward(cfg, params, toks)

    times = {k: [] for k in kinds}
    with torch.no_grad():
        for ctx in kinds.values():  # warm each kind, lowering included
            forward(ctx)
        hits = dict(ctx_all.hits_by_key)
        for _ in range(args.reps):
            for kind, ctx in kinds.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forward(ctx)
                torch.cuda.synchronize()
                times[kind].append((time.perf_counter() - t0) * 1e3)
        traced = profile(lambda: forward(ctx_all))
    med = {k: median(v) for k, v in times.items()}
    for kind, ts in times.items():
        print(f"[forward] {kind}: median {med[kind]:.2f} ms of "
              f"{[round(t, 2) for t in ts]}")
    print(f"[forward] traced dispatched forward: {traced}")
    sites = site_calls(tasks, db, hits)
    result = dict(card=card, src=str(ROOT / "src"), tuned_here=tuned_here,
                  forward_ms=med, forward_ms_all=times, sites=sites, traced=traced)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(card)
    print(json.dumps(dict(forward_ms=med, busy_ms=traced.get("busy_ms"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())

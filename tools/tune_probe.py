#!/usr/bin/env python3
"""Where the time of ``chip_smoke.py``'s tuning goes, task by task.

Run from the root of a checkout on a machine with one CUDA card::

    python3 tools/tune_probe.py [--structural-timeout S] [--out build/tune_probe]

It tunes whisper-medium's forward tasks (batch 1, seq 256) and smollm-135m's
train-step tasks (batch 8, seq 128) as ``chip_smoke.py`` phases 16 and 13
do, through ``chip_smoke.phase_tune``, with the event tracer on.  Printed:
each tune's wall time and its largest host functions under ``cProfile``,
then, for every task, the seconds its candidates spent in ``measure.build``
and ``measure.run`` and each candidate's latency.  The trace is written to
``--out``/trace.jsonl.  ``--structural-timeout`` sets the first call
after which a structural candidate is timed no further
(``chip_smoke.STRUCTURAL_TIMEOUT_S`` by default; 10, the runner's own
default, times every candidate in full).

Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUNES = (("whisper-medium", 1, 256), ("smollm-135m", 8, 128))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--structural-timeout", type=float, default=None)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "tune_probe"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out, "trace.jsonl")
    os.environ["REPRO_TRACE"] = trace_path  # read when repro_torch.obs is imported
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("tune_probe: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch
    from repro_torch.configs.base import get_config
    from repro_torch.obs.trace import disable_tracing
    from repro_torch.search.database import Database

    if args.structural_timeout is not None:
        cs.STRUCTURAL_TIMEOUT_S = args.structural_timeout
    print(cs.card_line())
    print(f"[probe] structural timeout {cs.STRUCTURAL_TIMEOUT_S} s")
    cs.phase_build()
    for arch, batch, seq in TUNES:
        cfg = get_config(arch)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        cs.phase_tune(cfg, Database(), tag=arch,
                      extract=lambda: repro_torch.extract_tasks(cfg, batch=batch, seq=seq))
        prof.disable()
        print(f"[probe] {arch} tune {time.perf_counter() - t0:.1f} s")
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(30)
        print(out.getvalue())
    disable_tracing()

    spent = defaultdict(lambda: defaultdict(float))
    latencies = defaultdict(list)
    with open(trace_path) as fh:
        for line in fh:
            ev = json.loads(line)
            if "dur_s" in ev and "key" in ev:
                spent[ev["key"]][ev["ev"]] += ev["dur_s"]
            if ev.get("ev") == "measure.run":
                latencies[ev["key"]].append(ev.get("latency_s") or ev.get("error", ""))
    for key, by_ev in sorted(spent.items(), key=lambda kv: -sum(kv[1].values())):
        print(f"[probe] {key}: "
              + ", ".join(f"{ev} {s:.2f} s" for ev, s in sorted(by_ev.items()))
              + f"; candidates {latencies[key]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""How long a tuning task's timing inputs take to draw, on the host and on the card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/input_draws.py batch_matmul/b=128/k=7168/m=4/n=4864 \\
        dense/k=8192/m=4/n=152064

For each workload key it draws the inputs a local runner times the task
on, both ways, and prints the seconds and the bytes: the host's way
(``random_inputs(func, 0)``, float64 numpy draws cast to the buffer's
dtype, then copied to the card), which the runners took before they drew
on the card, and ``search/measure/local.py:device_inputs`` (N(0, 1) from a
``torch.Generator`` seeded 0 on the card).  Each way ends in
``synchronize()``; the host's way holds 8 bytes an element of host memory
while it draws (35.7 GB at arctic-480b's b128 expert product).
``--device-only`` skips the host's way.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.tir import random_inputs  # noqa: E402
from repro_torch.core.workloads import get_workload  # noqa: E402
from repro_torch.search.database import parse_workload_key  # noqa: E402
from repro_torch.search.measure.local import device_inputs  # noqa: E402


def timed(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("keys", nargs="+", help="workload keys, as the database writes them")
    ap.add_argument("--device-only", action="store_true",
                    help="time only the draw on the card")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("input_draws: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for key in args.keys:
        op, kw = parse_workload_key(key)
        func = get_workload(op, **kw)
        elems = sum(math.prod(b.shape) for b in func.inputs)
        ins, dev_s = timed(lambda: device_inputs(func, dev))
        nbytes = sum(t.numel() * t.element_size() for t in ins.values())
        del ins
        torch.cuda.empty_cache()
        line = (f"{key}: {elems:.4g} elements, {nbytes / 1e9:.3f} GB on the card; "
                f"drawn on the card {dev_s:.3f} s")
        if not args.device_only:
            ins, host_s = timed(lambda: {k: torch.from_numpy(v).to(dev)
                                         for k, v in random_inputs(func, 0).items()})
            del ins
            torch.cuda.empty_cache()
            line += f", on the host and copied {host_s:.3f} s"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""How far K1's ``fma`` variant rounds from the exact product, on the CPU.

Run from the root of a checkout::

    python3 tools/k1_fma_rounding.py 256 8192 8192     # M K N

K1's ``fma`` kernel (``src/repro_torch/kernels/csrc/matmul.cu``) sums each
output with one ``fmaf`` a k, in k order, whatever the tile, so every
``fma`` tile of a shape gives the same bits.  This script replays that
order in float32 with numpy (each product is exact in float64, and the sum
of a product and the float32 accumulator rounds once to float32, as
``fmaf`` does) on inputs drawn as a tuning task's are off the card
(``random_inputs(func, 0)``, N(0, 1); on the card a runner draws the same
distribution there, ``device_inputs``), and prints the largest error of
that sum and of numpy's float32 product against the float64 product,
beside max |y|.  ``chip_smoke.py:tuned_k1_against_plain`` holds a tuned
tile against the plain product within ``TOL_MATMUL`` (2e-3); this is how
close an ``fma`` tile comes by rounding alone.  It takes K passes over an
M x N float64 array (about 100 s at 256 x 8192 x 8192).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.tir import random_inputs  # noqa: E402
from repro_torch.core.workloads import get_workload  # noqa: E402


def fma_order_sum(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """x (M, K) @ w (K, N) with one float32 rounding a k, in k order."""
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k in range(x.shape[1]):
        acc = (np.outer(x64[:, k], w64[k]) + acc).astype(np.float32)
    return acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("M", type=int)
    ap.add_argument("K", type=int)
    ap.add_argument("N", type=int)
    args = ap.parse_args(argv)
    ins = random_inputs(get_workload("dense", m=args.M, n=args.N, k=args.K), 0)
    x, w = ins["X"], ins["W"]
    t0 = time.perf_counter()
    exact = x.astype(np.float64) @ w.astype(np.float64)
    fma = float(np.abs(fma_order_sum(x, w) - exact).max())
    f32 = float(np.abs(x @ w - exact).max())
    print(f"dense m{args.M} k{args.K} n{args.N}: the fma order's max error "
          f"{fma:.4e}, numpy's float32 product's {f32:.4e}, against the float64 "
          f"product; max |y| {float(np.abs(exact).max()):.1f} "
          f"({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

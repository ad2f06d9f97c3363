#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --out DIR        # also write the results as JSON

Phases, in order; a failing phase makes the run exit non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version on the card, in float32,
   at the smollm-135m shapes with tiles that are not powers of two;
4. the main path, part one: extract smollm-135m's dense, batch_matmul and
   attention tasks (batch 1, seq 256) and tune them on the ``cuda``
   backend through ``cached+local`` with a small budget;
5. the main path, part two: the full-width 30-layer bf16 forward under
   ``DispatchContext`` against the same forward with no context;
6. each kernel's time at its main-path shapes with the tuned tiles, beside
   its plain version, the one PyTorch call that computes the same function,
   and the least time the card could take.

Every kernel wrapper counts its launches; the counts are zeroed just before
the main path and read just after it.  TF32 is off for float32 matmuls in
this script (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set to False), so the plain
versions run in full float32.  The second-to-last line is a JSON object
with one entry per kernel; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's published peaks (H100 SXM data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

SEQ = 256
BATCH = 1
TOL_MATMUL = 2e-3  # f32, K <= 1536, N(0,1) inputs: |y| up to ~200
TOL_ATTN = 1e-4  # f32, outputs are convex combinations of v
TOL_LOGITS_REL = 5e-2  # bf16 plain forward vs f32 kernels cast to bf16


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import numpy as np
    import torch

    from repro_torch.search.measure.local import time_call

    return float(np.median(time_call(fn, torch.device("cuda"), reps, warmup))) * 1e3


def sdpa(q, k, v, causal: bool):
    """The library call that computes K3's function (a yardstick only)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True
    )


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def phase_build() -> float:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    dt = time.perf_counter() - t0
    print(f"[build] {sorted(built) or 'cached'} in {dt:.1f} s "
          f"into {_build.build_dir()}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}")
    return dt


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(gen) -> dict:
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref

    dev = "cuda"
    errs = {"matmul": 0.0, "batch_matmul": 0.0, "flash_attention": 0.0}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def report(kernel, label, got, want, tol, k_ms, p_ms, lib_ms=None, exact=None):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        errs[kernel] = max(errs[kernel], err)
        lib = f" library {lib_ms:.4f} ms" if lib_ms is not None else ""
        f64 = ""
        if exact is not None:  # the same product in float64, as a witness
            f64 = (f" (kernel vs float64 {float((got.double() - exact).abs().max()):.3e},"
                   f" plain vs float64 {float((want.double() - exact).abs().max()):.3e})")
        print(f"[kernels] {kernel} {label}: max_abs_err {err:.3e} (tol {tol:g}){f64} "
              f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms{lib}")
        if not math.isfinite(err) or err > tol:
            fail(f"{kernel} {label}: max_abs_err {err} > {tol}")

    M = BATCH * SEQ
    dense_shapes = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
    tiles = [(64, 96, 48), (32, 192, 64), (128, 64, 96), (256, 48, 32)]
    for (K, N), blocks in zip(dense_shapes, tiles):
        x, w = randn(M, K), randn(K, N)
        bias = randn(N)
        bs = mm.launch_config(1, M, N, K, mm._clamp(blocks, M, N, K))["blocks"]
        for epi in ("none", "bias", "relu", "gelu", "silu", "softcap"):
            b = bias if epi == "bias" else None
            got = mm.matmul(x, w, b, epilogue=epi, block_sizes=bs)
            want = ref.matmul(x, w, b, epilogue=epi)
            k_ms = median_ms(lambda: mm.matmul(x, w, b, epilogue=epi, block_sizes=bs))
            p_ms = median_ms(lambda: ref.matmul(x, w, b, epilogue=epi))
            lib_ms = None
            if epi == "none":
                lib_ms = median_ms(lambda: torch.matmul(x, w))
            elif epi == "bias":
                lib_ms = median_ms(lambda: torch.addmm(b, x, w))
            exact = x.double() @ w.double() if epi == "none" else None
            report("matmul", f"({M},{N},{K}) {epi} blocks {bs}", got, want,
                   TOL_MATMUL, k_ms, p_ms, lib_ms, exact)
    # the tied unembed: the (vocab, d) table read transposed, no copy
    table = randn(49152, 576)
    x = randn(M, 576)
    wt = table.t()
    bs = (64, 192, 64)
    got = mm.matmul(x, wt, block_sizes=bs)
    want = ref.matmul(x, wt)
    report("matmul", f"unembed ({M},49152,576) transposed blocks {bs}", got, want,
           TOL_MATMUL, median_ms(lambda: mm.matmul(x, wt, block_sizes=bs)),
           median_ms(lambda: ref.matmul(x, wt)),
           median_ms(lambda: torch.matmul(x, wt)), x.double() @ wt.double())

    # K2: the attention contractions in canonical layout (B·KVH, G·S, ·)
    H, KVH, D = 9, 3, 64
    G = H // KVH
    for (Bb, Mm, Kk, Nn), bs in (
        ((KVH, G * SEQ, D, SEQ), (96, 64, 32)),
        ((KVH, G * SEQ, SEQ, D), (48, 64, 128)),
    ):
        a, b = randn(Bb, Mm, Kk), randn(Bb, Kk, Nn)
        got = mm.batch_matmul(a, b, block_sizes=bs)
        want = ref.batch_matmul(a, b)
        report("batch_matmul", f"({Bb},{Mm},{Nn},{Kk}) blocks {bs}", got, want,
               TOL_MATMUL, median_ms(lambda: mm.batch_matmul(a, b, block_sizes=bs)),
               median_ms(lambda: ref.batch_matmul(a, b)),
               median_ms(lambda: torch.bmm(a, b)), a.double() @ b.double())

    # K3: causal, sliding window, softcap, GQA 9/3, at S=256 and S=96
    for S in (SEQ, 96):
        q = randn(BATCH, H, S, D)
        k, v = randn(BATCH, KVH, S, D), randn(BATCH, KVH, S, D)
        for label, kw, blocks in (
            ("causal", dict(causal=True), (64, 32)),
            ("causal window=64", dict(causal=True, window=64), (32, 64)),
            ("causal softcap=50", dict(causal=True, softcap=50.0), (48, 96)),
            ("full", dict(causal=False), (128, 128)),
        ):
            bq, bkv = blocks
            got = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
            want = ref.flash_attention(q, k, v, **kw)
            lib_ms = None
            if "window" not in kw and "softcap" not in kw:
                lib_ms = median_ms(lambda: sdpa(q, k, v, kw["causal"]))
            snapped = fa.flash_attention.last_launch["blocks"]
            report("flash_attention",
                   f"(1,{H},{S},{D}) kvh {KVH} {label} blocks {snapped}",
                   got, want, TOL_ATTN,
                   median_ms(lambda: fa.flash_attention(
                       q, k, v, block_q=bq, block_kv=bkv, **kw)),
                   median_ms(lambda: ref.flash_attention(q, k, v, **kw)), lib_ms)
    return errs


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------

KERNELS = ("matmul", "batch_matmul", "flash_attention")


def _wrappers():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm

    return {"matmul": mm.matmul, "batch_matmul": mm.batch_matmul,
            "flash_attention": fa.flash_attention}


def reset_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def read_counts() -> dict:
    return {k: w.launches for k, w in _wrappers().items()}


def phase_tune(cfg, db):
    import repro_torch
    from repro_torch.search.evolutionary import SearchConfig

    t0 = time.perf_counter()
    tasks = repro_torch.extract_tasks(
        cfg, batch=BATCH, seq=SEQ, dispatchable_only=True,
        ops=("dense", "batch_matmul", "attention"),
    )
    print(f"[tune] extracted {len(tasks)} tasks in {time.perf_counter() - t0:.1f} s")
    for t in tasks:
        print(f"[tune]   {t.key} weight {t.weight:g}")
    search = SearchConfig(
        max_trials=32, init_random=8, population=16, measure_per_round=8,
        rollout_factor=2,
    )
    config = repro_torch.TuneConfig(
        search=search, runner_spec="cached+local", backend="cuda",
        device="cuda", warm_start=False,
    )
    t0 = time.perf_counter()
    sched = repro_torch.TaskScheduler(tasks, database=db, config=config)
    best = sched.tune(total_rounds=4 * len(tasks))
    print(f"[tune] {sched.rounds_run} rounds in {time.perf_counter() - t0:.1f} s; "
          f"runner stats {sched.runner.stats()}")
    for key, lat in best.items():
        if not math.isfinite(lat):
            fail(f"task {key} has no finite best latency")
    reasons = Counter(failure_reason(err) for search in sched.searches
                      for _, err in search.errors)
    print(f"[tune] failed candidates by reason: {dict(reasons)}")
    others = [r for r in reasons if not r.startswith(EXPECTED_FAILURES)]
    if others:
        fail(f"candidates failed for reasons other than a rejection: {others}")
    return tasks, best


# what a candidate may fail with: a tile the card cannot run, a trace the
# validator refuses, or a first call over the runner's timeout
EXPECTED_FAILURES = ("rejected (", "invalid trace", "timeout")


def failure_reason(err: str) -> str:
    """A candidate's error without its numbers: ``rejected (grid)``,
    ``invalid trace``, ``timeout``, or the whole error if it is none of
    these."""
    if err.startswith("rejected ("):
        return err.split(":", 1)[0]
    for kind in EXPECTED_FAILURES[1:]:
        if err.startswith(kind):
            return kind
    return err


def check_tiles(tasks, db) -> dict:
    """Replay each task's best record and check that the kernel launched
    with the record's snapped tile: grid, threads and shared memory follow
    from those blocks alone."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.search.measure.local import device_inputs
    from repro_torch.search.tune import apply_trace

    runs = {}
    for t in tasks:
        rec = db.best(t.key)
        meta = rec.meta
        snapped = tuple(meta["pallas_blocks_snapped"])
        _, lowered = apply_trace(t.func, rec.trace(), backend="cuda")
        ins = device_inputs(t.func, torch.device("cuda"))
        lowered.fn(ins)
        torch.cuda.synchronize()
        kern = meta["pallas_kernel"]
        last = _wrappers()[kern].last_launch
        shapes = [b.shape for b in t.func.inputs]
        if kern == "flash_attention":
            b, kvh, g, s, d = shapes[0]
            bq, bkv = snapped
            want = dict(grid=(s // bq, b * kvh * g), threads=fa.THREADS,
                        smem_bytes=fa.smem_bytes(bq, bkv, d))
        else:
            if kern == "matmul":
                (M, K), (_, N), B = shapes[0], shapes[1], 1
            else:
                (B, M, K), N = shapes[0], shapes[1][2]
            bm, bn, bk = snapped
            want = dict(grid=(N // bn, M // bm, B),
                        threads=mm.micro_tile(bm, bn)[1],
                        smem_bytes=4 * (bm * bk + bk * bn))
        got = {k: last[k] for k in want}
        print(f"[tiles] {t.key}: sampled {meta.get('pallas_blocks_sampled')} "
              f"snapped {list(snapped)} -> grid {last['grid']} threads "
              f"{last['threads']} smem {last['smem_bytes']} B; best "
              f"{rec.latency_s * 1e3:.4f} ms")
        if tuple(last["blocks"]) != snapped or got != want:
            fail(f"{t.key}: launch {last} does not follow snapped blocks {snapped}")
        runs[t.key] = (kern, snapped, shapes)
    return runs


def phase_forward(cfg, tasks, db, gen_seed: int = 0):
    import torch

    import repro_torch
    from repro_torch.models import transformer as T

    params = T.init_params(cfg, seed=gen_seed, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(gen_seed + 1)
    toks = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=g, device="cuda")

    def timed(fn, n=3):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return out, sorted(ts)[len(ts) // 2] * 1e3

    with torch.no_grad():
        T.forward(cfg, params, toks)  # warm the plain path
        plain, plain_ms = timed(lambda: T.forward(cfg, params, toks))
        ctx = repro_torch.DispatchContext(db, tasks=tasks, backend="cuda")
        reset_counts()
        with ctx:
            tuned = T.forward(cfg, params, toks)
        torch.cuda.synchronize()
        fwd_counts = read_counts()
        stats, by_key = dict(ctx.stats), ctx.stats_by_key()  # this one forward
        with ctx:
            _, tuned_ms = timed(lambda: T.forward(cfg, params, toks))
    diff = (tuned.float() - plain.float()).abs()
    max_abs = float(diff.max())
    rel = max_abs / float(plain.float().abs().max())
    print(f"[forward] logits {tuple(tuned.shape)} {tuned.dtype}; max_abs_err "
          f"{max_abs:.4e} max_rel_err {rel:.4e} (tol {TOL_LOGITS_REL:g})")
    print(f"[forward] plain {plain_ms:.2f} ms, dispatched {tuned_ms:.2f} ms "
          f"(median of 3, batch {BATCH} seq {SEQ})")
    print(f"[forward] dispatch stats of one forward {stats}")
    reasons = {}
    for key, row in by_key.items():
        print(f"[forward]   {key}: hits {row['hits']} misses {row['misses']} "
              f"fallbacks {row['fallbacks']} reasons {row['reasons']}")
        for r, n in row["reasons"].items():
            reasons[r] = reasons.get(r, 0) + n
    print(f"[forward] kernel launches in one dispatched forward: {fwd_counts}")
    if not torch.isfinite(tuned.float()).all():
        fail("dispatched logits are not finite")
    if tuned.shape != (BATCH, SEQ, cfg.vocab):
        fail(f"logits shape {tuple(tuned.shape)}")
    if rel > TOL_LOGITS_REL:
        fail(f"logits rel err {rel} > {TOL_LOGITS_REL}")
    if stats["hits"] <= 0:
        fail("no dispatch hits")
    if reasons.get("lowering_failed"):
        fail(f"{reasons['lowering_failed']} lowering_failed misses")
    for k in ("matmul", "flash_attention"):
        if fwd_counts[k] <= 0:
            fail(f"{k} was not launched in the dispatched forward")
    return dict(max_abs_err=max_abs, max_rel_err=rel, plain_ms=plain_ms,
                dispatched_ms=tuned_ms, stats=stats,
                reasons=reasons), fwd_counts


# ---------------------------------------------------------------------------
# phase 6: tuned-tile timings at the main path's shapes
# ---------------------------------------------------------------------------


def phase_timings(tasks, runs, gen, vocab: int) -> dict:
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref

    rows = {}
    for t in tasks:
        kern, snapped, shapes = runs[t.key]
        if kern == "matmul":
            (M, K), (_, N) = shapes[0], shapes[1]
            x = torch.randn(M, K, generator=gen, device="cuda")
            w = torch.randn(K, N, generator=gen, device="cuda")
            if N == vocab:  # the tied unembed reads the table transposed
                w = torch.randn(N, K, generator=gen, device="cuda").t()
            k_ms = median_ms(lambda: mm.matmul(x, w, block_sizes=snapped))
            p_ms = median_ms(lambda: ref.matmul(x, w))
            l_ms = median_ms(lambda: torch.matmul(x, w))
            flops, nbytes = 2 * M * N * K, 4 * (M * K + K * N + M * N)
        elif kern == "batch_matmul":
            (B, M, K), N = shapes[0], shapes[1][2]
            a = torch.randn(B, M, K, generator=gen, device="cuda")
            b = torch.randn(B, K, N, generator=gen, device="cuda")
            k_ms = median_ms(lambda: mm.batch_matmul(a, b, block_sizes=snapped))
            p_ms = median_ms(lambda: ref.batch_matmul(a, b))
            l_ms = median_ms(lambda: torch.bmm(a, b))
            flops = 2 * B * M * N * K
            nbytes = 4 * B * (M * K + K * N + M * N)
        else:
            b, kvh, g, s, d = shapes[0]
            h = kvh * g
            q = torch.randn(b, h, s, d, generator=gen, device="cuda")
            k = torch.randn(b, kvh, s, d, generator=gen, device="cuda")
            v = torch.randn(b, kvh, s, d, generator=gen, device="cuda")
            bq, bkv = snapped
            k_ms = median_ms(lambda: fa.flash_attention(
                q, k, v, causal=True, block_q=bq, block_kv=bkv))
            p_ms = median_ms(lambda: ref.flash_attention(q, k, v, causal=True))
            l_ms = median_ms(lambda: sdpa(q, k, v, True))
            # causal: only the s(s+1)/2 unmasked pairs need work
            flops = 4 * b * h * d * (s * (s + 1) // 2)
            nbytes = 4 * (2 * b * h * s * d + 2 * b * kvh * s * d)
        b_ms, b_by = bound(flops, nbytes)
        rows[t.key] = dict(kernel=kern, blocks=list(snapped), ms=k_ms,
                           plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                           bound_by=b_by, weight=t.weight, flops=flops)
        print(f"[time] {t.key} {kern} blocks {list(snapped)}: kernel {k_ms:.4f} ms "
              f"plain {p_ms:.4f} ms library {l_ms:.4f} ms bound {b_ms:.4f} ms "
              f"({b_by})")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory to write chip_smoke.json into")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          "allow_tf32 False (matmul, cudnn)")

    from repro_torch.configs.base import get_config
    from repro_torch.search.database import Database

    build_s = phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = phase_kernels(gen)

    cfg = get_config("smollm-135m")
    db = Database()
    reset_counts()  # the main path starts here
    tasks, best = phase_tune(cfg, db)
    tune_counts = read_counts()
    print(f"[tune] kernel launches while tuning: {tune_counts}")
    for k in KERNELS:
        if tune_counts[k] <= 0:
            fail(f"{k} was not launched while tuning")
    runs = check_tiles(tasks, db)
    fwd, fwd_counts = phase_forward(cfg, tasks, db)
    launches = {k: tune_counts[k] + fwd_counts[k] for k in KERNELS}

    rows = phase_timings(tasks, runs, gen, cfg.vocab)
    sources = {
        "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:46"),
        "batch_matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                         "src/repro/kernels/matmul.py:114"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:96"),
    }
    entries = []
    for k in KERNELS:
        # the main-path shape where the kernel has the most work
        key = max((r for r in rows if rows[r]["kernel"] == k),
                  key=lambda r: rows[r]["weight"] * rows[r]["flops"])
        r = rows[key]
        entries.append(dict(
            name=k, route="cuda", source=sources[k][0], replaces=sources[k][1],
            launches=launches[k], forward_launches=fwd_counts[k],
            max_abs_err=errs[k], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=key, blocks=r["blocks"],
        ))
    total_s = time.perf_counter() - t_start
    print(f"[done] build {build_s:.1f} s, total {total_s:.1f} s")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           total_s=total_s, kernels=entries, timings=rows,
                           forward=fwd, tune_best=best,
                           tune_launches=tune_counts), f, indent=1)
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

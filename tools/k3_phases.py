#!/usr/bin/env python3
"""Where K3's tc kernel spends its time: per-CTA phase stamps on the card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 tools/k3_phases.py [--tiles 8,128 16,32] [--out OUT.json]

It builds a copy of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(under ``build/k3_phases/``) in which thread 0 of every CTA of the tc
kernel writes ``%globaltimer`` at five points: after its Q loads are
split, when the first copies have landed, after the kv loop, when the
output is ready to store (the splits combined), and at its end; with its
start and its SM.  Each tile of ``--tiles`` then runs at smollm-135m's
forward shape (batch 1, 9 heads over 3 kv heads, 256 tokens, head dim 64,
causal) with the plan ``kernels/flash_attention.py:launch_config`` gives.
Printed, and written to ``--out`` as JSON, for each tile: the device time
of the unmodified kernel (CUDA events around a graph of 20 calls, as
``chip_smoke.py`` times it), the stamped kernel's error against the plain
version, the spread of the CTAs' starts and ends, and each phase's mean
and largest time over the CTAs, and the phases of the CTA that ended last.

Exits 2 without a card; prints no result then.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("q", "first copy", "kv loop", "combine", "store")

STAMP = """__device__ __forceinline__ unsigned long long k3_time() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned k3_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %smid;" : "=r"(s));
  return s;
}
#define K3_STAMP(i) if (threadIdx.x == 0) k3_dbg[blockIdx.x * 8 + (i)] = k3_time();
"""

# (text of the source, what goes before it) or (text, what replaces it)
EDITS = (
    ("// One CTA: rows [16*mw*grp", STAMP + "// One CTA: rows [16*mw*grp", "before"),
    ("  const int G = H / KVH, R = G * bq;\n",
     "  const int G = H / KVH, R = G * bq;\n"
     "  unsigned long long* k3_dbg = reinterpret_cast<unsigned long long*>(\n"
     "      o + (long long)B * H * S * 8 * ND);\n"
     "  K3_STAMP(0);\n  if (threadIdx.x == 0) k3_dbg[blockIdx.x * 8 + 7] = k3_smid();\n",
     "replace"),
    # the first Q value is needed before the stamp, so the loads are not
    # sunk below it
    ("  // rows g and g + 8: running max",
     "  if (qhi[0][0] == 0x7fffffffu) o[0] = 0.f;\n  K3_STAMP(1);\n", "before"),
    ("    __syncthreads();\n    if (r < cnt) {",
     "    __syncthreads();\n    if (r == 0) K3_STAMP(2);\n    if (r < cnt) {", "replace"),
    ("  l_a = quad_sum(l_a);\n", "  K3_STAMP(3);\n", "before"),
    ("    const float inv_a = 1.f / fmaxf(l_a, 1e-30f)", "    K3_STAMP(4);\n", "before"),
    ("                                             acc[n], inv_a, inv_b);\n    return;",
     "                                             acc[n], inv_a, inv_b);\n"
     "    K3_STAMP(5);\n    return;", "replace"),
    ("  const float inv_a = 1.f / fmaxf(sl_a, 1e-30f)", "  K3_STAMP(4);\n", "before"),
    ("    store_rows(o, row_a, row_b, in_a, in_b, 8 * n + 2 * tig, sum, inv_a, inv_b);\n  }\n}",
     "    store_rows(o, row_a, row_b, in_a, in_b, 8 * n + 2 * tig, sum, inv_a, inv_b);\n"
     "  }\n  K3_STAMP(5);\n}", "replace"),
)


def stamped_source(src: str) -> str:
    """The tc kernel's source with the stamps; raises if a marker moved."""
    for text, new, how in EDITS:
        if src.count(text) != 1:
            raise SystemExit(f"k3_phases: marker not found once in the source: {text!r}")
        src = src.replace(text, new + text if how == "before" else new)
    return src


def build(out_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.included_headers(_build.SOURCES["flash_attention"]):
        (out_dir / header.name).write_bytes(header.read_bytes())
    src = out_dir / "flash_attention.cu"
    src.write_text(stamped_source(_build.SOURCES["flash_attention"].read_text()))
    lib_path = out_dir / "flash_attention_stamped.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_flash_attention_tc.argtypes = [P] * 4 + [I] * 14 + [Fl, I, I, Fl, I, P]
    lib.repro_flash_attention_tc.restype = I
    return lib


def phases(lib, q, k, v, bq: int, bkv: int) -> dict:
    import torch

    from chip_smoke import graph_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, sm_count

    B, H, S, D = q.shape
    KVH = k.shape[1]
    plan = fa.launch_config(B, H, KVH, S, D, bq, bkv, sm_count(q.device))
    if plan["variant"] != "tc":
        raise SystemExit(f"k3_phases: ({bq}, {bkv}) takes {plan['variant']}, not tc")
    ctas = plan["grid"][0]
    buf = torch.zeros(q.numel() + 16 * ctas, device=q.device)

    def call():
        err = lib.repro_flash_attention_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), B, H, KVH, S, D,
            bq, bkv, plan["groups"], plan["m_warps"], plan["tiles"], plan["sub"],
            plan["stages"], plan["kv_step"], 1, D ** -0.5, 1, 0, 0.0,
            plan["smem_bytes"], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"k3_phases: launch failed with {err}")

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    err = float((buf[: q.numel()].view(q.shape) - ref.flash_attention(q, k, v)).abs().max())
    st = buf[q.numel():].view(torch.int64).view(ctas, 8).cpu()
    t = (st[:, :6] - st[:, 0].min()).double() / 1e3  # us from the first start
    d = t[:, 1:] - t[:, :-1]
    last = int(t[:, 5].argmax())
    return dict(
        blocks=[bq, bkv], ctas=ctas, sms=len(set(st[:, 7].tolist())),
        splits=plan["splits"], tiles=plan["tiles"], sub=plan["sub"], stages=plan["stages"],
        device_ms=graph_ms(lambda: fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)),
        max_abs_err=err, start_spread_us=float(t[:, 0].max()), end_us=float(t[:, 5].max()),
        phase_mean_us={p: float(d[:, i].mean()) for i, p in enumerate(PHASES)},
        phase_max_us={p: float(d[:, i].max()) for i, p in enumerate(PHASES)},
        last_cta_us={p: float(d[last, i]) for i, p in enumerate(PHASES)},
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", nargs="+", default=["8,128", "16,32", "16,16", "64,64"],
                    help="(block_q, block_kv) tiles as bq,bkv")
    ap.add_argument("--out", default=None, help="JSON file to write")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("k3_phases: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    lib = build(ROOT / "build" / "k3_phases")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 9, 256, 64, generator=g, device="cuda")
    k = torch.randn(1, 3, 256, 64, generator=g, device="cuda")
    v = torch.randn(1, 3, 256, 64, generator=g, device="cuda")
    rows = []
    for tile in args.tiles:
        bq, bkv = (int(x) for x in tile.split(","))
        r = phases(lib, q, k, v, bq, bkv)
        rows.append(r)
        print(f"({bq}, {bkv}): {r['ctas']} CTAs on {r['sms']} SMs, {r['splits']} splits "
              f"({r['tiles']} runs x {r['sub']} parts), {r['stages']} stage(s); device "
              f"{r['device_ms']:.4f} ms; stamped max_abs_err {r['max_abs_err']:.2e}; starts "
              f"within {r['start_spread_us']:.2f} us, last end {r['end_us']:.2f} us")
        for key in ("phase_mean_us", "phase_max_us", "last_cta_us"):
            print(f"   {key}: " + ", ".join(f"{p} {x:.2f}" for p, x in r[key].items()))
    if args.out:
        Path(args.out).write_text(json.dumps(dict(card=card, tiles=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

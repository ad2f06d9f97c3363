"""Batched serving on PyTorch and CUDA: prefill + decode a smoke gemma2-2b
with the KV cache engine, on the card.

    PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]

``--device`` defaults to ``cuda``; asking for the card without one raises.
"""
import argparse

from repro_torch.launch import serve as serve_launcher

REQUESTS = 8

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: cuda)")
    args = ap.parse_args()
    reqs = serve_launcher.main([
        "--arch", "gemma2-2b", "--requests", str(REQUESTS),
        "--prompt-len", "32", "--new-tokens", "12", "--max-batch", "4",
        "--device", args.device,
    ])
    done = sum(r.done and len(r.generated) == 12 for r in reqs)
    print(f"served {done}/{len(reqs)} requests on {args.device}")
    if done != REQUESTS:
        raise SystemExit(f"serve_batched_torch: {done} of {REQUESTS} requests finished")

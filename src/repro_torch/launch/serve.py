"""Serving launcher: batched requests against a smoke-config model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --requests 8 --prompt-len 32 --new-tokens 16 [--device cpu]

Runs on the card unless ``--device cpu`` is given; asking for the card
without one raises.  ``--arch mamba2-370m`` serves the state-space model
(its SSD state in the cache; the prompt length must be at most 64 or a
multiple of 64, the scan's chunk rule); ``--arch olmoe-1b-7b`` and
``--arch arctic-480b`` serve the mixture-of-experts smoke models, and
``--arch qwen2-vl-2b`` the Qwen2-VL backbone (M-RoPE) from its tokens.
Serving prefills from tokens alone, as the reference's engine does, so
``--arch whisper-medium``, whose prefill needs the encoder's frames, is
refused.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..configs.base import ARCHS, get_config
from ..device import resolve_device
from ..models.registry import build_model
from ..serving.config import ServeConfig
from ..serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="smollm-135m")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    params = build_model(cfg).init(seed=0, device=dev)
    eng = ServingEngine(
        cfg, params,
        config=ServeConfig(
            max_slots=args.max_batch,
            max_seq=args.prompt_len + args.new_tokens + 8,
        ),
    )
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(
            rng.integers(0, cfg.vocab, args.prompt_len),
            max_new_tokens=args.new_tokens,
            temperature=args.temperature,
        )
    reqs = eng.run()
    for r in reqs[:4]:
        print(f"req {r.rid}: {r.generated[:10]} ...")
    s = eng.stats
    print(
        f"prefill {s['prefill_tokens']} tok in {s['prefill_s']:.2f}s | "
        f"decode {s['decode_steps']} steps in {s['decode_s']:.2f}s "
        f"({s['decode_steps']/max(s['decode_s'],1e-9):.1f} steps/s)"
    )
    return reqs


if __name__ == "__main__":
    main()

"""Serving launcher: ``python -m repro_torch.launch.serve --arch qwen3-8b``

Seeded random parameters (no weights are needed), a continuous-batching
:class:`~repro_torch.serving.engine.ServeEngine` over the paged KV cache,
``--requests`` short prompts.  Runs on the GPU; ``--device cpu`` asks for
the CPU (``--smoke`` shrinks the model to a CPU-sized one of the same
family).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from ..configs import CONFIGS
    from ..models import core as M
    from ..serving.engine import Request, ServeEngine
    cfg = CONFIGS[args.arch]
    if args.smoke:
        cfg = cfg.smoke()
    params = M.init_params(cfg, 0, device=args.device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                      device=args.device)
    for i in range(args.requests):
        eng.submit(Request(rid=i, prompt=[2 + i, 3, 4], max_new=args.max_new,
                           eos=1))
    t0 = time.time()
    done = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(f"{len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s) on {eng.device}; kv={eng.kv.stats}")
    return done


if __name__ == "__main__":
    main()

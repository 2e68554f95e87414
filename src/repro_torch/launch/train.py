"""Training launcher: ``python -m repro_torch.launch.train --arch ...``

The reference's flags, plus ``--device``: runs on the GPU; ``--device
cpu`` asks for the CPU (``--smoke`` shrinks the model to a CPU-sized one
of the same family).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt "
                         "under the temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..configs import CONFIGS
    from ..training.train_loop import train
    cfg = CONFIGS[args.arch]
    if args.smoke:
        cfg = cfg.smoke()
    losses = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                   ckpt_dir=args.ckpt, device=args.device)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()

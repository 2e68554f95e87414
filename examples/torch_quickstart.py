"""Quickstart on the port: train a reduced Qwen3-family model for a few
steps, then greedy-decode from it with the paged KV cache; on the CUDA
device by default (attention through the ``flash_attention`` kernel in
training, ``paged_attention`` in decode).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]
      [--steps 5] [--decode 8]
"""
import argparse
import sys

import numpy as np
import torch

sys.path.insert(0, __file__.rsplit("/examples/", 1)[0] + "/src")

from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import core as M  # noqa: E402
from repro_torch.training.optim import init_opt_state  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                help="where the model runs (default: the CUDA device)")
ap.add_argument("--steps", type=int, default=5, help="train steps")
ap.add_argument("--decode", type=int, default=8, help="greedy decode steps")
a = ap.parse_args()

cfg = CONFIGS["qwen3-8b"].smoke()
print(f"arch={cfg.name} (reduced): {cfg.n_layers}L d={cfg.d_model}")

params = M.init_params(cfg, seed=0, device=a.device)
opt_state = init_opt_state(params)
step = make_train_step(cfg)              # AdamW, the reference's defaults
rng = np.random.default_rng(0)
for i in range(a.steps):
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))
                            .astype(np.int32)).to(a.device)
    params, opt_state, metrics = step(params, opt_state,
                                      {"tokens": toks, "labels": toks})
    print(f"step {i}: loss={float(metrics['loss']):.4f} "
          f"gnorm={float(metrics['grad_norm']):.3f}")

state = M.make_decode_state(cfg, batch=2, max_seq=64, device=a.device)
toks = torch.tensor([5, 9], device=a.device)
out = []
with torch.no_grad():
    for _ in range(a.decode):
        logits, state = M.decode_step(cfg, params, state, toks)
        toks = logits.argmax(dim=-1)
        out.append(toks.cpu().numpy())
print("greedy decode:", np.stack(out, 1).tolist())

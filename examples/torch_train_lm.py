"""End-to-end training on the port with fault tolerance: trains a reduced
model, checkpointing every 50 steps and surviving an injected node
failure at step 120 (or half way, in a shorter run); on the CUDA device
by default (attention through the ``flash_attention`` kernel).

  PYTHONPATH=src python examples/torch_train_lm.py [steps]
      [--device cuda|cpu] [--ckpt-dir DIR]

The checkpoints go to ``--ckpt-dir`` (default ``repro_torch_train_demo``
under the temporary directory), which is emptied first.
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, __file__.rsplit("/examples/", 1)[0] + "/src")

from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.training.train_loop import FailureInjector, train  # noqa: E402,E501

ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
ap.add_argument("steps", nargs="?", type=int, default=200)
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                help="where the model trains (default: the CUDA device)")
ap.add_argument("--ckpt-dir", default=os.path.join(
    tempfile.gettempdir(), "repro_torch_train_demo"))
a = ap.parse_args()

steps = a.steps
shutil.rmtree(a.ckpt_dir, ignore_errors=True)
cfg = CONFIGS["chatglm3-6b"].smoke()
losses = train(cfg, steps=steps, batch=8, seq=64, ckpt_dir=a.ckpt_dir,
               ckpt_every=50,
               injector=FailureInjector(fail_at_steps=[min(120, steps//2)]),
               device=a.device)
print(f"{len(losses)} steps run (incl. replay); "
      f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")

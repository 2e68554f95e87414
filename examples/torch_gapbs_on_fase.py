"""An OpenMP-style multi-threaded graph benchmark (BFS) on the FASE
target of the PyTorch/CUDA port with 4 cores — dynamically scheduled
threads, futex barriers, and remote syscalls over the modelled UART.

  PYTHONPATH=src python examples/torch_gapbs_on_fase.py
      [--device cuda|cpu] [--target torch|pysim]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/examples/", 1)[0] + "/src")

from repro_torch.core.runtime import FaseRuntime  # noqa: E402
from repro_torch.core.workloads import build, graphgen  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                help="where TorchTarget runs (default: the CUDA device)")
ap.add_argument("--target", default="torch", choices=["torch", "pysim"],
                help="pysim: the port's pure-Python simulator")
a = ap.parse_args()
if a.target == "torch":
    from repro_torch.core.interface import TorchTarget
    tgt = TorchTarget(4, 1 << 23, device=a.device)
else:
    from repro_torch.core.target.pysim import PySim
    tgt = PySim(4, 1 << 23)

g = graphgen.rmat(7, 8, weights=True)
rt = FaseRuntime(tgt, mode="fase")
rt.load(build("bfs"), ["bfs", "g.bin", "4", "3"], files={"g.bin": g})
rep = rt.run(max_ticks=1 << 36)
print(rep.stdout.decode())
print(f"threads cloned: {rep.syscalls.get('clone')} | "
      f"futexes: {rep.syscalls.get('futex')} | "
      f"hfutex hits: {rep.hfutex['hits']}")
print(f"traffic by category: { {k: v for k, v in sorted(rep.traffic.items()) if v > 500} }")

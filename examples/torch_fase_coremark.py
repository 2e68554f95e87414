"""The paper's flagship demo on the PyTorch/CUDA port: CoreMark-lite on
the FASE target.

The benchmark binary (an assembled RV64 user program) runs on the port's
target — by default ``TorchTarget`` on the CUDA device, whose chunk
kernel runs the interpreter — and every syscall is served remotely by the
host runtime through the HTP/UART model: no OS, no SoC.

  PYTHONPATH=src python examples/torch_fase_coremark.py [iters]
      [--device cuda|cpu] [--target torch|pysim]
"""
import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/examples/", 1)[0] + "/src")

from repro_torch.core.runtime import FaseRuntime  # noqa: E402
from repro_torch.core.workloads import build  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
ap.add_argument("iters", nargs="?", default="2")
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                help="where TorchTarget runs (default: the CUDA device)")
ap.add_argument("--target", default="torch", choices=["torch", "pysim"],
                help="pysim: the port's pure-Python simulator")
a = ap.parse_args()
if a.target == "torch":
    from repro_torch.core.interface import TorchTarget
    tgt = TorchTarget(1, 1 << 22, device=a.device)
else:
    from repro_torch.core.target.pysim import PySim
    tgt = PySim(1, 1 << 22)

rt = FaseRuntime(tgt, mode="fase")
rt.load(build("coremark"), ["coremark", a.iters])
t0 = time.time()
rep = rt.run(max_ticks=1 << 36)
print(rep.stdout.decode())
print(f"target time {rep.seconds*1e3:.2f} ms @100MHz | "
      f"user time {rep.user_seconds*1e3:.2f} ms | wall {time.time()-t0:.1f}s")
print(f"syscalls: {rep.syscalls}")
print(f"UART traffic: {rep.traffic_total} bytes")

"""Serve a small model with batched requests through the port's paged-KV
engine (continuous batching + prefix sharing + stop-mask polling), on the
CUDA device by default: decode attention through the ``paged_attention``
kernel, page zeroing through ``page_set``.

  PYTHONPATH=src python examples/torch_serve_paged.py [--device cuda|cpu]

Prints the lines ``examples/serve_paged.py`` prints.  The port draws its
own seeded weights and keeps one global KV pool, so its tokens are not the
reference's (whose requests outside slot 0 decode token 0); the steps,
page statistics and traffic are.
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/examples/", 1)[0] + "/src")

from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.models import core as M  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                help="where the model and the engine run (default: the "
                     "CUDA device)")
a = ap.parse_args()

cfg = CONFIGS["qwen3-8b"].smoke()
params = M.init_params(cfg, 0, device=a.device)
eng = ServeEngine(cfg, params, slots=4, max_seq=128, poll_every=4,
                  device=a.device)
shared_prefix = list(range(2, 2 + 66))    # spans >1 page: prefix-shared
for i in range(6):
    eng.submit(Request(rid=i, prompt=shared_prefix + [100 + i],
                       max_new=8, eos=1))
done = eng.run()
for r in sorted(done, key=lambda r: r.rid):
    print(f"req {r.rid}: {len(r.out)} tokens -> {r.out[:8]}")
print(f"steps={eng.steps} kv={eng.kv.stats}")
print(f"traffic h2d={eng.traffic.h2d_bytes}B d2h={eng.traffic.d2h_bytes}B "
      f"by_cat={eng.traffic.by_cat}")

"""Run one guest workload end to end on the PyTorch target."""
from __future__ import annotations

import time

from .core.interface import TorchTarget
from .core.runtime import FaseRuntime
from .core.workloads import build


def run_workload(name, argv_tail, mode="fase", n_cores=4, baud=921600,
                 hfutex=True, files=None, mem=1 << 23, target="torch",
                 device="cuda", max_ticks=1 << 36, link=None,
                 session="async", queue_depth=8, coalesce_ticks=50,
                 host_us_per_req=12.0, arg_prefetch=False,
                 ctrl_serialize=False, target_opts=None):
    """Build ``name``, load it with ``[name] + argv_tail`` (and ``files``)
    into a :class:`~repro_torch.core.runtime.FaseRuntime` over a
    :class:`~repro_torch.core.interface.TorchTarget` on ``device`` and run
    it to completion.  ``target_opts`` are extra ``TorchTarget`` kwargs
    (``issue_width``/``block_words``/``block_cache``/``fetch_kernel``/
    ``dtlb_ways``), e.g. from
    :func:`repro_torch.configs.fase_rocket.target_kwargs`.  Returns
    ``(runtime, report, wall_seconds)``; the wall clock stops after the
    device has finished."""
    if target != "torch":
        raise ValueError(f"repro_torch runs target='torch' only, "
                         f"got {target!r}")
    tgt = TorchTarget(n_cores, mem, device=device, **(target_opts or {}))
    rt = FaseRuntime(tgt, mode=mode, baud=baud, hfutex=hfutex, link=link,
                     session=session, queue_depth=queue_depth,
                     coalesce_ticks=coalesce_ticks,
                     host_us_per_req=host_us_per_req,
                     arg_prefetch=arg_prefetch,
                     ctrl_serialize=ctrl_serialize)
    rt.load(build(name), [name] + argv_tail, files=files or {})
    t0 = time.time()
    rep = rt.run(max_ticks=max_ticks)
    if tgt.device.type == "cuda":
        import torch
        torch.cuda.synchronize(tgt.device)
    wall = time.time() - t0
    return rt, rep, wall

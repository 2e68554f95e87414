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
                 ctrl_serialize=False, target_opts=None, telemetry=None):
    """Build ``name``, load it with ``[name] + argv_tail`` (and ``files``)
    into a :class:`~repro_torch.core.runtime.FaseRuntime` over a
    :class:`~repro_torch.core.interface.TorchTarget` on ``device`` and run
    it to completion.  ``target="pysim"`` runs it on this package's
    pure-Python :class:`~repro_torch.core.target.pysim.PySim` instead (the
    oracle; ``device`` and ``target_opts`` do not apply).
    ``target_opts`` are extra ``TorchTarget`` kwargs (``issue_width``/
    ``block_words``/``block_cache``/``fetch_kernel``/``dtlb_ways``/
    ``chunk_kernel``), e.g. from
    :func:`repro_torch.configs.fase_rocket.target_kwargs`.  ``telemetry``
    arms the out-of-band bridges — a
    :class:`~repro_torch.telemetry.TelemetryHub` kwargs dict, e.g.
    :func:`repro_torch.configs.fase_rocket.telemetry_kwargs`.
    ``target="fleet-vmap"`` runs the workload on board 0 of a one-board
    :class:`~repro_torch.core.fleet.vmap.FleetTarget` (the stacked fleet
    path: on the card each chunk is a launch of the fleet chunk kernel),
    which must stay tick-identical to ``target="torch"``.  Returns
    ``(runtime, report, wall_seconds)``; the wall clock stops after the
    device has finished."""
    if target == "torch":
        tgt = TorchTarget(n_cores, mem, device=device, **(target_opts or {}))
    elif target == "pysim":
        from .core.target.pysim import PySim
        tgt = PySim(n_cores, mem)
    elif target == "fleet-vmap":
        from .core.fleet.vmap import FleetTarget
        tgt = FleetTarget(1, n_cores, mem, device=device,
                          **(target_opts or {})).view(0)
    else:
        raise ValueError(f"repro_torch runs target='torch', 'fleet-vmap' "
                         f"or 'pysim', got {target!r}")
    rt = FaseRuntime(tgt, mode=mode, baud=baud, hfutex=hfutex, link=link,
                     session=session, queue_depth=queue_depth,
                     coalesce_ticks=coalesce_ticks,
                     host_us_per_req=host_us_per_req,
                     arg_prefetch=arg_prefetch,
                     ctrl_serialize=ctrl_serialize, telemetry=telemetry)
    rt.load(build(name), [name] + argv_tail, files=files or {})
    t0 = time.time()
    rep = rt.run(max_ticks=max_ticks)
    if getattr(tgt, "device", None) is not None and \
            tgt.device.type == "cuda":
        import torch
        torch.cuda.synchronize(tgt.device)
    wall = time.time() - t0
    return rt, rep, wall

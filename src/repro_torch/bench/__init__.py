"""The port's benchmark scripts, each run as ``python -m
repro_torch.bench.<name>`` (``PYTHONPATH=src``), and their runner,
``python -m repro_torch.bench``, which lists them (and, with ``--run``,
runs the seventeen twins of the reference's panels in
:data:`RUN_ORDER`).

They live here, not in the reference's ``benchmarks`` package, whose
runner (``benchmarks/run.py``) asserts that every module of that package
is one of its registered panels.  The same rule holds here:
:func:`audit` fails when a module of this package is neither in
:data:`SCRIPTS` nor in :data:`EXCLUDED`.
"""
from __future__ import annotations

#: the runnable scripts, by module name, in the order
#: ``python -m repro_torch.bench`` lists them
SCRIPTS = ("decode_kernels", "paged_attention_timeline", "port_kernels",
           "dryrun_sweep", "profile_drop",
           # the paper's FASE panels (twins of the reference's benchmarks)
           "htp_vs_direct", "stall_breakdown", "gapbs_accuracy",
           "coremark_accuracy", "baud_sweep", "hfutex_bench", "scale_sweep",
           "arg_prefetch",
           # the speed panels (twins of the reference's target_speed and
           # speedup)
           "target_speed", "speedup",
           # the fleet panels (twins of the reference's multi-board ones)
           "fleet_scale", "net_scale", "stall_attribution", "migration",
           # the LM-side twins
           "serving_traffic", "roofline", "hillclimb")
#: the paper's eight FASE panels of :data:`SCRIPTS`, in its order
PANELS = SCRIPTS[5:13]
#: the two speed panels of :data:`SCRIPTS`: guest instructions per second
#: of each interpreter route, and wall a CoreMark iteration against PySim
SPEED_PANELS = SCRIPTS[13:15]
#: the fleet panels of :data:`SCRIPTS`: their boards are targets of the
#: panel's kind behind one ``FleetRuntime``
FLEET_PANELS = SCRIPTS[15:19]
#: the LM-side twins of :data:`SCRIPTS`: the serving engine's poll sweep
#: and co-residency, and two readings of the port's dry run
LM_PANELS = SCRIPTS[19:]
#: the twins ``python -m repro_torch.bench --run`` runs, in the order of
#: the reference's runner (``benchmarks/run.py``)
RUN_ORDER = ("target_speed", "htp_vs_direct", "coremark_accuracy",
             "speedup", "gapbs_accuracy", "stall_breakdown", "baud_sweep",
             "hfutex_bench", "scale_sweep", "serving_traffic",
             "arg_prefetch", "fleet_scale", "net_scale", "migration",
             "roofline", "stall_attribution", "hillclimb")
#: the twins of :data:`RUN_ORDER` that run on the host whatever the card
#: (they take no ``target``)
HOST_ONLY = frozenset(("hillclimb",))
#: modules of this package that are not scripts
EXCLUDED = frozenset(("__main__", "timing", "panels"))


def audit() -> None:
    """Every module of this package is a registered script or excluded,
    and every registered script exists."""
    import pkgutil
    on_disk = {m.name for m in pkgutil.iter_modules(__path__)}
    missing = on_disk - set(SCRIPTS) - EXCLUDED
    assert not missing, (
        f"module(s) {sorted(missing)} of repro_torch.bench are neither in "
        f"SCRIPTS nor EXCLUDED")
    gone = set(SCRIPTS) - on_disk
    assert not gone, f"registered script(s) {sorted(gone)} do not exist"

"""The port's benchmark scripts, each run as ``python -m
repro_torch.bench.<name>`` (``PYTHONPATH=src``), and their runner,
``python -m repro_torch.bench``, which lists them.

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
           "dryrun_sweep",
           # the paper's FASE panels (twins of the reference's benchmarks)
           "htp_vs_direct", "stall_breakdown", "gapbs_accuracy",
           "coremark_accuracy", "baud_sweep", "hfutex_bench", "scale_sweep",
           "arg_prefetch")
#: the FASE panels of :data:`SCRIPTS`, in the paper's order
PANELS = SCRIPTS[4:]
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

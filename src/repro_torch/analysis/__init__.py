"""HTP hazard analyzer: static verification of protocol correctness.

The port's copy of the reference's ``repro.analysis``, over this
package's protocol tables, session and ``TorchTarget``; the linter scans
the port's own modules.  Three cooperating pieces (see the module
docstrings for the models):

  * :mod:`repro_torch.analysis.footprints` — declarative read/write sets
    for every Table II opcode, pinned against ``htp.SPECS`` at import;
  * :mod:`repro_torch.analysis.trace` /
    :mod:`repro_torch.analysis.detector` — the zero-cost session trace
    hook and the happens-before race detector over it;
  * :mod:`repro_torch.analysis.lint` — the static protocol linter
    (spec-table consistency, builder arity, host-sync antipatterns).

``python -m repro_torch.analysis`` is the CLI (``lint`` / ``race`` /
``footprints`` / ``gate``); ``tests/test_torch_analysis.py`` arms the
detector over every async session its tests build and runs ``gate``.
"""
from .detector import Access, Finding, detect, summarize
from .footprints import ARG_SPECS, conflicts, footprint, key_args
from .lint import (LintFinding, lint_all, lint_builders, lint_sources,
                   lint_specs)
from .trace import (SERIAL_DOMAIN, HtpTrace, TraceEvent, TraceRecorder,
                    attach_trace, session_is_serial)

__all__ = [
    "ARG_SPECS", "Access", "Finding", "HtpTrace", "LintFinding",
    "SERIAL_DOMAIN", "TraceEvent", "TraceRecorder", "attach_trace",
    "conflicts", "detect", "footprint", "key_args", "lint_all",
    "lint_builders", "lint_sources", "lint_specs", "session_is_serial",
    "summarize",
]

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def pytest_configure(config):
    # Soft per-test timeout so a completion-queue deadlock fails the run
    # fast instead of hanging it.  Armed only when pytest-timeout is
    # installed (CI always installs it; local runs without it just skip
    # the guard) and only if no explicit timeout was requested.
    if config.pluginmanager.hasplugin("timeout") and \
            getattr(config.option, "timeout", None) is None:
        config.option.timeout = 300
        config.option.timeout_method = "signal"  # soft: test may clean up
    config.addinivalue_line(
        "markers",
        "hazard: test deliberately violates HTP ordering; the autouse "
        "race-gate fixture must not fail it")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (and nvcc for the port's kernels); "
        "skips with a reason where there is none")


@pytest.fixture(autouse=True)
def htp_race_gate(request):
    """Hazard-analyzer gate over EVERY async-session test: each
    AsyncHtpSession constructed during the test gets the trace hook
    armed, and at teardown the happens-before detector must report zero
    findings — so any test that drives the queue-pair engine (or the
    fleet) doubles as a race-freedom check of the protocol discipline it
    exercises.  Tests that seed deliberate hazards opt out with
    ``@pytest.mark.hazard``."""
    from repro.analysis.trace import (HtpTrace, TraceRecorder,
                                      session_is_serial)
    from repro.core.cq import AsyncHtpSession

    if request.node.get_closest_marker("hazard"):
        yield
        return
    traces = []
    orig_init = AsyncHtpSession.__init__

    def traced_init(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        trace = HtpTrace()
        traces.append(trace)
        self.trace = TraceRecorder(trace, session_is_serial(self))

    AsyncHtpSession.__init__ = traced_init
    try:
        yield
    finally:
        AsyncHtpSession.__init__ = orig_init
    from repro.analysis.detector import detect
    for trace in traces:
        findings = detect(trace)
        assert not findings, (
            f"HTP race(s) in a clean test's transaction trace:\n" +
            "\n".join(f"  {f}" for f in findings))

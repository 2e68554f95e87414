"""Trace-driven replay: captured commit traces as conformance inputs.

The end-state differential fuzzer compares two backends *after* a run;
a mid-run divergence that later re-converges (or cancels out in the
compared fields) is invisible to it.  A commit trace closes that hole:
every retirement of every hart is a ``(tick, pc, inst, priv)`` record,
so replaying a captured trace against the PySim reference —
instruction by instruction, in commit order, per hart — is a lockstep
differential check over the *whole execution*, not just its endpoint.

``capture_commit_trace`` runs a workload with the commit-trace bridge
armed losslessly (unbounded telemetry backlog + a ring sized to the
drain cadence — a capture with ring drops is rejected, a lossy trace
cannot be a conformance input); ``replay_trace`` re-runs the same
workload on PySim and reports the first divergence per hart.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TraceDivergence:
    """First mismatching commit record of one hart."""

    core: int
    index: int                 # commit-order position of the mismatch
    captured: tuple | None     # (tick, pc, inst, priv) or None (missing)
    reference: tuple | None

    def __str__(self):
        def fmt(r):
            if r is None:
                return "<no record>"
            t, pc, inst, priv = r
            return f"tick={t} pc={pc:#x} inst={inst:#010x} priv={priv}"
        return (f"core {self.core} commit #{self.index}: "
                f"captured {fmt(self.captured)} != "
                f"reference {fmt(self.reference)}")


def _run_with_trace(name, argv_tail, *, target, n_cores, mem, files,
                    link, slots, target_opts=None, trigger=None,
                    max_ticks=1 << 36):
    from ..core.runtime import FaseRuntime
    from ..core.target.pysim import PySim
    from ..core.workloads import build
    if target == "pysim":
        tgt = PySim(n_cores, mem)
    elif target == "torch":
        from ..core.interface import TorchTarget
        tgt = TorchTarget(n_cores, mem, **(target_opts or {}))
    else:
        raise ValueError(f"capture runs on target='pysim' or 'torch', got "
                         f"{target!r}")
    rt = FaseRuntime(tgt, mode="fase", link=link, session="async",
                     telemetry=dict(counters=False, commit_trace=True,
                                    trace_slots=slots,
                                    backlog_ticks=None, trigger=trigger))
    rt.load(build(name), [name] + list(argv_tail), files=files or {})
    rep = rt.run(max_ticks=max_ticks)
    return rt.telemetry, rep


def capture_commit_trace(name, argv_tail, *, target="torch",
                         n_cores=1, mem=1 << 22, files=None, link="pcie",
                         slots=1 << 15, target_opts=None, trigger=None,
                         max_ticks=1 << 36):
    """Run a workload with lossless commit-trace capture; returns
    ``(records, report)`` where ``records[c]`` is hart *c*'s full
    commit-order record list.  ``target`` is ``"torch"`` (a
    :class:`~repro_torch.core.interface.TorchTarget`, on the card unless
    ``target_opts`` asks for ``device="cpu"``) or ``"pysim"`` (this
    package's :class:`~repro_torch.core.target.pysim.PySim`, the
    reference :func:`replay_trace` compares against).  ``trigger`` windows the
    capture (a :class:`~repro_torch.telemetry.triggers.TriggerSelector`
    or spec tuple); a windowed capture replays against an
    identically-windowed reference."""
    hub, rep = _run_with_trace(
        name, argv_tail, target=target, n_cores=n_cores, mem=mem,
        files=files, link=link, slots=slots, target_opts=target_opts,
        trigger=trigger, max_ticks=max_ticks)
    bridge = hub.commit
    if any(bridge.ring_dropped) or any(bridge.frame_dropped):
        raise ValueError(
            f"lossy capture (ring_dropped={bridge.ring_dropped}, "
            f"frame_dropped={bridge.frame_dropped}): raise trace_slots — "
            "a conformance input must be complete")
    return [list(r) for r in bridge.records], rep


def replay_trace(records, name, argv_tail, *, n_cores=1, mem=1 << 22,
                 files=None, link="pcie", slots=1 << 15, trigger=None,
                 max_ticks=1 << 36) -> list[TraceDivergence]:
    """Replay a captured commit trace against the PySim reference.

    Re-runs the workload on PySim with its own lossless capture and
    walks both record streams in lockstep, hart by hart; returns the
    first :class:`TraceDivergence` of each diverging hart (empty list =
    conformant).  Tick, pc, instruction word and privilege must all
    match bit-for-bit — this is strictly stronger than the end-state
    fuzzer's final-state comparison.
    """
    ref, _ = capture_commit_trace(
        name, argv_tail, target="pysim", n_cores=n_cores, mem=mem,
        files=files, link=link, slots=slots, trigger=trigger,
        max_ticks=max_ticks)
    divergences = []
    for c, (cap, exp) in enumerate(zip(records, ref)):
        for i in range(max(len(cap), len(exp))):
            a = tuple(cap[i]) if i < len(cap) else None
            b = tuple(exp[i]) if i < len(exp) else None
            if a != b:
                divergences.append(TraceDivergence(c, i, a, b))
                break
    return divergences

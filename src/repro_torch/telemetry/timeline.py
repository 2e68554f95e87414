"""Unified timeline export: one Perfetto-openable view of a FASE run.

A run already leaves several time-stamped footprints behind — the
session transaction trace (:mod:`repro_torch.analysis.trace`, incl. the
SERIAL/``telem``/``nic`` ordering domains), the telemetry counter
samples with their per-port fabric counters, gang superstep rounds
(:class:`~repro_torch.core.net.gang.GangReport` ``rounds``) and
migration/provision spans
(:class:`~repro_torch.core.fleet.runtime.MigrationReport`).  This module
merges them into **Chrome trace-event JSON** (the ``traceEvents``
array format), so any run — single board through a 4-board gang —
opens in Perfetto / ``chrome://tracing`` with per-(device, stream)
tracks:

  * one *process* per device (``dev0``, ``dev1``, … — or ``session``
    for a solo run), with its transaction domains as threads
    (``serial``, per-hart streams, ``telem``, ``nic``),
  * counter tracks (``ph: "C"``) from the CtrSample stream, per hart,
    plus the switch-port counters stamped into each sample,
  * a ``gang`` process carrying the superstep track (quantum + halo
    wait per round),
  * a ``fleet`` process carrying migration spans (capture → provision
    → restore).

Modelled ticks convert to microseconds at the target clock
(``CLOCK_HZ``), so Perfetto's ruler reads modelled target time.

:func:`validate_timeline` is the minimal schema check CI runs over
exported artifacts: monotone ``ts`` per (pid, tid) track, matched
``B``/``E`` nesting, no orphan async ``b``/``e`` pairs, non-negative
``X`` durations.

Command line: ``python -m repro_torch.telemetry timeline <workload>``
(see :mod:`repro_torch.telemetry.__main__`).
"""
from __future__ import annotations

import json

from ..core.consts import CLOCK_HZ
from .stream import TELEM_STREAM

#: modelled ticks per exported microsecond
_TICKS_PER_US = CLOCK_HZ / 1e6


def _us(ticks) -> float:
    return ticks / _TICKS_PER_US


def _pid(device) -> str:
    return "session" if device is None else f"dev{device}"


def _tid(stream) -> str:
    """Thread (track) name of one trace ordering domain."""
    if isinstance(stream, tuple):       # (device, local) fleet prefix
        stream = stream[-1]
    if stream == "__serial__":
        return "serial"
    if isinstance(stream, int):
        return f"hart{stream}"
    return str(stream)


def _ops_label(ev) -> str:
    ops = ",".join(r.op for r in ev.requests[:4])
    if len(ev.requests) > 4:
        ops += f",+{len(ev.requests) - 4}"
    return ops


def events_from_trace(trace) -> list[dict]:
    """Session transactions → complete (``X``) spans, one per traced
    transaction, on the (device, ordering-domain) track it ran on."""
    out = []
    for ev in trace.events:
        out.append({
            "name": _ops_label(ev), "ph": "X", "cat": "htp",
            "pid": _pid(ev.device), "tid": _tid(ev.stream),
            "ts": _us(ev.ready), "dur": _us(max(ev.done - ev.ready, 0)),
            "args": {"eid": ev.eid, "at": ev.at, "seq": ev.seq,
                     "advisory": ev.advisory},
        })
    return out


def events_from_telemetry(report: dict, device=None) -> list[dict]:
    """One telemetry hub report → per-hart counter (``C``) tracks plus
    the per-port fabric counters each sample carries."""
    out = []
    pid = _pid(device)
    counters = (report or {}).get("counters")
    for sample in (counters or {}).get("samples", ()):
        ts = _us(sample["at"])
        for c, ctr in enumerate(sample["cores"]):
            out.append({"name": f"hart{c} counters", "ph": "C",
                        "cat": TELEM_STREAM, "pid": pid,
                        "tid": "counters", "ts": ts,
                        "args": {k: v for k, v in ctr.items()}})
        nic = sample.get("nic")
        if nic is not None:
            out.append({"name": "switch port", "ph": "C", "cat": "nic",
                        "pid": pid, "tid": "counters", "ts": ts,
                        "args": {k: v for k, v in nic.items()
                                 if isinstance(v, (int, float))}})
    return out


def events_from_gang(gang) -> list[dict]:
    """A :class:`~repro_torch.core.net.gang.GangReport` → the superstep
    track: one span per round (compute quantum) with its halo wait."""
    out = []
    for r in getattr(gang, "rounds", ()) or ():
        out.append({
            "name": f"superstep {r['superstep']}", "ph": "X",
            "cat": "gang", "pid": "gang", "tid": "supersteps",
            "ts": _us(r["t0"]), "dur": _us(max(r["t1"] - r["t0"], 0)),
            "args": {"quantum": r["quantum"],
                     "wait_ticks": r["wait_ticks"]},
        })
        if r["wait_ticks"]:
            out.append({
                "name": "halo wait", "ph": "X", "cat": "gang",
                "pid": "gang", "tid": "halo",
                "ts": _us(r["t1"] - r["wait_ticks"]),
                "dur": _us(r["wait_ticks"]),
                "args": {"superstep": r["superstep"]},
            })
    return out


def events_from_migrations(migrations) -> list[dict]:
    """Migration reports → fleet-track spans: the whole migration as
    one span, the billed provision window as a child span."""
    out = []
    for m in migrations or ():
        out.append({
            "name": f"job{m.job_id} {m.src}->{m.dst}", "ph": "X",
            "cat": "migration", "pid": "fleet", "tid": "migrations",
            "ts": _us(m.capture_start),
            "dur": _us(max(m.restore_done - m.capture_start, 0)),
            "args": {"pages_shipped": m.pages_shipped,
                     "downtime_ticks": m.downtime_ticks},
        })
        if m.provision_ticks:
            out.append({
                "name": "provision", "ph": "X", "cat": "migration",
                "pid": "fleet", "tid": "migrations",
                "ts": _us(m.capture_done),
                "dur": _us(m.provision_ticks),
                "args": {"job": m.job_id, "dst": m.dst},
            })
    return out


def _meta_events(events) -> list[dict]:
    """Perfetto niceties: name every process track we emitted."""
    pids = []
    for e in events:
        if e["pid"] not in pids:
            pids.append(e["pid"])
    return [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": pid}} for pid in pids]


def build_timeline(trace=None, telemetry=None, gang=None,
                   migrations=None, metadata=None) -> dict:
    """Merge every available footprint into one Chrome trace-event
    document.  ``telemetry`` is one hub report dict (solo run) or a
    ``{device_id: report}`` mapping (fleet); the rest are optional.
    Events are globally time-sorted, so ``ts`` is monotone on every
    track by construction."""
    events: list[dict] = []
    if trace is not None:
        events += events_from_trace(trace)
    if telemetry is not None:
        if "counters" in telemetry or "stream" in telemetry:
            events += events_from_telemetry(telemetry)
        else:
            for dev, rep in sorted(telemetry.items(), key=lambda kv:
                                   str(kv[0])):
                events += events_from_telemetry(rep, device=dev)
    if gang is not None:
        events += events_from_gang(gang)
    if migrations is not None:
        events += events_from_migrations(migrations)
    events.sort(key=lambda e: (e["ts"], e["pid"], e.get("tid", "")))
    doc = {
        "traceEvents": _meta_events(events) + events,
        "displayTimeUnit": "ms",
        "metadata": dict(metadata or {}, clock_hz=CLOCK_HZ,
                         tool="repro_torch.telemetry.timeline"),
    }
    return doc


# ---------------------------------------------------------------------------
# minimal schema validation (the CI gate over exported artifacts)
# ---------------------------------------------------------------------------
def validate_timeline(doc) -> list[str]:
    """Minimal Chrome trace-event schema check; returns the list of
    problems (empty = valid).  Checks: required keys per phase type,
    monotone ``ts`` per (pid, tid) track, non-negative ``X`` durations,
    matched ``B``/``E`` nesting per track, and no orphan async
    ``b``/``e`` events (matched on (cat, id))."""
    problems: list[str] = []
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        return ["no traceEvents array"]
    last_ts: dict = {}
    b_stack: dict = {}
    async_open: dict = {}
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph is None or "pid" not in e or "name" not in e:
            problems.append(f"event {i}: missing ph/pid/name")
            continue
        if ph == "M":
            continue
        if "ts" not in e:
            problems.append(f"event {i}: missing ts")
            continue
        track = (e["pid"], e.get("tid", ""))
        if ph in ("X", "B", "E", "C", "b", "e"):
            if track in last_ts and e["ts"] < last_ts[track]:
                problems.append(
                    f"event {i} ({e['name']!r}): ts {e['ts']} goes "
                    f"backwards on track {track}")
            last_ts[track] = e["ts"]
        if ph == "X" and e.get("dur", 0) < 0:
            problems.append(f"event {i} ({e['name']!r}): negative dur")
        elif ph == "B":
            b_stack.setdefault(track, []).append(e["name"])
        elif ph == "E":
            stack = b_stack.get(track)
            if not stack:
                problems.append(
                    f"event {i}: E without matching B on track {track}")
            else:
                stack.pop()
        elif ph in ("b", "e"):
            key = (e.get("cat"), e.get("id"))
            if key == (None, None):
                problems.append(f"event {i}: async event without id")
            elif ph == "b":
                async_open[key] = async_open.get(key, 0) + 1
            else:
                if async_open.get(key, 0) <= 0:
                    problems.append(
                        f"event {i}: async end without begin {key}")
                else:
                    async_open[key] -= 1
    for track, stack in b_stack.items():
        for name in stack:
            problems.append(f"unclosed B span {name!r} on track {track}")
    for key, n in async_open.items():
        if n > 0:
            problems.append(f"unclosed async span {key}")
    return problems


def save_timeline(doc: dict, path) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True, default=int)
        f.write("\n")

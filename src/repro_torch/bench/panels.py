"""What the port's FASE panels share: the counterpart of the reference's
``benchmarks/common.py`` (``run_workload``, ``parse_kv``,
``trial_mean_ns``, ``save_json``) over the port's runtime, and each
panel's command line.

A panel runs its guest workloads through
:func:`repro_torch.run.run_workload` on one of :data:`TARGETS`: ``card``
(``TorchTarget`` on the CUDA device, the default), ``pysim`` (the port's
own pure-Python :class:`~repro_torch.core.target.pysim.PySim`, asked for
by name) or ``cpu`` (``TorchTarget`` on the host, for tests).  The
modelled numbers (ticks, stalls, traffic, syscalls, counters, the guest's
own scores) do not depend on the target; the wall seconds do.  A result
file ``results/torch_<name>.json`` holds the reference's rows, each with
its ``wall_s``, under ``result``, beside the target and, on the card, its
name and power limit as ``nvidia-smi`` prints them.  ``--against DIR``
holds the modelled numbers of the files a run wrote against the files of
the same names in ``DIR`` (and against the reference's own result of the
panel, ``DIR/<name>.json``, where there is one), tolerance 0.
"""
from __future__ import annotations

import argparse
import json
import os
import time

#: where a panel writes ``torch_<name>.json``
RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "results")
#: the targets a panel runs on: the CUDA device, the port's PySim, and
#: ``TorchTarget`` on the host (tests)
TARGETS = ("card", "pysim", "cpu")
#: the keys of a row that are measured, not modelled numbers: a row's
#: wall seconds, the serving engine's host seconds a part of its steps
#: (scheduling, enqueueing the device work, polling), a dry-run cell's
#: seconds on the host, the card's measured rates and the roofline
#: terms at those rates, and the speed panels' rates and their ratios
WALL_KEYS = ("wall", "wall_s", "oracle_wall_s", "host_schedule_s",
             "host_enqueue_s", "host_poll_s", "lower_s", "compile_s",
             "measured", "roofline_measured", "ips", "inst_per_s",
             "wall_per_iter", "value", "kernel_vs_eager_speedup",
             "fleet_aggregate_vs_one_board")


def target_kwargs(target: str) -> dict:
    """``repro_torch.run.run_workload``'s keywords for ``target``."""
    if target not in TARGETS:
        raise ValueError(f"target must be one of {TARGETS}, got {target!r}")
    if target == "pysim":
        return dict(target="pysim")
    return dict(target="torch", device=torch_device(target))


def make_target(target: str, n_cores: int, mem: int):
    """A target of ``n_cores`` cores and ``mem`` bytes on ``target``."""
    if target == "pysim":
        from ..core.target.pysim import PySim
        return PySim(n_cores, mem)
    from ..core.interface import TorchTarget
    return TorchTarget(n_cores, mem, **{k: v for k, v in
                                        target_kwargs(target).items()
                                        if k == "device"})


def torch_device(target: str) -> str:
    """Where ``target`` runs the port's tensors (an engine, a model):
    the CUDA device for ``card``, the host otherwise."""
    if target not in TARGETS:
        raise ValueError(f"target must be one of {TARGETS}, got {target!r}")
    return "cuda" if target == "card" else "cpu"


def timed(target: str, fn):
    """``fn()`` and its wall seconds, the clock stopped after the card is
    done on ``card``."""
    t0 = time.time()
    out = fn()
    if target == "card":
        import torch
        torch.cuda.synchronize()
    return out, time.time() - t0


#: the largest model :func:`lm_params` draws on the host
CPU_DRAW_PARAMS = 50_000_000


def lm_params(cfg, device):
    """Seeded parameters of ``cfg`` (``init_params(cfg, 0)``) on
    ``device``.  A model of up to ``CPU_DRAW_PARAMS`` parameters is drawn
    on the host and moved, so the card and the CPU decode with the same
    weights; a larger one is drawn on ``device`` itself."""
    from ..models import core as M
    from ..training.optim import tree_map
    if cfg.param_count() > CPU_DRAW_PARAMS:
        return M.init_params(cfg, 0, device=device)
    params = M.init_params(cfg, 0, device="cpu")
    return tree_map(lambda t: t.to(device), params)


def run_workload(name, argv_tail, target="card", **kw):
    """:func:`repro_torch.run.run_workload` on ``target``; returns
    ``(runtime, report, wall_seconds)``."""
    from ..run import run_workload as run
    return run(name, argv_tail, **target_kwargs(target), **kw)


def run_runtime(rt, target, max_ticks=1 << 36):
    """``rt.run`` to the end, the wall clock stopped after the device is
    done; returns ``(report, wall_seconds)``."""
    return timed(target, lambda: rt.run(max_ticks=max_ticks))


def parse_kv(stdout: bytes) -> dict:
    out = {}
    for line in stdout.decode().splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[1].lstrip("-").isdigit():
            out.setdefault(parts[0], []).append(int(parts[1]))
    return out


def trial_mean_ns(stdout: bytes) -> float:
    vals = parse_kv(stdout).get("trial_ns", [])
    return sum(vals) / max(len(vals), 1)


def card_line(target: str):
    """The card's name and power limit on the card, else None."""
    if target != "card":
        return None
    from .timing import nvidia_smi_line
    return nvidia_smi_line()


def save_json(name: str, result, target: str, quick: bool,
              out_dir: str | None = None) -> str:
    """Write ``<out_dir>/torch_<name>.json`` (default ``results/``):
    ``result`` with the target, the card and the cut; returns the path."""
    out_dir = out_dir or RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"torch_{name}.json")
    with open(path, "w") as f:
        json.dump(dict(panel=name, target=target, card=card_line(target),
                       quick=quick, result=result), f, indent=1)
    return path


def modelled(obj):
    """``obj`` (a result, or a result file's content) as plain data
    without its wall-time keys: what must not differ between targets."""
    if isinstance(obj, dict) and "result" in obj and "panel" in obj:
        obj = obj["result"]
    obj = json.loads(json.dumps(obj))

    def strip(o):
        if isinstance(o, dict):
            return {k: strip(v) for k, v in o.items() if k not in WALL_KEYS}
        if isinstance(o, list):
            return [strip(v) for v in o]
        return o
    return strip(obj)


def walls(obj) -> list:
    """Every ``wall_s`` of a result, at any depth, in order."""
    if isinstance(obj, dict):
        return [w for k, v in obj.items()
                for w in ([v] if k == "wall_s" else walls(v))]
    if isinstance(obj, list):
        return [w for v in obj for w in walls(v)]
    return []


def differences(a, b, where="", limit=8) -> list:
    """Where the modelled numbers of ``a`` and ``b`` differ (at most
    ``limit`` places), as ``path: a != b`` strings."""
    out = []

    def walk(x, y, path):
        if len(out) >= limit:
            return
        if isinstance(x, dict) and isinstance(y, dict):
            for k in sorted(set(x) | set(y), key=str):
                walk(x.get(k), y.get(k), f"{path}.{k}")
        elif isinstance(x, list) and isinstance(y, list) and \
                len(x) == len(y):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        elif x != y:
            out.append(f"{path or '.'}: {x!r} != {y!r}")
    walk(modelled(a), modelled(b), where)
    return out


def check_against(paths, against: str) -> int:
    """Each written ``torch_<name>.json`` against ``<against>/`` (the file
    of the same name, and the reference's ``<name>.json``): prints a line
    a comparison; 1 if a file of the same name differs, else 0."""
    rc = 0
    for path in paths:
        base = os.path.basename(path)
        with open(path) as f:
            mine = json.load(f)
        for other, own in ((base, True), (base[len("torch_"):], False)):
            theirs_path = os.path.join(against, other)
            if not os.path.exists(theirs_path):
                continue
            with open(theirs_path) as f:
                theirs = json.load(f)
            diff = differences(mine, theirs)
            print(f"against {theirs_path}: "
                  f"{'modelled numbers equal' if not diff else 'DIFFERS'}"
                  + "".join(f"\n  {d}" for d in diff), flush=True)
            rc |= bool(diff) and own
    return rc


def cli(doc: str, links: bool = False, options=(), host_only=False,
        targets=TARGETS[:2]):
    """The panel's argument parser: ``--quick``, ``--target`` (one of
    ``targets``; none where the panel is ``host_only``), ``--out``,
    ``--against`` (and ``--link`` where the reference panel has it), and
    the panel's own ``options``, each ``(flag, add_argument
    keywords)``."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the reference's quick cut")
    if not host_only:
        ap.add_argument("--target", default="card", choices=targets,
                        help="card (default): TorchTarget on the CUDA "
                             "device; pysim: the port's pure-Python "
                             "simulator" + ("; cpu: TorchTarget on the "
                                            "host (tests)"
                                            if "cpu" in targets else ""))
    ap.add_argument("--out", default=None,
                    help="directory for torch_<name>.json (default "
                         "results/)")
    ap.add_argument("--against", default=None, metavar="DIR",
                    help="compare the modelled numbers with DIR's files")
    if links:
        ap.add_argument("--link", default="uart",
                        choices=["uart", "pcie", "oracle"])
    for flag, kw in options:
        ap.add_argument(flag, **kw)
    return ap


def main(run, doc: str, files, links: bool = False, options=(),
         host_only=False, targets=TARGETS[:2], against=check_against) -> int:
    """Parse the panel's command line, run it (``run`` takes ``quick``,
    ``out_dir``, ``target`` (one of ``targets``) unless the panel is
    ``host_only`` (it runs on the host's CPU whatever the card), with
    ``links`` ``link``, and each of ``options`` by its name; it writes
    ``torch_<f>.json`` for each of ``files``, or of ``files(args)`` where
    that is a function) and, with ``--against``, compare what it wrote
    (``against(paths, DIR)``, :func:`check_against` unless the panel has
    its own); returns the exit code."""
    a = cli(doc, links, options, host_only, targets).parse_args()
    if not host_only and a.target == "card":
        import torch
        if not torch.cuda.is_available():
            import sys
            print("no CUDA device (torch.cuda.is_available() is False): "
                  "pass --target pysim to run on the host",
                  file=sys.stderr)
            return 1
    kw = {} if host_only else dict(target=a.target)
    if links:
        kw["link"] = a.link
    for flag, opt in options:
        name = opt.get("dest", flag.lstrip("-").replace("-", "_"))
        kw[name] = getattr(a, name)
    run(quick=a.quick, out_dir=a.out, **kw)
    paths = [os.path.join(a.out or RESULTS_DIR, f"torch_{f}.json")
             for f in (files(a) if callable(files) else files)]
    return against(paths, a.against) if a.against else 0

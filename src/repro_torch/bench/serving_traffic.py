"""Layer B's analogue of Fig 17 on the port: the serving engine's
device-side stop mask amortises host<->device syncs (the ``poll_every``
sweep), and serving co-resides with a FASE guest on one modelled PCIe
link; on the card by default.

The twin of the reference's ``benchmarks/serving_traffic.py``:

  * :func:`run`, the ``poll_every`` sweep: ``qwen3-8b.smoke()`` on 2
    slots, 4 requests, polls every 1 and every 8 steps; each row's steps,
    bytes and finished requests, with ``wall_s`` and the engine's host
    seconds spent scheduling, enqueueing the device work and polling
    (``host_schedule_s``, ``host_enqueue_s``, ``host_poll_s``: on the card
    a poll is a real device->host sync, which the reference could only
    count; each row's engine warm, after one untimed run).
    ``--config qwen3-8b`` runs the same requests and polls on
    the whole model (36 layers, d 4096, seeded bf16 drawn on the card),
    on the card only.  The engine runs on the CUDA device with
    ``--target card``, on the host otherwise.  Writes
    ``results/torch_serving_traffic.json`` (``_qwen3-8b`` for the whole
    model);
  * :func:`co_residency`: bc on a 2-core board of the panel's target with
    the serving command batches queued on the runtime's own session
    (``SERVE_STREAM``, through ``rt.traffic_hook``) at each step rate; the
    bc makespan's inflation against the serving-free run.  Writes
    ``results/torch_serving_coresidency.json``.
"""
from __future__ import annotations

from . import panels
from ..configs import CONFIGS
from ..core.consts import CLOCK_HZ
from ..core.runtime import FaseRuntime
from ..core.workloads import build, graphgen
from ..serving.engine import SERVE_STREAM, Request, ServeEngine
from ..serving.htp import CommandBatch

#: the sweep's model by ``--config``: the reference's smoke cut, or the
#: whole model
CONFIG_NAMES = ("smoke", "qwen3-8b")
POLLS = (1, 8)


def co_residency(quick=False, target="card", out_dir=None):
    """Sweep the serving command-batch step rate against GAPBS BC on ONE
    shared PCIe link: the batches queue on the ``"serve"`` stream of the
    runtime's own session, so every serving byte and doorbell contends
    with Layer-A exception traffic.  Reports the bc makespan inflation
    against the serving-free baseline per step rate."""
    g = graphgen.rmat(4 if quick else 5, 8, weights=True)
    rates = (0, 2_000, 20_000) if quick else (0, 1_000, 10_000, 25_000)
    # a representative per-step command batch: a wide pod (32 slots,
    # 64-page block tables), wire-heavy but controller-sustainable at
    # every swept rate (no PageS churn)
    cb = CommandBatch.empty(slots=32, pages=64)
    cb.override[:] = 5
    serve_txn = cb.to_transaction()
    rows = []
    base = None
    for rate in rates:
        rt = FaseRuntime(panels.make_target(target, 2, 1 << 23),
                         mode="fase", link="pcie")
        state = {"next_step": 0, "steps": 0}
        if rate:
            period = CLOCK_HZ // rate
            state["next_step"] = period

            def hook(now, rt=rt, state=state, period=period):
                # catch the serve schedule up to modelled time: one
                # command batch per step on the shared link
                while state["next_step"] <= now:
                    rt.session.submit(serve_txn, state["next_step"],
                                      stream=SERVE_STREAM)
                    state["steps"] += 1
                    state["next_step"] += period
            rt.traffic_hook = hook
        rt.load(build("bc"), ["bc", "g.bin", "2", "2"],
                files={"g.bin": g})
        rep, wall = panels.run_runtime(rt, target)
        if base is None:
            base = rep.ticks
        inflation = 100.0 * (rep.ticks - base) / base
        rows.append(dict(
            steps_per_s=rate, gapbs_ticks=rep.ticks,
            inflation_pct=inflation, serve_steps=state["steps"],
            serve_bytes=sum(rep.traffic.get(f"sys:{c}", 0)
                            for c in ("overrides", "block_tables",
                                      "page_cmds")),
            wall_s=wall))
        print(f"serving_coresidency,rate={rate},{rep.ticks},"
              f"inflation={inflation:.3f}% over {state['steps']} "
              f"serve steps ({target} {wall:.2f}s)", flush=True)
    panels.save_json("serving_coresidency", rows, target, quick, out_dir)
    return rows


def model(config: str, target: str):
    """The sweep's model config and seeded parameters on the target's
    device; the whole model only on the card."""
    if config not in CONFIG_NAMES:
        raise ValueError(f"config must be one of {CONFIG_NAMES}, got "
                         f"{config!r}")
    cfg = CONFIGS["qwen3-8b"]
    if config == "smoke":
        cfg = cfg.smoke()
    elif target != "card":
        raise ValueError(f"--config {config} runs on the card only")
    return cfg, panels.lm_params(cfg, panels.torch_device(target))


def new_engine(cfg, params, poll, device, impl="kernel"):
    """The sweep's engine at ``poll``: 2 slots, ``max_seq`` 128, its four
    requests submitted; ``impl`` picks the kernels or their plain
    versions."""
    eng = ServeEngine(cfg, params, slots=2, max_seq=128, poll_every=poll,
                      impl=impl, device=device)
    for i in range(4):
        eng.submit(Request(rid=i, prompt=[3 + i, 9, 2], max_new=8, eos=1))
    return eng


def sweep(cfg, params, target):
    """The ``poll_every`` rows of ``cfg``, after one untimed run of the
    first poll's engine (a row's wall is a warm engine's)."""
    device = panels.torch_device(target)
    new_engine(cfg, params, POLLS[0], device).run()
    rows = []
    for poll in POLLS:
        eng = new_engine(cfg, params, poll, device)
        done, wall = panels.timed(target, eng.run)
        rows.append(dict(poll_every=poll, steps=eng.steps,
                         d2h=eng.traffic.d2h_bytes,
                         h2d=eng.traffic.h2d_bytes,
                         finished=len(done), wall_s=wall,
                         **{f"host_{k}_s": v
                            for k, v in eng.host_s.items()}))
        print(f"serving_traffic,poll={poll},{eng.traffic.d2h_bytes},"
              f"d2h bytes over {eng.steps} steps ({target} {wall:.2f}s, "
              f"{eng.host_s['poll']:.4f}s in polls)", flush=True)
    return rows


def file_name(config: str) -> str:
    return "serving_traffic" if config == "smoke" else \
        f"serving_traffic_{config}"


def run(quick=False, target="card", out_dir=None, config="smoke",
        skip_poll=False):
    """The ``poll_every`` sweep (unless ``skip_poll``), then the
    co-residency panel; returns the sweep's rows."""
    rows = []
    if not skip_poll:
        cfg, params = model(config, target)
        rows = sweep(cfg, params, target)
        panels.save_json(file_name(config), rows, target, quick, out_dir)
        del params
    co_residency(quick, target, out_dir)
    return rows


def files(args):
    return ([] if args.skip_poll else [file_name(args.config)]) + \
        ["serving_coresidency"]


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, files, options=(
        ("--config", dict(default="smoke", choices=CONFIG_NAMES,
                          help="the sweep's model: the smoke cut "
                               "(default) or the whole qwen3-8b (the "
                               "card only)")),
        ("--skip-poll", dict(action="store_true",
                             help="co-residency panel only")))))

"""Fault-tolerant train loop — the port of
:mod:`repro.training.train_loop` for one device.

As in the reference: checkpoints every ``ckpt_every`` steps (async,
:class:`~repro_torch.training.checkpoint.Checkpointer`); on an injected
failure the loop waits for an in-flight save, restores ``LATEST``,
re-seeks the data pipeline and continues step-exactly; a step slower than
``max_step_seconds`` is logged by the straggler watchdog.  A checkpoint
``LATEST`` found at start is restored first.

Unlike the reference, which restarts on any ``RuntimeError``, only the
injector's :class:`InjectedFailure` takes the restart path: in PyTorch a
CUDA error or a failed kernel launch is a ``RuntimeError`` too, and it
must end the run, not replay it.
"""
from __future__ import annotations

import os
import tempfile
import time

import torch

from ..launch.steps import make_train_step
from ..models import core as M
from .checkpoint import Checkpointer
from .data import TokenPipeline
from .optim import AdamWConfig, init_opt_state


class InjectedFailure(RuntimeError):
    pass


class FailureInjector:
    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.failed = set()

    def maybe_fail(self, step):
        if step in self.fail_at and step not in self.failed:
            self.failed.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


def train(cfg, steps: int = 20, batch: int = 8, seq: int = 64,
          ckpt_dir: str | None = None, ckpt_every: int = 5,
          injector: FailureInjector | None = None,
          max_step_seconds: float = 300.0, opt=AdamWConfig(),
          log=print, device="cuda"):
    """Train ``cfg`` from seeded parameters (``init_params(cfg, 0)``) on
    the synthetic token pipeline; returns the loss of every step taken,
    replayed steps included.  ``ckpt_dir`` defaults to
    ``repro_torch_ckpt`` under the temporary directory."""
    dev = M.resolve_device(device)
    ckpt = Checkpointer(ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                 "repro_torch_ckpt"))
    train_step = make_train_step(cfg, opt)
    pipe = TokenPipeline(cfg.vocab, batch, seq)
    injector = injector or FailureInjector()

    def fresh_state():
        params = M.init_params(cfg, 0, device=dev)
        return {"params": params, "opt": init_opt_state(params), "step": 0}

    state = fresh_state()
    latest = ckpt.latest_step()
    if latest is not None:
        state = ckpt.restore(latest, state)
        start = state["step"] = latest
        pipe.seek(latest)
        log(f"restored checkpoint step {latest}")
    else:
        start = 0

    losses = []
    step = start
    while step < steps:
        batch_np = next(pipe)
        t0 = time.time()
        try:
            injector.maybe_fail(step)
            params, opt_state, metrics = train_step(
                state["params"], state["opt"],
                {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()})
            state["params"], state["opt"] = params, opt_state
        except InjectedFailure as e:
            log(f"FAILURE: {e}; restarting from checkpoint")
            ckpt.wait()          # let an in-flight async save land first
            latest = ckpt.latest_step()
            if latest is not None:
                state = ckpt.restore(latest, state)
            else:
                state = None     # free the old state before drawing anew
                state = fresh_state()
            latest = latest or 0
            state["step"] = latest
            pipe.seek(latest)
            step = latest
            continue
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if dt > max_step_seconds:
            log(f"straggler watchdog: step {step} took {dt:.1f}s")
        losses.append(loss)
        step += 1
        state["step"] = step
        if step % ckpt_every == 0:
            ckpt.save(step, state)
    ckpt.wait()
    pipe.close()
    return losses

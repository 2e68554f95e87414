"""Checkpointing with async save, in the reference's on-disk format.

The port of :mod:`repro.training.checkpoint` for one process:
``<dir>/step_XXXXXXXX/shard_0.npz`` holds every leaf of the state under
its ``/``-path with ``|`` for ``/`` (``|params|blocks|0|wq``), bfloat16
stored as float32 (npz has no bf16), Python ints as int64; beside it
``manifest.json`` (step and sorted keys), and ``<dir>/LATEST`` names the
newest step.  A checkpoint written by either package restores into the
other.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def _host(v):
    """A host copy that later in-place updates of ``v`` cannot reach (for
    a CPU tensor ``.cpu()`` alone would be a view)."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    t = v.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _restore_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _restore_into(v, flat, f"{prefix}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore_into(v, flat, f"{prefix}/{i}")
                              for i, v in enumerate(template))
    a = flat[prefix]
    if not isinstance(template, torch.Tensor):
        return type(template)(a)
    if tuple(a.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {prefix}: shape {a.shape} != "
                         f"{tuple(template.shape)}")
    with torch.no_grad():
        template.copy_(torch.from_numpy(a))
    return template


class Checkpointer:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None

    def save(self, step: int, state: dict, blocking: bool = False):
        """Async save: copies to the host, then writes on a worker
        thread."""
        host = {k: _host(v) for k, v in _flatten(state).items()}

        def write():
            path = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(path, exist_ok=True)
            np.savez(os.path.join(path, "shard_0.npz"), **{
                k.replace("/", "|"): v for k, v in host.items()})
            with open(os.path.join(path, "manifest.json"), "w") as f:
                json.dump({"step": step, "keys": sorted(host)}, f)
            with open(os.path.join(self.dir, "LATEST"), "w") as f:
                f.write(str(step))

        self.wait()
        self._pending = threading.Thread(target=write)
        self._pending.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def latest_step(self) -> int | None:
        try:
            with open(os.path.join(self.dir, "LATEST")) as f:
                return int(f.read().strip())
        except FileNotFoundError:
            return None

    def restore(self, step: int, template):
        """Restore into ``template``'s structure **in place**: each tensor
        leaf is overwritten (converted to its dtype, on its device), each
        int leaf replaced; returns the restored tree.  The checkpoint's
        keys must be the template's."""
        path = os.path.join(self.dir, f"step_{step:08d}", "shard_0.npz")
        with np.load(path) as z:
            flat = {k.replace("|", "/"): z[k] for k in z.files}
        want = set(_flatten(template))
        if set(flat) != want:
            raise ValueError(
                f"checkpoint {path}: keys differ from the template's: "
                f"missing {sorted(want - set(flat))[:4]}, extra "
                f"{sorted(set(flat) - want)[:4]}")
        return _restore_into(template, flat)

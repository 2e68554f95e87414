"""AdamW with global-norm clipping, plus int8 gradient compression with
error feedback — the port of :mod:`repro.training.optim`.

The reference is functional (it returns new parameters and moments); the
port updates the parameters, ``m``, ``v`` and ``step`` in place under
``torch.no_grad()``, with the reference's order of operations in f32
(``m`` and ``v`` are f32 whatever the parameters' dtype).  Large leaves
go through in slices of ``CHUNK`` elements, so the f32 temporaries of
the 622 M-element qwen3-8b embedding stay small.  Nothing syncs with the
host: the clip scale, the step count and the bias corrections stay on
the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..distributed import dtensor as DT

F32 = torch.float32
#: elements of one slice of a leaf in :func:`adamw_update`
CHUNK = 1 << 24


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree):
    """The leaves of a tree of dicts and lists, depth first, dict keys in
    sorted order (as ``jax.tree`` orders them), so two trees with the same
    keys give their leaves in the same order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` of every leaf, visited in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def init_opt_state(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    leaves = tree_leaves(params)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def global_norm(tree):
    return torch.sqrt(sum(DT.sum_squares(x) for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step in place on ``params`` and ``state``; returns
    ``(params, state, grad_norm)`` as the reference does."""
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    state["step"] += 1
    step = state["step"].to(F32)
    b1c = 1 - torch.pow(cfg.b1, step)
    b2c = 1 - torch.pow(cfg.b2, step)
    scale, b1c, b2c = (DT.local_value(t) for t in (scale, b1c, b2c))
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = DT.laid_out_as(g, p)
        for ps, gs, ms, vs in zip(DT.slices(p, CHUNK),
                                  DT.slices(g, CHUNK, view=False),
                                  DT.slices(m, CHUNK), DT.slices(v, CHUNK)):
            gs = gs.to(F32) * scale
            ms.copy_(cfg.b1 * ms + (1 - cfg.b1) * gs)
            vs.copy_(cfg.b2 * vs + (1 - cfg.b2) * gs * gs)
            mh = ms / b1c
            vh = vs / b2c
            pf = ps.to(F32)
            ps.copy_(pf - cfg.lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                    + cfg.weight_decay * pf))
    return params, state, gn


# --- int8 gradient compression with error feedback -------------------------
def compress_int8(g, err):
    g = g.to(F32) + err
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.to(F32) * scale
    return q, scale, g - deq


def decompress_int8(q, scale):
    return q.to(F32) * scale

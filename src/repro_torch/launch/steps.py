"""Step functions of every execution mode — the port of
:mod:`repro.launch.steps` for one device.

``loss_and_grads`` is ``jax.value_and_grad`` of the loss: the gradients
come back as a tree shaped like the parameters, in their dtype.  The
train step updates the parameters and the optimizer state in place (the
reference returns new ones).  ``SHAPES``, ``input_specs`` and the
``abstract_*`` helpers of the reference wait for the dry-run port
(ROADMAP Queue A 10).
"""
from __future__ import annotations

import torch

from ..models import core as M
from ..models.config import ModelConfig
from ..training.optim import AdamWConfig, adamw_update, tree_leaves, tree_map

F32 = torch.float32


def loss_and_grads(cfg: ModelConfig, params, batch, impl="kernel"):
    """``(loss, grads)`` of :func:`repro_torch.models.core.loss_fn`; marks
    the parameter leaves as requiring gradients."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = M.loss_fn(cfg, params, batch, impl=impl)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig = AdamWConfig(),
                    n_micro: int = 1):
    """Train step with optional gradient accumulation over ``n_micro``
    microbatches (summed in f32, then divided, as the reference's scan
    does).  ``train_step(params, opt_state, batch)`` returns ``(params,
    opt_state, {"loss", "grad_norm"})``, the first two updated in
    place."""
    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = loss_and_grads(cfg, params, batch)
        else:
            micro = {k: v.reshape(n_micro, v.shape[0] // n_micro,
                                  *v.shape[1:]) for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                  device=p.device), params)
            loss_sum = torch.zeros((), dtype=F32,
                                   device=tree_leaves(params)[0].device)
            for i in range(n_micro):
                loss, g = loss_and_grads(
                    cfg, params, {k: v[i] for k, v in micro.items()})
                loss_sum = loss_sum + loss
                for a, b in zip(tree_leaves(gsum), tree_leaves(g)):
                    a += b.to(F32)
            loss = loss_sum / n_micro
            grads = tree_map(lambda g: g / n_micro, gsum)
        params, opt_state, gn = adamw_update(opt, params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gn}
    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        logits, _ = M.forward(cfg, params, batch["tokens"],
                              batch.get("prefix_embeds"))
        return logits[:, -1]
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, state, tokens):
        return M.decode_step(cfg, params, state, tokens)
    return serve_step

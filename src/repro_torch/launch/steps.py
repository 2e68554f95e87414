"""Step functions of every execution mode, and abstract input specs —
the port of :mod:`repro.launch.steps`.

``loss_and_grads`` is ``jax.value_and_grad`` of the loss: the gradients
come back as a tree shaped like the parameters, in their dtype.  The
train step updates the parameters and the optimizer state in place (the
reference returns new ones).  ``act_spec`` is the reference's: a sharding
spec pinned onto the residual stream when it is a DTensor.

``input_specs(cfg, shape_name)`` returns the cell's inputs as tensors on
the ``meta`` device — the reference's ``ShapeDtypeStruct``s: shapes and
dtypes, nothing allocated, as ``jax.eval_shape`` allocates nothing.  The
dry run (:mod:`repro_torch.launch.dryrun`) lays them out on its mesh.
"""
from __future__ import annotations

import torch

from ..distributed import dtensor as DT
from ..models import core as M
from ..models.config import ModelConfig
from ..training.optim import (AdamWConfig, adamw_update, init_opt_state,
                              tree_leaves, tree_map)

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32

# assignment shape table (LM family)
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}
PREFIX_LEN = 256   # modality-stub prefix positions ([vlm]/[audio])
META = torch.device("meta")


def cell_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.is_subquadratic:
        return False, "SKIP(full-attn)"
    return True, ""


def loss_and_grads(cfg: ModelConfig, params, batch, impl="kernel",
                   act_spec=None):
    """``(loss, grads)`` of :func:`repro_torch.models.core.loss_fn`; marks
    the parameter leaves as requiring gradients."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = M.loss_fn(cfg, params, batch, impl=impl, act_spec=act_spec)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig = AdamWConfig(),
                    n_micro: int = 1, act_spec=None, impl="kernel"):
    """Train step with optional gradient accumulation over ``n_micro``
    microbatches (summed in f32, then divided, as the reference's scan
    does).  ``train_step(params, opt_state, batch)`` returns ``(params,
    opt_state, {"loss", "grad_norm"})``, the first two updated in
    place; ``impl`` picks the attention implementation."""
    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = loss_and_grads(cfg, params, batch, impl=impl,
                                         act_spec=act_spec)
        else:
            micro = {k: DT.microbatches(v, n_micro)
                     for k, v in batch.items()}
            gsum = tree_map(lambda p: DT.zeros_like(p, F32), params)
            loss_sum = torch.zeros((), dtype=F32,
                                   device=tree_leaves(params)[0].device)
            for i in range(n_micro):
                loss, g = loss_and_grads(
                    cfg, params, {k: v[i] for k, v in micro.items()},
                    impl=impl, act_spec=act_spec)
                loss_sum = loss_sum + loss
                for a, b in zip(tree_leaves(gsum), tree_leaves(g)):
                    DT.accumulate(a, b)
            loss = loss_sum / n_micro
            grads = tree_map(lambda g: DT.divided(g, n_micro), gsum)
        params, opt_state, gn = adamw_update(opt, params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gn}
    return train_step


def make_prefill_step(cfg: ModelConfig, act_spec=None, impl="kernel"):
    """``prefill_step(params, batch)``: the last position's logits.  It
    runs without autograd (the reference's jitted forward keeps no
    tape); ``impl`` picks the attention implementation."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = M.forward(cfg, params, batch["tokens"],
                              batch.get("prefix_embeds"), impl=impl,
                              act_spec=act_spec)
        return logits[:, -1]
    return prefill_step


def make_decode_step(cfg: ModelConfig, impl="kernel"):
    @torch.no_grad()
    def serve_step(params, state, tokens):
        return M.decode_step(cfg, params, state, tokens, impl=impl)
    return serve_step


def abstract_params(cfg: ModelConfig):
    """The parameter tree on the ``meta`` device."""
    return M.init_params(cfg, 0, device=META)


def abstract_opt_state(cfg: ModelConfig):
    return init_opt_state(abstract_params(cfg))


def abstract_decode_state(cfg: ModelConfig, batch: int, seq: int):
    """The decode state on the ``meta`` device (the port's global KV pool:
    the reference's ``(B, pages)`` axes flattened into one pages axis)."""
    return M.make_decode_state(cfg, batch, seq, device=META)


def input_specs(cfg: ModelConfig, shape_name: str):
    """``meta`` stand-ins for the cell's step-function inputs."""
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)
    if sh["kind"] in ("train", "prefill"):
        batch = {"tokens": spec((B, S), I32)}
        if sh["kind"] == "train":
            batch["labels"] = spec((B, S), I32)
        if cfg.frontend != "none":
            batch["prefix_embeds"] = spec((B, PREFIX_LEN, cfg.d_model), BF16)
        out = {"params": abstract_params(cfg), "batch": batch}
        if sh["kind"] == "train":
            out["opt_state"] = abstract_opt_state(cfg)
        return out
    # decode: one new token against a seq-long KV cache / state
    return {"params": abstract_params(cfg),
            "state": abstract_decode_state(cfg, B, S),
            "tokens": spec((B,), I32)}

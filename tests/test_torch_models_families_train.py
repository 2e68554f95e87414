"""The port's MoE, Mamba-hybrid and xLSTM families against the JAX
package on the CPU at ``smoke()`` widths: ``forward`` with ``aux`` and
``collect_cache=True`` (the dense layout's too), ``loss_fn`` and autograd
gradients against ``jax.grad``.  The oracle and the tolerances are those
of ``tests/test_torch_models_families.py`` (its docstring): the reference
op by op, but for the gradients of the MoE and xLSTM layouts, whose jitted
reference routes as its op-by-op one does at these widths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import core as JM
from repro_torch.models import core as M
from repro_torch.models.convert import params_from_jax
from repro_torch.training.optim import tree_leaves

from test_torch_models_families import (CACHE_ULPS, DENSE, GRAD_REL_L2,
                                        HYBRID, LOGIT_ATOL, LOSS_ATOL, MOE,
                                        SSM, _cfgs, _close, _np, _params)


# ---------------------------------------------------------------------------
# forward, the caches, loss and gradients
# ---------------------------------------------------------------------------
def _tokens(cfg, B=2, S=16, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _reference(fn, *args, op_by_op=True):
    """``fn`` of the reference, op by op (see the module docstring) or
    jitted."""
    if op_by_op:
        with jax.disable_jit():
            return fn(*args)
    return jax.jit(fn, static_argnums=0)(*args)


def _close_tree(got, want, what):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, f"{what}[{i}]")
        return
    assert tuple(got.shape) == want.shape, (what, got.shape, want.shape)
    assert str(got.dtype).split(".")[1] == str(want.dtype), what
    _close(got, want, CACHE_ULPS, what)


@pytest.mark.parametrize("name", [DENSE, MOE, HYBRID, SSM])
def test_forward_and_caches_match_the_reference(name):
    """``forward(collect_cache=True)`` against the reference's: logits,
    ``aux`` and every cache — ``(k, v)`` per attention sublayer, ``(h,
    conv)`` per Mamba, ``C`` per mLSTM, ``(h, c)`` per sLSTM, stacked over
    scan steps.  The checkpointed ``forward`` gives the same logits and
    ``aux``."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    tok = _tokens(jcfg)
    jl, jc, jaux = _reference(
        lambda c, p, t: JM.forward(c, p, t, collect_cache=True),
        jcfg, jp, jnp.asarray(tok))
    tl, tc, taux = M.forward(tcfg, tp, torch.from_numpy(tok),
                             collect_cache=True)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4,
                               atol=1e-6)
    assert (float(taux) > 0) == (name in (MOE, HYBRID))
    _close_tree(tc, jax.device_get(jc), "caches")
    tl2, taux2 = M.forward(tcfg, tp, torch.from_numpy(tok))
    assert torch.equal(tl2, tl) and torch.equal(taux2, taux)


@pytest.mark.parametrize("name", [MOE, HYBRID, SSM])
def test_loss_and_gradients_match_jax_grad(name):
    jcfg, tcfg = _cfgs(name)
    jp, _ = _params(name)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(1)
    tok = _tokens(jcfg, S=8, seed=1)
    lab = rng.integers(0, jcfg.vocab, tok.shape).astype(np.int32)
    lab[0, :2] = -1
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    # jitted but for jamba, whose jitted run routes differently
    jloss, jg = _reference(
        lambda c, p, b: jax.value_and_grad(lambda q: JM.loss_fn(c, q, b))(p),
        jcfg, jp, batch, op_by_op=name == HYBRID)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = M.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(tok),
                                "labels": torch.from_numpy(lab)})
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_ATOL
    grads = torch.autograd.grad(loss, leaves)
    flat = jax.tree_util.tree_leaves_with_path(jax.device_get(jg))
    assert len(flat) == len(grads)
    for (path, want), got, leaf in zip(flat, grads, leaves):
        assert got.dtype == leaf.dtype
        want = np.asarray(want, np.float32)
        rel = np.linalg.norm(_np(got) - want) / max(np.linalg.norm(want),
                                                    1e-30)
        assert rel < GRAD_REL_L2, (jax.tree_util.keystr(path), rel)

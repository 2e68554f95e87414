"""The port's training path against the JAX package's, on the CPU, at
smoke widths.

* ``forward``: the reference's parameters carried over by
  ``params_from_jax``, logits within ``LOGIT_ATOL`` (the tolerance of the
  decode comparison in ``tests/test_torch_models.py``, a few bf16 ulps of
  the logits: XLA:CPU fuses across the jitted scan and drops some bf16
  round trips that the port's eager ops keep).
* ``loss_fn`` within ``LOSS_ATOL``; each gradient leaf within
  ``GRAD_REL_L2`` relative L2 of ``jax.grad`` (the gradients are bf16, and
  those few-ulp differences of the activations carry into them; measured
  at most 2.5e-2).
* ``adamw_update`` on identical numpy inputs: the grad norm to f32
  rounding (``rtol`` 1e-6: the sums of squares run in another order),
  ``m`` and ``v`` to f32 rounding of their terms (``rtol`` 1e-6, ``atol``
  1e-7 — about 1e-6 of the largest ``|m|``; where ``b1·m`` and
  ``(1-b1)·g`` cancel, the grad norm's last bit moves the small
  difference by more than its own ``rtol``), the bf16 parameters within
  one bf16 ulp.
* ``TokenPipeline`` and ``compress_int8``: equal.
* ``Checkpointer``: a checkpoint of either package restores into the
  other bit for bit.
* ``train``: 4 steps from one step-0 checkpoint of the reference's
  parameters, losses within ``TRAIN_LOSS_ATOL`` of the reference's
  ``train``; the failure-restart run equal to the uninterrupted run
  exactly; ``make_train_step(n_micro=2)`` against ``n_micro=1``.
* ``chip_smoke.py``'s bound on the attention leaves' gradients between
  the kernel and plain routes: above what one-ulp rounding differences of
  the attention output give, below what a wrong dK/dV of one GQA group
  gives.
"""
import functools
import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import core as JM
from repro.training import optim as JO
from repro.training.checkpoint import Checkpointer as JaxCheckpointer
from repro.training.data import TokenPipeline as JaxPipeline
from repro.training.train_loop import train as jax_train
from repro_torch.configs import CONFIGS
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.launch import steps as S
from repro_torch.launch.train import main as train_main
from repro_torch.models import core as M
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.training import optim as O
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.data import TokenPipeline
from repro_torch.training.train_loop import FailureInjector, train

BF16_ULP = 2.0 ** -8
LOGIT_ATOL = 2e-2
LOSS_ATOL = 2e-3
GRAD_REL_L2 = 5e-2
TRAIN_LOSS_ATOL = 5e-3


@functools.lru_cache(maxsize=None)
def _jax_params(name, tied=False):
    cfg = JCONFIGS[name].smoke()
    if tied:
        cfg = cfg.scaled(tied_embeddings=True)
    return jax.device_get(JM.init_params(cfg, 0))


def _batch(vocab, B=2, S=64, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


@pytest.mark.parametrize("name", ["qwen3-8b", "chatglm3-6b"])
def test_forward_matches_the_reference(name):
    """qwen3-8b (qk-norm, GQA 2) and chatglm3-6b (no qk-norm)."""
    cfg = JCONFIGS[name].smoke()
    jp = _jax_params(name)
    batch = _batch(cfg.vocab)
    want, _ = jax.jit(JM.forward, static_argnums=0)(
        cfg, jp, jnp.asarray(batch["tokens"]))
    got, aux = M.forward(CONFIGS[name].smoke(),
                         params_from_jax(jp, device="cpu"),
                         torch.from_numpy(batch["tokens"]))
    assert got.dtype == torch.bfloat16 and float(aux) == 0.0
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=LOGIT_ATOL)


def test_forward_with_prefix_embeds_and_tied_embeddings():
    """The modality stub's prefix embeddings (internvl2-76b's vision
    frontend) and a head tied to the embedding (qwen3-8b with
    ``tied_embeddings``)."""
    cfg = JCONFIGS["internvl2-76b"].smoke()
    jp = _jax_params("internvl2-76b")
    batch = _batch(cfg.vocab, B=2, S=48, seed=1)
    pre = (np.random.default_rng(2).standard_normal((2, 8, cfg.d_model))
           .astype(ml_dtypes.bfloat16))
    want, _ = JM.forward(cfg, jp, jnp.asarray(batch["tokens"]),
                         jnp.asarray(pre))
    got, _ = M.forward(CONFIGS["internvl2-76b"].smoke(),
                       params_from_jax(jp, device="cpu"),
                       torch.from_numpy(batch["tokens"]),
                       torch.from_numpy(pre.astype(np.float32))
                       .to(torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=LOGIT_ATOL)
    cfg = JCONFIGS["qwen3-8b"].smoke().scaled(tied_embeddings=True)
    jp = _jax_params("qwen3-8b", tied=True)
    assert "lm_head" not in jp
    want = JM.loss_fn(cfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = M.loss_fn(CONFIGS["qwen3-8b"].smoke().scaled(tied_embeddings=True),
                    params_from_jax(jp, device="cpu"), _tb(batch))
    assert abs(float(got) - float(want)) < LOSS_ATOL


@pytest.mark.parametrize("name", ["qwen3-8b", "chatglm3-6b"])
def test_loss_and_gradients_match_the_reference(name):
    cfg = JCONFIGS[name].smoke()
    jp = _jax_params(name)
    batch = _batch(cfg.vocab, seed=3)
    batch["labels"][0, :5] = -1                 # masked positions
    jloss, jgrads = jax.value_and_grad(lambda p: JM.loss_fn(
        cfg, p, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    tp = params_from_jax(jp, device="cpu")
    loss, grads = S.loss_and_grads(CONFIGS[name].smoke(), tp, _tb(batch))
    assert abs(float(loss) - float(jloss)) < LOSS_ATOL
    leaves = jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads))
    assert len(leaves) == len(O.tree_leaves(grads))
    for path, want in leaves:
        got = _leaf(grads, path)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        want = np.asarray(want, np.float32)
        rel = np.linalg.norm(got.float().numpy() - want) / \
            np.linalg.norm(want)
        assert rel < GRAD_REL_L2, (jax.tree_util.keystr(path), rel)


def _opt_inputs(seed=5, step=3):
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 48), "b": (48,), "blocks": [(3, 16, 16)]}

    def draw(shape, scale, dt):
        return (rng.standard_normal(shape) * scale).astype(dt)
    bf = ml_dtypes.bfloat16
    p = {"w": draw(shapes["w"], 0.1, bf), "b": draw(shapes["b"], 1.0, bf),
         "blocks": [draw(shapes["blocks"][0], 0.3, bf)]}
    g = jax.tree.map(lambda a: draw(a.shape, 0.5, bf), p)
    m = jax.tree.map(lambda a: draw(a.shape, 0.05, np.float32), p)
    v = jax.tree.map(lambda a: np.abs(draw(a.shape, 0.01, np.float32)), p)
    return p, g, {"m": m, "v": v, "step": np.int32(step)}


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_the_reference(clip):
    """The clip engages at 1.0 (the grad norm is ~20) and not at 100."""
    cfg = O.AdamWConfig(clip_norm=clip)
    p, g, st = _opt_inputs()
    jp, jst, jgn = JO.adamw_update(JO.AdamWConfig(clip_norm=clip),
                                   *jax.tree.map(jnp.asarray, (p, g, st)))
    tp = params_from_jax(p, device="cpu")
    tst = opt_state_from_jax(st, device="cpu")
    tp2, tst2, gn = O.adamw_update(cfg, tp, params_from_jax(g, device="cpu"),
                                   tst)
    assert tp2 is tp and tst2 is tst and int(tst["step"]) == 4
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for name in ("m", "v"):
        for got, want in zip(O.tree_leaves(tst[name]),
                             jax.tree_util.tree_leaves(jst[name])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
    for got, want in zip(O.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=BF16_ULP, atol=0)


def test_compress_int8_matches_the_reference():
    rng = np.random.default_rng(6)
    g = (rng.standard_normal((512,)) * 1e-3).astype(np.float32)
    err = np.zeros_like(g)
    terr = torch.zeros(512)
    for _ in range(5):
        q, scale, err = JO.compress_int8(jnp.asarray(g), jnp.asarray(err))
        tq, tscale, terr = O.compress_int8(torch.from_numpy(g), terr)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        assert float(tscale) == float(scale)
        np.testing.assert_array_equal(terr.numpy(), np.asarray(err))
        np.testing.assert_array_equal(
            O.decompress_int8(tq, tscale).numpy(),
            np.asarray(JO.decompress_int8(q, scale)))


def test_token_pipeline_matches_the_reference():
    a, b = TokenPipeline(256, 4, 16, seed=3), JaxPipeline(256, 4, 16, seed=3)
    try:
        for step in range(6):
            if step == 4:
                a.seek(1)
                b.seek(1)
            x, y = next(a), next(b)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(x[k], y[k])
        assert a.step == b.step == 3
    finally:
        a.close()
        b.close()


def _jax_state(cfg, jp):
    return {"params": jp, "opt": jax.device_get(JO.init_opt_state(jp)),
            "step": 0}


def _port_state(jp, jst):
    return {"params": params_from_jax(jp, device="cpu"),
            "opt": opt_state_from_jax(jst, device="cpu"), "step": 0}


def test_checkpoints_cross_restore(tmp_path):
    """JAX -> port and port -> JAX, bit for bit (bf16 through f32)."""
    cfg = JCONFIGS["qwen3-8b"].smoke()
    jp = _jax_params("qwen3-8b")
    _, g, st = _opt_inputs()
    jstate = _jax_state(cfg, jp)
    jstate["opt"]["step"] = np.int32(7)
    jstate["step"] = 7
    JaxCheckpointer(str(tmp_path / "j")).save(7, jstate, blocking=True)
    port = Checkpointer(str(tmp_path / "j"))
    assert port.latest_step() == 7
    zeros = jax.tree.map(np.zeros_like, jstate["params"])
    zeros32 = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), zeros)
    template = _port_state(zeros, {"m": zeros32, "v": zeros32, "step": 0})
    got = port.restore(7, template)
    assert got["step"] == 7 and int(got["opt"]["step"]) == 7
    assert got["params"]["embed"] is template["params"]["embed"]  # in place
    for path, want in jax.tree_util.tree_leaves_with_path(jstate["params"]):
        t = _leaf(got["params"], path)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want, np.float32))
    # port -> JAX: perturb, save, restore with the reference
    with torch.no_grad():
        got["params"]["embed"] += 1
        got["opt"]["m"]["embed"] += 0.5
    got["step"] = 9
    Checkpointer(str(tmp_path / "p")).save(9, got, blocking=True)
    jck = JaxCheckpointer(str(tmp_path / "p"))
    assert jck.latest_step() == 9
    back = jck.restore(9, jax.eval_shape(lambda: jstate))
    assert int(back["step"]) == 9
    for name in ("params", "opt"):
        for path, want in jax.tree_util.tree_leaves_with_path(back[name]):
            t = _leaf(got[name], path)
            assert np.asarray(want).dtype == {
                torch.bfloat16: ml_dtypes.bfloat16,
                torch.float32: np.float32, torch.int32: np.int32}[t.dtype]
            np.testing.assert_array_equal(
                np.asarray(want, np.float32 if t.is_floating_point()
                           else np.int32),
                t.float().numpy() if t.is_floating_point() else t.numpy())
    with pytest.raises(ValueError, match="keys differ"):
        Checkpointer(str(tmp_path / "p")).restore(9, {"step": 0})


def test_train_matches_the_reference_trajectory(tmp_path):
    """Both loops start from one step-0 checkpoint of the reference's
    parameters (each restores ``LATEST``), then take 4 steps on the same
    pipeline batches."""
    cfg = JCONFIGS["qwen3-8b"].smoke()
    jp = _jax_params("qwen3-8b")
    for d in ("j", "p"):
        JaxCheckpointer(str(tmp_path / d)).save(0, _jax_state(cfg, jp),
                                                blocking=True)
    logs = []
    want = jax_train(cfg, steps=4, batch=4, seq=32,
                     ckpt_dir=str(tmp_path / "j"), ckpt_every=100,
                     log=lambda *a: None)
    got = train(CONFIGS["qwen3-8b"].smoke(), steps=4, batch=4, seq=32,
                ckpt_dir=str(tmp_path / "p"), ckpt_every=100,
                log=logs.append, device="cpu")
    assert logs == ["restored checkpoint step 0"]
    assert len(got) == len(want) == 4 and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_LOSS_ATOL)


def test_restart_equals_the_uninterrupted_run(tmp_path):
    """The reference's fault test (fail at step 6, checkpoints every 4):
    12 losses, and the steps after the restore equal the uninterrupted
    run's exactly."""
    cfg = CONFIGS["qwen3-8b"].smoke()
    logs = []
    hit = train(cfg, steps=10, batch=4, seq=32, ckpt_dir=str(tmp_path / "a"),
                ckpt_every=4, injector=FailureInjector([6]), log=logs.append,
                device="cpu")
    clean = train(cfg, steps=10, batch=4, seq=32,
                  ckpt_dir=str(tmp_path / "b"), ckpt_every=4,
                  log=logs.append, device="cpu")
    assert len(hit) == 12 and len(clean) == 10
    assert hit[:6] == clean[:6] and hit[6:] == clean[4:]
    assert any(line.startswith("FAILURE: injected") for line in logs)
    assert Checkpointer(str(tmp_path / "a")).latest_step() == 8


def test_train_step_accumulates_microbatches():
    """n_micro=2 over the two halves of a batch against n_micro=1 on the
    whole batch: the same loss and grad norm (up to the f32 sums' order)
    and first moments ``m`` — the accumulated gradient — within the bf16
    rounding of the per-microbatch gradients."""
    cfg = CONFIGS["qwen3-8b"].smoke()
    batch = _tb(_batch(cfg.vocab, B=4, S=32, seed=7))
    out = []
    for n_micro in (1, 2):
        params = M.init_params(cfg, 0, device="cpu")
        st = O.init_opt_state(params)
        step = S.make_train_step(cfg, n_micro=n_micro)
        _, st, metrics = step(params, st, batch)
        out.append((metrics, st))
    (m1, s1), (m2, s2) = out
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]),
                               rtol=1e-2)
    for a, b in zip(O.tree_leaves(s1["m"]), O.tree_leaves(s2["m"])):
        rel = float((a - b).norm() / b.norm())
        assert rel < 1e-2, rel


def test_reference_train_step_with_microbatches_agrees():
    """The port's n_micro=2 step against the reference's, from the same
    parameters and optimizer state: the loss, the grad norm and the
    updated first moments."""
    jcfg = JCONFIGS["qwen3-8b"].smoke()
    jp = _jax_params("qwen3-8b")
    batch = _batch(jcfg.vocab, B=4, S=32, seed=8)
    jst = JO.init_opt_state(jp)
    _, jst2, jm = jax.jit(jax_make_train_step(jcfg, n_micro=2))(
        jp, jst, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(jp, device="cpu")
    tst = O.init_opt_state(tp)
    _, tst, tm = S.make_train_step(CONFIGS["qwen3-8b"].smoke(), n_micro=2)(
        tp, tst, _tb(batch))
    assert abs(float(tm["loss"]) - float(jm["loss"])) < LOSS_ATOL
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_REL_L2)
    for a, b in zip(O.tree_leaves(tst["m"]),
                    jax.tree_util.tree_leaves(jax.device_get(jst2["m"]))):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) / np.linalg.norm(b) < GRAD_REL_L2


def test_prefill_step_agrees_with_token_by_token_decode():
    """make_prefill_step's last logits (forward over flash attention)
    against make_decode_step fed the same tokens one at a time (paged
    attention over the KV cache), within ``LOGIT_ATOL``."""
    cfg = CONFIGS["qwen3-8b"].smoke()
    params = M.init_params(cfg, 0, device="cpu")
    batch = _tb(_batch(cfg.vocab, B=2, S=24, seed=9))
    last = S.make_prefill_step(cfg)(params, batch)
    logits, _ = M.forward(cfg, params, batch["tokens"])
    assert torch.equal(last, logits[:, -1])
    state = M.make_decode_state(cfg, 2, 64, device="cpu")
    step = S.make_decode_step(cfg)
    for t in range(24):
        out, state = step(params, state, batch["tokens"][:, t].long())
    np.testing.assert_allclose(out.float().numpy(), last.float().numpy(),
                               rtol=0, atol=LOGIT_ATOL)


def test_launcher_runs_on_the_cpu(tmp_path, capsys):
    losses = train_main(["--smoke", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--ckpt",
                         str(tmp_path)])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "final loss" in capsys.readouterr().out
    shutil.rmtree(tmp_path, ignore_errors=True)


class _KernelLikeRoute(torch.autograd.Function):
    """The kernel route's shape on the CPU: forward the plain version with
    one bf16 ulp added to a seeded 0.1 % of its outputs (the rounding
    steps in which a kernel that sums in another order differs),
    backward ``attention_bwd``; ``drop`` zeroes the dK and dV of KV head
    0, a wrong gradient for one GQA group."""

    @staticmethod
    def forward(ctx, q, k, v, drop):
        ctx.drop = drop
        ctx.save_for_backward(q, k, v)
        o = FR.flash_mha_ref(q, k, v, True)
        hit = torch.rand(o.shape, generator=torch.Generator().manual_seed(0)
                         ) < 1e-3
        return torch.where(hit, torch.nextafter(o, torch.full_like(
            o, float("inf"))), o)

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = FR.attention_bwd(*ctx.saved_tensors, do, True)
        if ctx.drop:
            dk[:, :, 0] = 0
            dv[:, :, 0] = 0
        return dq, dk, dv, None


def test_route_leaf_bound_separates_rounding_from_a_group_defect(
        monkeypatch):
    """chip_smoke.py's ``TRAIN_LEAF_REL_L2`` at its 12 layers, narrowed:
    a one-ulp change in 0.1 % of the attention outputs moves each
    attention leaf's gradient by about 2e-2 relative L2 (the bf16 backward
    carries it through every layer), inside the bound; a wrong dK/dV of
    one of two GQA groups moves them by 0.4 or more, far outside it."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = CONFIGS["qwen3-8b"].scaled(n_layers=12, d_model=256, n_heads=4,
                                     n_kv_heads=2, d_head=64, d_ff=512,
                                     vocab=1024)
    params = M.init_params(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 257),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    plain = S.loss_and_grads(cfg, params, batch, "ref")[1]["blocks"][0]
    gaps = {}
    for drop in (False, True):
        monkeypatch.setattr(M, "flash_mha", lambda q, k, v, causal, impl: (
            _KernelLikeRoute.apply(q.contiguous(), k.contiguous(),
                                   v.contiguous(), drop)))
        got = S.loss_and_grads(cfg, params, batch)[1]["blocks"][0]
        gaps[drop] = {n: float((got[n].float() - plain[n].float()).norm() /
                               plain[n].float().norm())
                      for n in smoke.ATTN_LEAVES}
    assert all(0 < e < smoke.TRAIN_LEAF_REL_L2 for e in gaps[False].values()
               ), gaps
    assert min(gaps[True].values()) > 4 * smoke.TRAIN_LEAF_REL_L2, gaps

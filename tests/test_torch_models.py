"""The port's model substrate against the JAX package's.

Primitives (``rmsnorm``, ``rope``, ``silu``/``swiglu``) on seeded bf16
inputs: equal to the reference run op by op, within one bf16 ulp (they
agree bit for bit on these inputs; the ulp allows for another order of
the f32 sums).  ``decode_step``: the reference's parameters and decode
state carried over by ``repro_torch.models.convert``, several steps of
seeded tokens through both, logits within ``LOGIT_ATOL``.  That
tolerance is a few bf16 ulps of the logits' range: the reference's
decode step is one jitted scan, and XLA:CPU fuses across it — it keeps
the sum of squares of ``rmsnorm`` in two halves and drops some bf16
round trips between fused ops — while the port rounds after every op as
the reference's ops do when run one by one (which the port matches bit
for bit, ``test_decode_step_matches_the_reference_op_by_op``).
"""
import functools
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.models import core as JM
from repro_torch.configs import CONFIGS
from repro_torch.models import core as M
from repro_torch.models.convert import decode_state_from_jax, params_from_jax

BF16_ULP = 2.0 ** -8
#: logits are bf16 of magnitude < 1 at the smoke widths (vocab 256)
LOGIT_ATOL = 2e-2


def _bf16(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(ml_dtypes.bfloat16)


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _close(got, want, ulps=1):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=ulps * BF16_ULP,
                               atol=ulps * BF16_ULP * 1e-2)


def test_configs_are_the_reference_configs():
    assert set(CONFIGS) == set(JCONFIGS)
    for name, cfg in CONFIGS.items():
        assert cfg.__dict__ == JCONFIGS[name].__dict__, name
        assert cfg.smoke().__dict__ == JCONFIGS[name].smoke().__dict__, name
        assert cfg.param_count() == JCONFIGS[name].param_count(), name


def test_rmsnorm_matches():
    rng = np.random.default_rng(0)
    x, w = _bf16(rng, (3, 1, 4, 16), 2.0), _bf16(rng, (16,), 0.1) + 1
    _close(M.rmsnorm(_t(x), _t(w)), JM.rmsnorm(jnp.asarray(x),
                                               jnp.asarray(w)))


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = _bf16(rng, (3, 2, 4, 32))
    pos = rng.integers(0, 4096, (3, 2)).astype(np.int32)
    _close(M.rope(_t(x), _t(pos), theta),
           JM.rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_silu_rounds_like_the_reference():
    rng = np.random.default_rng(2)
    x = _bf16(rng, (4096,), 3.0)
    got = M.silu(_t(x)).float().numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.nn.silu(jnp.asarray(x)), np.float32))


def test_swiglu_matches():
    rng = np.random.default_rng(3)
    p = {"w_gate": _bf16(rng, (64, 128), 0.1), "w_in": _bf16(rng, (64, 128),
                                                             0.1),
         "w_out": _bf16(rng, (128, 64), 0.1)}
    x = _bf16(rng, (3, 1, 64))
    _close(M.swiglu({k: _t(v) for k, v in p.items()}, _t(x)),
           JM.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x)))


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """The reference's seeded smoke parameters (its init compiles for a
    few seconds: made once per configuration)."""
    return JM.init_params(JCONFIGS[name].smoke(), 0)


def _carried(name, B=3, max_seq=128):
    cfg = JCONFIGS[name].smoke()
    jp = _jax_params(name)
    js = JM.make_decode_state(cfg, B, max_seq)
    P = js["block_tables"].shape[1]
    # per-row tables that are not the identity (every id below P, where the
    # reference is well defined), and rows 8 tokens short of a page end
    # (the zeroed slots before them are valid, zero keys and values)
    js["block_tables"] = jnp.asarray(np.stack(
        [np.roll(np.arange(P), b) for b in range(B)]).astype(np.int32))
    js["seq_lens"] = jnp.asarray([56, 57, 120][:B], jnp.int32)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    ts = decode_state_from_jax(jax.device_get(js), device="cpu")
    return cfg, jp, js, tp, ts


@pytest.mark.parametrize("name", ["qwen3-8b", "chatglm3-6b"])
def test_decode_step_matches_the_reference(name):
    """qwen3-8b (qk_norm, GQA 2) and chatglm3-6b (no qk_norm) at smoke
    widths; the steps cross a page boundary."""
    cfg, jp, js, tp, ts = _carried(name)
    jstep = jax.jit(JM.decode_step, static_argnums=0)
    rng = np.random.default_rng(4)
    for step in range(12):
        tok = rng.integers(0, cfg.vocab, 3)
        jl, js = jstep(cfg, jp, js, jnp.asarray(tok, jnp.int32))
        tl, ts2 = M.decode_step(CONFIGS[name].smoke(), tp, ts,
                                torch.from_numpy(tok))
        assert ts2 is ts and tl.dtype == torch.bfloat16
        if step % 4 == 0 or step > 8:
            np.testing.assert_allclose(tl.float().numpy(),
                                       np.asarray(jl, np.float32),
                                       rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(ts["seq_lens"].numpy(),
                                  np.asarray(js["seq_lens"]))
    # the KV written so far agrees within the same tolerance, page by page
    kp = np.asarray(js["kpool"], np.float32)
    kp = kp.reshape(ts["kpool"].shape)
    np.testing.assert_allclose(ts["kpool"].float().numpy(), kp, rtol=0,
                               atol=4 * LOGIT_ATOL)


def test_decode_step_matches_the_reference_op_by_op():
    """One layer, one step, against the reference's own functions run op
    by op (no jit): bit for bit."""
    cfg = JCONFIGS["qwen3-8b"].smoke().scaled(n_layers=1)
    jp = dict(_jax_params("qwen3-8b"))
    jp["blocks"] = jax.tree.map(lambda a: a[:1], jp["blocks"])
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    tok = np.asarray([5, 77, 200])
    pa = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    pm = jax.tree.map(lambda a: a[0], jp["blocks"][1])
    B, H, Hkv, D = 3, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    x = jp["embed"][jnp.asarray(tok)][:, None, :].astype(jnp.bfloat16)
    h = JM.rmsnorm(x, pa["norm"], cfg.norm_eps)
    v = (h @ pa["wv"]).reshape(B, 1, Hkv, D)
    # at position 0 attention returns the single valid V row
    o = jnp.repeat(v, H // Hkv, axis=2).reshape(B, 1, H * D) @ pa["wo"]
    x = x + o
    x = x + JM.swiglu(pm, JM.rmsnorm(x, pm["norm"], cfg.norm_eps))
    x = JM.rmsnorm(x, jp["final_norm"], cfg.norm_eps)
    want = np.asarray((x @ jp["lm_head"])[:, 0], np.float32)
    ts = M.make_decode_state(cfg, B, 128, device="cpu")
    got, _ = M.decode_step(cfg, tp, ts, torch.from_numpy(tok))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_init_params_layout_and_seed():
    cfg = CONFIGS["qwen3-8b"].smoke()
    ref = jax.device_get(_jax_params("qwen3-8b"))
    a = M.init_params(cfg, 0, device="cpu")
    b = M.init_params(cfg, 0, device="cpu")
    c = M.init_params(cfg, 1, device="cpu")
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    # embed, lm_head, final_norm; attn: wq wk wv wo norm q_norm k_norm;
    # mlp: w_gate w_in w_out norm
    assert len(flat_ref) == 3 + 7 + 4
    for path, leaf in flat_ref:
        t = a
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    # the reference's scales: 1/sqrt(fan_in) for projections, 0.02 embed
    wq = a["blocks"][0]["wq"].float()
    assert abs(wq.std().item() * math.sqrt(cfg.d_model) - 1) < 0.1
    assert abs(a["embed"].float().std().item() / 0.02 - 1) < 0.1


def test_decode_state_layout():
    cfg = CONFIGS["qwen3-8b"].smoke()
    st = M.make_decode_state(cfg, 3, 130, device="cpu")
    P = 3                                     # ceil(130 / 64)
    assert st["kpool"].shape == (cfg.n_layers, 1, 3 * P, M.PAGE_SIZE,
                                 cfg.n_kv_heads, cfg.d_head)
    assert st["block_tables"].tolist() == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    js = JM.make_decode_state(JCONFIGS["qwen3-8b"].smoke(), 3, 130)
    js["block_tables"] = js["block_tables"].at[1, 0].set(P)
    with pytest.raises(ValueError, match="wrong row"):
        decode_state_from_jax(jax.device_get(js), device="cpu")


def test_unported_layouts_raise():
    """The MoE, hybrid and xLSTM layouts raise everywhere, the training
    forward and loss included; the dense forward's KV-cache collection is
    not ported either."""
    for name in ("phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b", "xlstm-350m"):
        cfg = CONFIGS[name].smoke()
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            M.init_params(cfg, 0, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            M.make_decode_state(cfg, 1, 64, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            M.forward(cfg, {}, None)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            M.loss_fn(cfg, {}, {"tokens": None, "labels": None})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.forward(CONFIGS["qwen3-8b"].smoke(), {}, None, collect_cache=True)

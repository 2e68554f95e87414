"""The port's MoE, Mamba-hybrid and xLSTM families and sliding-window
decode against the JAX package, on the CPU at ``smoke()`` widths: the
sublayers alone, the parameter and decode-state layouts, decode steps, the
windowed ring.  ``forward``, its caches, ``loss_fn`` and the gradients are
in ``tests/test_torch_models_families_train.py``.

The reference's parameters and decode states are carried over with
``repro_torch.models.convert``; inputs are seeded with numpy.  The oracle
is the reference run **op by op** (its functions called eagerly, and
``forward``/``decode_step``/``jax.grad`` under ``jax.disable_jit()``)
wherever the jitted one routes differently: XLA:CPU fuses the f32 router
product and drops bf16 round trips, and at jamba's smoke widths that
moves some tokens to other experts (its jitted and op-by-op logits differ
by 0.55, its own two runs; ``tests/test_torch_models.py`` explains the
few-ulp differences of the dense layout).  Tolerances:

* the sublayers, decode steps and decode states: within ``ULPS`` bf16
  ulps of the output's largest magnitude (the port agrees bit for bit on
  most of these inputs; XLA's f32 dots sum in another order, which flips
  the rounding of a few bf16 elements), f32 states within ``F32_RTOL``;
* Mamba over two chunks of 256: the port's log-step scan combines in
  another order than ``lax.associative_scan``, ``SCAN_ULPS`` bf16 ulps;
* ``forward`` logits against the op-by-op reference within
  ``LOGIT_ATOL`` (the dense layout's decode tolerance), and every cache of
  ``collect_cache=True`` within ``CACHE_ULPS`` bf16 ulps of its largest
  magnitude — the f32 recurrent states too, since they sum bf16 inputs
  of which a few round the other way once a scan's f32 order differs;
* ``loss_fn`` within ``LOSS_ATOL`` and each gradient leaf within
  ``GRAD_REL_L2`` relative L2 of ``jax.grad`` (``tests/test_torch_training.py``:
  the gradients are bf16; measured at most 1.6e-2 here).
"""
import functools

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
from repro_torch.training.optim import tree_leaves

BF16_ULP = 2.0 ** -8
ULPS = 1
SCAN_ULPS = 4
CACHE_ULPS = 2
F32_RTOL = 1e-5
LOGIT_ATOL = 2e-2
LOSS_ATOL = 2e-3
GRAD_REL_L2 = 5e-2

MOE, HYBRID, SSM, MOE_TOP1, DENSE = ("phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b",
                                     "xlstm-350m", "llama4-scout-17b-a16e",
                                     "qwen3-8b")


def _bf16(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(ml_dtypes.bfloat16)


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, ulps=ULPS, what=""):
    """Every element within ``ulps`` bf16 ulps of the largest magnitude of
    ``want``: a product's output moves by about that when one of its
    bf16 inputs rounds the other way."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ulps * BF16_ULP * scale, err_msg=what)


def _cfgs(name, **kw):
    return JCONFIGS[name].smoke().scaled(**kw), \
        CONFIGS[name].smoke().scaled(**kw)


@functools.lru_cache(maxsize=None)
def _params(name):
    """The reference's seeded smoke parameters and the port's copy."""
    jp = JM.init_params(JCONFIGS[name].smoke(), 0)
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _sublayer(name, kind):
    """The first scan step's parameters of the layout's first ``kind``
    sublayer, in both packages."""
    jp, tp = _params(name)
    i = JM.period_layout(JCONFIGS[name].smoke()).index(kind)
    pj = jax.tree.map(lambda a: a[0], jp["blocks"][i])
    return pj, {k: v[0] for k, v in tp["blocks"][i].items()}


# ---------------------------------------------------------------------------
# the sublayers alone
# ---------------------------------------------------------------------------
def _routing(jcfg, pj, x2d):
    """The reference's assignments: top-k by its own ops, then the capacity
    positions of its stable sort."""
    logits = jnp.asarray(x2d).astype(jnp.float32) @ pj["router"].astype(
        jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.top_k)
    e = np.asarray(idx).reshape(-1)
    order = np.argsort(e, kind="stable")
    pos = np.arange(e.size) - np.searchsorted(e[order], e[order])
    T, K, E = x2d.shape[0], jcfg.top_k, jcfg.n_experts
    return int(jcfg.capacity_factor * T * K / E) + 1, pos


#: (config, experts, tokens): the smoke MoE; jamba's decode case (16
#: experts, top-2, 4 tokens: capacity 1, so tokens are dropped); top-1
@pytest.mark.parametrize("name,experts,T", [(MOE, None, 6), (MOE, 16, 4),
                                            (HYBRID, 16, 4),
                                            (MOE_TOP1, None, 5)])
def test_moe_matches_the_reference(name, experts, T):
    jcfg, tcfg = _cfgs(name)
    pj, pt = _sublayer(name, "moe")
    rng = np.random.default_rng(T)
    if experts:
        jcfg, tcfg = (c.scaled(n_experts=experts) for c in (jcfg, tcfg))
        pj = {k: _bf16(rng, (experts, *v.shape[1:]), 0.25) if v.ndim == 3
              else v for k, v in jax.device_get(pj).items()}
        pj["router"] = _bf16(rng, (jcfg.d_model, experts), 0.3)
        pt = params_from_jax(pj, device="cpu")
    x = _bf16(rng, (T, jcfg.d_model))
    want, jaux = JM.moe(pj, jcfg, jnp.asarray(x))
    got, taux = M.moe(pt, tcfg, _t(x))
    assert got.dtype == torch.bfloat16 and taux.dtype == torch.float32
    _close(got, want, what="moe output")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    C, pos = _routing(jcfg, pj, x)
    if experts:
        assert C == 1 and (pos >= C).any(), "no assignment was dropped"


def _state_mamba(rng, jcfg, B):
    return (rng.standard_normal((B, jcfg.d_inner, jcfg.ssm_state))
            .astype(np.float32) * 0.5,
            _bf16(rng, (B, jcfg.conv_width - 1, jcfg.d_inner)))


@pytest.mark.parametrize("S,with_state", [(1, True), (16, False),
                                          (16, True), (512, True)])
def test_mamba_matches_the_reference(S, with_state):
    """Decode (one token from a state), a prefill, a prefill from a state,
    and two chunks of ``SSM_CHUNK``."""
    jcfg, tcfg = _cfgs(HYBRID)
    pj, pt = _sublayer(HYBRID, "mamba")
    rng = np.random.default_rng(S)
    B = 2
    x = _bf16(rng, (B, S, jcfg.d_model))
    st = _state_mamba(rng, jcfg, B) if with_state else None
    want, (jh, jc) = JM.mamba(pj, jcfg, jnp.asarray(x),
                              None if st is None else tuple(map(jnp.asarray,
                                                                st)))
    got, (th, tc) = M.mamba(pt, tcfg, _t(x),
                            None if st is None else tuple(map(_t, st)))
    ulps = SCAN_ULPS if S > M.SSM_CHUNK else ULPS
    _close(got, want, ulps, "mamba output")
    assert th.dtype == torch.float32 and tc.dtype == torch.bfloat16
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=F32_RTOL,
                               atol=F32_RTOL * float(np.abs(jh).max()))
    np.testing.assert_array_equal(_np(tc), _np(jc))


@pytest.mark.parametrize("S,with_state", [(1, True), (16, False),
                                          (16, True), (512, True)])
def test_mlstm_matches_the_reference(S, with_state):
    jcfg, tcfg = _cfgs(SSM)
    pj, pt = _sublayer(SSM, "mlstm")
    rng = np.random.default_rng(S + 1)
    B, H = 2, jcfg.n_heads
    D = jcfg.d_model // H
    x = _bf16(rng, (B, S, jcfg.d_model))
    st = (rng.standard_normal((B, H, D, D)) * 0.3).astype(np.float32) \
        if with_state else None
    want, jC = JM.mlstm(pj, jcfg, jnp.asarray(x),
                        None if st is None else jnp.asarray(st))
    got, tC = M.mlstm(pt, tcfg, _t(x), None if st is None else _t(st))
    _close(got, want, SCAN_ULPS if S > M.SSM_CHUNK else ULPS,
           "mlstm output")
    assert tC.dtype == torch.float32
    np.testing.assert_allclose(tC.numpy(), np.asarray(jC), rtol=F32_RTOL,
                               atol=F32_RTOL * float(np.abs(jC).max()))


@pytest.mark.parametrize("S,with_state", [(1, True), (16, False),
                                          (16, True)])
def test_slstm_matches_the_reference(S, with_state):
    jcfg, tcfg = _cfgs(SSM)
    pj, pt = _sublayer(SSM, "slstm")
    assert pt["r"].dtype == torch.float32
    rng = np.random.default_rng(S + 2)
    B, d = 2, jcfg.d_model
    x = _bf16(rng, (B, S, d))
    st = tuple(np.tanh(rng.standard_normal((B, d))).astype(np.float32)
               for _ in range(2)) if with_state else None
    want, (jh, jc) = JM.slstm(pj, jcfg, jnp.asarray(x),
                              None if st is None else tuple(map(jnp.asarray,
                                                                st)))
    got, (th, tc) = M.slstm(pt, tcfg, _t(x),
                            None if st is None else tuple(map(_t, st)))
    _close(got, want, what="slstm output")
    for a, b in ((th, jh), (tc, jc)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=F32_RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("module", [
    "chatglm3_6b", "deepseek_coder_33b", "internvl2_76b", "jamba_v0_1_52b",
    "llama3_405b", "llama4_scout_17b_a16e", "musicgen_medium",
    "phi35_moe_42b", "qwen3_8b", "xlstm_350m"])
def test_per_model_config_modules_match_the_reference(module):
    import importlib
    ours = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
    want = importlib.import_module(f"repro.configs.{module}").CONFIG
    assert ours.__dict__ == want.__dict__
    assert ours is CONFIGS[ours.name]


# ---------------------------------------------------------------------------
# parameters and decode state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [MOE, HYBRID, SSM, MOE_TOP1])
def test_init_params_and_decode_state_layouts(name):
    """``init_params`` has the reference's tree, shapes and dtypes (``A_log``
    and ``r`` f32, the rest bf16); ``params_from_jax`` keeps every dtype;
    ``make_decode_state`` has the reference's leaves, the pools flattened
    to global pages, none without attention."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    ours = M.init_params(tcfg, 0, device="cpu")
    again = M.init_params(tcfg, 0, device="cpu")
    for (path, leaf), mine, carried, same in zip(
            jax.tree_util.tree_leaves_with_path(jax.device_get(jp)),
            tree_leaves(ours), tree_leaves(tp), tree_leaves(again)):
        want = torch.float32 if leaf.dtype == np.float32 else torch.bfloat16
        assert tuple(mine.shape) == leaf.shape, path
        assert mine.dtype == carried.dtype == want, path
        assert torch.equal(mine, same)
    assert len(tree_leaves(ours)) == len(jax.tree_util.tree_leaves(jp))
    js = JM.make_decode_state(jcfg, 3, 200)
    ts = M.make_decode_state(tcfg, 3, 200, device="cpu")
    assert set(ts) == set(js)
    for key, leaf in js.items():
        shape = leaf.shape
        if key in ("kpool", "vpool"):
            shape = (*shape[:2], shape[2] * shape[3], *shape[4:])
        assert tuple(ts[key].shape) == shape, key
        assert str(ts[key].dtype).split(".")[1] == str(leaf.dtype), key
    assert ("kpool" in ts) == (name != SSM)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _seeded_state(jcfg, B, max_seq, seq_lens, seed):
    """The reference's decode state with seeded pools and recurrent states
    and the given lengths, and the port's copy of it."""
    rng = np.random.default_rng(seed)
    js = jax.device_get(JM.make_decode_state(jcfg, B, max_seq))
    js = {k: np.array(v) for k, v in js.items()}
    for k, v in js.items():
        if k in ("kpool", "vpool", "mamba_conv"):
            js[k] = _bf16(rng, v.shape, 0.5)
        elif k in ("mamba_h", "mlstm_C"):
            js[k] = (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
        elif k in ("slstm_h", "slstm_c"):
            js[k] = np.tanh(rng.standard_normal(v.shape)).astype(np.float32)
    js["seq_lens"] = np.asarray(seq_lens, np.int32)
    return {k: jnp.asarray(v) for k, v in js.items()}, \
        decode_state_from_jax(js, device="cpu")


def _decode_both(jcfg, tcfg, jp, tp, js, ts, steps, seed):
    rng = np.random.default_rng(seed)
    B = ts["seq_lens"].shape[0]
    for _ in range(steps):
        tok = rng.integers(0, jcfg.vocab, B)
        with jax.disable_jit():
            jl, js = JM.decode_step(jcfg, jp, js, jnp.asarray(tok, jnp.int32))
        tl, ts2 = M.decode_step(tcfg, tp, ts, torch.from_numpy(tok))
        assert ts2 is ts and tl.dtype == torch.bfloat16
        _close(tl, jl, what="logits")
    np.testing.assert_array_equal(ts["seq_lens"].numpy(),
                                  np.asarray(js["seq_lens"]))
    want = decode_state_from_jax(jax.device_get(js), device="cpu")
    for key, leaf in want.items():
        if leaf.dtype == torch.float32:
            np.testing.assert_allclose(
                ts[key].numpy(), leaf.numpy(), rtol=F32_RTOL,
                atol=F32_RTOL * float(leaf.abs().max()), err_msg=key)
        else:
            _close(ts[key], leaf, what=key)
    return tl, jl


@pytest.mark.parametrize("name", [MOE, MOE_TOP1, HYBRID, SSM])
def test_decode_steps_match_the_reference(name):
    """Several steps from the reference's state (seeded pools and
    recurrent states, lengths inside the table) against the reference's
    ``decode_step`` op by op: logits and the whole state after them."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    js, ts = _seeded_state(jcfg, 3, 128, [5, 63, 100], seed=3)
    _decode_both(jcfg, tcfg, jp, tp, js, ts, 3, seed=4)


def test_windowed_ring_past_its_wrap():
    """jamba at smoke width with a window of 64 and ``max_seq`` 200: the
    ring holds ``min(200, 64 + 64)`` = 128 slots (2 pages), and rows past
    128 tokens wrap; seeded pools, so every slot of the ring holds a
    distinct value and the window masks 64 of them."""
    jcfg, tcfg = _cfgs(HYBRID, sliding_window=64)
    assert M.pages_per_seq(tcfg, 200) == 2
    jp, tp = _params(HYBRID)
    js, ts = _seeded_state(jcfg, 3, 200, [130, 150, 191], seed=5)
    assert ts["block_tables"].shape == (3, 2)
    _decode_both(jcfg, tcfg, jp, tp, js, ts, 3, seed=6)


def test_window_attends_unwritten_slots_in_both_packages():
    """The recorded reference fault: jamba's window (8192) covers its whole
    ring at ``max_seq`` 128, so a one-token sequence attends to the ring's
    127 unwritten (zero) slots too.  Its first step's logits differ from
    the same model's without a window — in both packages alike, and each
    package equal to the other."""
    out = {}
    for window in (8192, 0):
        jcfg, tcfg = _cfgs(HYBRID, sliding_window=window)
        jp, tp = _params(HYBRID)
        js = JM.make_decode_state(jcfg, 2, 128)
        ts = decode_state_from_jax(jax.device_get(js), device="cpu")
        out[window] = _decode_both(jcfg, tcfg, jp, tp, js, ts, 1, seed=7)
    for i in range(2):
        assert np.abs(_np(out[8192][i]) - _np(out[0][i])).max() > 1e-2

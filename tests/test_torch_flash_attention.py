"""The port's flash attention against the JAX package's, on the CPU.

The plain versions (``attention_ref`` on ``(BH, S, D)``, ``flash_mha_ref``
on ``(B, S, H, D)`` with GQA) against the reference's ``attention_ref``
and its Pallas ``flash_mha`` in interpret mode, at the tolerances of
``tests/test_kernels.py`` (2e-3 in float32, 2e-2 in bfloat16); the plain
backward ``attention_bwd`` against ``jax.grad`` of the reference's
``attention_ref`` through the GQA fold, in float32, to a relative L2
error of 1e-5 per gradient (f32 rounding: both sum the same products in
another order).  The CUDA kernel itself is held against the plain version
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``); here its
tensor-core design's numerics are emulated, to pin why it splits the
probabilities into three bf16 parts (``ref.ATTN_TOL``, the card check's
bound).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention as pallas_flash)
from repro.kernels.flash_attention.ops import flash_mha as jax_flash_mha
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention)
from repro_torch.kernels.flash_attention.ref import (ATTN_TOL, attention_bwd,
                                                     attention_ref,
                                                     flash_mha_ref)

TOL = {"float32": 2e-3, "bfloat16": 2e-2}
GRAD_REL_L2 = 1e-5
#: the shapes of tests/test_kernels.py, (BH, S, D)
KERNEL_SHAPES = [((2, 256, 64), "float32"), ((1, 128, 128), "float32"),
                 ((3, 384, 64), "bfloat16")]


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [rng.standard_normal(s).astype(np_dt) for s in shapes]


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,dtype", KERNEL_SHAPES)
def test_attention_ref_matches_the_reference(shape, dtype, causal):
    q, k, v = _inputs(0, [shape] * 3, dtype)
    got = attention_ref(_t(q), _t(k), _t(v), causal)
    assert got.dtype == getattr(torch, dtype)
    _close(got, jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal), dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,dtype", KERNEL_SHAPES)
def test_flash_mha_ref_matches_the_pallas_kernel(shape, dtype, causal):
    """The same shapes as (B=1, S, H=BH, D), against the reference's
    flash_mha — the Pallas kernel in interpret mode."""
    BH, S, D = shape
    q, k, v = _inputs(1, [(1, S, BH, D)] * 3, dtype)
    want = jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, interpret=True)
    _close(flash_mha_ref(_t(q), _t(k), _t(v), causal), want, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_mha_ref_gqa(causal):
    """G = 4 (8 query heads on 2 KV heads) at a narrow width."""
    q, k, v = _inputs(2, [(2, 128, 8, 16), (2, 128, 2, 16),
                          (2, 128, 2, 16)], "float32")
    want = jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, interpret=True)
    _close(flash_mha_ref(_t(q), _t(k), _t(v), causal), want, "float32")
    # the CPU route of the entry point is the plain version
    _close(ops.flash_mha(_t(q), _t(k), _t(v), causal), want, "float32")


@pytest.mark.parametrize("S", [1, 200])
def test_attention_ref_at_any_length(S):
    """S = 1 and an S that is no multiple of the TPU kernel's tile."""
    for causal in (True, False):
        q, k, v = _inputs(S, [(2, S, 64)] * 3, "float32")
        got = attention_ref(_t(q), _t(k), _t(v), causal)
        assert torch.isfinite(got).all()
        _close(got, jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal), "float32")


def test_pallas_kernel_is_nan_past_a_partial_tile():
    """ROADMAP Queue C: at S = 200 (over 128 and not a multiple of the
    128 tile) the reference's Pallas kernel reads its padded K/V rows as
    NaN and ``p @ v`` carries ``0 * NaN`` into valid rows, while its
    ``ref.py`` — the specification — and the port's plain version agree
    and are finite.  The port's kernel computes ``ref.py`` at every S."""
    q, k, v = _inputs(3, [(2, 200, 64)] * 3, "float32")
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    for causal in (True, False):
        pallas = np.asarray(pallas_flash(jq, jk, jv, causal=causal,
                                         interpret=True))
        assert np.isnan(pallas).any()
        want = jax_ref(jq, jk, jv, causal=causal)
        assert np.isfinite(np.asarray(want)).all()
        _close(attention_ref(_t(q), _t(k), _t(v), causal), want, "float32")


def _jax_mha_ref(q, k, v, causal):
    """The reference's GQA fold (``ops.py``) over its ``attention_ref``:
    differentiable, unlike the Pallas kernel."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(B * H, S, D)
    o = jax_ref(fold(q), fold(jnp.repeat(k, G, axis=2)),
                fold(jnp.repeat(v, G, axis=2)), causal=causal)
    return o.reshape(B, H, S, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hkv,D", [(2, 64, 2, 2, 32),
                                         (1, 96, 8, 2, 16)])
def test_plain_backward_matches_jax_grad(B, S, H, Hkv, D, causal):
    q, k, v, do = _inputs(4, [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D),
                              (B, S, H, D)], "float32")
    want = jax.grad(lambda q, k, v: jnp.sum(
        _jax_mha_ref(q, k, v, causal) * do), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = attention_bwd(_t(q), _t(k), _t(v), _t(do), causal)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert g.dtype == torch.float32 and rel < GRAD_REL_L2, (name, rel)


def test_entry_point_checks_its_arguments():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="impl"):
        ops.flash_mha(q, q, q, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    # impl="ref" is the plain version by name on any device
    assert torch.equal(ops.flash_mha(q, q, q, impl="ref"),
                       flash_mha_ref(q, q, q))


# A pin of the tensor-core design's numerics: the kernel runs only on the
# card, so its arithmetic is emulated here against the bound the card
# check holds it to.

def _tensor_core_numerics(q, k, v, causal, parts):
    """The tensor-core design's arithmetic on the CPU, (BH, S, D) bf16:
    128-row query tiles over 128-key tiles, scores in f32 scaled by
    log2(e)/sqrt(D), an online softmax in the exp2 domain from -1e30, the
    row sum l from the f32 probabilities, and P V accumulated in f32 from
    P split into ``parts`` bf16 parts, each the rounding of what the parts
    before it left over (the kernel uses 3)."""
    BH, S, D = q.shape
    scale = 1.4426950408889634 / np.sqrt(D)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty_like(qf)
    rows = torch.arange(S)[:, None]
    for q0 in range(0, S, 128):
        qt = qf[:, q0:q0 + 128]
        n = qt.shape[1]
        m = torch.full((BH, n, 1), -1e30)
        l = torch.zeros((BH, n, 1))
        acc = torch.zeros((BH, n, D))
        end = min(S, q0 + 128) if causal else S
        for k0 in range(0, end, 128):
            s = qt @ kf[:, k0:k0 + 128].transpose(1, 2) * scale
            cols = torch.arange(k0, min(S, k0 + 128))[None]
            if causal:
                s = torch.where(cols <= rows[q0:q0 + n], s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            vt = vf[:, k0:k0 + 128]
            pv = torch.zeros_like(acc)
            for _ in range(parts):
                part = p.bfloat16().float()
                pv = pv + part @ vt
                p = p - part
            acc = acc * corr + pv
            m = m_new
        out[:, q0:q0 + n] = acc / l
    return out.to(q.dtype)


def _over_chip_tolerance(got, want):
    atol, rtol = ATTN_TOL["bfloat16"]
    diff = (got.float() - want.float()).abs()
    return int((diff > atol + rtol * want.float().abs()).sum())


def _folded(seed, B, S, H, Hkv, D):
    """(B, S, H, Hkv, D) GQA inputs as flash_mha folds them: (B·H, S, D),
    each KV head read by its H / Hkv query heads."""
    q, k, v = (_t(x) for x in _inputs(seed, [(B, S, H, D), (B, S, Hkv, D),
                                              (B, S, Hkv, D)], "bfloat16"))

    def fold(x):
        return x.repeat_interleave(H // x.shape[2], dim=2).transpose(1, 2) \
            .reshape(B * H, S, D)
    return fold(q), fold(k), fold(v)


@pytest.mark.parametrize("shape,causal", [((3, 384, 1, 1, 64), True),
                                          ((4, 200, 1, 1, 128), False),
                                          ((1, 200, 4, 2, 128), True),
                                          ((2, 300, 8, 2, 64), True)])
def test_tensor_core_numerics_need_three_parts_of_p(shape, causal):
    """Why the tensor-core kernel issues P three times: split into three
    bf16 parts its arithmetic meets the card check's ``ATTN_TOL`` against
    ``attention_ref``; rounded to bf16 once (a textbook FA kernel) it
    misses it by hundreds of elements or more."""
    q, k, v = _folded(sum(shape), *shape)
    want = attention_ref(q, k, v, causal)
    got = _tensor_core_numerics(q, k, v, causal, parts=3)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert _over_chip_tolerance(got, want) == 0
    single = _tensor_core_numerics(q, k, v, causal, parts=1)
    assert _over_chip_tolerance(single, want) > 100


#: inputs seeded 0, 1, 2: two parts miss at seeds 0 and 2
SEEDS_TWO_PARTS = 3


def test_two_parts_of_p_miss_the_tolerance_where_outputs_cancel():
    """Two parts leave 2^-18 of P: at (2, 300, 8, 2, 64) causal an output
    that cancels to near 0 then misses the 1e-6 absolute floor of
    ``ATTN_TOL``, which three parts meet."""
    over = {2: 0, 3: 0}
    for seed in range(SEEDS_TWO_PARTS):
        q, k, v = _folded(seed, 2, 300, 8, 2, 64)
        want = attention_ref(q, k, v, True)
        for parts in over:
            over[parts] += _over_chip_tolerance(
                _tensor_core_numerics(q, k, v, True, parts), want)
    assert over[2] > 0 and over[3] == 0


@pytest.mark.parametrize("window", [1, 5, 16])
def test_windowed_plain_version_matches_the_reference(window):
    """``flash_mha_ref`` with a sliding window against the reference's
    ``_online_attn`` with the same window (positions by index), f32;
    a window of ``S`` or more is full causal attention."""
    from repro.models.core import _online_attn
    rng = np.random.default_rng(window)
    B, S, H, Hkv, D = 2, 16, 4, 2, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want = _online_attn(jnp.asarray(q).reshape(B, S, Hkv, H // Hkv, D),
                        jnp.asarray(k), jnp.asarray(v), pos, pos, window)
    got = ops.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
        B, S, H, D), rtol=1e-5, atol=1e-5)
    full = ops.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v))
    assert torch.equal(ops.flash_mha(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), window=S), full)
    assert (window >= S) == torch.equal(got, full)


@pytest.mark.parametrize("window", [1, 5, 16])
def test_windowed_backward_matches_jax_grad(window):
    """``attention_bwd`` with a sliding window against ``jax.grad`` of the
    reference's ``_online_attn`` with that window (GQA, f32), to the
    file's relative L2 of 1e-5 per gradient."""
    from repro.models.core import _online_attn
    B, S, H, Hkv, D = 2, 40, 4, 2, 16
    q, k, v, do = _inputs(7 + window, [(B, S, H, D), (B, S, Hkv, D),
                                       (B, S, Hkv, D), (B, S, H, D)],
                          "float32")
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    def ref(q, k, v):
        o = _online_attn(q.reshape(B, S, Hkv, H // Hkv, D), k, v, pos, pos,
                         window)
        return jnp.sum(o.reshape(B, S, H, D) * do)
    want = jax.grad(ref, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = attention_bwd(_t(q), _t(k), _t(v), _t(do), True, window)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        err = np.linalg.norm(g.numpy() - w)
        # a window of 1 attends one key a row: dq is exactly 0 in both
        rel = err / np.linalg.norm(w) if np.any(w) else err
        assert g.dtype == torch.float32 and rel < GRAD_REL_L2, (name, rel)
    full = attention_bwd(_t(q), _t(k), _t(v), _t(do), True)
    assert not torch.equal(got[0], full[0])


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, to reach the kernel route
    without one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("window,sent", [(0, 0), (7, 7), (40, 0), (99, 0)])
def test_kernel_route_passes_the_window_to_the_kernel(monkeypatch, window,
                                                      sent):
    """``flash_mha`` on the kernel route hands the window to the kernel's
    launch (0 where it masks nothing: ``window >= S``), and the
    ``autograd.Function`` keeps it for the backward: its gradients equal
    autograd through the plain version with that window.  The build
    helpers are replaced by ones that record the launch."""
    import types
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as FA
    calls = []
    monkeypatch.setattr(_build, "check_tensor", lambda *a: None)
    monkeypatch.setattr(_build, "entry", lambda *a: "flash_attention_launch")
    monkeypatch.setattr(_build, "launch",
                        lambda op, fn, args, dev: calls.append(args))
    monkeypatch.setattr(FA.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    B, S, H, Hkv, D = 1, 40, 4, 2, 16
    q, k, v, do = (_t(x) for x in _inputs(
        3, [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)],
        "float32"))
    qc, kc, vc = (x.clone().as_subclass(_OnCard).requires_grad_(True)
                  for x in (q, k, v))
    out = ops.flash_mha(qc, kc, vc, window=window)
    assert len(calls) == 1
    (B_, S_, H_, Hkv_, D_, causal, win) = calls[0][4:11]
    assert (B_, S_, H_, Hkv_, D_, causal, win) == (B, S, H, Hkv, D, 1, sent)
    got = torch.autograd.grad(out, (qc, kc, vc), do)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    want = torch.autograd.grad(flash_mha_ref(qr, kr, vr, True, window),
                               (qr, kr, vr), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.as_subclass(torch.Tensor), w,
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        ops.flash_mha(qc, kc, vc, impl="pallas", window=window)
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention(qc, kc, vc, causal=False, window=3)

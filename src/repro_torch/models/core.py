"""Model substrate of the port: every layout of the registry, for training
and serving.

The counterpart of :mod:`repro.models.core`: the primitives
(:func:`rmsnorm`, :func:`rope`, :func:`swiglu`), the sublayers
(:func:`attention`, :func:`moe`, :func:`mamba`, :func:`mlstm`,
:func:`slstm`), the parameter layout and seeded initialisation
(:func:`init_params`, plain dictionaries of tensors stacked over scan
steps, as the reference's pytrees), the training / prefill
:func:`forward` and :func:`loss_fn`, the decode state
(:func:`make_decode_state`: a paged KV cache and the recurrent states) and
one decode step (:func:`decode_step`).  PyTorch runs eagerly, so the
reference's scan over layers is a Python loop, ``jax.checkpoint`` around a
scan step is ``torch.utils.checkpoint.checkpoint`` and the decode state is
updated in place.

The KV cache is one **global** page pool per K and V, ``(steps, n_attn,
NP, page, Hkv, D)``, addressed by the block table — the contract of the
paged-attention and page-op kernels.  The reference keeps a per-row pool
``(steps, n_attn, B, pages_per_seq, ...)`` and indexes it with the
serving engine's global page ids, which is only well defined while every
id is below ``pages_per_seq``; where it is, the global pool gives the
same numbers (flatten the rows to ``B * pages_per_seq`` pages and offset
row ``b``'s table by ``b * pages_per_seq``, as
:func:`repro_torch.models.convert.decode_state_from_jax` does).  Under a
sliding window the cache is the reference's ring of ``min(max_seq, window
+ PAGE_SIZE)`` slots, and decode attends to ring slot ``t`` iff ``(seq_len
- t) mod ring < window`` — slots never written included, as the reference
does (ROADMAP Queue C, "Recorded").

Attention goes through the ported kernels: :func:`forward` through
:func:`repro_torch.kernels.flash_attention.ops.flash_mha` (the reference
calls its own ``_online_attn``, the same function: ``q`` scaled in f32
first, the causal and window masks by index, an f32 softmax), decode
through :func:`repro_torch.kernels.paged_attention.ops.paged_decode`.  The
MoE dispatch, the scans and the recurrences have no Pallas twin in the
reference (it leaves them to XLA) and stay plain PyTorch; every product
stays ``torch.matmul``.  bf16 values are rounded after every operation,
as the reference's operations round them.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import dtensor as DT
from ..kernels.flash_attention.ops import flash_mha
from ..kernels.paged_attention.ops import paged_decode
from .config import ModelConfig

F32 = torch.float32
BF16 = torch.bfloat16
I32 = torch.int32

SSM_CHUNK = 256
PAGE_SIZE = 64          # tokens per KV page

#: the sublayers that carry decode state, in the state's key order
_STATEFUL = ("attn", "mamba", "mlstm", "slstm")


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-5):
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


def rope_angles(positions, d, theta):
    """``cos``/``sin`` ``(..., S, 1, d // 2)`` f32 of ``positions``
    ``(..., S)``; one decode step computes them once for every layer."""
    half = d // 2
    freqs = torch.exp(-math.log(theta) *
                      torch.arange(half, dtype=F32, device=positions.device)
                      / half)
    ang = positions[..., :, None, None].to(F32) * freqs
    return torch.cos(ang), torch.sin(ang)


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_apply(x, cos, sin):
    """RoPE of ``x`` ``(..., S, H, D)`` by angles from
    :func:`rope_angles`; on DTensors shard by shard
    (:func:`DT.local_rope`)."""
    return DT.local_rope(_rope, x, cos, sin)


def rope(x, positions, theta):
    """x (..., S, H, D); positions (..., S)."""
    return rope_apply(x, *rope_angles(positions, x.shape[-1], theta))


class _Silu(torch.autograd.Function):
    """The forward rounds as :func:`silu` says; the backward is
    ``g * (s + x * s * (1 - s))`` with ``s = sigmoid(x)``, all in f32.
    Autograd through ``1 / (1 + exp(-x))`` itself would multiply the
    gradient 0 by ``exp(-x) = inf`` where ``x`` is below about -88 (the
    reference's ``jax.nn.silu`` differentiates its stable ``sigmoid``):
    jamba's expert pre-activations, of standard deviation 16 at full
    width, reach it in a few elements a step."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * (1 / (1 + torch.exp(-x)))

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        xf = x.float()
        sf = torch.sigmoid(xf)
        return (g.float() * (sf + xf * sf * (1 - sf))).to(g.dtype)


def silu(x):
    """``x * sigmoid(x)`` with ``sigmoid(x) = 1 / (1 + exp(-x))`` rounded
    to ``x``'s dtype after every operation, as the reference's
    ``jax.nn.silu`` is in bfloat16 (``F.silu`` rounds once, which differs
    in the last bfloat16 bit for about a tenth of the inputs); a finite
    gradient at every finite ``x`` (:class:`_Silu`)."""
    return _Silu.apply(x)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    in ``x``'s dtype, rounded after every operation.  Not ``F.softplus``,
    which returns ``x`` itself above a threshold of 20."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def swiglu(p, x):
    return DT.matmul(silu(DT.matmul(x, p["w_gate"])) *
                     DT.matmul(x, p["w_in"]), p["w_out"])


# ---------------------------------------------------------------------------
# parameters (stacked over scan steps, as the reference's scan carries them)
# ---------------------------------------------------------------------------
def _device(gen):
    """The device parameters are drawn on: the generator's, or ``meta``
    (``gen`` None: shapes and dtypes only, nothing drawn or allocated)."""
    return torch.device("meta") if gen is None else gen.device


def _dense_init(gen, shape, scale=None, steps=None):
    """bf16 ``N(0, scale^2)``, ``scale = 1/sqrt(shape[0])`` by default (the
    reference's fan-in: the expert count for an expert stack); with
    ``steps``, ``steps`` such tensors stacked, drawn one at a time so the
    f32 draw never holds more than one scan step."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale or (1.0 / math.sqrt(fan_in))
    dev = _device(gen)
    if gen is None:
        return torch.empty(shape if steps is None else (steps, *shape),
                           dtype=BF16, device=dev)

    def draw():
        return (torch.randn(shape, generator=gen, dtype=F32, device=dev)
                * scale).to(BF16)
    if steps is None:
        return draw()
    out = torch.empty((steps, *shape), dtype=BF16, device=dev)
    for i in range(steps):
        out[i] = draw()
    return out


def _full(gen, shape, value, steps, dtype=BF16):
    return torch.full((steps, *shape), value, dtype=dtype,
                      device=_device(gen))


def _attn_params(gen, cfg: ModelConfig, steps):
    d, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": _dense_init(gen, (d, H * D), steps=steps),
        "wk": _dense_init(gen, (d, Hkv * D), steps=steps),
        "wv": _dense_init(gen, (d, Hkv * D), steps=steps),
        "wo": _dense_init(gen, (H * D, d), steps=steps),
        "norm": _full(gen, (d,), 1.0, steps),
    }
    if cfg.qk_norm:
        p["q_norm"] = _full(gen, (D,), 1.0, steps)
        p["k_norm"] = _full(gen, (D,), 1.0, steps)
    return p


def _mlp_params(gen, cfg: ModelConfig, steps):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": _dense_init(gen, (d, ff), steps=steps),
        "w_in": _dense_init(gen, (d, ff), steps=steps),
        "w_out": _dense_init(gen, (ff, d), steps=steps),
        "norm": _full(gen, (d,), 1.0, steps),
    }


def _moe_params(gen, cfg: ModelConfig, steps):
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {
        "router": _dense_init(gen, (d, E), scale=0.02, steps=steps),
        "w_gate": _dense_init(gen, (E, d, ff), steps=steps),
        "w_in": _dense_init(gen, (E, d, ff), steps=steps),
        "w_out": _dense_init(gen, (E, ff, d), steps=steps),
        "norm": _full(gen, (d,), 1.0, steps),
    }


def _mamba_params(gen, cfg: ModelConfig, steps):
    d, di, N, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.conv_width
    # A_log stays f32, as in the reference
    a_log = torch.log(torch.arange(1, N + 1, dtype=F32, device=_device(gen))
                      / 2.0)
    return {
        "w_in": _dense_init(gen, (d, 2 * di), steps=steps),
        "conv_w": _dense_init(gen, (W, di), scale=0.2, steps=steps),
        "w_dt": _dense_init(gen, (di, di), scale=0.01, steps=steps),
        "dt_bias": _full(gen, (di,), 0.0, steps),
        "w_B": _dense_init(gen, (di, N), steps=steps),
        "w_C": _dense_init(gen, (di, N), steps=steps),
        "A_log": a_log.expand(steps, di, N).contiguous(),
        "d_skip": _full(gen, (di,), 1.0, steps),
        "w_out": _dense_init(gen, (di, d), steps=steps),
        "norm": _full(gen, (d,), 1.0, steps),
    }


def _mlstm_params(gen, cfg: ModelConfig, steps):
    d = cfg.d_model
    return {
        "wq": _dense_init(gen, (d, d), steps=steps),
        "wk": _dense_init(gen, (d, d), steps=steps),
        "wv": _dense_init(gen, (d, d), steps=steps),
        "wf": _dense_init(gen, (d, cfg.n_heads), scale=0.02, steps=steps),
        "wi": _dense_init(gen, (d, cfg.n_heads), scale=0.02, steps=steps),
        "wo": _dense_init(gen, (d, d), steps=steps),
        "out_norm": _full(gen, (d,), 1.0, steps),
        "norm": _full(gen, (d,), 1.0, steps),
    }


def _slstm_params(gen, cfg: ModelConfig, steps):
    d = cfg.d_model
    return {
        "w_z": _dense_init(gen, (d, d), steps=steps),
        "w_f": _dense_init(gen, (d, d), steps=steps),
        "w_i": _dense_init(gen, (d, d), steps=steps),
        "w_o": _dense_init(gen, (d, d), steps=steps),
        # bf16 values held in f32, as in the reference
        "r": _dense_init(gen, (d, d), scale=0.02, steps=steps).float(),
        "w_out": _dense_init(gen, (d, d), steps=steps),
        "norm": _full(gen, (d,), 1.0, steps),
    }


def period_layout(cfg: ModelConfig) -> list[str]:
    """Sub-layer layout of one scan step.

    dense:  ["attn", "mlp"] x 1 layer per step
    moe:    ["attn", "moe"]
    hybrid: per period: attn at pos 0 else mamba; mlp or moe after each
    ssm:    ["mlstm", "mlp"] / ["slstm", "mlp"] alternating
    """
    if cfg.arch_type == "dense":
        return ["attn", "mlp"]
    if cfg.arch_type == "moe":
        return ["attn", "moe"]
    if cfg.arch_type == "hybrid":
        out = []
        for pos in range(cfg.hybrid_period):
            out.append("attn" if pos == 0 else "mamba")
            if cfg.moe_every and pos % cfg.moe_every == cfg.moe_every - 1:
                out.append("moe")
            else:
                out.append("mlp")
        return out
    # ssm / xlstm: one mLSTM block + one sLSTM block per period
    return ["mlstm", "mlp", "slstm", "mlp"]


def n_scan_steps(cfg: ModelConfig) -> int:
    if cfg.arch_type == "hybrid":
        return cfg.n_layers // cfg.hybrid_period
    if cfg.arch_type == "ssm":
        return cfg.n_layers // 2
    return cfg.n_layers


_SUBLAYER_INIT = {
    "attn": _attn_params, "mlp": _mlp_params, "moe": _moe_params,
    "mamba": _mamba_params, "mlstm": _mlstm_params, "slstm": _slstm_params,
}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Seeded random parameters in the reference's layout (``embed``,
    ``blocks`` = one dict per sublayer of :func:`period_layout` with every
    leaf stacked over scan steps, ``final_norm``, ``lm_head`` unless
    tied), bf16 but for the f32 ``A_log`` and ``r``, on ``device``.  A
    ``torch.Generator`` on that device draws them, so the numbers differ
    from the reference's ``jax.random`` ones; tests carry the reference's
    parameters over with
    :func:`repro_torch.models.convert.params_from_jax`.  On the ``meta``
    device nothing is drawn: the shapes and dtypes alone (the reference's
    ``jax.eval_shape`` of this function)."""
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    steps = n_scan_steps(cfg)
    params = {
        "embed": _dense_init(gen, (cfg.vocab, cfg.d_model), scale=0.02),
        "blocks": [_SUBLAYER_INIT[name](gen, cfg, steps)
                   for name in period_layout(cfg)],
        "final_norm": torch.ones((cfg.d_model,), dtype=BF16, device=dev),
    }
    if not cfg.tied_embeddings:
        params["lm_head"] = _dense_init(gen, (cfg.d_model, cfg.vocab),
                                        scale=0.02)
    return params


# ---------------------------------------------------------------------------
# sublayers
# ---------------------------------------------------------------------------
def attention(p, cfg: ModelConfig, x, cos, sin, impl="kernel"):
    """Causal self-attention over the whole sequence (the reference's
    ``attention`` without a cache) with GQA, RoPE (``cos``/``sin`` from
    :func:`rope_angles`), qk-norm and the config's sliding window.
    Returns ``(out, k, v)``: the keys after RoPE and the values, the
    cache a prefill leaves."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = DT.query_heads(DT.matmul(x, p["wq"]), B, S, H, D, causal=True)
    k = DT.heads(DT.matmul(x, p["wk"]), B, S, Hkv, D)
    v = DT.heads(DT.matmul(x, p["wv"]), B, S, Hkv, D)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rope_apply(q, *DT.in_row_order(q, cos, sin))
    k = rope_apply(k, cos, sin)
    window = {"window": cfg.sliding_window} if cfg.sliding_window else {}
    o = flash_mha(q, k, v, causal=True, impl=impl, **window)
    return DT.matmul(DT.query_heads(o, B, S, H * D, causal=True),
                     p["wo"]), k, v


def moe(p, cfg: ModelConfig, x2d):
    """Sort-based capacity-dispatch MoE (the reference's ``moe``): ``x2d``
    ``(T, d)`` -> ``((T, d), aux)``.  Each token's top-``K`` experts by
    the f32 router softmax (ties to the lower index, as ``lax.top_k``),
    gates renormalised over the ``K``; the ``T * K`` assignments sorted by
    expert (stable, as ``jnp.argsort``), each expert taking at most ``C =
    int(capacity_factor * T * K / E) + 1`` in that order.  A dropped
    assignment adds zeros into its expert's slot ``C - 1`` and gets no
    output.  Every expert runs on its ``C`` slots; a token's ``K``
    contributions are summed in bf16 in the sorted order.  ``aux`` is the
    Switch balance loss ``E * sum(mean(probs) * share of assignments)``.
    On DTensor rows each device routes its own rows and only rows move,
    with the same routing (:func:`moe_dispatch`)."""
    return moe_dispatch(p, cfg, x2d, *route(p, cfg, x2d))


def route(p, cfg: ModelConfig, x2d):
    """The router of :func:`moe`: its f32 probabilities ``(T, E)`` and each
    token's top-``K`` experts ``(T, K)``, the highest first (on DTensor
    rows each device routes its own: :func:`DT.by_rows`)."""
    def top(logits):
        probs = torch.softmax(logits, dim=-1)
        idx = torch.argsort(probs, dim=-1, descending=True,
                            stable=True)[:, :cfg.top_k]
        return probs, idx
    return DT.routed(top, 2, x2d, p["router"])


def dispatch_plan(idx, E, C):
    """The capacity dispatch of each token's experts ``idx`` ``(T, K)``
    over ``E`` experts of ``C`` slots: the ``T * K`` assignments sorted by
    expert (stable: ``order``), each one's token (``tok_s``), whether it
    got a slot (``keep``) and its row ``e * C + slot`` of the experts'
    buffer (``row``; a dropped one its expert's slot ``C - 1``)."""
    T, K = idx.shape
    dev = idx.device
    e_flat = idx.reshape(-1)                                  # (T*K,)
    tok_flat = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(e_flat, stable=True)
    e_s, tok_s = e_flat[order], tok_flat[order]
    start = torch.searchsorted(e_s, torch.arange(E, device=dev))
    pos = torch.arange(T * K, device=dev) - start[e_s]
    keep = pos < C
    row = e_s * C + torch.where(keep, pos, C - 1)
    return order, tok_s, keep, row


def _gates_by_id(probs, idx):
    """Each token's gates (its top-``K`` probabilities renormalised) and
    its ``K`` assignments ordered by expert id ``(T, K)``: the order its
    contributions are summed in."""
    gate_vals = probs.gather(1, idx)
    rank = (idx[:, None, :] < idx[:, :, None]).sum(-1)        # (T, K)
    return (gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9),
            rank.argsort(dim=1))


def _experts(p, buf):
    """Every expert's SwiGLU on its slots ``buf`` ``(E, C, d)`` (on
    DTensors whose width is sharded, the products' partial sums reduced
    first)."""
    h = DT.summed(torch.bmm(buf, p["w_gate"]))
    h2 = DT.summed(torch.bmm(buf, p["w_in"]))
    return torch.bmm(silu(h) * h2, p["w_out"])


def moe_dispatch(p, cfg: ModelConfig, x2d, probs, idx):
    """:func:`moe` from the router's ``probs`` and each token's experts
    ``idx`` on: the gates, the balance loss, the capacity dispatch and the
    experts.  Every device computes the one plan of the whole batch from
    the expert ids ``(T, K)`` (on DTensors gathered: integers only); the
    token rows go into the experts' slots (:func:`DT.send_rows`) and the
    outputs come back to their rows (:func:`DT.take_rows`), on DTensor
    rows each device's own rows to and from the devices that hold their
    experts' slots."""
    T, d = x2d.shape
    E, K = cfg.n_experts, cfg.top_k
    C = int(cfg.capacity_factor * T * K / E) + 1
    gates, by_id = DT.by_rows(_gates_by_id, 2, (probs, idx))
    idx = DT.local_value(idx)                         # (T, K), every device
    # each expert's share of the assignments (bincount has no meta kernel)
    ce = torch.zeros(E, device=idx.device).index_add_(
        0, idx.reshape(-1), torch.ones(T * K, device=idx.device)) / (T * K)
    aux = E * (DT.column_means(probs) * DT.as_replicated(ce, probs)).sum()
    sort, _, keep, row = dispatch_plan(idx, E, C)
    # each assignment's expert, slot and keep, in (token, k) order
    row = torch.empty_like(row).index_copy(0, sort, row).view(T, K)
    keep = torch.empty_like(keep).index_copy(0, sort, keep).view(T, K)
    expert, slot = row // C, row % C
    buf = DT.send_rows(x2d, expert, slot, keep, sort, p["w_gate"], C)
    out = DT.by_expert(_experts(p, buf), p["w_gate"])
    return DT.take_rows(out, expert, slot, keep, sort, gates, by_id), aux


def _linear_scan(a, b):
    """Inclusive scan over axis 1 of ``h_t = a_t * h_{t-1} + b_t`` from
    ``h_{-1} = 0``: the cumulative products of ``a`` and the states, by the
    reference's combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)`` in
    ``ceil(log2(c))`` vectorised steps (``lax.associative_scan`` combines
    in another order, so the f32 results differ in rounding)."""
    n, s = a.shape[1], 1
    while s < n:
        a, b = (torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], 1),
                torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], 1))
        s *= 2
    return a, b


def _scan_chunk(decay, drive, C, h):
    """One chunk of the selective scan from state ``h`` ``(B, di, N)``:
    the outputs ``(B, c, di)`` against ``C`` ``(B, c, N)`` and the state
    after the chunk."""
    cdec, cdrv = _linear_scan(decay, drive)
    h_all = cdec * h[:, None] + cdrv                          # (B,c,di,N)
    return torch.einsum("bcdn,bcn->bcd", h_all, C), h_all[:, -1]


def mamba(p, cfg: ModelConfig, x, state=None):
    """The reference's chunked selective scan.  ``x`` ``(B, S, d)``;
    ``state`` ``(h (B, di, N) f32, conv (B, W - 1, di))`` for decode.
    Returns ``(out, (h, conv))``."""
    B, S, d = x.shape
    di, N, W = cfg.d_inner, cfg.ssm_state, cfg.conv_width
    xi, z = DT.halves(DT.matmul(x, p["w_in"]))
    # causal depthwise conv1d: a Python sum of W bf16 products, in order
    pad = xi.new_zeros((B, W - 1, di)) if state is None else state[1]
    xc = torch.cat([pad, xi], dim=1)
    new_conv = xc[:, -(W - 1):, :]
    kern = p["conv_w"]
    xi = sum(xc[:, w:w + S, :] * kern[w] for w in range(W))
    xi = silu(xi)
    # (B, S, di), on DTensors its channels sharded as xi's (DTensor 2.11
    # adds the sharded bias to the reduced product by gathering the bias)
    dt = softplus(DT.laid_out_as(DT.summed(xi @ p["w_dt"]), xi) +
                  p["dt_bias"])
    Bm = DT.matmul(xi, p["w_B"])                              # (B,S,N)
    Cm = DT.matmul(xi, p["w_C"])
    A = -torch.exp(p["A_log"].float())                        # (di,N)
    decay = torch.exp(dt.float()[..., None] * A)              # (B,S,di,N)
    drive = (dt.float() * xi.float())[..., None] * \
        Bm.float()[:, :, None, :]

    nchunk = max(S // SSM_CHUNK, 1)
    c = S // nchunk
    decay_c = decay.reshape(B, nchunk, c, di, N)
    drive_c = drive.reshape(B, nchunk, c, di, N)
    C_c = Cm.float().reshape(B, nchunk, c, N)
    h = x.new_zeros((B, di, N), dtype=F32) if state is None else \
        state[0].float()
    ys = []
    for j in range(nchunk):
        args = (decay_c[:, j], drive_c[:, j], C_c[:, j], h)
        # under autograd each chunk's scan is recomputed in the backward:
        # its log-step intermediates are ~18 (B, c, di, N) f32 tensors a
        # chunk, which for every chunk of seven Mamba layers would not fit
        y_j, h = (checkpoint(DT.local_scan, _scan_chunk, *args,
                             use_reentrant=False)
                  if torch.is_grad_enabled() else
                  DT.local_scan(_scan_chunk, *args))
        ys.append(y_j)
    y = torch.cat(ys, dim=1).to(x.dtype)
    y = y + xi * p["d_skip"]
    out = DT.matmul(y * silu(z), p["w_out"])
    return out, (h, new_conv)


def _mlstm_chunk(qj, kj, vj, fj, ij, C, mask):
    """One chunk of :func:`mlstm` from state ``C`` ``(B, H, D, D)``: the
    outputs ``(B, c, H, D)`` and the state after the chunk."""
    logf = torch.log(fj.clamp(min=1e-9))                      # (B,c,H)
    cum = torch.cumsum(logf, dim=1)
    total = cum[:, -1:]
    # intra-chunk causal gated attention; pairwise log-decay
    cum_h = cum.transpose(1, 2)                               # (B,H,c)
    dec = torch.exp((cum_h[:, :, :, None] - cum_h[:, :, None, :])
                    .clamp(max=0.0))
    w = dec * ij.transpose(1, 2)[:, :, None, :]
    s = torch.einsum("bqhd,bkhd->bhqk", qj, kj) * w
    s = torch.where(mask, s, 0.0)
    intra = torch.einsum("bhqk,bkhd->bqhd", s, vj)
    # inter-chunk: q_t * decay(0..t) @ C
    inter = torch.einsum("bqhd,bhde->bqhe",
                         qj * torch.exp(cum)[..., None], C)
    C = _mlstm_carry(kj, vj, ij, cum, total, C)
    return intra + inter, C


def _mlstm_carry(kj, vj, ij, cum, total, C):
    """The state ``C`` carried across a chunk of :func:`_mlstm_chunk`
    (``cum``, ``total``: the cumulative and whole log forget gates over
    the chunk)."""
    wk = ij * torch.exp(total - cum)                          # decay t..end
    return C * torch.exp(total)[:, 0, :, None, None] + \
        torch.einsum("bkhd,bkhe->bhde", kj * wk[..., None], vj)


def _mlstm_state(kj, vj, fj, ij, C):
    """The state after a chunk of :func:`_mlstm_chunk` without its
    outputs, and the chunk's whole log forget gate ``(B, H)``."""
    cum = torch.cumsum(torch.log(fj.clamp(min=1e-9)), dim=1)
    total = cum[:, -1:]
    return _mlstm_carry(kj, vj, ij, cum, total, C), total[:, 0]


def mlstm(p, cfg: ModelConfig, x, state=None):
    """The reference's chunked gated linear attention.  ``state`` ``C``
    ``(B, H, D, D)`` f32 for decode; returns ``(out, C)``.  On DTensors
    each chunk runs shard by shard (:func:`DT.local_chunk`), or where the
    heads do not divide the ranks that shard their columns, each device
    its own run of chunks (:func:`DT.local_chunks`)."""
    B, S, d = x.shape
    H = cfg.n_heads
    D = d // H
    nchunk = max(S // SSM_CHUNK, 1)
    c = S // nchunk
    q = DT.query_heads(DT.matmul(x, p["wq"]), B, S, H, D, unit=c)
    k = DT.query_heads(DT.matmul(x, p["wk"]), B, S, H, D,
                       unit=c) / math.sqrt(D)
    v = DT.query_heads(DT.matmul(x, p["wv"]), B, S, H, D, unit=c)
    f = torch.sigmoid(DT.matmul(x, p["wf"]).reshape(B, S, H).float())
    i = torch.exp(-softplus(-DT.matmul(x, p["wi"]).reshape(B, S, H)
                            .float()))

    def start():        # the intra-chunk causal mask and the state
        mask = torch.ones((c, c), dtype=torch.bool,
                          device=DT.local_device(x)).tril()
        return mask, (x.new_zeros((B, H, D, D), dtype=F32)
                      if state is None else state.float())
    if DT.rows_split(q):
        # each device's runs of chunks (DT.query_heads split the rows)
        y, C = DT.local_chunks(_mlstm_chunk, _mlstm_state, q, k, v, f, i,
                               *reversed(start()))
        y = y.reshape(B, S, H * D).to(x.dtype)
    else:
        qc, kc, vc = (t.float().reshape(B, nchunk, c, H, D)
                      for t in (q, k, v))
        fc, ic = f.reshape(B, nchunk, c, H), i.reshape(B, nchunk, c, H)
        mask, C = start()
        ys = []
        for j in range(nchunk):
            y_j, C = DT.local_chunk(_mlstm_chunk, qc[:, j], kc[:, j],
                                    vc[:, j], fc[:, j], ic[:, j], C, mask)
            ys.append(y_j)
        y = DT.heads(torch.cat(ys, dim=1), B, S, H * D).to(x.dtype)
    y = rmsnorm(y, p["out_norm"], cfg.norm_eps)
    return DT.matmul(DT.columns(y), p["wo"]), C


#: the time loop of :func:`slstm`: ``TIME_LOOP(trip, (h, c), S)`` returns
#: ``(hs (B, S, d), (h, c))``.  None runs every trip; the dry run sets its
#: own, which runs a representative two and counts them for all ``S``
#: (:func:`repro_torch.launch.dryrun.count_time_loop`)
TIME_LOOP = None


def slstm(p, cfg: ModelConfig, x, state=None):
    """Scalar-memory LSTM with recurrent mixing, one step at a time.
    ``state`` ``(h, c)`` ``(B, d)`` f32 for decode; returns ``(out, (h,
    c))``.  ``h @ r`` is an f32 product (TF32 stays off, PyTorch's
    default)."""
    B, S, d = x.shape
    zi = DT.matmul(x, p["w_z"]).float()
    fi = DT.matmul(x, p["w_f"]).float()
    ii = DT.matmul(x, p["w_i"]).float()
    oi = DT.matmul(x, p["w_o"]).float()
    if state is None:
        h = x.new_zeros((B, d), dtype=F32)
        c = x.new_zeros((B, d), dtype=F32)
    else:
        h, c = state

    def trip(t, h, c):
        rec = h @ p["r"]
        f = torch.sigmoid(fi[:, t] + rec)
        i = torch.sigmoid(ii[:, t] + rec)
        z = torch.tanh(zi[:, t] + rec)
        o = torch.sigmoid(oi[:, t] + rec)
        c = f * c + i * z
        return o * torch.tanh(c), c
    if TIME_LOOP is None:
        hs = []
        for t in range(S):
            h, c = trip(t, h, c)
            hs.append(h)
        y = torch.stack(hs, dim=1)
    else:
        y, (h, c) = TIME_LOOP(trip, (h, c), S)
    return DT.matmul(y.to(x.dtype), p["w_out"]), (h, c)


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------
def _apply_sublayer(name, p, cfg, x, cos, sin, impl):
    """``(x + f(rmsnorm(x)), aux, cache)`` — the reference's
    ``_apply_sublayer``; ``cache`` is ``None`` for ``mlp`` and ``moe``.
    On DTensors the sublayer's input and output are laid out as
    Megatron's tensor parallelism lays them (:func:`DT.tp_in`,
    :func:`DT.summed`), in the backward too."""
    h = DT.tp_in(rmsnorm(x, p["norm"], cfg.norm_eps))
    aux, cache = None, None
    if name == "attn":
        o, k, v = attention(p, cfg, h, cos, sin, impl)
        cache = (k, v)
    elif name == "mlp":
        o = swiglu(p, h)
    elif name == "moe":
        B, S, d = h.shape
        o, aux = moe(p, cfg, h.reshape(B * S, d))
        o = o.reshape(B, S, d)
    elif name == "mamba":
        o, cache = mamba(p, cfg, h)
    elif name == "mlstm":
        o, cache = mlstm(p, cfg, h)
    elif name == "slstm":
        o, cache = slstm(p, cfg, h)
    else:
        raise ValueError(name)
    return x + DT.summed(o), aux, cache


def _step(cfg, layout, layer, x, cos, sin, impl):
    """One scan step: every sublayer of the layout in order.  Returns
    ``(x, aux, caches)``, ``aux`` the sum of the step's MoE balance
    losses (f32), ``caches`` those of its cache-bearing sublayers.  A
    residual stream pinned with its sequence sharded (``act_spec``) is
    gathered over the sequence first: DTensor does not flatten a sharded
    sequence into the matmuls' rows, so the step computes on batch-sharded
    activations and only the carry between steps is sequence-sharded."""
    x = DT.whole_seq(x)
    aux = x.new_zeros((), dtype=F32)
    caches = []
    for name, p in zip(layout, DT.for_use(layer)):
        x, a, c = _apply_sublayer(name, p, cfg, x, cos, sin, impl)
        if a is not None:
            aux = aux + a
        if c is not None:
            caches.append(c)
    return x, aux, tuple(caches)


def _unstack(blocks):
    """Per-step views of the stacked block parameters.  ``unbind`` (not
    one index per step) so that the backward writes each stacked
    gradient once, not once per step."""
    per = [{n: DT.unbind(t) for n, t in sub.items()} for sub in blocks]
    steps = len(next(iter(per[0].values())))
    return [[{n: ts[i] for n, ts in sub.items()} for sub in per]
            for i in range(steps)]


def _stack_caches(per_step):
    """The caches of every step stacked over steps, as ``lax.scan``
    stacks its outputs: a tuple over the cache-bearing sublayers, each a
    tensor or a tuple of tensors with a leading steps axis."""
    def stack(items):
        if isinstance(items[0], tuple):
            return tuple(stack(list(z)) for z in zip(*items))
        return torch.stack(items)
    return tuple(stack(list(z)) for z in zip(*per_step))


def forward(cfg: ModelConfig, params, tokens, prefix_embeds=None,
            collect_cache=False, impl="kernel", act_spec=None):
    """tokens ``(B, S)`` -> ``(logits (B, S, V) bf16, aux)``, or ``(logits,
    caches, aux)`` with ``collect_cache``.  ``prefix_embeds`` ``(B, P, d)``
    replaces the embeddings of the first ``P`` positions (modality stub).
    Each scan step runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``), so a backward recomputes it — and launches the
    attention kernel again; with ``collect_cache`` it does not, as the
    reference drops the checkpoint there.  ``aux`` is the sum of the MoE
    balance losses (0 without MoE).  ``caches`` (see
    :func:`_stack_caches`) holds ``(k, v)`` ``(steps, B, S, Hkv, D)`` per
    attention sublayer, ``(h, conv)`` per Mamba, ``C`` per mLSTM and
    ``(h, c)`` per sLSTM.  ``impl`` picks the attention implementation,
    as in :func:`decode_step`.  ``act_spec`` (a sharding spec) is pinned
    onto the residual stream after the embedding and after every scan step
    when it is a DTensor (Megatron-style sequence sharding, the
    reference's ``act_spec``)."""
    layout = period_layout(cfg)
    x = DT.embed(params["embed"], tokens).to(BF16)
    if prefix_embeds is not None:
        P = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(BF16), x[:, P:]], dim=1)
    x = DT.pin(x, act_spec)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=I32, device=x.device).expand(B, S)
    # on DTensors each device computes the angles of its own batch rows
    cos, sin = DT.rows_of(
        lambda pos: rope_angles(pos, cfg.d_head, cfg.rope_theta), 2,
        positions, x)
    aux = x.new_zeros((), dtype=F32)
    per_step = []
    for layer in _unstack(params["blocks"]):
        if collect_cache:
            x, a, caches = _step(cfg, layout, layer, x, cos, sin, impl)
            per_step.append(caches)
        else:
            x, a, _ = checkpoint(_step, cfg, layout, layer, x, cos, sin,
                                 impl, use_reentrant=False)
        x = DT.pin(x, act_spec)
        aux = aux + a
    x = rmsnorm(DT.whole_seq(x), params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = DT.head_logits(x, head)
    if collect_cache:
        return logits, _stack_caches(per_step), aux
    return logits, aux


def loss_fn(cfg: ModelConfig, params, batch, impl="kernel", act_spec=None):
    """Mean next-token NLL over the labels ``>= 0`` (f32 log-softmax of the
    bf16 logits), plus ``0.01 * aux``."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          batch.get("prefix_embeds"), impl=impl,
                          act_spec=act_spec)
    logits = logits.float()
    labels = batch["labels"].long()
    logz, gold = DT.logz_and_gold(logits, labels)
    mask = (labels >= 0).to(F32)
    nll = ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)
    return nll + 0.01 * aux


# ---------------------------------------------------------------------------
# Paged KV cache + decode
# ---------------------------------------------------------------------------
def pages_per_seq(cfg: ModelConfig, max_seq: int) -> int:
    """Block-table width: ``max_seq`` tokens, or under a sliding window
    the reference's ring of ``min(max_seq, window + PAGE_SIZE)``."""
    window = cfg.sliding_window or 0
    eff_seq = min(max_seq, window + PAGE_SIZE) if window else max_seq
    return (eff_seq + PAGE_SIZE - 1) // PAGE_SIZE


def make_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      n_pages: int | None = None, device="cuda"):
    """Decode-time state: ``seq_lens`` ``(B,)`` int32, ``block_tables``
    ``(B, pages_per_seq)`` int32; for a layout with attention the global
    pools ``kpool``/``vpool`` ``(steps, n_attn, n_pages, PAGE_SIZE, Hkv,
    D)`` bf16; the recurrent states ``mamba_h`` ``(steps, n_mamba, B, di,
    N)`` f32 and ``mamba_conv`` ``(steps, n_mamba, B, W - 1, di)`` bf16,
    ``mlstm_C`` ``(steps, n_mlstm, B, H, D, D)`` f32, ``slstm_h`` and
    ``slstm_c`` ``(steps, n_slstm, B, d)`` f32 — all zeroed.  By default
    the pool has ``batch * pages_per_seq`` pages and row ``b`` owns pages
    ``b * pages_per_seq ...`` — the reference's identity tables over its
    per-row pool; the serving engine passes its own ``n_pages`` and sends
    the tables every step."""
    dev = resolve_device(device)
    steps = n_scan_steps(cfg)
    n = {name: period_layout(cfg).count(name) for name in _STATEFUL}
    P = pages_per_seq(cfg, max_seq)
    state = {
        "seq_lens": torch.zeros((batch,), dtype=I32, device=dev),
        "block_tables": torch.arange(batch * P, dtype=I32, device=dev)
        .reshape(batch, P),
    }
    if n["attn"]:
        n_pages = batch * P if n_pages is None else n_pages
        state["kpool"] = torch.zeros(
            (steps, n["attn"], n_pages, PAGE_SIZE, cfg.n_kv_heads,
             cfg.d_head), dtype=BF16, device=dev)
        state["vpool"] = torch.zeros_like(state["kpool"])
    if n["mamba"]:
        state["mamba_h"] = torch.zeros(
            (steps, n["mamba"], batch, cfg.d_inner, cfg.ssm_state),
            dtype=F32, device=dev)
        state["mamba_conv"] = torch.zeros(
            (steps, n["mamba"], batch, cfg.conv_width - 1, cfg.d_inner),
            dtype=BF16, device=dev)
    if n["mlstm"]:
        D = cfg.d_model // cfg.n_heads
        state["mlstm_C"] = torch.zeros(
            (steps, n["mlstm"], batch, cfg.n_heads, D, D), dtype=F32,
            device=dev)
    if n["slstm"]:
        state["slstm_h"] = torch.zeros(
            (steps, n["slstm"], batch, cfg.d_model), dtype=F32, device=dev)
        state["slstm_c"] = torch.zeros_like(state["slstm_h"])
    return state


def decode_step(cfg: ModelConfig, params, state, tokens, impl="kernel"):
    """One decode step.  ``tokens`` ``(B,)`` int64.  Each attention
    sublayer writes its row's new K/V into the ring or linear slot of its
    page and attends over the row's pages through the block table; the
    recurrent sublayers advance their states; ``seq_lens`` advances — all
    in place on ``state`` — and returns ``(logits (B, vocab), state)``.
    The MoE sublayers dispatch the ``B`` rows as ``B`` tokens, so rows
    compete for expert capacity, idle rows included, as in the reference.
    ``impl`` picks the attention implementation (``"kernel"``: the CUDA
    kernel for CUDA tensors; ``"ref"``: the plain version)."""
    layout = period_layout(cfg)
    B = tokens.shape[0]
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    window = cfg.sliding_window or 0
    x = DT.embed(params["embed"], tokens)[:, None, :]           # (B,1,d)
    seq_lens = state["seq_lens"]
    if "attn" in layout:
        bt = state["block_tables"]                            # (B,P)
        n_pages = bt.shape[1]
        kv_len = n_pages * PAGE_SIZE
        if window:
            # the ring: slot seq_len mod kv_len; the kernel attends by
            # ring distance from the new token, so lens is not clamped
            slot = (seq_lens % kv_len).long()
            lens = seq_lens + 1
        else:
            # linear growth, clamped at the last slot as in the reference;
            # the new token is written before attention: it sees slots <=
            # its position (the reference's mask kv_pos <= q_pos)
            slot = seq_lens.clamp(max=kv_len - 1).long()
            lens = (seq_lens + 1).clamp(max=kv_len)
        page_of_slot = bt.gather(
            1, ((slot // PAGE_SIZE) % n_pages)[:, None])[:, 0].long()
        off = slot % PAGE_SIZE
        cos, sin = rope_angles(seq_lens[:, None], D, cfg.rope_theta)
    # per-step views of the weights and of the state, [step][sublayer]:
    # on DTensors shard by shard (an index per step would be a new
    # operator signature a step, whose sharding DTensor derives on
    # global-shaped tensors)
    steps = _unstack(params["blocks"])
    at = {n: [DT.unbind(s) for s in DT.unbind(t)]
          for n, t in state.items() if n not in ("seq_lens", "block_tables")}
    for i, layer in enumerate(steps):
        j = dict.fromkeys(_STATEFUL, 0)
        step = DT.for_use(layer, rows=x)
        for name, p in zip(layout, step):
            h = rmsnorm(x, p["norm"], cfg.norm_eps)
            if name == "attn":
                a = j["attn"]
                q = DT.heads(DT.matmul(h, p["wq"]), B, 1, H, D)
                k = DT.heads(DT.matmul(h, p["wk"]), B, 1, Hkv, D)
                v = DT.heads(DT.matmul(h, p["wv"]), B, 1, Hkv, D)
                if cfg.qk_norm:
                    q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
                    k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
                q = rope_apply(q, cos, sin)
                k = rope_apply(k, cos, sin)
                kp, vp = at["kpool"][i][a], at["vpool"][i][a]
                DT.write_rows(kp, page_of_slot, off, k[:, 0])
                DT.write_rows(vp, page_of_slot, off, v[:, 0])
                o = paged_decode(q[:, 0], kp, vp, bt, lens, impl=impl,
                                 window=window)               # (B,H,D)
                o = DT.matmul(DT.heads(o, B, 1, H * D), p["wo"])
            elif name == "mlp":
                o = swiglu(p, h)
            elif name == "moe":
                o, _ = moe(p, cfg, h.reshape(B, -1))
                o = o.reshape(B, 1, -1)
            elif name == "mamba":
                a = j["mamba"]
                m_h, m_conv = at["mamba_h"][i][a], at["mamba_conv"][i][a]
                o, (h_new, conv_new) = mamba(p, cfg, h, state=(m_h, m_conv))
                m_h.copy_(h_new)
                m_conv.copy_(conv_new)
            elif name == "mlstm":
                a = j["mlstm"]
                C = at["mlstm_C"][i][a]
                o, C_new = mlstm(p, cfg, h, state=C)
                C.copy_(C_new)
            elif name == "slstm":
                a = j["slstm"]
                s_h, s_c = at["slstm_h"][i][a], at["slstm_c"][i][a]
                o, (h_new, c_new) = slstm(p, cfg, h, state=(s_h, s_c))
                s_h.copy_(h_new)
                s_c.copy_(c_new)
            else:
                raise ValueError(name)
            if name in j:
                j[name] += 1
            x = x + DT.summed(o)
    seq_lens += 1
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return DT.matmul(x, head)[:, 0], state

"""Model substrate of the port: the dense decoder, for training and
serving.

The counterpart of :mod:`repro.models.core`: the primitives
(:func:`rmsnorm`, :func:`rope`, :func:`swiglu`), the parameter layout and
seeded initialisation (:func:`init_params`, plain dictionaries of tensors
stacked over layers, as the reference's pytrees), the training / prefill
:func:`forward` and :func:`loss_fn`, the paged KV cache
(:func:`make_decode_state`) and one decode step (:func:`decode_step`).
PyTorch runs eagerly, so the reference's layer ``lax.scan`` is a Python
loop, ``jax.checkpoint`` around a layer is
``torch.utils.checkpoint.checkpoint`` and the decode state is updated in
place.

The KV cache is one **global** page pool per K and V, ``(steps, n_attn,
NP, page, Hkv, D)``, addressed by the block table — the contract of the
paged-attention and page-op kernels.  The reference keeps a per-row pool
``(steps, n_attn, B, pages_per_seq, ...)`` and indexes it with the
serving engine's global page ids, which is only well defined while every
id is below ``pages_per_seq``; where it is, the global pool gives the
same numbers (flatten the rows to ``B * pages_per_seq`` pages and offset
row ``b``'s table by ``b * pages_per_seq``, as
:func:`repro_torch.models.convert.decode_state_from_jax` does).

Attention goes through the ported kernels: :func:`forward` through
:func:`repro_torch.kernels.flash_attention.ops.flash_mha` (the reference
calls its own ``_online_attn``, the same function: ``q`` scaled in f32
first, the causal mask by index, an f32 softmax), decode through
:func:`repro_torch.kernels.paged_attention.ops.paged_decode`.  The matrix
products stay ``torch.matmul``, as the reference leaves them to XLA.  Only
the dense layout (``["attn", "mlp"]``, full attention) is ported: MoE,
Mamba and xLSTM sublayers and sliding windows raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention.ops import flash_mha
from ..kernels.paged_attention.ops import paged_decode
from .config import ModelConfig

F32 = torch.float32
BF16 = torch.bfloat16
I32 = torch.int32

PAGE_SIZE = 64          # tokens per KV page

_NOT_PORTED = ("ROADMAP Queue A 9b: only the dense decoder is ported; {} "
               "is not")


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


def rope_apply(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta):
    """x (..., S, H, D); positions (..., S)."""
    return rope_apply(x, *rope_angles(positions, x.shape[-1], theta))


def silu(x):
    """``x * sigmoid(x)`` with ``sigmoid(x) = 1 / (1 + exp(-x))`` rounded
    to ``x``'s dtype after every operation, as the reference's
    ``jax.nn.silu`` is in bfloat16 (``F.silu`` rounds once, which differs
    in the last bfloat16 bit for about a tenth of the inputs)."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(p, x):
    return (silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]


# ---------------------------------------------------------------------------
# parameters (stacked over layers, as the reference's scan carries them)
# ---------------------------------------------------------------------------
def _dense_init(gen, shape, scale=None, steps=None):
    """bf16 ``N(0, scale^2)``, ``scale = 1/sqrt(fan_in)`` by default; with
    ``steps``, ``steps`` such tensors stacked, drawn one at a time so the
    f32 draw never holds more than one layer."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale or (1.0 / math.sqrt(fan_in))
    dev = gen.device

    def draw():
        return (torch.randn(shape, generator=gen, dtype=F32, device=dev)
                * scale).to(BF16)
    if steps is None:
        return draw()
    out = torch.empty((steps, *shape), dtype=BF16, device=dev)
    for i in range(steps):
        out[i] = draw()
    return out


def _attn_params(gen, cfg: ModelConfig, steps):
    d, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dev = gen.device
    p = {
        "wq": _dense_init(gen, (d, H * D), steps=steps),
        "wk": _dense_init(gen, (d, Hkv * D), steps=steps),
        "wv": _dense_init(gen, (d, Hkv * D), steps=steps),
        "wo": _dense_init(gen, (H * D, d), steps=steps),
        "norm": torch.ones((steps, d), dtype=BF16, device=dev),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((steps, D), dtype=BF16, device=dev)
        p["k_norm"] = torch.ones((steps, D), dtype=BF16, device=dev)
    return p


def _mlp_params(gen, cfg: ModelConfig, steps):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": _dense_init(gen, (d, ff), steps=steps),
        "w_in": _dense_init(gen, (d, ff), steps=steps),
        "w_out": _dense_init(gen, (ff, d), steps=steps),
        "norm": torch.ones((steps, d), dtype=BF16, device=gen.device),
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


def _check_dense(cfg: ModelConfig):
    layout = period_layout(cfg)
    if layout != ["attn", "mlp"]:
        raise NotImplementedError(_NOT_PORTED.format(
            f"{cfg.name}'s {cfg.arch_type} layout {layout}"))
    if cfg.sliding_window:
        raise NotImplementedError(_NOT_PORTED.format(
            f"{cfg.name}'s sliding-window attention"))


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Seeded random parameters in the reference's layout (``embed``,
    ``blocks`` = one dict per sublayer of the layout with every leaf
    stacked over layers, ``final_norm``, ``lm_head`` unless tied), bf16,
    on ``device``.  A ``torch.Generator`` on that device draws them, so
    the numbers differ from the reference's ``jax.random`` ones; tests
    carry the reference's parameters over with
    :func:`repro_torch.models.convert.params_from_jax`."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    steps = n_scan_steps(cfg)
    params = {
        "embed": _dense_init(gen, (cfg.vocab, cfg.d_model), scale=0.02),
        "blocks": [_attn_params(gen, cfg, steps),
                   _mlp_params(gen, cfg, steps)],
        "final_norm": torch.ones((cfg.d_model,), dtype=BF16, device=dev),
    }
    if not cfg.tied_embeddings:
        params["lm_head"] = _dense_init(gen, (cfg.d_model, cfg.vocab),
                                        scale=0.02)
    return params


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------
def attention(p, cfg: ModelConfig, x, cos, sin, impl="kernel"):
    """Causal self-attention over the whole sequence (the reference's
    ``attention`` without a cache) with GQA, RoPE (``cos``/``sin`` from
    :func:`rope_angles`) and qk-norm."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, H, D)
    k = (x @ p["wk"]).reshape(B, S, Hkv, D)
    v = (x @ p["wv"]).reshape(B, S, Hkv, D)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rope_apply(q, cos, sin)
    k = rope_apply(k, cos, sin)
    o = flash_mha(q, k, v, causal=True, impl=impl)
    return o.reshape(B, S, H * D) @ p["wo"]


def _layer(cfg, layer, x, cos, sin, impl):
    """One scan step of the dense layout: ``attn`` then ``mlp``, each
    ``x + f(rmsnorm(x))`` (the reference's ``_apply_sublayer``)."""
    attn, mlp = layer
    x = x + attention(attn, cfg, rmsnorm(x, attn["norm"], cfg.norm_eps),
                      cos, sin, impl)
    return x + swiglu(mlp, rmsnorm(x, mlp["norm"], cfg.norm_eps))


def _unstack(blocks):
    """Per-layer views of the stacked block parameters.  ``unbind`` (not
    one index per layer) so that the backward writes each stacked
    gradient once, not once per layer."""
    per = [{n: t.unbind(0) for n, t in sub.items()} for sub in blocks]
    steps = len(next(iter(per[0].values())))
    return [[{n: ts[i] for n, ts in sub.items()} for sub in per]
            for i in range(steps)]


def forward(cfg: ModelConfig, params, tokens, prefix_embeds=None,
            collect_cache=False, impl="kernel"):
    """tokens ``(B, S)`` -> ``(logits (B, S, V) bf16, aux)``.
    ``prefix_embeds`` ``(B, P, d)`` replaces the embeddings of the first
    ``P`` positions (modality stub).  Each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so a
    backward recomputes it — and launches the attention kernel again.
    ``aux`` (the MoE balance loss) is 0 for the dense layout.  ``impl``
    picks the attention implementation, as in :func:`decode_step`."""
    _check_dense(cfg)
    if collect_cache:
        raise NotImplementedError(_NOT_PORTED.format(
            "forward(collect_cache=True), a prefill into the KV cache"))
    x = params["embed"][tokens.long()].to(BF16)
    if prefix_embeds is not None:
        P = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(BF16), x[:, P:]], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=I32, device=x.device).expand(B, S)
    cos, sin = rope_angles(positions, cfg.d_head, cfg.rope_theta)
    for layer in _unstack(params["blocks"]):
        x = checkpoint(_layer, cfg, layer, x, cos, sin, impl,
                       use_reentrant=False)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x @ head, torch.zeros((), dtype=F32, device=x.device)


def loss_fn(cfg: ModelConfig, params, batch, impl="kernel"):
    """Mean next-token NLL over the labels ``>= 0`` (f32 log-softmax of the
    bf16 logits), plus ``0.01 * aux``."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          batch.get("prefix_embeds"), impl=impl)
    logits = logits.float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(F32)
    nll = ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)
    return nll + 0.01 * aux


# ---------------------------------------------------------------------------
# Paged KV cache + decode
# ---------------------------------------------------------------------------
def pages_per_seq(cfg: ModelConfig, max_seq: int) -> int:
    return (max_seq + PAGE_SIZE - 1) // PAGE_SIZE


def make_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      n_pages: int | None = None, device="cuda"):
    """Decode-time state: ``seq_lens`` ``(B,)`` int32, ``block_tables``
    ``(B, pages_per_seq)`` int32 and the global pools ``kpool``/``vpool``
    ``(steps, 1, n_pages, PAGE_SIZE, Hkv, D)`` bf16, zeroed.  By default
    the pool has ``batch * pages_per_seq`` pages and row ``b`` owns pages
    ``b * pages_per_seq ...`` — the reference's identity tables over its
    per-row pool; the serving engine passes its own ``n_pages`` and sends
    the tables every step."""
    _check_dense(cfg)
    dev = resolve_device(device)
    P = pages_per_seq(cfg, max_seq)
    n_pages = batch * P if n_pages is None else n_pages
    state = {
        "seq_lens": torch.zeros((batch,), dtype=I32, device=dev),
        "block_tables": torch.arange(batch * P, dtype=I32, device=dev)
        .reshape(batch, P),
        "kpool": torch.zeros((n_scan_steps(cfg), 1, n_pages, PAGE_SIZE,
                              cfg.n_kv_heads, cfg.d_head), dtype=BF16,
                             device=dev),
    }
    state["vpool"] = torch.zeros_like(state["kpool"])
    return state


def decode_step(cfg: ModelConfig, params, state, tokens, impl="kernel"):
    """One decode step.  ``tokens`` ``(B,)`` int64.  Writes each row's new
    K/V into its page and slot, attends over its pages through the block
    table, advances ``seq_lens`` — all in place on ``state`` — and
    returns ``(logits (B, vocab), state)``.  ``impl`` picks the attention
    implementation (``"kernel"``: the CUDA kernel for CUDA tensors;
    ``"ref"``: the plain version)."""
    _check_dense(cfg)
    B = tokens.shape[0]
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    x = params["embed"][tokens][:, None, :]                   # (B,1,d)
    seq_lens = state["seq_lens"]
    positions = seq_lens[:, None]                             # (B,1)
    bt = state["block_tables"]                                # (B,P)
    kv_len = bt.shape[1] * PAGE_SIZE
    # linear growth, clamped at the last slot as in the reference
    slot = seq_lens.clamp(max=kv_len - 1).long()
    page_of_slot = bt.gather(1, (slot // PAGE_SIZE)[:, None])[:, 0].long()
    off = slot % PAGE_SIZE
    # the new token is written before attention: it sees slots <= its
    # position (the reference's mask kv_pos <= q_pos, clamped at kv_len)
    lens = (seq_lens + 1).clamp(max=kv_len)
    cos, sin = rope_angles(positions, D, cfg.rope_theta)
    attn, mlp = params["blocks"]
    kpool, vpool = state["kpool"], state["vpool"]
    for i in range(n_scan_steps(cfg)):
        h = rmsnorm(x, attn["norm"][i], cfg.norm_eps)
        q = (h @ attn["wq"][i]).reshape(B, 1, H, D)
        k = (h @ attn["wk"][i]).reshape(B, 1, Hkv, D)
        v = (h @ attn["wv"][i]).reshape(B, 1, Hkv, D)
        if cfg.qk_norm:
            q = rmsnorm(q, attn["q_norm"][i], cfg.norm_eps)
            k = rmsnorm(k, attn["k_norm"][i], cfg.norm_eps)
        q = rope_apply(q, cos, sin)
        k = rope_apply(k, cos, sin)
        kp, vp = kpool[i, 0], vpool[i, 0]
        kp[page_of_slot, off] = k[:, 0]
        vp[page_of_slot, off] = v[:, 0]
        o = paged_decode(q[:, 0], kp, vp, bt, lens, impl=impl)  # (B,H,D)
        x = x + o.reshape(B, 1, H * D) @ attn["wo"][i]
        h = rmsnorm(x, mlp["norm"][i], cfg.norm_eps)
        x = x + swiglu({n: w[i] for n, w in mlp.items()}, h)
    seq_lens += 1
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return (x @ head)[:, 0], state

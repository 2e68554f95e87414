"""Sharding rules: FSDP over "data" (+"pod") composed with tensor/expert
parallelism over "model" — the port of :mod:`repro.distributed.sharding`.

The same functions and the same spec table as the reference.  A spec is
the port's own :class:`P`, one entry a tensor dim: ``None`` (replicated),
a mesh axis name, or a tuple of names (the dim split over those mesh dims,
the first name the outermost, as a ``PartitionSpec`` splits it).
:func:`make_shardings` turns a tree of specs into a tree of DTensor
placements (``Shard(dim)`` on each mesh dim that names that tensor dim,
``Replicate()`` elsewhere), and :func:`distribute` lays a tree of tensors
out on the mesh by them.

Training params: weights shard their contraction dim over "data" (FSDP)
and their parallel dim over "model" (heads / ffn columns / experts).
Serving can request TP-only specs (``fsdp=False``) so decode avoids
per-step parameter all-gathers.
"""
from __future__ import annotations

import math

from ..models.config import ModelConfig


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def dp_axis(mesh) -> tuple:
    names = mesh.mesh_dim_names
    return ("pod", "data") if "pod" in names else ("data",)


def dp_size(mesh) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in dp_axis(mesh))


def dp_for(mesh, n: int):
    """Batch axes smaller than the dp extent stay replicated."""
    return dp_axis(mesh) if n % dp_size(mesh) == 0 else None


def _sub_specs(name: str, cfg: ModelConfig, dp, fsdp: bool):
    d = dp if fsdp else None
    if name == "attn":
        s = {"wq": P(None, d, "model"), "wk": P(None, d, "model"),
             "wv": P(None, d, "model"), "wo": P(None, "model", d),
             "norm": P(None, None)}
        if cfg.qk_norm:
            s["q_norm"] = P(None, None)
            s["k_norm"] = P(None, None)
        return s
    if name == "mlp":
        return {"w_gate": P(None, d, "model"), "w_in": P(None, d, "model"),
                "w_out": P(None, "model", d), "norm": P(None, None)}
    if name == "moe":
        return {"router": P(None, d, None),
                "w_gate": P(None, "model", d, None),
                "w_in": P(None, "model", d, None),
                "w_out": P(None, "model", None, d),
                "norm": P(None, None)}
    if name == "mamba":
        return {"w_in": P(None, d, "model"),
                "conv_w": P(None, None, "model"),
                "w_dt": P(None, "model", None),
                "dt_bias": P(None, "model"),
                "w_B": P(None, "model", None), "w_C": P(None, "model", None),
                "A_log": P(None, "model", None),
                "d_skip": P(None, "model"),
                "w_out": P(None, "model", d), "norm": P(None, None)}
    if name == "mlstm":
        return {"wq": P(None, d, "model"), "wk": P(None, d, "model"),
                "wv": P(None, d, "model"), "wf": P(None, d, None),
                "wi": P(None, d, None), "wo": P(None, "model", d),
                "out_norm": P(None, None), "norm": P(None, None)}
    if name == "slstm":
        return {"w_z": P(None, d, "model"), "w_f": P(None, d, "model"),
                "w_i": P(None, d, "model"), "w_o": P(None, d, "model"),
                "r": P(None, None, None),
                "w_out": P(None, "model", d), "norm": P(None, None)}
    raise ValueError(name)


def param_specs(cfg: ModelConfig, mesh, fsdp: bool = True,
                policy: str = "fsdp_tp"):
    """policy: 'fsdp_tp' (default), 'tp_only' (== fsdp=False), or
    'dp_only' (replicate weights; no tensor parallelism)."""
    from ..models.core import period_layout
    if policy == "tp_only":
        fsdp = False
    layout = period_layout(cfg)
    if policy == "dp_only":
        def rep(spec_dict):
            return {k: P(*([None] * len(v))) for k, v in spec_dict.items()}
        dp = dp_axis(mesh)
        specs = {
            "embed": P(None, None),
            "blocks": [rep(_sub_specs(n, cfg, dp, True)) for n in layout],
            "final_norm": P(None),
        }
        if not cfg.tied_embeddings:
            specs["lm_head"] = P(None, None)
        return specs
    dp = dp_axis(mesh)
    d = dp if fsdp else None
    specs = {
        "embed": P("model", d),
        "blocks": [_sub_specs(n, cfg, dp, fsdp) for n in layout],
        "final_norm": P(None),
    }
    if not cfg.tied_embeddings:
        specs["lm_head"] = P(d, "model")
    return specs


def batch_specs(cfg: ModelConfig, mesh, with_prefix: bool = False,
                policy: str = "fsdp_tp"):
    dp = dp_axis(mesh)
    if policy == "dp_only":
        dp = tuple(dp) + ("model",)       # pure DP over every axis
    s = {"tokens": P(dp, None), "labels": P(dp, None)}
    if with_prefix:
        s["prefix_embeds"] = P(dp, None, None)
    return s


def decode_state_specs(cfg: ModelConfig, mesh, state):
    """The reference's table over the port's decode state.  The reference
    keeps a per-row pool ``(steps, n_attn, B, pages, page, Hkv, D)`` and
    shards its rows over the data axes and its pages over "model" where
    a row's pages divide by it; the port keeps one global pool ``(steps,
    n_attn, NP, page, Hkv, D)``, row ``b`` owning pages ``b * pages ...``
    (:func:`repro_torch.models.core.make_decode_state`), and shards its
    pages over the same axes, the data axes outermost: the same bytes a
    device, each row's pages on its own data shard.  A decode step writes
    and reads the pages each device holds
    (:func:`repro_torch.distributed.dtensor.write_rows`,
    :func:`~repro_torch.distributed.dtensor.local_decode`)."""
    batch = state["seq_lens"].shape[0]
    dp = dp_for(mesh, batch)
    tp = mesh.size(mesh.mesh_dim_names.index("model"))

    def mdl(n):    # shard over "model" only when divisible
        return "model" if n % tp == 0 else None

    specs = {"seq_lens": P(dp), "block_tables": P(dp, None)}
    if "kpool" in state:
        axes = tuple(dp or ()) + tuple(filter(None, [mdl(
            state["block_tables"].shape[1])]))
        specs["kpool"] = P(None, None, axes or None, None, None, None)
        specs["vpool"] = P(None, None, axes or None, None, None, None)
    if "mamba_h" in state:
        di = state["mamba_h"].shape[3]
        specs["mamba_h"] = P(None, None, dp, mdl(di), None)
        specs["mamba_conv"] = P(None, None, dp, None, mdl(di))
    if "mlstm_C" in state:
        specs["mlstm_C"] = P(None, None, dp, None, None, None)
    if "slstm_h" in state:
        specs["slstm_h"] = P(None, None, dp, None)
        specs["slstm_c"] = P(None, None, dp, None)
    return specs


def tokens_spec(mesh, n: int = 0):
    return P(dp_for(mesh, n) if n else dp_axis(mesh))


def placements(mesh, spec):
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on
    each mesh dim that names tensor dim ``dim``, ``Replicate()``
    elsewhere.  Two mesh dims on one tensor dim must come in the mesh's
    order (outermost first), as DTensor splits them."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: axes {axes} of dim {dim} are "
                             f"not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def make_shardings(mesh, spec_tree):
    """A tree of DTensor placements, shaped like ``spec_tree``."""
    return _tree_map(lambda s: placements(mesh, s), spec_tree)


def distribute(mesh, tree, spec_tree):
    """``tree``'s tensors laid out on ``mesh`` by ``spec_tree`` (same
    structure) as DTensors."""
    from torch.distributed.tensor import distribute_tensor

    def put(spec, t):
        if t.dim() != len(spec):
            raise ValueError(f"spec {spec!r} has {len(spec)} dims, the "
                             f"tensor {tuple(t.shape)}")
        return distribute_tensor(t, mesh, placements(mesh, spec))
    return _tree_map(put, spec_tree, tree)

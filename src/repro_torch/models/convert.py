"""Carry the reference's parameters, optimizer state and decode state into
the port.

The functions take trees of numpy arrays (``jax.device_get`` of the
reference's pytrees, done by the caller, so this module imports no JAX)
and return the port's layout on ``device``.  bfloat16 arrays (numpy's
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects) go through
float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, device="cuda"):
    """The reference's parameter pytree (dicts and lists of arrays, every
    block leaf stacked over layers) as the same structure of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _tensor(tree, device)


def opt_state_from_jax(state, device="cuda"):
    """The reference's AdamW state (``m``, ``v`` trees of f32 and the int32
    ``step``) as the port's: the same trees of tensors and a 0-d int32
    ``step`` tensor, so a train state carries over whole."""
    return {"m": params_from_jax(state["m"], device),
            "v": params_from_jax(state["v"], device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


#: the recurrent leaves of a decode state: the same layout in both packages
RECURRENT = ("mamba_h", "mamba_conv", "mlstm_C", "slstm_h", "slstm_c")


def decode_state_from_jax(state, device="cuda"):
    """The reference's decode state with its per-row pools ``(steps,
    n_attn, B, P, page, Hkv, D)`` as the port's global pools ``(steps,
    n_attn, B * P, page, Hkv, D)``: row ``b``'s page ``j`` becomes global
    page ``b * P + j``, so its block table is offset by ``b * P``.  Exact
    wherever the reference is well defined (every id below ``P``).  A
    state without pools (a layout with no attention) keeps its table as
    it is; the recurrent states carry over as they are, f32 as f32."""
    bt = np.asarray(state["block_tables"]).astype(np.int64)
    out = {"seq_lens": _tensor(np.asarray(state["seq_lens"], np.int32),
                               device)}
    if "kpool" in state:
        kp = np.asarray(state["kpool"])
        steps, n_attn, B, P = kp.shape[:4]
        if bt.min() < 0 or bt.max() >= P:
            raise ValueError("decode_state_from_jax: the reference reads "
                             f"page ids >= {P} from the wrong row; got ids "
                             f"in [{bt.min()}, {bt.max()}]")
        bt = bt + P * np.arange(B)[:, None]
        for name in ("kpool", "vpool"):
            a = np.asarray(state[name])
            out[name] = _tensor(a.reshape(steps, n_attn, B * P,
                                          *a.shape[4:]), device)
    out["block_tables"] = _tensor(bt.astype(np.int32), device)
    for name in RECURRENT:
        if name in state:
            out[name] = _tensor(state[name], device)
    return out

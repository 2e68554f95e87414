"""The few places where a DTensor (the dry run's tensors, laid out by
:mod:`repro_torch.distributed.sharding`) takes another route than a plain
tensor, gathered in one module.

The model, the optimizer and the attention wrappers run the same code on
DTensors as on plain tensors, but for the helpers here.  Each is the plain
operation on a plain tensor; on a DTensor it gathers a dim first where
DTensor has no rule for the layout, or runs a plain function shard by
shard (:func:`local_attention`, :func:`local_decode`).  No serve or train
path on the card sees a DTensor.
"""
from __future__ import annotations

import torch


def is_dtensor(t) -> bool:
    return hasattr(t, "device_mesh")


def replicated(t, which):
    """A DTensor ``t`` with each placement ``which(placement)`` picks made
    ``Replicate()``; anything else as it is."""
    if not is_dtensor(t) or not any(map(which, t.placements)):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(placements=[Replicate() if which(pl) else pl
                                      for pl in t.placements])


def summed(t):
    """``t`` with a DTensor's pending partial sums reduced (a sharded
    contraction's output), before an addend sharded over the same mesh
    dim: DTensor 2.11 cannot make that addend partial instead."""
    return replicated(t, lambda pl: pl.is_partial())


def _reshape_heads(t, shape):
    """``t.reshape(shape)`` where the reshape splits the last dim into
    ``(heads, d)`` or merges the last two.  A DTensor sharded on the
    heads' dim over more ranks than the heads divide into (deepseek's 56
    or musicgen's 24 heads, or 8 KV heads, over 16) is gathered on it
    first: DTensor splits or merges a sharded dim only along whole
    shards."""
    split = len(shape) > t.dim()
    dim = t.dim() - 1 if split else t.dim() - 2
    heads = shape[-2] if split else t.shape[-2]
    if any(pl.is_shard(dim) and heads % t.device_mesh.size(i)
           for i, pl in enumerate(t.placements)):
        t = replicated(t, lambda pl: pl.is_shard(dim))
    return t.reshape(shape)


class _MergeHeads(torch.autograd.Function):
    """The last two dims merged (:func:`_reshape_heads`), and the
    gradient split back the same way: the backward of a plain reshape
    would split the gradient's sharded dim itself, which DTensor refuses
    where the heads do not divide the ranks (the attention output's
    gradient comes back from ``wo`` sharded on the merged dim)."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.shape = tuple(t.shape)
        return _reshape_heads(t, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_heads(g, ctx.shape), None


def heads(t, *shape):
    """``t.reshape(*shape)``: the last dim split into ``(heads, d)``, or
    the last two merged.  On a DTensor, gathered where the heads do not
    divide the ranks: before a split, and before a merge and its
    gradient's split."""
    if not is_dtensor(t):
        return t.reshape(*shape)
    if len(shape) > t.dim() or not any(t.shape[-2] % k
                                       for k in t.device_mesh.shape):
        return _reshape_heads(t, shape)
    return _MergeHeads.apply(t, shape)


def embed(table, tokens):
    """The rows of ``table`` at ``tokens``; on DTensors through
    ``embedding``, which DTensor lays out over a sharded table (it has no
    rule for indexing one), its partial rows summed while they keep the
    shape the lookup's mask was made for."""
    if is_dtensor(table):
        return summed(torch.nn.functional.embedding(tokens.long(), table))
    return table[tokens.long()]


def pin(x, act_spec):
    """The residual stream laid out by ``act_spec`` (a
    :class:`repro_torch.distributed.sharding.P`) when it is a DTensor: the
    reference's ``with_sharding_constraint``.  A plain tensor, or no spec,
    passes through."""
    if act_spec is None or not is_dtensor(x):
        return x
    from .sharding import placements
    return x.redistribute(x.device_mesh, placements(x.device_mesh, act_spec))


def whole_seq(x):
    """A DTensor residual stream ``(B, S, d)`` with its sequence dim
    gathered; anything else as is."""
    return replicated(x, lambda pl: pl.is_shard(1))


def whole_vocab(logits):
    """DTensor logits with the vocabulary gathered whole on every device
    and no partial sums (DTensor has no vocab-parallel gather of the
    label's logit that runs on every mesh); anything else as is."""
    last = logits.dim() - 1
    return replicated(logits, lambda pl: pl.is_partial() or
                      pl.is_shard(last))


def bincount(x, n):
    """``torch.bincount(x, minlength=n)`` of a 1-d index tensor; on a
    DTensor as a one-hot sum (DTensor has no rule for ``bincount``)."""
    if is_dtensor(x):
        return torch.nn.functional.one_hot(x, n).sum(0)
    return torch.bincount(x, minlength=n)


def first_of_each(sorted_ids, n):
    """Where each of ``0 .. n-1`` first appears in the sorted 1-d
    ``sorted_ids`` (``torch.searchsorted``); on a DTensor from the counts
    (DTensor has no rule for ``searchsorted``)."""
    if is_dtensor(sorted_ids):
        counts = bincount(sorted_ids, n)
        return counts.cumsum(0) - counts
    return torch.searchsorted(
        sorted_ids, torch.arange(n, device=sorted_ids.device))


def write_rows(pool, page, off, rows):
    """``pool[page, off] = rows`` in place.  On DTensors the pool is whole
    on every device, so every device writes every row: the rows are
    gathered and each device writes its copy of the pool (DTensor has no
    rule for the indexed write)."""
    if not is_dtensor(pool):
        pool[page, off] = rows
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    whole = (Replicate(),) * pool.device_mesh.ndim

    def write(pool, page, off, rows):
        pool[page, off] = rows
    local_map(write, out_placements=None, in_placements=(whole,) * 4)(
        pool, *(t.redistribute(placements=whole) for t in (page, off, rows)))


def microbatches(v, n_micro):
    """``v`` ``(B, ...)`` as ``(n_micro, B // n_micro, ...)``: microbatch
    ``i`` the ``i``-th run of rows, as the reference's reshape.  A DTensor
    batch whose rows are sharded over more ranks than there are
    microbatches is gathered first and each microbatch's rows sharded
    again (DTensor does not split a sharded dim it would have to move):
    the reshard XLA makes of the same reshape."""
    if not is_dtensor(v):
        return v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
    from torch.distributed.tensor import Replicate, Shard
    rows = v.placements
    v = v.redistribute(placements=[Replicate()] * len(rows))
    v = v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
    return v.redistribute(placements=[Shard(1) if p.is_shard(0) else p
                                      for p in rows])


def slices(t, chunk, view=True):
    """``t`` flat in slices of ``chunk`` elements (views of it with
    ``view``, which an in-place update writes through); a DTensor whole,
    as one slice: its shards are the slices."""
    if is_dtensor(t):
        return (t,)
    return (t.view(-1) if view else t.reshape(-1)).split(chunk)


def refuse_kernel(op, t, impl):
    """A DTensor runs the plain version shard by shard only when it is
    asked for by name (``impl="ref"``) or its shards are not on a CUDA
    device; the kernel route on CUDA shards raises."""
    if impl != "ref" and t.to_local().is_cuda:
        raise NotImplementedError(
            f"{op}: the kernel takes no DTensor; on CUDA shards pass "
            f"impl='ref' to run the plain version shard by shard")


def local_attention(q, k, v, causal, window):
    """:func:`~repro_torch.kernels.flash_attention.ref.flash_mha_ref` on
    DTensors, shard by shard: attention is independent per sequence and
    head, so with the sequence whole each device computes its own batch
    rows and heads.  K and V are repeated to the query heads (the GQA
    fold) and laid out as ``q``; no sharded dim is flattened, which
    DTensor does not do for the fold's ``(B * H)``."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from ..kernels.flash_attention.ref import flash_mha_ref
    placements = tuple(q.placements)
    if any(pl.is_shard(1) or pl.is_partial() for pl in placements):
        raise ValueError(f"attention on DTensors needs the sequence whole "
                         f"and no partial sums; q is {placements}")
    G = q.shape[2] // k.shape[2]

    def as_q(x):
        whole = x.redistribute(placements=[
            Replicate() if pl.is_shard(2) else pl for pl in x.placements])
        return whole.repeat_interleave(G, dim=2).redistribute(
            placements=placements)
    run = local_map(flash_mha_ref, out_placements=(placements,),
                    in_placements=(placements,) * 3 + (None, None))
    return run(q, as_q(k), as_q(v), causal, window)


def local_decode(q, kpool, vpool, block_table, seq_lens, window):
    """:func:`~repro_torch.kernels.paged_attention.ref.paged_attention_ref`
    on DTensors, device by device: each device's query rows and heads
    against the KV heads they read (a sharded index of each query head's
    KV head picks them), over the whole pools.  The pools must be whole
    on every device: page ids are data."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    from ..kernels.paged_attention.ref import paged_attention_ref
    mesh = q.device_mesh
    H, Hkv = q.shape[1], kpool.shape[2]
    whole = (Replicate(),) * mesh.ndim
    pools = []
    for pool in (kpool, vpool):
        if tuple(pool.placements) != whole:
            pool = pool.redistribute(placements=whole)
        pools.append(pool)
    heads_pl = tuple(Shard(0) if pl.is_shard(1) else Replicate()
                     for pl in q.placements)
    kv_of = distribute_tensor(
        torch.arange(H, device=q.to_local().device) // (H // Hkv), mesh,
        heads_pl)
    rows = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                 for pl in q.placements)

    def run(q, kp, vp, bt, lens, kv):
        # this device's query heads read a run of KV heads, G a head
        g = min(H // Hkv, q.shape[1])
        sel = kv[::g]
        return paged_attention_ref(q, kp[:, :, sel], vp[:, :, sel], bt,
                                   lens, window)
    return local_map(run, out_placements=(tuple(q.placements),),
                     in_placements=(tuple(q.placements), whole, whole,
                                    rows, rows, heads_pl))(
        q, *pools, block_table.redistribute(placements=rows),
        seq_lens.redistribute(placements=rows), kv_of)

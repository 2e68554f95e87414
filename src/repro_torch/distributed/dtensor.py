"""The places where a DTensor (the dry run's tensors, laid out by
:mod:`repro_torch.distributed.sharding`) takes another route than a plain
tensor, gathered in one module.

The model, the optimizer and the attention wrappers run the same code on
DTensors as on plain tensors, but for the helpers here.  Each is the plain
operation on a plain tensor.  On a DTensor it gives the step the layout
XLA's partition of the reference gives it, so that DTensor does not pick
each operator's layout by itself: weights gathered over the data axes
for a use and again in the backward (FSDP: :func:`gathered`), a
sublayer's input rows-only and its output summed, in both passes
(Megatron: :func:`tp_in`, :func:`summed`), the embedding and the loss
over vocabulary shards, the MoE dispatch over gathered token rows and
experts' buffers pinned to the experts' shards; and it runs shard by
shard (``local_map``) what is independent per row and head, or what
DTensor lays out badly (the attention, the mLSTM and Mamba chunks, RoPE,
the optimizer's elementwise updates).  No serve or train path on the card
sees a DTensor.
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


class _Pinned(torch.autograd.Function):
    """``t`` laid out as ``placements`` in the forward, and its gradient
    laid out the same way in the backward."""

    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = placements
        return t.redistribute(placements=placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(placements=ctx.placements), None


def pinned(t, placements):
    """DTensor ``t`` laid out as ``placements``, its gradient too (DTensor
    lays a backward out by itself otherwise, and 2.11 splits the
    gradient's dims over mesh dims they do not divide); anything else as
    it is."""
    if not is_dtensor(t):
        return t
    return _Pinned.apply(t, tuple(placements))


def tp_in(h):
    """A sublayer's input ``h`` ``(B, S, d)``; on DTensors with only its
    batch rows sharded and its gradient reduced over the other mesh dims
    to the same layout: Megatron's tensor-parallel entry (identity
    forward, all-reduce backward).  Without it DTensor lays the backward
    out by itself, and gathers whole hidden widths to meet the forward's
    column shards."""
    if not is_dtensor(h):
        return h
    from torch.distributed.tensor import Replicate
    return pinned(h, (pl if pl.is_shard(0) else Replicate()
                      for pl in h.placements))


def by_expert(buf, w):
    """The experts' buffer ``buf`` ``(E * C, d)`` of an MoE sublayer whose
    expert weights are ``w`` ``(E, ...)``: on DTensors its rows sharded
    as ``w``'s experts are (a run of whole experts a device) and nothing
    else, in the backward too."""
    if not is_dtensor(buf):
        return buf
    from torch.distributed.tensor import Replicate, Shard
    return pinned(buf, (Shard(0) if pl.is_shard(0) else Replicate()
                        for pl in w.placements))


def whole(t):
    """DTensor ``t`` whole on every device, its gradient too; anything
    else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return pinned(t, (Replicate(),) * t.device_mesh.ndim)


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


#: the mesh dims a weight's FSDP shards lie on (the data axes)
_FSDP_AXES = ("pod", "data")


def _fsdp_free(t):
    """``t``'s placements with its shards over the data axes made
    ``Replicate()``; its shards over "model" kept."""
    from torch.distributed.tensor import Replicate
    names = t.device_mesh.mesh_dim_names
    return tuple(Replicate() if pl.is_shard() and names[i] in _FSDP_AXES
                 else pl for i, pl in enumerate(t.placements))


class _Gather(torch.autograd.Function):
    """A weight gathered over the data axes for one use (FSDP), its
    gradient reduce-scattered back onto the weight's own shards.  It
    saves nothing: inside a checkpointed scan step the backward's
    recompute gathers the weight again, as XLA re-gathers it."""

    @staticmethod
    def forward(ctx, w):
        ctx.placements = tuple(w.placements)
        return w.redistribute(placements=_fsdp_free(w))

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(placements=ctx.placements)


def gathered(w):
    """``w`` whole over the data axes for one use when it is a DTensor
    sharded over them (the reference's FSDP parameters: XLA gathers a
    weight where it is used and keeps the activations' batch sharded);
    anything else as it is.  Without it DTensor contracts over the
    weight's data-sharded dim and reduces activation-sized partial sums,
    or gathers the batch."""
    if not is_dtensor(w) or _fsdp_free(w) == tuple(w.placements):
        return w
    return _Gather.apply(w)


def for_use(layer):
    """Each weight of a scan step's sublayer dicts :func:`gathered`; the
    dicts of plain tensors as they are (decided once, on the first weight:
    a model's weights are all DTensors or none)."""
    if not is_dtensor(next(iter(layer[0].values()))):
        return layer
    return [{n: gathered(w) for n, w in sub.items()} for sub in layer]


def _head_logits(x, head):
    return x @ gathered(head)


def head_logits(x, head):
    """``x @ head``.  On DTensors the head is gathered over the data axes
    for the product and again in its backward, under
    ``torch.utils.checkpoint``, so that no device keeps it whole from
    the forward to the backward."""
    if not is_dtensor(head):
        return x @ head
    from torch.utils.checkpoint import checkpoint
    return checkpoint(_head_logits, x, head, use_reentrant=False)


def _vocab_ids(t, dim):
    """``arange(t.shape[dim])`` as a DTensor sharded over the mesh dims
    that shard ``t``'s dim ``dim``: each device's ids of its rows."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    return distribute_tensor(
        torch.arange(t.shape[dim], device=t.to_local().device),
        t.device_mesh, tuple(Shard(0) if pl.is_shard(dim) else Replicate()
                             for pl in t.placements))


def _local_rows(table, idx, ids):
    """This device's rows of ``table`` at the global ``idx``, zeros where
    another device holds the row (``ids``: the global ids of its rows)."""
    local = idx - ids[0]
    inside = (local >= 0) & (local < table.shape[0])
    rows = torch.nn.functional.embedding(
        local.clamp(0, table.shape[0] - 1), table)
    return rows * inside[..., None].to(rows.dtype)


def embed(table, tokens):
    """The rows of ``table`` at ``tokens``.  On DTensors vocab-parallel:
    the table gathered over the data axes (:func:`gathered`), each device
    looks up the tokens its vocabulary shard holds, and the partial rows
    are summed.  DTensor has no rule for indexing a sharded table, and
    its own ``embedding`` rule builds the whole table's gradient on every
    device."""
    if not is_dtensor(table):
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    w = gathered(table)
    tpl = tuple(w.placements)
    rows = tuple(pl if pl.is_shard(0) and not w_pl.is_shard(0)
                 else Replicate()
                 for pl, w_pl in zip(tokens.placements, tpl))
    out = tuple(Partial() if w_pl.is_shard(0) else r
                for r, w_pl in zip(rows, tpl))
    grad = tuple(Partial() if r.is_shard(0) else w_pl
                 for r, w_pl in zip(rows, tpl))
    ids = _vocab_ids(w, 0)
    return summed(local_map(
        _local_rows, out_placements=(out,),
        in_placements=(tpl, rows, tuple(ids.placements)),
        in_grad_placements=(grad, rows, tuple(ids.placements)))(
            w, tokens.long().redistribute(placements=rows), ids))


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


def _local_max(logits):
    """The max of this device's vocabulary shard of ``logits``: a shift of
    the log-sum-exp only, so it carries no gradient."""
    return logits.detach().amax(-1)


def _local_sumexp(logits, m):
    """The sum of ``exp(logits - m)`` over this device's vocabulary
    shard."""
    return torch.exp(logits - m[..., None]).sum(-1)


def _local_gold(logits, labels, ids):
    """The logit of each label in this device's vocabulary shard (``ids``:
    its global ids), 0 where another device holds it."""
    local = labels - ids[0]
    inside = (local >= 0) & (local < logits.shape[-1])
    picked = logits.gather(
        -1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    return picked * inside.to(logits.dtype)


def whole_rows(t):
    """A DTensor with its rows (dim 0) gathered and no partial sums; the
    MoE dispatch routes every assignment of the batch together (one
    stable sort, one capacity), and DTensor 2.11 mislays the experts'
    buffer built from row-sharded tokens over two data axes.  Anything
    else as it is."""
    return replicated(t, lambda pl: pl.is_shard(0) or pl.is_partial())


def laid_out_as(t, like):
    """DTensor ``t`` laid out as DTensor ``like``; anything else as is."""
    if not is_dtensor(t):
        return t
    return t.redistribute(placements=like.placements)


def logz_and_gold(logits, labels):
    """``(logsumexp(logits, -1), logits[..., label])`` of f32 ``logits``
    ``(B, S, V)`` and int64 ``labels`` ``(B, S)`` (clamped at 0).  On
    DTensors vocab-parallel (Megatron's cross entropy): each device takes
    the max, the sum of exponentials and the label's logit over its own
    shard of the vocabulary, and the shards' results are reduced (a max,
    then two sums), so no device holds the whole vocabulary.  The max is
    a shift only (its gradient cancels), so it carries none."""
    if not is_dtensor(logits):
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        return logz, gold
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    logits = summed(logits)
    last = logits.dim() - 1
    lpl = tuple(logits.placements)
    if any(pl.is_shard(d) for pl in lpl for d in range(1, last)):
        logits = replicated(logits, lambda pl: not pl.is_shard(0) and
                            not pl.is_shard(last))
        lpl = tuple(logits.placements)
    rows = tuple(pl if pl.is_shard(0) else Replicate() for pl in lpl)
    vocab = tuple(Shard(0) if pl.is_shard(last) else Replicate()
                  for pl in lpl)

    def reduced(op):
        return tuple(Partial(op) if pl.is_shard(last) else r
                     for pl, r in zip(lpl, rows))

    m = local_map(_local_max, out_placements=(reduced("max"),),
                  in_placements=(lpl,))(logits).redistribute(
                      placements=rows)
    s = local_map(_local_sumexp, out_placements=(reduced("sum"),),
                  in_placements=(lpl, rows))(logits, m)
    logz = m + torch.log(s.redistribute(placements=rows))
    ids = _vocab_ids(logits, last)
    lab = labels.clamp(min=0).redistribute(placements=rows)
    gold = local_map(_local_gold, out_placements=(reduced("sum"),),
                     in_placements=(lpl, rows, vocab))(logits, lab, ids)
    return logz, gold.redistribute(placements=rows)


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
    the reshard XLA makes of the same reshape.  A microbatch is sharded
    only over the row axes, in order, whose product divides its rows, and
    kept whole on the rest (as :func:`~repro_torch.distributed.sharding.
    dp_for` keeps a batch smaller than the data-parallel extent): DTensor
    infers a shard's global shape from even shards, where XLA pads."""
    if not is_dtensor(v):
        return v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
    from torch.distributed.tensor import Replicate, Shard
    rows = v.placements
    mesh = v.device_mesh
    v = v.redistribute(placements=[Replicate()] * len(rows))
    v = v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
    out, ways = [], 1
    for dim, p in enumerate(rows):
        if p.is_shard(0):
            even = v.shape[1] % (ways * mesh.size(dim)) == 0
            ways *= mesh.size(dim) if even else 1
            p = Shard(1) if even else Replicate()
        out.append(p)
    return v.redistribute(placements=out)


def unbind(t):
    """``t.unbind(0)``; a DTensor shard by shard, its dim 0 whole: each
    view keeps the stack's shards of its dims, and the backward stacks
    each device's gradients as they come (DTensor 2.11 stacks gradients
    sharded over two mesh dims, the pod and data axes, by gathering
    them whole)."""
    if not is_dtensor(t):
        return t.unbind(0)
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(t.placements)
    if any(p.is_shard(0) or p.is_partial() for p in pl):
        raise ValueError(f"unbind of a DTensor laid out {pl}: dim 0 must "
                         f"be whole")
    view = tuple(Shard(p.dim - 1) if p.is_shard() else p for p in pl)
    return local_map(lambda x: x.unbind(0),
                     out_placements=(view,) * t.shape[0],
                     in_placements=(pl,))(t)


def slices(t, chunk, view=True):
    """``t`` flat in slices of ``chunk`` elements (views of it with
    ``view``, which an in-place update writes through); a DTensor as its
    local shard, one slice (an in-place update of the shard writes
    through to the DTensor).  An update of several DTensors shard by
    shard needs them laid out alike (:func:`laid_out_as`) and its scalars
    local (:func:`local_value`): DTensor 2.11 multiplies a tensor sharded
    over two mesh dims by a scalar DTensor by gathering it whole."""
    if is_dtensor(t):
        return (t.to_local(),)
    return (t.view(-1) if view else t.reshape(-1)).split(chunk)


def zeros_like(t, dtype):
    """``torch.zeros_like(t, dtype=dtype)``; a DTensor's shard by shard,
    laid out as ``t`` (DTensor builds the zeros of a tensor sharded over
    two mesh dims against their order whole on ``meta`` tensors)."""
    if not is_dtensor(t):
        return torch.zeros_like(t, dtype=dtype)
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(t.placements)
    return local_map(lambda x: torch.zeros_like(x, dtype=dtype),
                     out_placements=(pl,), in_placements=(pl,))(t)


def accumulate(acc, g):
    """``acc += g.to(acc.dtype)`` in place; DTensors shard by shard, ``g``
    laid out as ``acc`` first (DTensor gathers a tensor sharded over two
    mesh dims whole for an elementwise update by another)."""
    if not is_dtensor(acc):
        acc += g.to(acc.dtype)
        return
    acc.to_local().add_(laid_out_as(g, acc).to_local().to(acc.dtype))


def divided(t, n):
    """``t / n``; a DTensor shard by shard (DTensor gathers a tensor
    sharded over two mesh dims whole to divide it by a scalar)."""
    if not is_dtensor(t):
        return t / n
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(t.placements)
    return local_map(lambda x: x / n, out_placements=(pl,),
                     in_placements=(pl,))(t)


def sum_squares(x):
    """``torch.sum(torch.square(x.to(float32)))``; a DTensor's shard by
    shard, the shards' sums partial over the mesh dims that shard it
    (DTensor 2.11 gathers a tensor sharded over two mesh dims whole to
    reduce it)."""
    if not is_dtensor(x):
        return torch.sum(torch.square(x.to(torch.float32)))
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    x = summed(x)
    out = tuple(Partial() if pl.is_shard() else Replicate()
                for pl in x.placements)
    return local_map(lambda t: torch.sum(torch.square(t.to(torch.float32))),
                     out_placements=(out,),
                     in_placements=(tuple(x.placements),))(x)


def local_value(t):
    """A DTensor's value, whole, as a plain tensor (its partial sums
    reduced); anything else as it is."""
    if not is_dtensor(t):
        return t
    return replicated(t, lambda pl: True).to_local()


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


def local_device(t):
    """The device of ``t``'s data: a DTensor's local shard's."""
    return t.to_local().device if is_dtensor(t) else t.device


def local_rope(fn, x, cos, sin):
    """``fn(x, cos, sin)``, RoPE of ``x`` ``(B, S, H, D)`` by angles
    ``(B, S, 1, D / 2)``; on a DTensor ``x`` shard by shard, the angles
    laid out as its rows (DTensor 2.11 on fake tensors multiplies a
    sharded query by its angles as whole tensors)."""
    if not is_dtensor(x):
        return fn(x, cos, sin)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    x = summed(x)
    pl = tuple(x.placements)
    if any(p.is_shard(d) for p in pl for d in (1, x.dim() - 1)):
        raise ValueError(f"rope of a DTensor laid out {pl}: its sequence "
                         f"and last dim must be whole")
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)
    cos, sin = (t.redistribute(placements=rows) if is_dtensor(t) else
                distribute_tensor(t, x.device_mesh, rows)
                for t in (cos, sin))
    return local_map(fn, out_placements=(pl,),
                     in_placements=(pl, rows, rows))(x, cos, sin)


def local_chunk(fn, q, k, v, f, i, C, mask):
    """``fn(q, k, v, f, i, C, mask)`` -> ``(y, C)``, an mLSTM chunk
    (``q``, ``k``, ``v``, ``y`` ``(B, c, H, D)``, the gates ``(B, c,
    H)``, the state ``C`` ``(B, H, D, D)``); on DTensors shard by shard,
    every batch row and head being independent: each device runs the
    chunk on its rows and heads as ``q`` lays them out (its other dims
    whole), so DTensor propagates none of the chunk's operators (2.11 has
    no rule for the ``flip`` of the cumulative sum's backward)."""
    if not is_dtensor(q):
        return fn(q, k, v, f, i, C, mask)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    on = [0 if pl.is_shard(0) else 2 if pl.is_shard(2) else None
          for pl in q.placements]
    heads = tuple(Replicate() if d is None else Shard(d) for d in on)
    state = tuple(Replicate() if d is None else Shard(min(d, 1))
                  for d in on)
    q, k, v, f, i = (t.redistribute(placements=heads)
                     for t in (q, k, v, f, i))
    return local_map(fn, out_placements=(heads, state),
                     in_placements=(heads,) * 5 + (state, None))(
        q, k, v, f, i, C.redistribute(placements=state), mask)


def local_scan(fn, decay, drive, C, h):
    """``fn(decay, drive, C, h)`` -> ``(y, h)``, a chunk of the selective
    scan (``decay``, ``drive`` ``(B, c, di, N)``, ``C`` ``(B, c, N)``,
    ``h`` ``(B, di, N)``, ``y`` ``(B, c, di)``); on DTensors shard by
    shard, every batch row and channel being independent: each device
    scans its rows and channels as ``decay`` lays them out, so DTensor
    propagates none of the log-step scan's many small operators."""
    if not is_dtensor(decay):
        return fn(decay, drive, C, h)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    on = [0 if pl.is_shard(0) else 2 if pl.is_shard(2) else None
          for pl in decay.placements]

    def lay(channels):      # the rows' dim 0; the channels' dim, if any
        return tuple(Shard(0) if d == 0 else
                     Shard(channels) if d == 2 and channels else Replicate()
                     for d in on)
    seq, rows, state = lay(2), lay(None), lay(1)
    decay, drive = (t.redistribute(placements=seq) for t in (decay, drive))
    return local_map(fn, out_placements=(seq, state),
                     in_placements=(seq, seq, rows, state))(
        decay, drive, C.redistribute(placements=rows),
        h.redistribute(placements=state))


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

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
over vocabulary shards, the MoE dispatch moving each device's token rows
into the experts' slots and back (:func:`by_rows`, :func:`send_rows`,
:func:`take_rows`: every device routes its rows and computes the one plan
of the batch from the gathered expert ids; at a decode step's few rows
the expert weights stay on their ranks: :func:`for_use`), at token rows
the data axes do not shard (one decode row) no weight gathered, each
product on the weight's own shards (:func:`whole_rows`, :func:`matmul`,
the embedding's lookup and the head too), decode's KV
pool sharded over its pages with split-KV decoding over the shards
(:func:`write_rows`, :func:`local_decode`), query heads that do not
divide the ranks kept whole with the query rows split instead
(:func:`query_heads`); and it runs shard by shard
(``local_map``) what is independent per row and head, or what DTensor
lays out badly (the attention, in prefill the reference's online KV
chunks, the mLSTM and Mamba chunks, RoPE, the optimizer's elementwise
updates).  No serve or train path on the card sees a DTensor.
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


def _buffer(w):
    """The placements of the experts' buffer ``(E, C, d)`` against expert
    weights ``w`` ``(E, d, ...)``, per mesh dim: its experts where ``w``
    shards them (a run of whole experts a device), its width where ``w``
    shards its rows (weights kept on their ranks: :func:`for_use`), its
    slots over every other mesh dim."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(0) if pl.is_shard(0) else Shard(2) if pl.is_shard(1)
                 else Shard(1) for pl in w.placements)


def by_expert(buf, w):
    """The experts' buffer ``buf`` ``(E, C, d)`` of an MoE sublayer whose
    expert weights are ``w`` ``(E, ...)``: on DTensors laid out by
    :func:`_buffer`, in the backward too."""
    if not is_dtensor(buf):
        return buf
    return pinned(buf, _buffer(w))


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


def halves(t):
    """``t.chunk(2, dim=-1)``.  A DTensor whose last dim is sharded over
    one mesh dim of ``k`` ranks holds the first half on its first ``k /
    2`` ranks, which DTensor splits by gathering it whole (each device
    then computing the whole of what follows, gradients included); here
    the halves are regrouped as XLA reshards the reference's split, each
    half sharded over all ``k`` ranks: the ``2 k`` runs of columns moved
    to every rank (one all-to-all), split into the halves, and each
    half's runs moved back one a rank (one all-to-all each).  The views
    go shard by shard (DTensor 2.11 gathers a sharded dim it splits, and
    unbinds by gathering every dim)."""
    last = t.dim() - 1
    on = [i for i, pl in enumerate(t.placements if is_dtensor(t) else ())
          if pl.is_shard(last) and t.device_mesh.size(i) > 1]
    if len(on) != 1:
        return t.chunk(2, dim=-1)
    from torch.distributed.tensor.experimental import local_map
    w = t.shape[-1] // (2 * t.device_mesh.size(on[0]))

    def shard_by_shard(fn, x, n_out=1):
        pl = tuple(x.placements)
        return local_map(fn, out_placements=(pl,) * n_out,
                         in_placements=(pl,))(x)
    runs = shard_by_shard(lambda x: x.reshape(*x.shape[:-1], -1, w), t)
    runs = _moved(runs, last, last + 1)      # every run, w / k columns
    first, second = shard_by_shard(lambda x: x.reshape(
        *x.shape[:-2], 2, -1, x.shape[-1]).unbind(-3), runs, 2)
    return tuple(shard_by_shard(lambda x: x.reshape(*x.shape[:-2], -1),
                                _moved(h, last + 1, last))
                 for h in (first, second))


def _moved(t, src, dst):
    """DTensor ``t`` with its shards of dim ``src`` moved to dim ``dst``
    on the same mesh dims (one all-to-all each); its gradient moved back
    (DTensor's ``redistribute``)."""
    from torch.distributed.tensor import Shard
    return t.redistribute(placements=[Shard(dst) if pl.is_shard(src) else pl
                                      for pl in t.placements])


def _split_rows(t, dim):
    """The number of parts DTensor ``t``'s dim ``dim`` is split into and
    this device's part (over the mesh dims that shard it, outermost first,
    as DTensor splits a dim over several)."""
    mesh = t.device_mesh
    n, r = 1, 0
    for i, pl in enumerate(t.placements):
        if pl.is_shard(dim):
            n, r = n * mesh.size(i), r * mesh.size(i) + mesh.get_local_rank(i)
    return n, r


def _pair_blocks(t, n, undo=False):
    """DTensor ``t`` ``(B, S, ...)``, its dim 1 whole, with the ``2 n``
    blocks of its rows dealt in pairs, one from each end: ``0, 2n - 1, 1,
    2n - 2, ...`` (each of ``n`` runs of rows then holds block ``r`` and
    block ``2n - 1 - r``); with ``undo``, back.  Shard by shard."""
    from torch.distributed.tensor.experimental import local_map
    order = [b for r in range(n) for b in (r, 2 * n - 1 - r)]
    if undo:
        order = sorted(range(2 * n), key=order.__getitem__)

    def deal(x):
        blocks = x.reshape(x.shape[0], 2 * n, -1, *x.shape[2:])
        idx = torch.tensor(order, device=x.device)
        return blocks.index_select(1, idx).reshape(x.shape)
    pl = tuple(t.placements)
    return local_map(deal, out_placements=(pl,), in_placements=(pl,))(t)


def query_heads(t, *shape, unit=1, causal=False):
    """The queries ``t`` ``(B, S, H * D)`` split into heads ``(B, S, H,
    D)``, or an attention output's heads merged back: ``t.reshape(*shape)``.
    On a DTensor whose columns are sharded over ranks that the ``H``
    heads do not divide (deepseek's 56, llama4-scout's 40 or musicgen's
    24 over 16) and whose rows split into runs of ``unit`` (an mLSTM's
    chunks) over the same ranks, laid out as XLA partitions the
    reference: the columns' shards moved to the rows before the split (one
    all-to-all a mesh dim, the heads then whole and the rows split), and
    an output's rows' shards back to its columns after the merge
    (:func:`columns`).  With ``causal`` (attention's queries and output)
    the rows are dealt in pairs of blocks from both ends first
    (:func:`_pair_blocks`, undone after the merge), so that every device's
    rows attend to as many keys (:func:`_rows_attention`).  Otherwise
    :func:`heads`."""
    if not is_dtensor(t):
        return t.reshape(*shape)
    split = len(shape) > t.dim()
    last = t.dim() - 1
    unit *= 2 if causal else 1
    if split and any(pl.is_shard(last) and shape[-2] % t.device_mesh.size(i)
                     for i, pl in enumerate(t.placements)) and not any(
            pl.is_shard(last) and t.shape[1] % (unit * t.device_mesh.size(i))
            for i, pl in enumerate(t.placements)):
        if causal:
            t = _pair_blocks(t, _split_rows(t, last)[0])
        return _moved(t, last, 1).reshape(shape)
    if not split and any(pl.is_shard(1) for pl in t.placements):
        n = _split_rows(t, 1)[0]
        t = columns(t.reshape(shape))
        return _pair_blocks(t, n, undo=True) if causal else t
    return heads(t, *shape)


def in_row_order(q, *ts):
    """``ts`` ``(B, S, ...)`` (the rotary angles) in the order of the rows
    of queries ``q`` that :func:`query_heads` split with ``causal``; as
    they are otherwise."""
    if not rows_split(q):
        return ts
    n = _split_rows(q, 1)[0]
    return tuple(_pair_blocks(t, n) for t in ts)


def columns(t):
    """``t`` ``(B, S, n)``; a DTensor whose rows :func:`query_heads` split
    with its rows' shards moved back to its columns (one all-to-all a
    mesh dim), for the product with a weight's row shards (``wo``)."""
    if not is_dtensor(t) or not any(pl.is_shard(1) for pl in t.placements):
        return t
    return _moved(t, 1, t.dim() - 1)


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


def whole_rows(rows):
    """Whether DTensor ``rows`` (a step's token rows, dim 0) lies whole
    over the data axes: a batch they do not divide (one decode row, as
    :func:`~repro_torch.distributed.sharding.dp_for` keeps it replicated).
    At such rows the reference's program contracts every product on the
    weight's own FSDP shard and reduces the small partial rows, where it
    gathers the weights for rows the data axes shard."""
    names = rows.device_mesh.mesh_dim_names
    return not any(pl.is_shard(0) and names[i] in _FSDP_AXES
                   for i, pl in enumerate(rows.placements))


def _stays(w, rows):
    """Whether an MoE sublayer's expert weights ``w`` ``(E, d, ...)`` stay
    on the ranks that hold them for a step of ``rows`` token rows: where
    the rows (and so any expert's slots) are fewer than the rows ``d`` of
    the weight, moving the slots' partial products costs less than
    gathering the weight (decode's few rows, as XLA lays out the
    reference's decode)."""
    return rows is not None and w.dim() == 3 and rows < w.shape[1]


def for_use(layer, rows=None):
    """Each weight of a scan step's sublayer dicts :func:`gathered`; the
    dicts of plain tensors as they are (decided once, on the first weight:
    a model's weights are all DTensors or none).  With ``rows``, the step's
    token rows ``(B, ...)``: where they lie whole over the data axes
    (:func:`whole_rows`) no weight is gathered, each product contracting
    the row's columns on the weight's own shards (:func:`matmul`);
    otherwise the expert weights
    :func:`_stays` keeps are not gathered: the experts' products contract
    over the weights' own shards (:func:`by_expert`)."""
    if not is_dtensor(next(iter(layer[0].values()))):
        return layer
    if rows is not None and whole_rows(rows):
        return layer
    n = None if rows is None else rows.shape[0]
    return [{k: w if _stays(w, n) else gathered(w)
             for k, w in sub.items()} for sub in layer]


def matmul(x, w):
    """``x @ w``; on DTensor rows whole over the data axes
    (:func:`whole_rows`), where ``w`` stays on its ranks (:func:`for_use`),
    the product's partial sums over ``w``'s shards reduced at once, so
    that DTensor does not pick the reduction (or a gather of ``w``) by
    itself at the operator that reads them."""
    out = x @ w
    return summed(out) if is_dtensor(x) and whole_rows(x) else out


def routed(fn, n_out, x, w):
    """``fn(x.float() @ w.float())`` -> ``n_out`` tensors of the rows of
    ``x`` ``(T, d)`` (a router's logits and what follows them).  On
    DTensor rows each device runs it on its own rows with ``w`` whole
    (:func:`by_rows`); on rows whole over the data axes
    (:func:`whole_rows`) the product contracts on ``w``'s own shards and
    is reduced first, so ``w`` is not gathered."""
    if is_dtensor(x) and whole_rows(x):
        return by_rows(fn, n_out, (summed(x.float() @ w.float()),))
    return by_rows(lambda x, w: fn(x.float() @ w.float()), n_out, (x,), w)


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


def _ids(n, t, dim, placements=None):
    """``arange(n)`` as a DTensor sharded over the mesh dims that shard
    DTensor ``t``'s dim ``dim`` (by ``t``'s placements, or ``placements``):
    each device's ids of its part of that dim."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    return distribute_tensor(
        torch.arange(n, device=t.to_local().device), t.device_mesh,
        tuple(Shard(0) if pl.is_shard(dim) else Replicate()
              for pl in placements or t.placements))


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
    are summed.  At tokens whole over the data axes (:func:`whole_rows`:
    one decode row) the table is not gathered: each device looks them up
    in its own shard, and the rows come out split over its columns as
    the table's are.  DTensor has no rule for indexing a sharded table,
    and its own ``embedding`` rule builds the whole table's gradient on
    every device."""
    if not is_dtensor(table):
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    w = table if whole_rows(tokens) else gathered(table)
    tpl = tuple(w.placements)
    rows = tuple(pl if pl.is_shard(0) and not w_pl.is_shard(0)
                 else Replicate()
                 for pl, w_pl in zip(tokens.placements, tpl))
    out = tuple(Partial() if w_pl.is_shard(0) else
                Shard(tokens.dim()) if w_pl.is_shard(1) else r
                for r, w_pl in zip(rows, tpl))
    grad = tuple(Partial() if r.is_shard(0) else w_pl
                 for r, w_pl in zip(rows, tpl))
    ids = _ids(w.shape[0], w, 0)
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
    ids = _ids(logits.shape[last], logits, last)
    lab = labels.clamp(min=0).redistribute(placements=rows)
    gold = local_map(_local_gold, out_placements=(reduced("sum"),),
                     in_placements=(lpl, rows, vocab))(logits, lab, ids)
    return logz, gold.redistribute(placements=rows)


def _rows(t, skip=None):
    """``t``'s placements with only its shards of dim 0 kept (and not on
    the mesh dims ``skip`` marks)."""
    from torch.distributed.tensor import Replicate
    skip = skip or (False,) * len(t.placements)
    return tuple(pl if pl.is_shard(0) and not s else Replicate()
                 for pl, s in zip(t.placements, skip))


def by_rows(fn, n_out, rows, *weights):
    """``fn(*rows, *weights)`` -> ``n_out`` tensors of the rows ``(T,
    ...)`` of the tensors ``rows`` (laid out alike): on DTensors each
    device runs ``fn`` on its own rows (each of ``rows`` whole but for its
    shards of dim 0), the weights whole, every output laid out as the rows
    and each weight's gradient the sum of the devices' (row by row work:
    no operator of ``fn`` is propagated)."""
    if not is_dtensor(rows[0]):
        return fn(*rows, *weights)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    lay = _rows(rows[0])
    whole = (Replicate(),) * len(lay)
    grad = tuple(Partial() if pl.is_shard(0) else pl for pl in lay)
    ws = tuple(w.redistribute(placements=whole) for w in weights)
    return local_map(fn, out_placements=(lay,) * n_out,
                     in_placements=(lay,) * len(rows) + (whole,) * len(ws),
                     in_grad_placements=(lay,) * len(rows) +
                     (grad,) * len(ws))(
        *(x.redistribute(placements=lay) for x in rows), *ws)


def column_means(t):
    """``t.mean(0)``; a DTensor whose rows are sharded shard by shard, the
    devices' sums reduced."""
    if not is_dtensor(t):
        return t.mean(0)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    rows = _rows(t)
    return summed(local_map(
        lambda x: x.sum(0), out_placements=(
            tuple(Partial() if pl.is_shard(0) else Replicate()
                  for pl in rows),), in_placements=(rows,))(
        t.redistribute(placements=rows))) / t.shape[0]


def as_replicated(t, like):
    """A plain ``t``, the same on every device, as a replicated DTensor
    on ``like``'s mesh when ``like`` is a DTensor (no collective);
    otherwise ``t``."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, like.device_mesh,
                              (Replicate(),) * like.device_mesh.ndim,
                              run_check=False)


def _moe_layout(x, w):
    """The MoE dispatch's layout of DTensor token rows ``x`` against
    expert weights ``w`` ``(E, ...)``, per mesh dim: whether it shards the
    experts (``ex``); ``x``'s rows' placements, whole on the experts'
    dims (``rows``); and the experts' buffer's ``(E, C, d)`` placements
    (``buf``, :func:`_buffer`)."""
    ex = tuple(pl.is_shard(0) for pl in w.placements)
    return ex, _rows(x, ex), _buffer(w)


def _slots(C, x, w):
    """The capacity ``C`` rounded up to a multiple of the ranks that split
    the experts' slots (:func:`_moe_layout`), so that they split it
    evenly.  The slots past ``C`` stay empty."""
    n = 1
    for i, pl in enumerate(_moe_layout(x, w)[2]):
        n *= x.device_mesh.size(i) if pl.is_shard(1) else 1
    return -(-C // n) * n


def _sorted(expert, slot, keep, sort, C):
    """The plan's assignments in ``sort`` order (by expert, stable): each
    one's row ``e * C + slot`` of the experts' buffer, whether it got a
    slot, and its token."""
    K = expert.shape[1]
    return ((expert * C + slot).reshape(-1)[sort], keep.reshape(-1)[sort],
            sort // K)


def _slot_of(expert, slot, keep, tok, exp, cap, need_keep):
    """Each of this device's rows' assignments (``tok``: the global ids of
    its rows) at its place ``e * C_l + s`` in this device's part of the
    experts' buffer (``exp``, ``cap``: the global ids of its experts and
    slots), and whether it lies there (and, with ``need_keep``, got a
    slot)."""
    e = expert[tok] - exp[0]                                  # (T_l, K)
    s = slot[tok] - cap[0]
    inside = (e >= 0) & (e < exp.shape[0]) & (s >= 0) & (s < cap.shape[0])
    if need_keep:
        inside = inside & keep[tok]
    return torch.where(inside, e * cap.shape[0] + s, 0), inside


def send_rows(x, expert, slot, keep, sort, w, C):
    """The experts' buffer ``(E, C, d)`` of an MoE sublayer from the token
    rows ``x`` ``(T, d)`` and the whole batch's plan (plain tensors:
    ``expert``, ``slot``, ``keep`` ``(T, K)``, each assignment's expert,
    its slot there and whether it got one; ``sort``, the assignments
    sorted by expert) against the expert weights ``w`` ``(E, ...)``: the
    kept rows added into their slots in ``sort`` order.  On DTensor rows
    each device adds its own rows into its experts' slots; where the rows
    are sharded, the parts are reduce-scattered over the slots (the
    capacity rounded up to split evenly: :func:`_slots`).  Laid out by
    :func:`by_expert`: every device runs its experts on its own slots."""
    if not is_dtensor(x):
        row, kept, tok = _sorted(expert, slot, keep, sort, C)
        return x.new_zeros((w.shape[0] * C, x.shape[1])).index_add(
            0, row, x[tok] * kept[:, None].to(x.dtype)).view(
                w.shape[0], C, x.shape[1])
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    _, rows, lay = _moe_layout(x, w)
    # where the buffer's width is split and the rows are not, each device
    # adds its own columns of every row
    rows = tuple(Shard(1) if b.is_shard(2) and not r.is_shard(0) else r
                 for r, b in zip(rows, lay))
    part = tuple(Partial() if r.is_shard(0) else pl
                 for r, pl in zip(rows, lay))
    grad = tuple(pl if pl.is_shard(0) or pl.is_shard(1) else Partial()
                 for pl in rows)
    x = x.redistribute(placements=rows)
    tok, exp = _ids(x.shape[0], x, 0), _ids(w.shape[0], w, 0)
    cap = _ids(_slots(C, x, w), x, 1, part)

    def send(x, tok, exp, cap, expert, slot, keep):
        at, inside = _slot_of(expert, slot, keep, tok, exp, cap, True)
        buf = x.new_zeros((exp.shape[0] * cap.shape[0], x.shape[1]))
        for k in range(at.shape[1]):
            buf.index_add_(0, at[:, k], x * inside[:, k, None].to(x.dtype))
        return buf.view(exp.shape[0], cap.shape[0], x.shape[1])
    ids = tuple(tuple(t.placements) for t in (tok, exp, cap))
    return by_expert(local_map(
        send, out_placements=(part,),
        in_placements=(rows, *ids, None, None, None),
        in_grad_placements=(grad, *ids, None, None, None))(
            x, tok, exp, cap, expert, slot, keep), w)


def take_rows(out, expert, slot, keep, sort, gates, by_id):
    """Each token's MoE output ``(T, d)`` from the experts' outputs
    ``out`` ``(E, C, d)`` (laid out by :func:`by_expert`) and the plan of
    :func:`send_rows`: each kept assignment's output weighted by its gate
    (``gates`` ``(T, K)``, laid out as the rows), a token's summed in
    ``by_id`` order (its assignments by expert id) in ``out``'s dtype.
    On DTensors, gathered over the slots where the rows are sharded (and
    over the width where it is split: :func:`for_use`; at rows whole over
    the data axes the width stays split, and so do the outputs), each
    device takes its rows' assignments to the experts and slots it holds;
    the partial sums of the devices that hold the other experts and slots
    are pending (summed as a sublayer's output is)."""
    if not is_dtensor(out):
        E, C, d = out.shape
        T, K = expert.shape
        row, kept, _ = _sorted(expert, slot, keep, sort, C)
        g = gates.reshape(-1)[sort]
        contrib = out.view(E * C, d)[row] * \
            (g * kept.float())[:, None].to(out.dtype)
        # back to (token, k); a token's contributions in expert-id order
        per_tok = torch.empty_like(contrib).index_copy(0, sort, contrib)
        per_tok = per_tok.view(T, K, d).gather(
            1, by_id[..., None].expand(T, K, d))
        y = out.new_zeros((T, d))
        for r in range(K):
            y = y + per_tok[:, r]
        return y
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ex = tuple(pl.is_shard(0) for pl in out.placements)
    rows = _rows(gates, ex)
    gates, by_id = (t.redistribute(placements=rows) for t in (gates, by_id))
    # at rows whole over the data axes the width stays split, as the
    # residual stream's columns are
    whole = whole_rows(gates)
    held = tuple(Replicate() if r.is_shard(0) or pl.is_shard(2) and not whole
                 else pl for r, pl in zip(rows, out.placements))
    out = pinned(out, held)
    y_pl = tuple(pl if pl.is_shard(0) else Shard(1) if h.is_shard(2) else
                 Partial() if not h.is_replicate() else Replicate()
                 for pl, h in zip(rows, held))
    out_grad = tuple(Partial() if r.is_shard(0) else h
                     for r, h in zip(rows, held))
    tok = _ids(gates.shape[0], gates, 0)
    exp = _ids(out.shape[0], out, 0)
    cap = _ids(out.shape[1], out, 1)

    def take(out, tok, exp, cap, expert, slot, keep, gates, by_id):
        at, inside = _slot_of(expert, slot, keep, tok, exp, cap, False)
        g = (gates * keep[tok].to(gates.dtype)).to(out.dtype) * \
            inside.to(out.dtype)
        flat = out.reshape(-1, out.shape[-1])
        y = out.new_zeros((tok.shape[0], out.shape[-1]))
        for j in range(at.shape[1]):
            k = by_id[:, j:j + 1]
            y = y + flat[at.gather(1, k)[:, 0]] * g.gather(1, k)
        return y
    ids = tuple(tuple(t.placements) for t in (tok, exp, cap))
    return local_map(
        take, out_placements=(y_pl,),
        in_placements=(held, *ids, None, None, None, rows, rows),
        in_grad_placements=(out_grad, *ids, None, None, None, y_pl, rows))(
            out, tok, exp, cap, expert, slot, keep, gates, by_id)


def _write_local(pool, page, off, rows):
    """``pool[page, off] = rows`` for the entries whose ``page`` lies in
    ``pool`` ``(NP, page_size, ...)``; the rest write nothing.  Without a
    data-dependent shape: an entry outside rewrites what the first entry
    inside writes, or with none inside, slot 0 of page 0 with its own
    value."""
    NP, size = pool.shape[:2]
    inside = (page >= 0) & (page < NP)
    flat = pool.view(NP * size, *pool.shape[2:])
    at = page.clamp(0, NP - 1) * size + off
    first = inside.int().argmax()[None]
    some = inside.any()
    at = torch.where(inside, at, torch.where(some, at[first], 0))
    keep = inside.reshape(-1, *([1] * (rows.dim() - 1)))
    flat[at] = torch.where(keep, rows, torch.where(some, rows[first],
                                                   flat[0]))


def write_rows(pool, page, off, rows):
    """``pool[page, off] = rows`` in place.  On DTensors the pool's pages
    are sharded (:func:`repro_torch.distributed.sharding.
    decode_state_specs`): the page ids, offsets and rows are gathered
    (a few bytes a row) and each device writes the entries whose page it
    holds, at its own page ids (DTensor has no rule for the indexed
    write)."""
    if not is_dtensor(pool):
        pool[page, off] = rows
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    whole = (Replicate(),) * pool.device_mesh.ndim
    ids = _ids(pool.shape[0], pool, 0)

    def write(pool, page, off, rows, ids):
        _write_local(pool, page - ids[0], off, rows)
    local_map(write, out_placements=None,
              in_placements=(tuple(pool.placements),) + (whole,) * 3 +
              (tuple(ids.placements),))(
        pool, *(t.redistribute(placements=whole) for t in (page, off, rows)),
        ids)


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


def _group(h, G):
    """The query heads of one KV head in a device's run of ``h``
    consecutive query heads (``G`` a KV head): ``G`` where the run holds
    whole groups, ``h`` where it lies inside one, else 1 (each query head
    with its own copy of its KV head)."""
    return G if h % G == 0 else h if G % h == 0 else 1


def local_attention(q, k, v, causal, window):
    """Attention on DTensors, shard by shard: attention is independent per
    sequence and head, so with the sequence whole each device computes its
    own batch rows and heads.  Causal and without autograd (the prefill)
    it runs the reference's own function,
    :func:`~repro_torch.kernels.flash_attention.ref.online_attn` (K/V
    chunks, the query heads grouped by KV head, which each device
    gathers for its query heads); under autograd (a train step, whose
    checkpoint saves only the inputs)
    :func:`~repro_torch.kernels.flash_attention.ref.flash_mha_ref`, K and
    V repeated to the query heads (the GQA fold) and laid out as ``q``;
    no sharded dim is flattened, which DTensor does not do for the fold's
    ``(B * H)``."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from ..kernels.flash_attention.ref import flash_mha_ref
    placements = tuple(q.placements)
    if any(pl.is_partial() for pl in placements) or (
            any(pl.is_shard(1) for pl in placements) and not causal):
        raise ValueError(f"attention on DTensors needs no partial sums, "
                         f"and the sequence whole but causal; q is "
                         f"{placements}")
    if any(pl.is_shard(1) for pl in placements):
        return _rows_attention(q, k, v, window)
    if causal and not torch.is_grad_enabled():
        return _local_online(q, k, v, window)
    G = q.shape[2] // k.shape[2]

    def as_q(x):
        whole = x.redistribute(placements=[
            Replicate() if pl.is_shard(2) else pl for pl in x.placements])
        return whole.repeat_interleave(G, dim=2).redistribute(
            placements=placements)
    run = local_map(flash_mha_ref, out_placements=(placements,),
                    in_placements=(placements,) * 3 + (None, None))
    return run(q, as_q(k), as_q(v), causal, window)


def _local_online(q, k, v, window):
    """:func:`local_attention` without autograd: each device's rows and
    query heads through ``online_attn``, against the KV heads they read
    (K and V gathered over the heads' shards, their rows as ``q``'s; a
    sharded index of each query head's KV head picks them)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from ..kernels.flash_attention.ref import online_attn
    placements = tuple(q.placements)
    G = q.shape[2] // k.shape[2]
    kv_pl = tuple(Replicate() if pl.is_shard(2) else pl for pl in placements)
    heads = _ids(q.shape[2], q, 2)

    def run(q, k, v, heads):
        B, S, h, D = q.shape
        g = _group(h, G)
        pos = torch.arange(S, device=q.device).expand(B, S)
        sel = heads[::g] // G             # the KV heads of its query heads
        o = online_attn(q.reshape(B, S, h // g, g, D), k[:, :, sel],
                        v[:, :, sel], pos, pos, window)
        return o.reshape(B, S, h, D)
    return local_map(run, out_placements=(placements,),
                     in_placements=(placements, kv_pl, kv_pl,
                                    tuple(heads.placements)))(
        q, k.redistribute(placements=kv_pl), v.redistribute(placements=kv_pl),
        heads)


def _rows_attention(q, k, v, window):
    """:func:`local_attention` of queries whose rows :func:`query_heads`
    split with ``causal``, in both passes: each device's two blocks of
    rows (block ``r`` and ``2n - 1 - r`` of ``2n``) through ``online_attn``
    at their positions against the keys up to the block's end (rounded up
    to whole KV chunks; the chunks past it are wholly masked), K and V
    whole over the mesh dims that split the rows (the reference's
    partition of its ``_online_attn``, without its masked chunks; every
    device attends to as many keys).  Under autograd (a train step) each
    block runs ``masked_attn`` on its keys at once (autograd keeps every
    chunk's scores for the backward either way), and the keys' and
    values' gradients are each device's partial sums over its rows."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from ..kernels.flash_attention.ref import (KV_CHUNK, masked_attn,
                                               online_attn)
    placements = tuple(q.placements)
    S, G = k.shape[1], q.shape[2] // k.shape[2]
    kv_pl = tuple(Replicate() if pl.is_shard(1) or pl.is_shard(2) else pl
                  for pl in placements)
    kv_grad = tuple(Partial() if pl.is_shard(1) else kv
                    for pl, kv in zip(placements, kv_pl))
    n, r = _split_rows(q, 1)
    L = S // (2 * n)
    whole = torch.is_grad_enabled()
    attn = masked_attn if whole else online_attn

    def run(q, k, v):
        B, _, H, D = q.shape
        out = []
        for j, b in enumerate((r, 2 * n - 1 - r)):
            end = (b + 1) * L if whole else \
                min(S, -(-(b + 1) * L // KV_CHUNK) * KV_CHUNK)
            q_pos = torch.arange(b * L, (b + 1) * L,
                                 device=q.device).expand(B, L)
            kv_pos = torch.arange(end, device=q.device).expand(B, end)
            o = attn(q[:, j * L:(j + 1) * L].reshape(B, L, H // G, G, D),
                     k[:, :end], v[:, :end], q_pos, kv_pos, window)
            out.append(o.reshape(B, L, H, D))
        return torch.cat(out, dim=1)
    return local_map(run, out_placements=(placements,),
                     in_placements=(placements, kv_pl, kv_pl),
                     in_grad_placements=(placements, kv_grad, kv_grad))(
        q, k.redistribute(placements=kv_pl), v.redistribute(placements=kv_pl))


def local_device(t):
    """The device of ``t``'s data: a DTensor's local shard's."""
    return t.to_local().device if is_dtensor(t) else t.device


def rows_of(fn, n_out, t, like):
    """``fn(t)`` -> ``n_out`` tensors of ``t``'s rows, ``t`` ``(B, ...)``
    a plain tensor the same on every device (the positions of a batch).
    Where ``like`` is a DTensor whose rows ``(B, ...)`` are sharded, each
    device computes its own rows' (``t`` and the outputs laid out as
    ``like``'s rows), not the whole batch's."""
    if not is_dtensor(like):
        return fn(t)
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    rows = _rows(like)
    return local_map(fn, out_placements=(rows,) * n_out,
                     in_placements=(rows,))(
        distribute_tensor(t, like.device_mesh, rows))


def local_rope(fn, x, cos, sin):
    """``fn(x, cos, sin)``, RoPE of ``x`` ``(B, S, H, D)`` by angles
    ``(B, S, 1, D / 2)``; on a DTensor ``x`` shard by shard, the angles
    laid out as its rows and, where :func:`query_heads` split them, its
    positions (DTensor 2.11 on fake tensors multiplies a sharded query by
    its angles as whole tensors)."""
    if not is_dtensor(x):
        return fn(x, cos, sin)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    x = summed(x)
    pl = tuple(x.placements)
    if any(p.is_shard(x.dim() - 1) for p in pl):
        raise ValueError(f"rope of a DTensor laid out {pl}: its last dim "
                         f"must be whole")
    rows = tuple(Shard(p.dim) if p.is_shard(0) or p.is_shard(1) else
                 Replicate() for p in pl)
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


def rows_split(t):
    """Whether ``t`` is a DTensor whose rows (dim 1) are split
    (:func:`query_heads`)."""
    return is_dtensor(t) and any(pl.is_shard(1) for pl in t.placements)


def local_chunks(fn, state_fn, q, k, v, f, i, C, mask):
    """The mLSTM over queries ``q``, ``k``, ``v`` ``(B, S, H, D)`` whose
    rows :func:`query_heads` split, gates ``(B, S, H)`` and incoming state
    ``C`` ``(B, H, D, D)``: ``(y (B, S, H, D), C)`` laid out as ``q`` and
    as its batch rows.  The state's recurrence over chunks is linear, so
    each device runs its own run of chunks twice: from a zero state for
    the state at the run's end and its whole log forget gate
    (``state_fn``), which are gathered over the ranks that split the rows;
    then, from ``C`` with the gathered states of the runs before its own
    folded in, through ``fn`` (:func:`local_chunk`'s) for its outputs.
    The last run's device holds the state at the end (its partial, zero
    elsewhere, is summed)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(q.placements)
    split = tuple(p.is_shard(1) for p in pl)
    rows = tuple(p if p.is_shard(0) or s else Replicate()
                 for p, s in zip(pl, split))
    state = tuple(p if p.is_shard(0) else Replicate() for p in rows)
    runs = tuple(Shard(0) if s else Shard(1) if p.is_shard(0) else p
                 for p, s in zip(state, split))
    every = tuple(Replicate() if s else r for r, s in zip(runs, split))
    partial = tuple(Partial() if s else p for p, s in zip(state, split))
    summed_runs = tuple(Partial() if s else p for p, s in zip(every, split))
    c = mask.shape[0]
    q, k, v, f, i = (t.redistribute(placements=rows) for t in (q, k, v, f, i))
    ids = _ids(q.shape[1], q, 1)
    last = q.shape[1] - q.to_local().shape[1]

    def chunked(*ts):
        B, Sl = ts[0].shape[:2]
        return [t.float().reshape(B, Sl // c, c, *t.shape[2:]) for t in ts]

    def first(k, v, f, i):
        kc, vc, fc, ic = chunked(k, v, f, i)
        B, n, _, H, D = kc.shape
        end = kc.new_zeros((B, H, D, D))
        logf = kc.new_zeros((B, H))
        for j in range(n):
            end, total = state_fn(kc[:, j], vc[:, j], fc[:, j], ic[:, j], end)
            logf = logf + total
        return end[None], logf[None]
    ends, logfs = (t.redistribute(placements=every) for t in local_map(
        first, out_placements=(runs, runs), in_placements=(rows,) * 4)(
            k, v, f, i))

    def second(q, k, v, f, i, C, ends, logfs, ids):
        qc, kc, vc, fc, ic = chunked(q, k, v, f, i)
        run = ids[0] // qc.shape[1] // c
        for s in range(ends.shape[0]):       # the runs before this one
            C = torch.where(s < run, C * torch.exp(logfs[s])[..., None, None]
                            + ends[s], C)
        ys = []
        for j in range(qc.shape[1]):
            y, C = fn(qc[:, j], kc[:, j], vc[:, j], fc[:, j], ic[:, j], C,
                      mask)
            ys.append(y)
        return torch.cat(ys, dim=1), C * (ids[0] == last).to(C.dtype)
    ids_pl = tuple(ids.placements)
    y, C = local_map(
        second, out_placements=(rows, partial),
        in_placements=(rows,) * 5 + (state, every, every, ids_pl),
        in_grad_placements=(rows,) * 5 + (partial, summed_runs, summed_runs,
                                          ids_pl))(
        q, k, v, f, i, C.redistribute(placements=state), ends, logfs, ids)
    return y, C.redistribute(placements=state)


def local_scan(fn, decay, drive, C, h):
    """``fn(decay, drive, C, h)`` -> ``(y, h)``, a chunk of the selective
    scan (``decay``, ``drive`` ``(B, c, di, N)``, ``C`` ``(B, c, N)``,
    ``h`` ``(B, di, N)``, ``y`` ``(B, c, di)``); on DTensors shard by
    shard, every batch row and channel being independent: each device
    scans its rows and channels as ``decay`` lays them out, so DTensor
    propagates none of the log-step scan's many small operators.  ``C``
    is read by every channel, so its gradient is each device's partial
    sum over its channels."""
    if not is_dtensor(decay):
        return fn(decay, drive, C, h)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    on = [0 if pl.is_shard(0) else 2 if pl.is_shard(2) else None
          for pl in decay.placements]

    def lay(channels):      # the rows' dim 0; the channels' dim, if any
        return tuple(Shard(0) if d == 0 else
                     Shard(channels) if d == 2 and channels else Replicate()
                     for d in on)
    seq, rows, state = lay(2), lay(None), lay(1)
    rows_grad = tuple(Partial() if d == 2 else pl for d, pl in zip(on, rows))
    decay, drive = (t.redistribute(placements=seq) for t in (decay, drive))
    return local_map(fn, out_placements=(seq, state),
                     in_placements=(seq, seq, rows, state),
                     in_grad_placements=(seq, seq, rows_grad, state))(
        decay, drive, C.redistribute(placements=rows),
        h.redistribute(placements=state))


def local_decode(q, kpool, vpool, block_table, seq_lens, window):
    """:func:`~repro_torch.kernels.paged_attention.ref.paged_attention_ref`
    on DTensors, split-KV over the pools' shards: each device runs
    :func:`~repro_torch.kernels.paged_attention.ref.paged_partial` over
    the pages it holds, for every row (the query rows, the block table
    and the lengths gathered: a page may be any row's) and for its query
    heads (whole over the mesh dims that shard the pages), and one
    combine joins the devices that split the pages (a max, then two sums,
    over them).  Any block table that names each page at most once."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..kernels.paged_attention.ref import paged_partial
    mesh, q_in = q.device_mesh, tuple(q.placements)
    pages = tuple(kpool.placements)
    if any(not (pl.is_shard(0) or pl.is_replicate()) for pl in pages):
        raise ValueError(f"decode on DTensors needs the pools laid out by "
                         f"pages alone; kpool is {pages}")
    vpool = laid_out_as(vpool, kpool)
    split = [pl.is_shard(0) for pl in pages]
    hd = [pl.is_shard(1) and not s for pl, s in zip(q.placements, split)]
    whole = (Replicate(),) * mesh.ndim
    q_pl = tuple(Shard(1) if h else Replicate() for h in hd)

    def lay(split_as, heads_dim):
        return tuple(split_as if s else Shard(heads_dim) if h else
                     Replicate() for s, h in zip(split, hd))
    parts, maxed, sums, out = (lay(Shard(0), 2), lay(Partial("max"), 1),
                               lay(Partial(), 1), lay(Replicate(), 1))
    G = q.shape[1] // kpool.shape[2]
    q = q.redistribute(placements=q_pl)
    heads, ids = _ids(q.shape[1], q, 1), _ids(kpool.shape[0], kpool, 0)

    def part(q, kp, vp, bt, lens, heads, ids):
        sel = heads[::_group(q.shape[1], G)] // G
        return tuple(t[None] for t in paged_partial(
            q, kp[:, :, sel], vp[:, :, sel], bt, lens, ids[0], window))
    m, l, acc = local_map(
        part, out_placements=(parts,) * 3,
        in_placements=(q_pl, pages, pages, whole, whole,
                       tuple(heads.placements), tuple(ids.placements)))(
        q, kpool, vpool, *(t.redistribute(placements=whole)
                           for t in (block_table, seq_lens)), heads, ids)
    top = local_map(lambda m: m[0], out_placements=(maxed,),
                    in_placements=(parts,))(m).redistribute(placements=out)

    def rescale(m, l, acc, top):
        w = torch.exp(m[0] - top)
        return l[0] * w, acc[0] * w[..., None]
    l, acc = (t.redistribute(placements=out) for t in local_map(
        rescale, out_placements=(sums, sums),
        in_placements=(parts, parts, parts, out))(m, l, acc, top))
    o = local_map(lambda l, acc: (acc / l[..., None]).to(q.dtype),
                  out_placements=(out,), in_placements=(out, out))(l, acc)
    return o.redistribute(placements=q_in)

"""The dry run's layouts that follow the reference's partition of the
step (ROADMAP Queue C 6–11), jax-free: decode's KV pool sharded over its
pages as the reference shards its per-row pool, with split-KV decoding
over the shards; prefill attention in the reference's online KV chunks;
the MoE dispatch moving token rows, not the batch; query heads that do
not divide "model" kept whole with the query rows split (the attention's
blocks, the mLSTM's runs of chunks); Mamba's ``x @ w_in`` in halves
sharded over "model"; decode's expert weights kept on their ranks; and
(ROADMAP Queue C 12) at one token row, which the data axes do not shard,
no weight gathered: each product, the embedding's lookup and the head on
the weights' own shards.  The numbers come from
four processes of a real gloo group on the CPU
(``tests/torch_dtensor_worker.py``) against the plain model; the bytes
from the dry run itself on a fake group."""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import CONFIGS
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.flash_attention.ref import (ATTN_TOL, KV_CHUNK,
                                                     flash_mha_ref,
                                                     masked_attn,
                                                     online_attn)
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_partial)
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.training.optim import tree_leaves
from test_torch_dtensor_numbers import run_ranks


@pytest.mark.parametrize("case", ["decode", "decode_window"])
def test_sharded_decode_equals_the_plain_decode_on_a_permuted_table(case):
    """Three f32 decode steps of qwen3-8b at smoke width on a (2, 2) gloo
    group, the block table a seeded permutation of the pages (a row's
    pages on any rank), the pools and lengths seeded (``decode_window``:
    a ring of 3 pages under a window of 96, past its wrap, the pages not
    split over "model"): the logits and the pools within f32 summation
    order, the lengths and tables equal, and each device holding its
    share of the pages (not the whole pool)."""
    out = run_ranks(case)
    assert out["logits_rel"] < 1e-5 and out["state_rel"] < 1e-6, out
    assert out["ints_equal"], out
    share = 4 if case == "decode" else 2        # data x model, or data
    assert out["pool_local"][2] == out["pages"] // share, out


def test_sharded_decode_in_bf16_is_the_plain_decode_to_rounding():
    """The same in bf16, the model's dtype: the logits within bf16
    partial sums reduced in another order (a page read from the wrong
    rank, or missed, moves them by their own size)."""
    out = run_ranks("decode_bf16")
    assert out["logits_rel"] < 3e-2 and out["state_rel"] < 3e-3, out
    assert out["ints_equal"], out


def test_moe_moves_rows_and_routes_as_the_plain_one():
    """phi3.5-moe's sublayer at smoke width, 16 token rows sharded over
    "data": the same expert ids and plan as the plain dispatch (one
    stable sort, one capacity), the outputs and the balance loss equal,
    every gradient (rows, router, experts) to bf16 rounding; the experts'
    buffer on each device its 2 of 4 experts and half of the slots (the
    capacity 11 rounded up to 12), not every slot of its experts."""
    out = run_ranks("moe_grad")
    assert out["routing_equal"], out
    assert out["rel"] < 1e-6 and out["aux"] < 1e-6, out
    assert out["grad_rel"] < 2e-2, out
    slots = -(-out["capacity"] // 2) * 2
    assert out["buffer_local"] == [[out["experts"] // 2, slots // 2,
                                    64]] * 2, out


def test_prefill_runs_the_online_chunks_shard_by_shard():
    """The prefill step of qwen3-8b at smoke width in f32 on DTensors:
    the plain ``forward``'s logits, each device's attention through
    ``online_attn`` on its row and its one KV head's group of two query
    heads."""
    out = run_ranks("prefill")
    assert out["logits_rel"] < 1e-5, out
    assert out["online_calls"] == [[1, 3 * KV_CHUNK, 1, 2, 16]] * 2, out


@pytest.mark.parametrize("attn", [online_attn, masked_attn],
                         ids=["online", "masked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 700])
def test_online_attn_equals_flash_mha_ref(dtype, window, attn):
    """``online_attn`` over three KV chunks (and ``masked_attn``, the
    same keys at once: the train step's blocks of query rows) against
    ``flash_mha_ref`` on the same GQA inputs, causal and windowed (the
    window across chunk boundaries), within ``ATTN_TOL``."""
    rng = np.random.default_rng(7)
    B, S, Hkv, G, D = 2, 3 * KV_CHUNK, 2, 2, 16
    dt = getattr(torch, dtype)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dt)
    q, k, v = draw(B, S, Hkv * G, D), draw(B, S, Hkv, D), draw(B, S, Hkv, D)
    pos = torch.arange(S).expand(B, S)
    got = attn(q.reshape(B, S, Hkv, G, D), k, v, pos, pos, window)
    want = flash_mha_ref(q, k, v, True, window)
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.reshape(B, S, Hkv * G, D).float(),
                               want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("window", [0, 20])
def test_split_kv_partials_combine_to_paged_attention(window):
    """``paged_partial`` over three ranges of a pool's pages, rescaled to
    their largest max and summed, is ``paged_attention_ref`` (a permuted table,
    rows of lengths 0 to full, and with ``window`` a ring past its wrap)."""
    g = torch.Generator().manual_seed(8)
    B, P, page, Hkv, G, D = 3, 4, 8, 2, 2, 16
    NP = B * P
    q = torch.randn((B, Hkv * G, D), generator=g)
    kp, vp = (torch.randn((NP, page, Hkv, D), generator=g) for _ in "kv")
    bt = torch.randperm(NP, generator=g).int().view(B, P)
    lens = torch.tensor([1, 17, P * page] if not window else
                        [1, 70, 3 * P * page + 5]).int()
    cuts = [0, 5, 9, NP]
    m, l, acc = (torch.stack(t) for t in zip(*(
        paged_partial(q, kp[a:b], vp[a:b], bt, lens, a, window)
        for a, b in zip(cuts, cuts[1:]))))
    w = torch.exp(m - m.amax(dim=0))              # the splits' combine
    got = (acc * w[..., None]).sum(0) / (l * w).sum(0)[..., None]
    want = paged_attention_ref(q, kp, vp, bt, lens, window)
    torch.testing.assert_close(got, want.float(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch,shape,axes", [
    ("qwen3-8b", "decode_32k", ("data", "model")),
    ("jamba-v0.1-52b", "decode_32k", ("data",)),     # a ring of 129 pages
    ("jamba-v0.1-52b", "long_500k", None),           # one row, 129 pages
])
def test_pool_specs_follow_the_references_rule(arch, shape, axes):
    """The pool's pages over the data axes of ``dp_for`` and then "model"
    where a row's pages divide by it: the reference's ``P(None, None, dp,
    mdl(pages), ...)`` on its per-row pool."""
    cfg = CONFIGS[arch].scaled(n_layers=CONFIGS[arch].hybrid_period or 1)
    B, S = st.SHAPES[shape]["batch"], st.SHAPES[shape]["seq"]
    with fake_world(256):
        mesh = make_production_mesh()
        state = st.abstract_decode_state(cfg, B, S)
        spec = sh.decode_state_specs(cfg, mesh, state)
    assert spec["kpool"] == spec["vpool"] == sh.P(None, None, axes, None,
                                                  None, None)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_decode_cell_arguments_are_the_spec_tables_arithmetic(multi_pod):
    """qwen3-8b ``decode_32k`` cut to one layer: the dry run's argument
    bytes a device are every input's bytes over the mesh sizes its spec
    names, the pools' over dp x tp (256 or 512), which halves them from
    16 x 16 to 2 x 16 x 16."""
    cfg = CONFIGS["qwen3-8b"].scaled(n_layers=1)
    res = DR.run_cell("qwen3-8b", "decode_32k", multi_pod, verbose=False,
                      n_layers=1)
    assert res["status"] == "OK", res
    B = st.SHAPES["decode_32k"]["batch"]
    inputs = st.input_specs(cfg, "decode_32k")
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        specs = {"params": sh.param_specs(cfg, mesh),
                 "state": sh.decode_state_specs(cfg, mesh, inputs["state"]),
                 "tokens": sh.tokens_spec(mesh, B)}
        size = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def share(t, spec):
        ways = math.prod(size[a] for e in spec if e is not None
                         for a in (e if isinstance(e, tuple) else (e,)))
        assert t.numel() % ways == 0
        return t.numel() * t.element_size() // ways
    pairs = list(_pairs(inputs, specs))
    pool = sum(share(t, s) for t, s in pairs if t.dim() == 6)
    whole = sum(t.numel() * t.element_size() for t, _ in pairs
                if t.dim() == 6)
    assert pool * math.prod(size.values()) == whole
    assert res["per_device"]["argument_bytes"] == sum(
        share(t, s) for t, s in pairs)
    assert len(pairs) == len(tree_leaves(inputs))


def _pairs(tree, specs):
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    elif isinstance(tree, list):
        for a, b in zip(tree, specs):
            yield from _pairs(a, b)
    else:
        yield tree, specs


def test_fake_world_moves_a_shard_with_one_all_to_all():
    """Inside ``fake_world`` DTensor's move of a shard from one dim to
    another (``Shard(0)`` -> ``Shard(1)`` over the 8-rank "model" dim)
    counts one all-to-all of the local size and no all-gather, and holds
    at most a few local sizes live, not the gathered whole (8 of them):
    the move a card's group makes, not the all-gather and chunk of a CPU
    mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    local = torch.empty((8, 64, 32), device="meta", dtype=torch.bfloat16)
    nbytes = local.numel() * local.element_size()
    with fake_world(16):
        mesh = init_device_mesh("cpu", (2, 8),
                                mesh_dim_names=("data", "model"))
        t = DTensor.from_local(local, mesh, (Replicate(), Shard(0)),
                               run_check=False)
        counter = DR._counter()
        with counter:
            moved = t.redistribute(placements=(Replicate(), Shard(1)))
        assert tuple(moved.to_local().shape) == (64, 8, 32)
    assert counter.coll == {"all-to-all": nbytes}, counter.coll
    assert counter.peak <= 4 * nbytes, (counter.peak, nbytes)


@pytest.mark.parametrize("case", ["loss_heads", "loss_mlstm", "loss_jamba"])
def test_uneven_heads_and_mamba_train_as_the_plain_model(case):
    """The loss and every gradient on a (2, 2) gloo group in f32 against
    the plain model: musicgen-medium at smoke width with 3 heads (the
    attention's query rows split over "model", which 3 heads do not
    divide), an mLSTM of one head over two chunks (each rank its own
    chunk, from the state the other's folds in), jamba at smoke width
    (Mamba's ``x @ w_in``, 256 columns over 2 ranks, split into halves
    each sharded over both; the MoE; the window).  The loss within the
    f32 limit of 1e-5; the gradients within 1e-3 (f32 partial sums
    reduced in another order read up to 1.8e-4, on the embedding; the
    Mamba scan's ``C`` gradient taken whole on every rank instead of
    summed read 0.77)."""
    out = run_ranks(case)
    assert out["loss_rel"] < 1e-5, out
    assert out["grad_rel"] < 1e-3, out


def test_uneven_heads_prefill_splits_the_query_rows():
    """The prefill of musicgen-medium at smoke width with 3 heads, f32, 3
    KV chunks on a (2, 2) group: the plain ``forward``'s logits, and each
    rank's ``online_attn`` queries its two blocks of 384 rows (block r and
    3 - r of 4) with all 3 heads, not every row."""
    out = run_ranks("prefill_heads")
    assert out["logits_rel"] < 1e-5, out
    # two layers, two blocks each: rows 384 = 3 * KV_CHUNK / 4
    assert out["online_calls"] == [[1, 3 * KV_CHUNK // 4, 3, 1, 16]] * 4, \
        out


def _recorded(run, op):
    """``run()`` under the dry run's counter on the open fake group, after
    a first run that fills DTensor's sharding caches (as the dry run warms
    up: DTensor derives a new operator signature's output on global-shaped
    tensors): the shapes of every ``op`` call's arguments, and the
    counter."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        run()
    counter = DR._counter()
    base = type(counter)
    calls = []

    class Recorder(base):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = base.__torch_dispatch__(self, func, types, args, kwargs)
            if out is not NotImplemented and func._overloadpacket is op:
                calls.append([tuple(a.shape) for a in args])
            return out
    counter.__class__ = Recorder
    with implicit_replication(), counter:
        run()
    return calls, counter


def test_mamba_w_in_gradient_is_the_local_shards_product():
    """jamba's Mamba sublayer at production width (d 4096, d_inner 8192)
    on a fake 16 x 16 world, 16 rows of 256 tokens: ``x @ w_in``'s
    halves stay sharded over "model", so the weight gradient's product is
    the local shard's, ``(4096, 1024)``, and no product reaches all
    2 * 8192 columns (the whole, 16x the share, read 56 such products a
    train step)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import dtensor as DT
    from repro_torch.models import core as M
    cfg = CONFIGS["jamba-v0.1-52b"]
    with fake_world(256):
        mesh = make_production_mesh()
        specs = sh.param_specs(cfg, mesh)["blocks"][2]
        params = sh.distribute(mesh, M._mamba_params(None, cfg, 1), specs)
        w_in = params["w_in"].requires_grad_(True)
        x = distribute_tensor(
            torch.empty((16, 256, cfg.d_model), device="meta",
                        dtype=torch.bfloat16), mesh, (Shard(0), Replicate()))

        def run():
            p = DT.for_use([{n: DT.unbind(t)[0]
                             for n, t in params.items()}])[0]
            out, _ = M.mamba(p, cfg, DT.tp_in(x))
            torch.autograd.grad(DT.summed(out).float().sum(), [w_in])
        calls, _ = _recorded(run, torch.ops.aten.mm)
    outs = [(a[0], b[1]) for a, b in calls]
    assert (cfg.d_model, 2 * cfg.d_inner // 16) in outs, outs
    assert all(2 * cfg.d_inner not in a + b for a, b in calls), calls


def test_decode_experts_stay_on_their_ranks():
    """jamba's MoE sublayer at a decode step's 128 token rows (sharded
    over "data") on a fake 16 x 16 world: its expert weights are not
    gathered for the step (fewer rows than a weight's 4096), so every
    expert product reads the local expert's weight shard, ``(1, 256,
    14336)`` or ``(1, 14336, 256)``, and the step all-gathers no weight
    (the parent's read 117 MB a weight)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import dtensor as DT
    from repro_torch.models import core as M
    cfg = CONFIGS["jamba-v0.1-52b"]
    B = st.SHAPES["decode_32k"]["batch"]
    with fake_world(256):
        mesh = make_production_mesh()
        specs = sh.param_specs(cfg, mesh)["blocks"][3]
        params = sh.distribute(mesh, M._moe_params(None, cfg, 1), specs)
        x = distribute_tensor(
            torch.empty((B, cfg.d_model), device="meta",
                        dtype=torch.bfloat16), mesh, (Shard(0), Replicate()))

        def run():
            p = DT.for_use([{n: DT.unbind(t)[0]
                             for n, t in params.items()}], rows=x)[0]
            with torch.no_grad():
                M.moe(p, cfg, x)
        calls, counter = _recorded(run, torch.ops.aten.bmm)
    d, ff = cfg.d_model // 16, cfg.moe_d_ff
    assert sorted(w for _, w in calls) == [(1, d, ff), (1, d, ff),
                                           (1, ff, d)], calls
    assert counter.coll.get("all-gather", 0) < 1 << 20, counter.coll


@pytest.mark.parametrize("case", ["decode_row", "decode_row_bf16"])
def test_one_row_decodes_as_the_plain_decode(case):
    """Three decode steps of one row (batch 1: the data axes do not shard
    it) of qwen3-8b, jamba (Mamba, MoE, the windowed ring) and xlstm-350m
    (mLSTM, sLSTM) at smoke width on a (2, 2) gloo group, no weight
    gathered, against the plain decode from the same seeded state.  f32:
    the logits and every float of the state within the f32 summation
    order of :func:`test_sharded_decode_equals_the_plain_decode_on_a_\
permuted_table`.  bf16: the logits within its bf16 limit, the state
    within 3e-2 (the recurrent states carry the rounding of the bf16
    projections that feed them: up to 1.4e-2 on the route that gathers
    the weights at 4 rows, 1.4e-2 here; a partial sum reduced over the
    wrong ranks moves them by their own size)."""
    out = run_ranks(case)
    logits, states = (1e-5, 1e-6) if case == "decode_row" else (3e-2, 3e-2)
    for arch, o in out.items():
        assert o["logits_rel"] < logits and o["state_rel"] < states, \
            (arch, o)
        assert o["ints_equal"] and o["gathers"] == 0, (arch, o)


def _cell_calls(arch, shape, layers, ops):
    """The dry run's cell on 16 x 16 cut to ``layers``, and the argument
    shapes and dtype of every ``ops`` call of its counted run, by op."""
    counter, calls = DR._counter, {}

    def recording():
        c = counter()
        base = type(c)

        class Recorder(base):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = base.__torch_dispatch__(self, func, types, args,
                                              kwargs)
                if out is not NotImplemented and func._overloadpacket in ops:
                    calls.setdefault(func._overloadpacket, []).append(
                        (tuple(tuple(a.shape) for a in args
                               if isinstance(a, torch.Tensor)), args[0].dtype))
                return out
        c.__class__ = Recorder
        return c
    DR._counter = recording
    try:
        rep = DR.run_cell(arch, shape, False, verbose=False, n_layers=layers)
    finally:
        DR._counter = counter
    assert rep["status"] == "OK", rep
    return rep, calls


@pytest.mark.parametrize("arch, layers, weights, table, head", [
    # Mamba's w_in, the MLP's w_gate/w_in and w_out, Mamba's w_out
    pytest.param("jamba-v0.1-52b", 8, [(256, 1024), (256, 896), (896, 256),
                                       (512, 256)], (4096, 256), (256, 4096),
                 id="jamba"),
    # the mLSTM's and sLSTM's (d, d), the MLP's w_gate/w_in and w_out
    pytest.param("xlstm-350m", 2, [(64, 64), (64, 256), (256, 64)],
                 (3144, 64), (64, 3144), id="xlstm")])
def test_one_row_contracts_on_the_weights_own_shards(arch, layers, weights,
                                                     table, head):
    """``long_500k``'s one decode row on a fake 16 x 16 world at production
    width: every bf16 product reads its weight's local shard, ``(d / 16,
    n / 16)`` (none reads the whole width ``d``), the embedding looks the
    token up in the table's own ``(vocab / 16, d / 16)`` shard, the head
    contracts its ``(d / 16, vocab / 16)`` shard, and the step all-gathers
    under 1 MiB a device (the weights gathered over the data axes read
    10.8 MB at xlstm-350m's 2 layers, 216 MB at jamba's 8)."""
    d = CONFIGS[arch].d_model
    rep, calls = _cell_calls(arch, "long_500k", layers,
                             (torch.ops.aten.mm, torch.ops.aten.embedding))
    mm = [w for (_, w), dt in calls[torch.ops.aten.mm]
          if dt == torch.bfloat16]
    assert all(w[0] != d for w in mm), mm
    assert set(weights + [head]) <= set(mm), mm
    assert [a[0] for a, _ in calls[torch.ops.aten.embedding]] == [table]
    assert rep["collective_bytes_per_device"]["all-gather"] < 1 << 20, rep


def test_many_rows_still_gather_the_dense_weights():
    """At ``decode_32k``'s 128 rows, which the data axes shard, the dense
    weights are gathered for the step as the reference's program gathers
    them there (jamba at one period on 16 x 16): the products read
    weights whole over the width, ``(4096, n / 16)``, and the embedding
    the table's rows gathered over the data axes, ``(4096, 4096)``."""
    _, calls = _cell_calls("jamba-v0.1-52b", "decode_32k", 8,
                           (torch.ops.aten.mm, torch.ops.aten.embedding))
    mm = {w for (_, w), dt in calls[torch.ops.aten.mm]
          if dt == torch.bfloat16}
    assert {(4096, 1024), (4096, 896)} <= mm, mm
    assert [a[0] for a, _ in calls[torch.ops.aten.embedding]] == \
        [(4096, 4096)]

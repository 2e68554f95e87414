"""One rank of a real (gloo, CPU) process group that runs a model piece on
DTensors laid out by the dry run's sharding rules and holds it against
the plain piece on the whole tensors; the helper of
``tests/test_torch_dtensor_numbers.py``.  Jax-free.

    python tests/torch_dtensor_worker.py RANK WORLD PORT CASE

Every rank builds the same seeded inputs; rank 0 prints one JSON line of
the comparison.  Cases: ``loss`` (qwen3-8b at smoke width: ``loss_fn``
and its gradients on a (2, 2) mesh against the plain ones), ``moe``
(the MoE dispatch of decode's token rows sharded over "data" against the
plain dispatch of the gathered rows), ``moe_grad`` (the same with
gradients, the routing and the experts' buffer's layout), ``decode`` and
``decode_window`` (three f32 decode steps over a permuted block table
against the plain ``decode_step``; the pool's local shape),
``decode_bf16`` (the same in bf16), ``decode_row`` and
``decode_row_bf16`` (one row of qwen3-8b, jamba and xlstm-350m, f32 and
bf16), ``prefill`` (f32 prefill logits);
``loss_heads`` and ``prefill_heads`` (the same two where the query heads
do not divide the "model" axis), ``loss_mlstm`` (an mLSTM whose heads do
not), ``loss_jamba`` (jamba at smoke width: Mamba, MoE, the window).
"""
from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import CONFIGS  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.models import core as M  # noqa: E402
from repro_torch.training.optim import tree_leaves, tree_map  # noqa: E402


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def case_loss(mesh, cfg=None, B=4, S=32, dtype=torch.bfloat16):
    """``loss_fn`` and ``autograd.grad`` on DTensors against the plain
    ones (qwen3-8b at smoke width, or ``cfg`` on ``B`` rows of ``S``
    tokens, the weights in ``dtype``): the loss's relative gap and each
    leaf's relative L2 gap."""
    cfg = cfg or CONFIGS["qwen3-8b"].smoke()
    params = tree_map(lambda t: t.to(dtype) if t.is_floating_point() and
                      t.dtype != torch.float32 else t,
                      M.init_params(cfg, 0, device="cpu"))
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g)
    labels = torch.randint(0, cfg.vocab, (B, S), generator=g)
    labels[0, :5] = -1
    batch = {"tokens": tokens.int(), "labels": labels.int()}
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    want = M.loss_fn(cfg, params, batch, impl="ref")
    want_g = torch.autograd.grad(want, leaves)
    dparams = sh.distribute(mesh, tree_map(lambda t: t.detach(), params),
                            sh.param_specs(cfg, mesh))
    dleaves = tree_leaves(dparams)
    for p in dleaves:
        p.requires_grad_(True)
    dbatch = sh.distribute(mesh, batch, sh.batch_specs(cfg, mesh))
    act = sh.P(sh.dp_axis(mesh), "model", None)
    got = M.loss_fn(cfg, dparams, dbatch, impl="ref", act_spec=act)
    got_g = torch.autograd.grad(got, dleaves)
    return {"loss": float(want), "loss_rel": abs(float(full(got)) -
                                                 float(want)) / float(want),
            "grad_rel": max(rel(full(a), b) for a, b in zip(got_g, want_g)),
            "grad_rels": [rel(full(a), b) for a, b in zip(got_g, want_g)]}


def case_moe(mesh):
    """The MoE dispatch of 8 decode rows sharded over "data" (the
    experts' weights as the spec lays them out) against the plain
    dispatch: the same routing (output rows equal up to bf16 rounding of
    the sharded products) and the same balance loss."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    cfg = CONFIGS["phi3.5-moe-42b-a6.6b"].smoke()
    params = M.init_params(cfg, 0, device="cpu")
    p = {n: w[0] for n, w in params["blocks"][1].items()}
    specs = sh.param_specs(cfg, mesh)["blocks"][1]
    g = torch.Generator().manual_seed(2)
    x = torch.randn((8, cfg.d_model), generator=g).to(torch.bfloat16)
    want, want_aux = M.moe(p, cfg, x)
    dp = {n: distribute_tensor(
        params["blocks"][1][n], mesh, sh.placements(mesh, specs[n]))
        for n in p}
    dp = {n: w[0] for n, w in dp.items()}
    rows = [Shard(0) if n == "data" else Replicate()
            for n in mesh.mesh_dim_names]
    dx = distribute_tensor(x, mesh, rows)
    got, got_aux = M.moe(dp, cfg, dx)
    got = full(got)
    C = int(cfg.capacity_factor * 8 * cfg.top_k / cfg.n_experts) + 1
    from repro_torch.distributed import dtensor as DT
    plans = [M.dispatch_plan(DT.local_value(M.route(q, cfg, t)[1]),
                             cfg.n_experts, C)
             for q, t in ((p, x), (dp, dx))]
    return {"routing_equal": all(torch.equal(full(a), b) for a, b in
                                 zip(plans[1], plans[0])),
            "rel": rel(got, want), "aux": abs(float(full(got_aux)) -
                                              float(want_aux)),
            "max_abs": float((got.float() - want.float()).abs().max()),
            "max_want": float(want.float().abs().max())}


def _decode(mesh, window, dtype, arch="qwen3-8b", B=4):
    """Three decode steps of ``arch`` (qwen3-8b) at smoke width on
    DTensors laid out by the dry run's spec table against the plain
    ``decode_step``, from the same state: the weights and the state in
    ``dtype`` where it is f32 (the two routes differ only in the order of
    f32 sums), the model's own dtypes otherwise; every float of the state
    (the pools, the recurrent states) filled with seeded values, the
    lengths seeded (past the ring's wrap under a window), the block table
    a seeded permutation of the pages.  Returns the largest relative gap
    of the logits and of the state after each step, the pool's local
    shape, whether every integer of the state is equal, and how many
    weights were gathered over the data axes (``DT.gathered``)."""
    from repro_torch.distributed import dtensor as DT
    cfg = CONFIGS[arch].smoke()
    if window:
        cfg = cfg.scaled(sliding_window=window)
    f32 = dtype == torch.float32
    params = tree_map(lambda t: t.to(dtype) if f32 else t,
                      M.init_params(cfg, 0, device="cpu"))
    S = 256
    g = torch.Generator().manual_seed(3)
    state = M.make_decode_state(cfg, B, S, device="cpu")
    floats = [n for n, t in state.items() if t.is_floating_point()]
    for name in floats:
        state[name] = torch.randn(state[name].shape, generator=g).to(
            dtype if f32 else state[name].dtype)
    if "kpool" in state:
        NP = state["kpool"].shape[2]
        state["block_tables"].copy_(torch.randperm(NP, generator=g).int()
                                    .view(B, -1))
    top = S + 64 if cfg.sliding_window else S - 8
    state["seq_lens"].copy_(torch.randint(0, top, (B,), generator=g).int())
    dstate = sh.distribute(mesh, tree_map(lambda t: t.clone(), state),
                           sh.decode_state_specs(cfg, mesh, state))
    dparams = sh.distribute(mesh, params, sh.param_specs(cfg, mesh))
    logits, states, ints = [], [], True
    gathers, real = [], DT._Gather.apply

    def gather(w):
        gathers.append(tuple(w.shape))
        return real(w)
    DT._Gather.apply = gather
    try:
        for _ in range(3):
            tokens = torch.randint(0, cfg.vocab, (B,), generator=g)
            want, _ = M.decode_step(cfg, params, state, tokens, impl="ref")
            got, _ = M.decode_step(cfg, dparams, dstate, sh.distribute(
                mesh, tokens, sh.tokens_spec(mesh, B)), impl="ref")
            logits.append(rel(full(got), want))
            states.append(max(rel(full(dstate[n]), state[n])
                              for n in floats))
            ints = ints and all(torch.equal(full(dstate[n]), state[n])
                                for n in ("seq_lens", "block_tables"))
    finally:
        DT._Gather.apply = real
    out = {"logits_rel": max(logits), "state_rel": max(states),
           "ints_equal": ints, "gathers": len(gathers)}
    if "kpool" in state:
        out.update(pages=NP, pool_local=list(dstate["kpool"].to_local()
                                             .shape))
    return out


def case_decode(mesh):
    return _decode(mesh, 0, torch.float32)


def case_decode_window(mesh):
    return _decode(mesh, 96, torch.float32)


def case_decode_bf16(mesh):
    return _decode(mesh, 0, torch.bfloat16)


#: the families :func:`case_decode_row` decodes one row of: dense, hybrid
#: (Mamba, MoE, the windowed ring), xLSTM (mLSTM, sLSTM)
ROW_ARCHS = ("qwen3-8b", "jamba-v0.1-52b", "xlstm-350m")


def case_decode_row(mesh, dtype=torch.float32):
    """:func:`_decode` of one row (batch 1, which the data axes do not
    shard: no weight gathered, each product on the weights' own shards)
    for each of ``ROW_ARCHS``, by arch."""
    return {arch: _decode(mesh, 0, dtype, arch, B=1) for arch in ROW_ARCHS}


def case_decode_row_bf16(mesh):
    return case_decode_row(mesh, torch.bfloat16)


def case_moe_grad(mesh):
    """The MoE sublayer on 16 token rows sharded over "data", its weights
    laid out by the spec table and gathered for the use as a scan step
    gathers them, against the plain sublayer: each call's expert ids
    (``dispatch_plan``'s input) and plan equal, the outputs, the balance
    loss and every gradient (the rows' and each weight's) to bf16
    rounding; and the experts' buffer's local shape."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import dtensor as DT
    cfg = CONFIGS["phi3.5-moe-42b-a6.6b"].smoke()
    params = M.init_params(cfg, 0, device="cpu")
    p = {n: w[0].clone() for n, w in params["blocks"][1].items()}
    specs = sh.param_specs(cfg, mesh)["blocks"][1]
    g = torch.Generator().manual_seed(4)
    x = torch.randn((16, cfg.d_model), generator=g).to(torch.bfloat16)
    probe = torch.randn((16, cfg.d_model), generator=g)
    plans, bufs = [], []
    real_plan, real_buf = M.dispatch_plan, DT.by_expert

    def plan(idx, E, C):
        out = real_plan(idx, E, C)
        plans.append((idx.clone(), *(t.clone() for t in out)))
        return out

    def by_expert(buf, w):
        out = real_buf(buf, w)
        if DT.is_dtensor(out):
            bufs.append(list(out.to_local().shape))
        return out
    M.dispatch_plan, DT.by_expert = plan, by_expert

    def run(p, x):
        leaves = [x] + [p[n] for n in ("router", "w_gate", "w_in", "w_out")]
        for t in leaves:
            t.requires_grad_(True)
        y, aux = M.moe(p, cfg, x)
        y = DT.summed(y)
        loss = (y.float() * probe).sum() + aux
        return y, aux, torch.autograd.grad(loss, leaves)
    try:
        want, want_aux, want_g = run(p, x.clone())
        dp = {n: distribute_tensor(params["blocks"][1][n], mesh,
                                   sh.placements(mesh, specs[n]))
              for n in p}
        dp = DT.for_use([{n: DT.unbind(w)[0] for n, w in dp.items()}])[0]
        rows = [Shard(0) if n == "data" else Replicate()
                for n in mesh.mesh_dim_names]
        dx = distribute_tensor(x.clone(), mesh, rows)
        got, got_aux, got_g = run(dp, dx)
    finally:
        M.dispatch_plan, DT.by_expert = real_plan, real_buf
    C = int(cfg.capacity_factor * 16 * cfg.top_k / cfg.n_experts) + 1
    return {"routing_equal": len(plans) == 2 and all(
        torch.equal(a, b) for a, b in zip(*plans)),
            "rel": rel(full(got), want),
            "aux": abs(float(full(got_aux)) - float(want_aux)),
            "grad_rel": max(rel(full(a), b) for a, b in zip(got_g, want_g)),
            "buffer_local": bufs, "experts": cfg.n_experts, "capacity": C}


#: smoke widths whose heads do not divide the (2, 2) group's "model" axis
#: of 2: musicgen-medium's attention with 3 heads (48 columns, 24 a rank)
UNEVEN = CONFIGS["musicgen-medium"].smoke().scaled(n_heads=3, n_kv_heads=3)
#: and xlstm-350m's mLSTM with one head of 64 (32 columns a rank)
UNEVEN_MLSTM = CONFIGS["xlstm-350m"].smoke().scaled(n_heads=1)


def case_loss_heads(mesh):
    """:func:`case_loss` where the query heads do not divide "model": the
    attention's rows split over it (two blocks a rank, each against its
    keys)."""
    return case_loss(mesh, UNEVEN, dtype=torch.float32)


def case_loss_mlstm(mesh):
    """:func:`case_loss` of an mLSTM whose heads do not divide "model",
    over two chunks of 256 rows: each rank runs its own chunk from the
    state its predecessor's chunk folds in."""
    return case_loss(mesh, UNEVEN_MLSTM, B=2, S=512, dtype=torch.float32)


def case_loss_jamba(mesh):
    """:func:`case_loss` of jamba at smoke width: the Mamba sublayer's
    ``x @ w_in`` (256 columns over 2 ranks) split into halves each sharded
    over both ranks, the MoE and the windowed attention."""
    return case_loss(mesh, CONFIGS["jamba-v0.1-52b"].smoke(),
                     dtype=torch.float32)


def case_prefill(mesh, cfg=None):
    """The prefill step (``forward`` without autograd: the attention's
    online KV chunks shard by shard) of qwen3-8b (or ``cfg``) at smoke
    width, f32, on DTensors laid out by the spec table, against the plain
    ``forward``: the logits' relative gap, over a sequence of three KV
    chunks, and the local query shapes ``online_attn`` ran on."""
    from repro_torch.kernels.flash_attention import ref as FR
    cfg = cfg or CONFIGS["qwen3-8b"].smoke()
    params = tree_map(lambda t: t.float(),
                      M.init_params(cfg, 0, device="cpu"))
    g = torch.Generator().manual_seed(5)
    S = 3 * FR.KV_CHUNK
    tokens = torch.randint(0, cfg.vocab, (2, S), generator=g).int()
    act = sh.P(sh.dp_axis(mesh), "model", None)
    calls, real = [], FR.online_attn

    def online(q, *rest):
        calls.append(list(q.shape))
        return real(q, *rest)
    FR.online_attn = online
    try:
        with torch.no_grad():
            want, _ = M.forward(cfg, params, tokens, impl="ref")
            got, _ = M.forward(cfg, sh.distribute(
                mesh, params, sh.param_specs(cfg, mesh)), sh.distribute(
                    mesh, tokens, sh.P(sh.dp_axis(mesh), None)),
                impl="ref", act_spec=act)
    finally:
        FR.online_attn = real
    return {"logits_rel": rel(full(got), want), "online_calls": calls}


def case_prefill_heads(mesh):
    """:func:`case_prefill` where the query heads do not divide "model"."""
    return case_prefill(mesh, UNEVEN)


def main():
    rank, world, port, case = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, world // 2),
                                mesh_dim_names=("data", "model"))
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():         # as the dry run runs
            out = {"loss": case_loss, "moe": case_moe,
                   "decode": case_decode,
                   "decode_window": case_decode_window,
                   "decode_bf16": case_decode_bf16,
                   "decode_row": case_decode_row,
                   "decode_row_bf16": case_decode_row_bf16,
                   "prefill": case_prefill,
                   "prefill_heads": case_prefill_heads,
                   "loss_heads": case_loss_heads,
                   "loss_mlstm": case_loss_mlstm,
                   "loss_jamba": case_loss_jamba,
                   "moe_grad": case_moe_grad}[case](mesh)
        if rank == 0:
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

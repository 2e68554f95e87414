"""One rank of a real (gloo, CPU) process group that runs a model piece on
DTensors laid out by the dry run's sharding rules and holds it against
the plain piece on the whole tensors; the helper of
``tests/test_torch_dtensor_numbers.py``.  Jax-free.

    python tests/torch_dtensor_worker.py RANK WORLD PORT CASE

Every rank builds the same seeded inputs; rank 0 prints one JSON line of
the comparison.  Cases: ``loss`` (qwen3-8b at smoke width: ``loss_fn``
and its gradients on a (2, 2) mesh against the plain ones), ``moe``
(the MoE dispatch of decode's token rows sharded over "data" against the
plain dispatch of the gathered rows).
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


def case_loss(mesh):
    """``loss_fn`` and ``autograd.grad`` on DTensors against the plain
    ones: the loss's relative gap and each leaf's relative L2 gap."""
    cfg = CONFIGS["qwen3-8b"].smoke()
    params = M.init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 32), generator=g)
    labels = torch.randint(0, cfg.vocab, (4, 32), generator=g)
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
            "grad_rel": max(rel(full(a), b) for a, b in zip(got_g, want_g))}


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
    plans = [M.dispatch_plan(M.route(q, cfg, t)[1], cfg.n_experts, C)
             for q, t in ((p, x), (dp, dx))]
    return {"routing_equal": all(torch.equal(full(a), b) for a, b in
                                 zip(plans[1], plans[0])),
            "rel": rel(got, want), "aux": abs(float(full(got_aux)) -
                                              float(want_aux)),
            "max_abs": float((got.float() - want.float()).abs().max()),
            "max_want": float(want.float().abs().max())}


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
            out = {"loss": case_loss, "moe": case_moe}[case](mesh)
        if rank == 0:
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

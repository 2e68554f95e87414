"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on
storage-free tensors laid out on the production mesh — the port of
:mod:`repro.launch.dryrun`, without hardware.

Proves the distribution config is coherent: for each cell the step
function runs once on ``meta`` tensors (shapes and dtypes, no storage,
no computation: the reference's ``ShapeDtypeStruct``s), distributed by the
sharding rules (:mod:`repro_torch.distributed.sharding`) as DTensors over
a fake process group of 256 or 512 ranks
(:func:`repro_torch.launch.mesh.fake_world`).  That run is the port's
``.lower().compile()``: DTensor propagates every operator's sharding and
issues the collectives a real mesh would, so a cell whose step cannot be
laid out fails here, with the operator named, as a reference cell fails
to lower.  The step takes the plain route by name (``impl="ref"``: the
attention is ``flash_mha``'s plain version and decode's
``paged_attention``'s, shard by shard): the reference's dry run traces
``models/core.py``, which calls no Pallas kernel either.  What the model
builds itself (masks, positions) lands on the ``meta`` device too.

A first run (``lower_s``) of the same cell cut to one scan step fills
DTensor's sharding caches: DTensor derives each new operator signature's
output shape by running it once on global-shaped tensors, which must not
count as a device's work, and every scan step and microbatch repeats the
first one's signatures.  The second run (``compile_s``), of the whole
cell, is counted, one device's view:

* ``per_device.argument_bytes``: the local shards of every input, exactly;
* ``per_device.peak_bytes``: the arguments plus the peak of the storage
  the step allocates (``torch.distributed._tools.mem_tracker``);
* ``hlo_flops_per_device``: ``torch.utils.flop_counter``'s formulas on
  the operators each device runs on its local shards (a counter that
  steps aside for DTensor operators and sees what DTensor runs locally —
  ``FlopCounterMode`` above a DTensor counts the global operator);
* ``collective_bytes_per_device``: the output bytes of every functional
  collective a device issues (``_c10d_functional``), by kind, as the
  reference sums collectives' output shapes.  The fake group lowers an
  all-to-all as an all-gather and a chunk: it is counted as the
  all-gather;
* ``trip_mult`` is 1: the run executes every layer and microbatch, where
  XLA counts a ``while`` body once and the reference multiplies.

The roofline divides by one NVIDIA H100 SXM's rates from NVIDIA's data
sheet (dense bf16 tensor cores, HBM3, and NVLink 4 at 450 GB/s each way),
never the reference's TPU constants.  ``chip_smoke.py`` prints the card's
measured bf16 GEMM and HBM copy rates beside them.

Usage:
  python -m repro_torch.launch.dryrun [--arch qwen3-8b] [--shape train_4k]
      [--multi-pod] [--both-meshes] [--all] [--out results.json]
      [--variant baseline|tp_serve|dp_only|microN]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from ..configs import CONFIGS
from ..distributed import sharding as sh
from . import steps as st
from .mesh import fake_world, make_production_mesh

# NVIDIA H100 SXM, NVIDIA's data sheet (dense, no sparsity)
PEAK_FLOPS = 989e12          # bf16 tensor cores / GPU
HBM_BW = 3.35e12             # B/s HBM3 per GPU
LINK_BW = 450e9              # B/s NVLink 4 per GPU, one direction

#: the functional collectives a device issues, by the reference's names
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}


def _counter():
    """A dispatch mode that counts what one device runs: it steps aside
    for DTensor operators (returns ``NotImplemented``, so DTensor runs
    them) and sees the operators DTensor runs on the local shards and the
    collectives it issues."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Local(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.coll = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            kind = _COLLECTIVES.get(func._overloadpacket.__name__)
            if kind is not None and func.namespace == "_c10d_functional":
                self.coll[kind] = (self.coll.get(kind, 0) +
                                   out.numel() * out.element_size())
            return out
    return Local()


def _local_bytes(tree):
    from ..training.optim import tree_leaves
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree))


def _cell(cfg, shape: str, mesh, variant: str):
    """The cell's step function and its ``meta`` inputs laid out on
    ``mesh``, and the number of microbatches."""
    specs = st.input_specs(cfg, shape)
    kind = st.SHAPES[shape]["kind"]
    policy = variant if variant in ("dp_only", "tp_only") else "fsdp_tp"
    act_spec = sh.P(sh.dp_axis(mesh), "model", None) \
        if policy != "dp_only" else None
    n_micro = 8 if st.SHAPES[shape]["batch"] >= 8 * sh.dp_size(mesh) else 1
    if variant.startswith("micro"):
        n_micro = int(variant[5:])
    if kind == "train":
        fn = st.make_train_step(cfg, n_micro=n_micro, act_spec=act_spec,
                                impl="ref")
        pspec = sh.param_specs(cfg, mesh, policy=policy)
        args = (sh.distribute(mesh, specs["params"], pspec),
                sh.distribute(mesh, specs["opt_state"],
                              {"m": pspec, "v": pspec, "step": sh.P()}),
                sh.distribute(mesh, specs["batch"], sh.batch_specs(
                    cfg, mesh, "prefix_embeds" in specs["batch"],
                    policy=policy)))
    elif kind == "prefill":
        fn = st.make_prefill_step(cfg, act_spec=act_spec, impl="ref")
        bspec = {"tokens": sh.P(sh.dp_axis(mesh), None)}
        if "prefix_embeds" in specs["batch"]:
            bspec["prefix_embeds"] = sh.P(sh.dp_axis(mesh), None, None)
        args = (sh.distribute(mesh, specs["params"],
                              sh.param_specs(cfg, mesh, policy=policy)),
                sh.distribute(mesh, specs["batch"], bspec))
    else:
        fn = st.make_decode_step(cfg, impl="ref")
        args = (sh.distribute(mesh, specs["params"],
                              sh.param_specs(cfg, mesh,
                                             fsdp=variant != "tp_serve",
                                             policy=policy)),
                sh.distribute(mesh, specs["state"],
                              sh.decode_state_specs(cfg, mesh,
                                                    specs["state"])),
                sh.distribute(mesh, specs["tokens"],
                              sh.P(sh.dp_for(
                                  mesh, st.SHAPES[shape]["batch"]))))
    return fn, args, n_micro


def lower(cfg, shape: str, mesh, variant: str = "baseline") -> dict:
    """Run the cell's step on ``mesh`` (a DeviceMesh with the production
    axis names over an open fake group) and count it; the report's body."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models.core import n_scan_steps
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    kind = st.SHAPES[shape]["kind"]
    one_step = cfg.scaled(n_layers=cfg.n_layers // n_scan_steps(cfg))
    warm_fn, warm_args, _ = _cell(one_step, shape, mesh, variant)
    t0 = time.time()
    with implicit_replication():
        warm_fn(*warm_args)
    t_lower = time.time() - t0
    del warm_args
    fn, args, n_micro = _cell(cfg, shape, mesh, variant)
    arg_bytes = _local_bytes(args)
    counter, mem = _counter(), MemTracker()
    t0 = time.time()
    with implicit_replication(), mem, counter:
        fn(*args)
    t_compile = time.time() - t0
    temp = sum(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    flops = float(counter.flops)
    coll = dict(sorted(counter.coll.items()))
    res = {
        "status": "OK", "variant": variant,
        "n_chips": int(mesh.size()),
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "per_device": {"argument_bytes": arg_bytes, "temp_bytes": temp,
                       "peak_bytes": arg_bytes + temp},
        "hlo_flops_per_device": flops,
        "collective_bytes_per_device": coll,
        "scan_trip_count": n_scan_steps(cfg), "trip_mult": 1,
        "n_micro": n_micro if kind == "train" else 1,
        "mesh_shape": sizes,
    }
    res["roofline"] = {
        "compute_s": flops / PEAK_FLOPS,
        # every argument read once, the step's temporaries written once
        "memory_s": (arg_bytes + temp) / HBM_BW,
        "collective_s": sum(coll.values()) / LINK_BW,
    }
    res["roofline"]["dominant"] = max(res["roofline"],
                                      key=res["roofline"].get)
    return res


def run_cell(arch: str, shape: str, multi_pod: bool,
             verbose: bool = True, variant: str = "baseline") -> dict:
    """variant: baseline | tp_serve (decode without FSDP param gathers) |
    dp_only (no tensor parallelism) | microN (train grad-accum N)."""
    cfg = CONFIGS[arch]
    ok, why = st.cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "status": why}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        res = {"arch": arch, "shape": shape,
               "mesh": "2x16x16" if multi_pod else "16x16",
               **lower(cfg, shape, mesh, variant)}
    if verbose:
        r = res["roofline"]
        print(f"[{res['mesh']}] {arch:26s} {shape:12s} "
              f"compile={res['compile_s']:6.1f}s peak/dev="
              f"{res['per_device']['peak_bytes']/2**30:7.2f}GiB "
              f"comp={r['compute_s']*1e3:8.2f}ms "
              f"mem={r['memory_s']*1e3:8.2f}ms "
              f"coll={r['collective_s']*1e3:8.2f}ms  dom={r['dominant']}",
              flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(CONFIGS)
    shapes = [args.shape] if args.shape else list(st.SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(run_cell(arch, shape, mp,
                                            variant=args.variant))
                except Exception as e:  # noqa: BLE001 - report, keep going
                    results.append({"arch": arch, "shape": shape,
                                    "mesh": "2x16x16" if mp else "16x16",
                                    "status": f"FAIL: {type(e).__name__}: "
                                              f"{str(e)[:300]}"})
                    print(results[-1], file=sys.stderr, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if r["status"].startswith("FAIL")]
    print(f"dry-run: {len(results)} cells, {len(bad)} failures", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

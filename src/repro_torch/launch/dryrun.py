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
attention is ``flash_mha``'s plain version, in prefill the reference's
online KV chunks, and decode's ``paged_attention``'s split over the
pages each device holds, shard by shard): the reference's dry run traces
``models/core.py``, which calls no Pallas kernel either.  What the model
builds itself (masks, positions) lands on the ``meta`` device too.

A first run (``lower_s``) of the same cell cut to one scan step fills
DTensor's sharding caches: DTensor derives each new operator signature's
output shape by running it once on global-shaped tensors, which must not
count as a device's work, and every scan step and microbatch repeats the
first one's signatures.  The second run (``compile_s``), of the whole
cell, is counted, one device's view:

* ``per_device.argument_bytes``: the local shards of every input, exactly
  (of a decode cell with attention, ``kv_pool_bytes`` those of the KV
  pools);
* ``per_device.peak_bytes``: the arguments plus ``temp_bytes``, the most
  bytes of storage the operators a device runs hold live at once (the
  counter below tracks each storage they allocate until it is freed; the
  same on ``meta`` and fake tensors, where ``torch.distributed._tools.
  mem_tracker`` reads more on ``meta`` tensors on torch 2.11);
* ``hlo_flops_per_device``: ``torch.utils.flop_counter``'s formulas on
  the operators each device runs on its local shards (a counter that
  steps aside for DTensor operators and sees what DTensor runs locally —
  ``FlopCounterMode`` above a DTensor counts the global operator);
* ``collective_bytes_per_device``: the output bytes of every functional
  collective a device issues (``_c10d_functional``), by kind, as the
  reference sums collectives' output shapes (DTensor's move of a shard
  to another dim is one all-to-all of the local size inside
  :func:`~repro_torch.launch.mesh.fake_world`, where a CPU mesh would
  gather the whole dim);
* ``trip_mult`` is 1: the run executes every layer and microbatch, where
  XLA counts a ``while`` body once and the reference multiplies.  The one
  loop it does not execute whole is the sLSTM's time loop, a Python loop
  of ``S`` identical trips on ``(B, d)`` states (32 768 trips a layer in
  ``prefill_32k``): it runs two trips and counts the second ``S - 1``
  times, the reference's rule for a loop body, and holds the bytes the
  second leaves live for the backward ``S - 2`` times more
  (:func:`count_time_loop`).

The roofline divides by one NVIDIA H100 SXM's rates from NVIDIA's data
sheet (dense bf16 tensor cores, HBM3, and NVLink 4 at 450 GB/s each way),
never the reference's TPU constants.  ``chip_smoke.py`` prints the card's
measured bf16 GEMM and HBM copy rates beside them.

Usage:
  python -m repro_torch.launch.dryrun [--arch qwen3-8b] [--shape train_4k]
      [--multi-pod] [--both-meshes] [--all] [--out results.json]
      [--variant baseline|tp_serve|dp_only|microN] [--tensors meta|fake]
      [--layers N]
"""
from __future__ import annotations

import argparse
import contextlib
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
    collectives it issues, each counted ``scale`` times (1 but inside the
    trip :func:`count_time_loop` stands for many); and the bytes of the
    storages those operators allocate that are live at once, at their
    most (``peak``): one device's temporaries, with the bytes
    :meth:`hold` adds for trips that did not run."""
    import weakref

    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Local(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.coll = {}
            self.scale = 1
            self.live = self.peak = 0
            self.storages = set()
            self.holds = {}

        def hold(self, nbytes, keys):
            """``nbytes`` more live from now until every storage of
            ``keys`` (keys of ``storages``) is freed."""
            if nbytes <= 0 or not keys:
                return
            group = [set(keys), nbytes]
            for key in keys:
                self.holds.setdefault(key, []).append(group)
            self.live += nbytes
            self.peak = max(self.peak, self.live)

        def _freed(self, key, nbytes):
            self.storages.discard(key)
            self.live -= nbytes
            for group in self.holds.pop(key, ()):
                group[0].discard(key)
                if not group[0]:
                    self.live -= group[1]

        def _track(self, out):
            """Every new storage among ``out``'s tensors: live from now
            until it is freed (a finalizer on the storage)."""
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                    continue
                st = t.untyped_storage()
                key = st._cdata
                if key in self.storages:
                    continue
                self.storages.add(key)
                self.live += st.nbytes()
                weakref.finalize(st, self._freed, key, st.nbytes())
                self.peak = max(self.peak, self.live)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            self._track(out)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += self.scale * count(*args, **kwargs,
                                                 out_val=out)
            kind = _COLLECTIVES.get(func._overloadpacket.__name__)
            if kind is not None and func.namespace == "_c10d_functional":
                self.coll[kind] = (self.coll.get(kind, 0) + self.scale *
                                   out.numel() * out.element_size())
            return out
    return Local()


def _scale_region():
    """An identity on a loop's carry that sets a counter's ``scale``: to
    ``fwd`` when the forward passes it, to ``bwd`` when the backward
    does.  A trip between an entry ``(S - 1, 1)`` and an exit ``(1, S -
    1)`` is counted ``S - 1`` times in both passes: the backward runs the
    trip's nodes between the exit's and the entry's (autograd takes the
    ready node created last first, and every node of the trip hangs on
    the entry's outputs)."""
    import torch

    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, counter, fwd, bwd, *carry):
            ctx.counter, ctx.bwd = counter, bwd
            if counter is not None:
                counter.scale = fwd
            return tuple(t.view_as(t) for t in carry)

        @staticmethod
        def backward(ctx, *grads):
            if ctx.counter is not None:
                ctx.counter.scale = ctx.bwd
            return (None, None, None, *grads)
    return Scale


@contextlib.contextmanager
def count_time_loop(counter=None):
    """The dry run's rule for the sLSTM's time loop (``models.core.
    TIME_LOOP``), while the block runs: of ``S`` trips the first runs as
    it is (from the zero state it differs in the backward) and the
    second runs once and is counted ``S - 1`` times by ``counter``
    (FLOPs and collective bytes, forward and backward); ``hs`` holds the
    two trips' outputs and zeros for the rest.  Every trip does the same
    work on ``(B, d)`` states, so the counts are the whole loop's.  So are
    the live bytes: what the second trip leaves live beyond its output
    ``h`` (which the zeros stand for) is, under autograd, the tensors it
    saves for the backward, which each of the ``S - 2`` trips that did not
    run would also have left; ``counter`` holds them ``S - 2`` times more,
    and from the end of the loop the ``S - 2`` outputs ``h`` the zeros stood
    for too (the next trip saves each), until the second trip's saved
    tensors are freed (its backward).  Without autograd, or where a
    checkpoint drops what is saved, a trip leaves only ``h`` and nothing
    is held."""
    import torch

    from ..distributed import dtensor as DT
    from ..models import core as M
    Scale = _scale_region()

    def storage(t):
        return (t.to_local() if DT.is_dtensor(t) else t).untyped_storage()

    def loop(trip, carry, S):
        hs, kept = [], set()
        for t in range(min(S, 2)):
            if t == 1:
                carry = Scale.apply(counter, S - 1, 1, *carry)
                if counter is not None:
                    live, before = counter.live, set(counter.storages)
            carry = trip(t, *carry)
            if t == 1:
                carry = Scale.apply(counter, 1, S - 1, *carry)
                if counter is not None and S > 2:
                    # the trip's new storages but its carry: what it saved
                    kept = counter.storages - before - {
                        storage(v)._cdata for v in carry}
                    h = storage(carry[0]).nbytes()
                    counter.hold((S - 2) * (counter.live - live - h), kept)
            hs.append(carry[0])
        hs = torch.stack(hs, dim=1)
        if S > 2:
            def rest(h):
                return h.new_zeros((h.shape[0], S - 2, h.shape[2]))
            if DT.is_dtensor(hs):
                # laid out as the trips' outputs: a DTensor's new_zeros
                # is whole on every device
                from torch.distributed.tensor.experimental import local_map
                pl = tuple(hs.placements)
                rest = local_map(rest, out_placements=(pl,),
                                 in_placements=(pl,))
            hs = torch.cat([hs, rest(hs)], dim=1)
            if counter is not None:
                # the outputs the zeros stood for, saved for the backward
                counter.hold((S - 2) * h, kept)
        return hs, carry
    saved, M.TIME_LOOP = M.TIME_LOOP, loop
    try:
        yield
    finally:
        M.TIME_LOOP = saved


def _local_bytes(tree):
    from ..training.optim import tree_leaves
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree))


def _cell(cfg, shape: str, mesh, variant: str, fake: bool = False):
    """The cell's step function and its ``meta`` inputs laid out on
    ``mesh``, and the number of microbatches; with ``fake``, the inputs
    as fake CPU tensors of an active ``FakeTensorMode`` instead."""
    specs = st.input_specs(cfg, shape)
    if fake:
        import torch

        from ..training.optim import tree_map
        specs = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                         specs)
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


def lower(cfg, shape: str, mesh, variant: str = "baseline",
          tensors: str = "meta") -> dict:
    """Run the cell's step on ``mesh`` (a DeviceMesh with the production
    axis names over an open fake group) and count it; the report's body.
    ``tensors="fake"`` runs it on fake CPU tensors (``FakeTensorMode``)
    instead of ``meta`` ones: the same counts, much slower."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models.core import n_scan_steps
    if tensors not in ("meta", "fake"):
        raise ValueError(f"tensors={tensors!r}: 'meta' or 'fake'")
    fake = tensors == "fake"
    if fake:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode()
    else:
        mode = contextlib.nullcontext()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    kind = st.SHAPES[shape]["kind"]
    one_step = cfg.scaled(n_layers=cfg.n_layers // n_scan_steps(cfg))
    with mode:
        warm_fn, warm_args, _ = _cell(one_step, shape, mesh, variant, fake)
        t0 = time.time()
        with implicit_replication(), count_time_loop():
            warm_fn(*warm_args)
        t_lower = time.time() - t0
        del warm_args
        fn, args, n_micro = _cell(cfg, shape, mesh, variant, fake)
        arg_bytes = _local_bytes(args)
        counter = _counter()
        t0 = time.time()
        with implicit_replication(), count_time_loop(counter), counter:
            fn(*args)
        t_compile = time.time() - t0
    temp = counter.peak
    per_device = {"argument_bytes": arg_bytes, "temp_bytes": temp,
                  "peak_bytes": arg_bytes + temp}
    flops = float(counter.flops)
    coll = dict(sorted(counter.coll.items()))
    if kind == "decode" and "kpool" in args[1]:
        per_device["kv_pool_bytes"] = _local_bytes(
            [args[1]["kpool"], args[1]["vpool"]])
    res = {
        "status": "OK", "variant": variant,
        "n_chips": int(mesh.size()),
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "per_device": per_device,
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
             verbose: bool = True, variant: str = "baseline",
             tensors: str = "meta", n_layers: int | None = None) -> dict:
    """variant: baseline | tp_serve (decode without FSDP param gathers) |
    dp_only (no tensor parallelism) | microN (train grad-accum N);
    ``tensors`` as :func:`lower`'s; ``n_layers`` cuts the model's depth
    (widths and shapes as they are) to a multiple of its scan step's layers
    (jamba's period of 8, xlstm's 2)."""
    cfg = CONFIGS[arch]
    if n_layers:
        from ..models.core import n_scan_steps
        step = cfg.n_layers // n_scan_steps(cfg)
        if n_layers % step:
            raise ValueError(f"{arch}: {n_layers} layers is not a multiple "
                             f"of its scan step's {step}")
        cfg = cfg.scaled(n_layers=n_layers)
    ok, why = st.cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "status": why}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        res = {"arch": arch, "shape": shape,
               "mesh": "2x16x16" if multi_pod else "16x16",
               **lower(cfg, shape, mesh, variant, tensors)}
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
    ap.add_argument("--tensors", choices=("meta", "fake"), default="meta")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every model to this many layers (a multiple "
                         "of its scan step's: jamba 8, xlstm 2)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(CONFIGS)
    shapes = [args.shape] if args.shape else list(st.SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(run_cell(
                        arch, shape, mp, variant=args.variant,
                        tensors=args.tensors, n_layers=args.layers))
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

"""The port's dry run (``repro_torch.launch.dryrun``) on small fake
meshes, on the CPU: every shape kind of every smoke configuration lowers
(``OK``) on a (2, 2) ("data", "model") mesh over a 4-rank fake process
group; the local shards it lays out have the shapes the reference's
``PartitionSpec`` gives at the same axis sizes (``NamedSharding.
shard_shape`` on an abstract mesh); and on the (1, 1) mesh the FLOPs it
counts for one device equal ``FlopCounterMode`` on the plain step over
unsharded tensors.  The shapes are cut to a few tokens (the production
ones are the chip check's); the fake group is torn down after each
test."""
import math

import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import CONFIGS
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import fake_world, make_local_mesh
from repro_torch.training.optim import tree_leaves, tree_map


@pytest.fixture
def small_shapes(monkeypatch):
    """SHAPES at a few tokens (batch 8: divisible by every data extent
    here), the modality prefix inside the sequence."""
    monkeypatch.setattr(st, "SHAPES", {
        k: dict(v, seq=128 if v["kind"] == "decode" else 64, batch=8)
        for k, v in st.SHAPES.items()})
    monkeypatch.setattr(st, "PREFIX_LEN", 16)


@pytest.fixture
def mesh22():
    with fake_world(4):
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                              "model"))


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_every_shape_kind_of_the_smoke_configs_is_ok(small_shapes, mesh22,
                                                     arch):
    cfg = CONFIGS[arch].smoke()
    for shape in st.SHAPES:
        if not st.cell_supported(cfg, shape)[0]:
            continue
        res = DR.lower(cfg, shape, mesh22)
        assert res["status"] == "OK" and res["trip_mult"] == 1
        assert res["hlo_flops_per_device"] > 0, shape
        assert res["per_device"]["argument_bytes"] > 0
        assert res["per_device"]["peak_bytes"] > \
            res["per_device"]["argument_bytes"]
        assert sum(res["collective_bytes_per_device"].values()) > 0
        assert res["roofline"]["dominant"] in ("compute_s", "memory_s",
                                               "collective_s")


def test_microbatches_split_a_batch_sharded_wider_than_their_count(
        small_shapes):
    """``microN`` on a (4, 1) mesh: 8 rows sharded 4 ways, split into 2
    microbatches of 4 (the production train cells split 256 rows sharded
    16 ways into 8), against the same step in one batch: the same FLOPs,
    and the gather the split needs shows as an all-gather."""
    cfg = CONFIGS["qwen3-8b"].smoke()
    with fake_world(4):
        mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data",
                                                               "model"))
        one = DR.lower(cfg, "train_4k", mesh, "micro1")
        two = DR.lower(cfg, "train_4k", mesh, "micro2")
    assert one["n_micro"] == 1 and two["n_micro"] == 2
    assert two["status"] == "OK"
    assert two["hlo_flops_per_device"] == one["hlo_flops_per_device"]


def _pairs(tree, specs):
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    elif isinstance(tree, list):
        for a, b in zip(tree, specs):
            yield from _pairs(a, b)
    else:
        yield tree, specs


@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_local_shards_match_the_partition_spec(arch, multi_pod):
    """Parameters, the batch and the decode state laid out on (2, 2) or
    (2, 2, 2) (``("pod", "data")`` on one dim included): each local shard
    has the shape the reference's PartitionSpec gives."""
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape = (2, 2, 2) if multi_pod else (2, 2)
    jmesh = AbstractMesh(shape, names)
    cfg = CONFIGS[arch].smoke()
    with fake_world(math.prod(shape)):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        tokens = torch.empty((8, 64), dtype=torch.int32, device="meta")
        trees = [(st.abstract_params(cfg), sh.param_specs(cfg, mesh)),
                 ({"tokens": tokens, "labels": tokens},
                  sh.batch_specs(cfg, mesh))]
        state = st.abstract_decode_state(cfg, 8, 256)
        trees.append((state, sh.decode_state_specs(cfg, mesh, state)))
        n = 0
        for tree, specs in trees:
            for t, spec in _pairs(tree, specs):
                want = NamedSharding(jmesh, JP(*spec)).shard_shape(
                    tuple(t.shape))
                got = tuple(sh.distribute(mesh, t, spec).to_local().shape)
                assert got == want, (spec, tuple(t.shape))
                n += 1
    assert n == sum(len(tree_leaves(t)) for t, _ in trees)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_flops_on_the_one_by_one_mesh_equal_flop_counter(small_shapes,
                                                         shape):
    """On the (1, 1) mesh every device runs the whole step: the dry run's
    FLOPs per device equal FlopCounterMode over the plain step on
    unsharded ``meta`` tensors, with the same inputs' shapes."""
    from torch.utils.flop_counter import FlopCounterMode
    st.SHAPES[shape]["batch"] = 4        # one microbatch
    cfg = CONFIGS["jamba-v0.1-52b"].smoke()
    with fake_world(1):
        res = DR.lower(cfg, shape, make_local_mesh())
    inputs = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                      st.input_specs(cfg, shape))
    kind = st.SHAPES[shape]["kind"]
    if kind == "train":
        fn, args = st.make_train_step(cfg), (inputs["params"],
                                              inputs["opt_state"],
                                              inputs["batch"])
    elif kind == "prefill":
        fn, args = st.make_prefill_step(cfg), (inputs["params"],
                                                inputs["batch"])
    else:
        fn, args = st.make_decode_step(cfg), (inputs["params"],
                                               inputs["state"],
                                               inputs["tokens"])
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    assert res["hlo_flops_per_device"] == fc.get_total_flops() > 0


def _cuda_dtensor(mesh, shape):
    """A DTensor whose shards are fake CUDA tensors (no device needed)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate
    with FakeTensorMode():
        t = torch.empty(shape, device="cuda")
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)


def test_kernel_route_refuses_a_dtensor_on_cuda_shards():
    """On DTensors the attention wrappers run the plain version shard by
    shard only with ``impl="ref"`` or shards off the card: the kernel
    route on CUDA shards raises, and never runs the plain version."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import dtensor as DT
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.kernels.paged_attention.ops import paged_decode
    with fake_world(1):
        mesh = DeviceMesh("cuda", torch.arange(1).view(1, 1),
                          mesh_dim_names=("data", "model"))
        q = _cuda_dtensor(mesh, (1, 8, 2, 16))
        assert q.to_local().is_cuda
        with pytest.raises(NotImplementedError, match="flash_mha: the "
                           "kernel takes no DTensor"):
            flash_mha(q, q, q)
        qd = _cuda_dtensor(mesh, (1, 2, 16))
        with pytest.raises(NotImplementedError, match="paged_decode: the "
                           "kernel takes no DTensor"):
            paged_decode(qd, q, q, qd, qd)
        DT.refuse_kernel("flash_mha", q, "ref")          # by name: runs
        cpu = DT.replicated(q, lambda pl: False).to_local().to("meta")
        assert not cpu.is_cuda


def test_uneven_heads_merge_and_split_in_both_directions(small_shapes):
    """Heads that do not divide the model axis (deepseek's 56 and
    musicgen's 24 over 16): a train cell with 6 query and 2 KV heads on a
    (2, 4) mesh lowers, and the merged attention output's gradient comes
    back in the shape and layout of its input."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import dtensor as DT
    cfg = CONFIGS["deepseek-coder-33b"].smoke().scaled(n_heads=6,
                                                       n_kv_heads=2)
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data",
                                                               "model"))
        assert DR.lower(cfg, "train_4k", mesh)["status"] == "OK"
        o = distribute_tensor(torch.zeros(2, 3, 6, 4, device="meta"), mesh,
                              [Shard(0), Replicate()]).requires_grad_()
        y = DT.heads(o, 2, 3, 24)
        assert tuple(y.shape) == (2, 3, 24)
        y.redistribute(placements=[Shard(0), Shard(2)]).sum().backward()
        assert tuple(o.grad.shape) == (2, 3, 6, 4)
        assert tuple(o.grad.placements) == (Shard(0), Replicate())


@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-v0.1-52b"])
def test_one_step_warm_run_counts_what_a_whole_warm_run_counts(small_shapes,
                                                              arch):
    """The counted run after the one-scan-step warm run (``lower``) sees
    exactly what it sees after a warm run of the whole cell: no sharding
    propagation on global shapes leaks into the count."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = CONFIGS[arch].smoke()
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        res = DR.lower(cfg, "train_4k", mesh, "micro2")
        fn, args, _ = DR._cell(cfg, "train_4k", mesh, "micro2")
        for _ in range(2):
            counter = DR._counter()
            with implicit_replication(), counter:
                fn(*args)
    assert res["hlo_flops_per_device"] == counter.flops > 0
    assert res["collective_bytes_per_device"] == dict(
        sorted(counter.coll.items()))
    assert res["per_device"]["temp_bytes"] == counter.peak > 0


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_temp_bytes_are_what_mem_tracker_reads_on_fake_tensors(small_shapes,
                                                               shape):
    """The dry run's own count of the live storages (``temp_bytes``)
    against ``torch.distributed._tools.mem_tracker`` over the same step
    on fake tensors, where it reads each storage as it is allocated and
    freed: the same peak a device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = CONFIGS["qwen3-8b"].smoke()
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        res = DR.lower(cfg, shape, mesh, tensors="fake")
        with FakeTensorMode():
            fn, args, _ = DR._cell(cfg, shape, mesh, "baseline", fake=True)
            mem = MemTracker()
            with implicit_replication(), mem:
                fn(*args)
    assert res["per_device"]["temp_bytes"] == sum(
        v["Total"] for v in mem.get_tracker_snapshot("peak").values()) > 0

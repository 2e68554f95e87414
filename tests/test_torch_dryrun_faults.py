"""The dry run's repaired cells, at smoke width on fake meshes, without
JAX (so that the card's host, which has no JAX, runs this file too):

* the cells the card's torch 2.11 refused lower ``OK``: the MoE decode
  cells (a row-sharded token dim in the dispatch), the MoE train cells
  on a three-axis mesh with one expert a device (the experts' buffer's
  gradient split over data axes its capacity does not divide), xlstm's
  train, decode and prefill cells;
* the sLSTM's time loop, run as two trips and counted for all ``S``
  under the dry run, counts what ``FlopCounterMode`` counts on the whole
  loop of the plain step, and peaks where the whole loop peaks (the
  (1, 1) mesh);
* the vocab-parallel pieces (the embedding's and the loss's shard-local
  functions) give the plain results when the vocabulary is cut in shards;
* ``meta`` and fake tensors read the same counts;
* no weight is saved whole for the backward: every tensor autograd saves
  in a sharded train step that has a weight's shape keeps the weight's
  data-axis shards.

The shapes are cut to a few tokens; the fake group is torn down after
each test."""
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import CONFIGS
from repro_torch.distributed import dtensor as DT
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import fake_world, make_local_mesh
from repro_torch.models import core as M
from repro_torch.training.optim import tree_map

MOE = ("llama4-scout-17b-a16e", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b")
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "2x2x4": ((2, 2, 4), ("pod", "data", "model"))}


@pytest.fixture
def small_shapes(monkeypatch):
    """SHAPES at a few tokens (batch 8: divisible by every data extent
    here), the modality prefix inside the sequence."""
    monkeypatch.setattr(st, "SHAPES", {
        k: dict(v, seq=128 if v["kind"] == "decode" else 64, batch=8)
        for k, v in st.SHAPES.items()})
    monkeypatch.setattr(st, "PREFIX_LEN", 16)


def lower_on(mesh_name, arch, shape):
    dims, names = MESHES[mesh_name]
    with fake_world(int(torch.tensor(dims).prod())):
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
        return DR.lower(CONFIGS[arch].smoke(), shape, mesh)


@pytest.mark.parametrize("arch,shape,mesh", [
    *[(a, "decode_32k", "2x4") for a in MOE],
    *[(a, "train_4k", "2x2x4") for a in MOE],
    ("xlstm-350m", "train_4k", "2x4"), ("xlstm-350m", "train_4k", "2x2x2"),
    ("xlstm-350m", "decode_32k", "2x4"),
    ("xlstm-350m", "prefill_32k", "2x4")])
def test_formerly_refused_cell_lowers(small_shapes, arch, shape, mesh):
    res = lower_on(mesh, arch, shape)
    assert res["status"] == "OK"
    assert res["hlo_flops_per_device"] > 0
    assert res["per_device"]["peak_bytes"] > \
        res["per_device"]["argument_bytes"] > 0


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_slstm_time_loop_counts_what_the_whole_loop_counts(small_shapes,
                                                           shape):
    """On the (1, 1) mesh the dry run's FLOPs, with the sLSTM's loop run
    as two trips and the second counted ``S - 1`` times (forward and
    backward), equal FlopCounterMode over the plain step running every
    trip on unsharded tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    st.SHAPES[shape]["batch"] = 4        # one microbatch
    cfg = CONFIGS["xlstm-350m"].smoke()
    with fake_world(1):
        res = DR.lower(cfg, shape, make_local_mesh())
    assert M.TIME_LOOP is None
    inputs = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                      st.input_specs(cfg, shape))
    if st.SHAPES[shape]["kind"] == "train":
        fn, args = st.make_train_step(cfg), (inputs["params"],
                                              inputs["opt_state"],
                                              inputs["batch"])
    else:
        fn, args = st.make_prefill_step(cfg), (inputs["params"],
                                                inputs["batch"])
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    assert res["hlo_flops_per_device"] == fc.get_total_flops() > 0


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_slstm_time_loop_peak_is_the_whole_loops(small_shapes, shape):
    """On the (1, 1) mesh the dry run's ``temp_bytes``, with the sLSTM's
    loop run as two trips and the bytes the second saves for the backward
    held for the trips that did not run, equal the peak of the same
    counter over the step running every trip (the step's checkpoint
    recomputes the loop in the backward, with every trip's tensors
    saved)."""
    from torch.distributed.tensor.experimental import implicit_replication
    st.SHAPES[shape]["batch"] = 4        # one microbatch
    cfg = CONFIGS["xlstm-350m"].smoke()
    with fake_world(1):
        mesh = make_local_mesh()
        res = DR.lower(cfg, shape, mesh)
        fn, args, _ = DR._cell(cfg, shape, mesh, "baseline")
        counter = DR._counter()
        with implicit_replication(), counter:
            fn(*args)
    assert M.TIME_LOOP is None
    assert res["per_device"]["temp_bytes"] == counter.peak > 0


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_meta_and_fake_tensors_read_the_same(small_shapes, shape):
    """The dry run on ``meta`` tensors and on fake CPU tensors counts the
    same bytes, FLOPs and collectives: its own count of the storages each
    device's operators allocate (``torch.distributed._tools.mem_tracker``,
    which it read before, reads more on ``meta`` tensors on torch 2.11)."""
    cfg = CONFIGS["qwen3-8b"].smoke()
    reads = []
    for tensors in ("meta", "fake"):
        with fake_world(4):
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                                   "model"))
            res = DR.lower(cfg, shape, mesh, tensors=tensors)
        reads.append((res["per_device"], res["hlo_flops_per_device"],
                      res["collective_bytes_per_device"]))
    assert reads[0] == reads[1]
    assert reads[0][0]["temp_bytes"] > 0


def test_vocab_parallel_pieces_give_the_plain_results():
    """The shard-local functions of the vocab-parallel embedding and
    loss, each vocabulary shard on its own and the shards' results
    reduced (sum, max), against the plain lookup, ``logsumexp`` and the
    label's logit."""
    g = torch.Generator().manual_seed(3)
    V, d, n = 24, 5, 4
    table = torch.randn((V, d), generator=g)
    logits = torch.randn((2, 7, V), generator=g)
    tokens = torch.randint(0, V, (2, 7), generator=g)
    ids = torch.arange(V).chunk(n)
    rows = sum(DT._local_rows(t, tokens, i)
               for t, i in zip(table.chunk(n), ids))
    assert torch.equal(rows, table[tokens])
    parts = logits.chunk(n, dim=-1)
    m = torch.stack([DT._local_max(p) for p in parts]).amax(0)
    s = sum(DT._local_sumexp(p, m) for p in parts)
    gold = sum(DT._local_gold(p, tokens, i) for p, i in zip(parts, ids))
    logz, want_gold = DT.logz_and_gold(logits, tokens)
    assert torch.equal(gold, want_gold)
    torch.testing.assert_close(m + torch.log(s), logz)


def test_no_weight_is_saved_whole_for_the_backward(small_shapes):
    """A train step on the (2, 2) mesh under ``saved_tensors_hooks``:
    every saved DTensor with the shape of a weight (one scan step's, or
    the embedding's and head's) keeps that weight's shards over the data
    axis — weights are gathered for a use and again in the backward,
    never kept whole between the two."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = CONFIGS["qwen3-8b"].smoke().scaled(d_model=48, n_heads=4,
                                             n_kv_heads=2, d_head=12,
                                             d_ff=80, vocab=112)
    saved = []

    def pack(t):
        if DT.is_dtensor(t):
            saved.append((tuple(t.shape), tuple(t.placements)))
        return t
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        fn, args, _ = DR._cell(cfg, "train_4k", mesh, "micro1")
        params = args[0]
        weights = {}
        for t in [params["embed"], params["lm_head"]] + [
                w for sub in params["blocks"] for w in sub.values()]:
            shape = tuple(t.shape) if t.dim() == 2 else tuple(t.shape[1:])
            if t.placements[0].is_shard():
                weights[shape] = t.placements
        with implicit_replication(), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(*args)
    assert weights and saved
    whole = [(shape, pl) for shape, pl in saved
             if shape in weights and not pl[0].is_shard()]
    assert not whole, whole


def test_dp_only_microbatches_smaller_than_the_ranks_lower(monkeypatch):
    """hillclimb's xlstm-350m ``train_4k`` ``dp_only`` cell: ``dp_only``
    shards the batch's rows over every axis, and 8 microbatches of 2 rows
    on a 2 x 4 mesh have fewer rows than its 8 ranks.  Each microbatch is
    sharded over the data axis (2 divides its rows) and kept whole on the
    model axis, and the cell lowers ``OK``; sharded over all 8 ranks,
    DTensor read 8 rows from a shard of 1 and the loss's product refused
    the mask's 2 (the fault the hill-climb met at production size)."""
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    monkeypatch.setattr(st, "SHAPES", {
        k: dict(v, seq=64, batch=16) for k, v in st.SHAPES.items()})
    dims, names = MESHES["2x4"]
    with fake_world(8):
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
        rows = distribute_tensor(torch.empty((16, 4), device="meta"), mesh,
                                 [Shard(0), Shard(0)])
        micro = DT.microbatches(rows, 8)
        assert tuple(micro.shape) == (8, 2, 4)
        assert tuple(micro.placements) == (Shard(1), Replicate())
        res = DR.lower(CONFIGS["xlstm-350m"].smoke(), "train_4k", mesh,
                       "dp_only")
    assert res["status"] == "OK" and res["n_micro"] == 8

"""Production mesh builders (assignment: 16x16 single pod, 2x16x16 pods)
— the port of :mod:`repro.launch.mesh`, as ``torch.distributed``
``DeviceMesh``es.

:func:`make_production_mesh` stands over a fake process group of 256 or
512 ranks (PyTorch's test-only ``fake`` backend: every collective returns
at once, no device runs), which :func:`fake_world` opens and closes: the
dry run lays its fake tensors out on it.  :func:`make_local_mesh` is the
``(1, 1)`` mesh with the same names over the process's one device, in a
one-rank fake group.  No serve or train path opens a process group.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks (this process rank 0), torn
    down on exit.  Refuses to stand over a group that is already open.
    Inside it DTensor moves a shard from one dim to another with one
    all-to-all of the local size (:func:`_all_to_all`)."""
    import torch.distributed as dist
    from torch.distributed.tensor import placement_types as PT
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry run's fake world needs its own")
    dist.init_process_group("fake", world_size=size, rank=0,
                            store=FakeStore())
    real, PT.shard_dim_alltoall = PT.shard_dim_alltoall, _all_to_all
    try:
        yield
    finally:
        PT.shard_dim_alltoall = real
        dist.destroy_process_group()


def _all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's move of a shard from dim ``gather_dim`` to ``shard_dim``
    over one mesh dim (its ``shard_dim_alltoall``; DTensor has padded
    ``shard_dim`` to a multiple of the ranks), as the one all-to-all of the
    local size a card's group runs.  On a CPU mesh DTensor gathers the
    whole dim and keeps a chunk (gloo has no all-to-all): on the fake
    group that would count an all-gather's bytes and hold the gathered
    whole live."""
    import torch
    import torch.distributed._functional_collectives as funcol
    out = funcol.all_to_all_single(
        torch.stack(input.chunk(mesh.size(mesh_dim), dim=shard_dim)), None,
        None, (mesh, mesh_dim))
    if isinstance(out, funcol.AsyncCollectiveTensor):
        out = out.wait()
    return torch.cat(out.unbind(0), dim=gather_dim)


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the open fake group (whose size must
    be 256 or 512)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_local_mesh():
    """1-device mesh with the same axis names (CPU tests), over an open
    one-rank group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))

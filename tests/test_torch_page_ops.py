"""The port's page operations (PageS / PageCP / PageR) against the JAX
package: its plain versions must be array-equal to the reference's
``page_ops/ref.py`` and to the Pallas kernels in interpret mode, on the
inputs of ``tests/test_kernels.py`` plus a chained pair (a destination
that is another pair's source) and a duplicate destination.  The CUDA
kernels themselves are held against these plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_gpu.py``).  Tolerance 0."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.page_ops import page_ops as PK
from repro.kernels.page_ops import ref as PR
from repro_torch.kernels.page_ops import ops, page_ops

PAIRS = {
    "reference": [[0, 3], [5, 7]],
    # page 5 gets page 3 as it was before the call
    "chained": [[0, 3], [3, 5]],
    # two pairs name page 3: the later one wins
    "duplicate_dst": [[0, 3], [1, 3]],
    "swap": [[2, 6], [6, 2], [2, 6]],
}


def _pool(dtype=np.float32, shape=(8, 16, 2, 32)):
    rng = np.random.default_rng(2)
    return rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_page_copy_matches_jax_ref_and_pallas(name):
    pool = _pool()
    pairs = np.asarray(PAIRS[name], np.int32)
    want = np.asarray(PR.page_copy_ref(jnp.asarray(pool), jnp.asarray(pairs)))
    pallas = np.asarray(PK.page_copy(jnp.asarray(pool), jnp.asarray(pairs),
                                     interpret=True))
    t = torch.from_numpy(pool.copy())
    got = ops.page_copy(t, torch.from_numpy(pairs))
    assert got is t                                  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("ids,value", [([1, 4], 0.0), ([4, 4, 0], -2.5),
                                       ([7], 1.0)])
def test_page_set_matches_jax_ref_and_pallas(ids, value):
    pool = _pool()
    ids = np.asarray(ids, np.int32)
    want = np.asarray(PR.page_set_ref(jnp.asarray(pool), jnp.asarray(ids),
                                      value))
    pallas = np.asarray(PK.page_set(jnp.asarray(pool), jnp.asarray(ids),
                                    value, interpret=True))
    got = ops.page_set(torch.from_numpy(pool.copy()), torch.from_numpy(ids),
                       value)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_page_gather_matches_jax_ref_and_pallas():
    pool = _pool()
    table = np.asarray([7, 2, 0], np.int32)
    want = np.asarray(PR.page_gather_ref(jnp.asarray(pool),
                                         jnp.asarray(table)))
    pallas = np.asarray(PK.page_gather(jnp.asarray(pool), jnp.asarray(table),
                                       interpret=True))
    got = ops.page_gather(torch.from_numpy(pool), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_leading_layer_axes_apply_to_every_layer():
    """The serving pools carry (steps, n_attn) in front of the pages: one
    call applies the same ids on every layer, as one reference call per
    layer would."""
    pool = _pool(shape=(3, 2, 8, 4, 2, 16))
    pairs = np.asarray(PAIRS["chained"], np.int32)
    ids = np.asarray([1, 6], np.int32)
    want = pool.copy()
    for a in range(3):
        for b in range(2):
            layer = PR.page_copy_ref(jnp.asarray(pool[a, b]),
                                     jnp.asarray(pairs))
            want[a, b] = np.asarray(PR.page_set_ref(layer, jnp.asarray(ids),
                                                    0.0))
    t = torch.from_numpy(pool.copy())
    ops.page_copy(t, torch.from_numpy(pairs))
    ops.page_set(t, torch.from_numpy(ids), 0.0)
    np.testing.assert_array_equal(t.numpy(), want)


def test_bfloat16_pool_is_copied_bit_for_bit():
    pool = torch.from_numpy(_pool()).to(torch.bfloat16)
    ref = pool.clone()
    ops.page_copy(pool, torch.tensor(PAIRS["duplicate_dst"],
                                     dtype=torch.int32))
    assert torch.equal(pool[3], ref[1]) and torch.equal(pool[0], ref[0])


def test_impl_and_device_selection():
    pool = torch.from_numpy(_pool())
    ids = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="impl"):
        ops.page_set(pool, ids, 0.0, impl="pallas")
    # a CPU pool goes to the plain version with impl="kernel" too ...
    before = page_ops.page_set.launches
    ops.page_set(pool, ids, 0.0)
    assert page_ops.page_set.launches == before
    # ... and the kernel wrapper refuses it outright (no quiet CPU run)
    with pytest.raises(ValueError, match="CUDA"):
        page_ops.page_set(pool, ids, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        page_ops.page_copy(pool, torch.tensor([[0, 1]], dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ops.page_set(pool.transpose(1, 2), ids, 0.0)


def test_page_gather_routing():
    """A CPU pool goes to the plain version (no launch), ``impl="ref"``
    names it on any device, and an unknown ``impl`` raises."""
    pool = torch.from_numpy(_pool())
    table = torch.tensor([6, 1, 6], dtype=torch.int32)
    before = page_ops.page_gather.launches
    got = ops.page_gather(pool, table)
    assert page_ops.page_gather.launches == before
    assert torch.equal(got, pool[[6, 1, 6]])
    assert torch.equal(ops.page_gather(pool, table, impl="ref"), got)
    with pytest.raises(ValueError, match="impl"):
        ops.page_gather(pool, table, impl="pallas")


def test_page_gather_kernel_wrapper_refuses_what_it_does_not_take():
    pool = torch.from_numpy(_pool())
    table = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        page_ops.page_gather(pool, table)
    with pytest.raises(ValueError, match="int32"):
        page_ops.page_gather(pool, table.long())
    with pytest.raises(ValueError, match="contiguous"):
        page_ops.page_gather(pool.transpose(1, 2), table)


def test_page_gather_ref_with_layer_axes_matches_jax_per_layer():
    """A layered pool ``(3, 2, NP, page, H, D)``: each layer's gather is
    the reference's, and the Pallas kernel's in interpret mode."""
    pool = _pool(shape=(3, 2, 8, 4, 2, 16))
    table = np.asarray([5, 0, 5, 7], np.int32)
    got = ops.page_gather(torch.from_numpy(pool), torch.from_numpy(table))
    assert got.shape == (3, 2, 4, 4, 2, 16)
    for a in range(3):
        for b in range(2):
            layer = jnp.asarray(pool[a, b])
            np.testing.assert_array_equal(
                got[a, b].numpy(),
                np.asarray(PR.page_gather_ref(layer, jnp.asarray(table))))
            np.testing.assert_array_equal(
                got[a, b].numpy(),
                np.asarray(PK.page_gather(layer, jnp.asarray(table),
                                          interpret=True)))


def test_page_copy_kernel_wrapper_limits_its_pairs():
    """One CTA holds a chunk of every pair's source in shared memory, a
    vector of each at the least: more pairs than that raise."""
    pool = torch.from_numpy(_pool())
    too_many = torch.zeros((page_ops.COPY_MAX_PAIRS + 1, 2),
                           dtype=torch.int32)
    with pytest.raises(ValueError, match="pairs are more than"):
        page_ops.page_copy(pool, too_many)
    assert page_ops.COPY_MAX_PAIRS * 16 <= page_ops.COPY_SMEM_BYTES
    # at the limit only the device is wrong
    with pytest.raises(ValueError, match="CUDA"):
        page_ops.page_copy(pool, too_many[1:])

"""The port's dry run against the reference's on qwen3-8b
``prefill_32k`` cut to one layer (ROADMAP Queue C 7): the prefill
attention in the reference's online KV chunks shard by shard, so the
peak a device stays within 1.5x of the reference's XLA peak (the plain
attention's S x S scores read 9.99x on 16 x 16); and the
port's ``online_attn`` against the reference's ``_online_attn`` on the
same seeded inputs.  The peak ratio is held from below too, at about 0.8
of its reading (0.6549 / 0.4136 on the two meshes since each device
computes the rotary angles of its own batch rows; 0.7467 / 0.5325 before),
so that a counter that stops counting live storage fails.  Needs ``jax`` (skipped without
it)."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_torch_dryrun_reference import helper  # noqa: E402


@pytest.mark.parametrize("multi_pod, least", [
    pytest.param(False, 0.6, id="16x16"),
    pytest.param(True, 0.33, id="2x16x16")])
def test_prefill_peak_is_within_1_5x_of_the_reference(multi_pod, least):
    R = helper()
    ref = R.reference_cell("qwen3-8b", "prefill_32k", multi_pod, 1)
    port = R.port_cell("qwen3-8b", "prefill_32k", multi_pod, 1, "meta")
    assert port["status"] == ref["status"] == "OK"
    line = R.row(port, ref)
    assert port["per_device"]["argument_bytes"] == \
        ref["per_device"]["argument_bytes"] > 0, line
    assert least <= line["peak_ratio"] <= 1.5, line


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 600])
def test_online_attn_is_the_references(dtype, window):
    """Three KV chunks of GQA attention (two KV heads of two query heads,
    positions offset and the keys' their own): the port's ``online_attn``
    against the reference's ``_online_attn`` within ``ATTN_TOL``."""
    import jax.numpy as jnp

    from repro.models.core import KV_CHUNK, _online_attn
    from repro_torch.kernels.flash_attention import ref as FR
    assert FR.KV_CHUNK == KV_CHUNK
    rng = np.random.default_rng(11)
    B, Sq, Skv, Hkv, G, D = 2, 256, 3 * KV_CHUNK, 2, 2, 16
    q = rng.standard_normal((B, Sq, Hkv, G, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    q_pos = np.arange(Skv - Sq, Skv)[None].repeat(B, 0).astype(np.int32)
    kv_pos = np.arange(Skv)[None].repeat(B, 0).astype(np.int32)
    want = np.asarray(_online_attn(
        *(jnp.asarray(t, getattr(jnp, dtype)) for t in (q, k, v)),
        jnp.asarray(q_pos), jnp.asarray(kv_pos), window), np.float32)
    dt = getattr(torch, dtype)
    got = FR.online_attn(
        *(torch.from_numpy(t).to(dt) for t in (q, k, v)),
        torch.from_numpy(q_pos), torch.from_numpy(kv_pos), window)
    atol, rtol = FR.ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)

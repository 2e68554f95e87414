"""The port's dry run against the reference's on qwen3-8b ``decode_32k``
cut to one layer (ROADMAP Queue C 6): the KV pool sharded over its pages
as the reference shards its per-row pool, so the argument bytes a device
are the reference's on both meshes and the peak within 1.5x of its XLA
peak (a pool whole on every device reads 219x the arguments and 8.09x the
peak on 16 x 16).  The peak ratio is held from below too, at about 0.8 of
its reading (0.0856 / 0.1315 on the two meshes: each device reads its own
pages once, split-KV, where the reference's program gathers each row's
pages), so that a counter that stops counting live storage fails.  And
jamba-v0.1-52b ``decode_32k`` at one period of 8 layers on 16 x 16
(ROADMAP Queue C 10): at a decode step's few rows its MoE sublayers' expert
weights stay on the ranks that hold them, where gathering them over the
data axes read 2.46x the reference's peak and 5.2x its all-gather bytes.
Needs ``jax`` (skipped without it); the reference runs in its own
interpreter (``tests/torch_dryrun_reference.py``)."""
import pytest

pytest.importorskip("jax")

from test_torch_dryrun_reference import helper  # noqa: E402


@pytest.mark.parametrize("multi_pod, least", [
    pytest.param(False, 0.068, id="16x16"),
    pytest.param(True, 0.105, id="2x16x16")])
def test_decode_pool_bytes_are_the_references(multi_pod, least):
    R = helper()
    ref = R.reference_cell("qwen3-8b", "decode_32k", multi_pod, 1)
    port = R.port_cell("qwen3-8b", "decode_32k", multi_pod, 1, "meta")
    assert port["status"] == ref["status"] == "OK"
    line = R.row(port, ref)
    assert port["per_device"]["argument_bytes"] == \
        ref["per_device"]["argument_bytes"] > 0, line
    assert least <= line["peak_ratio"] <= 1.5, line


def test_jamba_decode_keeps_its_experts_on_their_ranks():
    """Peak and all-gather bytes a device within 1.5x of the reference's,
    each held from below at about 0.8 of its reading (1.0254 and 0.6956),
    argument bytes equal."""
    R = helper()
    ref = R.reference_cell("jamba-v0.1-52b", "decode_32k", False, 8)
    port = R.port_cell("jamba-v0.1-52b", "decode_32k", False, 8, "meta")
    assert port["status"] == ref["status"] == "OK"
    line = R.row(port, ref)
    assert port["per_device"]["argument_bytes"] == \
        ref["per_device"]["argument_bytes"] > 0, line
    assert 0.82 <= line["peak_ratio"] <= 1.5, line
    gathers = (port["collective_bytes_per_device"]["all-gather"] /
               line["reference"]["collective_bytes_per_device"]["all-gather"])
    assert 0.56 <= gathers <= 1.5, (gathers, line)

"""The port's dry run against the reference's at ``long_500k``'s one token
row (ROADMAP Queue C 12): jamba-v0.1-52b at one period of 8 layers and
xlstm-350m at 2 layers, on 16 x 16.  The data axes do not shard one row,
so the reference's XLA program contracts every product on the weight's
own FSDP shard and reduces the small partial rows; so does the port
(``DT.for_use(layer, rows=x)``, ``DT.matmul``, the embedding's lookup in
the table's own shard, the head on its own shard), where it gathered every
dense weight, the table and the head over the data axes for the one row
(all-gather 216 MB and 10.8 MB a device, peaks 2.195x and 4.015x).

Each cell: argument bytes equal, the all-gather under 1 MiB a device, and
the peak and FLOPs ratios held from both sides at their readings (peak
1.5077 / 2.3567, FLOPs 0.7607 / 2.4654).  The peak's excess over 1.5x is
the counter's, not the step's: ``launch/dryrun.py``'s counter counts an
argument's storage again, whole, when an operator returns a view of it
(the ``unbind`` of the stacked weights and the decode state: 192 MB of
jamba's 202 MB of temporaries, 5.5 of xlstm's 8.7; ROADMAP Queue C 13).
Net of those views the peak is within 1.5x of the reference's (0.781 /
1.492).  Needs ``jax`` (skipped without it); the reference runs in its
own interpreter (``tests/torch_dryrun_reference.py``), about a minute a
cell."""
import pytest

pytest.importorskip("jax")

from test_torch_dryrun_reference import helper  # noqa: E402


@pytest.mark.parametrize("arch, layers, peak, flops", [
    pytest.param("jamba-v0.1-52b", 8, 1.5077, 0.7607, id="jamba"),
    pytest.param("xlstm-350m", 2, 2.3567, 2.4654, id="xlstm")])
def test_one_row_is_contracted_on_the_weights_own_shards(arch, layers, peak,
                                                         flops):
    R = helper()
    ref = R.reference_cell(arch, "long_500k", False, layers)
    port = R.port_cell(arch, "long_500k", False, layers, "meta", parts=1000)
    assert port["status"] == ref["status"] == "OK"
    line = R.row(port, ref)
    assert port["per_device"]["argument_bytes"] == \
        ref["per_device"]["argument_bytes"] > 0, line
    assert port["collective_bytes_per_device"]["all-gather"] <= 1 << 20, line
    assert 0.8 * peak <= line["peak_ratio"] <= 1.03 * peak, line
    views = sum(b for b, op, *_ in port["peak_parts"]
                if op == "aten.unbind.int")
    net = (port["per_device"]["peak_bytes"] - views) / \
        ref["per_device"]["peak_bytes"]
    assert net <= 1.5, (net, views, line)
    ratio = port["hlo_flops_per_device"] / ref["hlo_flops_per_device"]
    assert 0.8 * flops <= ratio <= 1.2 * flops, (ratio, line)

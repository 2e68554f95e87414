"""The port's dry run against the reference's where the query heads do not
divide the "model" axis of 16 (ROADMAP Queue C 9): deepseek-coder-33b's
56, llama4-scout's 40 and musicgen-medium's 24 attention heads and
xlstm-350m's 4 mLSTM heads.  The reference's XLA program keeps such heads
whole and splits the query rows over "model"; so does the port
(``DT.query_heads``: the attention's rows in pairs of blocks from both
ends, each against the keys up to its end; the mLSTM's runs of chunks,
each from the state the runs before it fold in), where it held every
head of every row on every device (peaks 4.3-19.6x the reference's).  On
16 x 16 at one layer (xlstm-350m and llama4-scout at two, a multiple of
the period), argument bytes equal, the peak and, where the port's FLOPs
ran 2.6-10.8x the reference's, the FLOPs within 1.5x of the reference's;
each ratio held from below too, at about 0.8 of its reading (peak 0.8230
/ 1.3095 / 0.2573 / 0.3457 / 0.6457, FLOPs 1.1125 / 1.3041 / 1.0274 in
the table's order), so that a counter that stops counting fails.  Needs
``jax`` (skipped without it); 10-25 s a cell."""
import pytest

pytest.importorskip("jax")

from test_torch_dryrun_reference import helper  # noqa: E402


@pytest.mark.parametrize("arch, shape, layers, peak, flops", [
    pytest.param("musicgen-medium", "train_4k", 1, 0.66, 0.89,
                 id="musicgen-train"),
    pytest.param("deepseek-coder-33b", "prefill_32k", 1, 1.05, 1.04,
                 id="deepseek-prefill"),
    pytest.param("deepseek-coder-33b", "train_4k", 1, 0.21, 0.82,
                 id="deepseek-train"),
    pytest.param("llama4-scout-17b-a16e", "train_4k", 2, 0.28, None,
                 id="llama4-train"),
    pytest.param("xlstm-350m", "prefill_32k", 2, 0.52, None,
                 id="xlstm-prefill")])
def test_uneven_heads_are_within_1_5x_of_the_reference(arch, shape, layers,
                                                      peak, flops):
    R = helper()
    ref = R.reference_cell(arch, shape, False, layers)
    port = R.port_cell(arch, shape, False, layers, "meta")
    assert port["status"] == ref["status"] == "OK"
    line = R.row(port, ref)
    assert port["per_device"]["argument_bytes"] == \
        ref["per_device"]["argument_bytes"] > 0, line
    assert peak <= line["peak_ratio"] <= 1.5, line
    if flops is not None:
        ratio = port["hlo_flops_per_device"] / ref["hlo_flops_per_device"]
        assert flops <= ratio <= 1.5, (ratio, line)

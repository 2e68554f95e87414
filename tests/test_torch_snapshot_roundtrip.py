"""Cross-backend round trips of the port's snapshots (twin of
``tests/test_snapshot.py::test_cross_backend_roundtrip_bit_identical``):
capture on one backend, restore into another, run both to the final
ecall, every architectural bit equal — ``TorchTarget(device="cpu")``
against the reference's ``PySim`` and ``JaxTarget``, both directions.
Kept apart from ``tests/test_torch_snapshot.py`` so the two files run
side by side (each leg runs thousands of eager substeps).  Integer state;
tolerance 0."""
import pytest

from test_torch_snapshot import MAKERS, _cap, _fresh, _key, _restore


@pytest.mark.parametrize("src,dst", [("pysim", "torch"), ("torch", "pysim"),
                                     ("jax", "torch"), ("torch", "jax")])
def test_cross_backend_roundtrip_bit_identical(src, dst):
    """Capture on one backend, restore into the other, run on both,
    capture again: every architectural bit agrees, to the final ecall."""
    a = _fresh(MAKERS[src])
    a.run(max_cycles=250)                      # mid-loop, dirty state
    s0 = _cap(a)
    b = MAKERS[dst]()
    _restore(b, s0)
    assert _key(_cap(b)) == _key(s0), "restore must reproduce the capture"
    assert b.get_ticks() == a.get_ticks()
    a.run(max_cycles=300)
    b.run(max_cycles=300)
    assert _key(_cap(a)) == _key(_cap(b))
    for name in ("pc", "satp", "mcause", "mepc", "mtval"):
        assert a.csr_read(0, name) == b.csr_read(0, name), name
    for t in (a, b):
        while not t.pending_cores():
            t.run(max_cycles=1000)
    assert _key(_cap(a)) == _key(_cap(b))
    assert a.get_instret(0) == b.get_instret(0)

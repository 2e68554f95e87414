"""The FASE target processor package (PyTorch port).

:mod:`repro_torch.core.target.cpu` is the lane-vectorized RV64IMA
interpreter (state in persistent device tensors), :mod:`.isa` /
:mod:`.asm` the shared encodings and the two-pass assembler,
:mod:`.u64` the unsigned-64-bit helpers over ``torch.int64`` storage and
:mod:`.convert` the numpy bridge used to seed and compare whole states.
"""
